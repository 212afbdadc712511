"""Carry the JAX package's objects across into this package's types.

:func:`from_reference` reads a reference object by attribute and
``np.asarray`` — it never imports JAX — and returns the port's
equivalent, so one set of inputs can drive both packages:

* a ``NetworkTopology`` -> :class:`~phoskintime_tpu_torch.network.topology.NetworkTopology`;
* a ``GlobalSystem`` -> :class:`~phoskintime_tpu_torch.network.system.GlobalSystem`
  with the same ``kin_grid``, ``Kmat`` and ``custom_y0``;
* a ``LossData`` -> :class:`~phoskintime_tpu_torch.network.lossdata.LossData`;
* a per-gene ``NormestResult`` -> :class:`~phoskintime_tpu_torch.fit.normest.NormestResult`
  (numpy fields, the CI dict carried over), so that a JAX fit can feed
  the port's ``process_gene(precomputed=...)``;
* a kinopt or tfopt problem: :func:`kinopt_problem_from_reference`,
  :func:`tfopt_problem_from_reference` (their fields are numpy already);
* a dict (a parameter dict, ``slices``, a demo bundle) -> a dict of the
  converted values;
* an array (a ``theta`` vector, a parameter leaf) -> a numpy array.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, torch_dtype
from phoskintime_tpu_torch.fit.normest import NormestResult
from phoskintime_tpu_torch.kinopt.model import KinoptProblem
from phoskintime_tpu_torch.network.lossdata import LossData
from phoskintime_tpu_torch.network.system import GlobalSystem
from phoskintime_tpu_torch.network.topology import NetworkTopology
from phoskintime_tpu_torch.tfopt.model import TfoptProblem


def _topology(t) -> NetworkTopology:
    return NetworkTopology(
        proteins=list(t.proteins), kinases=list(t.kinases),
        sites=[list(s) for s in t.sites],
        n_sites=np.asarray(t.n_sites, np.int32),
        p2i=dict(t.p2i), k2i=dict(t.k2i), proxy_map=dict(t.proxy_map),
        driver_map=np.asarray(t.driver_map, np.int32),
        W_pad=np.asarray(t.W_pad, float), tf_mat=np.asarray(t.tf_mat, float),
        tf_deg=np.asarray(t.tf_deg, float), model=int(t.model))


def from_reference(obj, *, dtype: torch.dtype | None = None, device=DEFAULT_DEVICE):
    """The port's equivalent of a JAX-package object (see module doc).

    A system is made at ``dtype`` (default: the reference system's own
    numpy dtype) on ``device`` (default: the card; raises where there is
    none); other values ignore both. The topology carries its mechanism,
    so a model-2 system comes across with its hypercube tables."""
    if hasattr(obj, "W_pad") and hasattr(obj, "driver_map"):
        return _topology(obj)
    if hasattr(obj, "topo") and hasattr(obj, "Kmat") and hasattr(obj, "kin_grid"):
        y0 = getattr(obj, "custom_y0", None)
        return GlobalSystem(
            _topology(obj.topo), np.asarray(obj.kin_grid, float),
            np.asarray(obj.Kmat, float),
            custom_y0=None if y0 is None else np.asarray(y0, float),
            dtype=dtype or torch_dtype(getattr(obj, "dtype", np.float64)),
            device=device)
    if hasattr(obj, "_fields") and "p_prot" in obj._fields:
        return LossData(*(v if isinstance(v, int) else np.asarray(v)
                          for v in obj))
    if hasattr(obj, "_fields") and "popt_raw" in obj._fields:
        return NormestResult(*(from_reference(v) for v in obj))
    if isinstance(obj, Mapping):
        return {k: from_reference(v, dtype=dtype, device=device)
                for k, v in obj.items()}
    if obj is None or isinstance(obj, (slice, str, int, float, bool)):
        return obj
    return np.asarray(obj)


def _listed(v):
    return None if v is None else list(v)


def kinopt_problem_from_reference(p) -> KinoptProblem:
    """The port's :class:`KinoptProblem` of the JAX package's."""
    return KinoptProblem(
        np.asarray(p.P_obs, float), np.asarray(p.K_array, float),
        np.asarray(p.gp_kin_idx, np.int32), np.asarray(p.gp_mask, bool),
        np.asarray(p.k_row_idx, np.int32), np.asarray(p.k_mask, bool),
        _listed(p.gp_names), _listed(p.kinase_names), float(p.lb), float(p.ub))


def tfopt_problem_from_reference(p) -> TfoptProblem:
    """The port's :class:`TfoptProblem` of the JAX package's."""
    return TfoptProblem(
        np.asarray(p.mRNA_mat, float), np.asarray(p.regulators, np.int32),
        np.asarray(p.protein_mat, float), np.asarray(p.psite_tensor, float),
        np.asarray(p.num_psites, np.int32), _listed(p.gene_ids), _listed(p.tf_ids),
        _listed(p.psite_labels), float(p.lb), float(p.ub))
