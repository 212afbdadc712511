"""The port's tfopt (model, losses, projected-Adam multistart, the
evolutionary fits by every optimizer code, data builders) against the JAX
package's, on the CPU in float64.

The same seeded numpy inputs go through both packages. Whole evolutionary
runs draw from the port's own generator and are held to the quality gates
of the JAX package's tests (``tests/test_kinopt_tfopt.py``).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.tfopt import data as jdata
from phoskintime_tpu.tfopt import model as jmodel
from phoskintime_tpu.tfopt.optimize import run_local as jax_run_local
from phoskintime_tpu_torch.interop import tfopt_problem_from_reference
from phoskintime_tpu_torch.tfopt import data, model
from phoskintime_tpu_torch.tfopt.optimize import run_evolutionary, run_local

torch.set_num_threads(2)

T = 14
RTOL_LOSS = 1e-12      # float64, the same operations: rounding only
RTOL_ADAM = 1e-9       # hundreds of Adam steps of rounding


def tf_problem(seed=0):
    """4 genes, 3 TFs (2, 1 and 0 psites), known weights (the JAX package's
    ``tests/test_kinopt_tfopt.py::tf_problem``)."""
    rng = np.random.default_rng(seed)
    n_genes, n_TF, n_reg, n_ps = 4, 3, 2, 2
    protein = rng.uniform(0.5, 2.0, (n_TF, T))
    psites = rng.uniform(0.2, 1.5, (n_TF, n_ps, T))
    num_psites = np.array([2, 1, 0])
    psites[1, 1:] = 0.0
    psites[2, :] = 0.0
    regulators = np.array([[0, 1], [1, 2], [0, 2], [2, -1]])
    beta_true = np.zeros((n_TF, 1 + n_ps))
    beta_true[0] = [0.5, 0.3, 0.2]
    beta_true[1] = [0.6, 0.4, 0.0]
    beta_true[2] = [1.0, 0.0, 0.0]
    alpha_true = np.array([[0.7, 0.3], [0.5, 0.5], [0.4, 0.6], [1.0, 0.0]])
    effect = beta_true[:, :1] * protein + np.einsum("fk,fkt->ft", beta_true[:, 1:], psites)
    mRNA = np.zeros((n_genes, T))
    for g in range(n_genes):
        for r in range(n_reg):
            if regulators[g, r] >= 0:
                mRNA[g] += alpha_true[g, r] * effect[regulators[g, r]]
    prob = jmodel.TfoptProblem(mRNA, regulators, protein, psites, num_psites)
    return prob, alpha_true, beta_true


def scaled_problem(n_genes=40, n_TF=12, n_reg=4, max_ps=6, seed=0):
    """The generator above scaled: ``n_reg`` regulators a gene (some slots
    empty), 0..``max_ps`` psites a TF."""
    rng = np.random.default_rng(seed)
    protein = rng.uniform(0.5, 2.0, (n_TF, T))
    num_psites = rng.integers(0, max_ps + 1, n_TF)
    psites = rng.uniform(0.2, 1.5, (n_TF, max_ps, T))
    psites *= (np.arange(max_ps)[None, :] < num_psites[:, None])[..., None]
    regulators = np.stack([rng.choice(n_TF, n_reg, replace=False) for _ in range(n_genes)])
    regulators[rng.random((n_genes, n_reg)) < 0.2] = -1
    regulators[:, 0] = np.abs(regulators[:, 0])
    mRNA = rng.uniform(0.5, 3.0, (n_genes, T))
    return jmodel.TfoptProblem(mRNA, regulators.astype(np.int32), protein, psites,
                               num_psites.astype(np.int32))


@pytest.fixture(scope="module")
def scaled():
    pj = scaled_problem()
    return pj, tfopt_problem_from_reference(pj)


def weights(prob, P=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if P is None else (P,)
    a = rng.uniform(-0.2, 1.2, lead + prob.alpha_mask.shape) * prob.alpha_mask
    b = rng.uniform(-0.5, 1.5, lead + prob.beta_mask.shape) * prob.beta_mask
    return a, b


@pytest.mark.parametrize("loss_type", range(7))
def test_predict_and_loss_match_jax(scaled, loss_type):
    """Loss codes 0-6 (elastic net and Tikhonov with their lam quirk) on a
    population of 4 in one call against each member alone in JAX."""
    pj, pt = scaled
    A, B = weights(pj, P=4, seed=loss_type)
    got = model.tfopt_loss(pt, torch.as_tensor(A), torch.as_tensor(B), loss_type, 1e-2, 3e-2)
    want = [float(jmodel.tfopt_loss(pj, jnp.asarray(a), jnp.asarray(b), loss_type, 1e-2, 3e-2))
            for a, b in zip(A, B)]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_LOSS)
    pred = model.predict(pt, torch.as_tensor(A), torch.as_tensor(B))
    av, bv = model.violation_sq(pt, torch.as_tensor(A), torch.as_tensor(B))
    for k in range(4):
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(jmodel.predict(
            pj, jnp.asarray(A[k]), jnp.asarray(B[k]))), rtol=RTOL_LOSS, atol=1e-15)
        wa, wb = jmodel.violation_sq(pj, jnp.asarray(A[k]), jnp.asarray(B[k]))
        np.testing.assert_allclose([float(av[k]), float(bv[k])], [float(wa), float(wb)],
                                   rtol=RTOL_LOSS)


def test_zero_at_truth_and_masks():
    pj, a, b = tf_problem()
    pt = tfopt_problem_from_reference(pj)
    assert float(model.tfopt_loss(pt, torch.as_tensor(a), torch.as_tensor(b))) == \
        pytest.approx(0.0, abs=1e-20)
    assert np.array_equal(pt.beta_mask, pj.beta_mask) and pt.n_alpha == pj.n_alpha
    x = pt.pack(a, b)
    np.testing.assert_array_equal(np.concatenate(pt.unpack(x), axis=None),
                                  np.concatenate(pj.unpack(x), axis=None))


@pytest.mark.parametrize("loss_type", [0, 6])
def test_run_local_matches_jax(loss_type):
    """The same numpy starts through both packages: alpha and beta within
    1e-8, the per-start losses at rtol 1e-9, the same picked start."""
    pj, *_ = tf_problem()
    pt = tfopt_problem_from_reference(pj)
    want = jax_run_local(pj, loss_type=loss_type, n_starts=6, steps=300, lr=0.05, seed=2)
    got = run_local(pt, loss_type=loss_type, n_starts=6, steps=300, lr=0.05, seed=2,
                    device="cpu")
    assert np.argmin(got.all_losses) == np.argmin(want.all_losses)
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=RTOL_ADAM, atol=1e-20)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.beta, want.beta, rtol=0, atol=1e-8)
    assert got.feasible == want.feasible
    np.testing.assert_allclose(got.beta[pt.no_psite_tf, 0], 1.0, atol=1e-12)


def alpha_violation(prob, res):
    av = np.abs((res.alpha * prob.alpha_mask).sum(axis=1) - 1.0)
    return av[prob.alpha_mask.sum(axis=1) > 0].max()


@pytest.mark.parametrize("optimizer,gens_per_dispatch,n_gen,pop,gate", [
    (0, 1, 60, 60, 0.2), (0, 10, 60, 60, 0.2), (1, 1, 120, 40, 0.5), (2, 1, 120, 40, 0.5),
    (3, 1, 60, 40, 0.5)])
def test_evolutionary_quality(optimizer, gens_per_dispatch, n_gen, pop, gate):
    """The JAX package's gates on the port's own generator: U-NSGA-III on
    the host and all-device, SMS-EMOA, AGE-MOEA and NSGA-II reach an alpha
    violation below 0.2 / 0.5 with a finite loss."""
    pj, *_ = tf_problem()
    pt = tfopt_problem_from_reference(pj)
    res = run_evolutionary(pt, optimizer=optimizer, n_gen=n_gen, pop_size=pop, seed=1,
                           gens_per_dispatch=gens_per_dispatch, device="cpu")
    assert np.isfinite(res.loss)
    assert alpha_violation(pt, res) < gate
    assert res.all_losses.shape == (n_gen, 3)


# --- the data builders ----------------------------------------------------------------


def input_frames(seed=0):
    """input3 (mRNA, a duplicate gene, a gene without regulators), input1
    (TF protein rows and psite rows, a TF without protein data) and input4
    (the network, a duplicate edge)."""
    rng = np.random.default_rng(seed)
    genes = ["ga", "GB", "GC ", "GD", "GB", "GE"]
    mrna = pd.DataFrame({"GeneID": genes, **{f"x{i}": rng.uniform(0.5, 2.0, len(genes))
                                             for i in range(1, 10)}})
    rows = []
    for tf, sites in [("TF1", [None, "S1", "S2"]), ("TF2", [None]), ("TF3", ["", "T4"]),
                      ("TF4", ["S9"])]:
        for s in sites:
            rows.append([tf, s, *rng.uniform(0.5, 3.0, T)])
    prot = pd.DataFrame(rows, columns=["GeneID", "Psite", *[f"x{i}" for i in range(1, 15)]])
    net = pd.DataFrame({"Source": ["TF1", "TF2", "tf1", "TF3", "TF4", "TF2", "TF9"],
                        "Target": ["GA", "GA", "GB", "GB", "GC", "GD", "GE"]})
    return mrna, prot, net


def columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def assert_same_problem(got, want):
    for k in ("mRNA_mat", "regulators", "protein_mat", "psite_tensor", "num_psites"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert (got.gene_ids, got.tf_ids, got.psite_labels) == \
        (want.gene_ids, want.tf_ids, want.psite_labels)


@pytest.mark.parametrize("T_use", [9, 5])
def test_build_tfopt_problem_matches_jax(T_use):
    mrna, prot, net = input_frames()
    want, wmeta = jdata.build_tfopt_problem(mrna, prot, net, T_use=T_use)
    got, gmeta = data.build_tfopt_problem(columns(mrna), columns(prot), columns(net),
                                          T_use=T_use)
    assert_same_problem(got, want)
    assert gmeta == wmeta
    assert_same_problem(data.build_tfopt_problem(mrna, prot, net, T_use=T_use)[0], want)


def test_load_tfopt_problem_matches_jax(tmp_path):
    mrna, prot, net = input_frames(1)
    paths = [tmp_path / f"input{k}.csv" for k in (1, 3, 4)]
    for frame, p in zip((prot, mrna, net), paths):
        frame.to_csv(p, index=False)
    want, wmeta = jdata.load_tfopt_problem(*paths)
    got, gmeta = data.load_tfopt_problem(*paths)
    np.testing.assert_allclose(got.mRNA_mat, want.mRNA_mat, rtol=1e-15)
    np.testing.assert_allclose(got.psite_tensor, want.psite_tensor, rtol=1e-15)
    assert got.tf_ids == want.tf_ids and gmeta == wmeta


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pt = tfopt_problem_from_reference(tf_problem()[0])
    calls = [lambda: run_local(pt, n_starts=2, steps=1)]
    calls += [lambda o=o, g=g: run_evolutionary(pt, optimizer=o, pop_size=8, n_gen=1,
                                                gens_per_dispatch=g)
              for o, g in [(0, 1), (0, 10), (1, 1), (2, 1), (3, 1)]]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
