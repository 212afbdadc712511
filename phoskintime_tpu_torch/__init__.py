"""phoskintime_tpu_torch — the PyTorch/CUDA port of ``phoskintime_tpu``.

The JAX package is the reference; this package mirrors its module paths
(``network/expo.py`` here is the counterpart of ``network/expo.py`` there)
and is held against it by the parity tests in ``tests/test_torch_*.py``.

Conventions:

* plain functions on tensors; parameters are dicts of tensors with a
  leading population axis where the JAX package vmaps;
* every tensor is made with an explicit ``device`` and ``dtype``
  (:mod:`phoskintime_tpu_torch.config.numerics` holds the policy);
* host-side draws use numpy ``default_rng``.

Importing the package loads torch and numpy only: no JAX, no kernel build.
Each hand-written CUDA kernel is compiled on first use (see
:mod:`phoskintime_tpu_torch.ops.cuda_build`).
"""

__version__ = "0.1.0"
