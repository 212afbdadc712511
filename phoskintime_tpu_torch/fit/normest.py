"""Per-gene parameter estimation ("normest").

Counterpart of ``phoskintime_tpu/fit/normest.py``. For each gene:

1. a lambda-regularization line search over ``logspace(-2, 0, 10)``, each
   lambda against every weight scheme, scored by :func:`score_fit`;
2. a 48-start multistart LM fit with jitter and stratified sampling at the
   winning (lambda, weight);
3. L2 regularization as appended pseudo-residuals ``lam/n_p * theta^2``;
4. the random model fitted in log-parameter space;
5. an optional bootstrap (multiplicative 5% Gaussian noise on the target);
6. Wald confidence intervals.

Each stage is one batch of LM lanes (:class:`_Lanes`, the JAX package's
vmapped ``_lanes_program``): the lanes run on the device with no host read
inside the loop, and each stage ends in ONE read of its packed results
(scores; for the fitting stages also the parameters and J^T J). The
covariance of the chosen lanes is then ``pinv(J^T J)`` on the host, with
JAX's cutoff. The per-gene seeding (seed + gene hash) and every numpy draw
are the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device, working_dtype
from phoskintime_tpu_torch.fit.ci import confidence_intervals
from phoskintime_tpu_torch.fit.score import score_fit
from phoskintime_tpu_torch.models.kinetics import OFFSET, n_params, solve_tensors, state_dim
from phoskintime_tpu_torch.models.weights import early_emphasis, get_weight_options
from phoskintime_tpu_torch.ops.lm import lm_loop, pinv

# the device memory one chunk of LM lanes may take, as a share of the card's
# memory: a lane's forward-mode Jacobian holds ~LANE_LIVE_MATRICES batches
# of T x (n_params + 1) augmented matrices at once
LANE_MEMORY_SHARE = 0.4
LANE_LIVE_MATRICES = 32
CPU_LANE_BYTES = 2 ** 32


def build_bounds(bounds: dict, num_psites: int, model: str):
    """Free-parameter bounds.

    dist/succ: [A, B, C, D, S*n, D*n] in linear space.
    randmod:   [A, B, C, D, S*n, Ddeg*(2^n - 1)] in LOG space.
    """
    lo = [bounds["A"][0], bounds["B"][0], bounds["C"][0], bounds["D"][0]]
    hi = [bounds["A"][1], bounds["B"][1], bounds["C"][1], bounds["D"][1]]
    lo += [bounds["S(i)"][0]] * num_psites
    hi += [bounds["S(i)"][1]] * num_psites
    if model == "randmod":
        m = (1 << num_psites) - 1
        lo += [bounds["D(i)"][0]] * m
        hi += [bounds["D(i)"][1]] * m
        eps = 1e-8
        lo = [np.log(max(b, eps)) for b in lo]
        hi = [np.log(max(b, eps)) for b in hi]
    else:
        lo += [bounds["D(i)"][0]] * num_psites
        hi += [bounds["D(i)"][1]] * num_psites
    return np.asarray(lo, float), np.asarray(hi, float)


def _multistart_p0(base: np.ndarray, lb: np.ndarray, ub: np.ndarray,
                   n_starts: int, jitter_frac: float, rng: np.random.Generator):
    """Jitter + stratified-uniform start cloud."""
    p0s = [np.clip(base, lb, ub)]
    span = np.where(ub - lb > 0, ub - lb, 1.0)
    for _ in range(max(0, n_starts // 3)):
        cand = base + jitter_frac * span * rng.normal(size=base.shape)
        p0s.append(np.clip(cand, lb, ub))
    remaining = max(0, n_starts - len(p0s))
    if remaining > 0:
        d = base.shape[0]
        U = np.empty((remaining, d))
        for j in range(d):
            u = (np.arange(remaining) + rng.random(remaining)) / float(remaining)
            rng.shuffle(u)
            U[:, j] = u
        p0s.extend(lb + U * (ub - lb))
    return np.stack(p0s)


def _phys_cov(pcov, popt, is_log: bool):
    """Physical-space covariance: for the log-space-fitted random model the
    delta method, Cov_phys = J Cov_log J^T with J = diag(exp(popt))."""
    if pcov is None or not is_log:
        return pcov
    j = np.exp(np.asarray(popt, float))
    return np.asarray(pcov, float) * np.outer(j, j)


class NormestResult(NamedTuple):
    params: np.ndarray           # physical-space best-fit parameters
    popt_raw: np.ndarray         # optimizer-space parameters (log for randmod)
    pcov: np.ndarray
    sol: np.ndarray              # (T, d) final trajectory
    fit: np.ndarray              # fit vector at best params
    error: float                 # mean squared error vs target
    score: float
    lambda_reg: float
    weight_name: str
    regularization_term: float
    ci: dict | None
    boot_params: np.ndarray | None


def lane_chunk(model: str, num_psites: int, n_times: int, device: torch.device,
               dtype: torch.dtype) -> int:
    """LM lanes a chunk: as many as the memory budget holds (the card's
    memory times LANE_MEMORY_SHARE; CPU_LANE_BYTES on the CPU)."""
    w = state_dim(model, num_psites) + 1
    lane = (LANE_LIVE_MATRICES * n_times * (n_params(model, num_psites) + 1) * w * w
            * torch.finfo(dtype).bits // 8)
    budget = (torch.cuda.get_device_properties(device).total_memory * LANE_MEMORY_SHARE
              if device.type == "cuda" else CPU_LANE_BYTES)
    return max(1, int(budget // lane))


class _Lanes:
    """The LM fit of one static configuration (model, sites,
    regularisation, iterations) over lanes: the counterpart of the JAX
    package's ``_lanes_program``. Per-lane data: p0, lambda, sigma, the
    fit target (with the zero regularisation rows) and the target."""

    def __init__(self, model, num_psites, use_regularization, lm_iters, time_points,
                 init_cond, lb, ub, device, dtype):
        self.model, self.n = model, num_psites
        self.npar = n_params(model, num_psites)
        self.is_log = model == "randmod"
        self.use_reg, self.lm_iters = use_regularization, lm_iters
        self.device, self.dtype = device, dtype
        self.t = self.tensor(time_points)
        self.y0 = self.tensor(init_cond)
        self.lb, self.ub = self.tensor(lb), self.tensor(ub)
        self.chunk = lane_chunk(model, num_psites, len(time_points), device, dtype)
        # one solve uploads the builders' static gather tables to the device
        # (cached), so that no host-to-device copy happens inside a loop
        self.fit_vec(self.lb)

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x), dtype=self.dtype, device=self.device)

    def fit_vec(self, p: torch.Tensor) -> torch.Tensor:
        pv = torch.exp(p) if self.is_log else p
        return solve_tensors(pv, self.y0, self.n, self.t, self.model)[1]

    def model_vec(self, p, lam):
        """The fit vector, with the regularisation rows appended."""
        y = self.fit_vec(p)
        if self.use_reg:
            y = torch.cat([y, (lam / self.npar)[..., None] * torch.square(p)], dim=-1)
        return y

    def residual(self, p, lam, sigma, tgt_fit):
        return (self.model_vec(p, lam) - tgt_fit) / sigma

    def run(self, p0, lam, sigma, tgt_fit, tgt, hessian: bool) -> np.ndarray:
        """Fit every lane; ONE host read at the end. Returns (lanes, k):
        the score, then (with ``hessian``) p and the flattened J^T J."""
        out = []
        for i in range(0, len(p0), self.chunk):
            sl = slice(i, i + self.chunk)
            args = (self.tensor(lam[sl]), self.tensor(sigma[sl]), self.tensor(tgt_fit[sl]))
            p, _, _, J = lm_loop(self.residual, self.tensor(p0[sl]), self.lb, self.ub, args,
                                 max_iters=self.lm_iters)
            pv = torch.exp(p) if self.is_log else p
            cols = [score_fit(pv, self.tensor(tgt[sl]), self.fit_vec(p))[:, None]]
            if hessian:
                cols += [p, (J.mT @ J).flatten(1)]
            out.append(torch.cat(cols, dim=1))
        return torch.cat(out).cpu().numpy()

    def scores(self, *lanes) -> np.ndarray:
        s = self.run(*lanes, hessian=False)[:, 0]
        return np.where(np.isfinite(s), s, np.inf)

    def fits(self, *lanes):
        """(scores, p (lanes, npar), pcov (lanes, npar, npar)) with the
        covariance on the host."""
        out = self.run(*lanes, hessian=True)
        s, p = out[:, 0], out[:, 1:1 + self.npar]
        H = torch.from_numpy(out[:, 1 + self.npar:].reshape(-1, self.npar, self.npar))
        return np.where(np.isfinite(s), s, np.inf), p, pinv(H).numpy()

    def finalize(self, popt: np.ndarray):
        """(param_final, sol, fit) on the host."""
        param_final = np.exp(popt) if self.is_log else popt
        sol, fit = solve_tensors(self.tensor(param_final), self.y0, self.n, self.t, self.model)
        return param_final, sol.cpu().numpy(), fit.cpu().numpy()

    def model_at(self, popt: np.ndarray, lam: float, tgt_fit: np.ndarray) -> np.ndarray:
        """residual(popt, lam, 1) + target, as the JAX package reads the
        model vector for its CIs."""
        tf = self.tensor(tgt_fit)
        r = self.residual(self.tensor(popt), self.tensor(lam), torch.ones_like(tf), tf)
        return (r + tf).cpu().numpy()


def _device(device, dtype):
    device = resolve_device(device)
    return device, dtype or working_dtype(device)


def normest(gene: str,
            pr_data: np.ndarray,
            p_data: np.ndarray,
            r_data: np.ndarray,
            init_cond: np.ndarray,
            num_psites: int,
            time_points: np.ndarray,
            bounds: dict,
            bootstraps: int = 0,
            model: str = "distmod",
            use_regularization: bool = True,
            ms_gauss_weights: np.ndarray | None = None,
            use_custom_weights: bool = False,
            n_starts: int = 48,
            jitter_frac: float = 0.10,
            lambdas: np.ndarray | None = None,
            seed: int = 42,
            lm_iters: int = 80,
            alpha_ci: float = 0.95,
            *,
            device=DEFAULT_DEVICE,
            dtype: torch.dtype | None = None) -> NormestResult:
    """Estimate one gene's kinetic parameters, each stage one batch of
    lanes on ``device`` (default: the card; raises where there is none) at
    ``dtype`` (default: float32 on the card, float64 on the CPU)."""
    device, dtype = _device(device, dtype)
    if lambdas is None:
        lambdas = np.logspace(-2, 0, 10)
    n_r = np.asarray(r_data, float).size
    if n_r != len(time_points) - OFFSET:
        raise ValueError(
            f"r_data has {n_r} points but the fit vector aligns RNA to "
            f"time_points[{OFFSET}:] = {len(time_points) - OFFSET} points "
            f"(reference normest.py fit-vector layout)")

    lb, ub = build_bounds(bounds, num_psites, model)
    npar = n_params(model, num_psites)
    if lb.shape[0] != npar:
        raise ValueError(f"bounds give {lb.shape[0]} parameters, the model has {npar}")

    rng0 = np.random.default_rng(seed)
    base_p0 = rng0.uniform(lb, ub)
    gene_hash = sum(ord(c) for c in str(gene)) % 1000003
    rng = np.random.default_rng(int(seed + gene_hash))

    target = np.concatenate([np.asarray(r_data, float).ravel(),
                             np.asarray(pr_data, float).ravel(),
                             np.asarray(p_data, float).ravel()])
    reg_len = npar if use_regularization else 0
    target_fit = (np.concatenate([target, np.zeros(npar)])
                  if use_regularization else target)

    early_w = early_emphasis(pr_data, p_data, time_points, num_psites)
    weight_options = get_weight_options(
        target, time_points, num_psites, use_regularization, reg_len,
        early_w, ms_gauss_weights, use_custom_weights=use_custom_weights)
    weight_names = list(weight_options.keys())
    sigmas = np.stack([weight_options[k] for k in weight_names])  # (W, m)

    lanes = _Lanes(model, num_psites, use_regularization, lm_iters, time_points,
                   init_cond, lb, ub, device, dtype)
    is_log = lanes.is_log

    def rows(x, n):
        return np.broadcast_to(x, (n,) + np.shape(x))

    # ---- stage 1: (lambda x weight) grid from the base start -------------
    L, W = len(lambdas), len(weight_names)
    scores1 = lanes.scores(rows(np.clip(base_p0, lb, ub), L * W), np.repeat(lambdas, W),
                           np.tile(sigmas, (L, 1)), rows(target_fit, L * W),
                           rows(target, L * W))
    k_best = int(np.argmin(scores1))
    lambda_reg = float(lambdas[k_best // W])
    weight_name = weight_names[k_best % W]
    sigma_best = sigmas[k_best % W]

    # ---- stage 2: multistart at the winning (lambda, weight) -------------
    p0s = _multistart_p0(base_p0, lb, ub, n_starts, jitter_frac, rng)
    S2 = len(p0s)
    scores2, popts, pcovs = lanes.fits(p0s, rows(lambda_reg, S2), rows(sigma_best, S2),
                                       rows(target_fit, S2), rows(target, S2))
    i_best = int(np.argmin(scores2))
    popt, pcov = popts[i_best], pcovs[i_best]
    best_score = float(scores2[i_best])

    # ---- bootstrap (optional): one more lane batch ------------------------
    boot_params = None
    if bootstraps > 0:
        B = bootstraps
        noise = rng.normal(0, 0.05, size=(B,) + target_fit.shape)
        noisy = target_fit[None] * (1 + noise)
        _, boot_params, bc = lanes.fits(rows(popt, B), rows(lambda_reg, B),
                                        rows(sigma_best, B), noisy, rows(target, B))
        popt = boot_params.mean(axis=0)
        pcov = bc.mean(axis=0)

    # ---- finalize ----------------------------------------------------------
    param_final, sol, fit = lanes.finalize(popt)
    error = float(np.sum(np.abs(fit - target) ** 2) / target.size)
    # in optimizer space, where the penalty is applied
    regularization_term = lambda_reg / npar * float(np.sum(popt ** 2))
    ci = confidence_intervals(param_final, _phys_cov(pcov, popt, is_log), target_fit,
                              lanes.model_at(popt, lambda_reg, target_fit),
                              alpha_val=1 - alpha_ci, use_custom_weights=use_custom_weights)
    return NormestResult(param_final, popt, pcov, sol, fit, error, best_score,
                         lambda_reg, weight_name, regularization_term, ci, boot_params)


def normest_batch(genes: list[str],
                  pr_batch: np.ndarray,
                  p_batch: np.ndarray,
                  r_batch: np.ndarray,
                  init_cond: np.ndarray,
                  num_psites: int,
                  time_points: np.ndarray,
                  bounds: dict,
                  model: str = "distmod",
                  use_regularization: bool = True,
                  ms_gauss_weights: list | None = None,
                  use_custom_weights: bool = False,
                  n_starts: int = 48,
                  jitter_frac: float = 0.10,
                  lambdas: np.ndarray | None = None,
                  seed: int = 42,
                  lm_iters: int = 80,
                  bootstraps: int = 0,
                  alpha_ci: float = 0.95,
                  *,
                  device=DEFAULT_DEVICE,
                  dtype: torch.dtype | None = None) -> dict[str, NormestResult]:
    """Fit a cohort of same-shape genes as two batches of lanes (three with
    the bootstrap): stage 1 runs (G x lambdas x weights) lanes, stage 2
    (G x starts). pr_batch (G, T), p_batch (G, n, T), r_batch (G, Tr);
    ``init_cond`` the shared steady state. Returns {gene: NormestResult},
    each equal to :func:`normest` of that gene."""
    device, dtype = _device(device, dtype)
    if lambdas is None:
        lambdas = np.logspace(-2, 0, 10)
    G = len(genes)
    lb, ub = build_bounds(bounds, num_psites, model)
    npar = n_params(model, num_psites)

    rng0 = np.random.default_rng(seed)
    base_p0 = rng0.uniform(lb, ub)

    targets = np.concatenate([
        np.asarray(r_batch, float).reshape(G, -1),
        np.asarray(pr_batch, float).reshape(G, -1),
        np.asarray(p_batch, float).reshape(G, -1)], axis=1)       # (G, m)
    reg_len = npar if use_regularization else 0
    targets_fit = (np.concatenate([targets, np.zeros((G, npar))], axis=1)
                   if use_regularization else targets)

    sigmas_all, weight_names = [], None
    for g in range(G):
        ew = early_emphasis(pr_batch[g], p_batch[g], time_points, num_psites)
        msw = ms_gauss_weights[g] if ms_gauss_weights is not None else None
        opts = get_weight_options(targets[g], time_points, num_psites,
                                  use_regularization, reg_len, ew, msw,
                                  use_custom_weights=use_custom_weights)
        if weight_names is None:
            weight_names = list(opts)
        sigmas_all.append(np.stack([opts[k] for k in weight_names]))
    sigmas_all = np.stack(sigmas_all)                             # (G, W, m)
    W = len(weight_names)
    L = len(lambdas)

    lanes = _Lanes(model, num_psites, use_regularization, lm_iters, time_points,
                   init_cond, lb, ub, device, dtype)
    is_log = lanes.is_log

    # ---- stage 1: (G x L x W) lanes from the shared base start ------------
    n1 = G * L * W
    scores1 = lanes.scores(np.broadcast_to(np.clip(base_p0, lb, ub), (n1, npar)),
                           np.tile(np.repeat(lambdas, W), G),
                           sigmas_all[:, None].repeat(L, 1).reshape(n1, -1),
                           np.repeat(targets_fit, L * W, axis=0),
                           np.repeat(targets, L * W, axis=0)).reshape(G, L * W)
    flat = scores1.argmin(axis=1)
    lam_best = lambdas[flat // W]                                  # (G,)
    w_best = flat % W
    sig_best = sigmas_all[np.arange(G), w_best]

    # ---- stage 2: (G x n_starts) multistart at each gene's winner ---------
    p0_stack, gene_rngs = [], []
    for gene in genes:
        gene_hash = sum(ord(c) for c in str(gene)) % 1000003
        rng = np.random.default_rng(int(seed + gene_hash))
        p0_stack.append(_multistart_p0(base_p0, lb, ub, n_starts, jitter_frac, rng))
        gene_rngs.append(rng)
    S = p0_stack[0].shape[0]
    scores2, popts, pcovs = lanes.fits(np.concatenate(p0_stack), np.repeat(lam_best, S),
                                       np.repeat(sig_best, S, axis=0),
                                       np.repeat(targets_fit, S, axis=0),
                                       np.repeat(targets, S, axis=0))
    scores2 = scores2.reshape(G, S)
    best = scores2.argmin(axis=1)
    popt_best = popts.reshape(G, S, npar)[np.arange(G), best]
    pcov_best = pcovs.reshape(G, S, npar, npar)[np.arange(G), best]

    # ---- stage 3 (optional): bootstrap as one more (G x B) lane batch -----
    boot_all = None
    if bootstraps > 0:
        B = bootstraps
        # each gene's noise continues its own multistart stream, as in the
        # single-gene path
        noise = np.stack([
            gene_rngs[g].normal(0, 0.05, size=(B,) + targets_fit.shape[1:])
            for g in range(G)])
        noisy = (targets_fit[:, None] * (1 + noise)).reshape(G * B, -1)
        _, bp, bc = lanes.fits(np.repeat(popt_best, B, axis=0), np.repeat(lam_best, B),
                               np.repeat(sig_best, B, axis=0), noisy,
                               np.repeat(targets, B, axis=0))
        boot_all = bp.reshape(G, B, npar)
        popt_best = boot_all.mean(axis=1)
        pcov_best = bc.reshape(G, B, npar, npar).mean(axis=1)

    # ---- assemble per-gene results -----------------------------------------
    out: dict[str, NormestResult] = {}
    for g, gene in enumerate(genes):
        popt, pcov = popt_best[g], pcov_best[g]
        param_final, sol, fit = lanes.finalize(popt)
        error = float(np.sum(np.abs(fit - targets[g]) ** 2) / targets[g].size)
        reg_term = float(lam_best[g]) / npar * float(np.sum(popt ** 2))
        mf = fit
        if use_regularization:
            mf = np.concatenate([fit, lam_best[g] / npar * popt ** 2])
        ci = confidence_intervals(param_final, _phys_cov(pcov, popt, is_log),
                                  targets_fit[g], mf, alpha_val=1 - alpha_ci,
                                  use_custom_weights=use_custom_weights)
        out[gene] = NormestResult(param_final, popt, pcov, sol, fit, error,
                                  float(scores2[g, best[g]]), float(lam_best[g]),
                                  weight_names[w_best[g]], reg_term, ci,
                                  boot_all[g] if boot_all is not None else None)
    return out
