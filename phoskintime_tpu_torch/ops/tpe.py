"""Multi-objective Tree-structured Parzen Estimator (MOTPE) sampler.

Counterpart of ``phoskintime_tpu/ops/tpe.py`` (numpy only, its own copy):
an ask/tell sampler from the published algorithm (Bergstra et al. 2011
TPE; Ozaki et al. 2020 MOTPE), in place of Optuna's MOTPE:

* observations are split into "good" / "bad" by non-dominated rank (then
  crowding) with gamma = ceil(0.1 * n);
* each dimension gets two 1-D Parzen estimators (truncated Gaussians with
  neighbour-distance bandwidths, "magic-clipped");
* candidates are drawn from the good model and ranked by the density ratio
  l(x)/g(x); the best of ``n_ei_candidates`` is proposed.

The same seed and the same told history give the same asks as the JAX
package's sampler, bit for bit: the same ``default_rng`` calls in the same
order. :meth:`MOTPESampler.ask_batch` computes the split and each
dimension's two estimators once per batch, where the JAX package rebuilds
them for every ask: they depend only on the told history, which a batch
does not change, and they draw nothing. The sampler's state is plain numpy
(the ask/tell history and the rng's state), saved by
:func:`~phoskintime_tpu_torch.parallel.checkpoint.save_sampler`.
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu_torch.ops.nsga import crowding_distance, fast_non_dominated_sort


class ParzenEstimator1D:
    """A mixture of Gaussians at the samples and one wide prior component
    at mid-range, equal weights, clipped to [low, high] when sampled."""

    def __init__(self, samples: np.ndarray, low: float, high: float):
        self.low, self.high = low, high
        span = max(high - low, 1e-12)
        mid = 0.5 * (low + high)
        # the prior joins the samples before the sort, so that every
        # neighbour gap is taken over the full sorted list
        mus = np.sort(np.concatenate([[mid], samples]))
        prior_idx = int(np.searchsorted(mus, mid))
        n = len(mus)
        if n > 2:
            gaps = np.empty(n)
            gaps[1:-1] = np.maximum(mus[2:] - mus[:-2], 1e-12)
            gaps[0] = gaps[-1] = span
            sigmas = np.clip(gaps, span / min(100.0, n), span)
        else:
            sigmas = np.full(n, span)
        sigmas[prior_idx] = span
        self.mus, self.sigmas = mus, sigmas
        self.weights = np.full(n, 1.0 / n)

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        comp = rng.choice(len(self.mus), size=size, p=self.weights)
        x = rng.normal(self.mus[comp], self.sigmas[comp])
        return np.clip(x, self.low, self.high)

    def log_pdf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, float)[:, None]
        z = (x - self.mus[None]) / self.sigmas[None]
        comp = (np.log(self.weights[None])
                - 0.5 * z ** 2 - np.log(self.sigmas[None] * np.sqrt(2 * np.pi)))
        m = comp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(comp - m).sum(axis=1, keepdims=True))).ravel()


class MOTPESampler:
    """Ask/tell multi-objective TPE over box bounds."""

    def __init__(self, xl, xu, seed: int = 42, n_startup_trials: int = 11,
                 n_ei_candidates: int = 24, gamma: float = 0.10):
        self.xl = np.asarray(xl, float)
        self.xu = np.asarray(xu, float)
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup_trials
        self.n_ei = n_ei_candidates
        self.gamma = gamma
        self.X: list[np.ndarray] = []
        self.F: list[np.ndarray] = []

    # -- persistence -----------------------------------------------------
    def state_dict(self) -> dict:
        return {"X": np.asarray(self.X), "F": np.asarray(self.F),
                "rng": self.rng.bit_generator.state}

    def load_state_dict(self, st: dict) -> None:
        self.X = [np.asarray(x) for x in st["X"]]
        self.F = [np.asarray(f) for f in st["F"]]
        self.rng.bit_generator.state = st["rng"]

    # -- core ------------------------------------------------------------
    def _split(self) -> tuple[np.ndarray, np.ndarray]:
        """Indices of the good and the bad trials: the first
        ceil(gamma n) in order of front, then of descending crowding."""
        F = np.asarray(self.F, float)
        n_good = max(1, int(np.ceil(self.gamma * len(F))))
        order: list[int] = []
        for fr in fast_non_dominated_sort(F):
            cd = crowding_distance(F[fr])
            order.extend(fr[np.argsort(-cd, kind="stable")].tolist())
        return np.asarray(order[:n_good], int), np.asarray(order[n_good:], int)

    def _estimators(self):
        """Each dimension's (good, bad) estimators of the told history, or
        None while asks are uniform (startup, or no bad trial yet)."""
        if len(self.X) < self.n_startup or len(self.X) < 2:
            return None
        good, bad = self._split()
        if len(bad) == 0:
            return None
        X = np.asarray(self.X, float)
        return [(ParzenEstimator1D(X[good, j], self.xl[j], self.xu[j]),
                 ParzenEstimator1D(X[bad, j], self.xl[j], self.xu[j]))
                for j in range(len(self.xl))]

    def _ask_with(self, estimators) -> np.ndarray:
        if estimators is None:
            return self.rng.uniform(self.xl, self.xu)
        x = np.empty(len(self.xl))
        for j, (l_est, g_est) in enumerate(estimators):
            cands = l_est.sample(self.rng, self.n_ei)
            score = l_est.log_pdf(cands) - g_est.log_pdf(cands)
            x[j] = cands[int(np.argmax(score))]
        return x

    def ask(self) -> np.ndarray:
        return self._ask_with(self._estimators())

    def ask_batch(self, n: int) -> np.ndarray:
        est = self._estimators()
        return np.stack([self._ask_with(est) for _ in range(n)])

    def tell(self, x: np.ndarray, f: np.ndarray) -> None:
        """Record a trial; one with a non-finite objective (a failed
        solve) is dropped."""
        f = np.atleast_1d(np.asarray(f, float))
        if not np.all(np.isfinite(f)):
            return
        self.X.append(np.asarray(x, float))
        self.F.append(f)

    def tell_batch(self, X: np.ndarray, F: np.ndarray) -> None:
        for x, f in zip(X, F):
            self.tell(x, f)

    @property
    def pareto(self):
        """The non-dominated trials told so far: (X, F)."""
        if not self.F:
            return np.zeros((0, len(self.xl))), np.zeros((0, 0))
        X = np.asarray(self.X)
        F = np.asarray(self.F)
        pf = fast_non_dominated_sort(F)[0]
        return X[pf], F[pf]


def run_motpe(evaluate, xl, xu, n_trials=1000, batch_size=16, seed=42,
              callback=None) -> tuple[np.ndarray, np.ndarray, MOTPESampler]:
    """Drive MOTPE in batches: ``evaluate`` maps (B, n) to (B, n_obj).
    Returns (pareto_X, pareto_F, sampler)."""
    sampler = MOTPESampler(xl, xu, seed=seed)
    done = 0
    while done < n_trials:
        b = min(batch_size, n_trials - done)
        Xb = sampler.ask_batch(b)
        Fb = np.asarray(evaluate(Xb), float)
        sampler.tell_batch(Xb, Fb)
        done += b
        if callback is not None:
            callback(done, sampler)
    pX, pF = sampler.pareto
    return pX, pF, sampler
