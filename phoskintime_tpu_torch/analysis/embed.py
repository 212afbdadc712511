"""Embeddings of parameter ensembles and fitted profiles: PCA and t-SNE,
in numpy (float64, on the host, as the JAX package computes them through
scikit-learn).

:class:`PCA` computes what ``sklearn.decomposition.PCA(n_components=k)``
does with its default solver choice: the covariance's eigenvectors
("covariance_eigh", for at least ten samples a feature and at most 1,000
features) or the SVD of the centred data ("full"); the components' signs
as ``svd_flip`` fixes them (each component's largest entry positive);
``explained_variance_ratio_`` and ``fit_transform``. Where scikit-learn
would take its randomized solver (more than 500 samples or features, and
fewer components than 80% of them), this takes the full SVD, the result
the randomized one approximates.

:func:`tsne` is scikit-learn's ``TSNE(method="exact", init="pca")``
with its defaults: the squared Euclidean distances (as
``pairwise_distances(squared=True)`` computes them, then as float32),
the conditional probabilities by the binary search for the perplexity
(``_binary_search_perplexity``: 100 steps, tolerance 1e-5, the sums in
order), the joint P; the embedding initialized from the data's first two
principal components scaled to a standard deviation of 1e-4 (float32);
the learning rate ``max(n / 12 / 4, 50)``; 250 iterations at early
exaggeration 12 and momentum 0.5, then up to ``max_iter`` at momentum 0.8;
the gains update; the stop after 300 iterations without progress or at a
gradient norm of 1e-7, checked every 50 iterations. The JAX package calls
scikit-learn's default Barnes-Hut method, whose tree approximation this
does not reproduce: the two embeddings differ (ROADMAP.md section 3).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import linalg
from scipy.spatial.distance import pdist, squareform

MACHINE_EPSILON = np.finfo(np.double).eps
PERPLEXITY_TOL = float(np.float32(1e-5))
SUM_FLOOR = float(np.float32(1e-8))
EXPLORATION_ITERS = 250               # at early exaggeration and momentum 0.5
EXAGGERATION, MAX_ITER = 12.0, 1000
N_ITER_CHECK = 50


def svd_flip_rows(V: np.ndarray) -> np.ndarray:
    """``svd_flip(u_based_decision=False)``'s signs: each row of V with its
    largest absolute entry positive. Returns the signs."""
    idx = np.argmax(np.abs(V), axis=1)
    return np.sign(V[np.arange(V.shape[0]), idx])


class PCA:
    """Principal components of X (n_samples, n_features), ``n_components``
    of them (default ``min(X.shape)``)."""

    def __init__(self, n_components: int | None = None):
        self.n_components = n_components

    def fit(self, X) -> "PCA":
        self._fit(np.asarray(X, float))
        return self

    def fit_transform(self, X) -> np.ndarray:
        X = np.asarray(X, float)
        U, S = self._fit(X)
        if U is None:
            return X @ self.components_.T - self.mean_.reshape(1, -1) @ self.components_.T
        U = U[:, : self.n_components_]
        U *= S[: self.n_components_]
        return U

    def _fit(self, X):
        n, d = X.shape
        k = min(n, d) if self.n_components is None else int(self.n_components)
        self.mean_ = np.mean(X, axis=0).reshape(-1)
        if not (d <= 1000 and n >= 10 * d):        # scikit-learn's "full" solver
            Xc = X.copy()
            Xc -= self.mean_
            U, S, Vt = linalg.svd(Xc, full_matrices=False)
            explained = (S ** 2) / (n - 1)
        else:
            C = X.T @ X
            C -= n * self.mean_.reshape(-1, 1) * self.mean_.reshape(1, -1)
            C /= n - 1
            vals, vecs = np.linalg.eigh(C)
            vals, vecs = np.flip(vals.reshape(-1), axis=0), np.flip(vecs, axis=1)
            vals[vals < 0.0] = 0.0
            explained = vals
            S = np.sqrt(vals * (n - 1))
            Vt, U = vecs.T, None
        signs = svd_flip_rows(Vt)
        if U is not None:
            U *= signs[np.newaxis, :]
        Vt *= signs[:, np.newaxis]
        self.n_components_ = k
        self.components_ = Vt[:k]
        self.explained_variance_ratio_ = (explained / np.sum(explained))[:k]
        return U, S


def squared_distances(X: np.ndarray) -> np.ndarray:
    """``pairwise_distances(X, squared=True)`` as scikit-learn computes it:
    -2 X X^T + |x|^2 + |y|^2, clipped at 0, the diagonal 0."""
    XX = np.einsum("ij,ij->i", X, X)[:, np.newaxis]
    D = -2 * (X @ X.T)
    D += XX
    D += XX.T
    np.maximum(D, 0, out=D)
    np.fill_diagonal(D, 0)
    return D


def _libm_exp(x: np.ndarray) -> np.ndarray:
    """exp through the C library, as the compiled search calls it (numpy's
    vectorised exp and log differ from the C library's in the last bit
    for some arguments, which can move a row's bisection by a step)."""
    return np.fromiter(map(math.exp, x.ravel().tolist()), float, x.size).reshape(x.shape)


def conditional_probabilities(sqdist: np.ndarray, perplexity: float) -> np.ndarray:
    """``_binary_search_perplexity`` on the (n, n) float32 squared distances:
    row i's Gaussian precision found by bisection (100 steps at most) so
    that its entropy is log(perplexity) within 1e-5; float64 P (n, n) with
    a zero diagonal. The rows search together; each row's sums run in
    index order, as the compiled loop adds them."""
    D = np.asarray(sqdist, np.float32).astype(np.float64)
    n = D.shape[0]
    desired = math.log(float(np.float32(perplexity)))
    beta = np.ones(n)
    beta_min, beta_max = np.full(n, -np.inf), np.full(n, np.inf)
    active = np.ones(n, bool)
    P = np.zeros((n, n))
    off = ~np.eye(n, dtype=bool)
    for _ in range(100):
        rows = np.flatnonzero(active)
        if not len(rows):
            break
        Pr = np.where(off[rows], _libm_exp(-D[rows] * beta[rows, None]), 0.0)
        s = np.cumsum(Pr, axis=1)[:, -1]
        s = np.where(s == 0.0, SUM_FLOOR, s)
        Pr /= s[:, None]
        sd = np.cumsum(D[rows] * Pr, axis=1)[:, -1]
        P[rows] = Pr
        entropy = np.fromiter(map(math.log, s.tolist()), float, len(s)) + beta[rows] * sd
        diff = entropy - desired
        done = np.abs(diff) <= PERPLEXITY_TOL
        up, down = ~done & (diff > 0.0), ~done & (diff <= 0.0)
        r_up, r_dn = rows[up], rows[down]
        beta_min[r_up] = beta[r_up]
        beta[r_up] = np.where(beta_max[r_up] == np.inf, beta[r_up] * 2.0,
                              (beta[r_up] + beta_max[r_up]) / 2.0)
        beta_max[r_dn] = beta[r_dn]
        beta[r_dn] = np.where(beta_min[r_dn] == -np.inf, beta[r_dn] / 2.0,
                              (beta[r_dn] + beta_min[r_dn]) / 2.0)
        active[rows[done]] = False
    return P


def joint_probabilities(sqdist: np.ndarray, perplexity: float) -> np.ndarray:
    """``_joint_probabilities``: the symmetrised conditional P, normalised,
    floored at machine epsilon, condensed (n (n - 1) / 2,)."""
    cond = conditional_probabilities(sqdist, perplexity)
    P = cond + cond.T
    total = np.maximum(np.sum(P), MACHINE_EPSILON)
    return np.maximum(squareform(P) / total, MACHINE_EPSILON)


def kl_divergence(params, P, dof: float, n: int, k: int, compute_error: bool = True):
    """``_kl_divergence``: the KL divergence of P and the Student-t Q of the
    embedding, and its gradient (in the embedding's dtype)."""
    Y = params.reshape(n, k)
    dist = pdist(Y, "sqeuclidean")
    dist /= dof
    dist += 1.0
    dist **= (dof + 1.0) / -2.0
    Q = np.maximum(dist / (2.0 * np.sum(dist)), MACHINE_EPSILON)
    kl = 2.0 * np.dot(P, np.log(np.maximum(P, MACHINE_EPSILON) / Q)) if compute_error else np.nan
    grad = np.ndarray((n, k), dtype=params.dtype)
    PQd = squareform((P - Q) * dist)
    for i in range(n):
        grad[i] = np.dot(np.ravel(PQd[i], order="K"), Y[i] - Y)
    grad = grad.ravel()
    grad *= 2.0 * (dof + 1.0) / dof
    return kl, grad


def _gradient_descent(p0, P, n, k, it, max_iter, momentum, learning_rate,
                      n_iter_without_progress, min_gain=0.01, min_grad_norm=1e-7):
    p = p0.copy().ravel()
    update = np.zeros_like(p)
    gains = np.ones_like(p)
    error = best_error = np.finfo(float).max
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        error, grad = kl_divergence(p, P, 1, n, k, compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        dec = np.invert(inc)
        gains[inc] += 0.2
        gains[dec] *= 0.8
        np.clip(gains, min_gain, np.inf, out=gains)
        grad *= gains
        update = momentum * update - learning_rate * grad
        p += update
        if check:
            grad_norm = linalg.norm(grad)
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return p, error, i


def tsne(X, perplexity: float = 30.0) -> np.ndarray:
    """The exact two-dimensional t-SNE embedding (n, 2) of X,
    PCA-initialised (see the module docstring); float32, as scikit-learn
    returns it."""
    X = np.asarray(X, float)
    n = X.shape[0]
    if not perplexity < n:
        raise ValueError(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    learning_rate = np.maximum(n / EXAGGERATION / 4, 50)
    P = joint_probabilities(squared_distances(X).astype(np.float32, copy=False), perplexity)
    Y = PCA(2).fit_transform(X).astype(np.float32, copy=False)
    Y = Y / np.std(Y[:, 0]) * 1e-4
    P *= EXAGGERATION
    params, _, it = _gradient_descent(Y.ravel(), P, n, 2, 0, EXPLORATION_ITERS, 0.5,
                                      learning_rate, EXPLORATION_ITERS)
    P /= EXAGGERATION
    params, _, it = _gradient_descent(params, P, n, 2, it + 1, MAX_ITER, 0.8, learning_rate,
                                      300)
    return params.reshape(n, 2)
