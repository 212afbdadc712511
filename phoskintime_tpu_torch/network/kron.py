"""Kronecker-factorized ETD2RK path for the combinatorial mechanism (model 2).

Counterpart of ``phoskintime_tpu/network/kron.py``, plain PyTorch: the JAX
package computes it in XLA outside every Pallas kernel, so it has no kernel
here either. Reached through
``exponential_simulate_batched(..., use_kron=True)``; the default stays
the dense path.

For per-site independent rates the 2^s-state linear operator is (almost) a
Kronecker sum

    K = (+)_j A_j - D delta_0,   A_j = [[-S_j,  E            ],
                                        [ S_j, -(E + Dp_j + D)]]

acting on bit j of the mask index (basis per bit: [clear, set]). The
rank-one mask-0 correction -D delta_0 does not commute with the sum, so the
path re-splits: L = diag(-B, (+)_j A_j), which factors, and the correction
with the translation C R moves into the ETD2RK remainder,

    g(y) = synth(y) e_R + (C R - D X_0) e_{X_0}.

Then exp(h A_j) is a closed-form 2 x 2 exponential a site and lane, E y is
s axis-wise 2 x 2 contractions, and the phi vectors take the dense path's
scaling, Taylor series and doubling ladder with every matrix operation
collapsed to factor squarings and factorized matvecs.

The path is exact linear algebra but opt-in only, as in the JAX package:
the remainder's -D X_0 sits under the ETD2RK correction stage's RK2-like
stability bound |h D| <~ 2. At substep 0.5 it agrees with the dense path;
at substep 4 (h D > 2) it diverges (``tests/test_torch_kron.py`` holds both
against the JAX package). Every loop is unrolled to a static count with
masks, so ``torch.autograd`` differentiates it.
"""

from __future__ import annotations

import numpy as np
import torch

from phoskintime_tpu_torch.network.expo import _run_plan
from phoskintime_tpu_torch.network.rhs import synthesis_rate
from phoskintime_tpu_torch.ops.phi_tables import ladder_len


def _taylor_radius(dtype) -> float:
    """The pre-squaring Taylor radius of the dense path: 0.25 in float64,
    0.5 in float32."""
    return 0.25 if dtype == torch.float64 else 0.5


# ---------------------------------------------------------------------------
# factor algebra (all shapes (s, ..., B): site-major, lanes minor)
# ---------------------------------------------------------------------------


def _expm2x2(a, b, c, d):
    """Closed-form exp of [[a, b], [c, d]], elementwise over the batch.

    Eigenvalues mu +- rt, mu = (a + d) / 2, rt = sqrt(((a - d) / 2)^2 + b c);
    on this RHS family b c = E S_j >= 0, so rt is real and both eigenvalues
    are <= 0. An all-zero (masked-site) block maps exactly to the identity.
    Returns (g00, g01, g10, g11)."""
    mu = 0.5 * (a + d)
    de = 0.5 * (a - d)
    disc = de * de + b * c
    # the square root's derivative is infinite at 0: the double where keeps
    # it out of a masked site's gradient
    pos = disc > 1e-12
    one = torch.ones_like(disc)
    rt = torch.where(pos, torch.sqrt(torch.where(pos, disc, one)), torch.zeros_like(disc))
    ch = torch.cosh(rt)
    # sinh(rt) / rt, stable at rt -> 0 (series 1 + rt^2 / 6)
    small = rt < 1e-4
    sh = torch.where(small, 1.0 + disc / 6.0, torch.sinh(rt) / torch.where(small, one, rt))
    em = torch.exp(mu)
    return em * (ch + sh * de), em * (sh * b), em * (sh * c), em * (ch - sh * de)


def _factor_square(G):
    """Square every 2 x 2 factor: G (s, 2, 2, B) -> G @ G a site."""
    g00, g01 = G[:, 0, 0], G[:, 0, 1]
    g10, g11 = G[:, 1, 0], G[:, 1, 1]
    n00 = g00 * g00 + g01 * g10
    n01 = g00 * g01 + g01 * g11
    n10 = g10 * g00 + g11 * g10
    n11 = g10 * g01 + g11 * g11
    return torch.stack([torch.stack([n00, n01], 1), torch.stack([n10, n11], 1)], 1)


def _kron_mv(G, X, s_sites: int):
    """((x)_j G_j) X with X (M, B), M = 2^s: s axis-wise 2 x 2 contractions.
    Bit j of the mask index m has stride 2^j, so after a row-major reshape
    to (2,)*s + (B,) bit j lives on axis s - 1 - j."""
    if s_sites == 0:
        return X
    B = X.shape[-1]
    T = X.reshape((2,) * s_sites + (B,))
    for j in range(s_sites):
        ax = s_sites - 1 - j
        x0, x1 = T.select(ax, 0), T.select(ax, 1)
        n0 = G[j, 0, 0] * x0 + G[j, 0, 1] * x1
        n1 = G[j, 1, 0] * x0 + G[j, 1, 1] * x1
        T = torch.stack([n0, n1], dim=ax)
    return T.reshape(1 << s_sites, B)


def _ksum_mv(a, b, c, d, X, s_sites: int):
    """((+)_j A_j) X, the Kronecker-sum matvec of the phi vectors' Taylor
    stage: the sum of the axis-wise 2 x 2 applies."""
    if s_sites == 0:
        return torch.zeros_like(X)
    B = X.shape[-1]
    T = X.reshape((2,) * s_sites + (B,))
    out = None
    for j in range(s_sites):
        ax = s_sites - 1 - j
        x0, x1 = T.select(ax, 0), T.select(ax, 1)
        contrib = torch.stack([a[j] * x0 + b[j] * x1, c[j] * x0 + d[j] * x1], dim=ax)
        out = contrib if out is None else out + contrib
    return out.reshape(1 << s_sites, B)


def _phi_vectors_kron(a, b, c, d, h: float, unroll: int, dtype):
    """The factorized counterpart of the dense lane build.

    a..d (s, B): each site's generator entries per unit time; h static.
    Returns G (s, 2, 2, B), the factors of exp(h (+)A_j), q1 (M, B) =
    h phi1(hK) e0 and q2 (M, B) = h^2 phi2(hK) e0: the dense path's radius
    and Taylor terms for the vectors, closed-form factor exponentials, and
    the doubling identities q1(2h) = (I + E) q1, q2(2h) = (I + E) q2 + h q1
    with every E-apply factorized; ``unroll`` masked ladder steps, each
    lane stepping while below its own squaring count."""
    s_sites, B = a.shape
    M = 1 << s_sites
    rows = torch.maximum(torch.abs(a) + torch.abs(b), torch.abs(c) + torch.abs(d))
    nu = h * (torch.sum(rows, dim=0) if s_sites else rows.new_zeros((B,)))
    rad = _taylor_radius(dtype)
    sq = torch.clamp(torch.ceil(torch.log2(torch.clamp(nu, min=1e-30) / rad)), min=0.0)
    sq = torch.clamp(sq, max=float(unroll))
    hs = torch.as_tensor(h, dtype=dtype, device=a.device) / torch.exp2(sq)     # (B,)
    ah, bh, chh, dh = (x * hs[None] for x in (a, b, c, d))
    g00, g01, g10, g11 = _expm2x2(ah, bh, chh, dh)
    G = torch.stack([torch.stack([g00, g01], 1), torch.stack([g10, g11], 1)], 1)

    terms = 12 if dtype == torch.float64 else 8
    e0 = a.new_zeros((M, B))
    e0[0] = 1.0
    term, v1, v2 = e0, e0, e0 / 2.0
    for k in range(1, terms + 1):
        term = _ksum_mv(ah, bh, chh, dh, term, s_sites) / k
        v1 = v1 + term / (k + 1)
        v2 = v2 + term / ((k + 1) * (k + 2))
    q1 = v1 * hs[None]
    q2 = v2 * (hs * hs)[None]

    hc = hs
    for i in range(unroll):
        go_l = i < sq                                       # (B,)
        q2n = q2 + _kron_mv(G, q2, s_sites) + q1 * hc[None]
        q1n = q1 + _kron_mv(G, q1, s_sites)
        G = torch.where(go_l[None, None, None], _factor_square(G), G)
        q1 = torch.where(go_l[None], q1n, q1)
        q2 = torch.where(go_l[None], q2n, q2)
        hc = torch.where(go_l, 2.0 * hc, hc)
    return G, q1, q2


def _r_scalars(Bl, h: float, dtype):
    """The R slot's propagator scalars e^{-B h}, h phi1(-B h), h^2 phi2(-B h)
    (expm1-stable; the series below |x| = 1e-3)."""
    x = -Bl * torch.as_tensor(h, dtype=dtype, device=Bl.device)
    small = torch.abs(x) < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    eR = torch.exp(x)
    p1 = torch.where(small, h * (1.0 + x / 2 + x * x / 6), h * torch.expm1(x) / xs)
    p2 = torch.where(small, h * h * (0.5 + x / 6 + x * x / 24),
                     h * h * (torch.expm1(x) - x) / (xs * xs))
    return eR, p1, p2


# ---------------------------------------------------------------------------
# table build + segment scan
# ---------------------------------------------------------------------------


def _site_entry_lanes(system, params_b: dict, buckets, dtype):
    """Each site's 2 x 2 generator entries as lane planes: (a, c) (Bu, s,
    P*N), the only bucket-dependent entries (-S_j, S_j); b, d (s, P*N); and
    the B, C, D lanes (P*N,). A masked site has all-zero entries (its factor
    the identity), so proteins of different site counts share one layout."""
    rhs = system.rhs
    N, Smax = rhs.N, rhs.Smax
    P = params_b["c_k"].shape[0]
    Bu = len(buckets)
    dev = rhs.Kmat.device

    def lane(x):                                       # (P, N) -> (P*N,)
        return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=dev), (P, N)).reshape(-1)

    bk = torch.as_tensor(np.asarray(buckets, np.int64), device=dev)
    Kt = (params_b["c_k"][None] * rhs.Kmat[:, bk].T[:, None, :]).to(dtype)   # (Bu, P, K)
    msk = rhs.site_mask                                                      # (N, Smax)
    S = (torch.stack([torch.einsum("bpk,nk->bpn", Kt, (rhs.W_pad[:, j, :] * msk[:, j:j + 1])
                                   .to(dtype)).reshape(Bu, P * N) for j in range(Smax)], dim=1)
         if Smax else Kt.new_zeros((Bu, 0, P * N)))                         # (Bu, s, PN)
    E_l, D_l, B_l, C_l = (lane(params_b[k]) for k in ("E_i", "D_i", "B_i", "C_i"))
    mj = (torch.stack([lane(msk[None, :, j]) for j in range(Smax)]) if Smax
          else Kt.new_zeros((0, P * N)))                                    # (s, PN)
    Dp = torch.stack([lane(params_b["Dp_i"][:, :, j]) for j in range(Smax)]) if Smax else mj
    b = E_l[None] * mj
    d = -(E_l[None] + Dp + D_l[None]) * mj
    return -S, S, b, d, B_l, C_l, D_l


def kron_simulate_batched(system, params_b: dict, y0b, plan, dtype):
    """Model 2's batched ETD2RK over the factorized splitting.

    ``params_b`` tensors with a leading P at ``dtype`` on the system's
    device, y0b (P, N*w), ``plan`` the ``expo._segment_plan`` tuple. The
    scan follows the dense path's runs of equal (bucket, h) segments, the
    tables fixed a run, a state kept at each run's end. Returns (ys (P, T,
    N*w), success (P,))."""
    (_, seg_h, seg_jb, out_idx, seg_uidx, u_jb, u_h) = plan
    rhs = system.rhs
    N, w, Smax = system.topo.N, system.topo.width, rhs.Smax
    P = params_b["c_k"].shape[0]

    bucket_uniq, bucket_inv = np.unique(u_jb, return_inverse=True)
    a_b, c_b, b_sh, d_sh, B_l, C_l, D_l = _site_entry_lanes(system, params_b, bucket_uniq, dtype)

    # a pair's tables; the ladder sized from the static h by the dense
    # path's rate cap
    tables = []
    for u in range(len(u_h)):
        h_u = float(u_h[u])
        slot = int(bucket_inv[u])
        G, q1, q2 = _phi_vectors_kron(a_b[slot], b_sh, c_b[slot], d_sh, h_u,
                                      ladder_len(w, h_u), dtype)
        tables.append((G, q1, q2) + _r_scalars(B_l, h_u, dtype))

    # the lane synthesis drive (model 2's total protein)
    stm_lane = rhs.state_mask.T.to(dtype).repeat(1, P)                      # (M, PN)
    drv_lane = rhs.driven.repeat(P)
    n_buckets = rhs.Kmat.shape[1]
    A_p = params_b["A_i"]                                                   # (P, N)
    ts_p = params_b["tf_scale"][:, None]

    def synth_of(yl, jb: int):
        tot = torch.sum(yl[1:] * stm_lane, dim=0)                           # (PN,)
        jbc = min(max(int(jb), 0), n_buckets - 1)
        Kt = rhs.Kmat[:, jbc][None, :] * params_b["c_k"]                    # (P, K)
        Pv = torch.where(drv_lane, Kt[:, rhs.driver_idx].reshape(-1), tot)
        v = (Pv.reshape(P, N) @ rhs.tf_mat.T) / rhs.tf_deg[None]
        uu = v / (1.0 + torch.abs(v))
        return synthesis_rate(A_p, ts_p, uu).reshape(P * N)

    runs, out_pos = _run_plan(seg_uidx, out_idx)
    yl = y0b.reshape(P * N, w).T                                            # (w, PN)
    states = [yl]
    for start, n in runs:
        G, q1, q2, eR, p1R, p2R = tables[int(seg_uidx[start])]
        jb = int(seg_jb[start])
        h = float(seg_h[start])
        p2Rh, q2h = p2R * (1.0 / h), q2 * (1.0 / h)
        for _ in range(n):
            R, X = yl[0], yl[1:]
            s_n = synth_of(yl, jb)
            gX_n = C_l * R - D_l * X[0]
            aR = eR * R + p1R * s_n
            aX = _kron_mv(G, X, Smax) + q1 * gX_n[None]
            s_a = synth_of(torch.cat([aR[None], aX], dim=0), jb)
            gX_a = C_l * aR - D_l * aX[0]
            yR = aR + p2Rh * (s_a - s_n)
            yX = aX + q2h * (gX_a - gX_n)[None]
            yl = torch.cat([yR[None], yX], dim=0)
        states.append(yl)

    sel = torch.stack([states[int(k)] for k in out_pos])                   # (T, w, PN)
    T = len(out_idx)
    ys = sel.reshape(T, w, P, N).permute(2, 0, 3, 1).reshape(P, T, N * w)
    return ys, torch.isfinite(ys).all(dim=2).all(dim=1)
