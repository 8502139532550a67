"""Monocular bootstrap: parallel homography/fundamental RANSAC + SfM recovery.

Capability analog of the reference `Initializer`
(`/root/reference/src/Initializer.cc:45-122`): score a homography (8-pt DLT)
and a fundamental matrix (8-pt, rank-2) over the same correspondences,
select by RH = SH/(SH+SF) > 0.40 (`:113-119`), then recover (R,t) + structure
— 4 hypotheses from E (`DecomposeE` :910), 8 Faugeras hypotheses from H
(`ReconstructH` :573) — gated by cheirality/parallax/reprojection (`CheckRT`
:799). Scoring thresholds match the reference (`:306-469`): sigma=1.0,
th_H=5.991, th_F=3.841, score cap th_score=5.991.

Accelerator-first: the reference runs 200 RANSAC iterations in two threads
(`:105-110`); here BOTH models' 200 hypotheses evaluate as one vmapped batch
— every 8-point solve is an independent tiny SVD, every score a masked
reduction over all correspondences.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import projection as proj
from ..geometry import se3

TH_H = 5.991
TH_F = 3.841
TH_SCORE = 5.991  # both models' per-point score cap uses chi2(2dof)
N_ITERS = 200
MIN_PARALLAX_DEG = 1.0


class InitResult(NamedTuple):
    success: jnp.ndarray      # bool
    pose21: jnp.ndarray       # f32[7] frame1->frame2 (Tcw of frame2 if frame1 = I)
    points3d: jnp.ndarray     # f32[M,3] triangulated in frame-1 coords
    is_good: jnp.ndarray      # bool[M] triangulation gates passed
    used_homography: jnp.ndarray  # bool


def _normalize(pts, valid):
    """Hartley normalization (Normalize, :750): zero-mean, unit mean abs dev."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(w.sum(), 1.0)
    mean = (pts * w[:, None]).sum(0) / n
    d = (jnp.abs(pts - mean) * w[:, None]).sum(0) / n
    s = 1.0 / jnp.maximum(d, 1e-8)
    T = jnp.array(
        [[s[0], 0, -mean[0] * s[0]], [0, s[1], -mean[1] * s[1]], [0, 0, 1.0]]
    )
    pn = (pts - mean) * s
    return pn, T


def _compute_h(p1, p2):
    """8-pt (4+ needed) homography DLT (ComputeH21, :227): p: [8,2] each."""
    def rows(a, b):
        x, y = a
        u, v = b
        r1 = jnp.array([0, 0, 0, -x, -y, -1, v * x, v * y, v])
        r2 = jnp.array([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        return jnp.stack([r1, r2])

    A = jnp.concatenate(jax.vmap(rows)(p1, p2))  # [16,9]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[-1].reshape(3, 3)


def _compute_f(p1, p2):
    """8-pt fundamental + rank-2 projection (ComputeF21, :269)."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    A = jnp.stack(
        [u * x, u * y, u, v * x, v * y, v, x, y, jnp.ones_like(x)], axis=-1
    )  # [8,9]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[-1].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return (U * S[None, :]) @ Vt


def _score_h(H, x1, x2, valid):
    """Symmetric transfer error score (CheckHomography, :306)."""
    Hinv = jnp.linalg.inv(H + 1e-12 * jnp.eye(3))

    def transfer(M, a):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], -1)
        b = ah @ M.T
        return b[:, :2] / jnp.where(jnp.abs(b[:, 2:3]) < 1e-12, 1e-12, b[:, 2:3])

    e12 = jnp.sum((x2 - transfer(H, x1)) ** 2, -1)
    e21 = jnp.sum((x1 - transfer(Hinv, x2)) ** 2, -1)
    ok = (e12 < TH_H) & (e21 < TH_H) & valid
    score = jnp.where(
        valid & (e12 < TH_H), TH_SCORE - e12, 0.0
    ) + jnp.where(valid & (e21 < TH_H), TH_SCORE - e21, 0.0)
    return score.sum(), ok


def _score_f(F, x1, x2, valid):
    """Epipolar distance score (CheckFundamental, :391)."""
    ones = jnp.ones_like(x1[:, :1])
    p1 = jnp.concatenate([x1, ones], -1)
    p2 = jnp.concatenate([x2, ones], -1)
    l2 = p1 @ F.T  # epipolar line in image 2
    l1 = p2 @ F
    d2 = (jnp.sum(p2 * l2, -1) ** 2) / jnp.maximum(
        l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12
    )
    d1 = (jnp.sum(p1 * l1, -1) ** 2) / jnp.maximum(
        l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12
    )
    ok = (d1 < TH_F) & (d2 < TH_F) & valid
    score = jnp.where(valid & (d2 < TH_F), TH_SCORE - d2, 0.0) + jnp.where(
        valid & (d1 < TH_F), TH_SCORE - d1, 0.0
    )
    return score.sum(), ok


def _triangulate(P1, P2, x1, x2):
    """Linear SVD triangulation (Triangulate, :735), batched over points."""
    def one(a, b):
        A = jnp.stack(
            [
                a[0] * P1[2] - P1[0],
                a[1] * P1[2] - P1[1],
                b[0] * P2[2] - P2[0],
                b[1] * P2[2] - P2[1],
            ]
        )
        _, _, vt = jnp.linalg.svd(A)
        X = vt[-1]
        return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, X[3])

    return jax.vmap(one)(x1, x2)


def _check_rt(R, t, x1, x2, valid, K, th2: float = 4.0):
    """Count triangulated points passing cheirality/parallax/reprojection
    (CheckRT, :799). x are pixel coords. Returns (n_good, good, X, parallax)."""
    Km = jnp.array([[K.fx, 0, K.cx], [0, K.fy, K.cy], [0, 0, 1.0]])
    P1 = Km @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], 1)
    P2 = Km @ jnp.concatenate([R, t[:, None]], 1)
    X = _triangulate(P1, P2, x1, x2)
    z1 = X[:, 2]
    X2 = X @ R.T + t[None]
    z2 = X2[:, 2]
    # parallax between viewing rays
    O2 = -R.T @ t
    r1 = X
    r2 = X - O2[None]
    cosp = jnp.sum(r1 * r2, -1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
    )
    # reprojection errors
    u1 = (X @ Km.T)
    u1 = u1[:, :2] / jnp.maximum(u1[:, 2:3], 1e-12)
    u2 = (X2 @ Km.T)
    u2 = u2[:, :2] / jnp.maximum(u2[:, 2:3], 1e-12)
    e1 = jnp.sum((u1 - x1) ** 2, -1)
    e2 = jnp.sum((u2 - x2) ** 2, -1)
    finite = jnp.all(jnp.isfinite(X), -1)
    good = (
        valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
        & (e1 < th2) & (e2 < th2)
    )
    # parallax of the 50th-best point (reference takes idx 50 clamped)
    sorted_cos = jnp.sort(jnp.where(good, cosp, 1.0))
    n_good = good.sum()
    idx = jnp.minimum(50, jnp.maximum(n_good - 1, 0))
    parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(sorted_cos[idx], -1, 1)))
    return n_good, good, X, parallax_deg


def _decompose_e(E):
    """E -> (R1,R2,t) (DecomposeE, :910)."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    W = jnp.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    R1 = U @ W @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    return R1, R2, t


def _decompose_h(H, K):
    """Faugeras-Lustman 8-solution enumeration (ReconstructH, :573).

    Returns (Rs [8,3,3], ts [8,3]) candidate motions (unit-norm t)."""
    Km = jnp.array([[K.fx, 0, K.cx], [0, K.fy, K.cy], [0, 0, 1.0]])
    Kinv = jnp.linalg.inv(Km)
    A = Kinv @ H @ Km
    U, w, Vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])

    # case d' > 0
    aux_st = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st = jnp.array([aux_st, -aux_st, -aux_st, aux_st])

    def rp(i):
        Rp = jnp.array(
            [[ct, 0.0, -st[i]], [0.0, 1.0, 0.0], [st[i], 0.0, ct]]
        )
        tp = (d1 - d3) * jnp.array([x1s[i], 0.0, -x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # case d' < 0
    aux_sp = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sp = jnp.array([aux_sp, -aux_sp, -aux_sp, aux_sp])

    def rn(i):
        Rp = jnp.array(
            [[cp, 0.0, sp[i]], [0.0, -1.0, 0.0], [sp[i], 0.0, -cp]]
        )
        tp = (d1 + d3) * jnp.array([x1s[i], 0.0, x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = rp(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = rn(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


def initialize(
    x1,
    x2,
    valid,
    cam: proj.CameraIntrinsics,
    key,
    n_iters: int = N_ITERS,
    min_triangulated: int = 50,
) -> InitResult:
    """Full monocular initialization from matched pixel coords x1,x2 [M,2].

    Everything is jittable with static shapes; the RANSAC populations for H
    and F evaluate as one batch (no threads — SURVEY.md §2.3 row 4).
    """
    M = x1.shape[0]
    xn1, T1 = _normalize(x1, valid)
    xn2, T2 = _normalize(x2, valid)

    # --- hypothesis batch: sample 8 valid correspondences per iteration ---
    # sampling: weighted choice without replacement approximated by
    # Gumbel-top-k over valid mask (exact uniform over valid subsets)
    keys = jax.random.split(key, n_iters)

    def sample(k):
        g = jax.random.gumbel(k, (M,)) + jnp.where(valid, 0.0, -1e9)
        return jax.lax.top_k(g, 8)[1]

    sel = jax.vmap(sample)(keys)  # [S,8]

    def fit_and_score(idx):
        p1, p2 = xn1[idx], xn2[idx]
        Hn = _compute_h(p1, p2)
        H = jnp.linalg.inv(T2 + 0.0) @ Hn @ T1  # denormalize: x2 = T2^-1 Hn T1 x1
        Fn = _compute_f(p1, p2)
        F = T2.T @ Fn @ T1
        sh, _ = _score_h(H, x1, x2, valid)
        sf, _ = _score_f(F, x1, x2, valid)
        return H, sh, F, sf

    Hs, sh, Fs, sf = jax.vmap(fit_and_score)(sel)
    bh = jnp.argmax(sh)
    bf_i = jnp.argmax(sf)
    H_best, SH = Hs[bh], sh[bh]
    F_best, SF = Fs[bf_i], sf[bf_i]
    _, inliers_h = _score_h(H_best, x1, x2, valid)
    _, inliers_f = _score_f(F_best, x1, x2, valid)

    RH = SH / jnp.maximum(SH + SF, 1e-12)
    use_h = RH > 0.40  # :113

    # --- motion hypotheses: 8 from H, 4 from E -> evaluate all 12 at once ---
    Km = jnp.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    E = Km.T @ F_best @ Km
    R1, R2, te = _decompose_e(E)
    Rs_e = jnp.stack([R1, R1, R2, R2])
    ts_e = jnp.stack([te, -te, te, -te])
    Rs_h, ts_h = _decompose_h(H_best, cam)

    Rs = jnp.concatenate([Rs_h, Rs_e])  # [12,3,3]
    ts = jnp.concatenate([ts_h, ts_e])
    from_h = jnp.arange(12) < 8

    inl = jnp.where(use_h, inliers_h, inliers_f)
    model_ok = jnp.where(use_h, from_h, ~from_h)

    def eval_rt(R, t):
        return _check_rt(R, t, x1, x2, inl, cam)

    n_good, good, X, par = jax.vmap(eval_rt)(Rs, ts)
    n_good = jnp.where(model_ok, n_good, -1)
    best = jnp.argmax(n_good)
    n_best = n_good[best]
    # winner must dominate (secondBestGood < 0.75*bestGood, :521/:616) and
    # clear parallax + count gates
    second = jnp.sort(n_good)[-2]
    n_inl = inl.sum()
    success = (
        (n_best >= jnp.maximum(min_triangulated, (0.9 * n_inl).astype(jnp.int32)))
        & (second.astype(jnp.float32) < 0.75 * n_best.astype(jnp.float32))
        & (par[best] > MIN_PARALLAX_DEG)
    )
    pose21 = se3.from_Rt(Rs[best], ts[best])
    return InitResult(
        success=success,
        pose21=pose21,
        points3d=X[best],
        is_good=good[best],
        used_homography=use_h,
    )
