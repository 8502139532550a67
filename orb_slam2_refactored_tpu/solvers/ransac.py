"""Vmapped RANSAC solvers: Horn 3D-3D (Sim3/SE3) and DLT P6P camera resection.

Capability analogs:
- `horn_ransac`  <- `Sim3Solver` (`/root/reference/src/Sim3Solver.cc:111-365`):
  Horn 1987 closed-form absolute orientation from 3 correspondences inside
  RANSAC, fixed scale s=1 for stereo/RGB-D (`:39` bFixScale), reprojection
  gating at 9.21*sigma^2 (`:245-246`). Also serves stereo/RGB-D
  relocalization (3D map point <-> 3D frame point with s=1).
- `pnp_ransac`   <- `PnPsolver` (`src/PnPsolver.cc:165-258,375-568`): the
  EPnP+RANSAC relocalization solver. This realization evaluates a mixed
  population of DLT-resection and plane-homography hypotheses in one vmapped
  batch (planar-safe — see `_planar_resection`), replacing the round-robin
  `iterate(5)` scheduling (`src/Tracking.cc:349-441`) with one batch.
- `p6p_ransac`   — the DLT-only variant (kept for non-degenerate callers).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection as proj
from ..geometry import se3


class RansacResult(NamedTuple):
    success: jnp.ndarray   # bool
    pose: jnp.ndarray      # f32[7] (and scale f32 for horn with scale)
    scale: jnp.ndarray     # f32 (1.0 when fixed)
    inliers: jnp.ndarray   # bool[M]
    n_inliers: jnp.ndarray


def horn_align(x_src, x_dst, with_scale: bool):
    """Closed-form similarity aligning src -> dst point sets [K,3]
    (Horn 1987 via SVD of the correlation, `src/Sim3Solver.cc:51-63` uses the
    quaternion-eigen variant; SVD is numerically equivalent).
    Returns (q, t, s): x_dst ~= s*R(q) x_src + t."""
    mu_s = x_src.mean(0)
    mu_d = x_dst.mean(0)
    xs = x_src - mu_s
    xd = x_dst - mu_d
    cov = xd.T @ xs
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(U @ Vt)
    S = jnp.diag(jnp.stack([jnp.float32(1.0), jnp.float32(1.0), det]))
    R = U @ S @ Vt
    if with_scale:
        var_s = jnp.maximum(jnp.sum(xs * xs), 1e-12)
        s = jnp.sum(D * jnp.diag(S)) / var_s
    else:
        s = jnp.float32(1.0)
    t = mu_d - s * (R @ mu_s)
    q = se3.quat_from_matrix(R)
    return q, t, s


def horn_ransac(
    x_src,
    x_dst,
    valid,
    key,
    with_scale: bool = False,
    n_iters: int = 128,
    inlier_th: float = 0.09,
    min_inliers: int = 20,
) -> RansacResult:
    """RANSAC absolute orientation between matched 3D sets [M,3].

    inlier gate: squared euclidean distance gated in BOTH frames (the
    reference's Sim3Solver checks reprojection in both images,
    src/Sim3Solver.cc:245-246 err1/err2) — the backward residual is the
    forward one divided by s^2, so the two-sided gate is
    e2 < th * min(1, s^2). One-sided 3D gating is degenerate under
    with_scale: a tiny s maps every source point near one spot and buys
    spurious inliers. Threshold in m^2."""
    M = x_src.shape[0]
    keys = jax.random.split(key, n_iters)

    def gate(e2, s):
        # a proper similarity has s > 0; reflections (negative Horn scale)
        # and extreme scales (|log s| > log 4 — far beyond plausible SLAM
        # scale drift over one loop) are degenerate fits, not solutions
        s_ok = (s > 0.25) & (s < 4.0)
        return (e2 < inlier_th * jnp.minimum(1.0, s * s)) & s_ok

    def hyp(k):
        g = jax.random.gumbel(k, (M,)) + jnp.where(valid, 0.0, -1e9)
        idx = jax.lax.top_k(g, 3)[1]
        q, t, s = horn_align(x_src[idx], x_dst[idx], with_scale)
        pred = s * se3.quat_rotate(q[None], x_src) + t[None]
        e2 = jnp.sum((pred - x_dst) ** 2, -1)
        inl = valid & gate(e2, s)
        return inl.sum(), q, t, s, inl

    n_inl, qs, ts, ss, inls = jax.vmap(hyp)(keys)
    best = jnp.argmax(n_inl)
    inl = inls[best]
    # refine on the full inlier set
    w = inl.astype(jnp.float32)[:, None]
    n = jnp.maximum(inl.sum(), 3)

    def refine(_):
        mu_s = (x_src * w).sum(0) / n
        mu_d = (x_dst * w).sum(0) / n
        xs = (x_src - mu_s) * w
        xd = (x_dst - mu_d) * w
        cov = xd.T @ xs
        U, D, Vt = jnp.linalg.svd(cov)
        det = jnp.linalg.det(U @ Vt)
        S = jnp.diag(jnp.stack([jnp.float32(1.0), jnp.float32(1.0), det]))
        R = U @ S @ Vt
        if with_scale:
            var_s = jnp.maximum(jnp.sum(xs * xs), 1e-12)
            s = jnp.sum(D * jnp.diag(S)) / var_s
        else:
            s = jnp.float32(1.0)
        t = mu_d - s * (R @ mu_s)
        return se3.quat_from_matrix(R), t, s

    q, t, s = refine(None)
    pred = s * se3.quat_rotate(q[None], x_src) + t[None]
    e2 = jnp.sum((pred - x_dst) ** 2, -1)
    inl = valid & gate(e2, s)
    return RansacResult(
        success=inl.sum() >= min_inliers,
        pose=se3.make(q, t),
        scale=s,
        inliers=inl,
        n_inliers=inl.sum(),
    )


def _dlt_resection(X, uv, w=None):
    """6+ point DLT: solve P [3,4] s.t. uv ~ P [X;1]; decompose to (R,t)
    assuming known intrinsics were removed (uv are NORMALIZED image coords).
    `w`: optional per-point weights (0 rows drop out of the nullspace fit)."""
    n = X.shape[0]
    ones = jnp.ones((n, 1))
    Xh = jnp.concatenate([X, ones], -1)  # [n,4]
    zeros = jnp.zeros((n, 4))
    r1 = jnp.concatenate([Xh, zeros, -uv[:, 0:1] * Xh], -1)
    r2 = jnp.concatenate([zeros, Xh, -uv[:, 1:2] * Xh], -1)
    A = jnp.concatenate([r1, r2], 0)  # [2n,12]
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    P = Vt[-1].reshape(3, 4)
    # enforce rotation via SVD of the leading 3x3
    Rraw = P[:, :3]
    U, D, Vt2 = jnp.linalg.svd(Rraw)
    det = jnp.linalg.det(U @ Vt2)
    R = U @ jnp.diag(jnp.stack([jnp.float32(1.0), jnp.float32(1.0), det])) @ Vt2
    scale = jnp.sum(D) / 3.0 * det  # signed scale
    t = P[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    # cheirality fix: majority of points must land in front
    z = (X @ R[2] + t[2])
    flip = jnp.sum(jnp.sign(z)) < 0
    R = jnp.where(flip, -R, R)
    t = jnp.where(flip, -t, t)
    return se3.from_Rt(R, t)


def _planar_resection(X, xn, w=None):
    """Pose from a (near-)coplanar 2D-3D sample via calibrated-homography
    decomposition (IPPE-style): fit the sample's plane (weighted PCA), DLT
    the plane->normalized-image homography, decompose H = [r1 r2 t]/lam.

    This is the planar-safe arm the reference gets from EPnP
    (`/root/reference/src/PnPsolver.cc:375-568`): a pure DLT resection has a
    2-D nullspace on coplanar points and returns garbage, which is exactly
    the one-wall mono relocalization failure mode.
    `w`: optional per-point weights for non-minimal refinement."""
    n_pts = X.shape[0]
    ww = jnp.ones((n_pts,)) if w is None else w
    wn = ww / jnp.maximum(ww.sum(), 1e-9)
    c = (X * wn[:, None]).sum(0)
    Xc = X - c
    cov = (Xc * wn[:, None]).T @ Xc
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    v_ax, u_ax = evecs[:, 1], evecs[:, 2]
    # right-handed (u, v, n) frame — eigh's column signs are arbitrary and a
    # left-handed triple would turn R_wc into a reflection
    nrm = jnp.cross(u_ax, v_ax)
    p2 = jnp.stack([Xc @ u_ax, Xc @ v_ax], -1)  # in-plane coords [n,2]
    ones = jnp.ones((n_pts, 1))
    ph = jnp.concatenate([p2, ones], -1)
    zeros = jnp.zeros_like(ph)
    r1 = jnp.concatenate([ph, zeros, -xn[:, 0:1] * ph], -1)
    r2 = jnp.concatenate([zeros, ph, -xn[:, 1:2] * ph], -1)
    A = jnp.concatenate([r1, r2], 0)  # [2n,9]
    A = A * jnp.concatenate([ww, ww])[:, None]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    H = Vt[-1].reshape(3, 3)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = jnp.sqrt(jnp.maximum(
        jnp.linalg.norm(h1) * jnp.linalg.norm(h2), 1e-12))
    # cheirality: the plane centroid maps to h3/lam, must sit at z > 0
    sgn = jnp.where(h3[2] < 0, -1.0, 1.0)
    h1, h2, h3 = sgn * h1 / lam, sgn * h2 / lam, sgn * h3 / lam
    Rraw = jnp.stack([h1, h2, jnp.cross(h1, h2)], -1)
    U, _, Vt2 = jnp.linalg.svd(Rraw)
    det = jnp.linalg.det(U @ Vt2)
    Rp = U @ jnp.diag(jnp.stack(
        [jnp.float32(1.0), jnp.float32(1.0), det])) @ Vt2
    # world->camera: xc = Rp @ [(x-c)@[u,v,n]] + h3
    R_wc = Rp @ jnp.stack([u_ax, v_ax, nrm], 0)
    t_wc = h3 - R_wc @ c
    return se3.from_Rt(R_wc, t_wc)


def pnp_ransac(
    pts3d,
    uv,
    valid,
    cam: proj.CameraIntrinsics,
    key,
    n_iters: int = 256,
    sample_size: int = 8,
    inlier_th_px: float = 9.0,
    min_inliers: int = 15,
) -> RansacResult:
    """Planar-safe PnP RANSAC — the capability analog of the reference's
    EPnP relocalization solver (`PnPsolver::iterate`/`compute_pose`,
    `/root/reference/src/PnPsolver.cc:165-258,375-568`), whose role there is
    exactly a degeneracy-free resection inside RANSAC.

    Batched realization: instead of EPnP's data-dependent beta-case
    switch, TWO closed-form hypothesis families evaluate as one vmapped
    batch — n_iters/2 DLT resections (exact for general 3D structure) and
    n_iters/2 plane-homography decompositions (exact for coplanar
    structure) — and the full-point-set inlier count picks the winner, so
    the degenerate family simply loses the argmax instead of being
    special-cased. Non-minimal refinement re-fits BOTH families on the
    winning inlier set (PnPsolver::Refine analog) and keeps the best."""
    M = pts3d.shape[0]
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1
    )
    half = n_iters // 2
    keys = jax.random.split(key, 2 * half)

    def score(pose):
        uv_pred, z = proj.project_world(cam, pose, pts3d)
        e2 = jnp.sum((uv_pred - uv) ** 2, -1)
        inl = valid & (z > 0.01) & (e2 < inlier_th_px)
        # fractional part breaks inlier-count ties toward lower mean inlier
        # error — otherwise the loosely-gated raw hypothesis beats its own
        # (far more accurate) non-minimal refit in the argmax below
        mean_e2 = jnp.where(inl, e2, 0.0).sum() / jnp.maximum(inl.sum(), 1)
        return inl.sum().astype(jnp.float32) - mean_e2 / inlier_th_px, inl

    def hyp(k, planar):
        g = jax.random.gumbel(k, (M,)) + jnp.where(valid, 0.0, -1e9)
        idx = jax.lax.top_k(g, sample_size)[1]
        pose = (_planar_resection(pts3d[idx], xn[idx]) if planar
                else _dlt_resection(pts3d[idx], xn[idx]))
        n, inl = score(pose)
        return n, pose, inl

    n_d, poses_d, inls_d = jax.vmap(lambda k: hyp(k, False))(keys[:half])
    n_p, poses_p, inls_p = jax.vmap(lambda k: hyp(k, True))(keys[half:])
    n_inl = jnp.concatenate([n_d, n_p])
    poses = jnp.concatenate([poses_d, poses_p])
    inls = jnp.concatenate([inls_d, inls_p])
    best = jnp.argmax(n_inl)
    w = inls[best].astype(jnp.float32)
    cand = [(n_inl[best], poses[best], inls[best])]
    for fit in (_dlt_resection, _planar_resection):
        pose_r = fit(pts3d, xn, w)
        n_r, inl_r = score(pose_r)
        cand.append((n_r, pose_r, inl_r))
    ns = jnp.stack([c[0] for c in cand])
    pick = jnp.argmax(ns)
    pose = jnp.stack([c[1] for c in cand])[pick]
    inl = jnp.stack([c[2] for c in cand])[pick]
    return RansacResult(
        success=inl.sum() >= min_inliers,
        pose=pose,
        scale=jnp.float32(1.0),
        inliers=inl,
        n_inliers=inl.sum(),
    )


def p6p_ransac(
    pts3d,
    uv,
    valid,
    cam: proj.CameraIntrinsics,
    key,
    n_iters: int = 256,
    sample_size: int = 12,
    inlier_th_px: float = 9.0,
    min_inliers: int = 15,
) -> RansacResult:
    """RANSAC camera resection from 2D-3D matches (PnPsolver analog).

    pts3d [M,3] world, uv [M,2] pixels. Returns world->camera pose."""
    M = pts3d.shape[0]
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1
    )
    keys = jax.random.split(key, n_iters)

    def hyp(k):
        # non-minimal 12-point hypotheses: the DLT is noise-sensitive at the
        # minimal size; a slightly larger sample trades a few extra RANSAC
        # iterations for far more accurate hypotheses (vmapped, so free)
        g = jax.random.gumbel(k, (M,)) + jnp.where(valid, 0.0, -1e9)
        idx = jax.lax.top_k(g, sample_size)[1]
        pose = _dlt_resection(pts3d[idx], xn[idx])
        uv_pred, z = proj.project_world(cam, pose, pts3d)
        e2 = jnp.sum((uv_pred - uv) ** 2, -1)
        inl = valid & (z > 0.01) & (e2 < inlier_th_px)
        return inl.sum(), pose, inl

    n_inl, poses, inls = jax.vmap(hyp)(keys)
    best = jnp.argmax(n_inl)
    # non-minimal refinement on the winning inlier set (PnPsolver::Refine
    # analog, src/PnPsolver.cc:260-306)
    w = inls[best].astype(jnp.float32)
    pose_r = _dlt_resection(pts3d, xn, w)
    uv_pred, z = proj.project_world(cam, pose_r, pts3d)
    e2 = jnp.sum((uv_pred - uv) ** 2, -1)
    inl_r = valid & (z > 0.01) & (e2 < inlier_th_px)
    use_r = inl_r.sum() >= n_inl[best]
    pose = jnp.where(use_r, pose_r, poses[best])
    inl = jnp.where(use_r, inl_r, inls[best])
    return RansacResult(
        success=jnp.maximum(inl.sum(), n_inl[best]) >= min_inliers,
        pose=pose,
        scale=jnp.float32(1.0),
        inliers=inl,
        n_inliers=inl.sum(),
    )
