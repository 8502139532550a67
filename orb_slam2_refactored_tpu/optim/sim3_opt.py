"""Relative-Sim3 optimization over paired reprojections.

Capability analog of `Optimizer::OptimizeSim3`
(`/root/reference/src/Optimizer.cc:944-1100`): refine the loop similarity
S12 (mapping KF2's camera frame into KF1's) by Levenberg-Marquardt over
paired reprojection residuals — each matched landmark contributes an edge in
BOTH images (`EdgeSim3ProjectXYZ` + `EdgeInverseSim3ProjectXYZ`), with a
Huber kernel and a chi2=10 outlier gate between rounds (`:1040-1070`).

Accelerator-first: the g2o graph becomes one masked vmapped residual tensor; the
7-DoF tangent (6 se3 + log-scale; scale row projected out when fix_scale)
solves densely per LM iteration inside `lax.scan` — same shape as
`optim/pose_opt.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection as proj
from ..geometry import se3, sim3

CHI2_SIM3 = 10.0  # reference th2 (src/Optimizer.cc:1042)


class Sim3OptResult(NamedTuple):
    S: jnp.ndarray            # f32[8] refined Sim3 (KF2 cam -> KF1 cam)
    inliers: jnp.ndarray      # bool[N] per matched pair
    num_inliers: jnp.ndarray  # i32
    final_cost: jnp.ndarray   # f32


def _pair_residuals(S, x1, x2, uv1, uv2, cam):
    """r[N,4]: reprojection of x2 through S into image 1 (2) stacked with
    reprojection of x1 through S^-1 into image 2 (2)."""
    r1 = uv1 - proj.project(cam, sim3.transform(S, x2))
    r2 = uv2 - proj.project(cam, sim3.transform(sim3.inverse(S), x1))
    return jnp.concatenate([r1, r2], axis=-1)


def optimize_sim3(
    S0,
    x1,
    x2,
    uv1,
    uv2,
    inv_s2_1,
    inv_s2_2,
    valid,
    cam: proj.CameraIntrinsics,
    fix_scale: bool = True,
    rounds: int = 2,
    iters_per_round: int = 6,
) -> Sim3OptResult:
    """x1/x2: f32[N,3] matched landmark positions in KF1/KF2 CAMERA frames;
    uv1/uv2: f32[N,2] the observed keypoints of the match in each image;
    inv_s2_*: per-observation information weights. valid: bool[N]."""
    with jax.default_matmul_precision("highest"):
        return _optimize_sim3_f32(
            S0, x1, x2, uv1, uv2, inv_s2_1, inv_s2_2, valid, cam,
            fix_scale, rounds, iters_per_round,
        )


def _optimize_sim3_f32(S0, x1, x2, uv1, uv2, inv_s2_1, inv_s2_2, valid, cam,
                       fix_scale, rounds, iters_per_round) -> Sim3OptResult:
    huber = jnp.sqrt(CHI2_SIM3)
    # tangent-row mask: freeze log-scale for stereo/RGB-D (g2o
    # VertexSim3Expmap _fix_scale)
    dof = jnp.ones((7,), jnp.float32)
    if fix_scale:
        dof = dof.at[6].set(0.0)

    def chi2_parts(r):
        c1 = jnp.sum(r[..., 0:2] ** 2, -1) * inv_s2_1
        c2 = jnp.sum(r[..., 2:4] ** 2, -1) * inv_s2_2
        return c1, c2

    def jac_res(S):
        def r_of(delta, a, b, ua, ub):
            return _pair_residuals(
                sim3.retract(S, delta * dof), a[None], b[None],
                ua[None], ub[None], cam,
            )[0]

        z = jnp.zeros((7,), jnp.float32)
        r = jax.vmap(lambda a, b, ua, ub: r_of(z, a, b, ua, ub))(x1, x2, uv1, uv2)
        J = jax.vmap(lambda a, b, ua, ub: jax.jacfwd(r_of)(z, a, b, ua, ub))(
            x1, x2, uv1, uv2
        )  # [N,4,7]
        return r, J

    def run_round(carry, _):
        S, inl = carry

        def lm_iter(state, _):
            S, lam = state
            r, J = jac_res(S)
            c1, c2 = chi2_parts(r)
            w_info = jnp.stack([inv_s2_1, inv_s2_1, inv_s2_2, inv_s2_2], -1)
            s_norm = jnp.sqrt(jnp.maximum(c1 + c2, 1e-12))
            w_h = jnp.where(s_norm > huber, huber / s_norm, 1.0)
            w = w_info * (w_h * (valid & inl))[..., None]  # [N,4]
            JW = J * w[..., None]
            H = jnp.einsum("nci,ncj->ij", JW, J)
            g = jnp.einsum("nci,nc->i", JW, r)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7)
            delta = -jnp.linalg.solve(Hd, g) * dof
            S_new = sim3.retract(S, delta)
            r_new = _pair_residuals(S_new, x1, x2, uv1, uv2, cam)
            c1n, c2n = chi2_parts(r_new)
            m = (valid & inl).astype(jnp.float32)
            sn = jnp.sqrt(jnp.maximum(c1n + c2n, 1e-12))
            whn = jnp.where(sn > huber, huber / sn, 1.0)
            cost_old = jnp.sum((c1 + c2) * w_h * m)
            cost_new = jnp.sum((c1n + c2n) * whn * m)
            ok = cost_new < cost_old
            S_out = jnp.where(ok, S_new, S)
            lam_out = jnp.clip(jnp.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            return (S_out, lam_out), None

        (S, _), _ = jax.lax.scan(
            lm_iter, (S, jnp.float32(1e-4)), None, length=iters_per_round
        )
        r = _pair_residuals(S, x1, x2, uv1, uv2, cam)
        c1, c2 = chi2_parts(r)
        # the reference drops a pair when EITHER edge fails chi2 (:1050-1065)
        inl = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
        return (S, inl), None

    (S, inl), _ = jax.lax.scan(run_round, (S0, valid), None, length=rounds)
    r = _pair_residuals(S, x1, x2, uv1, uv2, cam)
    c1, c2 = chi2_parts(r)
    cost = jnp.sum(jnp.where(inl, c1 + c2, 0.0))
    return Sim3OptResult(
        S=S, inliers=inl,
        num_inliers=jnp.sum(inl.astype(jnp.int32)),
        final_cost=cost,
    )
