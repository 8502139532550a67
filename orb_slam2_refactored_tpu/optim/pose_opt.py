"""Pose-only optimization: Levenberg-Marquardt on SE(3) with outlier rounds.

Capability analog of `Optimizer::PoseOptimization`
(`/root/reference/src/Optimizer.cc:345-489`): 4 rounds x 10 LM iterations,
Huber robust kernel with delta = sqrt(5.991) mono / sqrt(7.815) stereo, chi2
outlier gates per round with re-inclusion, dense 6x6 normal equations.

Accelerator-first: the g2o graph (unary `EdgeSE3ProjectXYZOnlyPose` edges + dense
solver) becomes a closed-form masked reduction — residual/Jacobian for every
observation at once via vmap'd jacfwd on the tangent retraction, one 6x6
solve per iteration inside `lax.fori_loop`, outliers handled as zero weights
(no graph surgery). Both mono and stereo observations live in one program:
stereo rows carry a third (u_right) residual component, mono rows mask it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection as proj
from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    pose: jnp.ndarray       # f32[7]
    inliers: jnp.ndarray    # bool[N]
    num_inliers: jnp.ndarray  # i32
    final_cost: jnp.ndarray   # f32


def _residuals(pose, pts_w, obs_uvr, has_ur, cam):
    """r[N,3] = observation - prediction; third row masked for mono."""
    xc = se3.transform(pose, pts_w)
    pred = proj.project_stereo(cam, xc)
    r = obs_uvr - pred
    r = r.at[..., 2].set(jnp.where(has_ur, r[..., 2], 0.0))
    return r, xc[..., 2]


def pose_optimize(
    pose0,
    pts_w,
    obs_uv,
    obs_ur,
    inv_sigma2,
    valid,
    cam: proj.CameraIntrinsics,
    rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """Optimize a world->camera pose against matched 3D points.

    pts_w: f32[N,3]; obs_uv: f32[N,2]; obs_ur: f32[N] (<0 = mono observation);
    inv_sigma2: f32[N] per-observation information (1/sigma^2 of its pyramid
    level); valid: bool[N].
    """
    # Hessian assembly is precision-critical: force f32 matmul locally
    with jax.default_matmul_precision("highest"):
        return _pose_optimize_f32(
            pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid, cam,
            rounds, iters_per_round,
        )


def _pose_optimize_f32(
    pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid, cam,
    rounds, iters_per_round,
) -> PoseOptResult:
    has_ur = obs_ur > 0
    obs_uvr = jnp.concatenate([obs_uv, jnp.where(has_ur, obs_ur, 0.0)[..., None]], -1)
    chi2_th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)
    huber_delta = jnp.sqrt(chi2_th)
    n_dim = jnp.where(has_ur, 3.0, 2.0)  # only used for cost reporting

    def chi2_of(r):
        return jnp.sum(r * r, axis=-1) * inv_sigma2

    def jac_and_res(pose):
        def r_of_delta(delta, x, o, h):
            p = se3.retract(pose, delta)
            xc = se3.transform(p, x)
            pred = proj.project_stereo(cam, xc)
            r = o - pred
            return r.at[2].set(jnp.where(h, r[2], 0.0))

        zero = jnp.zeros((6,), jnp.float32)
        r = jax.vmap(lambda x, o, h: r_of_delta(zero, x, o, h))(pts_w, obs_uvr, has_ur)
        J = jax.vmap(
            lambda x, o, h: jax.jacfwd(r_of_delta)(zero, x, o, h)
        )(pts_w, obs_uvr, has_ur)  # [N,3,6]
        return r, J

    def run_round(carry, round_idx):
        pose, inliers = carry
        use_huber = round_idx < 2  # reference drops the kernel for later rounds

        def lm_iter(state):
            pose, lam, it, _ = state
            r, J = jac_and_res(pose)
            chi2 = chi2_of(r)
            # Huber weight on residual norm (g2o RobustKernelHuber semantics)
            s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            w_huber = jnp.where(
                use_huber & (s > huber_delta), huber_delta / s, 1.0
            )
            w = jnp.where(valid & inliers, inv_sigma2 * w_huber, 0.0)  # [N]
            JW = J * w[:, None, None]
            H = jnp.einsum("nij,nik->jk", JW, J)  # [6,6]
            g = jnp.einsum("nij,ni->j", JW, r)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6)
            # J = dr/d(delta) with r = obs - pred, so the GN step is -H^-1 g
            delta = -jnp.linalg.solve(Hd, g)
            new_pose = se3.retract(pose, delta)
            # accept if cost decreased (simple LM lambda schedule);
            # residual-only evaluation (no Jacobians) for the trial point
            r_new, _ = _residuals(new_pose, pts_w, obs_uvr, has_ur, cam)
            cost_old = jnp.sum(jnp.where(valid & inliers, chi2_of(r) * w_huber, 0.0))
            chi2n = chi2_of(r_new)
            sn = jnp.sqrt(jnp.maximum(chi2n, 1e-12))
            w_h_n = jnp.where(use_huber & (sn > huber_delta), huber_delta / sn, 1.0)
            cost_new = jnp.sum(jnp.where(valid & inliers, chi2n * w_h_n, 0.0))
            improved = cost_new < cost_old
            pose_out = jnp.where(improved, new_pose, pose)
            lam_out = jnp.where(improved, lam * 0.5, lam * 4.0)
            # early exit (g2o's LM likewise terminates the iteration loop
            # when the gain stalls, optimization_algorithm_levenberg.cpp):
            # an accepted step with negligible relative cost gain, a
            # sub-1e-5 tangent step, or a rejected step at max lambda
            # cannot improve the pose meaningfully — the remaining
            # iterations of the round would be no-ops, and each costs a
            # full serial residual+Jacobian pass
            step_inf = jnp.max(jnp.abs(delta))
            rel_gain = (cost_old - cost_new) / jnp.maximum(cost_old, 1e-12)
            done = (
                (improved & ((rel_gain < 1e-5) | (step_inf < 1e-5)))
                | (~improved & (lam >= 1e6))
            )
            return (pose_out, jnp.clip(lam_out, 1e-8, 1e6), it + 1, done)

        pose, _, _, _ = jax.lax.while_loop(
            lambda st: (st[2] < iters_per_round) & ~st[3],
            lm_iter,
            (pose, jnp.float32(1e-3), jnp.int32(0), jnp.bool_(False)),
        )
        # re-classify ALL valid observations (outliers can return, :445-470)
        r, _ = jac_and_res(pose)
        chi2 = chi2_of(r)
        inliers = valid & (chi2 <= chi2_th)
        return (pose, inliers), None

    inliers0 = valid
    (pose, inliers), _ = jax.lax.scan(
        run_round, (pose0, inliers0), jnp.arange(rounds)
    )
    r, _ = _residuals(pose, pts_w, obs_uvr, has_ur, cam)
    final_cost = jnp.sum(jnp.where(inliers, chi2_of(r), 0.0))
    return PoseOptResult(
        pose=pose,
        inliers=inliers,
        num_inliers=jnp.sum(inliers.astype(jnp.int32)),
        final_cost=final_cost,
    )
