"""Bundle adjustment: Levenberg-Marquardt with Schur-complement landmark
marginalization, matrix-free CG on the reduced camera system.

Capability analog of the reference's g2o BA stack — `BundleAdjustment` /
`LocalBundleAdjustment` (`/root/reference/src/Optimizer.cc:204-343,491-736`)
on top of `BlockSolver` Schur marginalization
(`Thirdparty/g2o/g2o/core/block_solver.hpp:51-87`) and LM with adaptive
lambda (`core/optimization_algorithm_levenberg.cpp:47-151`).

Accelerator-first (not a port of g2o's sparse architecture):
- Observations live in the map's natural dense layout `[K, N]` (keyframe x
  feature slot) with -1 padding: residuals and both Jacobian blocks
  (pose [3,6], point [3,3]) for every observation come from ONE vmapped
  jacfwd — no edge objects, no sparse matrix assembly.
- The Schur-reduced camera system `S = Hpp - U Hll^-1 U^T` is never formed:
  CG runs matrix-free, where `U^T v` is a scatter-add over points and
  `U (G w)` a gather — exactly the shape that shards over a keyframe-axis
  device mesh with one psum (see `parallel/sharded_ba.py`).
- Fixed keyframes (gauge / local-BA frontier, `src/Optimizer.cc:526-537`)
  are a boolean mask projecting their tangent rows out of CG.
- Huber kernel with the reference's chi2 deltas (5.991 mono / 7.815 stereo).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection as proj
from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    kf_pose: jnp.ndarray    # f32[K,7] world->camera
    kf_fixed: jnp.ndarray   # bool[K] gauge/frontier frames (not optimized)
    obs_uv: jnp.ndarray     # f32[K,N,2]
    obs_ur: jnp.ndarray     # f32[K,N] (<0 -> mono observation)
    obs_pt: jnp.ndarray     # i32[K,N] point index (-1 -> no observation)
    obs_inv_s2: jnp.ndarray  # f32[K,N]
    pt_pos: jnp.ndarray     # f32[P,3]
    pt_valid: jnp.ndarray   # bool[P]
    # bool[P] landmarks held fixed (window BA: points also observed by
    # keyframes outside the window — the analog of g2o's fixed frontier
    # cameras, src/Optimizer.cc:526-537, seen from the point side). None ->
    # all landmarks free.
    pt_frozen: jnp.ndarray = None


class BAResult(NamedTuple):
    kf_pose: jnp.ndarray
    pt_pos: jnp.ndarray
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    obs_inlier: jnp.ndarray  # bool[K,N] final chi2 gate per observation


def _residual_one(pose, pt, uv, ur, has_ur, cam):
    xc = se3.transform(pose, pt)
    pred = proj.project_stereo(cam, xc)
    r = jnp.concatenate([uv, jnp.where(has_ur, ur, 0.0)[None]]) - pred
    r = r.at[2].set(jnp.where(has_ur, r[2], 0.0))
    # depth gate: points behind the camera contribute nothing
    return jnp.where(xc[2] > 1e-2, r, jnp.zeros(3))


def _residuals_jacobians(kf_pose, pt_pos, p: BAProblem, cam):
    """r[K,N,3], Jp[K,N,3,6], Jl[K,N,3,3] for every observation slot.

    Analytic Jacobians (the autodiff form costs ~10 residual evaluations per
    observation; this is one). Conventions: r = obs - proj(xc) with the
    left-multiplicative retraction exp(delta) @ pose, so
      dxc/domega = -[xc]x,  dxc/dupsilon = I,  dxc/dx_world = R(pose),
    matching g2o's EdgeSE3ProjectXYZ linearizeOplus up to the tangent
    ordering (`Thirdparty/g2o/g2o/types/types_six_dof_expmap.cpp`).
    """
    has_ur = p.obs_ur > 0
    pt_idx = jnp.clip(p.obs_pt, 0, pt_pos.shape[0] - 1)
    pts = pt_pos[pt_idx]  # [K,N,3]

    q = kf_pose[:, 0:4]
    xc = se3.transform(kf_pose[:, None, :], pts)  # [K,N,3]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    live = z > 1e-2
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    pred_u = cam.fx * x * inv_z + cam.cx
    pred_v = cam.fy * y * inv_z + cam.cy
    pred_r = pred_u - cam.bf * inv_z
    r = jnp.stack([
        p.obs_uv[..., 0] - pred_u,
        p.obs_uv[..., 1] - pred_v,
        jnp.where(has_ur, p.obs_ur - pred_r, 0.0),
    ], -1)
    r = jnp.where(live[..., None], r, 0.0)

    # J_proj = d(pred)/d(xc): [K,N,3,3]
    zr = jnp.zeros_like(x)
    Jproj = jnp.stack([
        jnp.stack([cam.fx * inv_z, zr, -cam.fx * x * inv_z2], -1),
        jnp.stack([zr, cam.fy * inv_z, -cam.fy * y * inv_z2], -1),
        jnp.stack([cam.fx * inv_z, zr,
                   -cam.fx * x * inv_z2 + cam.bf * inv_z2], -1),
    ], -2)
    # r = obs - pred  =>  dr/dxc = -Jproj; mask the mono third row and dead
    # (behind-camera) observations exactly like the residual
    row_mask = jnp.stack([live, live, live & has_ur], -1)  # [K,N,3]
    dr_dxc = jnp.where(row_mask[..., None], -Jproj, 0.0)

    # dxc/d(omega) = -[xc]x  (left-multiplicative tangent), dxc/dv = I
    O = jnp.zeros_like(x)
    skew = jnp.stack([
        jnp.stack([O, -z, y], -1),
        jnp.stack([z, O, -x], -1),
        jnp.stack([-y, x, O], -1),
    ], -2)  # [K,N,3,3]
    Jp_rot = -jnp.einsum("knij,knjl->knil", dr_dxc, skew)
    Jp = jnp.concatenate([Jp_rot, dr_dxc], -1)  # [K,N,3,6]

    # dxc/dx_world = R(pose): column l of Jl = dr_dxc @ R[:, l]
    R = se3.quat_to_matrix(q)  # [K,3,3]
    Jl = jnp.einsum("knij,kjl->knil", dr_dxc, R)
    return r, Jp, Jl


def problem_from_map(m, free_mask, inv_sigma2, pt_frozen=None) -> BAProblem:
    """Build the global-BA problem straight from live `MapArrays` (the
    GlobalBundleAdjustment graph construction, `/root/reference/src/
    Optimizer.cc:204-343`, as array views): dead keyframe slots arrive with
    free_mask=False, dead landmark slots with mp_valid=False — no
    compaction needed, padding rows contribute nothing."""
    return BAProblem(
        kf_pose=m.kf_pose,
        kf_fixed=~free_mask,
        obs_uv=m.kf_xy,
        obs_ur=m.kf_uright,
        obs_pt=m.kf_mp,
        obs_inv_s2=inv_sigma2[m.kf_level],
        pt_pos=m.mp_pos,
        pt_valid=m.mp_valid,
        pt_frozen=pt_frozen,
    )


def _cost_only(kf_pose, pt_pos, p: BAProblem, cam, w_valid, huber_delta,
               use_huber, axis_name=None):
    has_ur = p.obs_ur > 0
    pt_idx = jnp.clip(p.obs_pt, 0, pt_pos.shape[0] - 1)
    pts = pt_pos[pt_idx]
    fn = jax.vmap(jax.vmap(_residual_one, in_axes=(None, 0, 0, 0, 0, None)),
                  in_axes=(0, 0, 0, 0, 0, None))
    r = fn(kf_pose, pts, p.obs_uv, p.obs_ur, has_ur, cam)
    chi2 = jnp.sum(r * r, -1) * p.obs_inv_s2
    rho = _huber_rho(chi2, huber_delta, use_huber)
    return _psum(jnp.sum(jnp.where(w_valid, rho, 0.0)), axis_name), chi2


def _psum(x, axis_name):
    """Cross-shard reduction when running keyframe-sharded under shard_map."""
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det) — far cheaper on an
    accelerator than the general LU path of jnp.linalg.inv for [P,3,3] stacks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], -1),
        jnp.stack([A21, A22, A23], -1),
        jnp.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _huber_rho(chi2, delta, use_huber):
    """g2o Huber on the error norm: rho(s) = s if sqrt(s)<=d else 2d*sqrt(s)-d^2."""
    s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    rho = jnp.where(s <= delta, chi2, 2.0 * delta * s - delta * delta)
    return jnp.where(use_huber, rho, chi2)


def ba_solve(
    p: BAProblem,
    cam: proj.CameraIntrinsics,
    iters: int = 10,
    cg_iters: int = 50,
    use_huber: bool = True,
    chi2_gate: bool = True,
    axis_name: str = None,
    lambda0: float = 1e-4,
    dense_schur: bool = False,
    axis_size: int = 1,
) -> BAResult:
    """When `axis_name` is given, the problem's keyframe axis is assumed
    sharded under `shard_map(mesh, axis_name)` with point arrays replicated:
    all point-space reductions and CG scalars become collectives —
    the keyframe-sharded distributed global BA of BASELINE.json configs[4].

    With `axis_size > 1` the POINT-space stages shard too: every [P,*]
    all-reduce becomes reduce-scatter (`psum_scatter`) + local compute on
    P/n rows + `all_gather` — IDENTICAL ring communication volume to the
    plain psum, but the replicated point-space FLOPs (Hll damping, 3x3
    inversions, G products, back-substitution) divide by the mesh size.
    Without this the point work is an Amdahl term that caps multi-device
    efficiency; with it the per-shard compute shrinks ~1/n (four-card
    scaling is not measured on the H100 yet).

    `dense_schur=True` forms the reduced camera system S explicitly
    ([K*6, K*6], one batched application of S to the identity) and solves it
    directly — the shape for SMALL K (window BA, K<=32): the CG path's
    10-50 sequential tiny dispatches become one batched matmul + one dense
    solve. Large-K / sharded problems keep matrix-free CG
    (S materialization grows as K^2 and the basis batch as K*P)."""
    with jax.default_matmul_precision("highest"):
        return _ba_solve_f32(p, cam, iters, cg_iters, use_huber, chi2_gate,
                             axis_name, lambda0, dense_schur, axis_size)


def _ba_solve_f32(p, cam, iters, cg_iters, use_huber, chi2_gate, axis_name,
                  lambda0, dense_schur=False, axis_size=1) -> BAResult:
    K, N = p.obs_uv.shape[:2]
    P = p.pt_pos.shape[0]
    shard_pts = (axis_name is not None and axis_size > 1
                 and not dense_schur and P % axis_size == 0)
    if shard_pts:
        Psh = P // axis_size

        def to_shard(x):
            """Local [P,...] accumulator -> reduced [P/n,...] shard."""
            return jax.lax.psum_scatter(x, axis_name, scatter_dimension=0,
                                        tiled=True)

        def to_full(x_sh):
            """[P/n,...] shard -> replicated [P,...] (rank-ordered)."""
            return jax.lax.all_gather(x_sh, axis_name, axis=0, tiled=True)

        def my_rows(x):
            """This rank's rows of a replicated [P,...] array."""
            rank = jax.lax.axis_index(axis_name)
            return jax.lax.dynamic_slice_in_dim(x, rank * Psh, Psh, 0)
    else:
        Psh = P
        to_shard = lambda x: _psum(x, axis_name)  # noqa: E731
        to_full = lambda x: x                     # noqa: E731
        my_rows = lambda x: x                     # noqa: E731
    has_ur = p.obs_ur > 0
    huber_delta = jnp.sqrt(jnp.where(has_ur, CHI2_STEREO, CHI2_MONO))
    chi2_th = jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)
    obs_ok0 = (p.obs_pt >= 0) & p.pt_valid[jnp.clip(p.obs_pt, 0, P - 1)]
    pt_idx = jnp.clip(p.obs_pt, 0, P - 1)
    free = ~p.kf_fixed  # [K]

    def lm_step(state):
        kf_pose, pt_pos, lam, prev_cost, it, _ = state
        r, Jp, Jl = _residuals_jacobians(kf_pose, pt_pos, p, cam)
        chi2 = jnp.sum(r * r, -1) * p.obs_inv_s2
        s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w_huber = jnp.where(use_huber & (s > huber_delta), huber_delta / s, 1.0)
        w = jnp.where(obs_ok0, p.obs_inv_s2 * w_huber, 0.0)  # [K,N]

        JpW = Jp * w[..., None, None]
        JlW = Jl * w[..., None, None]
        # block-diagonal Hessians
        Hpp = jnp.einsum("knci,kncj->kij", JpW, Jp)           # [K,6,6]
        g_p = jnp.einsum("knci,knc->ki", JpW, r)              # [K,6]
        Hll_obs = jnp.einsum("knci,kncj->knij", JlW, Jl)      # [K,N,3,3]
        g_l_obs = jnp.einsum("knci,knc->kni", JlW, r)         # [K,N,3]
        flat_pt = pt_idx.reshape(-1)
        # ONE fused [P,12] scatter for Hll (9) + g_l (3): scatter cost is
        # per-pass, so packing the point-space accumulators halves it
        packed = jnp.concatenate(
            [Hll_obs.reshape(-1, 9), g_l_obs.reshape(-1, 3)], axis=-1
        )
        # point-space assembly: reduce-scatter when point-sharded (each
        # rank keeps P/n reduced rows), plain psum otherwise
        acc = to_shard(
            jnp.zeros((P, 12))
            .at[flat_pt]
            .add(jnp.where(obs_ok0.reshape(-1, 1), packed, 0.0))
        )
        Hll = acc[:, :9].reshape(Psh, 3, 3)
        g_l = acc[:, 9:]
        # damping: H + lam*diag(H) + eps on both blocks
        eye6 = jnp.eye(6)
        eye3 = jnp.eye(3)
        dp_diag = jnp.diagonal(Hpp, axis1=1, axis2=2)
        Hpp_d = Hpp + (lam * dp_diag + 1e-6)[:, :, None] * eye6[None]
        dl_diag = jnp.diagonal(Hll, axis1=1, axis2=2)
        Hll_d = Hll + (lam * dl_diag + 1e-6)[:, :, None] * eye3[None]
        G = _inv3x3(Hll_d + 1e-9 * eye3[None])  # [P/n,3,3]
        if p.pt_frozen is not None:
            # frozen landmarks are excluded from the Schur elimination: G=0
            # removes their -U G U^T term (they act as constants in the
            # reduced camera system) and forces dl=0 in back-substitution
            G = jnp.where(my_rows(p.pt_frozen)[:, None, None], 0.0, G)

        # W_obs = JpW^T Jl per obs: [K,N,6,3]
        W_obs = jnp.einsum("knci,kncj->knij", JpW, Jl)

        def U_T(v):
            """v [K,6] -> [P/n,3] shard: sum_obs W_obs^T v_k scattered to
            points, reduce-scattered across the mesh."""
            contrib = jnp.einsum("knij,ki->knj", W_obs, v)  # [K,N,3]
            return to_shard(
                jnp.zeros((P, 3)).at[flat_pt].add(
                    jnp.where(obs_ok0.reshape(-1, 1), contrib.reshape(-1, 3), 0.0)
                )
            )

        def U(y):
            """y [P,3] -> [K,6]: gather per obs, sum over features."""
            yk = y[pt_idx]  # [K,N,3]
            contrib = jnp.einsum("knij,knj->kni", W_obs, yk)
            return jnp.where(obs_ok0[..., None], contrib, 0.0).sum(1)

        def S_mv(v):
            v = v * free[:, None]
            out = jnp.einsum("kij,kj->ki", Hpp_d, v)
            w1 = U_T(v)                               # [P/n,3] shard
            w2 = to_full(jnp.einsum("pij,pj->pi", G, w1))  # gather [P,3]
            out = out - U(w2)
            return out * free[:, None]

        # block-Jacobi preconditioner from damped Hpp
        Minv = jnp.linalg.inv(Hpp_d + 1e-9 * eye6[None])

        def precond(v):
            return jnp.einsum("kij,kj->ki", Minv, v) * free[:, None]

        def cg_body(cg_state, _):
            x, rr, z, pdir, rz = cg_state
            Ap = S_mv(pdir)
            denom = _psum(jnp.sum(pdir * Ap), axis_name)
            alpha = rz / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
            x = x + alpha * pdir
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = _psum(jnp.sum(rr * z), axis_name)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1e-12, rz)
            pdir = z + beta * pdir
            return (x, rr, z, pdir, rz_new), None

        if dense_schur:
            # form S DIRECTLY from per-point camera-block sums: for point j
            # with G_j and per-camera W-sums T_j[k] = sum_{n:pt=j} W_obs,
            # S = blockdiag(Hpp_d) - sum_j T_j G_j T_j^T. The final
            # contraction is ONE [D, P*3] x [P*3, D] matmul, replacing the
            # earlier basis trick (vmap of S_mv over the K*6 identity), whose
            # 6K scatter/gather chains dominated the window BA's time. Fixed
            # frames get zeroed rows/cols + identity diagonal (their dp
            # solves to rhs=0).
            D = K * 6
            kidx = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N)).reshape(-1)
            w_upd = jnp.where(obs_ok0.reshape(-1, 1),
                              W_obs.reshape(-1, 18), 0.0)
            # flattened [P*K, 18] scatter target: one 1-D scatter instead of
            # the equivalent [P, K, 6, 3] 2-D scatter
            T = _psum(
                jnp.zeros((P * K, 18)).at[flat_pt * K + kidx].add(w_upd),
                axis_name,
            ).reshape(P, D, 3)
            TG = jnp.einsum("pdi,pij->pdj", T, G)  # [P,D,3]
            S_sub = jnp.einsum("pdi,pei->de", TG, T)
            rows = (jnp.arange(K)[:, None, None] * 6
                    + jnp.arange(6)[None, :, None])
            cols = (jnp.arange(K)[:, None, None] * 6
                    + jnp.arange(6)[None, None, :])
            S = jnp.zeros((D, D), g_p.dtype).at[rows, cols].add(Hpp_d)
            S = S - S_sub
            fmask = jnp.repeat(free, 6).astype(g_p.dtype)
            S = S * fmask[:, None] * fmask[None, :]
            S = S + jnp.diag(1.0 - fmask)
            # rhs and landmark back-substitution reuse T (U v == T^T-style
            # contractions), so the dense path pays no U/U_T scatter passes
            rhs = -(g_p.reshape(D)
                    - jnp.einsum("pdi,pi->d", T,
                                 jnp.einsum("pij,pj->pi", G, g_l))) * fmask
            dp = jnp.linalg.solve(S, rhs).reshape(K, 6)
            dp = dp * free[:, None]
            ut_dp = jnp.einsum("pdi,d->pi", T, dp.reshape(D))
        else:
            # rhs = -(g_p - U G g_l), projected to free frames
            rhs = -(g_p - U(to_full(jnp.einsum("pij,pj->pi", G, g_l)))) \
                * free[:, None]
            x0 = jnp.zeros_like(rhs)
            z0 = precond(rhs)
            (dp, *_), _ = jax.lax.scan(
                cg_body,
                (x0, rhs, z0, z0, _psum(jnp.sum(rhs * z0), axis_name)),
                None,
                length=cg_iters,
            )
            ut_dp = U_T(dp)

        # back-substitute landmarks: dl = G (-g_l - U^T dp), computed on
        # this rank's point shard then gathered (identical on every rank)
        dl = to_full(jnp.einsum("pij,pj->pi", G, -g_l - ut_dp))
        dl = jnp.where(p.pt_valid[:, None], dl, 0.0)

        new_pose = se3.retract(kf_pose, dp)
        new_pose = jnp.where(free[:, None], new_pose, kf_pose)
        new_pts = pt_pos + dl

        new_cost, _ = _cost_only(new_pose, new_pts, p, cam, obs_ok0,
                                 huber_delta, use_huber, axis_name)
        improved = new_cost < prev_cost
        kf_pose = jnp.where(improved, new_pose, kf_pose)
        pt_pos = jnp.where(improved, new_pts, pt_pos)
        lam = jnp.clip(jnp.where(improved, lam * 0.4, lam * 5.0), 1e-8, 1e5)
        cost = jnp.where(improved, new_cost, prev_cost)
        # early exit on gain stall (g2o's LM likewise terminates early,
        # optimization_algorithm_levenberg.cpp): an accepted step improving
        # cost by < 1e-5 relative means the remaining iterations are
        # no-ops, and each costs a full Jacobian + Schur + CG/solve pass
        # (the dominant slice of the per-keyframe window-BA device time)
        rel_gain = (prev_cost - new_cost) / jnp.maximum(prev_cost, 1e-12)
        done = improved & (rel_gain < 1e-5)
        return (kf_pose, pt_pos, lam, cost, it + 1, done)

    cost0, _ = _cost_only(
        p.kf_pose, p.pt_pos, p, cam, obs_ok0,
        jnp.sqrt(jnp.where(has_ur, CHI2_STEREO, CHI2_MONO)), use_huber, axis_name,
    )
    pt0 = p.pt_pos
    if shard_pts:
        # the point-sharded path's all_gathered updates are tracked as
        # varying over the mesh axis (identical on every rank in value);
        # the loop carry's initial value must match that annotation
        pt0 = jax.lax.pcast(pt0, axis_name, to="varying")
    kf_pose, pt_pos, _, final_cost, _, _ = jax.lax.while_loop(
        lambda st: (st[4] < iters) & ~st[5],
        lm_step,
        (p.kf_pose, pt0, jnp.float32(lambda0), cost0, jnp.int32(0),
         jnp.bool_(False)),
    )
    _, chi2 = _cost_only(kf_pose, pt_pos, p, cam, obs_ok0,
                         jnp.sqrt(chi2_th), use_huber, axis_name)
    inlier = obs_ok0 & (chi2 <= chi2_th) if chi2_gate else obs_ok0
    return BAResult(kf_pose, pt_pos, cost0, final_cost, inlier)
