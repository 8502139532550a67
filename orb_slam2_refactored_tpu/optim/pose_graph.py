"""Sim(3) pose-graph optimization (essential graph), matrix-free LM+CG.

Capability analog of `Optimizer::OptimizeEssentialGraph`
(`/root/reference/src/Optimizer.cc:743-942`): optimize every keyframe's
7-DoF similarity pose against relative-Sim3 edge measurements (loop edges,
spanning-tree edges, strong-covisibility edges with weight >= 100), fixed
loop keyframe as gauge, 20 LM iterations.

Accelerator-first: no g2o graph; edges are index arrays [E] with Sim3 measurements
[E,8]. Residuals r_e = log(M_e * S_j * S_i^-1) and both 7x7 Jacobian blocks
come from one vmapped jacfwd; the normal equations solve runs matrix-free
preconditioned CG over the [K,7] tangent space (scatter-add along edge
endpoints) — the same shape that shards over a keyframe mesh axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import sim3


class PoseGraphProblem(NamedTuple):
    poses: jnp.ndarray    # f32[K,8] Sim3 world->camera (Scw)
    fixed: jnp.ndarray    # bool[K]
    edge_i: jnp.ndarray   # i32[E]
    edge_j: jnp.ndarray   # i32[E]
    edge_rel: jnp.ndarray  # f32[E,8] measurement M_e ~ S_i * S_j^-1
    edge_w: jnp.ndarray   # f32[E] weight (0 = padding)


def edge_measurement(pose_i, pose_j):
    """M_e = S_i * S_j^-1 so that log(M_e * S_j * S_i^-1) = 0 at consistency."""
    return sim3.compose(pose_i, sim3.inverse(pose_j))


def _edge_residual(pose_i, pose_j, rel):
    return sim3.log(sim3.compose(rel, sim3.compose(pose_j, sim3.inverse(pose_i))))


def pose_graph_solve(
    p: PoseGraphProblem,
    iters: int = 20,
    cg_iters: int = 60,
    lambda0: float = 1e-4,
):
    """Returns (poses [K,8], initial_cost, final_cost)."""
    with jax.default_matmul_precision("highest"):
        return _pose_graph_solve_f32(p, iters, cg_iters, lambda0)


def _pose_graph_solve_f32(p, iters, cg_iters, lambda0):
    K = p.poses.shape[0]
    free = ~p.fixed

    def residuals_jacobians(poses):
        pi = poses[p.edge_i]
        pj = poses[p.edge_j]

        def one(a, b, rel):
            def f(da, db):
                return _edge_residual(sim3.retract(a, da), sim3.retract(b, db), rel)

            z = jnp.zeros(7)
            r = f(z, z)
            Ji = jax.jacfwd(f, argnums=0)(z, z)
            Jj = jax.jacfwd(f, argnums=1)(z, z)
            return r, Ji, Jj

        return jax.vmap(one)(pi, pj, p.edge_rel)

    def cost_of(poses):
        pi = poses[p.edge_i]
        pj = poses[p.edge_j]
        r = jax.vmap(_edge_residual)(pi, pj, p.edge_rel)
        return jnp.sum(p.edge_w * jnp.sum(r * r, -1))

    def lm_step(state, _):
        poses, lam, prev_cost = state
        r, Ji, Jj = residuals_jacobians(poses)  # [E,7], [E,7,7] x2
        w = p.edge_w[:, None, None]
        JiW = Ji * w
        JjW = Jj * w
        g = (
            jnp.zeros((K, 7))
            .at[p.edge_i]
            .add(jnp.einsum("eci,ec->ei", JiW, r))
            .at[p.edge_j]
            .add(jnp.einsum("eci,ec->ei", JjW, r))
        )
        # block-diagonal for preconditioner + damping
        Hii = jnp.zeros((K, 7, 7)).at[p.edge_i].add(
            jnp.einsum("eci,ecj->eij", JiW, Ji)
        ).at[p.edge_j].add(jnp.einsum("eci,ecj->eij", JjW, Jj))
        diag = jnp.diagonal(Hii, axis1=1, axis2=2)
        Hii_d = Hii + (lam * diag + 1e-6)[:, :, None] * jnp.eye(7)[None]
        Minv = jnp.linalg.inv(Hii_d + 1e-9 * jnp.eye(7)[None])

        def H_mv(v):
            v = v * free[:, None]
            vi = v[p.edge_i]
            vj = v[p.edge_j]
            Jv = jnp.einsum("eci,ei->ec", Ji, vi) + jnp.einsum("eci,ei->ec", Jj, vj)
            out = (
                jnp.zeros((K, 7))
                .at[p.edge_i]
                .add(jnp.einsum("eci,ec->ei", JiW, Jv))
                .at[p.edge_j]
                .add(jnp.einsum("eci,ec->ei", JjW, Jv))
            )
            out = out + (lam * diag + 1e-6) * v
            return out * free[:, None]

        def precond(v):
            return jnp.einsum("kij,kj->ki", Minv, v) * free[:, None]

        rhs = -g * free[:, None]

        def cg_body(cg_state, _):
            x, rr, z, pd, rz = cg_state
            Ap = H_mv(pd)
            denom = jnp.sum(pd * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
            x = x + alpha * pd
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1e-12, rz)
            return (x, rr, z, z + beta * pd, rz_new), None

        z0 = precond(rhs)
        (dx, *_), _ = jax.lax.scan(
            cg_body, (jnp.zeros_like(rhs), rhs, z0, z0, jnp.sum(rhs * z0)),
            None, length=cg_iters,
        )
        new_poses = sim3.retract(poses, dx)
        new_poses = jnp.where(free[:, None], new_poses, poses)
        new_cost = cost_of(new_poses)
        improved = new_cost < prev_cost
        poses = jnp.where(improved, new_poses, poses)
        lam = jnp.clip(jnp.where(improved, lam * 0.4, lam * 5.0), 1e-8, 1e5)
        return (poses, lam, jnp.where(improved, new_cost, prev_cost)), None

    cost0 = cost_of(p.poses)
    (poses, _, final_cost), _ = jax.lax.scan(
        lm_step, (p.poses, jnp.float32(lambda0), cost0), None, length=iters
    )
    return poses, cost0, final_cost
