"""Keyframe-sharded global bundle adjustment over a device mesh.

The distributed analog of the reference's Global BA thread
(`/root/reference/src/LoopClosing.cc:349-499` + `src/Optimizer.cc:204-343`),
redesigned for a multi-device mesh (BASELINE.json configs[4]): the keyframe axis of
the BA problem shards across a 1-D `jax.sharding.Mesh`; landmark arrays
replicate. Inside `shard_map`, every point-space reduction (Hll/g_l
assembly, `U^T v` in the Schur CG) and every CG scalar is a `psum` over the mesh;
pose blocks, Jacobians and the block-Jacobi preconditioner stay shard-local.

Communication per CG iteration: one `psum` of a `[P,3]` array + two scalar
psums — the reduced camera system exchange, over NVLink between the cards
of one host, matching the
SURVEY.md §2.3 "distributed comm backend" design row.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import projection as proj
from ..optim.ba import BAProblem, BAResult, ba_solve

AXIS = "kf"


def make_mesh(devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (AXIS,))


def pad_problem(p: BAProblem, n_shards: int) -> BAProblem:
    """Pad the keyframe axis to a multiple of the mesh size with fixed,
    observation-free dummy frames (they contribute nothing to any reduction)."""
    K = p.kf_pose.shape[0]
    pad = (-K) % n_shards
    if pad == 0:
        return p
    return BAProblem(
        kf_pose=jnp.concatenate(
            [p.kf_pose, jnp.tile(jnp.asarray([1, 0, 0, 0, 0, 0, 0], jnp.float32), (pad, 1))]
        ),
        kf_fixed=jnp.concatenate([p.kf_fixed, jnp.ones(pad, bool)]),
        obs_uv=jnp.concatenate([p.obs_uv, jnp.zeros((pad,) + p.obs_uv.shape[1:])]),
        obs_ur=jnp.concatenate([p.obs_ur, -jnp.ones((pad,) + p.obs_ur.shape[1:])]),
        obs_pt=jnp.concatenate(
            [p.obs_pt, jnp.full((pad,) + p.obs_pt.shape[1:], -1, jnp.int32)]
        ),
        obs_inv_s2=jnp.concatenate(
            [p.obs_inv_s2, jnp.ones((pad,) + p.obs_inv_s2.shape[1:])]
        ),
        pt_pos=p.pt_pos,
        pt_valid=p.pt_valid,
        pt_frozen=p.pt_frozen,
    )


def sharded_ba_solve(
    p: BAProblem,
    cam: proj.CameraIntrinsics,
    mesh: Mesh,
    iters: int = 10,
    cg_iters: int = 50,
    use_huber: bool = True,
) -> BAResult:
    """Run `ba_solve` with the keyframe axis sharded over `mesh`.

    Returns the full (unsharded) result; the caller slices off any padding.
    """
    n = mesh.shape[AXIS]
    K0 = p.kf_pose.shape[0]
    P0 = p.pt_pos.shape[0]
    p = pad_problem(p, n)
    # the point axis shards inside the solve (reduce-scatter + all-gather,
    # see optim/ba.py `shard_pts`): pad P to a mesh multiple
    pad_p = (-P0) % n
    if pad_p:
        p = p._replace(
            pt_pos=jnp.concatenate([p.pt_pos, jnp.zeros((pad_p, 3))]),
            pt_valid=jnp.concatenate([p.pt_valid, jnp.zeros(pad_p, bool)]),
            pt_frozen=(None if p.pt_frozen is None else jnp.concatenate(
                [p.pt_frozen, jnp.ones(pad_p, bool)])),
        )

    kf_spec = P(AXIS)
    pt_spec = P()
    in_specs = BAProblem(
        kf_pose=kf_spec, kf_fixed=kf_spec, obs_uv=kf_spec, obs_ur=kf_spec,
        obs_pt=kf_spec, obs_inv_s2=kf_spec, pt_pos=pt_spec, pt_valid=pt_spec,
    )
    out_specs = BAResult(
        kf_pose=kf_spec,
        pt_pos=pt_spec,
        initial_cost=pt_spec,
        final_cost=pt_spec,
        obs_inlier=kf_spec,
    )

    fn = jax.shard_map(
        partial(
            ba_solve, cam=cam, iters=iters, cg_iters=cg_iters,
            use_huber=use_huber, axis_name=AXIS, axis_size=n,
        ),
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=out_specs,
        # pt_pos is rebuilt by a deterministic all_gather of the
        # reduce-scattered point shards — bit-identical on every rank, but
        # "varying" to the static replication checker (there is no
        # varying->invarying pcast by design). The n=1-vs-n parity test
        # asserts the replication empirically (tests/test_sharded_ba.py).
        check_vma=False,
    )
    res = fn(p)
    if res.kf_pose.shape[0] != K0 or res.pt_pos.shape[0] != P0:
        res = BAResult(
            kf_pose=res.kf_pose[:K0],
            pt_pos=res.pt_pos[:P0],
            initial_cost=res.initial_cost,
            final_cost=res.final_cost,
            obs_inlier=res.obs_inlier[:K0],
        )
    return res
