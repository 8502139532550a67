"""Multi-host wiring for the sharded global bundle adjustment.

The reference has no distribution at all (SURVEY.md §2.3); the multi-host
scaling story is: one JAX process per host, `jax.distributed.initialize`
over the coordinator, a 1-D keyframe mesh spanning every device of every
host, and `sharded_ba_solve` unchanged — its psums ride NVLink within a host
and the network across hosts. Communication per CG iteration is a single
[P,3] psum + two scalar psums (~200KB at P=16k); whether hosts stay
compute-bound (the >=70%-at-2-hosts north star of BASELINE.json) is not
measured on the H100.

`run_multiprocess_ba` is the per-process entry used by the 2-process CPU
smoke test (tests/test_distributed.py): it initializes the process group,
builds the identical BA problem in every process, shards the keyframe axis
over the GLOBAL device mesh via `jax.device_put` + NamedSharding, and solves.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str, num_processes: int, process_id: int):
    """`jax.distributed.initialize` wrapper (one call per host/process)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def run_multiprocess_ba(K: int = 64, N: int = 128, P: int = 2048,
                        iters: int = 2, cg_iters: int = 6):
    """Solve a keyframe-sharded BA over ALL processes' devices.

    Must be called after `initialize`. Every process constructs the same
    problem (same seed); the keyframe-axis leaves are globally sharded with
    `jax.device_put`, landmark leaves replicate. Returns
    (initial_cost, final_cost) — identical on every process (the costs are
    psum-reduced inside the solve).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS

    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from __graft_entry__ import make_ba_problem
    from .sharded_ba import AXIS, make_mesh, pad_problem
    from ..optim.ba import BAProblem, BAResult, ba_solve
    from functools import partial

    prob, cam = make_ba_problem(K=K, N=N, P=P)
    mesh = make_mesh(jax.devices())  # GLOBAL mesh across processes
    n = mesh.shape[AXIS]
    prob = pad_problem(prob, n)

    kf_s = NamedSharding(mesh, PS(AXIS))
    pt_s = NamedSharding(mesh, PS())

    def put(x, s):
        return jax.device_put(np.asarray(x), s)

    gprob = BAProblem(
        kf_pose=put(prob.kf_pose, kf_s), kf_fixed=put(prob.kf_fixed, kf_s),
        obs_uv=put(prob.obs_uv, kf_s), obs_ur=put(prob.obs_ur, kf_s),
        obs_pt=put(prob.obs_pt, kf_s), obs_inv_s2=put(prob.obs_inv_s2, kf_s),
        pt_pos=put(prob.pt_pos, pt_s), pt_valid=put(prob.pt_valid, pt_s),
    )
    kf_spec = PS(AXIS)
    pt_spec = PS()
    in_specs = BAProblem(
        kf_pose=kf_spec, kf_fixed=kf_spec, obs_uv=kf_spec, obs_ur=kf_spec,
        obs_pt=kf_spec, obs_inv_s2=kf_spec, pt_pos=pt_spec, pt_valid=pt_spec,
    )
    out_specs = BAResult(kf_pose=kf_spec, pt_pos=pt_spec,
                         initial_cost=pt_spec, final_cost=pt_spec,
                         obs_inlier=kf_spec)
    fn = jax.jit(jax.shard_map(
        partial(ba_solve, cam=cam, iters=iters, cg_iters=cg_iters,
                axis_name=AXIS),
        mesh=mesh, in_specs=(in_specs,), out_specs=out_specs,
    ))
    res = fn(gprob)
    c0 = float(np.asarray(jax.device_get(res.initial_cost)))
    c1 = float(np.asarray(jax.device_get(res.final_cost)))
    return c0, c1
