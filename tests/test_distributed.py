"""Multi-PROCESS sharded BA: two OS processes, `jax.distributed.initialize`,
one global keyframe mesh — the single-host stand-in for the multi-host DCN
path (each process models one host; collectives cross the process boundary).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
K = int(sys.argv[4]); N = int(sys.argv[5]); P = int(sys.argv[6])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.getcwd())
from orb_slam2_refactored_tpu.parallel.distributed import (
    initialize, run_multiprocess_ba,
)
initialize(coord, nproc, pid)
assert jax.device_count() == 2 * nproc, jax.devices()
assert jax.process_count() == nproc
c0, c1 = run_multiprocess_ba(K=K, N=N, P=P)
print(f"RESULT {pid} {c0:.6f} {c1:.6f}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run_two_process(tmp_path, K, N, P):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_COMPILATION_CACHE_DIR"] = ""  # isolate from the session cache
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", coord,
             str(K), str(N), str(P)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, c0, c1 = line.split()
                results[int(pid)] = (float(c0), float(c1))
    assert set(results) == {0, 1}, f"missing results: {outs}"
    # both processes must agree bit-for-bit (the costs are psum-reduced
    # across the process boundary) and the solve must make progress
    assert results[0] == results[1]
    c0, c1 = results[0]
    assert np.isfinite(c1) and c1 < c0


def test_two_process_sharded_ba(tmp_path):
    _run_two_process(tmp_path, K=64, N=128, P=2048)


def test_two_process_sharded_ba_kitti_scale(tmp_path):
    """KITTI-00-scale keyframe count (K~1400; the reference's largest
    standard sequence, `Examples/Stereo/stereo_kitti.cc`) through the REAL
    2-process jax.distributed path: the keyframe axis
    shards 704/process and every point-space reduction crosses the
    process boundary."""
    _run_two_process(tmp_path, K=1408, N=128, P=16384)
