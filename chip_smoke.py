"""Smoke run of the SLAM system on one NVIDIA GPU, at VGA width.

    python chip_smoke.py                # device, rgbd, stereo, mono, parity
    python chip_smoke.py --four-cards   # sharded global BA on 4 GPUs only

Each phase prints its own lines, prefixed `[smoke:<phase>]`. The last line
of standard output is one JSON object,
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`,
printed only when every phase passed. Where JAX finds no GPU the script
exits non-zero at once: it never falls back to the CPU.

One process drives the card. A second JAX process on the same card would
fail for want of memory, since each reserves most of it at start-up.

The data is rendered from fixed seeds by `io/synthetic.py` (numpy only).
Times printed here are smoke observations on the card named in the device
line, not benchmark numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ATE_GATE_M = 0.03          # RGB-D and stereo: the bench's hard gate
MONO_SIM3_GATE_M = 0.35    # monocular sanity bar (scale drifts, no loop)
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class SmokeFailure(Exception):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str):
    print(f"[smoke:{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# device identity
# ---------------------------------------------------------------------------

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def parse_smi_line(line: str):
    """`name, power limit` as nvidia-smi prints them -> (name, limit)."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def read_smi() -> str:
    """First card's `name, power.limit`, read by a child that stays off JAX."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def require_gpu():
    """The JAX devices, or exit non-zero where the first is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"JAX found no GPU (first device: {devs[0].platform}); "
              f"nothing was run", file=sys.stderr)
        sys.exit(2)
    return devs


class CompileClock:
    """Seconds XLA spends compiling, from JAX's own monitoring events, so a
    phase's compile time prints apart from its run time."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == COMPILE_EVENT:
            self.seconds += duration


@dataclasses.dataclass
class Phase:
    """Wall and compile seconds of one phase."""

    clock: CompileClock
    t0: float = 0.0
    c0: float = 0.0

    def __post_init__(self):
        self.t0 = time.perf_counter()
        self.c0 = self.clock.seconds

    def split(self) -> str:
        wall = time.perf_counter() - self.t0
        comp = self.clock.seconds - self.c0
        return (f"wall {wall:.1f} s = compile {comp:.1f} s + "
                f"run {wall - comp:.1f} s")


def phase_device(clock):
    from orb_slam2_refactored_tpu.compile_cache import cache_dir
    from orb_slam2_refactored_tpu.native import load_library

    p = Phase(clock)
    say("device", f"compile cache: {cache_dir()}")
    lib = load_library()
    say("device", f"map graph: native ({lib._name})"
        if os.environ.get("TPU_SLAM_NATIVE_GRAPH", "1") != "0"
        else "map graph: python (TPU_SLAM_NATIVE_GRAPH=0)")
    say("device", p.split())


# ---------------------------------------------------------------------------
# sequences (geometry of bench.py's VGA orbit and panning circuit)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Geometry:
    width: int = 640
    height: int = 480
    fx: float = 520.0
    n_features: int = 1000
    settings: str = os.path.join(REPO, "configs", "synthetic_rgbd_vga.yaml")
    max_keyframes: int = 128
    max_points: int = 32768


def _scene(geo: Geometry, **kw):
    from orb_slam2_refactored_tpu.io.synthetic import SyntheticScene, box_room

    planes = box_room(half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0, **kw)
    return SyntheticScene(width=geo.width, height=geo.height, fx=geo.fx,
                          fy=geo.fx, planes=planes, baseline=0.08)


def circuit_frames(geo: Geometry, n=170, overlap=30, radius=0.7, seed=23):
    """Panning circuit: a full yaw sweep around the room whose last
    `overlap` frames revisit the start, so a loop has to close."""
    from orb_slam2_refactored_tpu.slam.system import _np_inverse

    scene = _scene(geo, distinct_textures=True)
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, geo.height, geo.width), np.uint8)
    depths = np.zeros((n, geo.height, geo.width), np.float32)
    gt = np.zeros((n, 7), np.float32)
    for i in range(n):
        a = 2.0 * np.pi * i / (n - overlap)
        pose_wc = np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0,
                            radius * np.sin(a), 0.0,
                            radius * (1 - np.cos(a)) * 0.5], np.float32)
        gt[i] = _np_inverse(pose_wc)
        img, depth = scene.render(gt[i])
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        depths[i] = depth * (1 + rng.normal(0, 0.01, depth.shape))
    return imgs, depths, gt


def orbit_poses(n: int):
    """First `n` poses of the bench's 200-frame orbit."""
    from orb_slam2_refactored_tpu.io.synthetic import orbit_trajectory

    return orbit_trajectory(200, radius=0.4, yaw_amp=0.3)[:n]


def _stage_count(tracker, stage: str) -> int:
    return len(tracker.timer.samples.get(stage, ()))


def _create(geo: Geometry, sensor: int):
    from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu.slam.system import SlamSystem

    return SlamSystem.create(
        geo.settings, sensor, enable_loop_closing=True,
        map_capacity=MapCapacity(max_keyframes=geo.max_keyframes,
                                 max_points=geo.max_points,
                                 max_features=geo.n_features))


# ---------------------------------------------------------------------------
# phases on the main path
# ---------------------------------------------------------------------------

def phase_rgbd(clock, geo: Geometry, card: str):
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu.slam.system import RGBD
    from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackState

    imgs, depths, gt = circuit_frames(geo)
    p = Phase(clock)
    system = _create(geo, RGBD)
    # the ORBvoc probe's tracker config (covisibility-window local map, a
    # keyframe at least every 8 frames): with SlamSystem.create's whole-map
    # default this circuit closes its BoW loop too, but ends at 4.0 cm ATE
    # on the H100, over the 3 cm gate
    system.tracker = Tracker(dataclasses.replace(
        system.tracker.cfg, local_map_window=10, kf_max_interval=8))
    tr = system.tracker
    say("rgbd", f"{geo.width}x{geo.height}, {tr.cfg.n_features} features, "
                f"{tr.cfg.n_levels} levels, {len(imgs)}-frame panning "
                f"circuit (seed 23), loop closing on; tracker given the "
                f"ORBvoc probe's windowed config (local_map_window="
                f"{tr.cfg.local_map_window}, kf_max_interval="
                f"{tr.cfg.kf_max_interval}): the whole-map default closes "
                f"the loop but misses the ATE gate on this circuit")
    times, explicit, implicit = [], 0, 0
    for i in range(len(imgs)):
        loops = tr.loop_closer.loops_closed if tr.loop_closer else 0
        t = time.perf_counter()
        system.track_rgbd(imgs[i], depths[i], i / 30.0)
        times.append(time.perf_counter() - t)
        if tr.loop_closer is not None and tr.loop_closer.loops_closed > loops:
            if tr.last_loop_info.get("implicit"):
                implicit += 1
            else:
                explicit += 1
    tr.flush()
    first_pass = p.split()
    est = system.corrected_frame_poses()
    ate, _ = ate_rmse(est, gt, align="se3")
    n_kf = int(tr.graph.num_kfs)
    n_ba = _stage_count(tr, "kf.local_ba")
    n_ba_held = _stage_count(tr, "kf.local_ba_held")
    n_gba = _stage_count(tr, "kf.gba_merge")
    say("rgbd", f"{len(imgs)} frames, {n_kf} keyframes "
                f"({len(tr.graph.alive_kfs())} alive), loops closed "
                f"{explicit + implicit} (BoW/Sim3 {explicit}, implicit "
                f"{implicit}), global BAs merged {n_gba}, local BAs {n_ba} "
                f"+ {n_ba_held} held while a global BA ran, ATE(se3) "
                f"{ate * 100:.3f} cm (gate {ATE_GATE_M * 100:.0f} cm), "
                f"state {tr.state}")
    say("rgbd", f"first pass (compiling): {first_pass}; median track_rgbd "
                f"{np.median(times) * 1e3:.2f} ms (smoke observation on "
                f"{card}, not a benchmark)")
    buf = jnp.asarray(tr._pack_rgbd(imgs[-1], depths[-1]))
    args = (buf, tr.last_frame, tr.last_mp_dev, tr.map, tr.pose_dev,
            tr.velocity_dev, tr._ref_kf_scalar(), tr.mp_vis_dev,
            tr.mp_found_dev, tr.local_mask_dev, tr.mp_seen_dev, tr.fidx_dev)
    ma = tr._step_packed.lower(*args).compile().memory_analysis()
    if ma is not None:
        say("rgbd", "per-frame step memory_analysis: "
                    f"arguments {ma.argument_size_in_bytes / 2**20:.1f} MiB, "
                    f"outputs {ma.output_size_in_bytes / 2**20:.1f} MiB, "
                    f"temps {ma.temp_size_in_bytes / 2**20:.1f} MiB, "
                    f"code {ma.generated_code_size_in_bytes / 2**20:.1f} MiB")
    check(tr.state == TrackState.OK, f"rgbd: tracking ended in state "
                                     f"{tr.state}, not OK")
    check(explicit + implicit >= 1, "rgbd: no loop closed")
    check(n_gba >= 1, "rgbd: no global BA merged")
    check(n_ba >= 1 and n_ba + n_ba_held == n_kf - 1,
          f"rgbd: local BA ran on {n_ba} + {n_ba_held} held of the "
          f"{n_kf - 1} keyframes after the first")
    check(ate < ATE_GATE_M, f"rgbd: ATE {ate:.4f} m over the gate")


def phase_stereo(clock, geo: Geometry, card: str, n: int = 120):
    from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu.slam.system import STEREO
    from orb_slam2_refactored_tpu.slam.tracking import TrackState

    gt = orbit_poses(n)
    scene = _scene(geo)
    pairs = []
    for pose in gt:
        left, right, _ = scene.render_stereo(pose)
        pairs.append((np.clip(left, 0, 255).astype(np.uint8),
                      np.clip(right, 0, 255).astype(np.uint8)))
    p = Phase(clock)
    system = _create(geo, STEREO)
    times = []
    for i, (left, right) in enumerate(pairs):
        t = time.perf_counter()
        system.track_stereo(left, right, i / 30.0)
        times.append(time.perf_counter() - t)
    system.tracker.flush()
    split = p.split()
    ate, _ = ate_rmse(system.corrected_frame_poses(), gt, align="se3")
    tr = system.tracker
    say("stereo", f"{n} frames of the {geo.width}x{geo.height} stereo "
                  f"orbit (baseline 0.08 m), "
                  f"{int(tr.graph.num_kfs)} keyframes, ATE(se3) "
                  f"{ate * 100:.3f} cm (gate {ATE_GATE_M * 100:.0f} cm), "
                  f"state {tr.state}")
    say("stereo", f"{split}; median track_stereo "
                  f"{np.median(times) * 1e3:.2f} ms (smoke observation on "
                  f"{card})")
    check(tr.state == TrackState.OK, f"stereo: state {tr.state}, not OK")
    check(ate < ATE_GATE_M, f"stereo: ATE {ate:.4f} m over the gate")


def phase_mono(clock, geo: Geometry, card: str, n: int = 120):
    from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu.slam.system import MONOCULAR
    from orb_slam2_refactored_tpu.slam.tracking import TrackState

    gt = orbit_poses(n)
    scene = _scene(geo)
    imgs = [np.clip(scene.render(pose)[0], 0, 255).astype(np.uint8)
            for pose in gt]
    p = Phase(clock)
    system = _create(geo, MONOCULAR)
    times = []
    for i, img in enumerate(imgs):
        t = time.perf_counter()
        system.track_monocular(img, i / 30.0)
        times.append(time.perf_counter() - t)
    system.tracker.flush()
    split = p.split()
    tr = system.tracker
    tracked = np.array([not e["lost"] for e in tr.traj_entries])
    check(tracked.any(), "mono: monocular initialization never succeeded")
    first = int(np.argmax(tracked))
    est = system.corrected_frame_poses()
    ate, _ = ate_rmse(est[tracked], gt[tracked], align="sim3")
    say("mono", f"{n} frames of the {geo.width}x{geo.height} orbit, "
                f"initialized at frame "
                f"{first}, {int(tracked.sum())} frames tracked, "
                f"{int(tr.graph.num_kfs)} keyframes, ATE(sim3, tracked "
                f"frames) {ate * 100:.2f} cm (bar "
                f"{MONO_SIM3_GATE_M * 100:.0f} cm), state {tr.state}")
    say("mono", f"{split}; median track_monocular "
                f"{np.median(times) * 1e3:.2f} ms (smoke observation on "
                f"{card})")
    check(tr.state == TrackState.OK, f"mono: state {tr.state}, not OK")
    check(ate < MONO_SIM3_GATE_M, f"mono: sim3 ATE {ate:.4f} m over the bar")


# ---------------------------------------------------------------------------
# parity with the numpy oracles of tests/test_orb_parity.py
# ---------------------------------------------------------------------------

def popcount_oracle(a: np.ndarray, b: np.ndarray, rows: int = 64):
    """Hamming distances u32[M,8] x u32[N,8] -> i32[M,N] in numpy."""
    lut = np.array([bin(i).count("1") for i in range(256)], np.int32)
    out = np.zeros((a.shape[0], b.shape[0]), np.int32)
    for s in range(0, a.shape[0], rows):
        x = np.bitwise_xor(a[s:s + rows, None, :], b[None, :, :])
        out[s:s + rows] = lut[x.view(np.uint8)].sum(-1)
    return out


def phase_parity(clock, geo: Geometry, n_corners: int = 150,
                 hamming_n: int = 32768):
    import jax
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.ops import fast as fast_ops
    from orb_slam2_refactored_tpu.ops import hamming
    from orb_slam2_refactored_tpu.ops import orb as orb_ops

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_orb_parity as oracle

    p = Phase(clock)
    img = np.clip(_scene(geo).render(orbit_poses(1)[0])[0], 0, 255
                  ).astype(np.uint8)
    img_d = jnp.asarray(img, jnp.float32)

    # FAST: integer arithmetic in f32, so the strength map is exact
    ours = np.asarray(jax.jit(fast_ops.fast_strength_map)(img_d))
    ref = oracle.oracle_fast_strength(img)
    inner = np.s_[3:-3, 3:-3]
    n_bad = int((ours[inner] != ref[inner]).sum())
    say("parity", f"FAST strength map {img.shape[1]}x{img.shape[0]}: "
                  f"{n_bad} pixels differ (tolerance 0: integer arithmetic "
                  f"is exact in f32)")
    check(n_bad == 0, "parity: FAST strength map differs from the oracle")

    # IC angle on the raw image, and the production angle, which takes the
    # moments of the in-window blurred patch
    ys, xs = oracle._interior_corners(img, n=n_corners)
    umax = oracle.oracle_umax()
    ref_raw = np.array([oracle.oracle_ic_angle(img, y, x, umax)
                        for y, x in zip(ys, xs)])
    ang_raw = np.asarray(jax.jit(orb_ops.ic_angles)(
        img_d, jnp.asarray(ys), jnp.asarray(xs)))
    blur_ref = oracle.oracle_blur(img)
    ref_blur = np.array([oracle.oracle_ic_angle(blur_ref, y, x, umax)
                         for y, x in zip(ys, xs)])
    ang, desc = jax.jit(orb_ops.angles_and_descriptors_mxu_raw)(
        img_d, jnp.asarray(ys), jnp.asarray(xs))
    ang, desc = np.asarray(ang), oracle.unpack_desc(desc)

    def deg(a, b):
        return np.degrees(np.abs(np.angle(np.exp(1j * (a - b)))))

    d_raw, d_blur = deg(ang_raw, ref_raw).max(), deg(ang, ref_blur).max()
    say("parity", f"IC angle at {len(ys)} corners: raw-image max "
                  f"{d_raw:.5f} deg, production (blurred window) max "
                  f"{d_blur:.5f} deg (tolerance 0.01 deg: f32 vs f64 "
                  f"moment sums)")
    check(d_raw < 0.01 and d_blur < 0.01, "parity: IC angle off the oracle")

    # descriptor bits at the production path's own angle bin centers
    B = orb_ops.N_ANGLE_BINS
    bins = np.floor((ang + np.pi) * (B / (2 * np.pi))).astype(int) % B
    centers = (bins + 0.5) * 2 * np.pi / B - np.pi
    pat = orb_ops.get_pattern("fresh")
    bad = total = 0
    for k, (y, x) in enumerate(zip(ys, xs)):
        ref_bits, margin = oracle.oracle_descriptor(blur_ref, y, x,
                                                    float(centers[k]), pat)
        tight = margin > 1.0
        bad += int((desc[k] != ref_bits)[tight].sum())
        total += int(tight.sum())
    say("parity", f"descriptor bits: {bad} of {total} differ where the "
                  f"test pair differs by > 1 gray (tolerance 0; pairs "
                  f"closer than that may flip under the bf16 BRIEF "
                  f"contraction)")
    check(total > 100 * len(ys) and bad == 0,
          "parity: descriptor bits differ from the oracle")

    # per-level budgets, and what the card's extractor filled of them
    ex = orb_ops.OrbExtractor(geo.height, geo.width, n_features=geo.n_features,
                              n_levels=8, scale_factor=1.2)
    feats = ex(jnp.asarray(img))
    lv = np.asarray(feats.level)[np.asarray(feats.valid)]
    filled = np.bincount(lv, minlength=8).tolist()
    ref_b = oracle.oracle_budgets(geo.n_features, 1.2, 8)
    say("parity", f"per-level budgets {ex.budgets} vs oracle {ref_b} "
                  f"(tolerance: equal); keypoints filled {filled}")
    check(ex.budgets == ref_b, "parity: per-level budgets differ")
    check(all(f <= b for f, b in zip(filled, ref_b)),
          "parity: a level holds more keypoints than its budget")

    # the Hamming core, bit-exact against a numpy popcount
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2 ** 32, (1000, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (hamming_n, 8), dtype=np.uint32)
    d = np.asarray(jax.jit(hamming.hamming_matrix)(jnp.asarray(a),
                                                   jnp.asarray(b)))
    n_bad = int((d != popcount_oracle(a, b)).sum())
    say("parity", f"hamming_matrix [1000 x {hamming_n}]: {n_bad} entries "
                  f"differ from numpy popcount (tolerance 0: integer)")
    check(n_bad == 0, "parity: hamming_matrix differs from popcount")
    say("parity", p.split())


# ---------------------------------------------------------------------------
# sharded global BA over four cards
# ---------------------------------------------------------------------------

def phase_four_cards(clock, devs, K: int = 1408, N: int = 128,
                     P: int = 16384, iters: int = 5, cg_iters: int = 30):
    """Sharded global BA on a 1-D keyframe mesh of four cards against the
    single-card `ba_solve`, at KITTI-00 keyframe scale (K, N and P of
    tests/test_distributed.py)."""
    import jax

    sys.path.insert(0, REPO)
    from __graft_entry__ import make_ba_problem
    from orb_slam2_refactored_tpu.optim.ba import ba_solve
    from orb_slam2_refactored_tpu.parallel.sharded_ba import (
        make_mesh, sharded_ba_solve,
    )

    check(len(devs) >= 4, f"four-cards: {len(devs)} devices, need 4")
    prob, cam = make_ba_problem(K=K, N=N, P=P)
    mesh = make_mesh(devs[:4])
    single = jax.jit(lambda q: ba_solve(q, cam, iters=iters,
                                        cg_iters=cg_iters))
    sharded = jax.jit(lambda q: sharded_ba_solve(q, cam, mesh, iters=iters,
                                                 cg_iters=cg_iters))

    def run(fn):
        p = Phase(clock)
        jax.block_until_ready(fn(prob))
        first = p.split()
        t = time.perf_counter()
        res = jax.block_until_ready(fn(prob))
        return res, first, time.perf_counter() - t

    r1, first1, t1 = run(single)
    r4, first4, t4 = run(sharded)
    c0 = (float(r1.initial_cost), float(r4.initial_cost))
    c1 = (float(r1.final_cost), float(r4.final_cost))
    dpose = float(np.abs(np.asarray(r1.kf_pose) - np.asarray(r4.kf_pose)
                         ).max())
    say("four-cards", f"global BA K={K} N={N} P={P}, {iters} LM x "
                      f"{cg_iters} CG; 1 card: first call {first1}, "
                      f"solve {t1 * 1e3:.1f} ms; 4 cards "
                      f"(1-D keyframe mesh): first call {first4}, solve "
                      f"{t4 * 1e3:.1f} ms")
    say("four-cards", f"cost 1 card {c0[0]:.6g} -> {c1[0]:.6g}, 4 cards "
                      f"{c0[1]:.6g} -> {c1[1]:.6g}; max |pose diff| "
                      f"{dpose:.2e} (tolerance: initial cost rtol 1e-5, "
                      f"final cost rtol 2e-2, poses 2e-3 — f32 sums in "
                      f"another order across four shards)")
    check(abs(c0[0] - c0[1]) <= 1e-5 * abs(c0[0]), "four-cards: initial "
                                                   "costs differ")
    check(abs(c1[0] - c1[1]) <= 2e-2 * abs(c1[0]), "four-cards: final "
                                                   "costs differ")
    check(c1[1] < c0[1], "four-cards: the sharded solve made no progress")
    check(dpose < 2e-3, "four-cards: poses differ")


# ---------------------------------------------------------------------------

def phase_names(four_cards: bool):
    """The phases a run makes: all single-card phases, or with
    `--four-cards` the sharded BA (and its single-card reference) alone."""
    if four_cards:
        return ["four-cards"]
    return ["device", "rgbd", "stereo", "mono", "parity"]


def run_phases(phases):
    """Run every phase, even after one fails, so one run shows all faults;
    returns the names of those that failed."""
    import traceback

    failed = []
    for name, fn in phases:
        try:
            fn()
        except Exception as e:  # reported, and the run exits non-zero
            traceback.print_exc()
            say(name, f"FAILED: {e}")
            failed.append(name)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded global BA on four GPUs and "
                         "the single-card solve it is compared with")
    args = ap.parse_args(argv)

    devs = require_gpu()
    sys.path.insert(0, REPO)
    from orb_slam2_refactored_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    clock = CompileClock()
    smi = read_smi()
    name, limit = parse_smi_line(smi)
    import jax

    print(f"[smoke] jax {jax.__version__}, {devs[0].device_kind} x "
          f"{len(devs)}, platform {devs[0].platform}; nvidia-smi: {smi}",
          flush=True)
    geo = Geometry()
    card = f"{name}, {limit}"
    fns = {
        "device": lambda: phase_device(clock),
        "rgbd": lambda: phase_rgbd(clock, geo, card),
        "stereo": lambda: phase_stereo(clock, geo, card),
        "mono": lambda: phase_mono(clock, geo, card),
        "parity": lambda: phase_parity(clock, geo),
        "four-cards": lambda: phase_four_cards(clock, devs),
    }
    failed = run_phases([(n, fns[n]) for n in phase_names(args.four_cards)])
    if failed:
        print(f"chip_smoke FAILED: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
