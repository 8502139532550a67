"""Benchmark: RGB-D tracking throughput on a synthetic VGA sequence.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline: the reference CPU engine tracks TUM sequences in real time at the
dataset's 30 fps replay rate (`/root/reference/Examples/Monocular/TUM1.yaml`
`Camera.fps: 30.0`, pacing loop `mono_tum.cc:92-100`; desktop-CPU median
tracking times in the ORB-SLAM2 literature are ~25-35 ms/frame). We therefore
score `vs_baseline = fps / 30.0`. The run also HARD-gates trajectory
accuracy (ATE must stay under 3 cm or vs_baseline is zeroed) so throughput
can't be bought with garbage poses; accuracy details go to stderr.

Measurement design:
- the first line on stderr names the device (`platform`, `device_kind`,
  count, and nvidia-smi's name and power limit); the bench exits non-zero
  when JAX finds no GPU, rather than timing the CPU.
- warmup is ONE FULL ORBIT: every program the steady state uses compiles
  before measurement, then `warm_stage_programs()` no-op-compiles every
  padding-bucket variant of the keyframe-stage programs. The scored
  tracker keeps loop closing OFF (the orbit's views all co-observe — one
  covisible blob, nothing to close; the BoW index still builds, serving
  relocalization). The loop/Sim3/GBA pathway is exercised and measured by
  the ORBvoc-regime probe (panning circuit, loop closing ON, 1M-word
  vocabulary) and the stereo segment carries the second scored metric.
- all three windows run the IDENTICAL workload (reset -> unmeasured re-warm
  prefix -> measured remainder of the orbit); the median is the score and
  the spread is printed.
- before each measured window, short probes pick the upload batch size
  (`probe_batch`) and the step fusion granularity (`probe_step_mode`);
  BENCH_BATCH / BENCH_PAIR pin them instead.
- the per-stage report covers ONLY the measured windows (steady state).
"""

import json
import os
import sys
import time

import numpy as np

import jax

from chip_smoke import read_smi, require_gpu
from orb_slam2_refactored_tpu.compile_cache import enable_compile_cache

N_FRAMES = int(os.environ.get("BENCH_FRAMES", "200"))
# re-warm prefix per window: enough frames to establish the map (vocabulary
# survives reset_map, so no re-training happens here)
WARMUP = int(os.environ.get("BENCH_WARMUP", "46"))
BATCH = int(os.environ.get("BENCH_BATCH", "1"))
BASELINE_FPS = 30.0
ATE_GATE_M = 0.03  # hard: a >3cm trajectory zeroes the score
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache", f"vga_{N_FRAMES}.npz")


def get_frames():
    """Close-range box room (TUM fr1-like depth conditioning); uint8 images
    and f16 depth keep the host->device upload 4x lighter."""
    from orb_slam2_refactored_tpu.io.synthetic import (
        SyntheticScene, box_room, orbit_trajectory,
    )

    if os.path.exists(CACHE):
        z = np.load(CACHE)
        return z["imgs"], z["depths"], z["gt"]
    planes = box_room(half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=planes)
    gt = orbit_trajectory(N_FRAMES, radius=0.4, yaw_amp=0.3)
    imgs = np.zeros((N_FRAMES, 480, 640), np.uint8)
    depths = np.zeros((N_FRAMES, 480, 640), np.float16)
    rng = np.random.default_rng(0)
    for i in range(N_FRAMES):
        img, depth = scene.render(gt[i])
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        depths[i] = (depth * (1 + rng.normal(0, 0.01, depth.shape))).astype(np.float16)
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    np.savez_compressed(CACHE, imgs=imgs, depths=depths, gt=gt)
    return imgs, depths, gt


def main():
    devs = require_gpu()  # exits non-zero without a GPU: no CPU timings
    print("[bench] device " + json.dumps({
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs), "nvidia_smi": read_smi()}), file=sys.stderr)
    enable_compile_cache()
    from orb_slam2_refactored_tpu.io.evaluation import ate_rmse, rpe
    from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig

    t0 = time.time()
    imgs, depths, gt = get_frames()
    print(f"[bench] frames ready in {time.time()-t0:.1f}s", file=sys.stderr)

    cfg = TrackerConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0,
        bf=0.08 * 520.0, n_features=1000, n_levels=8, pipelined=True,
        pipeline_depth=int(os.environ.get("BENCH_PIPE", "6")),
                           # in-flight frames; 8 lags the keyframe decision
                           # too far (not retuned for the H100)
        map_capacity=MapCapacity(max_keyframes=128, max_points=32768,
                                 max_features=1000),
        image_encoding=os.environ.get("BENCH_IMG_ENC", "raw"),
                            # image wire format. The fixed-rate 8x8-DCT
                            # option (ops/codec.py: 307 -> 77 KB) is NOT
                            # the scored default: ATE on this workload rises
                            # 1.94 -> 2.4-3.2 cm and one run crossed the
                            # 3 cm hard gate. (log8 depth survives the same
                            # gate with margin; the image is where the
                            # geometry lives.)
        depth_subsample=int(os.environ.get("BENCH_DEPTH_SUB", "8")),
        depth_encoding=os.environ.get("BENCH_DEPTH_ENC", "log8"),
                            # depth wire format: 8x8-subsampled log8 depth
                            # (1 byte/px; sampled at keypoints, outliers
                            # chi2-gated in tracking) = 4.8 KB/frame next
                            # to the 307 KB 8-bit gray image. Against
                            # sub=2 it gave better accuracy on this
                            # workload (ATE 1.94 vs 2.28 cm, RPE 0.86 vs
                            # 0.93 cm); the 3 cm ATE gate below HARD-fails
                            # the score if a depth format drifts.
    )
    tracker = Tracker(cfg)

    # ---- warmup: one FULL orbit ----
    # Compiles the per-frame programs, trains the vocabulary (the analog of
    # the reference loading ORBvoc.txt, ~10s, src/System.cc:343), and —
    # because the orbit CLOSES inside warmup — the loop-closure, essential-
    # graph and GBA-merge programs too. Then no-op-compile every
    # padding-bucket variant of the keyframe-stage programs.
    import jax.numpy as jnp

    PAIR_ENV = os.environ.get("BENCH_PAIR")  # "1"/"2"/"4" force a step
    # fusion granularity; unset = probe per window. Fused 2-frame stepping
    # (`Tracker._step2_impl`) makes one dispatch + one stacked pack fetch
    # per TWO frames; transfer sizes are unchanged.

    def ingest(lo, hi, ts_base, batch=1, mode=1):
        """Uploads always stream from the prefetch pool (off the dispatch
        thread); `batch` frames ride each transfer (picked per window, see
        probe_batch). Step dispatch granularity is `mode` frames per
        dispatch (1 = per-frame, 2 = fused pair, 4 = chained quad)."""
        if batch <= 1:
            futs = tracker.prefetch_rgbd(imgs[lo:hi], depths[lo:hi])
            j = 0
            n = hi - lo
            while j < n:
                rem = n - j
                if mode >= 4 and rem >= 4:
                    tracker.track_rgbd_chain_uploaded(
                        [futs[j + i].result() for i in range(4)],
                        [(ts_base + lo + j + i) / 30.0 for i in range(4)],
                    )
                    j += 4
                elif mode >= 2 and rem >= 2:
                    tracker.track_rgbd_pair_uploaded(
                        futs[j].result(), futs[j + 1].result(),
                        (ts_base + lo + j) / 30.0,
                        (ts_base + lo + j + 1) / 30.0,
                    )
                    j += 2
                else:
                    tracker.track_rgbd_uploaded(
                        futs[j].result(),
                        timestamp=(ts_base + lo + j) / 30.0)
                    j += 1
            return
        futs = tracker.prefetch_rgbd_batches(imgs[lo:hi], depths[lo:hi],
                                             batch)
        idx = lo
        for f in futs:
            k = min(batch, hi - idx)
            tracker.track_rgbd_batch(
                None, None,
                [(ts_base + i) / 30.0 for i in range(idx, idx + k)],
                uploaded=f.result(), mode=mode,
            )
            idx += k

    BATCH_ENV = os.environ.get("BENCH_BATCH")
    # capped at 8: the probe measures upload throughput only, and beyond
    # ~pipeline depth the real loop waits on transfers the probe cannot see
    PROBE_CANDS = (1, 2, 4, 8)
    _force_progs = {}

    def _force(h):
        """Force a transfer's real arrival with a tiny dependent fetch,
        jitted per shape."""
        if h.shape not in _force_progs:
            _force_progs[h.shape] = jax.jit(lambda a: a.reshape(-1)[:1])
        np.asarray(_force_progs[h.shape](h))

    _probe_buf = [None]

    def _probe_rest():
        return (tracker.last_frame, tracker.last_mp_dev, tracker.map,
                tracker.pose_dev, tracker.velocity_dev,
                jnp.int32(max(tracker.ref_kf, 0)),
                tracker.mp_vis_dev, tracker.mp_found_dev,
                tracker.local_mask_dev, tracker.mp_seen_dev,
                tracker.fidx_dev)

    def probe_batch(reps_frames=8, pair=False):
        """Time the per-frame ingest cost at each batch granularity (real
        pack+upload path, forced completion) and return the fastest. The
        probe keeps step dispatch+fetch work of the ALREADY-CHOSEN step
        mode (`pair`) running while timing, so the (batch, pair)
        combination is measured jointly. Runs OUTSIDE the timed window;
        tracker state is untouched (programs are functional)."""
        if BATCH_ENV is not None:
            return int(BATCH_ENV), 0.0
        buf = tracker._pack_rgbd(imgs[0], depths[0])
        if _probe_buf[0] is None:
            _probe_buf[0] = jnp.asarray(buf)
        sbuf = _probe_buf[0]
        rest = _probe_rest()
        pool = tracker._fetch_pool
        depth = max(int(cfg.pipeline_depth), 1)
        best_k, best_t = 1, np.inf
        for k in PROBE_CANDS:
            payload = (np.ascontiguousarray(np.repeat(buf[None], k, 0))
                       if k > 1 else buf)
            n_tx = max(reps_frames // k, 2)
            pend = []
            t0 = time.perf_counter()
            handles = []
            for _ in range(n_tx):
                handles.append(jnp.asarray(payload))
                # one step's worth of dispatch+readback per ingested frame,
                # in the mode the window will actually run
                n_steps = (k + 1) // 2 if pair else k
                for _ in range(n_steps):
                    if pair:
                        out = tracker._step2_packed(sbuf, sbuf, *rest)
                        h = out[8]
                    else:
                        out = tracker._step_packed(sbuf, *rest)
                        h = out[4]
                    h.copy_to_host_async()
                    pend.append(pool.submit(np.asarray, h))
                    while len(pend) > depth:
                        pend.pop(0).result()
            for h in handles:
                _force(h)
            for f in pend:
                f.result()
            per_frame = (time.perf_counter() - t0) / (n_tx * k)
            if per_frame < best_t:
                best_t, best_k = per_frame, k
        return best_k, best_t

    def probe_step_mode(frames_per_rep=24, reps=2):
        """Time the per-frame cost of the PIPELINED step dispatch+fetch
        loop at each fusion granularity (per-frame / fused pair / chained
        quad) and return the fastest mode (1, 2 or 4). Replays the real
        dispatch pattern — async dispatch, worker-pool pack fetch, depth-6
        in-flight window — against the current tracker state WITHOUT
        keyframe events. Modes alternate per rep. Outside the timed window;
        state is untouched (programs are functional)."""
        if PAIR_ENV is not None:
            return int(PAIR_ENV) if PAIR_ENV.isdigit() else 1
        if _probe_buf[0] is None:
            _probe_buf[0] = jnp.asarray(
                tracker._pack_rgbd(imgs[0], depths[0]))
        buf = _probe_buf[0]
        rest = _probe_rest()
        pool = tracker._fetch_pool
        depth = max(int(cfg.pipeline_depth), 1)

        def run(mode):
            pend = []
            t0 = time.perf_counter()
            n = frames_per_rep
            i = 0
            while i < n:
                if mode >= 4:
                    out = tracker._stepk_packed((buf, buf, buf, buf), *rest)
                    h = out[1]
                    i += 4
                elif mode == 2:
                    out = tracker._step2_packed(buf, buf, *rest)
                    h = out[8]
                    i += 2
                else:
                    out = tracker._step_packed(buf, *rest)
                    h = out[4]
                    i += 1
                h.copy_to_host_async()
                pend.append(pool.submit(np.asarray, h))
                while len(pend) > depth:
                    pend.pop(0).result()
            for f in pend:
                f.result()
            tracker.sync_device()
            return (time.perf_counter() - t0) / n

        best = {1: np.inf, 2: np.inf, 4: np.inf}
        for _ in range(reps):
            for mode in (1, 2, 4):
                best[mode] = min(best[mode], run(mode))
        return min(best, key=best.get)

    t0 = time.time()
    ingest(0, N_FRAMES, 0)
    tracker.flush()
    if tracker.loop_closer is not None:
        # compile the periodic idf refit (fires every 8 indexed keyframes)
        tracker.loop_closer.db.refit_idf()
    tracker.warm_stage_programs()
    # compile every batch-granularity variant the adaptive ingest may pick
    # (each [k,B] batch shape is its own fused-step program), plus the
    # probe's own force programs. Also cover the partial-tail shapes the
    # windows produce ((N-WARMUP) % k).
    tail_shapes = {(N_FRAMES - WARMUP) % k for k in PROBE_CANDS}
    for k in sorted(set(PROBE_CANDS) | tail_shapes - {0, 1}):
        if k > 1:
            ingest(0, k, 0, batch=k)
            ingest(0, k, 0, batch=k, mode=2)  # _step2_from_batch[k,B]
            if k >= 4:
                ingest(0, k, 0, batch=k, mode=4)  # _step4_from_batch[k,B]
    ingest(0, 4, 0, mode=2)  # _step2_packed (batch=1 pair variant)
    ingest(0, 8, 0, mode=4)  # _stepk_packed (chained quad)
    tracker.flush()
    probe_batch(reps_frames=PROBE_CANDS[-1])
    probe_step_mode(frames_per_rep=8, reps=1)  # probe-path warm
    print(f"[bench] warmup (full orbit, {N_FRAMES} frames + bucket "
          f"precompile) {time.time()-t0:.1f}s", file=sys.stderr)

    # ---- measured windows ----
    # One unscored settle window, then N_WINDOWS IDENTICAL windows (fresh
    # map, re-warmed prefix, probes, measured remainder); the MEDIAN is the
    # reported number and the spread goes to stderr.
    N_WINDOWS = int(os.environ.get("BENCH_WINDOWS", "7"))
    tracker.timer.reset()
    window_fps = []
    window_ate = []
    rmse = None
    rpe_t = None
    batches = []
    pair_modes = []
    for w in range(N_WINDOWS + 1):  # +1: window 0 is an unscored settle
        # pass (residual warmup traffic — probe-handle GC, first
        # post-reset allocations — systematically depresses the first
        # window by ~30%; it is warmup, so it is not scored)
        tracker.reset_map()
        tracker.timer.paused = True  # re-warm is not steady state
        ingest(0, WARMUP, (w + 1) * N_FRAMES)
        tracker.timer.paused = False
        tracker.sync_device()  # re-warm/GBA work must not leak into the window
        pk = probe_step_mode()  # step mode, probed outside the window
        # granularity probed UNDER the chosen step mode's dispatch work
        bk, bt = probe_batch(pair=pk >= 2)
        t0 = time.time()
        ingest(WARMUP, N_FRAMES, (w + 1) * N_FRAMES, batch=bk, mode=pk)
        tracker.flush()
        dt = time.time() - t0
        if w == 0:
            print(f"[bench] settle window: "
                  f"{(N_FRAMES - WARMUP) / dt:.1f} fps (unscored)",
                  file=sys.stderr)
            tracker.timer.reset()
            continue
        batches.append(bk)
        pair_modes.append(int(pk))
        window_fps.append((N_FRAMES - WARMUP) / dt)
        # accuracy measured on EVERY window (re-warm + measured frames
        # align 1:1 with gt over the whole orbit); the gate below uses the
        # MEDIAN window ATE — one unlucky pipelined-timing window must not
        # zero the score any more than one lucky one should pass it
        est = np.stack(tracker.trajectory[-N_FRAMES:])
        r_w, _ = ate_rmse(est, gt[:N_FRAMES], align="se3")
        window_ate.append(r_w)
        if w == 1:
            rpe_t, rpe_r = rpe(est, gt[:N_FRAMES])
    fps = float(np.median(window_fps))
    rmse = float(np.median(window_ate))
    n_kf = len(tracker.graph.alive_kfs())
    n_loops = (tracker.loop_closer.loops_closed
               if tracker.loop_closer is not None else 0)
    print(f"[bench] loops closed in scored windows: {n_loops} (loop "
          f"closing off in the scored run — see module docstring; the "
          f"orbvoc probe below runs it live)", file=sys.stderr)
    print(
        f"[bench] {fps:.1f} fps (windows: "
        f"{', '.join(f'{f:.1f}' for f in window_fps)}; "
        f"probe-chosen batch/window: {batches}, "
        f"step-mode/window: {pair_modes}), "
        f"ATE median {rmse*100:.2f} cm (windows: "
        f"{', '.join(f'{a*100:.2f}' for a in window_ate)}), "
        f"RPE {rpe_t*100:.2f} cm/frame, "
        f"{n_kf} keyframes, state={tracker.state}",
        file=sys.stderr,
    )
    gate_ok = rmse <= ATE_GATE_M
    if not gate_ok:
        print(f"[bench] FAIL: ATE {rmse:.3f} m exceeds the {ATE_GATE_M} m "
              f"gate — scoring vs_baseline as 0", file=sys.stderr)

    # ---- per-stage device-time breakdown ----
    # Each stage is timed over REPS back-to-back dispatches with one tiny
    # forced fetch; the round trip of a trivial program (measured
    # separately) is subtracted.
    import jax.numpy as jnp

    def _rt():
        import jax as _jax
        f = _jax.jit(lambda a: a + 1)
        x = jnp.zeros((1,), np.float32)
        for _ in range(3):
            np.asarray(f(x))
        t = time.perf_counter()
        for _ in range(10):
            np.asarray(f(x))
        return (time.perf_counter() - t) / 10

    def _stage(fn, *args, reps=10, rt=0.0):
        out = fn(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
        t = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
        return (time.perf_counter() - t - rt) / reps

    try:
        rt = _rt()
        buf_j = jnp.asarray(tracker._pack_rgbd(imgs[-1], depths[-1]))
        args = (buf_j, tracker.last_frame, tracker.last_mp_dev,
                tracker.map, tracker.pose_dev, tracker.velocity_dev,
                jnp.int32(max(tracker.ref_kf, 0)),
                tracker.mp_vis_dev, tracker.mp_found_dev,
                tracker.local_mask_dev, tracker.mp_seen_dev,
                tracker.fidx_dev)
        t_step = _stage(tracker._step_packed, *args, rt=rt)
        t_prep = _stage(tracker._prepare_packed, buf_j, rt=rt)
        print(f"[bench] device: step {t_step*1e3:.1f} ms "
              f"(extract {t_prep*1e3:.1f} ms), trivial-program round trip "
              f"{rt*1e3:.1f} ms -> device-bound ~{1.0/t_step:.0f} fps vs "
              f"end-to-end {fps:.1f} fps", file=sys.stderr)
        print(f"[bench] keyframe-stage wall times (measured windows only):\n"
              f"{tracker.timer.report()}", file=sys.stderr)
    except Exception as e:  # breakdown must never break the metric line
        print(f"[bench] breakdown failed: {e}", file=sys.stderr)

    # ---- ORBvoc-regime probe: per-KF place-recognition cost at the
    # reference's ~1M-word vocabulary scale, with loop closing live under
    # the injected vocab ----
    if os.environ.get("BENCH_ORBVOC", "1") not in ("0", ""):
        try:
            run_orbvoc_probe(imgs, depths, cfg)
        except Exception as e:
            import traceback
            traceback.print_exc(file=sys.stderr)
            print(f"[bench] orbvoc probe failed: {e}", file=sys.stderr)

    # ---- mono probe (compact, informational): the third modality's
    # throughput (uint8 uploads via the worker pool) ----
    if os.environ.get("BENCH_MONO", "1") not in ("0", ""):
        try:
            run_mono_probe(imgs, gt)
        except Exception as e:
            import traceback
            traceback.print_exc(file=sys.stderr)
            print(f"[bench] mono probe failed: {e}", file=sys.stderr)

    # ---- stereo segment: second scored metric ----
    # The reference's flagship modality is stereo KITTI
    # (`Examples/Stereo/stereo_kitti.cc`); this measures the packed-wire
    # stereo path (one uint8 upload per pair, pipelined + pair-fusable
    # stepping) on the same orbit. Its JSON line prints BEFORE the primary
    # rgbd line; failures here never break the primary metric.
    if os.environ.get("BENCH_STEREO", "1") not in ("0", ""):
        try:
            run_stereo_bench(gt)
        except Exception as e:
            import traceback
            traceback.print_exc(file=sys.stderr)
            print(f"[bench] stereo segment failed: {e}", file=sys.stderr)

    print(json.dumps({
        "metric": "rgbd_tracking_fps_vga",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3) if gate_ok else 0.0,
    }))


def _orbvoc_vocab(imgs, n_words_big):
    """Build (and cache) an ORBvoc-scale vocabulary: 4096 words TRAINED on
    this scene's descriptors (so BoW overlap behaves like a real trained
    vocab) padded to `n_words_big` with random far codes (so quantize/score
    pay the FULL W cost — cost depends on W, not code content). The
    reference always runs at this scale (`build.sh:22-24` ORBvoc.txt)."""
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.slam.vocabulary import (
        Vocabulary, train_vocabulary,
    )

    cache = os.path.join(os.path.dirname(CACHE),
                         f"orbvoc_{n_words_big}_circuit.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return Vocabulary(words=jnp.asarray(z["words"]),
                          idf=jnp.asarray(z["idf"]))
    from orb_slam2_refactored_tpu.ops.orb import OrbExtractor

    ex = OrbExtractor(480, 640, n_features=1000, n_levels=8)
    descs = []
    for i in range(0, len(imgs), max(len(imgs) // 8, 1)):
        f = ex(np.asarray(imgs[i]))
        d = np.asarray(f.desc)[np.asarray(f.valid)]
        descs.append(d)
    desc = np.concatenate(descs)
    voc = train_vocabulary(desc, n_words=min(4096, n_words_big), iters=6)
    rng = np.random.default_rng(0)
    n_pad = max(n_words_big - voc.n_words, 0)
    pad = rng.integers(0, 2 ** 32, (n_pad, 8), dtype=np.uint32)
    words = np.concatenate([np.asarray(voc.words), pad])[:n_words_big]
    idf = np.ones((n_words_big,), np.float32)
    np.savez(cache, words=words, idf=idf)
    return Vocabulary(words=jnp.asarray(words), idf=jnp.asarray(idf))


def _circuit_frames():
    """A VGA panning circuit (full 2*pi yaw sweep with a revisit overlap) —
    the workload whose revisit is GRAPH-DISTANT, so loop closing must
    actually fire. The bench's orbit cannot serve here: its views all
    co-observe (one covisible blob, nothing to close — measured 0 loops
    under both the live and the 1M vocabulary, correctly)."""
    cache = os.path.join(os.path.dirname(CACHE), "vga_circuit_170.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return z["imgs"], z["depths"]
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.geometry import se3
    from orb_slam2_refactored_tpu.io.synthetic import (
        SyntheticScene, box_room,
    )

    planes = box_room(half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0,
                      distinct_textures=True)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=planes)
    n, overlap, radius = 170, 30, 0.7
    n_loop = n - overlap
    imgs = np.zeros((n, 480, 640), np.uint8)
    depths = np.zeros((n, 480, 640), np.float16)
    rng = np.random.default_rng(23)
    for i in range(n):
        a = 2.0 * np.pi * i / n_loop
        q = np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0], np.float32)
        pose_wc = np.concatenate([q, np.array(
            [radius * np.sin(a), 0.0, radius * (1 - np.cos(a)) * 0.5],
            np.float32)])
        pose = np.asarray(se3.inverse(jnp.asarray(pose_wc)))
        img, depth = scene.render(pose)
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        depths[i] = (depth * (1 + rng.normal(0, 0.01, depth.shape))
                     ).astype(np.float16)
    np.savez_compressed(cache, imgs=imgs, depths=depths)
    return imgs, depths


def run_orbvoc_probe(imgs, depths, cfg):
    """Panning-circuit run with a 1M-word injected vocabulary: prove loop
    closing fires at ORBvoc scale and state the per-KF quantize+BoW /
    KFDB-scoring cost on the device."""
    import dataclasses

    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.slam.tracking import Tracker

    W_BIG = int(os.environ.get("BENCH_ORBVOC_WORDS", "1000000"))
    t0 = time.time()
    cimgs, cdepths = _circuit_frames()
    voc = _orbvoc_vocab(cimgs, W_BIG)  # trained on the circuit's views
    # windowed local-map matching (the reference's LocalMap semantics): the
    # whole-map matcher would silently re-acquire first-lap landmarks and
    # mask the drift the loop stage exists to fix (same rationale as
    # tests/test_organic_loop.py)
    cfg = dataclasses.replace(cfg, local_map_window=10, kf_max_interval=8,
                              enable_loop_closing=True)
    tracker = Tracker(cfg)
    tracker.set_vocabulary(voc)
    futs = tracker.prefetch_rgbd(cimgs, cdepths)
    for j, f in enumerate(futs):
        tracker.track_rgbd_uploaded(f.result(), timestamp=j / 30.0)
    tracker.flush()
    if tracker.loop_closer is None:
        print("[bench] orbvoc probe: no keyframes indexed", file=sys.stderr)
        return
    loops = tracker.loop_closer.loops_closed
    db = tracker.loop_closer.db
    desc = tracker.map.kf_desc[0]
    val = tracker.map.kf_feat_valid[0]

    def timeit(fn, reps=10):
        out = fn()
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
        tt = time.perf_counter()
        for _ in range(reps):
            out = fn()
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
        return (time.perf_counter() - tt) / reps

    t_bow = timeit(lambda: db._count(desc, val))
    (ids, cnt), _ = db.compute_bow(desc, val)
    t_score = timeit(lambda: db._scores2(db.bow_ids, db.bow_cnt, ids, cnt,
                                         db.idf))
    print(f"[bench] orbvoc regime (W={W_BIG}): quantize+BoW "
          f"{t_bow*1e3:.1f} ms/KF, KFDB score-all {t_score*1e3:.2f} ms, "
          f"loops closed {loops}, "
          f"{len(tracker.graph.alive_kfs())} keyframes "
          f"(probe total {time.time()-t0:.0f}s)", file=sys.stderr)
    if loops < 1:
        print("[bench] orbvoc WARNING: no loop closed under the 1M-word "
              "vocabulary", file=sys.stderr)


def run_mono_probe(imgs, gt):
    """Monocular throughput on the same orbit: warmup lap (compiles the
    mono programs; monocular init consumes the early parallax), then ONE
    measured lap with worker-pool uint8 uploads. Informational — mono
    shares the RGB-D step structure so its device cost is the same story;
    this proves the upload + pipeline work end-to-end on the device and states
    the number (sim3 ATE sanity-gated: monocular scale is unobservable)."""
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
    from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig

    t0 = time.time()
    cfg = TrackerConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0,
        bf=0.0, n_features=1000, n_levels=8, pipelined=True,
        pipeline_depth=int(os.environ.get("BENCH_PIPE", "6")),
        kf_ref_ratio=0.9,
        map_capacity=MapCapacity(max_keyframes=128, max_points=32768,
                                 max_features=1000),
    )
    tracker = Tracker(cfg)

    def lap(ts_base):
        futs = tracker.prefetch_mono(imgs)
        for j, f in enumerate(futs):
            tracker.track_mono_uploaded(f.result(),
                                        timestamp=(ts_base + j) / 30.0)
        tracker.flush()

    lap(0)  # warmup: compiles + initializes
    print(f"[bench] mono warmup (full orbit) {time.time()-t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    lap(N_FRAMES)
    dt = time.time() - t0
    n = len(tracker.trajectory)
    est = np.stack(tracker.trajectory[-N_FRAMES:])
    m = min(len(est), N_FRAMES)
    rmse, _ = ate_rmse(est[:m], gt[:m], align="sim3")
    # sanity bar 0.35 m sim3: monocular scale drifts over a 200-frame
    # loop-free run (the tracker-level mono circuit tests gate at the same
    # regime); the depth-aided 3 cm bar does not apply without metric depth
    ok = tracker.state == 1 and rmse < 0.35
    print(f"[bench] mono: {N_FRAMES/dt:.1f} fps (one measured lap), "
          f"ATE(sim3) {rmse*100:.1f} cm "
          f"{'(mono-drift regime, sane)' if ok else '(DEGRADED)'}, "
          f"{len(tracker.graph.alive_kfs())} keyframes, "
          f"state={tracker.state}", file=sys.stderr)


def get_stereo_frames(gt):
    """Rectified L/R pairs over the same orbit (cached)."""
    from orb_slam2_refactored_tpu.io.synthetic import (
        SyntheticScene, box_room,
    )

    cache = os.path.join(os.path.dirname(CACHE),
                         f"vga_stereo_{N_FRAMES}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return z["left"], z["right"]
    planes = box_room(half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=planes, baseline=0.08)
    left = np.zeros((N_FRAMES, 480, 640), np.uint8)
    right = np.zeros((N_FRAMES, 480, 640), np.uint8)
    for i in range(N_FRAMES):
        l, r, _ = scene.render_stereo(gt[i])
        left[i] = np.clip(l, 0, 255).astype(np.uint8)
        right[i] = np.clip(r, 0, 255).astype(np.uint8)
    np.savez_compressed(cache, left=left, right=right)
    return left, right


def run_stereo_bench(gt):
    """Measure stereo tracking fps on the packed wire path; prints ONE
    JSON line (stereo_tracking_fps_vga) with its own 3 cm ATE hard gate."""
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.io.evaluation import ate_rmse, rpe
    from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig

    t0 = time.time()
    left, right = get_stereo_frames(gt)
    print(f"[bench] stereo frames ready in {time.time()-t0:.1f}s",
          file=sys.stderr)
    cfg = TrackerConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0,
        bf=0.08 * 520.0, n_features=1000, n_levels=8, pipelined=True,
        # depth 3, not the RGB-D 6: a 6-frame keyframe lag cost accuracy
        # on the scored orbit (ATE 2.7-2.9 cm at depth 6 vs 2.1 cm at
        # depth 3 — too thin against the hard 3 cm gate)
        pipeline_depth=int(os.environ.get("BENCH_STEREO_PIPE", "3")),
        map_capacity=MapCapacity(max_keyframes=128, max_points=32768,
                                 max_features=1000),
    )
    tracker = Tracker(cfg)
    PAIR_ENV = os.environ.get("BENCH_STEREO_PAIR")

    def ingest(lo, hi, ts_base, mode=1):
        futs = tracker.prefetch_stereo(left[lo:hi], right[lo:hi])
        j = 0
        n = hi - lo
        while j < n:
            rem = n - j
            if mode >= 4 and rem >= 4:
                tracker.track_stereo_chain_uploaded(
                    [futs[j + i].result() for i in range(4)],
                    [(ts_base + lo + j + i) / 30.0 for i in range(4)],
                )
                j += 4
            elif mode >= 2 and rem >= 2:
                tracker.track_stereo_pair_uploaded(
                    futs[j].result(), futs[j + 1].result(),
                    (ts_base + lo + j) / 30.0,
                    (ts_base + lo + j + 1) / 30.0,
                )
                j += 2
            else:
                tracker.track_stereo_uploaded(
                    futs[j].result(), timestamp=(ts_base + lo + j) / 30.0)
                j += 1

    def probe_pair(frames_per_rep=16, reps=2):
        """Step-fusion probe (1 / 2 / 4 frames per dispatch — the stereo
        mirror of the rgbd probe_step_mode; state untouched)."""
        if PAIR_ENV is not None:
            return int(PAIR_ENV) if PAIR_ENV.isdigit() else 1
        buf = getattr(tracker, "_probe_sbuf", None)
        if buf is None:
            buf = tracker._probe_sbuf = jnp.asarray(
                tracker._pack_stereo(left[0], right[0]))
        rest = (tracker.last_frame, tracker.last_mp_dev, tracker.map,
                tracker.pose_dev, tracker.velocity_dev,
                jnp.int32(max(tracker.ref_kf, 0)),
                tracker.mp_vis_dev, tracker.mp_found_dev,
                tracker.local_mask_dev, tracker.mp_seen_dev,
                tracker.fidx_dev)
        pool = tracker._fetch_pool
        depth = max(int(cfg.pipeline_depth), 1)

        def run(mode):
            pend = []
            t0 = time.perf_counter()
            i = 0
            while i < frames_per_rep:
                if mode >= 4:
                    out = tracker._stepk_stereo_packed(
                        (buf, buf, buf, buf), *rest)
                    h = out[1]
                    i += 4
                elif mode == 2:
                    out = tracker._step2_stereo_packed(buf, buf, *rest)
                    h = out[8]
                    i += 2
                else:
                    out = tracker._step_stereo_packed(buf, *rest)
                    h = out[4]
                    i += 1
                h.copy_to_host_async()
                pend.append(pool.submit(np.asarray, h))
                while len(pend) > depth:
                    pend.pop(0).result()
            for f in pend:
                f.result()
            tracker.sync_device()
            return (time.perf_counter() - t0) / frames_per_rep

        best = {1: np.inf, 2: np.inf, 4: np.inf}
        for _ in range(reps):
            for mode in (1, 2, 4):
                best[mode] = min(best[mode], run(mode))
        return min(best, key=best.get)

    # warmup: one full orbit (compiles per-frame + pair + KF/loop programs)
    t0 = time.time()
    ingest(0, N_FRAMES, 0, mode=1)
    ingest(0, 4, 0, mode=2)
    ingest(0, 8, 0, mode=4)
    tracker.flush()
    if tracker.loop_closer is not None:
        tracker.loop_closer.db.refit_idf()
    tracker.warm_stage_programs()
    probe_pair(frames_per_rep=8, reps=1)
    print(f"[bench] stereo warmup (full orbit) {time.time()-t0:.1f}s",
          file=sys.stderr)

    # 3 windows (median): bounds the whole bench (main + orbvoc + mono +
    # stereo) to ~20 min with warm caches
    n_windows = int(os.environ.get("BENCH_STEREO_WINDOWS", "3"))
    tracker.timer.reset()
    window_fps = []
    window_ate = []
    rmse = None
    rpe_t = None
    pair_modes = []
    for w in range(n_windows + 1):  # window 0 = unscored settle
        tracker.reset_map()
        tracker.timer.paused = True
        ingest(0, WARMUP, (w + 1) * N_FRAMES, mode=1)
        tracker.timer.paused = False
        tracker.sync_device()
        pk = probe_pair()
        t0 = time.time()
        ingest(WARMUP, N_FRAMES, (w + 1) * N_FRAMES, mode=pk)
        tracker.flush()
        dt = time.time() - t0
        if w == 0:
            print(f"[bench] stereo settle window: "
                  f"{(N_FRAMES - WARMUP) / dt:.1f} fps (unscored)",
                  file=sys.stderr)
            tracker.timer.reset()
            continue
        pair_modes.append(int(pk))
        window_fps.append((N_FRAMES - WARMUP) / dt)
        est = np.stack(tracker.trajectory[-N_FRAMES:])
        r_w, _ = ate_rmse(est, gt[:N_FRAMES], align="se3")
        window_ate.append(r_w)
        if w == 1:
            rpe_t, _ = rpe(est, gt[:N_FRAMES])
    if not window_fps:  # BENCH_STEREO_WINDOWS=0: settle-only, nothing to score
        print("[bench] stereo: no measured windows", file=sys.stderr)
        return
    fps = float(np.median(window_fps))
    rmse = float(np.median(window_ate))
    print(
        f"[bench] stereo: {fps:.1f} fps (windows: "
        f"{', '.join(f'{f:.1f}' for f in window_fps)}; "
        f"step-mode/window: {pair_modes}), ATE median {rmse*100:.2f} cm "
        f"(windows: {', '.join(f'{a*100:.2f}' for a in window_ate)}), "
        f"RPE {(rpe_t or 0)*100:.2f} cm/frame, "
        f"{len(tracker.graph.alive_kfs())} keyframes",
        file=sys.stderr,
    )
    # device step time for the published split
    try:
        buf = jnp.asarray(tracker._pack_stereo(left[-1], right[-1]))
        args = (buf, tracker.last_frame, tracker.last_mp_dev, tracker.map,
                tracker.pose_dev, tracker.velocity_dev,
                jnp.int32(max(tracker.ref_kf, 0)), tracker.mp_vis_dev,
                tracker.mp_found_dev, tracker.local_mask_dev,
                tracker.mp_seen_dev, tracker.fidx_dev)
        out = tracker._step_stereo_packed(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
        t0 = time.perf_counter()
        for _ in range(10):
            out = tracker._step_stereo_packed(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
        t_step = (time.perf_counter() - t0) / 10
        print(f"[bench] stereo device: step {t_step*1e3:.1f} ms -> "
              f"device-bound ~{1.0/t_step:.0f} fps vs end-to-end "
              f"{fps:.1f} fps", file=sys.stderr)
    except Exception as e:
        print(f"[bench] stereo breakdown failed: {e}", file=sys.stderr)
    gate_ok = rmse <= ATE_GATE_M
    if not gate_ok:
        print(f"[bench] stereo FAIL: ATE {rmse:.3f} m exceeds the "
              f"{ATE_GATE_M} m gate — scoring vs_baseline as 0",
              file=sys.stderr)
    print(json.dumps({
        "metric": "stereo_tracking_fps_vga",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3) if gate_ok else 0.0,
    }))


if __name__ == "__main__":
    main()
