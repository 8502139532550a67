"""Long-sequence map scaling: covisibility-window tracking, bounded per-frame
cost, graceful behavior at capacity.

The reference holds ~1300 KFs over KITTI 00 by keeping tracking cost bounded
by the local covisibility window (`/root/reference/src/Tracking.cc:55-185`)
and culling. Oracle here: a 520-frame run accumulating 200+ keyframes keeps
tracking, keeps per-frame cost flat, and NEVER raises at point-capacity
exhaustion (dead slots recycle; growth stops gracefully).
"""

import time

import numpy as np
import pytest

from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory,
)
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig, TrackState


def wander_trajectory(n, seed=0):
    """Multi-orbit wander covering the room repeatedly (keyframes keep
    being demanded by the interval gate, as on a long exploration)."""
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.geometry import se3

    base = orbit_trajectory(n, radius=0.45, yaw_amp=0.5)
    rng = np.random.default_rng(seed)
    drift = np.cumsum(rng.normal(0, 0.004, (n, 3)), axis=0).astype(np.float32)
    out = base.copy()
    for i in range(n):
        d = np.concatenate([np.array([1, 0, 0, 0], np.float32),
                            0.3 * drift[i]])
        out[i] = np.asarray(se3.compose(jnp.asarray(d), jnp.asarray(base[i])))
    return out


class TestLongRun:
    def test_500_frames_200_kfs_flat_cost(self):
        n = 520
        planes = box_room(half_x=1.6, half_y=1.3, z_far=2.6, z_near=-2.6)
        scene = SyntheticScene(width=240, height=180, fx=200.0, fy=200.0,
                               planes=planes)
        gt = wander_trajectory(n)
        cfg = TrackerConfig(
            width=240, height=180, fx=200.0, fy=200.0, cx=120.0, cy=90.0,
            bf=0.08 * 200.0, n_features=400, n_levels=4,
            kf_max_interval=2, kf_min_interval=1,  # force a dense KF graph
            local_map_window=20,
            max_new_points_per_kf=120,
            map_capacity=MapCapacity(max_keyframes=300, max_points=16384,
                                     max_features=400),
        )
        tracker = Tracker(cfg)
        times = []
        for i in range(n):
            img, depth = scene.render(gt[i])
            t0 = time.perf_counter()
            tracker.track_rgbd(img, depth, timestamp=i / 30.0)
            times.append(time.perf_counter() - t0)
        assert tracker.state == TrackState.OK, tracker.track_info[-3:]
        n_kf = len(tracker.graph.alive_kfs())
        print(f"keyframes alive: {n_kf} (created {tracker.graph.num_kfs}), "
              f"points alive: {tracker.graph.pt_alive.sum()}, "
              f"next_point {tracker.graph.next_point}")
        assert tracker.graph.num_kfs >= 200, "long run must create 200+ KFs"
        est = np.stack(tracker.trajectory)
        rmse, _ = ate_rmse(est, gt, align="se3")
        print(f"ATE over {n} frames: {rmse:.4f} m")
        assert rmse < 0.06

        # flat per-frame cost: the last quartile must not blow up vs the
        # second quartile (first quartile holds compiles)
        q = n // 4
        med2 = float(np.median(times[q: 2 * q]))
        med4 = float(np.median(times[3 * q:]))
        print(f"median frame time Q2 {med2*1e3:.1f} ms vs Q4 {med4*1e3:.1f} ms")
        assert med4 < 2.5 * med2, "per-frame cost must stay flat as the map grows"

    def test_capacity_exhaustion_is_graceful(self):
        """Tiny capacities: the run must complete without RuntimeError, with
        point slots recycling and keyframe growth freezing."""
        n = 90
        planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
        scene = SyntheticScene(width=240, height=180, fx=200.0, fy=200.0,
                               planes=planes)
        gt = wander_trajectory(n, seed=3)
        cfg = TrackerConfig(
            width=240, height=180, fx=200.0, fy=200.0, cx=120.0, cy=90.0,
            bf=0.08 * 200.0, n_features=400, n_levels=4,
            kf_max_interval=2, kf_min_interval=1,
            map_capacity=MapCapacity(max_keyframes=24, max_points=2048,
                                     max_features=400),
        )
        tracker = Tracker(cfg)
        for i in range(n):
            img, depth = scene.render(gt[i])
            tracker.track_rgbd(img, depth, timestamp=i / 30.0)
        # survived: the alive set stays within capacity (culled slots
        # recycle, so total CREATIONS may exceed it — that's the point)
        assert len(tracker.graph.alive_kfs()) <= 24
        assert tracker.graph.next_point <= 2048
        assert tracker.state == TrackState.OK
        assert len(tracker.trajectory) == n
