"""KITTI-length endurance: thousands of frames, 1000+ keyframe creations,
keyframe-slot recycling, flat per-frame cost.

The reference tracks KITTI 00 (4541 frames) holding ~1300 keyframes via
unbounded heap growth + redundancy culling (`/root/reference/src/Map.cc:37-68`,
`src/LocalMapping.cc:641-701`). The engine's static SoA arrays get the
same unbounded-sequence behavior from quarantined slot recycling
(map_state.MapGraph.alloc_kf_slot): keyframe CREATIONS exceed the slot
capacity while the alive set stays bounded, and nothing freezes or raises.

Trajectory: a long forward "drive" through a corridor of rooms with gentle
weave — keyframes keep being demanded (interval gate + parallax), old regions
leave the covisibility window, and culling turns over slots.
"""

import os
import time

import numpy as np

from orb_slam2_refactored_tpu.io.synthetic import (
    SyntheticScene, box_room, )
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu.slam.tracking import (
    Tracker, TrackerConfig, TrackState,
)

N_FRAMES = int(os.environ.get("ENDURANCE_FRAMES", "4200"))


def drive_trajectory(n: int, seed: int = 0):
    """Forward drive with lateral weave inside a long corridor (Tcw poses).

    Stays well inside the walls; yaw sweeps keep triangulation parallax up.
    """
    from orb_slam2_refactored_tpu.io.synthetic import (
        _np_pose_inverse,
    )

    poses = []
    for i in range(n):
        t = i / max(n, 1)
        z = 0.02 * i                      # forward along +z
        x = 0.5 * np.sin(2 * np.pi * 6 * t)
        y = 0.15 * np.sin(2 * np.pi * 11 * t)
        yaw = 0.25 * np.sin(2 * np.pi * 6 * t + 1.0)
        q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0], np.float32)
        wc = np.concatenate([q, np.array([x, y, z], np.float32)])
        poses.append(_np_pose_inverse(wc))
    return np.stack(poses)


def corridor_planes(length: float, seed: int = 0):
    """Two side walls + floor + ceiling + periodic cross-slabs for texture
    variety along a corridor of the given length (meters, along +z)."""
    from orb_slam2_refactored_tpu.io.synthetic import Plane

    planes = []
    n = np.array
    # side walls (x = +-1.6), floor/ceiling (y = +-1.1)
    planes.append(Plane(point=n([1.6, 0, 0], np.float32),
                        normal=n([-1, 0, 0], np.float32),
                        axis_u=n([0, 0, 1], np.float32),
                        axis_v=n([0, 1, 0], np.float32), seed=11))
    planes.append(Plane(point=n([-1.6, 0, 0], np.float32),
                        normal=n([1, 0, 0], np.float32),
                        axis_u=n([0, 0, 1], np.float32),
                        axis_v=n([0, 1, 0], np.float32), seed=12))
    planes.append(Plane(point=n([0, 1.1, 0], np.float32),
                        normal=n([0, -1, 0], np.float32),
                        axis_u=n([1, 0, 0], np.float32),
                        axis_v=n([0, 0, 1], np.float32), seed=13))
    planes.append(Plane(point=n([0, -1.1, 0], np.float32),
                        normal=n([0, 1, 0], np.float32),
                        axis_u=n([1, 0, 0], np.float32),
                        axis_v=n([0, 0, 1], np.float32), seed=14))
    # far end wall
    planes.append(Plane(point=n([0, 0, length + 4.0], np.float32),
                        normal=n([0, 0, -1], np.float32),
                        axis_u=n([1, 0, 0], np.float32),
                        axis_v=n([0, 1, 0], np.float32), seed=15))
    return planes


class TestEndurance:
    def test_long_drive_recycles_kf_slots(self):
        n = N_FRAMES
        scene = SyntheticScene(width=200, height=150, fx=170.0, fy=170.0,
                               planes=corridor_planes(0.02 * n))
        gt = drive_trajectory(n)
        cfg = TrackerConfig(
            width=200, height=150, fx=170.0, fy=170.0, cx=100.0, cy=75.0,
            bf=0.08 * 170.0, n_features=300, n_levels=4,
            kf_max_interval=3, kf_min_interval=1,
            local_map_window=20,
            max_new_points_per_kf=100,
            # capacity ~1/4 of expected creations: recycling MUST engage
            map_capacity=MapCapacity(max_keyframes=384, max_points=24576,
                                     max_features=300),
        )
        tracker = Tracker(cfg)
        times = []
        for i in range(n):
            img, depth = scene.render(gt[i])
            t0 = time.perf_counter()
            tracker.track_rgbd(img, depth, timestamp=i / 10.0)
            times.append(time.perf_counter() - t0)
            assert tracker.state == TrackState.OK, (
                i, tracker.track_info[-3:]
            )
        g = tracker.graph
        n_alive = len(g.alive_kfs())
        created = g.num_kfs
        print(f"[endurance] {n} frames: {created} KFs created, "
              f"{n_alive} alive (cap {cfg.map_capacity.max_keyframes}), "
              f"points alive {int(np.asarray(g.pt_alive.sum()))}")
        # ~1 KF per 3 frames is demanded by the interval gate; at the full
        # 4200 frames this asserts 1000+ creations and engaged recycling
        # (ENDURANCE_FRAMES can shrink the run for smoke checks)
        assert created >= min(1000, n // 4), \
            "endurance run must keep creating keyframes"
        if n >= 2000:
            assert created > cfg.map_capacity.max_keyframes, \
                "creations must exceed slot capacity (recycling engaged)"
        assert n_alive <= cfg.map_capacity.max_keyframes

        # per-frame cost flat: last quartile vs second quartile medians
        q = n // 4
        med2 = float(np.median(times[q: 2 * q]))
        med4 = float(np.median(times[3 * q:]))
        print(f"[endurance] median frame time Q2 {med2*1e3:.1f} ms, "
              f"Q4 {med4*1e3:.1f} ms")
        assert med4 < 2.0 * med2, "per-frame cost must stay flat"

        # local drift check on the final stretch (a corridor drive has no
        # loop closures; global ATE grows with path length like any odometry
        # system — the reference behaves the same without loops)
        from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
        est = np.stack(tracker.trajectory)
        tail = slice(n - 600, n)
        rmse_tail, _ = ate_rmse(est[tail], gt[tail], align="se3")
        print(f"[endurance] tail-600 ATE {rmse_tail:.4f} m")
        assert rmse_tail < 0.30
