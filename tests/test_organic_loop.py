"""Organic end-to-end loop closure: a long drifting circuit where detection
fires through the real `LoopCloser.detect()` policy (BoW retrieval +
covisibility consistency), correction runs, and the SAVED corrected
trajectory beats the loop-disabled run.

Nothing is forced: no hand-picked keyframe pair, no injected Sim3.
"""

import numpy as np
import pytest

from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu.io.synthetic import (
    SyntheticScene, box_room,
)
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu.slam.system import corrected_frame_poses
from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig


def circuit_trajectory(n, overlap=30, radius=0.7):
    """Full panning circuit: the camera orbits the room center while yawing
    through 2*pi, re-seeing the start views in the last `overlap` frames."""
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.geometry import se3

    poses = []
    n_loop = n - overlap
    for i in range(n):
        a = 2.0 * np.pi * i / n_loop
        cx = radius * np.sin(a)
        cz = radius * (1.0 - np.cos(a)) * 0.5
        yaw = a
        q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0], np.float32)
        pose_wc = np.concatenate([q, np.array([cx, 0.0, cz], np.float32)])
        poses.append(np.asarray(se3.inverse(jnp.asarray(pose_wc))))
    return np.stack(poses)


@pytest.fixture(scope="module")
def circuit():
    planes = box_room(half_x=1.7, half_y=1.3, z_far=2.7, z_near=-2.7,
                      distinct_textures=True)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    n = 170
    gt = circuit_trajectory(n)
    rng = np.random.default_rng(23)
    frames = []
    for i in range(n):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.02, depth.shape).astype(np.float32))
        frames.append((img, depth))
    return frames, gt


def run(frames, loop: bool):
    cfg = TrackerConfig(
        width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
        bf=0.08 * 260.0, n_features=600, n_levels=4,
        enable_loop_closing=loop, vocab_words=1024,
        kf_max_interval=8,
        # covisibility-window local-map matching (the reference's
        # Tracking::LocalMap semantics, src/Tracking.cc:55-185): on the
        # revisit the tracker can only match against the drifted local map,
        # so accumulated drift persists and loop closing must fix it — the
        # whole-map brute-force path would silently re-acquire first-lap
        # landmarks and mask the drift this test is about.
        local_map_window=10,
        map_capacity=MapCapacity(max_keyframes=96, max_points=16384,
                                 max_features=600),
    )
    tracker = Tracker(cfg)
    for i, (img, depth) in enumerate(frames):
        tracker.track_rgbd(img, depth, timestamp=i / 30.0)
    tracker.flush()
    assert tracker.state == 1, tracker.track_info[-3:]
    return tracker


class TestOrganicLoop:
    def test_loop_fires_and_improves_ate(self, circuit):
        frames, gt = circuit
        t_no = run(frames, loop=False)
        t_lo = run(frames, loop=True)

        assert t_lo.loop_closer is not None
        n_loops = t_lo.loop_closer.loops_closed
        print(f"organic loops closed: {n_loops}, "
              f"last info: {t_lo.last_loop_info}")
        assert n_loops >= 1, "loop detection never fired organically"

        # the SAVED corrected trajectories (Tcr composed with current KF
        # poses) are compared — the loop/GBA correction must reach the
        # full-trajectory export, not just the keyframes
        est_no = corrected_frame_poses(t_no)
        est_lo = corrected_frame_poses(t_lo)
        rmse_no, _ = ate_rmse(est_no, gt, align="se3")
        rmse_lo, _ = ate_rmse(est_lo, gt, align="se3")
        print(f"ATE no-loop {rmse_no:.4f} m, with-loop {rmse_lo:.4f} m")
        assert rmse_lo < rmse_no, (
            f"loop closing must improve ATE ({rmse_lo:.4f} vs {rmse_no:.4f})"
        )
        # hard absolute gate (round 5): measured 0.048 m at the map's
        # constraint-structure optimum — re-solving the final merged map
        # with 3x the GBA iterations moves cost 5971 -> 5964 and ATE not at
        # all, so the residual is the single-seam circuit's odometry bend
        # (mid-lap poses are constrained only by odometry + one loop edge),
        # not correction quality. The gate would have caught the r4
        # GBA-merge bug (late keyframes corrected against the LAUNCH pose
        # snapshot instead of the merge-time parent pose -> post-loop chain
        # 0.55 m off, whole-trajectory ATE 0.19 m).
        assert rmse_lo < 0.06, f"with-loop ATE {rmse_lo:.4f} m"
