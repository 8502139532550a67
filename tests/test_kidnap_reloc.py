"""Kidnapped-camera relocalization, end-to-end.

Reference oracle: `Tracking::Relocalization`
(`/root/reference/src/Tracking.cc:1189-1327`) — when tracking is LOST, the
KeyFrameDatabase retrieves candidate keyframes by BoW similarity and PnP
RANSAC + pose optimization re-anchors the camera against the existing map.

Scenario: track half an orbit, then "kidnap" the camera — feed a burst of
featureless frames (blackout, as if the lens was covered during transport),
then resume from a DIFFERENT, already-mapped viewpoint. The tracker must go
LOST during the blackout and relocalize when imagery returns, with the
post-recovery trajectory consistent with ground truth.
"""

import numpy as np
import pytest

from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory,
)
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu.slam.tracking import (
    Tracker, TrackerConfig, TrackState,
)


@pytest.fixture(scope="module")
def kidnap_setup():
    planes = box_room(half_x=1.7, half_y=1.3, z_far=2.7, z_near=-2.7,
                      distinct_textures=True)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(160, radius=0.5, yaw_amp=0.35)
    return scene, gt


def run_kidnap(scene, gt, tracker):
    """Phase 1: frames 0-99 map the orbit. Phase 2: 12 blank frames (LOST).
    Phase 3: resume at frame 30's viewpoint (mapped in phase 1) and continue
    30-70. Returns (blank-phase states, resume-phase states)."""
    rng = np.random.default_rng(5)
    h, w = tracker.cfg.height, tracker.cfg.width
    states = []
    for i in range(100):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape).astype(np.float32))
        tracker.track_rgbd(img, depth, timestamp=i / 30.0)
    blank = np.zeros((h, w), np.float32)
    blank_depth = np.zeros((h, w), np.float32)
    for j in range(12):
        tracker.track_rgbd(blank, blank_depth, timestamp=(100 + j) / 30.0)
        states.append(int(tracker.state))
    resume = []
    for k, i in enumerate(range(30, 70)):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape).astype(np.float32))
        tracker.track_rgbd(img, depth, timestamp=(112 + k) / 30.0)
        resume.append(int(tracker.state))
    return states, resume


class TestKidnapRelocalization:
    def test_rgbd_kidnap_recovers(self, kidnap_setup):
        scene, gt = kidnap_setup
        cfg = TrackerConfig(
            width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
            bf=0.08 * 260.0, n_features=600, n_levels=4,
            enable_loop_closing=False,  # reloc must work without loop closing
            kf_max_interval=8,
            map_capacity=MapCapacity(max_keyframes=64, max_points=16384,
                                     max_features=600),
        )
        t = Tracker(cfg)
        blank_states, resume_states = run_kidnap(scene, gt, t)
        # blackout must lose tracking (auto-reset is gated to maps <= 5 KFs,
        # so the mature map survives — src/Tracking.cc:1317-1325 analog)
        assert TrackState.LOST in blank_states, blank_states
        n_kf = len(t.graph.alive_kfs())
        assert n_kf >= 8, "phase 1 must have built a real map"

        # recovery: relocalization must re-anchor within the resume window
        assert TrackState.OK in resume_states, (
            f"never relocalized; states={resume_states[:10]}..."
        )
        first_ok = resume_states.index(TrackState.OK)
        assert first_ok <= 20, f"relocalization took {first_ok} frames"
        assert resume_states[-1] == TrackState.OK

        # post-recovery poses must be consistent with ground truth: compare
        # the tracked tail (resume frames after recovery) against gt[30:70]
        est_tail = np.stack(t.trajectory[-(40 - first_ok):])
        gt_tail = gt[30 + first_ok: 70]
        rmse, _ = ate_rmse(est_tail, gt_tail, align="se3")
        print(f"[kidnap] reloc after {first_ok} frames, "
              f"post-recovery ATE {rmse:.4f} m over {len(gt_tail)} frames")
        assert rmse < 0.08, f"post-relocalization ATE {rmse:.4f}"
