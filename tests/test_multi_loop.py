"""Multi-loop endurance circuit: TWO successive revisits, each closing its
own loop.

The reference closes loops repeatedly over long sessions — every revisit
adds a loop edge and pulls drift out (`/root/reference/src/LoopClosing.cc`,
detection re-arms after the 10-keyframe cooldown). This drives two full
laps of the box-room circuit AFTER the mapping lap: each lap accumulates
fresh drift and must be reconnected organically (BoW or implicit pathway),
with the corrected trajectory staying tight at the end of BOTH laps.
"""

import numpy as np
import pytest

from test_organic_loop import circuit_trajectory

from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu.io.synthetic import SyntheticScene, box_room
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu.slam.system import corrected_frame_poses
from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig


@pytest.fixture(scope="module")
def two_lap_circuit():
    planes = box_room(half_x=1.7, half_y=1.3, z_far=2.7, z_near=-2.7,
                      distinct_textures=True)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    lap = circuit_trajectory(150, overlap=0)  # one full 2*pi lap, no tail
    gt = np.concatenate([lap, lap, lap[:60]])  # 2.4 laps -> 2 revisits
    rng = np.random.default_rng(31)
    frames = []
    for i in range(len(gt)):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.02, depth.shape).astype(np.float32))
        frames.append((img, depth))
    return frames, gt


class TestMultiLoop:
    def test_two_revisits_two_corrections(self, two_lap_circuit):
        frames, gt = two_lap_circuit
        cfg = TrackerConfig(
            width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
            bf=0.08 * 260.0, n_features=600, n_levels=4,
            enable_loop_closing=True, vocab_words=1024,
            kf_max_interval=8,
            local_map_window=10,
            map_capacity=MapCapacity(max_keyframes=128, max_points=16384,
                                     max_features=600),
        )
        t = Tracker(cfg)
        loops_at = []
        prev = 0
        for i, (img, depth) in enumerate(frames):
            t.track_rgbd(img, depth, timestamp=i / 30.0)
            if t.loop_closer is not None and t.loop_closer.loops_closed > prev:
                prev = t.loop_closer.loops_closed
                loops_at.append(i)
        t.flush()
        assert t.state == 1, t.track_info[-3:]

        n_loops = t.loop_closer.loops_closed
        print(f"[multi-loop] {n_loops} loops closed at frames {loops_at}")
        assert n_loops >= 2, f"both revisits must close ({n_loops} closed)"
        # the two corrections must belong to different revisits, not a
        # burst around one seam (laps are 150 frames apart)
        assert loops_at[-1] - loops_at[0] >= 100, loops_at

        est = corrected_frame_poses(t)
        rmse, _ = ate_rmse(est, gt, align="se3")
        print(f"[multi-loop] corrected ATE {rmse:.4f} m over {len(gt)} frames")
        assert rmse < 0.08, f"multi-loop ATE {rmse:.4f}"
