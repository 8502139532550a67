"""Sharded global BA must agree with the single-device solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam2_refactored_tpu.geometry import se3
from orb_slam2_refactored_tpu.optim.ba import ba_solve
from orb_slam2_refactored_tpu.parallel.sharded_ba import (
    make_mesh,
    pad_problem,
    sharded_ba_solve,
)

from test_ba import build_problem


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multi-device mesh")
class TestShardedBA:
    def test_matches_single_device(self):
        rng = np.random.default_rng(0)
        cam, prob, poses_gt, _ = build_problem(rng, K=8, P=64, N=64)
        mesh = make_mesh()
        res_s = sharded_ba_solve(prob, cam, mesh, iters=8, cg_iters=30)
        res_1 = ba_solve(prob, cam, iters=8, cg_iters=30)
        np.testing.assert_allclose(
            np.asarray(res_s.kf_pose), np.asarray(res_1.kf_pose), atol=1e-3
        )
        np.testing.assert_allclose(
            float(res_s.final_cost), float(res_1.final_cost), rtol=1e-2
        )

    def test_padding_neutral(self):
        rng = np.random.default_rng(1)
        cam, prob, poses_gt, _ = build_problem(rng, K=6, P=64, N=64)  # 6 % 8 != 0
        mesh = make_mesh()
        res_s = sharded_ba_solve(prob, cam, mesh, iters=6, cg_iters=25)
        res_1 = ba_solve(prob, cam, iters=6, cg_iters=25)
        assert res_s.kf_pose.shape[0] == 6
        np.testing.assert_allclose(
            np.asarray(res_s.kf_pose), np.asarray(res_1.kf_pose), atol=1e-3
        )

    def test_converges_on_mesh(self):
        rng = np.random.default_rng(2)
        cam, prob, poses_gt, _ = build_problem(rng, K=8, P=64, N=64, px_noise=0.0)
        mesh = make_mesh()
        res = sharded_ba_solve(prob, cam, mesh, iters=15, cg_iters=40)
        err = np.asarray(se3.boxminus(res.kf_pose, jnp.asarray(poses_gt)))
        assert np.linalg.norm(err, axis=1).max() < 1e-3

    def test_pt_frozen_threads_through_padding(self):
        """pad_problem must carry pt_frozen; frozen landmarks must come back
        untouched from the sharded solve (parity with single-device)."""
        rng = np.random.default_rng(3)
        cam, prob, poses_gt, _ = build_problem(rng, K=6, P=64, N=64)
        frozen = np.zeros(64, bool)
        frozen[::3] = True
        prob = prob._replace(pt_frozen=jnp.asarray(frozen))
        mesh = make_mesh()
        res_s = sharded_ba_solve(prob, cam, mesh, iters=6, cg_iters=25)
        res_1 = ba_solve(prob, cam, iters=6, cg_iters=25)
        np.testing.assert_allclose(
            np.asarray(res_s.kf_pose), np.asarray(res_1.kf_pose), atol=1e-3
        )
        np.testing.assert_array_equal(
            np.asarray(res_s.pt_pos)[frozen], np.asarray(prob.pt_pos)[frozen]
        )


@pytest.mark.skipif(jax.device_count() < 2, reason="needs multi-device mesh")
class TestTrackerDerivedGBA:
    def test_live_map_sharded_matches_single(self):
        """Global BA of a LIVE tracker's map — dead KF slots, culled points,
        real mono+stereo observation rows — sharded over the mesh must match
        the single-device solve. This is the
        distributed form of the loop closer's GBA
        (`/root/reference/src/LoopClosing.cc:349-499`)."""
        from orb_slam2_refactored_tpu.io.synthetic import (
            SyntheticScene, box_room, orbit_trajectory,
        )
        from orb_slam2_refactored_tpu.optim.ba import problem_from_map
        from orb_slam2_refactored_tpu.slam.frame import scale_factors
        from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
        from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig

        planes = box_room(half_x=1.6, half_y=1.3, z_far=2.6, z_near=-2.6)
        scene = SyntheticScene(width=240, height=180, fx=200.0, fy=200.0,
                               planes=planes)
        gt = orbit_trajectory(70, radius=0.45, yaw_amp=0.4)
        cfg = TrackerConfig(
            width=240, height=180, fx=200.0, fy=200.0, cx=120.0, cy=90.0,
            bf=0.08 * 200.0, n_features=400, n_levels=4,
            kf_max_interval=3, kf_min_interval=1,
            map_capacity=MapCapacity(max_keyframes=32, max_points=4096,
                                     max_features=400),
        )
        tracker = Tracker(cfg)
        for i in range(70):
            img, depth = scene.render(gt[i])
            tracker.track_rgbd(img, depth, timestamp=i / 30.0)
        tracker.flush()
        assert tracker.state == 1
        g = tracker.graph
        m = tracker.map
        # the run must have produced dead slots for the test to mean much
        assert len(g.alive_kfs()) >= 5

        K = m.kf_capacity
        free = np.zeros(K, bool)
        free[g.alive_kfs()] = True
        free[g.origin_kf] = False
        _, _, inv_s2 = scale_factors(cfg.n_levels, cfg.scale_factor)
        prob = problem_from_map(m, jnp.asarray(free), inv_s2)

        mesh = make_mesh()
        res_s = sharded_ba_solve(prob, cam=tracker.cam, mesh=mesh,
                                 iters=5, cg_iters=30)
        res_1 = ba_solve(prob, tracker.cam, iters=5, cg_iters=30)
        assert float(res_s.final_cost) <= float(res_s.initial_cost) + 1e-3
        np.testing.assert_allclose(
            float(res_s.final_cost), float(res_1.final_cost), rtol=2e-2
        )
        alive = g.alive_kfs()
        np.testing.assert_allclose(
            np.asarray(res_s.kf_pose)[alive], np.asarray(res_1.kf_pose)[alive],
            atol=2e-3,
        )
