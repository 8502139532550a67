"""AR demo + live-source driver: analogs of the reference's ROS surface
(`Examples/ROS/ORB_SLAM2/src/{AR/ViewerAR.cc, ros_rgbd.cc}`) — the last
reference components without counterparts here.

- `viz/ar.py`: RANSAC plane detection over well-observed map points, a
  virtual cube anchored to that plane, rendered through the LIVE tracked
  pose — world-locked like the GL version.
- `drivers.py live_rgbd`: consume synchronized rgb/depth pairs as a
  producer drops them into a watched directory (the message-subscription
  contract over filesystem transport).
"""

import os
import threading
import time

import numpy as np
import pytest

from orb_slam2_refactored_tpu.io.synthetic import (
    SyntheticScene, _np_quat_rotate, box_room, orbit_trajectory,
)
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig
from orb_slam2_refactored_tpu.viz.ar import ArOverlay, detect_plane

SETTINGS_YAML = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.fps: 30.0
Camera.bf: 20.8
Camera.RGB: 1
ThDepth: 35.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


class TestDetectPlane:
    def test_recovers_floor_plane(self):
        """Points on y=1.2 plus 20% outliers -> normal ~ +-y, origin on the
        plane (DetectPlane semantics, ViewerAR.cc:392-508)."""
        rng = np.random.default_rng(0)
        on = np.stack([rng.uniform(-2, 2, 200),
                       np.full(200, 1.2) + rng.normal(0, 0.004, 200),
                       rng.uniform(-2, 2, 200)], -1)
        out = rng.uniform(-2, 2, (50, 3))
        pts = np.concatenate([on, out])
        pose_cw = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)  # cam at origin
        pl = detect_plane(pts, pose_cw, iterations=60)
        assert pl is not None
        assert abs(abs(pl.normal[1]) - 1.0) < 0.02, pl.normal
        assert abs(pl.origin[1] - 1.2) < 0.05
        # normal faces the camera (origin is above the floor at y=0 < 1.2)
        assert pl.normal[1] < 0
        # plane frame: y-axis == normal
        np.testing.assert_allclose(pl.R_pw[:, 1], pl.normal, atol=1e-5)
        # reference-faithful tight inlier scale (1.4x the 20th-pct
        # distance, :486-494): a SUBSET of the plane points, refit over it
        assert len(pl.inlier_idx) >= 40
        assert np.all(np.isin(pl.inlier_idx, np.arange(200))), \
            "no outlier may survive the threshold"

    def test_too_few_points(self):
        pose_cw = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
        assert detect_plane(np.zeros((10, 3)), pose_cw) is None


class TestArOverlayE2E:
    def test_cube_world_locked(self):
        """Track a short sequence, insert a cube, render overlays: the
        cube's anchor must reproject where the GROUND-TRUTH pose puts it
        (within tracking error) on every frame — i.e. the virtual object
        is locked to the world, not the screen."""
        planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
        scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                               planes=planes)
        n_total = 40
        n = 32  # map-building prefix; the cube is checked on the remainder
        gt = orbit_trajectory(n_total, radius=0.3, yaw_amp=0.2)
        cfg = TrackerConfig(
            width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
            bf=0.08 * 260.0, n_features=600, n_levels=4,
            enable_loop_closing=False,
            map_capacity=MapCapacity(max_keyframes=32, max_points=8192,
                                     max_features=600),
        )
        tracker = Tracker(cfg)
        imgs = []
        for i in range(n):
            img, depth = scene.render(gt[i])
            imgs.append(img)
            tracker.track_rgbd(img, depth, timestamp=i / 30.0)
        tracker.flush()
        assert tracker.state == 1

        # min_obs=2: the reference's >5-observation gate assumes long maps
        # (ViewerAR.cc:406); a 30-frame bootstrap tops out at 3 obs/point
        ar = ArOverlay(tracker, min_obs=2)
        assert ar.insert_cube(size=0.3), "plane must be found in the room"
        anchor_w = ar.plane.origin

        # continue tracking NEW frames; at each one compare the anchor's
        # projection under the ESTIMATED pose (what render uses) vs the
        # TRUE pose
        errs = []
        for i in range(n, n_total):
            img, depth = scene.render(gt[i])
            imgs.append(img)
            tracker.track_rgbd(img, depth, timestamp=i / 30.0)
            tracker.flush()
            uv_est = ar.project(anchor_w)[0]
            pose = np.asarray(gt[i], np.float64)
            xc = _np_quat_rotate(pose[0:4], anchor_w.astype(np.float64)) \
                + pose[4:7]
            uv_gt = np.array([260.0 * xc[0] / xc[2] + 160.0,
                              260.0 * xc[1] / xc[2] + 120.0])
            errs.append(np.linalg.norm(uv_est - uv_gt))
        assert np.median(errs) < 8.0, f"anchor drift {errs} px"

        out = ar.render(imgs[-1])
        assert out.shape == (240, 320, 3) and out.dtype == np.uint8
        # the cube actually drew something (red channel strokes)
        red = (out[..., 0].astype(int) - out[..., 2].astype(int)) > 100
        assert red.sum() > 50, "cube wireframe missing from the overlay"


class TestLiveRgbdDriver:
    def test_consumes_frames_as_they_arrive(self, tmp_path):
        """A producer thread drops TUM-named rgb/depth pairs while the
        live_rgbd driver runs; the driver must track every pair and save a
        trajectory (ros_rgbd.cc contract over filesystem transport)."""
        import cv2

        from orb_slam2_refactored_tpu.drivers import main as driver_main

        planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
        scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                               planes=planes)
        n = 14
        gt = orbit_trajectory(n, radius=0.25, yaw_amp=0.15)
        watch = str(tmp_path / "live")
        os.makedirs(os.path.join(watch, "rgb"))
        os.makedirs(os.path.join(watch, "depth"))

        def produce():
            for i in range(n):
                ts = 1000.0 + i / 30.0
                img, depth = scene.render(gt[i])
                # write depth first, rgb last: the driver requires both
                cv2.imwrite(os.path.join(watch, "depth", f"{ts:.6f}.png"),
                            np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
                cv2.imwrite(os.path.join(watch, "rgb", f"{ts:.6f}.png"),
                            np.clip(img, 0, 255).astype(np.uint8))
                time.sleep(0.1)

        settings = str(tmp_path / "settings.yaml")
        with open(settings, "w") as f:
            f.write(SETTINGS_YAML)
        out = str(tmp_path / "live_traj.txt")

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        rc = driver_main([
            "live_rgbd", "--settings", settings, "--watch", watch,
            "--out", out, "--idle-timeout", "15", "--max-frames", str(n),
            "--no-loop-closing",
        ])
        producer.join(timeout=10)
        assert rc == 0 and os.path.exists(out)
        with open(out) as f:
            lines = [l for l in f if l.strip()]
        assert len(lines) == n, f"tracked {len(lines)}/{n} live frames"
