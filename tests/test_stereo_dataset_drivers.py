"""End-to-end stereo dataset paths: KITTI-layout and EuRoC-layout exports
-> the REAL `stereo_kitti` / `stereo_euroc` CLI drivers -> trajectory files
-> evaluator. No hand-wiring.

In-container stand-ins for running the reference's
`Examples/Stereo/stereo_kitti` on KITTI 00 and `stereo_euroc` on MH01
(zero egress blocks real data): the on-disk layouts, the CLI entry points,
the LEFT./RIGHT. K,D,R,P rectification fixture
(`/root/reference/Examples/Stereo/stereo_euroc.cc:61-107`), the saver
formats (`src/System.cc:690-843`), and the scoring all match what the real
sequences would exercise.
"""

import os

import numpy as np
import pytest

from orb_slam2_refactored_tpu.io.evaluation import ate_rmse, ate_rmse_assoc
from orb_slam2_refactored_tpu.io.synthetic import (
    SyntheticScene, box_room, euroc_settings_yaml, export_euroc_sequence,
    export_kitti_sequence, make_euroc_rig, orbit_trajectory,
)

N_FRAMES = 40

KITTI_SETTINGS = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
Camera.bf: 20.8
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("kitti_seq"))
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           baseline=0.08, planes=planes)
    gt = orbit_trajectory(N_FRAMES, radius=0.3, yaw_amp=0.2)
    export_kitti_sequence(out, scene, gt, fps=10.0)
    return out


@pytest.fixture(scope="module")
def euroc_rig():
    return make_euroc_rig(width=320, height=240, fx_rect=260.0,
                          baseline=0.08)


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory, euroc_rig):
    out = str(tmp_path_factory.mktemp("euroc_seq"))
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    gt = orbit_trajectory(N_FRAMES, radius=0.3, yaw_amp=0.2)
    export_euroc_sequence(out, planes, gt, rig=euroc_rig, fps=20.0)
    return out


def _parse_kitti(path):
    """KITTI rows (3x4 row-major Twc) -> world->camera pose7 array."""
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.geometry import se3

    mats = []
    with open(path) as f:
        for line in f:
            v = np.asarray([float(x) for x in line.split()]).reshape(3, 4)
            m = np.eye(4)
            m[:3] = v
            mats.append(m)
    mats = np.stack(mats)
    poses_wc = np.asarray(se3.from_matrix(jnp.asarray(mats, jnp.float32)))
    return np.asarray(se3.inverse(jnp.asarray(poses_wc)))


class TestKittiLayout:
    def test_export_files(self, kitti_dir):
        for f in ("times.txt", "poses_gt.txt"):
            assert os.path.exists(os.path.join(kitti_dir, f))
        assert os.path.exists(
            os.path.join(kitti_dir, "image_0", f"{N_FRAMES-1:06d}.png"))
        assert os.path.exists(
            os.path.join(kitti_dir, "image_1", f"{N_FRAMES-1:06d}.png"))
        with open(os.path.join(kitti_dir, "times.txt")) as f:
            times = [float(x) for x in f.read().split()]
        assert len(times) == N_FRAMES and abs(times[1] - 0.1) < 1e-6

    def test_gt_parses_as_kitti(self, kitti_dir):
        gt_cw = _parse_kitti(os.path.join(kitti_dir, "poses_gt.txt"))
        assert gt_cw.shape == (N_FRAMES, 7)
        # first pose is the origin
        assert np.allclose(gt_cw[0, 4:7], 0.0, atol=1e-5)


class TestKittiStereoDriverE2E:
    def test_cli_end_to_end(self, kitti_dir, tmp_path):
        """Drive the ACTUAL stereo_kitti CLI (argv -> loader -> SlamSystem ->
        KITTI-format trajectory file), then score it frame-by-frame against
        the exported ground truth — the KITTI-devkit workflow
        (`/root/reference/Examples/Stereo/stereo_kitti.cc`)."""
        from orb_slam2_refactored_tpu.drivers import main as driver_main

        settings = str(tmp_path / "kitti.yaml")
        with open(settings, "w") as f:
            f.write(KITTI_SETTINGS)
        out_kitti = str(tmp_path / "traj_kitti.txt")
        rc = driver_main([
            "stereo_kitti", "--settings", settings, "--sequence", kitti_dir,
            "--out", str(tmp_path / "traj_tum.txt"),
            "--kitti-out", out_kitti, "--no-loop-closing",
        ])
        assert rc == 0 and os.path.exists(out_kitti)

        est_cw = _parse_kitti(out_kitti)
        gt_cw = _parse_kitti(os.path.join(kitti_dir, "poses_gt.txt"))
        assert est_cw.shape[0] == N_FRAMES  # one line per frame
        rmse, _ = ate_rmse(est_cw, gt_cw, align="se3")
        print(f"stereo_kitti e2e: ATE {rmse:.4f} m over {N_FRAMES} frames")
        assert rmse < 0.05, f"ATE {rmse:.4f} m too large for the box room"


class TestEurocRectification:
    def test_rectified_matches_ideal(self, euroc_dir, euroc_rig, tmp_path):
        """EurocRectifier (cv2.initUndistortRectifyMap from the LEFT./RIGHT.
        YAML blocks) must map the RAW distorted/rotated export onto the
        ideal rectified pinhole view (`stereo_euroc.cc:61-107`)."""
        import cv2

        from orb_slam2_refactored_tpu.config import Settings
        from orb_slam2_refactored_tpu.io.datasets import EurocRectifier

        settings = str(tmp_path / "euroc.yaml")
        with open(settings, "w") as f:
            f.write(euroc_settings_yaml(euroc_rig))
        s = Settings.from_yaml(settings)
        assert s.rectification is not None
        rect = EurocRectifier(s.rectification)

        with open(os.path.join(euroc_dir, "timestamps.txt")) as f:
            ns = f.read().split()[0]
        raw_l = cv2.imread(
            os.path.join(euroc_dir, "mav0", "cam0", "data", ns + ".png"),
            cv2.IMREAD_GRAYSCALE).astype(np.float32)
        raw_r = cv2.imread(
            os.path.join(euroc_dir, "mav0", "cam1", "data", ns + ".png"),
            cv2.IMREAD_GRAYSCALE).astype(np.float32)
        rect_l, rect_r = rect(raw_l, raw_r)

        planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
        ideal = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                               baseline=0.08, planes=planes)
        gt = orbit_trajectory(N_FRAMES, radius=0.3, yaw_amp=0.2)
        ideal_l, ideal_r, _ = ideal.render_stereo(gt[0])

        for got, want in ((rect_l, ideal_l), (rect_r, ideal_r)):
            a = got[20:-20, 20:-20].ravel()
            b = np.clip(want, 0, 255)[20:-20, 20:-20].ravel()
            corr = np.corrcoef(a, b)[0, 1]
            assert corr > 0.93, f"rectified/ideal correlation {corr:.3f}"

    def test_raw_is_not_rectified(self, euroc_dir):
        """The export must actually be RAW (distorted/rotated): a raw pair
        row must NOT be stereo-aligned the way the rectified pair is."""
        import cv2

        with open(os.path.join(euroc_dir, "timestamps.txt")) as f:
            ns = f.read().split()[0]
        raw_l = cv2.imread(
            os.path.join(euroc_dir, "mav0", "cam0", "data", ns + ".png"),
            cv2.IMREAD_GRAYSCALE).astype(np.float32)
        planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
        ideal = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                               planes=planes)
        gt = orbit_trajectory(N_FRAMES, radius=0.3, yaw_amp=0.2)
        ideal_l, _ = ideal.render(gt[0])
        a = raw_l[20:-20, 20:-20].ravel()
        b = np.clip(ideal_l, 0, 255)[20:-20, 20:-20].ravel()
        corr = np.corrcoef(a, b)[0, 1]
        assert corr < 0.9, "raw export suspiciously identical to rectified"


class TestEurocStereoDriverE2E:
    def test_cli_end_to_end(self, euroc_dir, euroc_rig, tmp_path):
        """Drive the ACTUAL stereo_euroc CLI — nontrivial LEFT./RIGHT.
        rectification through EurocRectifier inside the driver — then score
        the saved TUM trajectory against ground truth with timestamp
        association (`stereo_euroc.cc`, `src/System.cc:690-747`)."""
        import jax.numpy as jnp

        from orb_slam2_refactored_tpu.drivers import main as driver_main
        from orb_slam2_refactored_tpu.geometry import se3
        from orb_slam2_refactored_tpu.io.datasets import load_tum_groundtruth

        settings = str(tmp_path / "euroc.yaml")
        with open(settings, "w") as f:
            f.write(euroc_settings_yaml(euroc_rig))
        out = str(tmp_path / "traj.txt")
        rc = driver_main([
            "stereo_euroc", "--settings", settings, "--sequence", euroc_dir,
            "--timestamps", os.path.join(euroc_dir, "timestamps.txt"),
            "--out", out, "--no-loop-closing",
        ])
        assert rc == 0 and os.path.exists(out)

        est_ts, est_poses = [], []
        with open(out) as f:
            for line in f:
                v = [float(x) for x in line.split()]
                est_ts.append(v[0])
                tx, ty, tz, qx, qy, qz, qw = v[1:8]
                est_poses.append([qw, qx, qy, qz, tx, ty, tz])
        est_cw = np.asarray(se3.inverse(jnp.asarray(est_poses, jnp.float32)))
        gt_ts, gt_cw = load_tum_groundtruth(
            os.path.join(euroc_dir, "groundtruth_tum.txt"))
        rmse, _, n = ate_rmse_assoc(
            np.asarray(est_ts), est_cw, gt_ts, gt_cw, max_dt=0.01)
        print(f"stereo_euroc e2e: ATE {rmse:.4f} m over {n} frames")
        assert n >= N_FRAMES - 5
        assert rmse < 0.05, f"ATE {rmse:.4f} m too large for the box room"
