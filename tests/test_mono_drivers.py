"""Monocular CLI drivers end-to-end: synthetic TUM-mono and
EuRoC-mono exports driven through the REAL `driver_main` entry — argv ->
loaders -> SlamSystem -> trajectory file -> scored against groundtruth —
realizing BASELINE configs[0] (TUM mono) and [3] (EuRoC mono WITH loop
closing) at driver level.

Reference drivers: `/root/reference/Examples/Monocular/mono_tum.cc:56-118`,
`mono_euroc.cc`; saver `src/System.cc:690-747` (mono entries exist only for
tracked frames — the saver skips lost prefixes, like the reference's
trajectory recording starting after initialization).
"""

import os

import numpy as np
import pytest

from test_organic_loop import circuit_trajectory

from orb_slam2_refactored_tpu.io.datasets import load_tum_groundtruth
from orb_slam2_refactored_tpu.io.evaluation import ate_rmse_assoc
from orb_slam2_refactored_tpu.io.synthetic import (
    SyntheticScene, box_room, export_euroc_sequence, export_tum_sequence,
    make_euroc_rig, orbit_trajectory,
)

MONO_TUM_YAML = """%YAML:1.0
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
Camera.fps: 30.0
Camera.bf: 20.8
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _read_traj(path):
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            tx, ty, tz, qx, qy, qz, qw = v[1:8]
            poses.append([qw, qx, qy, qz, tx, ty, tz])
    import jax.numpy as jnp

    from orb_slam2_refactored_tpu.geometry import se3

    return (np.asarray(ts),
            np.asarray(se3.inverse(jnp.asarray(poses, jnp.float32))))


class TestMonoTumDriverE2E:
    def test_cli_end_to_end(self, tmp_path):
        """mono_tum through the CLI on a synthetic TUM export: the saved
        trajectory (sim3-aligned — monocular scale is unobservable) must
        track the groundtruth orbit."""
        from orb_slam2_refactored_tpu.drivers import main as driver_main

        seq = str(tmp_path / "seq")
        planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
        scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                               planes=planes)
        gt = orbit_trajectory(40, radius=0.35, yaw_amp=0.3)
        export_tum_sequence(seq, scene, gt, fps=30.0)
        settings = str(tmp_path / "settings.yaml")
        with open(settings, "w") as f:
            f.write(MONO_TUM_YAML)
        out = str(tmp_path / "traj.txt")
        rc = driver_main([
            "mono_tum", "--settings", settings, "--sequence", seq,
            "--out", out, "--no-loop-closing",
        ])
        assert rc == 0 and os.path.exists(out)
        est_ts, est_cw = _read_traj(out)
        # mono records tracked frames only; init consumes a short prefix
        assert len(est_ts) >= 30
        gt_ts, gt_cw = load_tum_groundtruth(
            os.path.join(seq, "groundtruth.txt"))
        rmse, _, n = ate_rmse_assoc(est_ts, est_cw, gt_ts, gt_cw,
                                    align="sim3")
        print(f"mono_tum driver e2e: ATE(sim3) {rmse:.4f} m over {n} frames")
        assert n >= 25
        # drift-only gate (no loop closing in this short orbit; matches
        # test_mono_e2e's tracker-level gate)
        assert rmse < 0.3, f"ATE {rmse:.4f} m"


class TestMonoEurocDriverE2E:
    def test_cli_loop_closing(self, tmp_path):
        """mono_euroc through the CLI on a synthetic EuRoC-layout circuit,
        loop closing ENABLED (BASELINE configs[3]): raw distorted cam0
        images + Camera.k1.. undistortion (like the reference's
        EuRoC.yaml), a 240-frame circuit whose revisit must close a loop,
        and a sim3 ATE gate on the SAVED trajectory file."""
        from orb_slam2_refactored_tpu.drivers import main as driver_main

        rig = make_euroc_rig(width=320, height=240, fx_rect=260.0,
                             baseline=0.08)
        planes = box_room(half_x=1.7, half_y=1.3, z_far=2.7, z_near=-2.7,
                          distinct_textures=True)
        gt = circuit_trajectory(240, overlap=40)
        seq = str(tmp_path / "euroc_seq")
        export_euroc_sequence(seq, planes, gt, rig=rig, fps=20.0)

        # mono settings: RAW cam0 intrinsics + distortion (mono_euroc reads
        # the unrectified cam0 stream, `Examples/Monocular/EuRoC.yaml`)
        K, D = rig["K_l"], rig["D_l"]
        yaml = "\n".join([
            "%YAML:1.0",
            f"Camera.fx: {K[0, 0]}", f"Camera.fy: {K[1, 1]}",
            f"Camera.cx: {K[0, 2]}", f"Camera.cy: {K[1, 2]}",
            f"Camera.k1: {D[0]}", f"Camera.k2: {D[1]}",
            f"Camera.p1: {D[2]}", f"Camera.p2: {D[3]}",
            f"Camera.k3: {D[4]}",
            f"Camera.width: {rig['width']}",
            f"Camera.height: {rig['height']}",
            "Camera.fps: 8.0",  # kf_max_interval=fps: keyframe cadence for
                                # the 240-frame circuit (mono loop test cfg)
            "Camera.bf: 20.8", "Camera.RGB: 1", "ThDepth: 35.0",
            "ORBextractor.nFeatures: 900",
            "ORBextractor.scaleFactor: 1.2",
            "ORBextractor.nLevels: 4",
            "ORBextractor.iniThFAST: 20",
            "ORBextractor.minThFAST: 7",
        ]) + "\n"
        settings = str(tmp_path / "mono_euroc.yaml")
        with open(settings, "w") as f:
            f.write(yaml)
        out = str(tmp_path / "traj.txt")
        import io
        from contextlib import redirect_stdout

        cap = io.StringIO()
        with redirect_stdout(cap):
            rc = driver_main([
                "mono_euroc", "--settings", settings, "--sequence", seq,
                "--timestamps", os.path.join(seq, "timestamps.txt"),
                "--out", out,
            ])
        report = cap.getvalue()
        print(report)
        assert rc == 0 and os.path.exists(out)
        # loop closing must have fired (driver report line)
        assert "loops closed:" in report
        n_loops = int(report.split("loops closed:")[1].split()[0])
        assert n_loops >= 1, "no loop closed on the circuit"
        est_ts, est_cw = _read_traj(out)
        assert len(est_ts) >= 200
        gt_ts, gt_cw = load_tum_groundtruth(
            os.path.join(seq, "groundtruth_tum.txt"))
        rmse, _, n = ate_rmse_assoc(est_ts, est_cw, gt_ts, gt_cw,
                                    align="sim3")
        print(f"mono_euroc driver e2e: ATE(sim3) {rmse:.4f} m over {n}")
        assert n >= 180
        assert rmse < 0.45, f"mono circuit ATE {rmse:.4f} m"
