"""System façade: the user-facing entry point of the SLAM engine.

Capability analog of the reference `System`
(`/root/reference/include/System.h:45-113`, `src/System.cc:310-951`):
`System.create(settings_yaml, sensor)` builds the full engine from the SAME
YAML schema the reference reads; `track_monocular/track_stereo/track_rgbd`
process frames; trajectory savers write the reference's exact TUM/KITTI
formats (`SaveTrajectoryTUM` :690, `SaveKeyFrameTrajectoryTUM` :753,
`SaveTrajectoryKITTI` :790) so downstream evaluation tools work unchanged;
`activate_localization_mode` freezes the map (ModeManager analog :221-271);
`reset` clears all state (ResetManager :281-308).

The reference's thread launches (`src/System.cc:398-411`) have no analog:
tracking, local mapping and loop closing are synchronous staged calls over
device-resident state (SURVEY.md §2.3 design rows).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from ..config import Settings
from ..geometry import se3
from .map_state import MapCapacity
from .tracking import TrackState, Tracker, TrackerConfig

MONOCULAR = 0
STEREO = 1
RGBD = 2


def _np_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side se3 compose (same [qw,qx,qy,qz,t] layout & semantics as
    geometry.se3.compose: apply b first, then a)."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    q = np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], np.float32)
    q /= max(np.linalg.norm(q), 1e-12)
    u, w = a[1:4], a[0]
    v = b[4:7]
    uv = np.cross(u, v)
    t = v + 2.0 * (w * uv + np.cross(u, uv)) + a[4:7]
    return np.concatenate([q, t.astype(np.float32)])


def _np_inverse(a: np.ndarray) -> np.ndarray:
    """Host-side se3 inverse (layout & semantics of geometry.se3.inverse)."""
    q = np.array([a[0], -a[1], -a[2], -a[3]], np.float32)
    u, w = q[1:4], q[0]
    v = -a[4:7]
    uv = np.cross(u, v)
    t = v + 2.0 * (w * uv + np.cross(u, uv))
    return np.concatenate([q, t.astype(np.float32)])


def corrected_frame_poses(tracker: Tracker) -> np.ndarray:
    """Per-frame world->camera poses with loop/GBA corrections applied.

    The reference stores Tcr (pose relative to the reference KF at track
    time) and composes with the KF's CURRENT pose at save time, walking
    the spanning tree through culled reference KFs via their recorded
    Tcp (`SaveTrajectoryTUM`, src/System.cc:690-747). Frames without a
    Tcr record (losses, relocalization frames) keep their raw pose.
    """
    entries = tracker.traj_entries
    if not entries:
        return np.stack(tracker.trajectory) if tracker.trajectory else np.zeros((0, 7), np.float32)
    kf_pose = np.asarray(tracker.map.kf_pose)  # ONE device read
    g = tracker.graph
    tcp_map = getattr(g, "kf_tcp", {})
    out = np.zeros((len(entries), 7), np.float32)
    ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    for i, e in enumerate(entries):
        if e["lost"] or e["tcr"] is None or e["ref"] < 0:
            out[i] = e["pose"]
            continue
        # walk culled reference KFs: Trw accumulates Tcp hops
        # (host numpy composition: no device dispatch per hop)
        ref = e["ref"]
        trw = ident
        hops = 0
        while not g.kf_alive[ref] and ref in tcp_map and hops < 64:
            parent, tcp = tcp_map[ref]
            trw = _np_compose(trw, np.asarray(tcp))
            ref = parent
            hops += 1
        if not g.kf_alive[ref]:
            out[i] = e["pose"]  # unwalkable (reset wiped the map)
            continue
        trw = _np_compose(trw, kf_pose[ref])
        out[i] = _np_compose(e["tcr"], trw)
    return out


class SlamSystem:
    def __init__(self, tracker: Tracker, sensor: int, settings: Settings):
        self.tracker = tracker
        self.sensor = sensor
        self.settings = settings
        self.localization_only = False
        self.timestamps: List[float] = []
        self._pending_cmds: List = []

    # ------------------------------------------------------------------

    @staticmethod
    def create(
        settings_path: str,
        sensor: int,
        map_capacity: Optional[MapCapacity] = None,
        enable_loop_closing: bool = True,
        vocabulary=None,
        use_viewer: bool = False,
        viewer_dir: str = "viz_live",
    ) -> "SlamSystem":
        """Build from a reference-format YAML settings file
        (`src/System.cc:333-375` key schema — see config.Settings).
        `use_viewer` is the reference ctor's bUseViewer: starts the
        background LiveViewer render loop (viz/viewer.py)."""
        st = Settings.from_yaml(settings_path)
        cam = st.camera
        width = cam.width
        height = cam.height
        if not width or not height:
            raise ValueError(
                "Camera.width/Camera.height must be set in the settings YAML "
                "(static image geometry is required to compile the pipeline)"
            )
        cfg = TrackerConfig(
            width=width, height=height,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            bf=cam.bf if sensor != MONOCULAR else 0.0,
            dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3),
            th_depth=st.th_depth,
            n_features=st.orb.n_features,
            n_levels=st.orb.n_levels,
            scale_factor=st.orb.scale_factor,
            ini_th_fast=st.orb.ini_th_fast,
            min_th_fast=st.orb.min_th_fast,
            kf_max_interval=int(cam.fps),
            kf_ref_ratio=0.9 if sensor == MONOCULAR else 0.75,
            enable_loop_closing=enable_loop_closing,
            map_capacity=map_capacity,
            # extension key (not in the reference schema): selects the BRIEF
            # test-pair table; "learned" matches externally trained vocabs
            descriptor_pattern=str(
                st.raw.get("ORBextractor.pattern", "fresh")
            ),
        )
        tracker = Tracker(cfg)
        if vocabulary is not None:
            tracker.set_vocabulary(vocabulary)
        system = SlamSystem(tracker, sensor, st)
        if use_viewer:
            from ..viz.viewer import LiveViewer

            system.viewer = LiveViewer(
                tracker, out_dir=viewer_dir, system=system
            ).start()
        return system

    # ------------------------------------------------------------------
    # per-frame entry points (System::Track*, src/System.cc:430-622)
    # ------------------------------------------------------------------

    def track_monocular(self, img, timestamp: float):
        assert self.sensor == MONOCULAR
        self.timestamps.append(timestamp)
        return self._track(lambda: self.tracker.track_mono(img, timestamp))

    def track_stereo(self, img_left, img_right, timestamp: float):
        assert self.sensor == STEREO
        self.timestamps.append(timestamp)
        return self._track(
            lambda: self.tracker.track_stereo(img_left, img_right, timestamp)
        )

    def track_rgbd(self, img, depth, timestamp: float):
        assert self.sensor == RGBD
        if self.settings.depth_map_factor not in (0.0, 1.0):
            depth = np.asarray(depth, np.float32) / self.settings.depth_map_factor
        self.timestamps.append(timestamp)
        return self._track(lambda: self.tracker.track_rgbd(img, depth, timestamp))

    def _track(self, fn):
        if self._pending_cmds:
            self._apply_pending_commands()
        return fn()

    # ------------------------------------------------------------------
    # runtime control surface (the reference Viewer's menu toggles wire
    # back into System the same deferred way: the viewer thread REQUESTS,
    # the tracking thread APPLIES at its next frame — ModeManager /
    # ResetManager, `/root/reference/src/System.cc:221-308,439-442`,
    # menu wiring `src/Viewer.cc:62-179`)
    # ------------------------------------------------------------------

    def request_command(self, cmd: str, arg: str = ""):
        """Queue a control command from any thread; applied at the next
        tracked frame. Commands: `localization_mode on|off`, `reset`,
        `save_map <path>`."""
        self._pending_cmds.append((str(cmd), str(arg)))

    def _apply_pending_commands(self):
        cmds, self._pending_cmds = self._pending_cmds, []
        for cmd, arg in cmds:
            if cmd == "localization_mode":
                if arg.lower() in ("on", "1", "true"):
                    self.activate_localization_mode()
                else:
                    self.deactivate_localization_mode()
            elif cmd == "reset":
                self.reset()
            elif cmd == "save_map" and arg:
                self.save_map(arg)

    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        """Track-only mode (ModeManager stopping LocalMapping,
        `/root/reference/src/System.cc:221-271`): the in-flight mapping job
        and every deferred mapping product are flushed FIRST (the reference
        blocks on LocalMapping::Stop the same way), then keyframe creation
        and the mapping pump are disabled — the map cannot mutate until
        deactivation."""
        self.tracker._finalize_map()
        self.tracker.localization_only = True
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False
        self.localization_only = False

    def change_calibration(self, settings_path: str):
        """System::ChangeCalibration analog
        (`/root/reference/src/System.cc:869-875`): reload camera intrinsics
        and distortion from a settings YAML mid-session; the map survives,
        per-frame programs re-trace on next use."""
        st = Settings.from_yaml(settings_path)
        cam = st.camera
        self.settings = st
        self.tracker.change_calibration(
            cam.fx, cam.fy, cam.cx, cam.cy,
            bf=cam.bf if self.sensor != MONOCULAR else None,
            dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3),
        )

    def get_tracking_state(self) -> int:
        return self.tracker.state

    def map_changed_counter(self) -> int:
        return self.tracker.graph.big_change_counter

    def reset(self):
        """Full system reset (src/System.cc:624-660): new map, new graph,
        tracking back to uninitialized — compiled programs are retained."""
        cfg = self.tracker.cfg
        voc = self.tracker.vocabulary
        old = self.tracker
        new = Tracker(cfg)
        # reuse compiled programs (identical shapes) to avoid recompiling
        for attr in ("_prepare", "_prepare_packed", "_prepare_stereo",
                     "_prepare_mono", "_track", "_step", "_step_packed",
                     "_step_stereo", "_insert_kf", "_insert_kf_auto",
                     "_reloc_match", "_mono_match", "_mono_init",
                     "_zero_counters"):
            if hasattr(old, attr):
                setattr(new, attr, getattr(old, attr))
        if voc is not None:
            new.set_vocabulary(voc)
        self.tracker = new
        self.timestamps = []

    def save_map(self, path: str):
        """Persist the full SLAM state (the reference leaves SaveMap as a
        TODO, `/root/reference/src/System.cc:845-847`; here it is
        first-class — SURVEY.md §5 checkpoint/resume)."""
        from .serialize import save_map as _save
        _save(self.tracker, path)

    def load_map(self, path: str):
        """Restore a saved map into this system; the next tracked frame
        relocalizes against it (LoadMap analog the reference never
        implemented, `include/System.h:99-101`)."""
        from .serialize import load_map as _load
        _load(self.tracker, path)

    def shutdown(self):
        """Stop the viewer thread if one is running (the reference joins
        Viewer + LocalMapping + LoopClosing + GBA, src/System.cc:665-684;
        the SLAM stages here are staged in-process, so the viewer is the
        only actual thread)."""
        v = getattr(self, "viewer", None)
        if v is not None:
            v.stop()
            self.viewer = None

    # ------------------------------------------------------------------
    # trajectory export — byte-format parity with the reference
    # ------------------------------------------------------------------

    def _frame_poses_wc(self):
        traj = np.stack(self.tracker.trajectory) if self.tracker.trajectory else np.zeros((0, 7), np.float32)
        return np.asarray(se3.inverse(jnp.asarray(traj))) if len(traj) else traj

    def corrected_frame_poses(self) -> np.ndarray:
        return corrected_frame_poses(self.tracker)

    def save_trajectory_tum(self, path: str, corrected: bool = True):
        """TUM format: `t tx ty tz qx qy qz qw` per frame
        (`SaveTrajectoryTUM`, src/System.cc:690-747). With `corrected=True`
        (default, matching the reference) every frame pose composes its Tcr
        with the current — loop/GBA-corrected — reference keyframe pose."""
        if corrected and self.tracker.traj_entries:
            poses_cw = self.corrected_frame_poses()
            poses_wc = np.asarray(se3.inverse(jnp.asarray(poses_cw)))
        else:
            poses_wc = self._frame_poses_wc()
        with open(path, "w") as f:
            for ts, p in zip(self.timestamps, poses_wc):
                qw, qx, qy, qz, tx, ty, tz = p
                f.write(
                    f"{ts:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n"
                )

    def save_keyframe_trajectory_tum(self, path: str):
        """KF-only TUM trajectory (`SaveKeyFrameTrajectoryTUM`, :753-784)."""
        g = self.tracker.graph
        kfs = g.alive_kfs()
        kf_pose = np.asarray(self.tracker.map.kf_pose)
        with open(path, "w") as f:
            for k in kfs:
                p = np.asarray(se3.inverse(jnp.asarray(kf_pose[k])))
                qw, qx, qy, qz, tx, ty, tz = p
                ts = g.kf_timestamp[k]
                f.write(
                    f"{ts:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n"
                )

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 3x4 row-major pose matrix per line
        (`SaveTrajectoryKITTI`, src/System.cc:790-843)."""
        poses_wc = self._frame_poses_wc()
        mats = np.asarray(se3.to_matrix(jnp.asarray(poses_wc))) if len(poses_wc) else np.zeros((0, 4, 4))
        with open(path, "w") as f:
            for m in mats:
                row = m[:3].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in row) + "\n")
