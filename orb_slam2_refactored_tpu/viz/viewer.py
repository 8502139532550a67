"""Live viewer: a background render loop over the running tracker.

Runtime counterpart of the reference's Pangolin `Viewer` thread
(`/root/reference/src/Viewer.cc:62-179` — a loop that redraws the MapDrawer
+ FrameDrawer at a fixed rate while tracking runs). A headless host has no GUI;
the loop renders the same content (map points, keyframes, covisibility,
trajectory + the latest frame overlay) to PNG files at a fixed rate, so an
operator tails the directory (or serves it) the way the reference user
watches the Pangolin window. Headless-friendly, zero effect on the tracker:
reads only host mirrors and snapshots of the functional map arrays.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional


class LiveViewer:
    """Background thread rendering `plot_map` snapshots of a live tracker.

    Usage (System::Viewer analog, `src/System.cc:99-107` wiring):
        viewer = LiveViewer(tracker, out_dir="viz_live", hz=1.0)
        viewer.start()
        ... track frames ...
        viewer.stop()

    Files: `out_dir/map_latest.png` (atomically replaced each tick — the
    "window") plus a bounded history `map_00000.png ...`.
    """

    def __init__(self, tracker, out_dir: str = "viz_live", hz: float = 1.0,
                 keep_history: int = 20, system=None):
        self._tracker = tracker
        self.system = system  # enables the control surface + live tracker
        self.out_dir = out_dir
        self.period = 1.0 / max(hz, 1e-3)
        self.keep_history = keep_history
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.frames_rendered = 0
        self.commands_relayed = 0

    @property
    def tracker(self):
        # read through the system when attached: System.reset() swaps the
        # tracker object and a pinned reference would render a dead map
        return self.system.tracker if self.system is not None else self._tracker

    # -- lifecycle (Viewer::RequestFinish semantics) -----------------------

    def start(self):
        os.makedirs(self.out_dir, exist_ok=True)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="live-viewer", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_render: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if final_render:
            self._render_once()

    # -- render loop -------------------------------------------------------

    def _run(self):
        failures = 0
        while not self._stop.wait(self.period):
            try:
                self._poll_control()
                self._render_once()
                self._write_status()
                failures = 0
            except Exception as e:
                # a torn snapshot mid-keyframe must never kill the viewer
                # (the reference viewer holds mutexes instead; the
                # functional arrays make retries safe) — but a PERSISTENT
                # failure (e.g. matplotlib missing) must be diagnosable,
                # not a silent forever-loop (ADVICE r3)
                failures += 1
                if failures in (1, 10):
                    import sys
                    import traceback

                    print(f"[live-viewer] render failed "
                          f"({failures} consecutive): {e!r}",
                          file=sys.stderr)
                    if failures == 10:
                        traceback.print_exc()
                continue

    # -- control surface (reference Viewer menu -> System wiring,
    # `src/Viewer.cc:62-179`: "Localization Mode" checkbox + "Reset"
    # button; headless transport = a `control` file in the viz dir) -------

    def _poll_control(self):
        """Consume `out_dir/control` (one command per line: see
        `SlamSystem.request_command`) and relay to the attached system;
        commands apply at the system's next tracked frame — the same
        deferred request/apply protocol the reference's viewer thread uses
        (ModeManager/ResetManager, `src/System.cc:221-308`)."""
        if self.system is None:
            return
        path = os.path.join(self.out_dir, "control")
        if not os.path.exists(path):
            return
        claimed = os.path.join(self.out_dir, ".control_consumed")
        try:
            # claim FIRST via atomic rename, then read: a plain
            # read-then-remove would delete a file the operator rewrote
            # between the two calls, silently dropping those commands
            os.replace(path, claimed)
            with open(claimed) as f:
                lines = f.read().splitlines()
            os.remove(claimed)
        except OSError:
            return  # producer mid-write; retry next tick
        for line in lines:
            parts = line.strip().split(None, 1)
            if not parts or parts[0].startswith("#"):
                continue
            self.system.request_command(
                parts[0], parts[1] if len(parts) > 1 else "")
            self.commands_relayed += 1

    def _write_status(self):
        """`out_dir/status.json`: the FrameDrawer status-text analog
        (`src/FrameDrawer.cc:30-90` state + tracked-point counts)."""
        import json

        t = self.tracker
        lc = getattr(t, "loop_closer", None)
        status = {
            "frame_id": int(t.frame_id),
            "state": int(t.state),
            "keyframes": int(len(t.graph.alive_kfs())),
            "points": int(t.graph.pt_alive.sum()),
            "localization_only": bool(getattr(t, "localization_only", False)),
            "loops_closed": int(lc.loops_closed) if lc is not None else 0,
        }
        tmp = os.path.join(self.out_dir, ".status_tmp.json")
        with open(tmp, "w") as f:
            json.dump(status, f)
        os.replace(tmp, os.path.join(self.out_dir, "status.json"))

    def _render_once(self):
        from .plot import plot_map

        t = self.tracker
        if t.state != 1 or len(t.graph.alive_kfs()) == 0:
            return
        idx = self.frames_rendered
        tmp = os.path.join(self.out_dir, ".map_tmp.png")
        plot_map(t, tmp, title=f"tpu-slam live (frame {t.frame_id})")
        latest = os.path.join(self.out_dir, "map_latest.png")
        os.replace(tmp, latest)  # atomic "window" update
        if self.keep_history > 0:
            hist = os.path.join(self.out_dir, f"map_{idx:05d}.png")
            import shutil

            shutil.copyfile(latest, hist)
            old = idx - self.keep_history
            if old >= 0:
                stale = os.path.join(self.out_dir, f"map_{old:05d}.png")
                if os.path.exists(stale):
                    os.remove(stale)
        self.frames_rendered += 1
