"""Settings loader — reads the reference's YAML schema verbatim.

Capability parity with the cv::FileStorage reads in the reference System ctor
(`/root/reference/src/System.cc:47-120,333-375`): the same keys
(`Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,fps,RGB,bf}`, `ThDepth`,
`DepthMapFactor`, `ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,minThFAST}`,
`Viewer.*`, and EuRoC `LEFT./RIGHT.{K,D,R,P,height,width}`) parse from the
same settings files, so a reference user's YAML works unchanged.

OpenCV writes these files as YAML 1.0 with a `%YAML:1.0` directive and
`!!opencv-matrix` blocks. `_load_opencv_yaml` reads that subset directly
(flat `key: scalar` lines, comments, and matrix blocks with rows/cols/dt/data),
with YAML 1.1 scalar typing, so no YAML library is needed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import numpy as np

_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _scalar(text: str):
    """One plain or quoted YAML scalar, typed as YAML 1.1 types it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE"):
        return True
    if t in ("false", "False", "FALSE"):
        return False
    if _INT.match(t):
        return int(t)
    if _FLOAT.match(t) and t not in (".", "+.", "-."):
        return float(t.replace("_", ""))
    return t


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (one at the line start or after whitespace)."""
    m = re.search(r"(^|\s)#", line)
    return line[: m.start()] if m else line


def _load_opencv_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        lines = [_strip_comment(l).rstrip() for l in f]
    out: Dict[str, Any] = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line.startswith("%") or line.strip() == "---":
            continue
        key, _, value = line.partition(":")
        key, value = key.strip(), value.strip()
        if value.startswith("!!opencv-matrix") or value == "":
            # indented block of `field: value` lines; `data` may span lines
            node: Dict[str, Any] = {}
            while i < len(lines) and (not lines[i].strip()
                                      or lines[i][0] in " \t"):
                field, _, v = lines[i].strip().partition(":")
                i += 1
                if not field:
                    continue
                v = v.strip()
                if v.startswith("["):
                    while "]" not in v and i < len(lines):
                        v += " " + lines[i].strip()
                        i += 1
                    items = v.strip("[] ").split(",")
                    node[field.strip()] = [_scalar(x) for x in items
                                           if x.strip()]
                else:
                    node[field.strip()] = _scalar(v)
            out[key] = node if node else None
        else:
            out[key] = _scalar(value)
    return out


def _as_matrix(node) -> np.ndarray:
    """Decode an opencv-matrix node {rows, cols, dt, data} -> ndarray."""
    if isinstance(node, dict) and "data" in node:
        rows = int(node.get("rows", 1))
        cols = int(node.get("cols", 1))
        return np.asarray(node["data"], np.float64).reshape(rows, cols)
    return np.asarray(node, np.float64)


@dataclasses.dataclass
class OrbParams:
    """ORB extractor parameters (`/root/reference/include/ORBextractor.h:38-47`)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass
class CameraConfig:
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    rgb: bool = True
    bf: float = 0.0
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class RectificationConfig:
    """EuRoC-style stereo rectification block
    (`/root/reference/Examples/Stereo/stereo_euroc.cc:61-107`)."""

    K_l: np.ndarray = None
    K_r: np.ndarray = None
    D_l: np.ndarray = None
    D_r: np.ndarray = None
    R_l: np.ndarray = None
    R_r: np.ndarray = None
    P_l: np.ndarray = None
    P_r: np.ndarray = None
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class Settings:
    camera: CameraConfig
    orb: OrbParams
    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    viewer: Dict[str, float] = dataclasses.field(default_factory=dict)
    rectification: Optional[RectificationConfig] = None
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_yaml(path: str) -> "Settings":
        d = _load_opencv_yaml(path)

        def g(key, default=None):
            return d.get(key, default)

        cam = CameraConfig(
            fx=float(g("Camera.fx", 0.0)),
            fy=float(g("Camera.fy", 0.0)),
            cx=float(g("Camera.cx", 0.0)),
            cy=float(g("Camera.cy", 0.0)),
            k1=float(g("Camera.k1", 0.0)),
            k2=float(g("Camera.k2", 0.0)),
            p1=float(g("Camera.p1", 0.0)),
            p2=float(g("Camera.p2", 0.0)),
            k3=float(g("Camera.k3", 0.0)),
            fps=float(g("Camera.fps", 30.0) or 30.0),
            rgb=bool(int(g("Camera.RGB", 1))),
            bf=float(g("Camera.bf", 0.0)),
            width=int(g("Camera.width", 0)),
            height=int(g("Camera.height", 0)),
        )
        orb = OrbParams(
            n_features=int(g("ORBextractor.nFeatures", 2000)),
            scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(g("ORBextractor.nLevels", 8)),
            ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
            min_th_fast=int(g("ORBextractor.minThFAST", 7)),
        )
        rect = None
        if "LEFT.K" in d:
            rect = RectificationConfig(
                K_l=_as_matrix(d["LEFT.K"]),
                K_r=_as_matrix(d["RIGHT.K"]),
                D_l=_as_matrix(d["LEFT.D"]),
                D_r=_as_matrix(d["RIGHT.D"]),
                R_l=_as_matrix(d["LEFT.R"]),
                R_r=_as_matrix(d["RIGHT.R"]),
                P_l=_as_matrix(d["LEFT.P"]),
                P_r=_as_matrix(d["RIGHT.P"]),
                width=int(d.get("LEFT.width", 0)),
                height=int(d.get("LEFT.height", 0)),
            )
        viewer = {k[len("Viewer."):]: v for k, v in d.items() if k.startswith("Viewer.")}
        dmf = float(g("DepthMapFactor", 1.0) or 1.0)
        return Settings(
            camera=cam,
            orb=orb,
            th_depth=float(g("ThDepth", 35.0) or 35.0),
            depth_map_factor=dmf,
            viewer=viewer,
            rectification=rect,
            raw=d,
        )
