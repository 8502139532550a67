"""ctypes bindings for the native (C++) map-graph core.

`load_library` builds `native/libmapgraph.so` from `native/map_graph.cpp`
at first use in each process (make leaves an up-to-date library alone) and
loads it. `NativeMapGraph` is a drop-in for `slam.map_state.MapGraph` (same
accessor interface); the tracker uses it unless `TPU_SLAM_NATIVE_GRAPH=0`
selects the Python graph.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import List, Set

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_NAME = "libmapgraph.so"

_lib = None


def build_library(native_dir: str = _NATIVE_DIR) -> str:
    """Bring `<native_dir>/libmapgraph.so` up to date and return its path.

    The Makefile compiles into a temporary name and renames it into place,
    so a process never maps a half-written library. The build holds an
    exclusive lock on `<native_dir>/.build.lock`: processes that start
    together (test workers) build once, and the others wait and find the
    library current. A failed build raises."""
    with open(os.path.join(native_dir, ".build.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(["make", "-s", "-C", native_dir],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native map graph in {native_dir} failed:\n"
            f"{proc.stdout}{proc.stderr}")
    return os.path.join(native_dir, _LIB_NAME)


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    c_i32, c_i64, c_vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "mg_create": ([c_i32, c_i32], c_vp),
        "mg_destroy": ([c_vp], None),
        "mg_set_kf_alive": ([c_vp, c_i32, c_i32], None),
        "mg_kf_alive": ([c_vp, c_i32], c_i32),
        "mg_set_pt_alive": ([c_vp, c_i32, c_i32], None),
        "mg_pt_alive": ([c_vp, c_i32], c_i32),
        "mg_fill_pt_alive": ([c_vp, p_u8, c_i32], None),
        "mg_set_pt_first_kf": ([c_vp, c_i32, c_i64], None),
        "mg_pt_first_kf": ([c_vp, c_i32], c_i64),
        "mg_set_origin": ([c_vp, c_i32], None),
        "mg_origin": ([c_vp], c_i32),
        "mg_add_observation": ([c_vp, c_i32, c_i32, c_i32], None),
        "mg_erase_observation": ([c_vp, c_i32, c_i32], None),
        "mg_n_obs": ([c_vp, c_i32], c_i32),
        "mg_get_obs": ([c_vp, c_i32, p_i32, p_i32, c_i32], c_i32),
        "mg_obs_feat_in_kf": ([c_vp, c_i32, c_i32], c_i32),
        "mg_refresh_export": ([c_vp, p_i32, c_i32, c_i32, c_i32,
                               p_i32, p_i32, p_i32, p_i32, c_i32], c_i32),
        "mg_apply_fuse": ([c_vp, p_i32, p_i32, c_i32, p_i32, p_i32, p_u8,
                           p_i32, c_i32, p_i32, p_i32, p_i32, p_i32,
                           p_i32, p_i32, p_i32, p_i32, p_i32, p_i32,
                           p_i32, p_i32, p_i32, c_i32], c_i32),
        "mg_covis_weight": ([c_vp, c_i32, c_i32], c_i32),
        "mg_covis_neighbors": ([c_vp, c_i32, c_i32, c_i32, p_i32, c_i32], c_i32),
        "mg_update_connections": ([c_vp, c_i32, p_i32, c_i32, c_i32], None),
        "mg_parent": ([c_vp, c_i32], c_i32),
        "mg_set_parent": ([c_vp, c_i32, c_i32], None),
        "mg_add_loop_edge": ([c_vp, c_i32, c_i32], None),
        "mg_loop_edges": ([c_vp, c_i32, p_i32, c_i32], c_i32),
        "mg_kill_point": ([c_vp, c_i32, p_i32, p_i32, c_i32], c_i32),
        "mg_kill_keyframe": ([c_vp, c_i32], None),
        "mg_reset_kf": ([c_vp, c_i32], None),
        "mg_redundant_obs": ([c_vp, c_i32, p_i32, p_i32, c_i32, p_i32], c_i32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return _lib


def _as_i32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeMapGraph:
    """Same accessor interface as `map_state.MapGraph`, backed by C++.

    Observation lists, covisibility and the spanning tree live in the native
    arena; small numpy mirrors (alive flags, timestamps) stay host-side for
    vectorized reads.
    """

    def __init__(self, cap):
        lib = load_library()
        self._lib = lib
        self.cap = cap
        self._h = lib.mg_create(cap.max_keyframes, cap.max_points)
        # num_kfs = KFs ever created (monotonic); next_kf_slot = fresh cursor
        self.num_kfs = 0
        self.next_kf_slot = 0
        self.next_point = 0
        self.kf_seq = np.full(cap.max_keyframes, -1, np.int64)
        self.kf_quarantine: List = []
        self.kf_alive = np.zeros(cap.max_keyframes, bool)
        self.kf_frame_id = np.full(cap.max_keyframes, -1, np.int64)
        self.kf_timestamp = np.zeros(cap.max_keyframes, np.float64)
        self.kf_watermark = np.zeros(cap.max_keyframes, np.int64)
        self.pt_visible = np.zeros(cap.max_points, np.int32)
        self.pt_found = np.zeros(cap.max_points, np.int32)
        self.pt_first_kf = _FirstKf(self)
        self.pt_alive = _PtAlive(self)
        self._scratch_kf = np.zeros(4096, np.int32)
        self._scratch_feat = np.zeros(4096, np.int32)
        # host mirrors of device kf_mp rows / keypoint levels, so graph
        # queries never read the device (see map_state.MapGraph)
        self.kf_row = np.full(
            (cap.max_keyframes, cap.max_features), -1, np.int32
        )
        self.kf_levels = np.zeros(
            (cap.max_keyframes, cap.max_features), np.int32
        )
        self.big_change_counter = 0
        self.pt_quarantine: List = []
        self.recycled_log: List[int] = []
        self.young_pts: List = []
        self._obs_points: Set[int] = set()
        self.loop_edges = _LoopEdges(self)
        self.parent = _Parent(self)

    def __del__(self):
        try:
            self._lib.mg_destroy(self._h)
        except Exception:
            pass

    # -- slots ---------------------------------------------------------

    @property
    def origin_kf(self) -> int:
        return int(self._lib.mg_origin(self._h))

    @origin_kf.setter
    def origin_kf(self, kf: int):
        self._lib.mg_set_origin(self._h, int(kf))

    def can_alloc_kf(self) -> bool:
        return (self.next_kf_slot < self.cap.max_keyframes
                or any(self.num_kfs - st >= 3 for _, st in self.kf_quarantine))

    def alloc_kf_slot(self) -> int:
        """Fresh first, then quarantined recycling (see
        map_state.MapGraph.alloc_kf_slot)."""
        if self.next_kf_slot < self.cap.max_keyframes:
            s = self.next_kf_slot
            self.next_kf_slot += 1
        else:
            s = None
            for i, (k, stamp) in enumerate(self.kf_quarantine):
                if self.num_kfs - stamp >= 3:
                    del self.kf_quarantine[i]
                    s = int(k)
                    break
            if s is None:
                raise RuntimeError(
                    f"keyframe capacity {self.cap.max_keyframes} exhausted "
                    f"(no culled slots to recycle)"
                )
            self._lib.mg_reset_kf(self._h, s)
            self.kf_frame_id[s] = -1
            self.kf_timestamp[s] = 0.0
            self.kf_row[s] = -1
        self.kf_seq[s] = self.num_kfs
        self.num_kfs += 1
        self.kf_watermark[s] = self.next_point
        return s

    def alloc_point_slots(self, n: int) -> np.ndarray:
        """Allocate UP TO n slots; recycles quarantined dead slots at
        capacity (see map_state.MapGraph.alloc_point_slots)."""
        fresh = min(n, self.cap.max_points - self.next_point)
        slots = list(range(self.next_point, self.next_point + fresh))
        self.next_point += fresh
        if len(slots) < n and self.pt_quarantine:
            ready = [p for p, stamp in self.pt_quarantine
                     if self.num_kfs - stamp >= 3]
            take = ready[: n - len(slots)]
            if take:
                taken = set(take)
                self.pt_quarantine = [
                    (p, st) for p, st in self.pt_quarantine if p not in taken
                ]
                slots.extend(take)
                # the tracker zeroes found/visible counters of reused slots
                self.recycled_log.extend(take)
        return np.asarray(slots, np.int64)

    def return_point_slots(self, slots):
        """Give back allocated-but-unused point slots (see
        map_state.MapGraph.return_point_slots)."""
        for s in slots:
            self.pt_quarantine.insert(0, (int(s), self.num_kfs - 3))

    # -- alive flags (mirrored) ----------------------------------------

    def set_kf_alive(self, kf: int, alive: bool):
        self.kf_alive[kf] = alive
        self._lib.mg_set_kf_alive(self._h, int(kf), int(alive))

    # -- observations ---------------------------------------------------

    def add_observation(self, pt: int, kf: int, feat: int, is_stereo: bool = False):
        self._lib.mg_add_observation(self._h, int(pt), int(kf), int(feat))
        self._obs_points.add(int(pt))
        self.kf_row[kf, feat] = pt

    def erase_observation(self, pt: int, kf: int):
        feat = int(self._lib.mg_obs_feat_in_kf(self._h, int(pt), int(kf)))
        self._lib.mg_erase_observation(self._h, int(pt), int(kf))
        if feat >= 0 and self.kf_row[kf, feat] == pt:
            self.kf_row[kf, feat] = -1

    def set_levels(self, kf: int, levels: np.ndarray):
        self.kf_levels[kf] = levels

    def n_obs(self, pt: int) -> int:
        return int(self._lib.mg_n_obs(self._h, int(pt)))

    def obs_pairs(self, pt: int) -> List:
        n = self._lib.mg_get_obs(
            self._h, int(pt), _as_i32_ptr(self._scratch_kf),
            _as_i32_ptr(self._scratch_feat), len(self._scratch_kf),
        )
        return list(zip(self._scratch_kf[:n].tolist(), self._scratch_feat[:n].tolist()))

    def obs_feat_in_kf(self, pt: int, kf: int) -> int:
        return int(self._lib.mg_obs_feat_in_kf(self._h, int(pt), int(kf)))

    def apply_fuse(self, srcs, dsts, idx_all, dst_pt_all, keep_all,
                   src_mp_all):
        """Arena-side fuse-decision application (mg_apply_fuse): ONE FFI
        call replacing the Python per-pair/per-feature loop. Returns
        (adds (kf, ft, pt), merges (src, dst chain-resolved), killed) and
        applies the kf_row mirror updates in place.

        Capacity is handled INSIDE the arena call: each item checks the
        remaining output room before mutating, so on overflow the tail is
        cleanly skipped (fusion is best-effort per keyframe; later
        keyframes retry) and everything returned is consistent — there is
        no half-applied state and no fallback re-run."""
        n_pairs = len(srcs)
        n_feat = idx_all.shape[1]
        cap = max(n_pairs * n_feat * 2, 1024)
        i32 = np.int32
        a_kf, a_ft, a_pt = (np.zeros(cap, i32) for _ in range(3))
        m_src, m_dst = np.zeros(cap, i32), np.zeros(cap, i32)
        u_kf, u_ft, u_val = (np.zeros(cap, i32) for _ in range(3))
        kl = np.zeros(cap, i32)
        counts = np.zeros(4, i32)
        rc = self._lib.mg_apply_fuse(
            self._h,
            _as_i32_ptr(np.ascontiguousarray(srcs, i32)),
            _as_i32_ptr(np.ascontiguousarray(dsts, i32)),
            n_pairs,
            _as_i32_ptr(np.ascontiguousarray(idx_all, i32)),
            _as_i32_ptr(np.ascontiguousarray(dst_pt_all, i32)),
            np.ascontiguousarray(keep_all, np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            _as_i32_ptr(np.ascontiguousarray(src_mp_all, i32)),
            n_feat,
            _as_i32_ptr(a_kf), _as_i32_ptr(a_ft), _as_i32_ptr(a_pt),
            _as_i32_ptr(counts[0:1]),
            _as_i32_ptr(m_src), _as_i32_ptr(m_dst),
            _as_i32_ptr(counts[1:2]),
            _as_i32_ptr(u_kf), _as_i32_ptr(u_ft), _as_i32_ptr(u_val),
            _as_i32_ptr(counts[2:3]),
            _as_i32_ptr(kl), _as_i32_ptr(counts[3:4]),
            cap,
        )
        if rc > 0:
            import sys

            print(f"[map-graph] fuse output capacity hit: {int(rc)} kept "
                  f"features deferred to later keyframes", file=sys.stderr)
        n_add, n_merge, n_upd, n_kill = (int(c) for c in counts)
        # mirror maintenance (the arena already updated its obs maps)
        if n_upd:
            self.kf_row[u_kf[:n_upd], u_ft[:n_upd]] = u_val[:n_upd]
        for p in a_pt[:n_add]:
            self._obs_points.add(int(p))
        for p in kl[:n_kill]:
            self._obs_points.discard(int(p))
            self.pt_quarantine.append((int(p), self.num_kfs))
        return ((a_kf[:n_add], a_ft[:n_add], a_pt[:n_add]),
                (m_src[:n_merge], m_dst[:n_merge]), kl[:n_kill])

    def refresh_export(self, mp_row: np.ndarray, min_obs: int, M: int,
                       B: int):
        """Batched observation export for refresh_points: one FFI call
        returns (pts i32[B], obs_kf i32[B,M], obs_ft i32[B,M], nob i32[B],
        count) for the alive >=min_obs points of a keyframe's row."""
        row = np.ascontiguousarray(mp_row, np.int32)
        pts = np.zeros(B, np.int32)
        okf = np.zeros((B, M), np.int32)
        oft = np.zeros((B, M), np.int32)
        nob = np.zeros(B, np.int32)
        n = self._lib.mg_refresh_export(
            self._h, _as_i32_ptr(row), len(row), int(min_obs), int(M),
            _as_i32_ptr(pts), _as_i32_ptr(okf), _as_i32_ptr(oft),
            _as_i32_ptr(nob), B,
        )
        return pts, okf, oft, nob, int(n)

    def points_with_obs(self):
        dead = [p for p in self._obs_points if self.n_obs(p) == 0]
        for p in dead:
            self._obs_points.discard(p)
        return list(self._obs_points)

    # -- covisibility ----------------------------------------------------

    def covis_weight(self, a: int, b: int) -> int:
        return int(self._lib.mg_covis_weight(self._h, int(a), int(b)))

    def covis_neighbors(self, kf: int, min_weight: int = 0, top_k: int = 0):
        n = self._lib.mg_covis_neighbors(
            self._h, int(kf), int(min_weight), int(top_k),
            _as_i32_ptr(self._scratch_kf), len(self._scratch_kf),
        )
        return self._scratch_kf[:n].tolist()

    def update_connections(self, kf: int, kf_mp_row: np.ndarray, obs_for_new=True):
        row = np.ascontiguousarray(kf_mp_row, np.int32)
        self._lib.mg_update_connections(
            self._h, int(kf), _as_i32_ptr(row), len(row), int(obs_for_new)
        )

    # -- lifecycle -------------------------------------------------------

    def note_new_point(self, pt: int, creating_kf: int):
        sq = int(self.kf_seq[creating_kf])
        self.pt_first_kf[pt] = sq
        self.young_pts.append((int(pt), sq))

    def young_points(self, cur_seq: int, max_age: int):
        # graph-level prune horizon shared by all culling rules (ADVICE r3)
        keep, out, seen = [], [], set()
        self.young_horizon = max(
            getattr(self, "young_horizon", 6), max_age + 2
        )
        horizon = self.young_horizon
        for pt, sq in self.young_pts:
            if cur_seq - sq > horizon or not self.pt_alive[pt]:
                continue
            keep.append((pt, sq))
            if cur_seq - sq <= max_age and pt not in seen:
                seen.add(pt)
                out.append(pt)
        self.young_pts = keep
        return out

    def kill_point(self, pt: int):
        if not self.pt_alive[pt]:
            return []
        n = self._lib.mg_kill_point(
            self._h, int(pt), _as_i32_ptr(self._scratch_kf),
            _as_i32_ptr(self._scratch_feat), len(self._scratch_kf),
        )
        self._obs_points.discard(int(pt))
        pairs = list(zip(self._scratch_kf[:n].tolist(),
                         self._scratch_feat[:n].tolist()))
        for kf, feat in pairs:
            if self.kf_row[kf, feat] == pt:
                self.kf_row[kf, feat] = -1
        self.pt_quarantine.append((int(pt), self.num_kfs))
        return pairs

    def kill_keyframe(self, kf: int):
        if kf == self.origin_kf:
            return
        self._lib.mg_kill_keyframe(self._h, int(kf))
        self.kf_alive[kf] = False
        self.kf_row[kf] = -1
        self.kf_quarantine.append((int(kf), self.num_kfs))

    def redundant_obs(self, kf: int, mp_row: np.ndarray, levels_all: np.ndarray):
        row = np.ascontiguousarray(mp_row, np.int32)
        lv = np.ascontiguousarray(levels_all, np.int32)
        total = ctypes.c_int32(0)
        red = self._lib.mg_redundant_obs(
            self._h, int(kf), _as_i32_ptr(row), _as_i32_ptr(lv), lv.shape[1],
            ctypes.byref(total),
        )
        return int(red), int(total.value)

    def alive_kfs(self) -> np.ndarray:
        return np.nonzero(self.kf_alive)[0]

    def alive_points(self) -> np.ndarray:
        buf = np.zeros(self.cap.max_points, np.uint8)
        self._lib.mg_fill_pt_alive(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf)
        )
        return np.nonzero(buf)[0]


class _PtAlive:
    """numpy-flavored view over the native pt_alive flags (supports the
    `graph.pt_alive[pt]`, `graph.pt_alive[pt] = x`, `.sum()` idioms)."""

    def __init__(self, g: NativeMapGraph):
        self._g = g

    def __getitem__(self, pt):
        return bool(self._g._lib.mg_pt_alive(self._g._h, int(pt)))

    def __setitem__(self, pt, v):
        self._g._lib.mg_set_pt_alive(self._g._h, int(pt), int(bool(v)))

    def sum(self):
        buf = np.zeros(self._g.cap.max_points, np.uint8)
        self._g._lib.mg_fill_pt_alive(
            self._g._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf)
        )
        return int(buf.sum())


class _FirstKf:
    def __init__(self, g: NativeMapGraph):
        self._g = g

    def __getitem__(self, pt):
        return int(self._g._lib.mg_pt_first_kf(self._g._h, int(pt)))

    def __setitem__(self, pt, v):
        self._g._lib.mg_set_pt_first_kf(self._g._h, int(pt), int(v))


class _LoopEdges:
    """dict-of-sets facade over native loop edges (read paths only need
    membership / iteration for a given kf)."""

    def __init__(self, g: NativeMapGraph):
        self._g = g

    def get(self, kf, default=None):
        n = self._g._lib.mg_loop_edges(
            self._g._h, int(kf), _as_i32_ptr(self._g._scratch_kf),
            len(self._g._scratch_kf),
        )
        s = set(self._g._scratch_kf[:n].tolist())
        return s if (s or default is None) else default

    def setdefault(self, kf, default):
        return _LoopEdgeAdder(self._g, kf)


class _LoopEdgeAdder:
    def __init__(self, g, kf):
        self._g, self._kf = g, kf

    def add(self, other):
        self._g._lib.mg_add_loop_edge(self._g._h, int(self._kf), int(other))


class _Parent:
    def __init__(self, g: NativeMapGraph):
        self._g = g

    def __getitem__(self, kf):
        return int(self._g._lib.mg_parent(self._g._h, int(kf)))

    def __setitem__(self, kf, p):
        self._g._lib.mg_set_parent(self._g._h, int(kf), int(p))
