"""Tracking stage: per-frame pose estimation over device-resident map state.

Capability analog of the reference `Tracking`
(`/root/reference/src/Tracking.cc:1188-1346`): stereo/RGB-D initialization,
motion-model tracking, local-map tracking, keyframe-need decision and
trajectory recording. Redesigned for an accelerator:

- The entire per-frame estimation (motion-model projection match -> pose LM ->
  whole-map projection match -> pose LM -> inlier stats) is ONE jitted program
  (`_track_impl`) with static shapes; the host only makes the keyframe
  decision from returned counts (no mutexes, no threads).
- "Local map" selection (`Tracking::LocalMap`, :55-185) is optional at TUM
  scale: the matcher brute-forces every live map point (masked dense
  Hamming); the covisibility window (`local_map_window`) is for large maps.
- Map insertion (`StereoInitialization` :965, `CreateMapPoints` :685) is a
  second jitted program scattering the new keyframe + unprojected landmarks
  into the SoA `MapArrays`; the sparse graph bookkeeping stays on host.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import projection as proj
from ..geometry import se3
from ..ops import matching
from ..ops.orb import OrbExtractor, OrbFeatures
from ..optim.pose_opt import pose_optimize
from ..utils.timing import StageTimer
from .frame import FrameData, scale_factors
from .map_state import INVALID, MapArrays, MapCapacity, MapGraph, empty_map

# log8 depth wire format range (see TrackerConfig.depth_encoding)
LOG8_DMIN = 0.25
LOG8_DMAX = 16.0


@dataclasses.dataclass
class TrackerConfig:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float = 0.0
    # radial-tangential lens distortion (k1, k2, p1, p2, k3) — the reference
    # undistorts every keypoint in the frontend (src/System.cc:153-174)
    dist_coeffs: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    th_depth: float = 35.0          # close/far split = bf/fx * ThDepth analog
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    map_capacity: MapCapacity = None
    mm_radius: float = 15.0         # motion-model search window (px at level 0)
    local_radius: float = 3.0       # local-map search window
    # >0: restrict map matching to points observed by the N best covisible
    # keyframes of the reference KF (Tracking::LocalMap, src/Tracking.cc:55-185,
    # reference N<=80). 0 = brute-force the whole map (meant for maps below
    # ~100k points; the window is for KITTI-scale maps).
    local_map_window: int = 0
    min_matches_mm: int = 20
    min_inliers_track: int = 10
    kf_ref_ratio: float = 0.75      # NeedNewKeyFrame ratio gate (:522 thRefRatio)
    kf_min_interval: int = 0
    kf_max_interval: int = 30
    enable_local_ba: bool = True
    # 3 LM iterations x 12 CG converge on tracked windows (the reference's
    # 5+10 g2o iterations solve from scratch each time; ours warm-start from
    # the previous BA's poses, so later iterations buy nothing)
    local_ba_iters: int = 3
    local_ba_cg_iters: int = 12
    enable_loop_closing: bool = False
    # Implicit loop closure (no reference analog — a consequence of this
    # architecture's whole-map projection matching): when a new keyframe's
    # covisibility edges reach a keyframe more than this many FRAMES older
    # that was NOT connected to the previous keyframe's context, tracking
    # has silently re-acquired a revisited region. The reference cannot hit
    # this state (its local-map matching never reconnects across drift); we
    # must treat it as a detected loop — same Sim3 verification + essential
    # graph correction — or the drifted middle of the trajectory is never
    # repaired. 0 disables. Requires enable_loop_closing.
    implicit_loop_min_gap: int = 50
    # Seam catch for the implicit loop pathway: the fused step counts how
    # many of this frame's FOUND landmarks were last seen more than
    # implicit_loop_min_gap frames ago (pt_last_seen array, one extra scalar
    # in the host pack). A spike means tracking just re-acquired a revisited
    # region — the host forces a keyframe IMMEDIATELY and runs the explicit
    # Sim3 correction while the mm-pose vs snapped-pose discrepancy is still
    # concentrated at the seam, instead of waiting for a covisibility edge
    # to form keyframes later (by then the snap has dissolved into several
    # frames' pose estimates and GBA can only partially repair the chain).
    # 0 disables. Requires enable_loop_closing.
    seam_min_reacq: int = 15
    # live-trained vocabulary size. Intended regimes:
    # 512 (default) suits single-room/short-session maps — cheap to train
    # mid-run, enough discrimination for reloc + loop gating at <=
    # a few hundred keyframes; building-scale sessions want 10k-100k
    # (tests/test_vocab_large_e2e.py runs the tracker at 100k); for
    # city-scale place recognition inject a pretrained ORBvoc-scale
    # vocabulary instead (`set_vocabulary` + `load_dbow2_text`, ~1M words
    # — the regime the reference ships, handled by the chunked quantize
    # path and the sparse KeyFrameDatabase rows).
    vocab_words: int = 512
    mono_init_min_matches: int = 100  # src/Tracking.cc:1044 (<100 resets init)
    max_new_points_per_kf: int = 350  # reference stops at 100 (src/Tracking.cc:685-743)
                                      # but also triangulates densely; 350
                                      # keeps our sparser map well-covered
    pose_opt_rounds: int = 4          # reference: 4 rounds (src/Optimizer.cc:417)
    pose_opt_iters: int = 5           # reference: 10 LM its/round; 5 converges
    pipelined: bool = False           # overlap host readback with next dispatch
    pipeline_depth: int = 2           # in-flight frames whose scalar
                                      # readback is still outstanding
    # BRIEF test-pair table: "fresh" (self-consistent, default) or "learned"
    # (the published ORB table — bit-compatible with externally trained
    # vocabularies such as the stock ORBvoc.txt)
    descriptor_pattern: str = "fresh"
    # >1: upload the depth map subsampled s x s (nearest) and sample it at
    # keypoints on device. Depth is smooth away from object boundaries, and
    # boundary outliers are culled by the chi2 gates; s=2 cuts the RGB-D
    # host->device payload from 900KB to 450KB per VGA frame.
    depth_subsample: int = 1
    # depth wire format: "f16" (2 bytes/px) or "log8" (1 byte/px log-scale,
    # 0=invalid, +-0.8% relative step over [0.25m, 16m] — well under RGB-D
    # sensor noise; every outlier is chi2-gated anyway). log8 halves the
    # depth half of the upload.
    depth_encoding: str = "f16"
    # image wire format: "raw" (1 byte/px, default) or "dct" (fixed-rate
    # 8x8-block DCT, 2 bit/px — 307 -> 77 KB at VGA, PSNR ~37 dB). The
    # codec is OPT-IN: it costs ~+1 cm ATE on the VGA bench (block-edge
    # ringing shifts keypoints half a pixel into the triangulation), and its
    # speed gain is not measured on the H100 — see ops/codec.py. Decode is
    # two batched matmuls inside the step program; encode rides the upload
    # worker pool. Requires H, W % 8 == 0.
    image_encoding: str = "raw"

    def __post_init__(self):
        if self.map_capacity is None:
            self.map_capacity = MapCapacity(
                max_keyframes=256, max_points=16384, max_features=self.n_features
            )
        # the per-frame host pack rides landmark indices through f32
        # (_make_host_pack), exact only below 2^24 — enforce, don't assume
        if self.map_capacity.max_points >= 2 ** 24:
            raise ValueError(
                f"max_points={self.map_capacity.max_points} >= 2^24: "
                "landmark ids would lose precision in the f32 host pack"
            )



def _make_host_pack(pose, vel_new, n_inl, n_mm, t_close, u_close, used_ref,
                    tcr, n_reacq, feat_mp):
    """One f32[27 + N] device->host pack per frame: scalars FOLLOWED BY the
    frame's landmark assignments (`feat_mp`, exact in f32: point capacity
    <= 2^24). Piggybacking feat_mp in the SAME transfer makes one
    device->host read per frame(-pair) instead of two."""
    return jnp.concatenate(
        [pose, vel_new,
         jnp.stack([n_inl, n_mm, t_close, u_close, used_ref]).astype(jnp.float32),
         tcr, n_reacq.astype(jnp.float32)[None],
         feat_mp.astype(jnp.float32)]
    )


class _RowFut:
    """Future-shaped view of one row of a batched pack fetch (see
    Tracker._flush_deferred_packs)."""

    __slots__ = ("_fut", "_row")

    def __init__(self, fut, row: int):
        self._fut = fut
        self._row = row

    def done(self):
        return self._fut.done()

    def result(self):
        return self._fut.result()[self._row]


class _Resolved:
    """Future-shaped wrapper around an already-materialized value."""

    def __init__(self, v):
        self._v = v

    def done(self):
        return True

    def result(self):
        return self._v


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


def _make_graph(cap: MapCapacity):
    """Sparse-graph backend: the native C++ arena (observations, covisibility,
    spanning tree — see native/map_graph.cpp), built from source at first
    use. `TPU_SLAM_NATIVE_GRAPH=0` selects the pure-Python MapGraph; a native
    library that fails to build or load raises."""
    if os.environ.get("TPU_SLAM_NATIVE_GRAPH", "1") == "0":
        return MapGraph(cap)
    from ..native import NativeMapGraph

    return NativeMapGraph(cap)


class Tracker:
    """Host-orchestrated tracking over jitted device programs (RGB-D/stereo)."""

    def __init__(self, cfg: TrackerConfig):
        self.cfg = cfg
        self.cam = proj.CameraIntrinsics.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf)
        # lens distortion: keypoints are undistorted right after extraction
        # (UndistortKeyPoints, src/System.cc:153-174); the frustum gate uses
        # the undistorted image bounds (ComputeImageBounds, :177-195)
        self._has_dist = any(float(c) != 0.0 for c in cfg.dist_coeffs)
        self.dist = proj.DistCoeffs.create(*cfg.dist_coeffs)
        if self._has_dist:
            self.image_bounds = proj.image_bounds_np(
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist_coeffs,
                cfg.width, cfg.height,
            )
        else:
            self.image_bounds = (0.0, float(cfg.width), 0.0, float(cfg.height))
        self.extractor = OrbExtractor(
            cfg.height, cfg.width, cfg.n_features, cfg.scale_factor,
            cfg.n_levels, cfg.ini_th_fast, cfg.min_th_fast,
            pattern=cfg.descriptor_pattern,
        )
        self.sf, self.sigma2, self.inv_sigma2 = scale_factors(
            cfg.n_levels, cfg.scale_factor
        )
        self.map = empty_map(cfg.map_capacity)
        self.graph = _make_graph(cfg.map_capacity)
        # device-resident found/visible counters (MapPoint statistics,
        # src/MapPoint.cc:322-339) — incremented inside the fused track
        # program, read back only at point-culling time
        P = cfg.map_capacity.max_points
        self.mp_vis_dev = jnp.zeros((P,), jnp.int32)
        self.mp_found_dev = jnp.zeros((P,), jnp.int32)
        # last tracked-frame index each landmark was FOUND (seam detection;
        # -1 = never). Lives with a device frame counter so no per-frame
        # host->device scalar transfer is needed.
        self.mp_seen_dev = jnp.full((P,), -1, jnp.int32)
        self.fidx_dev = jnp.int32(0)
        # covisibility-window point mask (all-true = whole-map matching)
        self.local_mask_dev = jnp.ones((P,), bool)
        self.state = TrackState.NOT_INITIALIZED
        if cfg.enable_local_ba:
            from .local_mapping import LocalMapper

            self.local_mapper = LocalMapper(
                self.cam, cfg.n_levels, cfg.scale_factor,
                ba_iters=cfg.local_ba_iters, cg_iters=cfg.local_ba_cg_iters,
            )
        else:
            self.local_mapper = None
        self.last_ba_info = None
        # loop closer is created lazily at the first keyframe (the vocabulary
        # trains on live descriptors; a pre-trained one can be injected via
        # set_vocabulary before the first frame)
        self.loop_closer = None
        self.vocabulary = None
        self.last_loop_info = None
        self._gba_pending = None
        self._map_job = None  # in-flight local-mapping job: (kf_slot, stage)
        self._pending_insert = None  # async KF-insert pack awaiting drain
        self._loop_pending = None    # async loop-detection scores
        # worker threads for per-frame scalar-pack fetches (device->host
        # transfers release the GIL; the frame loop keeps dispatching).
        # Several workers let several blocking reads wait at once; futures
        # keep per-frame ordering and each fetch targets a distinct array,
        # so the worker count does not affect results.
        self._fetch_pool = ThreadPoolExecutor(
            int(os.environ.get("TPU_SLAM_FETCH_THREADS", "3")),
            "track-fetch")

        self.pose = np.asarray(se3.identity())
        self.velocity = np.asarray(se3.identity())
        self.pose_dev = jnp.asarray(self.pose)
        self.velocity_dev = jnp.asarray(self.velocity)
        self.last_frame: Optional[FrameData] = None
        self.last_mp: Optional[np.ndarray] = None
        self.last_mp_dev = None
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self._ref_mp_row = None
        self.frames_since_kf = 0
        self.frame_id = 0
        self.trajectory: List[np.ndarray] = []
        # per-frame Tcr-relative records for loop/GBA-corrected export
        # (reference Trajectory, include/Tracking.h:43-52): one entry per
        # tracked frame, aligned with `trajectory`
        self.traj_entries: List[dict] = []
        self.track_info: List[dict] = []
        self.timer = StageTimer()

        self._build_jit_programs()
        self._mono_ref: Optional[FrameData] = None

    def _build_jit_programs(self):
        """(Re)wrap the impl methods in fresh jax.jit objects. Called from
        __init__ and from change_calibration — intrinsics are baked into the
        compiled programs as constants, so a calibration swap must re-trace."""
        self._prepare = jax.jit(self._prepare_impl)
        self._prepare_packed = jax.jit(
            lambda buf: self._prepare_impl(*self._unpack_impl(buf))
        )
        self._prepare_stereo = jax.jit(self._prepare_stereo_impl)
        self._prepare_stereo_packed = jax.jit(
            lambda buf: self._prepare_stereo_impl(
                *self._unpack_stereo_impl(buf))
        )
        self._track = jax.jit(self._track_impl)
        self._step = jax.jit(self._step_impl)
        self._step_packed = jax.jit(
            lambda buf, *rest: self._step_impl(*self._unpack_impl(buf), *rest)
        )
        self._step2_packed = jax.jit(
            lambda buf_a, buf_b, *rest: self._step2_impl(
                self._unpack_impl(buf_a), self._unpack_impl(buf_b), *rest)
        )
        # fused pair step sliced from a [k, B] batched upload (jit
        # re-specializes per batch shape k): frames i and i+1 of the batch
        # in one dispatch
        self._step2_from_batch = jax.jit(
            lambda b, i, *rest: self._step2_impl(
                self._unpack_impl(jax.lax.dynamic_index_in_dim(
                    b, i, axis=0, keepdims=False)),
                self._unpack_impl(jax.lax.dynamic_index_in_dim(
                    b, i + 1, axis=0, keepdims=False)),
                *rest)
        )
        # k-frame chained step from k separately-uploaded buffers
        # (jit re-specializes per k via the tuple arity)
        self._stepk_packed = jax.jit(
            lambda bufs, *rest: self._stepk_impl(
                [self._unpack_impl(b) for b in bufs], *rest)
        )
        # chained quad sliced from a [k, B] batched upload: ONE dispatch
        # + one stacked pack fetch per FOUR frames of the batch
        self._step4_from_batch = jax.jit(
            lambda b, i, *rest: self._stepk_impl(
                [self._unpack_impl(jax.lax.dynamic_index_in_dim(
                    b, i + j, axis=0, keepdims=False)) for j in range(4)],
                *rest)
        )
        self._step_stereo = jax.jit(self._step_stereo_impl)
        self._step_stereo_packed = jax.jit(
            lambda buf, *rest: self._step_stereo_impl(
                *self._unpack_stereo_impl(buf), *rest)
        )
        self._step2_stereo_packed = jax.jit(
            lambda buf_a, buf_b, *rest: self._step2_stereo_impl(
                self._unpack_stereo_impl(buf_a),
                self._unpack_stereo_impl(buf_b), *rest)
        )
        # k-frame chained stereo step (stereo mirror of _stepk_packed)
        self._stepk_stereo_packed = jax.jit(
            lambda bufs, *rest: self._stepk_stereo_impl(
                [self._unpack_stereo_impl(b) for b in bufs], *rest)
        )
        self._insert_kf = jax.jit(self._insert_kf_impl, donate_argnums=(0,))
        self._insert_kf_auto = jax.jit(
            self._insert_kf_auto_impl, donate_argnums=(0,)
        )
        self._reloc_match = jax.jit(self._reloc_match_impl)
        self._prepare_mono = jax.jit(self._prepare_mono_impl)
        self._mono_match = jax.jit(self._mono_match_impl)
        self._mono_init = None  # built lazily (imports initializer)

    def change_calibration(self, fx: float, fy: float, cx: float, cy: float,
                           bf: Optional[float] = None, dist_coeffs=None):
        """System::ChangeCalibration analog
        (`/root/reference/src/System.cc:869-875`): swap the camera model
        mid-session. The map and trajectory survive; the per-frame programs
        re-trace on next use (intrinsics are compile-time constants)."""
        cfg = self.cfg
        cfg.fx, cfg.fy, cfg.cx, cfg.cy = fx, fy, cx, cy
        # a half-done monocular initialization holds a reference frame
        # captured under the OLD intrinsics — matching/triangulating it
        # against new-intrinsics frames would be inconsistent (ADVICE r3)
        self._mono_ref = None
        if bf is not None:
            cfg.bf = bf
        if dist_coeffs is not None:
            cfg.dist_coeffs = tuple(dist_coeffs)
        self.cam = proj.CameraIntrinsics.create(cfg.fx, cfg.fy, cfg.cx,
                                                cfg.cy, cfg.bf)
        self._has_dist = any(float(c) != 0.0 for c in cfg.dist_coeffs)
        self.dist = proj.DistCoeffs.create(*cfg.dist_coeffs)
        if self._has_dist:
            self.image_bounds = proj.image_bounds_np(
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist_coeffs,
                cfg.width, cfg.height,
            )
        else:
            self.image_bounds = (0.0, float(cfg.width), 0.0,
                                 float(cfg.height))
        if self.local_mapper is not None:
            # the mapper's compiled programs also baked the old intrinsics:
            # drain its in-flight products, then rebuild it fresh
            self._finalize_map()
            from .local_mapping import LocalMapper

            self.local_mapper = LocalMapper(
                self.cam, cfg.n_levels, cfg.scale_factor,
                ba_iters=cfg.local_ba_iters, cg_iters=cfg.local_ba_cg_iters,
            )
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.cam = self.cam
            lc._match_kfs = jax.jit(lc._match_kfs_impl)
            lc._sim3_refine = jax.jit(lc._sim3_refine_impl)
            lc._gba = jax.jit(lc._gba_impl)
        self._build_jit_programs()

    # ------------------------------------------------------------------
    # jitted programs
    # ------------------------------------------------------------------

    def _packed_depth_hw(self) -> Tuple[int, int]:
        s = self.cfg.depth_subsample
        return -(-self.cfg.height // s), -(-self.cfg.width // s)

    def _packed_img_nbytes(self) -> int:
        if self.cfg.image_encoding == "dct":
            from ..ops import codec
            return codec.encoded_nbytes(self.cfg.height, self.cfg.width)
        return self.cfg.height * self.cfg.width

    def _pack_rgbd(self, img: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """Pack (gray image, f16 subsampled depth) into ONE uint8 buffer.

        One upload per frame instead of two, and host gray conversion cuts
        an RGB driver's payload 3x. The device side unpacks with a bitcast —
        zero-copy in XLA."""
        img = np.asarray(img)
        if img.ndim == 3:  # ConvertToGray on host (src/System.cc:122-151)
            img = (img.astype(np.float32) @
                   np.array([0.299, 0.587, 0.114], np.float32))
        if self.cfg.image_encoding == "dct":
            # fixed-rate 8x8-DCT wire format (2 bit/px; see ops/codec.py):
            # the gray image dominates the payload, and the encode (batched
            # BLAS, GIL-free) rides the upload worker pool
            from ..ops import codec
            img = codec.encode_dct(np.ascontiguousarray(img, np.uint8))
        else:
            img = np.ascontiguousarray(img, np.uint8)
        s = self.cfg.depth_subsample
        depth = np.asarray(depth)
        if s > 1 and depth.shape[0] == self.cfg.height:
            depth = depth[::s, ::s]
        hw = img.size
        if self.cfg.depth_encoding == "log8":
            d = depth.astype(np.float32)
            q = np.zeros(d.shape, np.uint8)
            # depths beyond the code range are INVALID (0), not clamped:
            # a far wall clamped into 16 m would yield systematically wrong
            # landmark positions; the reference likewise excludes far
            # structure via its depth threshold (ThDepth gate,
            # src/Tracking.cc:695-706). ADVICE r3.
            pos = (d > 0) & (d <= LOG8_DMAX)
            scale = 254.0 / np.log(LOG8_DMAX / LOG8_DMIN)
            enc = np.log(np.clip(d[pos], LOG8_DMIN, LOG8_DMAX)
                         / LOG8_DMIN) * scale
            q[pos] = np.clip(np.rint(enc), 0, 254).astype(np.uint8) + 1
            buf = np.empty(hw + q.size, np.uint8)
            buf[:hw] = img.reshape(-1)
            buf[hw:] = q.reshape(-1)
            return buf
        dep = np.ascontiguousarray(depth, np.float16)
        buf = np.empty(hw + dep.size * 2, np.uint8)
        buf[:hw] = img.reshape(-1)
        buf[hw:] = dep.view(np.uint8).reshape(-1)
        return buf

    def _unpack_impl(self, buf):
        """Device-side unpack of `_pack_rgbd` (bitcast / log- / DCT-decode)."""
        H, W = self.cfg.height, self.cfg.width
        h, w = self._packed_depth_hw()
        ib = self._packed_img_nbytes()
        if self.cfg.image_encoding == "dct":
            from ..ops import codec
            img = codec.decode_dct(buf[:ib], H, W)  # two batched matmuls
        else:
            img = buf[:ib].reshape(H, W)
        if self.cfg.depth_encoding == "log8":
            q = buf[ib: ib + h * w].reshape(h, w)
            step = float(np.log(LOG8_DMAX / LOG8_DMIN) / 254.0)
            dep = jnp.where(
                q > 0,
                LOG8_DMIN * jnp.exp((q.astype(jnp.float32) - 1.0) * step),
                0.0,
            )
            return img, dep
        dep = jax.lax.bitcast_convert_type(
            buf[ib : ib + h * w * 2].reshape(h, w, 2), jnp.float16
        )
        return img, dep

    def _prepare_impl(self, img, depth_img) -> FrameData:
        """Extract ORB + associate depth (ComputeStereoFromRGBD analog,
        `/root/reference/src/System.cc:197-219`). Accepts uint8/float images
        and f16/f32 depth (casts in-graph, so the upload stays small)."""
        depth_img = depth_img.astype(jnp.float32)
        feats: OrbFeatures = self.extractor._extract_impl(img)
        # depth sampled at the RAW keypoint (the depth map shares the RGB
        # distortion); u_right from the UNDISTORTED x — exactly the
        # reference's ComputeStereoFromRGBD (src/System.cc:197-219)
        xi = jnp.clip(jnp.round(feats.xy[:, 0]).astype(jnp.int32), 0, self.cfg.width - 1)
        yi = jnp.clip(jnp.round(feats.xy[:, 1]).astype(jnp.int32), 0, self.cfg.height - 1)
        s = self.cfg.depth_subsample
        if s > 1:  # depth arrives subsampled s x s (see TrackerConfig)
            d = depth_img[
                jnp.minimum(yi // s, depth_img.shape[0] - 1),
                jnp.minimum(xi // s, depth_img.shape[1] - 1),
            ]
        else:
            d = depth_img[yi, xi]
        has_d = d > 1e-3
        xy_und = (proj.undistort_points(self.cam, self.dist, feats.xy)
                  if self._has_dist else feats.xy)
        u_right = jnp.where(has_d, xy_und[:, 0] - self.cfg.bf / jnp.maximum(d, 1e-3), -1.0)
        return FrameData(
            xy=xy_und,
            xy_raw=feats.xy,
            level=feats.level,
            angle=feats.angle,
            response=feats.response,
            desc=feats.desc,
            u_right=u_right,
            depth=jnp.where(has_d, d, -1.0),
            valid=feats.valid,
        )

    def _pack_stereo(self, img_l: np.ndarray, img_r: np.ndarray) -> np.ndarray:
        """Pack a rectified L/R pair into ONE uint8 wire buffer — the stereo
        mirror of `_pack_rgbd`. Gray conversion happens on host
        (ConvertToGray, `/root/reference/src/System.cc:445-446`); optional
        DCT wire coding applies to both images."""
        bufs = []
        for img in (img_l, img_r):
            img = self._pack_mono(img)  # shared 8-bit wire quantization
            if self.cfg.image_encoding == "dct":
                from ..ops import codec
                img = codec.encode_dct(img)
            bufs.append(img.reshape(-1))
        return np.concatenate(bufs)

    def _unpack_stereo_impl(self, buf):
        """Device-side unpack of `_pack_stereo`."""
        H, W = self.cfg.height, self.cfg.width
        ib = self._packed_img_nbytes()
        if self.cfg.image_encoding == "dct":
            from ..ops import codec
            return (codec.decode_dct(buf[:ib], H, W),
                    codec.decode_dct(buf[ib: 2 * ib], H, W))
        return buf[:ib].reshape(H, W), buf[ib: 2 * ib].reshape(H, W)

    def _step2_stereo_impl(self, unpacked_a, unpacked_b, last, last_mp, m,
                           pose_last, velocity, ref_kf, mp_vis, mp_found,
                           local_mask, mp_seen, fidx):
        """TWO chained stereo tracking steps in ONE compiled program — the
        stereo mirror of `_step2_impl` (one dispatch per pair, and the
        same near-equivalence caveat: frame b sees map state at most one
        finalize staler than the per-frame path). The k=2 case of
        `_stepk_stereo_impl`, flattened to the legacy pair tuple."""
        outs, packs, mp_vis, mp_found, mp_seen, fidx = \
            self._stepk_stereo_impl(
                [unpacked_a, unpacked_b], last, last_mp, m, pose_last,
                velocity, ref_kf, mp_vis, mp_found, local_mask, mp_seen,
                fidx)
        (f1, pose1, vel1, fmp1), (f2, pose2, vel2, fmp2) = outs
        return (f1, pose1, vel1, fmp1, f2, pose2, vel2, fmp2,
                packs, mp_vis, mp_found, mp_seen, fidx)

    def _stepk_stereo_impl(self, unpacked_list, last, last_mp, m, pose_last,
                           velocity, ref_kf, mp_vis, mp_found, local_mask,
                           mp_seen, fidx):
        """k chained STEREO steps in one program (mirror of `_stepk_impl`)."""
        outs = []
        packs = []
        f, fmp, pose, vel = last, last_mp, pose_last, velocity
        for u in unpacked_list:
            (f, pose, vel, fmp, pack, mp_vis, mp_found, mp_seen, fidx) = \
                self._step_stereo_impl(*u, f, fmp, m, pose, vel, ref_kf,
                                       mp_vis, mp_found, local_mask,
                                       mp_seen, fidx)
            outs.append((f, pose, vel, fmp))
            packs.append(pack)
        return (outs, jnp.stack(packs), mp_vis, mp_found, mp_seen, fidx)

    def track_stereo_chain_uploaded(self, bufs, timestamps=None):
        """Track k stereo pairs via the chained program — one dispatch
        + one stacked pack fetch per k frames (stereo mirror of
        `track_rgbd_chain_uploaded`, same staleness caveat)."""
        k = len(bufs)
        if timestamps is None:
            timestamps = [0.0] * k
        if not (self.cfg.pipelined and self.state == TrackState.OK
                and k >= 2):
            for b, ts in zip(bufs, timestamps):
                self.track_stereo_uploaded(b, ts)
            return self.pose
        return self._run_chain(
            lambda: self._stepk_stereo_packed(
                tuple(bufs),
                self.last_frame, self.last_mp_dev, self.map,
                self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                self.mp_seen_dev, self.fidx_dev,
            ),
            timestamps,
        )

    def _prepare_stereo_impl(self, img_l, img_r) -> FrameData:
        """L/R extraction (the reference forks two threads,
        `/root/reference/src/System.cc:449-452`; here the two extraction
        subgraphs are traced one after the other in one program, and XLA
        schedules them. A vmapped camera axis, and a variant that vmapped
        only the pyramid and FAST stages, were both slower on the former
        accelerator; neither is measured on the H100) + row-banded stereo
        association
        (`src/ORBmatcher.cc:72-247`). The extractor's own pyramids feed the
        SAD refinement — no rebuild."""
        from ..ops.stereo import refine_subpixel_pyramid, stereo_match

        lf, pyr_l = self.extractor._extract_impl_pyr(img_l)
        rf, pyr_r = self.extractor._extract_impl_pyr(img_r)
        u_right, depth, ok = stereo_match(
            lf.xy, lf.level, lf.desc, lf.valid,
            rf.xy, rf.level, rf.desc, rf.valid,
            self.sf, self.cfg.bf, min_z=self.cfg.bf / self.cfg.fx,
        )
        # SAD refinement at each keypoint's OWN pyramid level (reference
        # ComputeStereoMatches octave semantics, src/ORBmatcher.cc:163-228)
        u_right, depth, ok = refine_subpixel_pyramid(
            pyr_l, pyr_r, lf.xy, lf.level, u_right, ok, self.cfg.bf, self.sf
        )
        # stereo input is assumed rectified (reference requirement); when
        # distortion coeffs are nonetheless given, undistort like the
        # reference's unconditional UndistortKeyPoints (u_right stays in the
        # raw rectified frame, matching ComputeStereoMatches semantics)
        xy_und = (proj.undistort_points(self.cam, self.dist, lf.xy)
                  if self._has_dist else lf.xy)
        return FrameData(
            xy=xy_und, xy_raw=lf.xy, level=lf.level, angle=lf.angle,
            response=lf.response, desc=lf.desc,
            u_right=u_right, depth=depth, valid=lf.valid,
        )

    def _seam_stats(self, found_mask, mp_seen, fidx):
        """Count re-acquired OLD landmarks (found now, last found more than
        implicit_loop_min_gap tracked frames ago) and advance the last-seen
        array — the seam-detection signal (see TrackerConfig.seam_min_reacq)."""
        gap = max(int(self.cfg.implicit_loop_min_gap), 1)
        old = found_mask & (mp_seen >= 0) & ((fidx - mp_seen) > gap)
        n_reacq = jnp.sum(old.astype(jnp.int32))
        mp_seen_new = jnp.where(found_mask, fidx, mp_seen)
        return n_reacq, mp_seen_new, fidx + 1

    def _step_stereo_impl(
        self, img_l, img_r, last: FrameData, last_mp, m: MapArrays,
        pose_last, velocity, ref_kf, mp_vis, mp_found, local_mask,
        mp_seen, fidx,
    ):
        frame = self._prepare_stereo_impl(img_l, img_r)
        (pose, feat_mp, n_inl, n_mm, t_close, u_close, used_ref,
         found_mask, vis_mask, tcr) = self._track_impl(
            frame, last, last_mp, m, pose_last, velocity, ref_kf, local_mask,
            fidx,
        )
        vel_new = se3.compose(pose, se3.inverse(pose_last))
        n_reacq, mp_seen, fidx = self._seam_stats(found_mask, mp_seen, fidx)
        host_pack = _make_host_pack(pose, vel_new, n_inl, n_mm, t_close,
                                    u_close, used_ref, tcr, n_reacq, feat_mp)
        return (frame, pose, vel_new, feat_mp, host_pack,
                mp_vis + vis_mask, mp_found + found_mask, mp_seen, fidx)

    def _prepare_mono_impl(self, img) -> FrameData:
        feats: OrbFeatures = self.extractor._extract_impl(img)
        n = feats.xy.shape[0]
        xy_und = (proj.undistort_points(self.cam, self.dist, feats.xy)
                  if self._has_dist else feats.xy)
        return FrameData(
            xy=xy_und, xy_raw=feats.xy, level=feats.level, angle=feats.angle,
            response=feats.response, desc=feats.desc,
            u_right=-jnp.ones((n,), jnp.float32),
            depth=-jnp.ones((n,), jnp.float32),
            valid=feats.valid,
        )

    def _mono_match_impl(self, curr: FrameData, ref: FrameData):
        """SearchForInitialization analog (`src/ORBmatcher.cc:614`): windowed
        descriptor matching (100 px) with rotation consistency."""
        d2 = jnp.sum((ref.xy[:, None, :] - curr.xy[None, :, :]) ** 2, -1)
        win = d2 <= 100.0 ** 2
        mm = matching.match_descriptors(
            ref.desc, curr.desc, ref.valid, curr.valid,
            max_dist=50, nn_ratio=0.9, extra_mask=win,
        )
        keep = matching.rotation_consistency(
            ref.angle,
            jnp.where(mm.idx >= 0, curr.angle[jnp.clip(mm.idx, 0, curr.capacity - 1)], 0.0),
            mm.valid,
        )
        return mm.idx, keep

    def _track_impl(
        self,
        frame: FrameData,
        last: FrameData,
        last_mp,
        m: MapArrays,
        pose_last,
        velocity,
        ref_kf,
        local_mask,
        fidx=None,
    ):
        cfg = self.cfg
        pred = se3.compose(velocity, pose_last)
        # RANSAC key varies per frame: a fixed key replays the identical
        # hypothesis set every attempt, so a geometry that defeats that one
        # sample sequence would defeat it forever
        rkey = jax.random.PRNGKey(0) if fidx is None \
            else jax.random.fold_in(jax.random.PRNGKey(0), fidx)

        # ---- 1a. motion-model matching against last frame's landmarks ----
        lm_idx = jnp.clip(last_mp, 0, m.point_capacity - 1)
        lm_pos = m.mp_pos[lm_idx]
        lm_ok = (last_mp >= 0) & m.mp_valid[lm_idx]
        mm = matching.search_last_frame(
            frame.xy, frame.level, frame.desc, frame.valid,
            last.xy, last.level, last.desc, lm_ok,
            lm_ok, lm_pos, pred, self.cam, self.sf,
            radius=cfg.mm_radius,
        )
        keep = matching.rotation_consistency(
            last.angle,
            jnp.where(mm.idx >= 0, frame.angle[jnp.clip(mm.idx, 0, frame.capacity - 1)], 0.0),
            mm.valid,
        )
        midx = jnp.clip(mm.idx, 0, frame.capacity - 1)
        n_mm = jnp.sum(keep.astype(jnp.int32))
        # per-frame-feature landmark assignment from the motion model
        feat_pt_mm = jnp.full((frame.capacity,), INVALID, jnp.int32).at[midx].max(
            jnp.where(keep, last_mp, INVALID)
        )

        # ---- 1b. TrackReferenceKeyFrame fallback (src/Tracking.cc:257-282,
        # selected at :800-829): when motion-model matching starves (fast
        # rotation, velocity jump), match descriptors against the reference
        # keyframe's landmarks with no spatial window and start LM from the
        # LAST pose instead of the constant-velocity prediction. Both paths
        # are computed in-graph; a scalar predicate selects.
        ref_mp = m.kf_mp[ref_kf]
        ref_ok = (
            (ref_mp >= 0) & m.kf_feat_valid[ref_kf]
            & m.mp_valid[jnp.clip(ref_mp, 0, m.point_capacity - 1)]
        )
        mref = matching.match_descriptors(
            frame.desc, m.kf_desc[ref_kf], frame.valid, ref_ok,
            max_dist=50, nn_ratio=0.7,
        )
        ridx = jnp.clip(mref.idx, 0, ref_mp.shape[0] - 1)
        keep_ref = matching.rotation_consistency(
            frame.angle,
            jnp.where(mref.idx >= 0, m.kf_angle[ref_kf][ridx], 0.0),
            mref.valid,
        )
        feat_pt_ref = jnp.where(keep_ref, ref_mp[ridx], INVALID)

        inv_s2_feat = self.inv_sigma2[frame.level]
        has_mm = feat_pt_mm >= 0
        # provisional estimate: 2 chi2 rounds suffice — the whole-map match
        # + full 4-round LM below (r2) carries the final accuracy (the
        # reference runs 4 rounds in BOTH passes, src/Optimizer.cc:417, but
        # its second pass starts from scratch; ours warm-starts from r1)
        r1_mm = pose_optimize(
            pred, m.mp_pos[jnp.clip(feat_pt_mm, 0, m.point_capacity - 1)],
            frame.xy, frame.u_right, inv_s2_feat, has_mm, self.cam,
            rounds=min(cfg.pose_opt_rounds, 2),
            iters_per_round=cfg.pose_opt_iters,
        )
        # fallback fires on starved matches OR starved post-opt inliers
        # (TrackWithMotionModel fails on nmatches<20 and on <10 inliers
        # after PoseOptimization — src/Tracking.cc:236,249-254)
        use_ref = (n_mm < cfg.min_matches_mm) | (r1_mm.num_inliers < 10)

        has_ref = feat_pt_ref >= 0
        pts_ref = m.mp_pos[jnp.clip(feat_pt_ref, 0, m.point_capacity - 1)]

        def run_ref(_):
            # Windowless descriptor matches carry ~30-40% aliased outliers
            # with huge residuals — plain LM from a far-off pose diverges, so
            # seed the pose with RANSAC first (the reference's relocalizer
            # does the same with EPnP, src/Tracking.cc:349-441).
            from ..solvers.ransac import horn_ransac, pnp_ransac

            if cfg.bf > 0:
                # RGB-D/stereo: 3D-3D Horn on (landmark, unprojected-depth)
                # pairs — closed-form and planar-safe, where a 2D-3D DLT
                # resection degenerates when the visible landmarks are
                # coplanar (one wall after a violent rotation)
                xc_cur = proj.unproject(
                    self.cam, frame.xy, jnp.maximum(frame.depth, 1e-3)
                )
                ok3d = has_ref & (frame.depth > 0)
                res = horn_ransac(
                    pts_ref, xc_cur, ok3d, rkey,
                    with_scale=False, inlier_th=0.05, min_inliers=10,
                )
            else:
                res = pnp_ransac(
                    pts_ref, frame.xy, has_ref, self.cam,
                    rkey, n_iters=256, sample_size=8,
                )
            pose_seed = jnp.where(res.success, res.pose, pose_last)
            # LM over the RANSAC inlier set only: gross aliased outliers
            # (~30-40%) overpower the Huber kernel before the first chi2
            # reclassification and drag the pose away from a good seed
            seed_ok = jnp.where(res.success, res.inliers & has_ref, has_ref)
            r = pose_optimize(
                pose_seed, pts_ref, frame.xy, frame.u_right,
                inv_s2_feat, seed_ok, self.cam,
                rounds=cfg.pose_opt_rounds, iters_per_round=cfg.pose_opt_iters,
            )
            return r.pose, r.inliers

        def keep_mm(_):
            return r1_mm.pose, r1_mm.inliers

        pose1, inl1 = jax.lax.cond(use_ref, run_ref, keep_mm, None)

        class _R1:  # lightweight view matching the r1 uses below
            pose = pose1
            inliers = inl1
        r1 = _R1

        # ---- 2. whole-map projection matching (local-map tracking) ----
        feat_pt0 = jnp.where(use_ref, feat_pt_ref, feat_pt_mm)
        taken = (feat_pt0 >= 0) & r1.inliers
        feat_mp = jnp.where(taken, feat_pt0, INVALID)
        lm, pt_vis = matching.search_by_projection_with_vis(
            frame.xy, frame.level, frame.desc, frame.valid & ~taken,
            m.mp_pos, m.mp_desc, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
            m.mp_valid & local_mask, r1.pose, self.cam, self.sf,
            # after a fallback the pose is coarser: widen the window like
            # the reference's post-relocalization search (radius 10,
            # src/ORBmatcher.cc reloc overload / src/Tracking.cc:441)
            radius=jnp.where(use_ref, 10.0, cfg.local_radius),
            image_bounds=self.image_bounds,
        )
        # per-point match -> per-feature assignment
        pidx = jnp.clip(lm.idx, 0, frame.capacity - 1)
        feat_mp = feat_mp.at[pidx].max(
            jnp.where(lm.valid, jnp.arange(m.point_capacity, dtype=jnp.int32), INVALID)
        )

        # ---- 3. final pose refinement over every assigned landmark ----
        has_mp = feat_mp >= 0
        fp = jnp.clip(feat_mp, 0, m.point_capacity - 1)
        pts = m.mp_pos[fp]
        r2 = pose_optimize(
            r1.pose, pts, frame.xy, frame.u_right,
            self.inv_sigma2[frame.level], has_mp, self.cam,
            rounds=cfg.pose_opt_rounds, iters_per_round=cfg.pose_opt_iters,
        )
        inl = r2.inliers & has_mp
        feat_mp_final = jnp.where(inl, feat_mp, INVALID)

        # ---- 4. stats for the keyframe decision ----
        close = frame.depth > 0
        close = close & (frame.depth < (cfg.bf / cfg.fx) * cfg.th_depth)
        tracked_close = jnp.sum((inl & close).astype(jnp.int32))
        untracked_close = jnp.sum((close & ~inl & frame.valid).astype(jnp.int32))
        # found/visible statistics (MapPoint::IncreaseVisible/IncreaseFound,
        # src/MapPoint.cc:322-339): found = landmark kept an inlier feature
        # this frame; visible = passed the frustum gate (or was found)
        found_mask = jnp.zeros((m.point_capacity,), bool).at[
            jnp.clip(feat_mp_final, 0, m.point_capacity - 1)
        ].max(feat_mp_final >= 0)
        vis_mask = pt_vis | found_mask
        # reference-KF-relative pose (Tcr): trajectory entries store Tcr and
        # compose with the (BA/loop-corrected) reference pose at save time
        # (src/Tracking.cc:1331-1343, src/System.cc:690-747)
        tcr = se3.compose(r2.pose, se3.inverse(m.kf_pose[ref_kf]))
        return (
            r2.pose,
            feat_mp_final,
            r2.num_inliers,
            n_mm,
            tracked_close,
            untracked_close,
            use_ref.astype(jnp.int32),
            found_mask,
            vis_mask,
            tcr,
        )

    def _step_impl(
        self, img, depth_img, last: FrameData, last_mp, m: MapArrays,
        pose_last, velocity, ref_kf, mp_vis, mp_found, local_mask,
        mp_seen, fidx,
    ):
        """Fused per-frame program: extract + depth-associate + track.

        One dispatch, one scalar pack back to host — the whole per-frame
        tracking hot path lives in a single compiled program (the analog
        of the reference's TrackStereo/TrackRGBD frontends + Tracking::Update,
        `/root/reference/src/System.cc:430-543` + `src/Tracking.cc:1188-1346`).
        """
        frame = self._prepare_impl(img, depth_img)
        (pose, feat_mp, n_inl, n_mm, t_close, u_close, used_ref,
         found_mask, vis_mask, tcr) = self._track_impl(
            frame, last, last_mp, m, pose_last, velocity, ref_kf, local_mask,
            fidx,
        )
        vel_new = se3.compose(pose, se3.inverse(pose_last))
        n_reacq, mp_seen, fidx = self._seam_stats(found_mask, mp_seen, fidx)
        host_pack = _make_host_pack(pose, vel_new, n_inl, n_mm, t_close,
                                    u_close, used_ref, tcr, n_reacq, feat_mp)
        return (frame, pose, vel_new, feat_mp, host_pack,
                mp_vis + vis_mask, mp_found + found_mask, mp_seen, fidx)

    def _step2_impl(self, unpacked_a, unpacked_b, last, last_mp, m,
                    pose_last, velocity, ref_kf, mp_vis, mp_found,
                    local_mask, mp_seen, fidx):
        """TWO chained tracking steps in ONE compiled program.

        Frame b is tracked against frame a's in-graph outputs (pose,
        velocity, feature assignments) exactly as the software pipeline
        would feed them — but with one dispatch and one stacked
        scalar-pack fetch for the pair instead of two of each.
        Semantics match back-to-back `_step_impl` calls with no host
        intervention between them; keyframe decisions already lag
        `pipeline_depth` frames (the reference's mapping thread lagged
        tracking too, `/root/reference/src/System.cc:398-411`), and the
        map/local-mask inputs both frames see are at most one frame
        staler than the per-frame path's. Implemented as the k=2 case of
        `_stepk_impl`, flattened to the legacy pair tuple."""
        outs, packs, mp_vis, mp_found, mp_seen, fidx = self._stepk_impl(
            [unpacked_a, unpacked_b], last, last_mp, m, pose_last,
            velocity, ref_kf, mp_vis, mp_found, local_mask, mp_seen, fidx)
        (f1, pose1, vel1, fmp1), (f2, pose2, vel2, fmp2) = outs
        return (f1, pose1, vel1, fmp1, f2, pose2, vel2, fmp2,
                packs, mp_vis, mp_found, mp_seen, fidx)

    def _stepk_impl(self, unpacked_list, last, last_mp, m, pose_last,
                    velocity, ref_kf, mp_vis, mp_found, local_mask,
                    mp_seen, fidx):
        """k CHAINED tracking steps in ONE compiled program (generalized
        `_step2_impl`): one dispatch + one stacked k-row pack fetch per k
        frames. Frame i+1 tracks against frame i's
        in-graph outputs; keyframe/map state is at most k-1 finalizes
        staler than the per-frame path (safe while k <= pipeline_depth)."""
        outs = []
        packs = []
        f, fmp, pose, vel = last, last_mp, pose_last, velocity
        for u in unpacked_list:
            (f, pose, vel, fmp, pack, mp_vis, mp_found, mp_seen, fidx) = \
                self._step_impl(*u, f, fmp, m, pose, vel, ref_kf,
                                mp_vis, mp_found, local_mask, mp_seen, fidx)
            outs.append((f, pose, vel, fmp))
            packs.append(pack)
        return (outs, jnp.stack(packs), mp_vis, mp_found, mp_seen, fidx)

    def _insert_kf_impl(
        self, m: MapArrays, slot, frame: FrameData, pose, feat_mp, new_slots
    ):
        """Scatter a keyframe + newly unprojected landmarks into MapArrays.

        new_slots: i32[N] target point slot per feature (-1 = don't create).
        New landmarks take the feature descriptor, the viewing direction as
        normal, and a scale band from the feature's level
        (MapPoint ctor + UpdateNormalAndDepth, src/MapPoint.cc:44-82,341-392).
        """
        m = m._replace(
            kf_pose=m.kf_pose.at[slot].set(pose),
            kf_valid=m.kf_valid.at[slot].set(True),
            kf_xy=m.kf_xy.at[slot].set(frame.xy),
            kf_level=m.kf_level.at[slot].set(frame.level),
            kf_angle=m.kf_angle.at[slot].set(frame.angle),
            kf_desc=m.kf_desc.at[slot].set(frame.desc),
            kf_uright=m.kf_uright.at[slot].set(frame.u_right),
            kf_depth=m.kf_depth.at[slot].set(frame.depth),
            kf_feat_valid=m.kf_feat_valid.at[slot].set(frame.valid),
        )
        # unproject new landmarks from depth through the camera pose
        create = new_slots >= 0
        xc = proj.unproject(self.cam, frame.xy, jnp.maximum(frame.depth, 1e-3))
        pose_wc = se3.inverse(pose)
        xw = se3.transform(pose_wc, xc)
        cam_center = se3.translation(pose_wc)
        view = xw - cam_center[None, :]
        dist = jnp.linalg.norm(view, axis=-1)
        lvl_sf = self.sf[frame.level]
        max_dist = dist * lvl_sf
        min_dist = max_dist / self.sf[-1]
        tgt = jnp.where(create, new_slots, m.point_capacity)  # OOB -> dropped
        m = m._replace(
            mp_pos=m.mp_pos.at[tgt].set(xw, mode="drop"),
            mp_valid=m.mp_valid.at[tgt].set(True, mode="drop"),
            mp_desc=m.mp_desc.at[tgt].set(frame.desc, mode="drop"),
            mp_normal=m.mp_normal.at[tgt].set(
                view / jnp.maximum(dist, 1e-6)[:, None], mode="drop"
            ),
            mp_min_dist=m.mp_min_dist.at[tgt].set(min_dist, mode="drop"),
            mp_max_dist=m.mp_max_dist.at[tgt].set(max_dist, mode="drop"),
        )
        all_mp = jnp.where(create, new_slots, feat_mp)
        m = m._replace(kf_mp=m.kf_mp.at[slot].set(all_mp))
        # pack (assignments, levels) so the host graph mirrors both from ONE
        # device->host transfer
        return m, jnp.stack([all_mp, frame.level])

    def _insert_kf_auto_impl(
        self, m: MapArrays, slot, frame: FrameData, pose, feat_mp,
        slot_buf, n_avail,
    ):
        """Keyframe insert with IN-GRAPH new-point selection.

        The reference's CreateMapPoints picks the ~100 closest unassigned
        close-depth features (`/root/reference/src/Tracking.cc:685-743`);
        a host version would need two [N]-array downloads (valid, depth)
        per keyframe. Here the selection runs on device: candidates =
        valid & close & unassigned, ranked by depth, the top `n_avail`
        mapped onto pre-allocated point slots `slot_buf` in feature order.
        The host replays the same mapping from ONE async pack readback a
        frame later (see `_drain_insert`)."""
        cfg = self.cfg
        close_th = (cfg.bf / cfg.fx) * cfg.th_depth
        cand = frame.valid & (frame.depth > 0) & (frame.depth < close_th) \
            & (feat_mp < 0)
        n = frame.capacity
        max_new = slot_buf.shape[0]
        depth_key = jnp.where(cand, frame.depth, jnp.inf)
        order = jnp.argsort(depth_key)
        rank = jnp.zeros((n,), jnp.int32).at[order].set(
            jnp.arange(n, dtype=jnp.int32)
        )
        create = cand & (rank < jnp.minimum(n_avail, max_new))
        # slots consumed in FEATURE-INDEX order (the host replays this)
        buf_idx = jnp.cumsum(create.astype(jnp.int32)) - 1
        new_slots = jnp.where(
            create, slot_buf[jnp.clip(buf_idx, 0, max_new - 1)], INVALID
        ).astype(jnp.int32)
        m, packed = self._insert_kf_impl(m, slot, frame, pose, feat_mp, new_slots)
        pack3 = jnp.concatenate(
            [packed, create.astype(jnp.int32)[None, :]], axis=0
        )
        return m, packed[0], pack3

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def _ref_kf_scalar(self):
        """Device scalar of the current reference KF. ref_kf changes only at
        keyframe events; caching avoids a fresh host->device scalar transfer
        every frame."""
        r = max(self.ref_kf, 0)
        c = getattr(self, "_ref_kf_cache", None)
        if c is None or c[0] != r:
            self._ref_kf_cache = c = (r, jnp.int32(r))
        return c[1]

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float = 0.0):
        """Process one RGB-D frame; returns the world->camera pose f32[7].

        Per tracked frame: one fused device program (`_step`) + ONE small
        host transfer (pose/velocity/stats pack). `feat_mp` and the frame
        arrays stay device-resident unless a keyframe is created.
        """
        buf_j = jnp.asarray(self._pack_rgbd(img, depth))
        return self._run_frame(
            lambda: self._prepare_packed(buf_j),
            lambda: self._step_packed(
                buf_j,
                self.last_frame, self.last_mp_dev, self.map,
                self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                self.mp_seen_dev, self.fidx_dev,
            ),
            timestamp,
        )

    def prefetch_rgbd(self, imgs, depths):
        """Pack + upload frames from a DEDICATED thread; returns one Future
        per frame resolving to the device buffer for `track_rgbd_uploaded`.

        `jnp.asarray` blocks its calling thread until the upload is staged;
        a small pool issues several uploads concurrently, overlapping them
        with each other and with device compute. The thread-shaped analog
        of the reference's disk-ingest loop running ahead of Tracking
        (`mono_tum.cc:84-101`)."""
        if not hasattr(self, "_upload_pool"):
            import os as _os

            n = int(_os.environ.get("TPU_SLAM_UPLOAD_THREADS", "4"))
            self._upload_pool = ThreadPoolExecutor(n, "frame-upload")
        return [
            self._upload_pool.submit(
                lambda i=i: jnp.asarray(self._pack_rgbd(imgs[i], depths[i]))
            )
            for i in range(len(imgs))
        ]

    def prefetch_rgbd_batches(self, imgs, depths, k: int):
        """Like `prefetch_rgbd`, but packs k frames per transfer (one
        future -> one [k, B] device buffer for `track_rgbd_batch`'s
        `uploaded=`). bench.py picks k per window with a probe; which k
        wins on the H100 is not measured."""
        if not hasattr(self, "_upload_pool"):
            self.prefetch_rgbd(imgs[:0], depths[:0])  # init pool only
        futs = []
        for s in range(0, len(imgs), k):
            e = min(s + k, len(imgs))
            futs.append(self._upload_pool.submit(
                lambda s=s, e=e: jnp.asarray(np.stack([
                    self._pack_rgbd(imgs[i], depths[i]) for i in range(s, e)
                ]))
            ))
        return futs

    def track_rgbd_uploaded(self, buf_dev, timestamp: float = 0.0):
        """Track one RGB-D frame from an already-uploaded packed buffer
        (see `prefetch_rgbd`). Identical programs/semantics to
        `track_rgbd` — only the upload moved off-thread."""
        return self._run_frame(
            lambda: self._prepare_packed(buf_dev),
            lambda: self._step_packed(
                buf_dev,
                self.last_frame, self.last_mp_dev, self.map,
                self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                self.mp_seen_dev, self.fidx_dev,
            ),
            timestamp,
        )

    def track_rgbd_pair_uploaded(self, buf_a, buf_b,
                                 ts_a: float = 0.0, ts_b: float = 0.0):
        """Track TWO RGB-D frames from already-uploaded packed buffers via
        the fused pair program (`_step2_impl`): one dispatch + one
        stacked pack fetch per pair. Falls back to per-frame stepping when
        the tracker is not in pipelined OK state (init/reloc need per-frame
        host control). Trajectory, keyframe policy and loss handling are
        NEAR-equivalent to two `track_rgbd_uploaded` calls — frame b is
        stepped with keyframe/map state at most one finalize staler than the
        per-frame pipelined path, so poses can differ at the noise level
        (not bit-equivalent)."""
        if not (self.cfg.pipelined and self.state == TrackState.OK):
            self.track_rgbd_uploaded(buf_a, ts_a)
            return self.track_rgbd_uploaded(buf_b, ts_b)
        return self._run_pair(
            lambda: self._step2_packed(
                buf_a, buf_b,
                self.last_frame, self.last_mp_dev, self.map,
                self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                self.mp_seen_dev, self.fidx_dev,
            ),
            ts_a, ts_b,
        )

    def _run_pair(self, step2_fn, ts_a: float, ts_b: float):
        """Dispatch a fused pair step and enqueue BOTH frames into the
        software pipeline — the k=2 case of `_run_chain`'s host epilogue
        (the pair step program returns the legacy flat tuple)."""
        with self.timer.time("track.dispatch"):
            (f1, pose1, vel1, fmp1, f2, pose2, vel2, fmp2, packs,
             self.mp_vis_dev, self.mp_found_dev,
             self.mp_seen_dev, self.fidx_dev) = step2_fn()
        return self._finish_chain(
            [(f1, pose1, vel1, fmp1), (f2, pose2, vel2, fmp2)], packs,
            [ts_a, ts_b],
        )

    def track_rgbd_chain_uploaded(self, bufs, timestamps=None):
        """Track k RGB-D frames from already-uploaded packed buffers via the
        k-frame chained program (`_stepk_impl`): ONE dispatch + ONE
        stacked k-row pack fetch for the whole chain. Falls back to
        per-frame stepping outside pipelined OK state. Same near-equivalence
        caveat as the pair step, scaled: keyframe/map state is up to k-1
        finalizes staler (keep k <= pipeline_depth)."""
        k = len(bufs)
        if timestamps is None:
            timestamps = [0.0] * k
        if not (self.cfg.pipelined and self.state == TrackState.OK
                and k >= 2):
            for b, ts in zip(bufs, timestamps):
                self.track_rgbd_uploaded(b, ts)
            return self.pose
        return self._run_chain(
            lambda: self._stepk_packed(
                tuple(bufs),
                self.last_frame, self.last_mp_dev, self.map,
                self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                self.mp_seen_dev, self.fidx_dev,
            ),
            timestamps,
        )

    def _run_chain(self, stepk_fn, timestamps):
        """Dispatch a k-frame chained step and enqueue all k frames into the
        software pipeline (sharing one stacked pack fetch), then run the
        per-frame host epilogue k times."""
        with self.timer.time("track.dispatch"):
            (outs, packs, self.mp_vis_dev, self.mp_found_dev,
             self.mp_seen_dev, self.fidx_dev) = stepk_fn()
        return self._finish_chain(outs, packs, timestamps)

    def _finish_chain(self, outs, packs, timestamps):
        """Shared host epilogue for fused multi-frame steps: one stacked
        pack fetch, k pipeline entries, k finalize/pump rounds."""
        packs.copy_to_host_async()
        fut = self._fetch_pool.submit(np.asarray, packs)
        q = getattr(self, "_pending_q", None)
        if q is None:
            q = self._pending_q = []
        for i, (f, pose, vel, fmp) in enumerate(outs):
            q.append((f, pose, vel, fmp, _RowFut(fut, i), timestamps[i],
                      self.ref_kf))
        f, pose, vel, fmp = outs[-1]
        self.pose_dev, self.velocity_dev = pose, vel
        self.last_frame = f
        self.last_mp_dev = fmp
        for _ in range(len(outs)):  # the per-frame host epilogue, k times
            while len(q) > max(int(self.cfg.pipeline_depth), 1):
                with self.timer.time("track.finalize"):
                    self._finalize_pending(q.pop(0))
                if self.state != TrackState.OK:
                    break  # loss drained the queue inside finalize
            self._pump_mapping()
            self.frame_id += 1
        return self.pose

    def upload_rgbd_batch(self, imgs, depths):
        """Pack + upload k RGB-D frames as ONE host->device transfer.

        bench.py probes per window which k to use (`probe_batch`); whether
        batching wins on the H100 is not measured. Returns an opaque device
        handle for `track_rgbd_batch`."""
        bufs = np.stack([self._pack_rgbd(i, d) for i, d in zip(imgs, depths)])
        return jnp.asarray(bufs)

    def track_rgbd_batch(self, imgs, depths, timestamps=None, uploaded=None,
                         paired: bool = False, mode: int = 0):
        """Track k RGB-D frames from one batched upload (see
        `upload_rgbd_batch`; pass `uploaded` to double-buffer: upload batch
        j+1 before stepping batch j). Steps still run strictly
        frame-sequential — pipeline dispatch, keyframe decisions and
        trajectory bookkeeping are IDENTICAL to per-frame `track_rgbd`; only
        the upload granularity changes (the reference likewise decouples
        disk ingest from tracking, `mono_tum.cc:84-101`).

        With `paired=True` the returned pose list is PAIR-granular: both
        frames of a fused pair report the post-pair pose (the trajectory
        itself, recorded per-frame in `finalize`, is unaffected)."""
        k = len(imgs) if imgs is not None else int(uploaded.shape[0])
        if timestamps is None:
            timestamps = [0.0] * k
        batch = self.upload_rgbd_batch(imgs, depths) if uploaded is None \
            else uploaded
        if not hasattr(self, "_slice_frame"):
            self._slice_frame = jax.jit(
                lambda b, i: jax.lax.dynamic_index_in_dim(
                    b, i, axis=0, keepdims=False)
            )
        if not hasattr(self, "_step_from_batch"):
            # slice fused INTO the step: one dispatch per frame instead of
            # two
            self._step_from_batch = jax.jit(
                lambda b, i, *rest: self._step_impl(
                    *self._unpack_impl(
                        jax.lax.dynamic_index_in_dim(b, i, axis=0,
                                                     keepdims=False)
                    ),
                    *rest,
                )
            )
        # opt-in (TPU_SLAM_DEFER_PACKS=1): defer the per-frame scalar-pack
        # fetches and issue ONE stacked fetch for the whole batch below
        # (safe while k <= pipeline depth, which keeps this batch's entries
        # clear of the finalize horizon). The batched fetch waits on the
        # batch's LAST step; not measured on the H100.
        import os as _os

        defer = (self.cfg.pipelined
                 and k <= max(int(self.cfg.pipeline_depth), 1)
                 and bool(_os.environ.get("TPU_SLAM_DEFER_PACKS")))
        poses = []
        mode = mode or (2 if paired else 1)
        if mode >= 2:
            # fused stepping within the batch: one dispatch + one
            # stacked pack fetch per `mode` frames (`_step2_impl` /
            # `_stepk_impl`); tail frames fall through to pair then
            # per-frame below
            i = 0
            while mode >= 4 and i + 3 < k and self.cfg.pipelined \
                    and self.state == TrackState.OK:
                self._run_chain(
                    lambda i=i: self._step4_from_batch(
                        batch, jnp.int32(i),
                        self.last_frame, self.last_mp_dev, self.map,
                        self.pose_dev, self.velocity_dev,
                        self._ref_kf_scalar(),
                        self.mp_vis_dev, self.mp_found_dev,
                        self.local_mask_dev, self.mp_seen_dev,
                        self.fidx_dev,
                    ),
                    timestamps[i: i + 4],
                )
                poses.extend([self.pose] * 4)
                i += 4
            while i + 1 < k and self.cfg.pipelined \
                    and self.state == TrackState.OK:
                self._run_pair(
                    lambda i=i: self._step2_from_batch(
                        batch, jnp.int32(i),
                        self.last_frame, self.last_mp_dev, self.map,
                        self.pose_dev, self.velocity_dev,
                        self._ref_kf_scalar(),
                        self.mp_vis_dev, self.mp_found_dev,
                        self.local_mask_dev, self.mp_seen_dev,
                        self.fidx_dev,
                    ),
                    timestamps[i], timestamps[i + 1],
                )
                poses.extend([self.pose, self.pose])
                i += 2
            for j in range(i, k):
                poses.append(self._run_frame(
                    lambda j=j: self._prepare_packed(
                        self._slice_frame(batch, jnp.int32(j))),
                    lambda j=j: self._step_from_batch(
                        batch, jnp.int32(j),
                        self.last_frame, self.last_mp_dev, self.map,
                        self.pose_dev, self.velocity_dev,
                        self._ref_kf_scalar(),
                        self.mp_vis_dev, self.mp_found_dev,
                        self.local_mask_dev, self.mp_seen_dev,
                        self.fidx_dev,
                    ),
                    timestamps[j],
                ))
            return poses
        for i in range(k):
            poses.append(self._run_frame(
                lambda i=i: self._prepare_packed(
                    self._slice_frame(batch, jnp.int32(i))),
                lambda i=i: self._step_from_batch(
                    batch, jnp.int32(i),
                    self.last_frame, self.last_mp_dev, self.map,
                    self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                    self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                    self.mp_seen_dev, self.fidx_dev,
                ),
                timestamps[i],
                defer_fetch=defer,
            ))
        if defer:
            self._flush_deferred_packs()
        return poses

    def _flush_deferred_packs(self):
        """Stack every still-raw pack handle in the pipeline queue into one
        device array and ONE worker fetch; patch the entries with row
        futures. Self-healing: scans for raw handles, so partial batches
        and loss-drained queues need no special cases."""
        q = getattr(self, "_pending_q", None)
        if not q:
            return
        raw_idx = [i for i, e in enumerate(q)
                   if not hasattr(e[4], "result")]
        if not raw_idx:
            return
        packs = [q[i][4] for i in raw_idx]
        progs = getattr(self, "_stack_packs", None)
        if progs is None:
            progs = self._stack_packs = {}
        kk = len(packs)
        if kk not in progs:
            progs[kk] = jax.jit(lambda *ps: jnp.stack(ps))
        stacked = progs[kk](*packs)
        stacked.copy_to_host_async()
        fut = self._fetch_pool.submit(np.asarray, stacked)
        for row, i in enumerate(raw_idx):
            e = q[i]
            q[i] = e[:4] + (_RowFut(fut, row),) + e[5:]

    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray,
                     timestamp: float = 0.0):
        """Process one rectified stereo pair (TrackStereo analog,
        `/root/reference/src/System.cc:430-485`). Rides the packed wire
        format (one uint8 upload for the pair — see `_pack_stereo`)."""
        buf_j = jnp.asarray(self._pack_stereo(img_l, img_r))
        return self.track_stereo_uploaded(buf_j, timestamp)

    def prefetch_stereo(self, imgs_l, imgs_r):
        """Pack + upload stereo pairs from the upload worker pool; one
        Future per pair (the stereo mirror of `prefetch_rgbd`)."""
        if not hasattr(self, "_upload_pool"):
            self.prefetch_rgbd([], [])  # init pool only
        return [
            self._upload_pool.submit(
                lambda i=i: jnp.asarray(self._pack_stereo(imgs_l[i],
                                                          imgs_r[i]))
            )
            for i in range(len(imgs_l))
        ]

    def track_stereo_uploaded(self, buf_dev, timestamp: float = 0.0):
        """Track one stereo pair from an already-uploaded packed buffer."""
        return self._run_frame(
            lambda: self._prepare_stereo_packed(buf_dev),
            lambda: self._step_stereo_packed(
                buf_dev,
                self.last_frame, self.last_mp_dev, self.map,
                self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                self.mp_seen_dev, self.fidx_dev,
            ),
            timestamp,
        )

    def track_stereo_pair_uploaded(self, buf_a, buf_b,
                                   ts_a: float = 0.0, ts_b: float = 0.0):
        """Track TWO stereo frames via the fused pair program — one dispatch
        + one stacked pack fetch per pair (the stereo mirror of
        `track_rgbd_pair_uploaded`, same fallback to per-frame stepping
        outside pipelined OK state and the same near-equivalence caveat)."""
        if not (self.cfg.pipelined and self.state == TrackState.OK):
            self.track_stereo_uploaded(buf_a, ts_a)
            return self.track_stereo_uploaded(buf_b, ts_b)
        return self._run_pair(
            lambda: self._step2_stereo_packed(
                buf_a, buf_b,
                self.last_frame, self.last_mp_dev, self.map,
                self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
                self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
                self.mp_seen_dev, self.fidx_dev,
            ),
            ts_a, ts_b,
        )

    def track_mono(self, img: np.ndarray, timestamp: float = 0.0):
        """Process one monocular frame (TrackMonocular analog,
        `/root/reference/src/System.cc:545-622`). Initialization follows
        `MonocularInitialization` + `CreateInitialMapMonocular`
        (`src/Tracking.cc:1020-1185`): windowed matching against a reference
        frame, parallel H/F RANSAC, triangulated bootstrap map normalized to
        unit median depth."""
        img_j = jnp.asarray(self._pack_mono(img))
        return self.track_mono_uploaded(img_j, timestamp)

    def _pack_mono(self, img: np.ndarray) -> np.ndarray:
        """8-bit mono wire (gray conversion on host, round-to-nearest) —
        4x fewer upload bytes than the old f32 path; real datasets are
        8-bit anyway."""
        img = np.asarray(img)
        if img.ndim == 3:  # ConvertToGray on host (src/System.cc:122-151)
            img = (img.astype(np.float32) @
                   np.array([0.299, 0.587, 0.114], np.float32))
        if img.dtype != np.uint8:
            img = np.clip(np.rint(img), 0, 255)
        return np.ascontiguousarray(img, np.uint8)

    def prefetch_mono(self, imgs):
        """Pack + upload mono frames from the worker pool (mirror of
        `prefetch_rgbd`)."""
        if not hasattr(self, "_upload_pool"):
            self.prefetch_rgbd([], [])  # init pool only
        return [
            self._upload_pool.submit(
                lambda i=i: jnp.asarray(self._pack_mono(imgs[i])))
            for i in range(len(imgs))
        ]

    def track_mono_uploaded(self, img_j, timestamp: float = 0.0):
        """Track one mono frame from an already-uploaded uint8 image."""

        def prep():
            return self._prepare_mono(img_j)

        def step():
            # mono tracking reuses the RGB-D step program minus depth: we pass
            # a zero depth image (u_right/depth stay -1 in the mono prep, and
            # the step re-derives the frame itself), so build a tiny wrapper
            frame = self._prepare_mono(img_j)
            return self._mono_step(frame)

        if self.state == TrackState.NOT_INITIALIZED:
            self._initialize_mono(prep(), timestamp)
            ok = self.state == TrackState.OK
            self._record_frame(
                tcr=np.asarray(se3.identity()) if ok else None,
                ref=self.ref_kf if ok else -1, lost=not ok,
            )
            self.frame_id += 1
            return self.pose
        return self._run_frame(prep, step, timestamp)

    def _mono_step(self, frame: FrameData):
        """Track an already-prepared mono frame via the shared program."""
        if not hasattr(self, "_mono_track"):
            def impl(fr, last, last_mp, m, pose_last, velocity, ref_kf,
                     mp_vis, mp_found, local_mask, mp_seen, fidx):
                (pose, feat_mp, n_inl, n_mm, t_close, u_close, used_ref,
                 found_mask, vis_mask, tcr) = self._track_impl(
                    fr, last, last_mp, m, pose_last, velocity, ref_kf,
                    local_mask, fidx
                )
                vel_new = se3.compose(pose, se3.inverse(pose_last))
                n_reacq, mp_seen, fidx = self._seam_stats(
                    found_mask, mp_seen, fidx
                )
                host_pack = _make_host_pack(pose, vel_new, n_inl, n_mm,
                                            t_close, u_close, used_ref,
                                            tcr, n_reacq, feat_mp)
                return (fr, pose, vel_new, feat_mp, host_pack,
                        mp_vis + vis_mask, mp_found + found_mask,
                        mp_seen, fidx)

            self._mono_track = jax.jit(impl)
        return self._mono_track(
            frame, self.last_frame, self.last_mp_dev, self.map,
            self.pose_dev, self.velocity_dev, self._ref_kf_scalar(),
            self.mp_vis_dev, self.mp_found_dev, self.local_mask_dev,
            self.mp_seen_dev, self.fidx_dev,
        )

    def _initialize_mono(self, frame: FrameData, timestamp: float):
        if int(np.asarray(frame.valid).sum()) < self.cfg.mono_init_min_matches:
            self._mono_ref = None
            return
        if self._mono_ref is None:
            self._mono_ref = frame
            self._mono_ref_ts = timestamp
            return
        idx, keep = self._mono_match(frame, self._mono_ref)
        n_matches = int(np.asarray(keep).sum())
        if n_matches < self.cfg.mono_init_min_matches:
            self._mono_ref = frame  # reference too old; restart (:1044)
            self._mono_ref_ts = timestamp
            return
        import jax as _jax

        from ..solvers.initializer import initialize

        if self._mono_init is None:
            self._mono_init = jax.jit(
                lambda x1, x2, v, k: initialize(x1, x2, v, self.cam, k)
            )
        ref = self._mono_ref
        midx = jnp.clip(idx, 0, frame.capacity - 1)
        x1 = ref.xy
        x2 = frame.xy[midx]
        res = self._mono_init(
            x1, x2, keep, _jax.random.PRNGKey(self.frame_id)
        )
        if not bool(res.success):
            return
        good = np.asarray(res.is_good)
        n_good = int(good.sum())
        if n_good < 50:
            return
        # normalize to unit median scene depth (:1138-1163)
        X = np.asarray(res.points3d)
        med_depth = float(np.median(X[good][:, 2]))
        if med_depth <= 0:
            return
        X = X / med_depth
        pose21 = np.array(res.pose21)
        pose21[4:7] /= med_depth

        # bootstrap map: two keyframes + triangulated landmarks
        slot0 = self.graph.alloc_kf_slot()
        empty_mp = jnp.full((frame.capacity,), INVALID, jnp.int32)
        no_new = jnp.full((frame.capacity,), INVALID, jnp.int32)
        self.map, p0 = self._insert_kf(
            self.map, slot0, ref, jnp.asarray(se3.identity()), empty_mp, no_new
        )
        slot1 = self.graph.alloc_kf_slot()
        self.map, p1 = self._insert_kf(
            self.map, slot1, frame, jnp.asarray(pose21), empty_mp, no_new
        )
        self.graph.set_levels(slot0, np.asarray(p0)[1])
        self.graph.set_levels(slot1, np.asarray(p1)[1])
        # scatter landmarks + both observations via the triangulation insert
        slots_np = np.full(frame.capacity, -1, np.int32)
        new_slots = self.graph.alloc_point_slots(n_good)
        if len(new_slots) < n_good:
            sel = np.nonzero(good)[0][: len(new_slots)]
            good = np.zeros_like(good)
            good[sel] = True
        slots_np[np.nonzero(good)[0]] = new_slots
        lm = self.local_mapper
        if lm is None:
            from .local_mapping import LocalMapper

            lm = LocalMapper(self.cam, self.cfg.n_levels, self.cfg.scale_factor)
            self.local_mapper = lm
        self.map = lm._tri_insert(
            self.map, jnp.int32(slot0), jnp.int32(slot1),
            jnp.asarray(slots_np), midx, jnp.asarray(X, jnp.float32),
        )
        idx_np = np.asarray(midx)
        for k, (slot, ts) in enumerate([(slot0, self._mono_ref_ts), (slot1, timestamp)]):
            self.graph.set_kf_alive(slot, True)
            self.graph.kf_frame_id[slot] = self.frame_id - (1 - k)
            self.graph.kf_timestamp[slot] = ts
        self.graph.origin_kf = slot0
        for f, s in zip(np.nonzero(good)[0], new_slots):
            s = int(s)
            self.graph.pt_alive[s] = True
            self.graph.note_new_point(s, slot0)
            self.graph.add_observation(s, slot0, int(f), False)
            self.graph.add_observation(s, slot1, int(idx_np[f]), False)
        self.graph.update_connections(slot1, self.graph.kf_row[slot1])

        # refine the bootstrap with a 2-KF bundle adjustment
        # (GlobalBundleAdjustemnt(20) at :1128)
        self.map, _ = lm.local_ba(self.map, self.graph, slot1)

        self.pose = np.asarray(self.map.kf_pose[slot1])
        self.pose_dev = jnp.asarray(self.pose)
        self.velocity = np.asarray(se3.identity())
        self.velocity_dev = jnp.asarray(self.velocity)
        self.last_frame = frame
        self.last_mp_dev = self.map.kf_mp[slot1]
        self.last_mp = np.asarray(self.last_mp_dev)
        self.ref_kf = slot1
        self.ref_kf_tracked = n_good
        self._ref_mp_row = self.graph.kf_row[slot1].copy()
        self.frames_since_kf = 0
        self._mono_ref = None
        self.state = TrackState.OK

    # ------------------------------------------------------------------
    # pipelined mode: hide the device->host round trip behind the next
    # frame's dispatch. This reproduces the reference's thread asynchrony
    # (tracking never waits for mapping, src/System.cc:398-411) as a
    # 1-frame software pipeline: frame i+1 is dispatched from frame i's
    # DEVICE outputs; frame i's scalars are read back while i+1 computes,
    # and a keyframe decision for i lands one frame late (the mapping
    # thread lagged in the reference too).
    # ------------------------------------------------------------------

    def _record_frame(self, tcr=None, ref=-1, lost=False):
        """Append one trajectory slot: the raw track-time pose plus the
        reference-KF-relative record (ref slot, Tcr) used by the
        loop/GBA-corrected trajectory saver (src/System.cc:690-747)."""
        self.trajectory.append(self.pose.copy())
        self.traj_entries.append({
            "ref": int(ref),
            "tcr": None if tcr is None else np.asarray(tcr, np.float32).copy(),
            "pose": self.pose.copy(),
            "lost": bool(lost),
        })

    def _run_frame_pipelined(self, step_fn, timestamp: float,
                             defer_fetch: bool = False):
        with self.timer.time("track.dispatch"):
            cur = step_fn()
        (frame, pose_dev, vel_dev, feat_mp_dev, host_pack,
         self.mp_vis_dev, self.mp_found_dev,
         self.mp_seen_dev, self.fidx_dev) = cur
        # request the scalar pack now AND hand the blocking read to the
        # fetch worker, so the main thread keeps dispatching while the read
        # waits. `defer_fetch` (batched ingest): the caller stacks several
        # frames' packs into ONE device array and ONE fetch.
        if defer_fetch:
            pack_fut = host_pack  # raw handle; caller patches in a future
        else:
            host_pack.copy_to_host_async()
            pack_fut = self._fetch_pool.submit(np.asarray, host_pack)
        q = getattr(self, "_pending_q", None)
        if q is None:
            q = self._pending_q = []
        q.append((frame, pose_dev, vel_dev, feat_mp_dev, pack_fut,
                  timestamp, self.ref_kf))
        # advance device-resident tracking state immediately (async)
        self.pose_dev, self.velocity_dev = pose_dev, vel_dev
        self.last_frame = frame
        self.last_mp_dev = feat_mp_dev
        while len(q) > max(int(self.cfg.pipeline_depth), 1):
            with self.timer.time("track.finalize"):
                self._finalize_pending(q.pop(0))
            if self.state != TrackState.OK:
                break  # loss drained the queue inside finalize
        # advance the local-mapping job one stage per frame (the mapping
        # "thread" runs between tracked frames; every readback it performs
        # was requested >= 1 frame ago)
        self._pump_mapping()
        self.frame_id += 1
        return self.pose

    def flush(self):
        """Drain the pipeline AND deferred mapping products (call before
        reading the trajectory or the map)."""
        q = getattr(self, "_pending_q", None)
        while q:
            self._finalize_pending(q.pop(0))
            if self.state != TrackState.OK:
                break
        self._complete_mapping()

    def _finalize_pending(self, pending):
        frame, pose_dev, vel_dev, feat_mp_dev, host_pack, ts, disp_ref = pending
        pack = (host_pack.result() if hasattr(host_pack, "result")
                else np.asarray(host_pack))
        n_inl = int(pack[14])
        if n_inl < self.cfg.min_inliers_track:
            self.state = TrackState.LOST
            self.pose_dev = jnp.asarray(self.pose)  # rewind device state
            self.velocity_dev = jnp.asarray(np.asarray(se3.identity()))
            self._record_frame(lost=True)
            self.track_info.append({"inliers": n_inl, "lost": True})
            # every still-in-flight frame was predicted from this (now
            # known-bad) state; their results are discarded, but each still
            # owns one trajectory slot — TUM export pairs every entry with
            # a SlamSystem timestamp, so the 1-entry-per-frame invariant
            # must hold even across a loss
            q = getattr(self, "_pending_q", None)
            while q:
                q.pop(0)
                self._record_frame(lost=True)
                self.track_info.append(
                    {"inliers": 0, "lost": True, "discarded": True}
                )
            self._maybe_auto_reset()
            return
        self.pose = pack[0:7]
        self.velocity = pack[7:14]
        self.frames_since_kf += 1
        need_kf = self._need_new_keyframe(n_inl, int(pack[16]), int(pack[17]))
        if self._seam_check(int(pack[26])):
            need_kf = True
        if need_kf:
            # keyframe creation must not clobber the newer (in-flight)
            # frame's device state — including the BA pose adoption, which
            # refines frame i while pose_dev already belongs to frame i+1
            save = (self.last_frame, self.last_mp_dev, self.last_mp,
                    self.pose_dev, self.velocity_dev)
            pose_np = self.pose.copy()
            feat_np = (pack[27:].astype(np.int32) if pack.shape[0] > 27
                       else np.asarray(feat_mp_dev))
            self._create_keyframe(frame, feat_np, ts,
                                  feat_mp_dev=feat_mp_dev)
            (self.last_frame, self.last_mp_dev, self.last_mp,
             self.pose_dev, self.velocity_dev) = save
            self.pose = pose_np
        if not need_kf:
            self._maybe_refresh_local_mask()
        self._record_frame(tcr=pack[19:26], ref=disp_ref)
        self.track_info.append(
            {"inliers": n_inl, "mm": int(pack[15]), "kf": bool(need_kf),
             "ref_fallback": bool(pack[18]), "lost": False}
        )

    def _run_frame(self, prep_fn, step_fn, timestamp: float,
                   defer_fetch: bool = False):
        if self.cfg.pipelined and self.state == TrackState.OK:
            return self._run_frame_pipelined(step_fn, timestamp,
                                             defer_fetch=defer_fetch)
        self.flush()
        if self.state == TrackState.NOT_INITIALIZED:
            frame = prep_fn()
            self._initialize(frame, timestamp)
            # init frame: pose IS the new KF pose -> Tcr = identity
            ok = self.state == TrackState.OK
            self._record_frame(
                tcr=np.asarray(se3.identity()) if ok else None,
                ref=self.ref_kf if ok else -1, lost=not ok,
            )
            self.frame_id += 1
            return self.pose
        elif self.state == TrackState.LOST:
            frame = prep_fn()
            if self._relocalize(frame):
                self.track_info.append({"reloc": True, "lost": False})
                self._record_frame(lost=False)  # absolute pose (no Tcr yet)
            else:
                self.track_info.append({"reloc": False, "lost": True})
                self._record_frame(lost=True)
            self.frame_id += 1
            return self.pose
        else:
            (frame, pose_dev, vel_dev, feat_mp_dev, host_pack,
             self.mp_vis_dev, self.mp_found_dev,
             self.mp_seen_dev, self.fidx_dev) = step_fn()
            pack = np.asarray(host_pack)
            pose = pack[0:7]
            n_inl, n_mm = int(pack[14]), int(pack[15])
            tracked_close, untracked_close = int(pack[16]), int(pack[17])
            if n_inl < self.cfg.min_inliers_track:
                self.state = TrackState.LOST
                self._record_frame(lost=True)
                self.track_info.append({"inliers": n_inl, "lost": True})
                self._maybe_auto_reset()
                self.frame_id += 1
                return self.pose
            disp_ref = self.ref_kf
            self.pose = pose
            self.velocity = pack[7:14]
            self.pose_dev, self.velocity_dev = pose_dev, vel_dev
            self.state = TrackState.OK
            self.frames_since_kf += 1
            need_kf = self._need_new_keyframe(n_inl, tracked_close, untracked_close)
            if self._seam_check(int(pack[26])):
                need_kf = True
            if need_kf:
                feat_np = (pack[27:].astype(np.int32) if pack.shape[0] > 27
                           else np.asarray(feat_mp_dev))
                slot = self._create_keyframe(frame, feat_np,
                                             timestamp, feat_mp_dev=feat_mp_dev)
                if slot < 0:  # capacity-frozen map: keep frame assignments
                    self.last_mp_dev = feat_mp_dev
            else:
                self.last_mp_dev = feat_mp_dev
                self._maybe_refresh_local_mask()
            self.last_frame = frame
            self.track_info.append(
                {"inliers": n_inl, "mm": n_mm, "kf": bool(need_kf),
                 "ref_fallback": bool(pack[18]), "lost": False}
            )
            self._record_frame(tcr=pack[19:26], ref=disp_ref)

        self.frame_id += 1
        return self.pose

    def _reloc_match_impl(self, frame: FrameData, m: MapArrays, kf):
        """Frame<->keyframe descriptor matching yielding 2D-3D pairs
        (SearchByBoW KF<->Frame analog, `src/ORBmatcher.cc:452`)."""
        mp = m.kf_mp[kf]
        pt = jnp.clip(mp, 0, m.point_capacity - 1)
        ok_b = (mp >= 0) & m.kf_feat_valid[kf] & m.mp_valid[pt]
        mm = matching.match_descriptors(
            frame.desc, m.kf_desc[kf], frame.valid, ok_b,
            max_dist=50, nn_ratio=0.75,
        )
        midx = jnp.clip(mm.idx, 0, mp.shape[0] - 1)
        feat_pt = jnp.where(mm.valid, mp[midx], INVALID)
        pts3d = m.mp_pos[jnp.clip(feat_pt, 0, m.point_capacity - 1)]
        return pts3d, feat_pt, mm.valid

    def _reloc_solve_impl(self, frame: FrameData, pts3d, valid, seed):
        """RANSAC seed + pose LM for relocalization, one jitted program.

        RGB-D/stereo seeds with 3D-3D Horn on unprojected depth (planar-safe
        — a 2D-3D DLT resection degenerates on one-wall views); mono seeds
        with EPnP RANSAC (matching the reference, src/Tracking.cc:349-441).
        `seed` (traced i32) varies the hypothesis set per attempt/candidate
        — a fixed key would replay the same samples forever."""
        from ..solvers.ransac import horn_ransac, pnp_ransac

        rkey = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        if self.cfg.bf > 0:
            xc = proj.unproject(self.cam, frame.xy,
                                jnp.maximum(frame.depth, 1e-3))
            ok3 = valid & (frame.depth > 0)
            res = horn_ransac(pts3d, xc, ok3, rkey,
                              with_scale=False, inlier_th=0.05,
                              min_inliers=10)
        else:
            res = pnp_ransac(pts3d, frame.xy, valid, self.cam,
                             rkey, n_iters=256, sample_size=8)
        seed_ok = jnp.where(res.success, res.inliers & valid, valid)
        r = pose_optimize(
            jnp.where(res.success, res.pose, jnp.asarray(se3.identity())),
            pts3d, frame.xy, frame.u_right,
            self.inv_sigma2[frame.level], seed_ok, self.cam,
        )
        return res.success, r.pose, r.inliers, r.num_inliers

    def _reloc_polish_impl(self, frame: FrameData, m: MapArrays, pose):
        """Post-relocalization polish: projection-guided matching around the
        coarse pose + full pose LM (the reference's second-chance search,
        `src/Tracking.cc:399-441`: SearchByProjection radius 10 after the
        EPnP pose, then PoseOptimization again)."""
        lm, _ = matching.search_by_projection_with_vis(
            frame.xy, frame.level, frame.desc, frame.valid,
            m.mp_pos, m.mp_desc, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
            m.mp_valid, pose, self.cam, self.sf,
            radius=10.0, image_bounds=self.image_bounds,
        )
        pidx = jnp.clip(lm.idx, 0, frame.capacity - 1)
        feat_mp = jnp.full((frame.capacity,), INVALID, jnp.int32).at[pidx].max(
            jnp.where(lm.valid, jnp.arange(m.point_capacity, dtype=jnp.int32),
                      INVALID)
        )
        has = feat_mp >= 0
        r = pose_optimize(
            pose, m.mp_pos[jnp.clip(feat_mp, 0, m.point_capacity - 1)],
            frame.xy, frame.u_right, self.inv_sigma2[frame.level], has,
            self.cam, rounds=self.cfg.pose_opt_rounds,
            iters_per_round=self.cfg.pose_opt_iters,
        )
        feat_final = jnp.where(r.inliers & has, feat_mp, INVALID)
        return r.pose, feat_final, r.num_inliers

    def _relocalize(self, frame: FrameData) -> bool:
        """BoW candidate retrieval + RANSAC + pose refinement
        (`Relocalizer::Relocalize`, /root/reference/src/Tracking.cc:284-463).
        Needs the loop closer's BoW database; without one, stays lost."""
        if self.loop_closer is None:
            return False
        if not hasattr(self, "_reloc_solve"):
            self._reloc_solve = jax.jit(self._reloc_solve_impl)
            self._reloc_polish = jax.jit(self._reloc_polish_impl)

        v, _ = self.loop_closer.db.compute_bow(frame.desc, frame.valid)
        # covisibility-group accumulated scoring, shared-word 0.8 gate —
        # DetectRelocalizationCandidates (src/KeyFrameDatabase.cc:173-265)
        # uses no absolute score floor (there is no pose prior when lost)
        cands = self.loop_closer.db.detect_candidates_grouped(
            v, exclude=set(), min_score=0.0, graph=self.graph,
            max_candidates=5,
        )
        if not cands:  # degenerate BoW overlap: fall back to plain scoring
            cands = self.loop_closer.db.detect_candidates(
                v, exclude=set(), min_score=0.015, max_candidates=3
            )
        for kf in cands:
            pts3d, feat_pt, valid = self._reloc_match(frame, self.map, jnp.int32(kf))
            if int(np.asarray(valid).sum()) < 15:
                continue
            success, pose, inliers, n_inl = self._reloc_solve(
                frame, pts3d, valid, jnp.int32(self.frame_id * 31 + kf)
            )
            if not bool(success):
                continue

            if int(n_inl) < 20:
                continue
            # polish: projection-guided matching around the coarse pose +
            # full pose LM (the reference re-searches + re-optimizes when
            # the first solve is thin, src/Tracking.cc:399-441)
            pose, feat_final, n_inl2 = self._reloc_polish(frame, self.map, pose)
            if int(n_inl2) < 20:
                continue
            self.pose = np.asarray(pose)
            self.pose_dev = jnp.asarray(self.pose)
            self.velocity = np.asarray(se3.identity())
            self.velocity_dev = jnp.asarray(self.velocity)
            self.last_frame = frame
            self.last_mp_dev = feat_final
            self.state = TrackState.OK
            return True
        return False

    def warm_stage_programs(self):
        """Pre-compile every padding-bucket variant of the keyframe-stage
        programs via semantic NO-OP calls (all indices = out-of-range
        sentinels with mode='drop' scatters, or empty BA windows whose
        write-backs all drop), so no lazy compile can stall a steady-state
        frame. The reference has no analog (C++ is ahead-of-time compiled);
        under XLA, shape variety is compile variety, and a first-use
        compile mid-run costs seconds. Call once after
        the first keyframes exist (programs close over map shapes)."""
        lm = self.local_mapper
        if lm is None or self.map is None:
            return
        P = self.map.point_capacity
        K = self.map.kf_capacity
        i32 = jnp.int32
        # _cull: kill-bucket x pair-bucket combos (pairs run ~2-3x kill)
        for kb in (512, 1024):
            for pb in (512, 1024, 2048):
                self.map = lm._cull(
                    self.map, jnp.full((kb,), P, i32),
                    jnp.full((pb,), K, i32), jnp.zeros((pb,), i32),
                )
        # _fuse_apply: one shared bucket across its five index arrays
        if not hasattr(lm, "_fuse_apply"):
            lm._fuse_apply = jax.jit(lm._fuse_apply_impl,
                                     donate_argnums=(0,))
        for b in (512, 2048):
            self.map = lm._fuse_apply(
                self.map, jnp.full((b,), K, i32), jnp.zeros((b,), i32),
                jnp.full((b,), INVALID, i32), jnp.full((b,), P, i32),
                jnp.full((b,), P, i32),
            )
        # window BA: every point-compaction bucket (empty window -> all
        # write-backs scatter to dropped padding rows)
        W = lm.BA_WINDOW
        for Q in lm.BA_POINT_BUCKETS:
            self.map, _, c0, c1 = lm._ba(
                self.map, jnp.full((W,), K, i32), jnp.zeros((W,), bool),
                jnp.zeros((W,), bool), jnp.full((P,), Q - 1, i32),
                jnp.full((Q,), P, i32),
            )
        c1.block_until_ready()
        # recycled-slot counter reset buckets
        if not hasattr(self, "_zero_counters"):
            self._zero_counters = jax.jit(
                lambda v, f, sn, s: (v.at[s].set(0, mode="drop"),
                                     f.at[s].set(0, mode="drop"),
                                     sn.at[s].set(-1, mode="drop"))
            )
        for b in (512, 1024):
            (self.mp_vis_dev, self.mp_found_dev,
             self.mp_seen_dev) = self._zero_counters(
                self.mp_vis_dev, self.mp_found_dev, self.mp_seen_dev,
                jnp.full((b,), P, i32),
            )
        self.sync_device()  # all warm programs genuinely done

    def sync_device(self):
        """Wait until the device has finished the map write chain and any
        in-flight global BA."""
        sinks = [self.map.kf_pose]
        pend = self._gba_pending
        if pend is not None:
            sinks.append(pend["gba_pose"])
        jax.block_until_ready(sinks)

    def reset_map(self):
        """Discard the map and return to NOT_INITIALIZED, keeping compiled
        programs and the trajectory log (System/Tracking::Reset analog,
        `/root/reference/src/System.cc:624-660`)."""
        self.map = empty_map(self.cfg.map_capacity)
        self.graph = _make_graph(self.cfg.map_capacity)
        P = self.cfg.map_capacity.max_points
        self.mp_vis_dev = jnp.zeros((P,), jnp.int32)
        self.mp_found_dev = jnp.zeros((P,), jnp.int32)
        self.local_mask_dev = jnp.ones((P,), bool)
        # seam-detection state must not survive into the new map: stale
        # last-seen stamps on reused point slots would read as long-gap
        # re-acquisitions and fire false seam keyframes / loop checks
        self.mp_seen_dev = jnp.full((P,), -1, jnp.int32)
        self.fidx_dev = jnp.int32(0)
        self._seam_pending = False
        self._seam_cooldown_until = 0
        if self.loop_closer is not None:
            self.loop_closer.db.clear()
            self.loop_closer.consistent_groups = []
        self._gba_pending = None
        self._map_job = None
        self._pending_insert = None
        self._loop_pending = None
        if self.local_mapper is not None:
            self.local_mapper._pending_ba_erase = None
            self.local_mapper._pending_tri = None
            self.local_mapper._pending_fuse = None
            self.local_mapper._pending_ratio = None
        self.pose = np.asarray(se3.identity())
        self.velocity = np.asarray(se3.identity())
        self.pose_dev = jnp.asarray(self.pose)
        self.velocity_dev = jnp.asarray(self.velocity)
        self.last_frame = None
        self.last_mp = None
        self.last_mp_dev = None
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self._ref_mp_row = None
        self.frames_since_kf = 0
        self._mono_ref = None
        self._pending_q = []
        self.state = TrackState.NOT_INITIALIZED

    def _maybe_auto_reset(self) -> bool:
        """Auto-reset when tracking is lost soon after initialization
        (<=5 keyframes in the map — `/root/reference/src/Tracking.cc:1317-1325`):
        a map that thin cannot support relocalization, so restart clean."""
        if len(self.graph.alive_kfs()) <= 5:
            self.reset_map()
            return True
        return False

    def set_vocabulary(self, voc):
        """Inject a pre-trained vocabulary (the reference loads ORBvoc.txt,
        `/root/reference/src/System.cc:343`; here training on live descriptors
        is the default and this is the analog injection point)."""
        self.vocabulary = voc

    # keyframes whose descriptors accumulate before vocabulary training:
    # a single view's words alias badly; 4 views of the scene give the
    # k-majority clustering real appearance diversity
    VOCAB_TRAIN_KFS = 4

    def _ensure_bow_index(self, slot: int):
        """Create the vocabulary + BoW database when enough keyframes have
        accumulated, and index keyframe `slot`. Returns the BoW vector (or
        None while the vocabulary is still warming up).

        This runs REGARDLESS of loop closing: the reference's
        KeyFrameDatabase serves both loop detection and relocalization
        (`src/KeyFrameDatabase.cc:68-265`), so a tracker with loop closing
        disabled must still be able to relocalize after a loss."""
        from .loop_closing import LoopCloser
        from .vocabulary import train_vocabulary

        if self.loop_closer is None:
            pending = getattr(self, "_vocab_pending", None)
            if pending is None:
                pending = self._vocab_pending = []
            pending.append(slot)
            if self.vocabulary is None:
                if len(pending) < self.VOCAB_TRAIN_KFS:
                    return None
                # pool the pending keyframes' descriptors (one small read
                # per KF, once per session) and train
                descs = []
                kf_desc = np.asarray(self.map.kf_desc[jnp.asarray(pending)])
                kf_val = np.asarray(
                    self.map.kf_feat_valid[jnp.asarray(pending)]
                )
                for i in range(len(pending)):
                    descs.append(kf_desc[i][kf_val[i]])
                desc = np.concatenate(descs)
                if len(desc) < 32:
                    return None
                self.vocabulary = train_vocabulary(
                    desc, n_words=min(self.cfg.vocab_words, len(desc)), iters=6
                )
            # Sim3 scale is observable (and drifts) only in monocular mode;
            # stereo/RGB-D fix s=1 (`src/LoopClosing.cc` fixScale ctor arg)
            self.loop_closer = LoopCloser(
                self.vocabulary, self.cam, self.cfg.map_capacity.max_keyframes,
                self.cfg.n_levels, self.cfg.scale_factor,
                fix_scale=self.cfg.bf > 0,
            )
            # index every pending keyframe that is still alive (minus the
            # current one, indexed below)
            for k in pending[:-1]:
                if self.graph.kf_alive[k]:
                    self.loop_closer.add_keyframe_bow(self.map, int(k))
            self._vocab_pending = []
        return self.loop_closer.add_keyframe_bow(self.map, slot)

    def force_bow_index(self) -> bool:
        """Train the vocabulary + build the BoW index NOW from every alive
        keyframe, bypassing the VOCAB_TRAIN_KFS warm-up threshold.

        Called by `serialize.save_map`: a short session (few keyframes)
        would otherwise checkpoint WITHOUT place-recognition state, and a
        later `load_map` could never relocalize into it — the map would be
        silently unusable (the reference never hits this because it loads
        ORBvoc.txt up front, src/System.cc:343). Returns True when an
        index exists afterwards."""
        if self.loop_closer is not None:
            return True
        alive = [int(k) for k in self.graph.alive_kfs()]
        if not alive:
            return False
        self._vocab_pending = list(alive[:-1])
        self.VOCAB_TRAIN_KFS = 1  # instance attr shadows the class default
        try:
            return self._ensure_bow_index(alive[-1]) is not None
        finally:
            del self.VOCAB_TRAIN_KFS  # restore the class default

    def _loop_closing_stage(self, frame: FrameData, slot: int):
        bow = self._ensure_bow_index(slot)
        if bow is None or not self.cfg.enable_loop_closing:
            return
        loop_kf = self.loop_closer.detect(self.map, self.graph, slot, bow)
        if loop_kf is None:
            return
        self._close_loop(frame, slot, loop_kf)

    def _implicit_loop_candidate(self, slot: int,
                                 min_weight: int = 15) -> Optional[int]:
        """Detect a silent re-acquisition: a strong covisibility edge from
        the new keyframe to a temporally distant keyframe that the PREVIOUS
        keyframe's context was not connected to. Whole-map projection
        matching creates these edges on revisits under moderate drift; the
        edge glues the current pose to the old map but leaves the drifted
        middle of the chain uncorrected — exactly the state the essential
        graph optimization exists to repair (see implicit_loop_min_gap)."""
        g = self.graph
        gap = self.cfg.implicit_loop_min_gap
        lc = self.loop_closer
        if (gap <= 0 or lc is None
                or g.kf_seq[slot] - lc.last_loop_seq < 10):
            return None
        if len(g.alive_kfs()) < 10:
            return None
        fid = g.kf_frame_id
        cur = fid[slot]
        nbs = g.covis_neighbors(slot, min_weight=min_weight, top_k=30)
        old = [n for n in nbs if cur - fid[n] > gap]
        import os as _os
        if _os.environ.get("TPU_SLAM_DEBUG_LOOP"):
            print(f"[implicit?] slot={slot} cur_fid={cur} nbs={nbs} "
                  f"old={old}", flush=True)
        if not old:
            return None
        # previous (temporal) keyframe: if its context already included the
        # old region, the camera merely lingered — not a revisit
        prev, best_fid = None, -1
        for k in g.alive_kfs():
            if k != slot and best_fid < fid[k] < cur:
                prev, best_fid = k, fid[k]
        if prev is None:
            return None
        prev_ctx = set(g.covis_neighbors(prev, top_k=30)) | {prev}
        for n in old:
            if n not in prev_ctx:
                return int(n)
        return None

    def _close_loop(self, frame: FrameData, slot: int, loop_kf: int,
                    implicit: bool = False):
        """Sim3 computation + verification + loop correction for a detected
        candidate (FindLoopInCandidateKFs + LoopCorrector::Correct,
        `/root/reference/src/LoopClosing.cc:62-155,521-692`). Rare and
        O(map)-sized, so it runs inline (the reference also stalls mapping
        for the correction, `:532-544`)."""
        import jax as _jax

        import os as _os
        _dbg = _os.environ.get("TPU_SLAM_DEBUG_LOOP")
        if implicit:
            # Whole-map matching already aligned the current keyframe to the
            # revisited region (they share >=15 inlier landmarks), so the
            # relative Sim3 is the TRACKED relative pose at scale 1 — a
            # descriptor-matched Horn solve would only re-derive it (or worse,
            # alias). The drift lives in the chain BETWEEN them; it is encoded
            # in this keyframe's mixed observations (re-acquired old landmarks
            # + drifted recent ones), which is exactly the signal global BA
            # consumes. So: strict projection verification, loop edge for the
            # essential graph, async global BA.
            from ..geometry import sim3 as _sim3
            from .system import _np_compose, _np_inverse
            kf_poses = np.asarray(self.map.kf_pose)  # rare event: one fetch
            rel = _np_compose(kf_poses[slot], _np_inverse(kf_poses[loop_kf]))
            S = _sim3.from_se3(jnp.asarray(rel))
            ok, n_proj = self.loop_closer.verify_by_projection(
                self.map, self.graph, slot, loop_kf, S, min_matches=25,
            )
            if _dbg:
                print(f"[close_loop] implicit slot={slot} loop={loop_kf}: "
                      f"proj ok={ok} n={n_proj}", flush=True)
            if not ok:
                return
            self.graph.loop_edges.setdefault(slot, set()).add(loop_kf)
            self.graph.loop_edges.setdefault(loop_kf, set()).add(slot)
            pending = self.loop_closer.launch_gba(self.map, self.graph)
            self._gba_pending = pending
            self.loop_closer.last_loop_kf = slot
            self.loop_closer.last_loop_seq = int(self.graph.kf_seq[slot])
            self.loop_closer.loops_closed += 1
            self.last_loop_info = {
                "loop_kf": loop_kf, "kf": slot, "implicit": True,
                "n_proj": int(n_proj),
            }
            return
        out = self.loop_closer.compute_sim3(
            self.map, slot, loop_kf, _jax.random.PRNGKey(slot)
        )
        if out is None:
            if _dbg:
                print(f"[close_loop] slot={slot} loop={loop_kf}: sim3 FAILED",
                      flush=True)
            return
        S, inl, pt_a, pt_b = out
        ok, n_proj = self.loop_closer.verify_by_projection(
            self.map, self.graph, slot, loop_kf, S
        )
        if _dbg:
            rel = np.asarray(se3.compose(
                self.map.kf_pose[slot], se3.inverse(self.map.kf_pose[loop_kf])
            ))
            print(f"[close_loop] slot={slot} loop={loop_kf}: proj ok={ok} "
                  f"n={n_proj} S={np.asarray(S).round(3)} "
                  f"rel={rel.round(3)}", flush=True)
        if not ok:
            return
        self.map, info = self.loop_closer.correct(
            self.map, self.graph, slot, loop_kf, S, inl, pt_a, pt_b
        )
        self._gba_pending = info.pop("gba_pending", None)
        self.last_loop_info = {"loop_kf": loop_kf, "kf": slot, **info}
        # pipelined mode keeps the in-flight frames' device state (their
        # predictions pre-date the correction; tracking re-acquires against
        # the corrected map) — matching the old finalize save/restore.
        if not self.cfg.pipelined:
            self.pose = np.asarray(self.map.kf_pose[slot])
            self.pose_dev = jnp.asarray(self.pose)

    def _ref_kf_tracked_points(self) -> int:
        """TrackedMapPoints(minObs) of the reference KF
        (`/root/reference/src/KeyFrame.cc` via `Tracking.cc:489-492`): only
        landmarks with >= minObs observations count toward the ratio gate —
        fresh single-observation points don't inflate the baseline."""
        if self.ref_kf < 0 or self._ref_mp_row is None:
            return max(self.ref_kf_tracked, 1)
        # reference uses minObs=3 on mature maps (src/Tracking.cc:489-492);
        # with our shorter-lived maps and per-KF creation caps, >=2 keeps the
        # baseline meaningful without starving keyframe insertion
        min_obs = 2 if len(self.graph.alive_kfs()) > 2 else 1
        n = 0
        for pt in self._ref_mp_row:
            if pt >= 0 and self.graph.pt_alive[pt] and self.graph.n_obs(pt) >= min_obs:
                n += 1
        return max(n, 1)

    def _seam_check(self, n_reacq: int) -> bool:
        """Seam trigger: force a keyframe the moment tracking re-acquires a
        batch of long-unseen landmarks (see TrackerConfig.seam_min_reacq).
        Returns True when a keyframe should be forced this frame."""
        cfg = self.cfg
        if (cfg.seam_min_reacq <= 0 or not cfg.enable_loop_closing
                or self.loop_closer is None
                or n_reacq < cfg.seam_min_reacq):
            return False
        if self.frame_id < getattr(self, "_seam_cooldown_until", 0):
            return False
        if (self.ref_kf >= 0 and self.graph.kf_seq[self.ref_kf]
                - self.loop_closer.last_loop_seq < 10):
            return False
        self._seam_cooldown_until = self.frame_id + 30
        self._seam_pending = True
        return True

    def _need_new_keyframe(self, n_inl, tracked_close, untracked_close) -> bool:
        """NeedNewKeyFrame policy (`/root/reference/src/Tracking.cc:465-550`):
        ratio vs reference KF, stereo close-point pressure, interval gates.
        Localization-only mode suppresses keyframes outright (`:470-471`)."""
        if getattr(self, "localization_only", False):
            return False
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        need_close = (tracked_close < 100) and (untracked_close > 70)
        ratio_gate = n_inl < self.cfg.kf_ref_ratio * self._ref_kf_tracked_points()
        interval_gate = self.frames_since_kf >= self.cfg.kf_max_interval
        return (ratio_gate or interval_gate or need_close) and n_inl > 15

    def _initialize(self, frame: FrameData, timestamp: float):
        """Stereo/RGB-D bootstrap (`src/Tracking.cc:965-1017`): first frame at
        origin; every feature with depth becomes a landmark."""
        valid = np.asarray(frame.valid)
        depth = np.asarray(frame.depth)
        create = valid & (depth > 0)
        if create.sum() < 50:
            return  # not enough structure yet
        self.pose = np.asarray(se3.identity())
        self.pose_dev = jnp.asarray(self.pose)
        self.velocity_dev = jnp.asarray(self.velocity)
        self._create_keyframe(frame, np.full(frame.capacity, INVALID, np.int64),
                              timestamp, create_mask=create)
        self.last_frame = frame
        self.state = TrackState.OK

    def _create_keyframe(
        self, frame: FrameData, feat_mp: np.ndarray, timestamp: float,
        create_mask: Optional[np.ndarray] = None, feat_mp_dev=None,
    ):
        cfg = self.cfg
        # complete the previous keyframe's mapping job FIRST: triangulation
        # allocates point slots at drain time, so it must precede this
        # keyframe's own allocations (the reference's mapping thread likewise
        # finishes one KF before accepting the next, src/LocalMapping.cc:79)
        if self.local_mapper is not None:
            with self.timer.time("kf.drain"):
                self._finalize_map()
        if not self.graph.can_alloc_kf():
            # no fresh slot and nothing recyclable in quarantine: keep
            # tracking against the frozen map instead of crashing mid-run
            # (graceful degradation; culling + slot recycling normally keep
            # this from ever triggering)
            if not getattr(self, "_warned_kf_cap", False):
                self._warned_kf_cap = True
                import sys
                print("[tpu-slam] keyframe capacity reached; map growth "
                      "stopped", file=sys.stderr)
            self.frames_since_kf = 0
            return -1
        slot = self.graph.alloc_kf_slot()
        if create_mask is None:
            # ---- async device path (steady-state keyframes) ----
            # New-point selection runs inside the insert program (no
            # valid+depth downloads); the pack (assignments, levels,
            # created) streams back off-thread and the graph bookkeeping
            # lands at the next pump call — the reference's mapping thread
            # lag (src/LocalMapping.cc:57-91).
            max_new = cfg.max_new_points_per_kf
            got = self.graph.alloc_point_slots(max_new)
            P = cfg.map_capacity.max_points
            slot_buf = np.full(max_new, P, np.int32)
            slot_buf[: len(got)] = got
            if feat_mp_dev is None:
                feat_mp_dev = jnp.asarray(feat_mp.astype(np.int32))
            self.map, all_mp_dev, pack_dev = self._insert_kf_auto(
                self.map, jnp.int32(slot), frame, jnp.asarray(self.pose),
                feat_mp_dev, jnp.asarray(slot_buf), jnp.int32(len(got)),
            )
            self.graph.set_kf_alive(slot, True)
            self.graph.kf_frame_id[slot] = self.frame_id
            self.graph.kf_timestamp[slot] = timestamp
            if self.graph.origin_kf < 0:
                self.graph.origin_kf = slot
            self.ref_kf = slot
            self.ref_kf_tracked = max(int((feat_mp >= 0).sum()), 1)
            self._ref_mp_row = None  # refined at drain
            self.frames_since_kf = 0
            self.last_mp = None
            self.last_mp_dev = all_mp_dev
            self.last_kf_frame = frame
            # loop-closing detection query: BoW + corpus scoring need only
            # device arrays — dispatch now so the scores come back while
            # the insert pack does
            self._loop_pending = None
            if (self.cfg.enable_loop_closing and self.loop_closer is not None
                    and self.local_mapper is not None):
                self._loop_pending = self.loop_closer.dispatch_detection(
                    self.map, slot, self.local_mapper._fetch
                )
            fetch = (self.local_mapper._fetch if self.local_mapper is not None
                     else None)
            if fetch is not None:
                pack_fut = fetch(pack_dev)
            else:
                pack_fut = _Resolved(np.asarray(pack_dev))
            self._pending_insert = (slot, frame, pack_fut, got, timestamp)
            self._map_job = (slot, -1)
            if self.local_mapper is None:
                # no mapping pump to drain the insert — resolve inline
                self._drain_insert()
                self._map_job = None
            elif not self.cfg.pipelined:
                self._complete_mapping()
            return slot
        # ---- explicit-mask path (bootstrap initialization) ----
        n_new = int(create_mask.sum())
        new_slots = np.full(frame.capacity, INVALID, np.int64)
        if n_new:
            got = self.graph.alloc_point_slots(n_new)
            if len(got) < n_new:
                # capacity-tight: keep only the closest candidate points
                # (one rare device read; the common path never pays it)
                cand = np.nonzero(create_mask)[0]
                depth_np = np.asarray(frame.depth)
                keep = cand[np.argsort(depth_np[cand])[: len(got)]]
                create_mask = np.zeros_like(create_mask)
                create_mask[keep] = True
            new_slots[create_mask] = got[: int(create_mask.sum())]
        self.map, packed_dev = self._insert_kf(
            self.map, slot, frame, jnp.asarray(self.pose),
            jnp.asarray(feat_mp.astype(np.int32)),
            jnp.asarray(new_slots, jnp.int32),
        )
        packed = np.asarray(packed_dev)
        all_mp, levels = packed[0], packed[1]
        all_mp_dev = packed_dev[0]
        # host graph bookkeeping
        self.graph.set_levels(slot, levels)
        self.graph.set_kf_alive(slot, True)
        self.graph.kf_frame_id[slot] = self.frame_id
        self.graph.kf_timestamp[slot] = timestamp
        if self.graph.origin_kf < 0:
            self.graph.origin_kf = slot
        for f in np.nonzero(all_mp >= 0)[0]:
            pt = int(all_mp[f])
            if create_mask[f]:
                self.graph.pt_alive[pt] = True
                self.graph.note_new_point(pt, slot)
            self.graph.add_observation(pt, slot, int(f), False)
        self.graph.update_connections(slot, all_mp)
        self.ref_kf = slot
        self.ref_kf_tracked = int((all_mp >= 0).sum())
        self._ref_mp_row = all_mp.copy()
        self.frames_since_kf = 0
        self.last_mp = all_mp
        self.last_mp_dev = all_mp_dev
        self.last_kf_frame: FrameData = frame

        self._post_insert(slot, frame, sync_loop=True)
        if self.local_mapper is not None and self._map_job is not None \
                and not self.cfg.pipelined:
            self._complete_mapping()
        return slot

    def _drain_insert(self):
        """Resolve the async keyframe-insert pack and do the deferred graph
        bookkeeping + loop detection + triangulation dispatch (the work the
        reference's mapping thread does when it dequeues a keyframe,
        `/root/reference/src/LocalMapping.cc:303-333`)."""
        slot, frame, pack_fut, got, _ts = self._pending_insert
        self._pending_insert = None
        pack = pack_fut.result()
        all_mp, levels, created = pack[0], pack[1], pack[2].astype(bool)
        # replay the device's slot mapping: created features consumed
        # slot_buf[:n] in feature-index order; return the rest
        n_created = int(created.sum())
        if n_created < len(got):
            self.graph.return_point_slots(got[n_created:])
        self.graph.set_levels(slot, levels)
        for f in np.nonzero(all_mp >= 0)[0]:
            pt = int(all_mp[f])
            if created[f]:
                self.graph.pt_alive[pt] = True
                self.graph.note_new_point(pt, slot)
            self.graph.add_observation(pt, slot, int(f), False)
        self.graph.update_connections(slot, all_mp)
        if self.ref_kf == slot:
            self.ref_kf_tracked = int((all_mp >= 0).sum())
            self._ref_mp_row = all_mp.copy()
            self.last_mp = all_mp
        self._post_insert(slot, frame, sync_loop=False)

    def _post_insert(self, slot: int, frame: FrameData, sync_loop: bool):
        """Post-bookkeeping keyframe work: GBA merge, local-map window mask,
        recycled-counter hygiene, loop closing, triangulation dispatch."""
        cfg = self.cfg
        # merge any async global-BA result before growing the map further
        # (the reference's GBA thread merges under the map mutex,
        # src/LoopClosing.cc:370-452; here the merge lands at the next KF)
        if self._gba_pending is not None and self.loop_closer is not None:
            with self.timer.time("kf.gba_merge"):
                self.map, ginfo = self.loop_closer.merge_gba(
                    self.map, self.graph, self._gba_pending
                )
                self._gba_pending = None
                if self.last_loop_info is not None:
                    self.last_loop_info.update(ginfo)

        # covisibility-window local-map mask rebuild (opt-in for large maps)
        if cfg.local_map_window > 0:
            self._refresh_local_mask(slot)

        # zero the found/visible counters of any recycled point slots (their
        # previous life's statistics must not feed ratio culling)
        rec = getattr(self.graph, "recycled_log", None)
        if rec:
            self.graph.recycled_log = []
            if not hasattr(self, "_zero_counters"):
                # recycled slots also reset the last-seen stamp: a new
                # landmark must not inherit the old occupant's stamp and
                # masquerade as a re-acquired old landmark (seam trigger)
                self._zero_counters = jax.jit(
                    lambda v, f, sn, s: (v.at[s].set(0, mode="drop"),
                                         f.at[s].set(0, mode="drop"),
                                         sn.at[s].set(-1, mode="drop"))
                )
            pad = np.full(max(((len(rec) + 511) // 512) * 512, 512),
                          self.cfg.map_capacity.max_points, np.int32)
            pad[: len(rec)] = rec
            (self.mp_vis_dev, self.mp_found_dev,
             self.mp_seen_dev) = self._zero_counters(
                self.mp_vis_dev, self.mp_found_dev, self.mp_seen_dev,
                jnp.asarray(pad)
            )

        # BoW index + loop closing stage. Index maintenance runs even with
        # loop closing disabled — the database serves relocalization too
        # (reference KeyFrameDatabase, src/KeyFrameDatabase.cc:68-265).
        # The async path dispatched the BoW/scoring query at KF creation;
        # here (one frame later) the scores are on the host and the
        # detection logic runs on host mirrors.
        with self.timer.time("kf.loop"):
            pend = getattr(self, "_loop_pending", None)
            self._loop_pending = None
            before = (self.loop_closer.loops_closed
                      if self.loop_closer is not None else 0)
            if pend is not None:
                loop_kf = self.loop_closer.resolve_detection(
                    self.graph, slot, pend
                )
                if loop_kf is not None:
                    self._close_loop(frame, slot, loop_kf)
            elif cfg.enable_loop_closing:
                self._loop_closing_stage(frame, slot)
            else:
                self._ensure_bow_index(slot)
            # a candidate that failed the Sim3/projection gates did NOT
            # close a loop — the implicit check below must still run
            fired = (self.loop_closer is not None
                     and self.loop_closer.loops_closed > before)
            # implicit loop closure: whole-map matching re-acquired a
            # graph-distant region (see _implicit_loop_candidate) — run the
            # same Sim3-verified correction the BoW path would
            # consume the seam flag unconditionally: if a BoW loop fired at
            # the seam keyframe the work is done — the flag must not leak
            # into a later, unrelated keyframe and relax its covis gate
            seam = getattr(self, "_seam_pending", False)
            self._seam_pending = False
            if cfg.enable_loop_closing and not fired:
                cand = self._implicit_loop_candidate(
                    slot, min_weight=(8 if seam else 15)
                )
                if cand is not None:
                    import os as _os
                    if _os.environ.get("TPU_SLAM_DEBUG_LOOP"):
                        print(f"[implicit] slot={slot} cand={cand} "
                              f"seam={seam}", flush=True)
                    if seam:
                        # seam caught at its FIRST frame: the drift is still
                        # concentrated between this KF's re-acquired old
                        # landmarks and the drifted recent chain, so the
                        # EXPLICIT Sim3 + essential-graph correction (which
                        # also fuses drifted duplicates into the original
                        # landmarks) applies cleanly
                        before2 = self.loop_closer.loops_closed
                        self._close_loop(frame, slot, cand, implicit=False)
                        if self.loop_closer.loops_closed == before2:
                            # explicit gates rejected: fall back to the
                            # implicit (loop edge + global BA) pathway
                            self._close_loop(frame, slot, cand, implicit=True)
                    else:
                        self._close_loop(frame, slot, cand, implicit=True)

        # local mapping stage (reference Update order, src/LocalMapping.cc:93-130:
        # triangulate -> fuse neighbors -> cull points -> local BA -> cull KFs).
        # The stage runs as a state machine — the analog of the reference's
        # mapping THREAD working one keyframe behind tracking
        # (src/LocalMapping.cc:57-91). Pipelined mode pumps ONE step per
        # tracked frame, so every device->host readback has had a frame
        # to land asynchronously and the frame loop never
        # blocks on the mapping stage; synchronous mode completes the job
        # inline (deterministic per-frame semantics for tests/drivers).
        if self.local_mapper is not None and len(self.graph.alive_kfs()) >= 2:
            with self.timer.time("kf.triangulate"):
                self.map, _ = self.local_mapper.triangulate_new_points(
                    self.map, self.graph, slot
                )
            if slot % 2 == 0:
                # snapshot the found/visible counters now; the ratio-cull
                # rule drains them right before local BA (stage 1)
                self.local_mapper.queue_ratio_cull(
                    slot, self.mp_vis_dev, self.mp_found_dev
                )
            self._map_job = (slot, 0)
        else:
            self._map_job = None

    def _refresh_local_mask(self, center_slot: int):
        """Rebuild the covisibility-window landmark mask around
        `center_slot` (the reference's UpdateLocalMap / local-map point set,
        `/root/reference/src/Tracking.cc:55-185`). Host cost is a few numpy
        gathers; the upload is P bits (~32 KB) staged async."""
        P = self.cfg.map_capacity.max_points
        kfs = [center_slot] + self.graph.covis_neighbors(
            center_slot, top_k=self.cfg.local_map_window
        )
        mask = np.zeros(P, bool)
        rows = self.graph.kf_row[kfs]
        mask[rows[rows >= 0]] = True
        self.local_mask_dev = jnp.asarray(mask)

    def _maybe_refresh_local_mask(self):
        """Mid-interval staleness guard: with long keyframe intervals the
        window mask built at the last KF ages badly — refresh it around the
        reference keyframe every 8 frames between keyframes."""
        if (self.cfg.local_map_window > 0 and self.ref_kf >= 0
                and self.frames_since_kf > 0
                and self.frames_since_kf % 8 == 0):
            self._refresh_local_mask(self.ref_kf)

    def _pump_mapping(self, force: bool = False, max_stages: int = 2):
        """Advance the in-flight local-mapping job by up to `max_stages`
        READY stages (their fetches landed); `force` waits instead.

        Each stage consumes a readback that a worker thread has been
        fetching since the previous stage dispatched, so the frame loop
        never blocks on a mapping-stage transfer. Advancing two ready
        stages per frame lets the job finish before the next keyframe's
        blocking force path when fetches take several frame-times."""
        for _ in range(max(max_stages, 1)):
            before = getattr(self, "_map_job", None)
            self._pump_mapping_once(force)
            if getattr(self, "_map_job", None) == before:
                break

    def _pump_mapping_once(self, force: bool = False):
        lm = self.local_mapper
        job = getattr(self, "_map_job", None)
        if lm is None or job is None:
            return
        if getattr(self, "localization_only", False) and not force:
            # localization mode froze the map; a job can only exist here if
            # the mode flipped mid-cycle — hold it until deactivation
            return
        slot, stage = job
        if stage == -1:
            pend = getattr(self, "_pending_insert", None)
            if pend is None:
                self._map_job = (slot, 0)
                return
            if not force and not pend[2].done():
                return
            with self.timer.time("kf.insert_drain"):
                self._drain_insert()
            return
        if stage == 0:
            if not force and not lm.tri_ready():
                return
            # triangulation readback landed: insert points, then dispatch
            # neighbor fusion over the refreshed covisibility ring
            with self.timer.time("kf.tri_drain"):
                self.map = lm._drain_tri(self.map, self.graph)
            with self.timer.time("kf.fuse"):
                self.map, _ = lm.fuse_neighbors(self.map, self.graph, slot)
            self._map_job = (slot, 1)
        elif stage == 1:
            if not force and not lm.fuse_ready():
                return
            # fusion decisions landed: apply merges. The refresh/cull/BA
            # work is its own pump step (stage 2), so one frame does not
            # carry the host work of both
            with self.timer.time("kf.fuse_drain"):
                self.map = lm._drain_fuse(self.map, self.graph)
            self._map_job = (slot, 2)
        elif stage == 2:
            if not force and not lm.ratio_ready():
                return
            # refresh point stats, run the host culling rule, then
            # dispatch window BA
            with self.timer.time("kf.refresh_points"):
                self.map = lm.refresh_points(self.map, self.graph, slot)
            with self.timer.time("kf.cull_points"):
                self.map, _ = lm.cull_points(
                    self.map, self.graph, slot, vis_found=None,
                )
                # found/visible-ratio rule: counters were snapshotted at KF
                # creation (async copy has had the tri+fuse stages to land);
                # cull BEFORE BA so doomed points don't pollute the solve
                self.map = lm._drain_ratio_cull(self.map, self.graph)
            if self._gba_pending is None:
                with self.timer.time("kf.local_ba"):
                    self.map, info = lm.local_ba(self.map, self.graph, slot)
                self.last_ba_info = info
            else:
                # a global BA is in flight: its merge will overwrite every
                # launched pose, and a window solve NOW would drag the
                # loop-corrected seam back toward the still-drifted fixed
                # frontier (measured 0.4 m on the organic-loop circuit).
                # The reference likewise stops LocalMapping across the
                # correction+GBA (`src/LoopClosing.cc:532-544`).
                with self.timer.time("kf.local_ba_held"):
                    self.last_ba_info = None
            self._map_job = (slot, 3)
        else:
            # cull redundant keyframes. The BA outlier erasure stays pending
            # until the NEXT keyframe's drain (matching the reference's
            # mapping-thread lag): erasing observations + orphan-killing
            # marginal points immediately would thin the live tracking map
            # mid-interval.
            with self.timer.time("kf.cull_kfs"):
                self.map, killed = lm.cull_keyframes(self.map, self.graph, slot)
            if killed and self.loop_closer is not None:
                for k in killed:
                    self.loop_closer.db.erase(k)
            self._map_job = None
            if self.last_ba_info is not None and not self.cfg.pipelined:
                # adopt the BA-refined pose of the new keyframe as the
                # tracker's current pose (the reference's map-update mutex
                # hand-off, src/Tracking.cc:1196, becomes this re-read).
                # Synchronous mode completes the job in the same frame the
                # KF was created, so the adoption is exact; pipelined mode
                # skips it (the in-flight frames' device state would be
                # rewound and the read discarded).
                self.pose = np.asarray(self.map.kf_pose[slot])
                self.pose_dev = jnp.asarray(self.pose)

    def _complete_mapping(self):
        """Run the in-flight mapping job to completion. The BA outlier
        erasure may stay pending (it drains at the next keyframe);
        `_finalize_map` flushes that too."""
        while getattr(self, "_map_job", None) is not None:
            self._pump_mapping(force=True)

    def _finalize_map(self):
        """Complete the mapping job AND drain every deferred product —
        required before serialization or whole-map reads."""
        self._complete_mapping()
        if self.local_mapper is not None:
            self.map = self.local_mapper.drain_pending(self.map, self.graph)
