"""Multi-scale ORB feature extraction, fully vectorized for the device.

Capability analog of the reference `ORBextractor`
(`/root/reference/src/ORBextractor.cc:743-820`): 8-level image pyramid,
grid-tiled two-threshold FAST, spatially-spread per-level feature budgets
(quad-tree suppression analog), intensity-centroid orientation (IC_Angle,
`:74-101`), Gaussian blur + rotated-BRIEF 256-bit descriptors
(`ComputeOrbDescriptor`, `:103-140`), packed as uint32[8] bit tensors.

Design choices for an accelerator (not a translation):
- Whole-level FAST as shifted-plane arithmetic (see `ops/fast.py`) instead of
  per-cell scalar loops; the two-threshold fallback is a max-pooled cell mask.
- Quad-tree suppression (`:542-693`) is replaced by rank-in-cell boosted
  top-k: every occupied cell contributes its best corner before any cell
  contributes its k-th — same spatial-spread budget semantics, one sort.
- The sampling pattern is a fresh deterministic BRIEF pattern (seeded
  isotropic Gaussian, radius-clipped), NOT the OpenCV learned table: this
  build has no cross-compatibility requirement with reference descriptors,
  only self-consistency.
- Orientation + descriptor sampling are per-keypoint 31x31 patch gathers,
  vmapped; all shapes static so one compiled program serves every frame.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fast as fast_ops
from . import image as image_ops

PATCH_SIZE = 31
HALF_PATCH = 15
EDGE_MARGIN = 19  # reference EDGE_THRESHOLD (src/ORBextractor.cc:69)
PATTERN_RADIUS = 13  # keeps rotated samples inside the 31x31 patch


# ---------------------------------------------------------------------------
# Constant tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256,2,2] int32: 256 (pointA, pointB) pairs, deterministic.

    Isotropic Gaussian sampling (sigma = PATCH/5) clipped to PATTERN_RADIUS,
    seeded so descriptors are reproducible across processes.
    """
    rng = np.random.default_rng(20260817)
    pts = []
    while len(pts) < 512:
        p = rng.normal(0.0, PATCH_SIZE / 5.0, size=2)
        p = np.round(p).astype(np.int32)
        if p[0] ** 2 + p[1] ** 2 <= PATTERN_RADIUS ** 2:
            pts.append(p)
    pat = np.stack(pts).reshape(256, 2, 2)
    # drop degenerate pairs (identical endpoints) by nudging point B
    same = np.all(pat[:, 0] == pat[:, 1], axis=-1)
    pat[same, 1, 0] = np.clip(pat[same, 1, 0] + 1, -PATTERN_RADIUS, PATTERN_RADIUS)
    return pat


@functools.lru_cache(maxsize=1)
def learned_pattern() -> np.ndarray:
    """[256,2,2] int32: the standard learned ORB test-pair table.

    This is the published greedy-search pattern from the ORB paper (Rublee
    et al. 2011), shipped as `bit_pattern_31_` data in OpenCV and the
    reference (`/root/reference/src/ORBextractor.cc:142`). It is a DATA
    constant, not code: using it makes descriptors live in the same bit
    space as externally trained vocabularies (e.g. the stock ORBvoc.txt),
    which pure self-consistency (`brief_pattern`) cannot provide.
    Layout: [pair, (pointA, pointB), (x, y)]; offsets within radius 13,
    so rotated samples stay inside EDGE_MARGIN=19.
    """
    import os
    path = os.path.join(os.path.dirname(__file__), "orb_pattern_cv.npy")
    pat = np.load(path)
    assert pat.shape == (256, 2, 2)
    return pat.astype(np.int32)


def get_pattern(name: str) -> np.ndarray:
    if name == "fresh":
        return brief_pattern()
    if name == "learned":
        return learned_pattern()
    raise ValueError(f"unknown BRIEF pattern {name!r} (fresh|learned)")


@functools.lru_cache(maxsize=1)
def _umax_table() -> np.ndarray:
    """The reference's circular-patch rim table (`src/ORBextractor.cc:704-719`):
    umax[v] = half-width of row v of the radius-15 patch, built with cvRound
    and a symmetry fix. NOT identical to floor(sqrt(r^2-v^2)): it admits a
    ring of rim pixels (e.g. (+-15, +-1)) a plain x^2+y^2<=r^2 mask excludes,
    which shifts IC angles by ~4 deg median on texture — so we transcribe
    the exact table (tests/test_orb_parity.py asserts exact angle parity)."""
    half = HALF_PATCH
    umax = np.zeros(half + 2, np.int64)
    vmax = int(np.floor(half * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half + 1]


@functools.lru_cache(maxsize=1)
def circular_patch_masks() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mask, x*mask, y*mask) over the 31x31 patch — the IC_Angle moment
    weights (src/ORBextractor.cc:74-101), using the reference's exact umax
    rim (see `_umax_table`)."""
    umax = _umax_table()
    ys, xs = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    mask = (np.abs(xs) <= umax[np.abs(ys)]).astype(np.float32)
    return mask, (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


def features_per_level(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Per-level budgets, geometric decay (`src/ORBextractor.cc:472-487`)."""
    f = 1.0 / scale_factor
    first = n_features * (1.0 - f) / (1.0 - f ** n_levels)
    counts, total = [], 0
    for l in range(n_levels - 1):
        c = int(round(first * f ** l))
        counts.append(c)
        total += c
    counts.append(max(n_features - total, 0))
    return counts


# ---------------------------------------------------------------------------
# Per-level selection: rank-in-cell boosted top-k (quad-tree analog)
# ---------------------------------------------------------------------------

def select_spread_topk(score, k: int, cell: int = 32, rank_rounds: int = 4):
    """Pick k maxima of `score` [H,W] with spatial spread.

    Rank-in-cell boosting: within each (cell x cell) tile, corners are ranked
    by response; the sort key is `BIG * (rank_rounds - min(rank, rank_rounds))
    + score`, so rank-0 corners across all tiles outrank every rank-1 corner,
    etc. This reproduces the quad-tree suppression's budget semantics
    (`src/ORBextractor.cc:542-693`: spread first, best-response within node)
    with a single global top-k. Returns (ys, xs, scores, valid) of length k.
    """
    h, w = score.shape
    # NOTE on small levels: with few 32px cells the rank loop below runs
    # dozens of SEQUENTIAL tiny argmaxes (level 7 at 80x60: ~37 rounds).
    # An adaptive cell (halve until C >= k) bounds the rounds at ~6, but the
    # stronger spread enforcement on small levels reshuffles the
    # scale-invariant features loops match on, and the 100k-vocab loop
    # circuit's corrected ATE regressed 0.048 -> 0.090 m, so it was
    # reverted. A CROSS-LEVEL BATCHED form (concatenate all levels' tiles,
    # run the rank rounds once — bit-identical selection) was slower on the
    # former accelerator; neither is measured on the H100.
    ph, pw = (-h) % cell, (-w) % cell
    sp = jnp.pad(score, ((0, ph), (0, pw)))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    C = hc * wc
    tiles = sp.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(C, cell * cell)
    # rank within cell by iterated argmax: round r extracts each cell's
    # r-th best corner. The global top-k then runs over the [rounds*C]
    # candidate list instead of the full [H*W] image (a ~250x smaller
    # top_k than an image-wide scatter + top_k). The
    # candidate pool must survive sparse occupancy: texture often covers
    # only ~25% of cells (e.g. a close-up wall), so rounds*C >= 6k keeps
    # pool_occupied = rounds * C/4 >= 1.5k. At VGA this stays ~5 rounds;
    # small pyramid levels take more rounds of a much smaller argmax.
    rounds = max(rank_rounds, -(-6 * k) // max(C, 1))
    work = tiles
    keys, raws, poss = [], [], []
    big = 1e6
    cidx = jnp.arange(C)
    for r in range(rounds):
        am = jnp.argmax(work, axis=1)  # [C]
        mx = work[cidx, am]
        # ranks beyond rank_rounds carry no boost (the reference's
        # quad-tree only guarantees spread for the first occupants)
        b = float(max(rank_rounds - r, 0))
        keys.append(jnp.where(mx > 0, big * b + mx, -1.0))
        raws.append(mx)
        poss.append(am)
        work = work.at[cidx, am].set(-1.0)
    key = jnp.concatenate(keys)   # [rounds*C]
    raw = jnp.concatenate(raws)
    pos = jnp.concatenate(poss)
    topv, topi = jax.lax.top_k(key, k)
    c = topi % C
    p = pos[topi]
    ys = (c // wc) * cell + p // cell
    xs = (c % wc) * cell + p % cell
    sel_scores = raw[topi]
    valid = topv > 0
    # padded-region pixels have score 0 and are excluded by `valid`, but
    # clamp coords anyway for safe downstream gathers
    return jnp.minimum(ys, h - 1), jnp.minimum(xs, w - 1), sel_scores, valid


# ---------------------------------------------------------------------------
# Orientation + descriptors (patch gathers)
# ---------------------------------------------------------------------------

def _gather_patches(img, ys, xs):
    """[K,31,31] patches centered at integer coords (assumed >= margin).

    Row-gather then column-slice: `img[ys+dy]` pulls whole contiguous rows
    and the vmapped dynamic_slice trims columns (XLA fuses the row gather
    into the slice, so the [K,31,W] intermediate need not materialize).
    Against a per-keypoint 2-D dynamic_slice or a flat-index gather, not
    measured on the H100."""
    d = jnp.arange(-HALF_PATCH, HALF_PATCH + 1)
    rows = img[ys[:, None] + d[None, :]]  # [K,31,W]
    return jax.vmap(
        lambda r, x: jax.lax.dynamic_slice(
            r, (0, x - HALF_PATCH), (PATCH_SIZE, PATCH_SIZE)
        )
    )(rows, xs)


def ic_angles(img, ys, xs):
    """Intensity-centroid orientation per keypoint (IC_Angle analog)."""
    mask, xm, ym = circular_patch_masks()
    patches = _gather_patches(img, ys, xs)  # [K,31,31]
    m10 = jnp.sum(patches * jnp.asarray(xm), axis=(1, 2))
    m01 = jnp.sum(patches * jnp.asarray(ym), axis=(1, 2))
    return jnp.arctan2(m01, m10)


N_ANGLE_BINS = 64  # 5.6 deg: rotation quantization under the 0.5px rounding
                   # the continuous path already applies at radius<=13


def pattern_fits_window(pattern: str) -> bool:
    """True when every rotated+rounded test point stays inside the 31x31
    patch (radius <= 14). The fresh pattern is radius-clipped to 13; the
    learned OpenCV table has corner points out to radius 18.4 (it samples
    within the EDGE_THRESHOLD=19 margin instead), so it keeps the
    full-image gather path."""
    pat = get_pattern(pattern).astype(np.float64)
    return float(np.sqrt((pat ** 2).sum(-1)).max()) <= HALF_PATCH - 1


@functools.lru_cache(maxsize=2)
def diff_tables(pattern: str) -> Tuple[np.ndarray, int]:
    """(int8[B,S*S,256], support) steered-BRIEF difference matrices.

    For angle bin b, column i holds +1 at the rotated pattern point A and -1
    at point B (flattened SxS window coords), so
    `sign(window_flat @ D[b]) == (sample_A < sample_B)` — the BRIEF test as
    ONE matmul contraction instead of 512 scalar gathers per keypoint. The
    rotation is quantized to B bins (the continuous path rounds rotated
    offsets to integers anyway, the same 0.5px scale as a 5.6 deg bin at
    radius 13).

    The window is trimmed to the pattern's exact rotated support S=2*sup+1
    (27x27 for the radius-13 fresh pattern): the [K,S^2,256] table gather
    dominates the descriptor stage's memory traffic, so dropping the 31x31
    window's guaranteed-zero border rows is a free ~25% cut."""
    pat = get_pattern(pattern)
    B = N_ANGLE_BINS
    taps = []  # (bin, ry, rx, col, sign)
    sup = 0
    for b in range(B):
        th = (b + 0.5) * 2 * np.pi / B - np.pi
        c, s = np.cos(th), np.sin(th)
        for i in range(256):
            for j, sign in ((0, 1), (1, -1)):
                x, y = pat[i, j]
                rx = int(round(x * c - y * s))
                ry = int(round(x * s + y * c))
                sup = max(sup, abs(rx), abs(ry))
                taps.append((b, ry, rx, i, sign))
    sup = min(sup, HALF_PATCH)
    S = 2 * sup + 1
    D = np.zeros((B, S * S, 256), np.int8)
    for b, ry, rx, i, sign in taps:
        D[b, (ry + sup) * S + (rx + sup), i] += sign
    return D, sup


def _pack_bits(bits):
    """bool[K,256] -> uint32[K,8] (exact f32 byte dot, then shifts)."""
    byte_w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.float32)
    # default precision: 0/1 bits times powers of two summed to <= 255 is
    # exact in TF32 as in f32
    bytes_f = bits.reshape(-1, 8, 4, 8).astype(jnp.float32) @ byte_w  # [K,8,4]
    b = bytes_f.astype(jnp.uint32)
    return b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)


def brief_descriptors_mxu(blurred, ys, xs, angles, pattern: str = "fresh"):
    """Rotated-BRIEF via angle-binned difference matrices, one bf16 matmul.

    Instead of the 512-sample flat gather (`brief_descriptors`), this
    gathers each keypoint's 31x31 blurred window (cheap row-gather) and
    contracts it with a per-bin +-1 matrix; its cost is the [K,961,256]
    table rows it reads (not measured on the H100). Descriptors differ from
    `brief_descriptors` only by the 5.6-deg angle quantization (~11/256
    bits on noise images, far less on blurred real frames); all matching is
    internally consistent either way."""
    win = _gather_patches(blurred, ys, xs).reshape(-1, 961)
    return _brief_from_windows(win, angles, pattern)


def _brief_from_windows(win, angles, pattern: str):
    D_np, sup = diff_tables(pattern)
    D = jnp.asarray(D_np)  # int8[B,S*S,256] (HLO constant)
    S = 2 * sup + 1
    if S < PATCH_SIZE:  # trim the window to the pattern's rotated support
        lo, hi = HALF_PATCH - sup, HALF_PATCH + sup + 1
        win = win.reshape(-1, PATCH_SIZE, PATCH_SIZE)[
            :, lo:hi, lo:hi
        ].reshape(-1, S * S)
    B = N_ANGLE_BINS
    bin_ = jnp.floor((angles + np.pi) * (B / (2 * np.pi))).astype(jnp.int32) % B
    diffs = jnp.einsum(
        "kp,kpq->kq", win.astype(jnp.bfloat16), D[bin_].astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return _pack_bits(diffs < 0)


def _gather_patches_r(img, ys, xs, radius: int):
    """[K,2r+1,2r+1] patches (generalized _gather_patches; same row-gather
    + column-slice lowering)."""
    P = 2 * radius + 1
    d = jnp.arange(-radius, radius + 1)
    rows = img[ys[:, None] + d[None, :]]  # [K,P,W]
    return jax.vmap(
        lambda r, x: jax.lax.dynamic_slice(r, (0, x - radius), (P, P))
    )(rows, xs)


@functools.lru_cache(maxsize=2)
def _blur31_matrix(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """[37,31] band matrix: (B^T raw37 B)[c,d] equals the full-image
    separable Gaussian evaluated on the interior 31x31 window (identical
    coefficients; windows sit >= EDGE_MARGIN from the border, so the
    full-image reflect padding never reaches them)."""
    from .image import _gaussian_kernel

    k = _gaussian_kernel(ksize, sigma)
    halo = ksize // 2
    B = np.zeros((PATCH_SIZE + 2 * halo, PATCH_SIZE), np.float32)
    for c in range(PATCH_SIZE):
        B[c: c + ksize, c] = k
    return B


def angles_and_descriptors_mxu_raw(lvl, ys, xs, pattern: str = "fresh"):
    """Fused IC-angle + rBRIEF from ONE raw-image window gather, blurring
    IN-WINDOW: the 37x37 raw patch collapses to the blurred 31x31 window
    via two small matmuls (B^T P B), so the full-image GaussianBlur pass
    (`src/ORBextractor.cc:791`) disappears from the per-level pipeline.
    Bit-identical to blurring the whole level first (interior windows,
    same kernel), just cheaper: the blur work follows the keypoints
    instead of the pixels."""
    halo = 3  # 7-tap kernel
    raw = _gather_patches_r(lvl, ys, xs, HALF_PATCH + halo)  # [K,37,37]
    B = jnp.asarray(_blur31_matrix())
    # blur in f32 regardless of the pyramid dtype (level 0 is exact in
    # bf16, so the blurred window — and the descriptor bits — stay
    # bit-identical to the f32 pipeline there)
    hi = jax.lax.Precision.HIGHEST
    # HIGHEST: in TF32 the window moves 0.1 gray and flips BRIEF bits (H100)
    win = jnp.einsum("ac,kab,bd->kcd", B, raw.astype(jnp.float32),
                     B, precision=hi).reshape(-1, 961)
    _, xm, ym = circular_patch_masks()
    mom = jnp.asarray(
        np.stack([xm.reshape(-1), ym.reshape(-1)], axis=1)
    )  # f32[961,2]
    # HIGHEST: TF32 moments move the angle 0.03 deg, past the 0.01 deg parity
    m = jnp.dot(win, mom, precision=hi)
    ang = jnp.arctan2(m[:, 1], m[:, 0])
    return ang, _brief_from_windows(win, ang, pattern)


def brief_descriptors(blurred, ys, xs, angles, pattern: str = "fresh"):
    """Rotated-BRIEF 256-bit descriptors packed into uint32[K,8].

    Samples the blurred level image at the rotated pattern offsets
    (steered BRIEF, `ComputeOrbDescriptor` semantics `src/ORBextractor.cc:103-140`).
    The 512 samples gather DIRECTLY from the flat image rather than with a
    per-row `take_along_axis` out of pre-gathered patches. Bit packing rides
    an exact f32 byte dot instead of a u32 multiply-reduce."""
    pat = jnp.asarray(get_pattern(pattern), jnp.float32)  # [256,2,2] (x,y)
    cos_t = jnp.cos(angles)[:, None, None]  # [K,1,1]
    sin_t = jnp.sin(angles)[:, None, None]
    px = pat[None, :, :, 0]  # [1,256,2]
    py = pat[None, :, :, 1]
    rx = jnp.round(px * cos_t - py * sin_t).astype(jnp.int32)  # [K,256,2]
    ry = jnp.round(px * sin_t + py * cos_t).astype(jnp.int32)
    h, w = blurred.shape
    iy = ys[:, None, None] + ry
    ix = xs[:, None, None] + rx
    k = iy.shape[0]
    samples = blurred.reshape(-1)[
        (iy * w + ix).reshape(k, -1).reshape(-1)
    ].reshape(k, 256, 2)
    return _pack_bits(samples[..., 0] < samples[..., 1])


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

class OrbFeatures(NamedTuple):
    xy: jnp.ndarray        # f32[K,2] level-0 coords
    level: jnp.ndarray     # i32[K]
    angle: jnp.ndarray     # f32[K]
    response: jnp.ndarray  # f32[K]
    desc: jnp.ndarray      # u32[K,8]
    valid: jnp.ndarray     # bool[K]


class OrbExtractor:
    """Compile-once ORB pipeline for a fixed image geometry.

    Params mirror the reference defaults (`include/ORBextractor.h:38-47`):
    nfeatures, scaleFactor=1.2, nlevels=8, iniThFAST=20, minThFAST=7.
    """

    def __init__(
        self,
        height: int,
        width: int,
        n_features: int = 1000,
        scale_factor: float = 1.2,
        n_levels: int = 8,
        ini_th_fast: float = 20.0,
        min_th_fast: float = 7.0,
        cell: int = 32,
        pattern: str = "fresh",
        desc_mode: str = "mxu",
    ):
        self.height, self.width = height, width
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th, self.min_th = float(ini_th_fast), float(min_th_fast)
        self.cell = cell
        self.pattern = pattern
        self.desc_mode = desc_mode
        self.budgets = features_per_level(n_features, n_levels, scale_factor)
        self.level_scales = [scale_factor ** l for l in range(n_levels)]
        self._extract = jax.jit(self._extract_impl)

    def __call__(self, img) -> OrbFeatures:
        return self._extract(img)

    def _extract_impl(self, img) -> OrbFeatures:
        return self._extract_impl_pyr(img)[0]

    def _extract_impl_pyr(self, img) -> Tuple[OrbFeatures, List]:
        """Like `_extract_impl` but also returns the f32 pyramid levels, so
        callers that need them again (stereo SAD refinement) don't rebuild
        the resize chain."""
        img = image_ops.to_gray(img)
        # The pyramid stays f32. A bf16 pyramid halves the resize chain's
        # and FAST planes' bytes (level 0 stays bit-exact since intensities
        # are integers), but the ~0.4-gray rounding of INTERPOLATED upper
        # levels perturbs keypoint selection enough to cost stereo
        # association accuracy (stereo-odometry ATE 0.044 -> 0.059 m, past
        # its gate); its speed is not measured on the H100. fast.py still
        # computes in the input dtype, so the bf16 option remains one cast
        # away for mono/RGB-D-only deploys.
        levels = image_ops.build_pyramid(img, self.n_levels, self.scale_factor)
        outs = []
        for l, lvl in enumerate(levels):
            k = self.budgets[l]
            if k <= 0:
                continue
            h, w = lvl.shape
            score = fast_ops.detect_two_threshold(lvl, self.ini_th, self.min_th)
            # static edge margin so every 31x31 patch gather stays in-bounds
            yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
            xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
            inb = (
                (yy >= EDGE_MARGIN)
                & (yy < h - EDGE_MARGIN)
                & (xx >= EDGE_MARGIN)
                & (xx < w - EDGE_MARGIN)
            )
            score = jnp.where(inb, score, 0.0)
            ys, xs, resp, valid = select_spread_topk(score, k, self.cell)
            # clamp for safe gathers on invalid (padded) slots
            ys_c = jnp.clip(ys, EDGE_MARGIN, h - 1 - EDGE_MARGIN)
            xs_c = jnp.clip(xs, EDGE_MARGIN, w - 1 - EDGE_MARGIN)
            if self.desc_mode == "mxu" and pattern_fits_window(self.pattern):
                # one RAW window gather feeds blur + IC-angle moments + the
                # BRIEF contraction; no full-image blur pass (see
                # angles_and_descriptors_mxu_raw)
                ang, desc = angles_and_descriptors_mxu_raw(
                    lvl, ys_c, xs_c, self.pattern
                )
            else:
                blurred = image_ops.gaussian_blur(lvl, 7, 2.0)
                ang = ic_angles(lvl, ys_c, xs_c)
                desc = brief_descriptors(blurred, ys_c, xs_c, ang, self.pattern)
            s = self.level_scales[l]
            xy0 = jnp.stack([xs_c.astype(jnp.float32), ys_c.astype(jnp.float32)], -1) * s
            outs.append(
                OrbFeatures(
                    xy=xy0,
                    level=jnp.full((k,), l, jnp.int32),
                    angle=ang,
                    response=resp,
                    desc=desc,
                    valid=valid,
                )
            )
        return OrbFeatures(
            xy=jnp.concatenate([o.xy for o in outs]),
            level=jnp.concatenate([o.level for o in outs]),
            angle=jnp.concatenate([o.angle for o in outs]),
            response=jnp.concatenate([o.response for o in outs]),
            desc=jnp.concatenate([o.desc for o in outs]),
            valid=jnp.concatenate([o.valid for o in outs]),
        ), levels
