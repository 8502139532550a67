"""Vectorized FAST-9/16 corner detection with scores, whole-image at once.

Capability analog of the reference's grid-tiled `cv::FAST` usage
(`/root/reference/src/ORBextractor.cc:489-540`): segment test on the 16-pixel
Bresenham circle (radius 3) requiring >=9 contiguous brighter/darker pixels.
Accelerator-first: instead of per-cell scalar loops, the whole level is evaluated as
16 shifted image planes; the contiguous-arc test is a log-time AND-cascade
over circularly concatenated masks, and the per-cell two-threshold fallback
(`:519-539`) becomes a max-pooled cell mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 (same circle as FAST-9/16), clockwise from top.
CIRCLE_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)  # (dx, dy) pairs
ARC_LEN = 9


def _shifted_planes(img):
    """[16,H,W] circle-sampled planes via jnp.roll (border rows invalid)."""
    planes = []
    for dx, dy in CIRCLE_OFFSETS:
        planes.append(jnp.roll(img, shift=(-dy, -dx), axis=(0, 1)))
    return jnp.stack(planes, axis=0)


def _contiguous_arc(mask16):
    """mask16: bool[16,H,W] -> bool[H,W]: any run of ARC_LEN consecutive true
    (circular). AND-cascade: m_k[i] = AND of window starting at i, length k."""
    m = mask16
    # window 9 = 8+1: build with shifts by 1,2,4 then 8 (circular axis 0)
    w2 = m & jnp.roll(m, -1, axis=0)       # length 2
    w4 = w2 & jnp.roll(w2, -2, axis=0)     # length 4
    w8 = w4 & jnp.roll(w4, -4, axis=0)     # length 8
    w9 = w8 & jnp.roll(m, -8, axis=0)      # length 9
    return jnp.any(w9, axis=0)


def _arc_min_cascade(vals):
    """vals: f32[16,H,W] -> f32[16,H,W] where out[i] = min over circular
    window of length ARC_LEN starting at i."""
    m = vals
    w2 = jnp.minimum(m, jnp.roll(m, -1, axis=0))
    w4 = jnp.minimum(w2, jnp.roll(w2, -2, axis=0))
    w8 = jnp.minimum(w4, jnp.roll(w4, -4, axis=0))
    return jnp.minimum(w8, jnp.roll(m, -8, axis=0))


def fast_strength_map(img):
    """Threshold-free FAST-9/16 arc strength for every pixel.

    f32[H,W]: max over the 16 circular 9-windows of min(|I_circle - I_p|),
    zeroed outside the 3px border. One evaluation serves every threshold
    (`score(th) = strength - th`), so the two-threshold detector pays for
    the 16 shifted planes once.

    Computes in the INPUT dtype: a bf16 pyramid level halves the bytes
    of the 16 shifted planes (the stage's dominant traffic), and the
    arithmetic here is exact for integer-valued bf16 images (differences
    of intensities <= 255 are representable; the cascades are pure
    min/max). Returns f32 either way — downstream sort keys add large
    rank-boost constants that bf16 cannot carry.
    """
    img = jnp.asarray(img)
    if not jnp.issubdtype(img.dtype, jnp.floating):
        img = img.astype(jnp.float32)  # uint8 would underflow on subtract
    planes = _shifted_planes(img)           # [16,H,W]
    d = planes - img[None]                  # circle minus center

    bright_strength = _arc_min_cascade(d)       # min over 9-window of d
    dark_strength = _arc_min_cascade(-d)        # min over 9-window of -d
    s_bright = jnp.max(bright_strength, axis=0)  # best window
    s_dark = jnp.max(dark_strength, axis=0)
    strength = jnp.maximum(s_bright, s_dark).astype(jnp.float32)

    h, w = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    border = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(border, strength, 0.0)


def fast_score_map(img, threshold: float):
    """FAST-9/16 corner response for every pixel.

    Returns f32[H,W]: 0 where not a corner; otherwise a positive score =
    max over qualifying arcs of min(|I_circle - I_p|) - threshold margin
    (the arc strength, an analog of OpenCV's max-threshold score used for
    NMS ordering).
    """
    s = fast_strength_map(img) - threshold
    return jnp.where(s > 0, s, 0.0)


def nms3x3(score):
    """3x3 non-max suppression: keep pixels that are the strict max of their
    neighborhood (ties broken toward top-left)."""
    neigh = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh.append(jnp.roll(score, (dy, dx), axis=(0, 1)))
    nmax = jnp.stack(neigh, 0).max(0)
    return jnp.where(score >= jnp.maximum(nmax, 1e-9), score, 0.0)


def cell_pool_any(mask, cell: int):
    """bool[H,W] -> bool[H,W]: per (cell x cell) tile OR, broadcast back."""
    h, w = mask.shape
    ph = (-h) % cell
    pw = (-w) % cell
    m = jnp.pad(mask, ((0, ph), (0, pw)))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    tiles = m.reshape(hc, cell, wc, cell).any(axis=(1, 3))
    back = jnp.repeat(jnp.repeat(tiles, cell, axis=0), cell, axis=1)
    return back[:h, :w]


def detect_two_threshold(img, ini_th: float, min_th: float, cell: int = 30):
    """Two-threshold FAST with per-cell fallback + 3x3 NMS.

    Semantics of `DetectFAST` (`/root/reference/src/ORBextractor.cc:489-540`):
    detect at `ini_th`; cells where nothing fired retry at `min_th`. The
    16-plane strength computes ONCE; both thresholds derive from it.
    Returns f32[H,W] response map (0 = no corner).
    """
    s = fast_strength_map(img)
    hi = jnp.maximum(s - ini_th, 0.0)
    lo = jnp.maximum(s - min_th, 0.0)
    has_hi = cell_pool_any(hi > 0, cell)
    score = jnp.where(has_hi, hi, lo)
    return nms3x3(score)
