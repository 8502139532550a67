"""Image wire codec: fixed-rate 8x8 DCT, for links whose bandwidth bounds ingest.

The gray image dominates the per-frame payload (307 KB of ~312 KB at VGA);
the same economics that gave depth its log8 wire format (1 byte/px,
ATE-gated) apply to the image. This codec stores each 8x8 block's low 4x4
DCT coefficients at fixed rate (16 bytes / 64 px = 2 bit/px -> 76.8 KB at
VGA): no entropy coding, so DECODE IS TWO SMALL MATMULS per block — a
batched einsum on device. Whether it pays on a PCIe-attached H100 is
not measured.

Why a lowpass wire format is mostly compatible with ORB: the descriptor
path already reads sigma=2-BLURRED windows (`ops/orb.py` in-window blur
matching `src/ORBextractor.cc:791`), and FAST thresholds (20/7) sit far
above the quantization noise; the low 4x4 band keeps block-texture
corners.

MEASURED TRADEOFF (VGA bench, 2026-08-21): +15-30% fps in byte-bound link
phases, but ATE rises 1.94 -> 2.4-3.2 cm (half-pixel keypoint shifts from
block-edge ringing feed triangulation noise) — one run crossed the
bench's HARD 3 cm gate and zeroed the score, so `image_encoding="raw"`
remains the scored default and this codec is an OPT-IN for deployments
whose accuracy budget tolerates ~1 cm for the payload cut
(tests/test_codec.py pins the quality floor and tracking parity bounds).

Encode is host numpy (batched BLAS matmuls, releases the GIL — it rides
the upload worker pool); decode is jnp inside the tracking step program.
"""

from __future__ import annotations

import functools
import os

import numpy as np

BLOCK = 8
# coefficients kept per axis: 4 -> 2 bit/px (PSNR ~37 dB), 5 -> 3.1 bit/px
# (PSNR ~40 dB; recovers most of the raw format's ATE at VGA)
KEEP = int(os.environ.get("TPU_SLAM_DCT_KEEP", "4"))
AC_STEP = float(os.environ.get("TPU_SLAM_DCT_STEP", "6.0"))
BYTES_PER_BLOCK = KEEP * KEEP


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II basis C[8,8]: X = C x C^T."""
    k = np.arange(BLOCK)
    C = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * BLOCK))
    C *= np.sqrt(2.0 / BLOCK)
    C[0] *= np.sqrt(0.5)
    return C.astype(np.float32)


def encoded_nbytes(h: int, w: int) -> int:
    return (h // BLOCK) * (w // BLOCK) * BYTES_PER_BLOCK


def encode_dct(img: np.ndarray) -> np.ndarray:
    """u8/f32 gray [H,W] (H,W multiples of 8) -> u8[encoded_nbytes].

    Per block: DC stored as round(dc/8) in u8 (the block mean, step 1
    gray); the 15 kept AC coefficients as round(ac/AC_STEP) in i8."""
    h, w = img.shape
    assert h % BLOCK == 0 and w % BLOCK == 0, (h, w)
    C = _dct_matrix()
    x = np.asarray(img, np.float32).reshape(
        h // BLOCK, BLOCK, w // BLOCK, BLOCK
    ).transpose(0, 2, 1, 3)                      # [bh,bw,8,8]
    X = C @ x @ C.T                              # batched BLAS
    K = X[..., :KEEP, :KEEP]                     # low 4x4
    out = np.empty(K.shape[:2] + (BYTES_PER_BLOCK,), np.uint8)
    dc = np.clip(np.rint(K[..., 0, 0] / 8.0), 0, 255)
    ac = np.clip(np.rint(K / AC_STEP), -127, 127).astype(np.int8)
    flat = ac.reshape(K.shape[:2] + (BYTES_PER_BLOCK,))
    out[:] = flat.view(np.uint8)
    out[..., 0] = dc.astype(np.uint8)
    return out.reshape(-1)


def decode_dct_np(buf: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host reference decoder (tests / oracles)."""
    C = _dct_matrix()
    bh, bw = h // BLOCK, w // BLOCK
    raw = np.asarray(buf, np.uint8).reshape(bh, bw, BYTES_PER_BLOCK)
    K = raw.view(np.int8).astype(np.float32) * AC_STEP
    K = K.reshape(bh, bw, KEEP, KEEP).copy()
    K[..., 0, 0] = raw[..., 0].astype(np.float32) * 8.0
    Cr = C[:KEEP]                                # [4,8]
    x = Cr.T @ K @ Cr                            # [bh,bw,8,8]
    return x.transpose(0, 2, 1, 3).reshape(h, w)


def decode_dct(buf, h: int, w: int):
    """Device decoder: u8[encoded] -> f32[h,w]. Two batched matmuls."""
    import jax.numpy as jnp

    C = _dct_matrix()
    bh, bw = h // BLOCK, w // BLOCK
    raw = buf.reshape(bh, bw, BYTES_PER_BLOCK)
    # i8 view via bitcast; DC byte is u8, the rest i8
    signed = jnp.where(raw < 128, raw.astype(jnp.float32),
                       raw.astype(jnp.float32) - 256.0)
    K = (signed * AC_STEP).reshape(bh, bw, KEEP, KEEP)
    K = K.at[..., 0, 0].set(raw[..., 0].astype(jnp.float32) * 8.0)
    Cr = jnp.asarray(C[:KEEP])                   # [4,8]
    # x = Cr^T @ K @ Cr per block, one batched einsum
    x = jnp.einsum("ak,bwkl,lc->bwac", Cr.T, K, Cr)
    return x.transpose(0, 2, 1, 3).reshape(h, w)
