"""Image-space primitives: pyramid resize, separable Gaussian blur, grayscale.

Capability analog of the OpenCV calls the reference leans on
(`cv::resize` / `cv::GaussianBlur` in `/root/reference/src/ORBextractor.cc:455-470,791`
and `ConvertToGray` in `src/System.cc:122-151`), implemented as XLA-fusible
jnp ops with static shapes.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def to_gray(img):
    """RGB[H,W,3] (or gray[H,W]) uint8/float -> float32 gray [H,W]."""
    img = jnp.asarray(img)
    if img.ndim == 3:
        w = jnp.array([0.299, 0.587, 0.114], jnp.float32)
        # default precision: on the H100 it matches the CPU to 2e-5 gray
        img = jnp.tensordot(img.astype(jnp.float32), w, axes=([-1], [0]))
    return img.astype(jnp.float32)


def resize_bilinear(img, out_hw: Tuple[int, int]):
    """Bilinear resize (cv::INTER_LINEAR analog) for [H,W] float images."""
    # HIGHEST (jax.image's default, kept explicit): TF32 moves levels 1-7
    # by up to 0.26 gray on the H100, which shifts FAST and BRIEF tests
    return jax.image.resize(img, out_hw, method="linear",
                            precision=jax.lax.Precision.HIGHEST)


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for l in range(n_levels):
        s = scale_factor ** l
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of per-level images, level 0 = input resolution.

    Like the reference (`src/ORBextractor.cc:455-470`), each level is resized
    from the previous one (not from level 0) to match its smoothing cascade.
    """
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with edge replication (BORDER_REFLECT_101-ish).

    Matches the pre-descriptor blur in the reference
    (`src/ORBextractor.cc:791`: GaussianBlur(7,7,2,2))."""
    k = jnp.asarray(_gaussian_kernel(ksize, sigma))
    r = ksize // 2
    # pad reflect then two 1-D convolutions via dot over shifted stacks
    p = jnp.pad(img, ((r, r), (r, r)), mode="reflect")
    # horizontal
    # default precision: on the H100 both passes match the CPU to 5e-5 gray
    cols = jnp.stack([p[:, i : i + img.shape[1]] for i in range(ksize)], axis=-1)
    hpass = cols @ k
    # vertical
    rows = jnp.stack([hpass[i : i + img.shape[0], :] for i in range(ksize)], axis=-1)
    return rows @ k
