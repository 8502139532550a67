"""Frame: the per-image measurement bundle as a fixed-shape pytree.

Capability analog of the reference `Frame` (`/root/reference/src/Frame.cc:161-196`,
`include/Frame.h`): keypoints (raw + undistorted), packed ORB descriptors,
per-keypoint stereo u_right / depth, and map-point associations. Redesigned
for an accelerator: every field is a statically-shaped array padded to `capacity`
features with a validity mask — no per-frame dynamic allocation, so one
compiled tracking program serves every frame.

The reference's 64x48 bucket grid (`src/Frame.cc:64-145`) exists to make
radius queries O(1) on CPU; on the device the dense masked candidate matrix
IS the fast path (vectorized Hamming over all pairs), so the grid is not
replicated — `GetFeaturesInArea` semantics are a masked distance test.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class FrameData(NamedTuple):
    """One image's measurements, padded to a static feature capacity N."""

    xy: jnp.ndarray        # f32[N,2] undistorted pixel coords
    xy_raw: jnp.ndarray    # f32[N,2] raw (distorted) pixel coords
    level: jnp.ndarray     # i32[N] pyramid level
    angle: jnp.ndarray     # f32[N] orientation (radians)
    response: jnp.ndarray  # f32[N] corner score
    desc: jnp.ndarray      # u32[N,8] packed 256-bit rBRIEF
    u_right: jnp.ndarray   # f32[N] right-image u coord (-1 = mono/no match)
    depth: jnp.ndarray     # f32[N] depth (-1 = unknown)
    valid: jnp.ndarray     # bool[N]

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def num_valid(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def empty_frame(capacity: int) -> FrameData:
    return FrameData(
        xy=jnp.zeros((capacity, 2), jnp.float32),
        xy_raw=jnp.zeros((capacity, 2), jnp.float32),
        level=jnp.zeros((capacity,), jnp.int32),
        angle=jnp.zeros((capacity,), jnp.float32),
        response=jnp.zeros((capacity,), jnp.float32),
        desc=jnp.zeros((capacity, 8), jnp.uint32),
        u_right=-jnp.ones((capacity,), jnp.float32),
        depth=-jnp.ones((capacity,), jnp.float32),
        valid=jnp.zeros((capacity,), bool),
    )


def scale_factors(n_levels: int, scale_factor: float):
    """Per-level scale / sigma2 tables (`/root/reference/include/Frame.h:50-59`)."""
    import numpy as np

    sf = scale_factor ** np.arange(n_levels, dtype=np.float32)
    return jnp.asarray(sf), jnp.asarray(sf**2), jnp.asarray(1.0 / sf**2)
