"""Pinhole camera projection / unprojection and radial-tangential distortion.

Capability analog of the reference's `CameraProjection`/`CameraUnProjection`
(`/root/reference/include/CameraProjection.h:31-109`) and `CameraParameters`
(`include/CameraParameters.h:29-40`), plus the keypoint undistortion done in
the System frontend (`/root/reference/src/System.cc:153-174`). Everything is
batched over trailing point axes and jit-friendly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import se3


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics. `bf` = baseline * fx (reference `Camera.bf`)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    bf: jnp.ndarray  # 0.0 for monocular

    @staticmethod
    def create(fx, fy, cx, cy, bf=0.0) -> "CameraIntrinsics":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return CameraIntrinsics(f(fx), f(fy), f(cx), f(cy), f(bf))

    @property
    def baseline(self):
        return self.bf / self.fx


class DistCoeffs(NamedTuple):
    """OpenCV-style radial-tangential distortion [k1,k2,p1,p2,k3]."""

    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    k3: jnp.ndarray

    @staticmethod
    def create(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0) -> "DistCoeffs":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return DistCoeffs(f(k1), f(k2), f(p1), f(p2), f(k3))

    @property
    def is_zero(self):
        # Static check usable outside jit (python floats / concrete arrays).
        return all(float(v) == 0.0 for v in self)


def project(cam: CameraIntrinsics, xc):
    """Camera-frame points [...,3] -> pixel coords [...,2] (no distortion)."""
    z = xc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * xc[..., 0] * inv_z + cam.cx
    v = cam.fy * xc[..., 1] * inv_z + cam.cy
    return jnp.stack([u, v], axis=-1)


def project_stereo(cam: CameraIntrinsics, xc):
    """Camera-frame points -> [u, v, u_right] (reference stereo residual,
    `Thirdparty/g2o/g2o/types/types_six_dof_expmap.cpp` stereo cam_project)."""
    uv = project(cam, xc)
    z = xc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf * inv_z
    return jnp.concatenate([uv, ur[..., None]], axis=-1)


def unproject(cam: CameraIntrinsics, uv, depth):
    """Pixels [...,2] + depth [...] -> camera-frame 3D points [...,3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def disparity_to_depth(cam: CameraIntrinsics, disparity):
    return cam.bf / jnp.maximum(disparity, 1e-9)


def project_world(cam: CameraIntrinsics, pose_cw, xw):
    """World points through world-to-camera pose -> pixels + camera z."""
    xc = se3.transform(pose_cw, xw)
    return project(cam, xc), xc[..., 2]


def distort_normalized(dist: DistCoeffs, xn):
    """Apply distortion to normalized image coords [...,2]."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + dist.k1 * r2 + dist.k2 * r2 * r2 + dist.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_points(cam: CameraIntrinsics, dist: DistCoeffs, uv, iters: int = 8):
    """Iteratively invert the distortion model (cv::undistortPoints analog).

    Capability parity with `UndistortKeyPoints` (`/root/reference/src/System.cc:153-174`).
    """
    xn0 = jnp.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], axis=-1
    )
    xn = xn0
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + dist.k1 * r2 + dist.k2 * r2 * r2 + dist.k3 * r2 * r2 * r2
        dx = 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
        dy = dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
        xn = jnp.stack(
            [(xn0[..., 0] - dx) / radial, (xn0[..., 1] - dy) / radial], axis=-1
        )
    return jnp.stack(
        [xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], axis=-1
    )


def undistort_points_np(fx, fy, cx, cy, coeffs, uv, iters: int = 8):
    """Host (numpy) undistortion for init-time work: static quantities
    (image bounds) are computed here without device dispatches.
    coeffs=(k1,k2,p1,p2,k3)."""
    import numpy as np

    k1, k2, p1, p2, k3 = coeffs
    uv = np.asarray(uv, np.float64)
    xn0 = np.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    xn = xn0.copy()
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = np.stack([(xn0[..., 0] - dx) / radial,
                       (xn0[..., 1] - dy) / radial], -1)
    return np.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], -1)


def image_bounds_np(fx, fy, cx, cy, coeffs, width: int, height: int):
    """Undistorted image bounds from the 4 corners, host-side
    (`/root/reference/src/System.cc:177-195`). Returns (min_x, max_x,
    min_y, max_y) python floats (static jit constants)."""
    import numpy as np

    corners = np.array(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]]
    )
    und = undistort_points_np(fx, fy, cx, cy, coeffs, corners)
    return (
        float(min(und[0, 0], und[2, 0])), float(max(und[1, 0], und[3, 0])),
        float(min(und[0, 1], und[1, 1])), float(max(und[2, 1], und[3, 1])),
    )


def compute_image_bounds(cam: CameraIntrinsics, dist: DistCoeffs, width: int, height: int):
    """Undistorted image bounds from the 4 corners
    (`/root/reference/src/System.cc:177-195`). Returns (min_x, max_x, min_y, max_y)."""
    corners = jnp.array(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]], jnp.float32
    )
    und = undistort_points(cam, dist, corners)
    min_x = jnp.minimum(und[0, 0], und[2, 0])
    max_x = jnp.maximum(und[1, 0], und[3, 0])
    min_y = jnp.minimum(und[0, 1], und[1, 1])
    max_y = jnp.maximum(und[2, 1], und[3, 1])
    return min_x, max_x, min_y, max_y
