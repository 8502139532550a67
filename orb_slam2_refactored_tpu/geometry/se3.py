"""SE(3) rigid transforms as quaternion + translation arrays.

Capability analog of the reference's `CameraPose` (R,t as cv::Matx,
`/root/reference/include/CameraPose.h:29-89`), redesigned for the device: poses are
flat float32 arrays `[qw,qx,qy,qz,tx,ty,tz]` so whole keyframe sets batch as
`[N,7]` tensors, every op broadcasts over leading axes, and tangent-space
exp/log provide the Levenberg-Marquardt update rule that the reference gets
from g2o's `SE3Quat::exp` (`Thirdparty/g2o/g2o/types/se3quat.h`).

Convention: a pose `T = (q, t)` maps points `x_parent -> q * x * q^-1 + t`.
Camera poses are world-to-camera (`Tcw`) like the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A pose is a float32[..., 7] array: [qw, qx, qy, qz, tx, ty, tz].
POSE_DIM = 7
TANGENT_DIM = 6  # [omega(3), upsilon(3)] — rotation first, translation second


def identity(batch_shape=()) -> jnp.ndarray:
    p = jnp.zeros(batch_shape + (POSE_DIM,), jnp.float32)
    return p.at[..., 0].set(1.0)


# ---------------------------------------------------------------------------
# Quaternion primitives (wxyz, Hamilton convention)
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_rotate(q, v):
    """Rotate 3-vectors v by unit quaternions q (broadcasting)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    # v' = v + 2*w*(u x v) + 2*(u x (u x v))
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m):
    """Robust rotation-matrix -> quaternion (Shepperd's method, branchless)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 0.0))

    # Four candidate constructions; pick the numerically largest pivot.
    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = jnp.stack([qw0, (m21 - m12) / (4 * qw0 + 1e-12),
                    (m02 - m20) / (4 * qw0 + 1e-12),
                    (m10 - m01) / (4 * qw0 + 1e-12)], axis=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = jnp.stack([(m21 - m12) / (4 * qx1 + 1e-12), qx1,
                    (m01 + m10) / (4 * qx1 + 1e-12),
                    (m02 + m20) / (4 * qx1 + 1e-12)], axis=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = jnp.stack([(m02 - m20) / (4 * qy2 + 1e-12),
                    (m01 + m10) / (4 * qy2 + 1e-12), qy2,
                    (m12 + m21) / (4 * qy2 + 1e-12)], axis=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = jnp.stack([(m10 - m01) / (4 * qz3 + 1e-12),
                    (m02 + m20) / (4 * qz3 + 1e-12),
                    (m12 + m21) / (4 * qz3 + 1e-12), qz3], axis=-1)

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    # Canonical sign: qw >= 0
    q = jnp.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE3 ops on [...,7] arrays
# ---------------------------------------------------------------------------

def make(q, t):
    return jnp.concatenate([q, t], axis=-1)


def rotation(p):
    return p[..., 0:4]


def translation(p):
    return p[..., 4:7]


def normalize(p):
    return make(quat_normalize(rotation(p)), translation(p))


def compose(a, b):
    """Return a @ b (apply b first, then a)."""
    q = quat_mul(rotation(a), rotation(b))
    t = quat_rotate(rotation(a), translation(b)) + translation(a)
    return make(quat_normalize(q), t)


def inverse(p):
    qi = quat_conj(rotation(p))
    return make(qi, -quat_rotate(qi, translation(p)))


def transform(p, x):
    """Apply pose to 3D points x[...,3] (broadcasting over leading dims)."""
    return quat_rotate(_bcast(rotation(p), x), x) + _bcast(translation(p), x)


def _bcast(field, x):
    """Broadcast a pose field [...,k] against points [..., N, 3] if needed."""
    if field.ndim == x.ndim:
        return field
    return field[..., None, :]


def to_matrix(p):
    """[...,7] -> [...,4,4] homogeneous matrix."""
    r = quat_to_matrix(rotation(p))
    t = translation(p)
    top = jnp.concatenate([r, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], p.dtype), p.shape[:-1] + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def from_matrix(m):
    return make(quat_from_matrix(m[..., :3, :3]), m[..., :3, 3])


def from_Rt(r, t):
    return make(quat_from_matrix(r), t)


# ---------------------------------------------------------------------------
# so(3)/se(3) exp & log — tangent order [omega, upsilon]
# ---------------------------------------------------------------------------

def _so3_exp_quat(omega):
    """Axis-angle [...,3] -> unit quaternion, Taylor-safe near 0."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    half = 0.5 * theta
    small = theta2 < 1e-12
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    return quat_normalize(jnp.concatenate([w, k * omega], axis=-1))


def _so3_log(q):
    """Unit quaternion -> axis-angle [...,3], Taylor-safe near identity."""
    q = jnp.where(q[..., 0:1] < 0, -q, q)
    w = jnp.clip(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vnorm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    theta = 2.0 * jnp.arctan2(vnorm, w)
    small = vnorm < 1e-6
    k = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), theta / jnp.maximum(vnorm, 1e-24))
    return k * v


def _skew(v):
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def _left_jacobian(omega):
    """SO(3) left Jacobian V such that exp_se3 translation = V @ upsilon."""
    theta2 = jnp.sum(omega * omega, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    K = _skew(omega)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    small = theta2 < 1e-12
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-24))
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, 1e-24))
    return eye + a * K + b * KK


def _left_jacobian_inv(omega):
    theta2 = jnp.sum(omega * omega, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    K = _skew(omega)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    small = theta2 < 1e-12
    half_theta = 0.5 * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * jnp.cos(half_theta) / jnp.maximum(jnp.sin(half_theta), 1e-24))
        / jnp.maximum(theta2, 1e-24),
    )
    return eye - 0.5 * K + cot_term * KK


def exp(tangent):
    """se(3) exp: [...,6] ([omega, upsilon]) -> pose [...,7]."""
    omega = tangent[..., 0:3]
    ups = tangent[..., 3:6]
    q = _so3_exp_quat(omega)
    V = _left_jacobian(omega)
    t = (V @ ups[..., :, None])[..., 0]
    return make(q, t)


def log(p):
    """Pose [...,7] -> se(3) tangent [...,6]."""
    omega = _so3_log(rotation(p))
    Vinv = _left_jacobian_inv(omega)
    ups = (Vinv @ translation(p)[..., :, None])[..., 0]
    return jnp.concatenate([omega, ups], axis=-1)


def retract(p, delta):
    """Left-multiplicative LM update: exp(delta) @ p."""
    return compose(exp(delta), p)


def boxminus(a, b):
    """log(a @ b^-1): the tangent that retracts b onto a."""
    return log(compose(a, inverse(b)))
