"""Quaternion / SO(3) / angle math as batched PyTorch functions.

Counterpart of ``legged_gym_dev_tpu/core/maths.py``. Quaternions are
``(x, y, z, w)`` (scalar-last), as in Isaac Gym and the JAX package.
Every function is batched over leading axes.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] (floor modulo, as ``jnp.mod``)."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def wrap_angles(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angles into [0, 2*pi) (floor modulo, as ``jnp.mod``)."""
    return torch.remainder(angle, 2.0 * math.pi)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of an (x,y,z,w) quaternion."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of an (x,y,z,w) quaternion (conjugate / squared norm)."""
    return quat_conjugate(q) / torch.clamp(
        torch.sum(q * q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (x,y,z,w) quaternions."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (x,y,z,w)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of unit quaternion q."""
    return quat_apply(quat_conjugate(q), v)


def quat_to_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw (z euler) of an (x,y,z,w) quaternion."""
    x, y, z, w = q.unbind(-1)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    return torch.atan2(siny_cosp, cosy_cosp)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z euler angles (roll, pitch, yaw) of an (x,y,z,w)
    quaternion."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_xyz_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """(x,y,z,w) quaternion from extrinsic x-y-z euler angles."""
    cr, cp, cy = torch.cos(0.5 * rpy).unbind(-1)
    sr, sp, sy = torch.sin(0.5 * rpy).unbind(-1)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([x, y, z, w], dim=-1)


def yaw_to_quat(yaw: torch.Tensor) -> torch.Tensor:
    """(x,y,z,w) quaternion for a pure-yaw rotation."""
    zeros = torch.zeros_like(yaw)
    return torch.stack([zeros, zeros, torch.sin(0.5 * yaw),
                        torch.cos(0.5 * yaw)], dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the yaw component of q to v."""
    return quat_apply(yaw_to_quat(quat_to_yaw(q)), v)


def yaw2rot(yaw: torch.Tensor) -> torch.Tensor:
    """2x2 world->body rotation for a yaw, row-major [[c, s], [-s, c]];
    shape (..., 2, 2)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, s], dim=-1),
                        torch.stack([-s, c], dim=-1)], dim=-2)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix from (x,y,z,w) quaternion; shape (..., 3, 3)."""
    q = quat_normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Log map of an (x,y,z,w) unit quaternion -> axis-angle vector in R^3
    (the short geodesic: w >= 0). Below ``sin_half < 1e-6`` the scale
    angle / sin(angle / 2) takes its series 2 + (2/3) half_angle^2; the
    other branch divides by a denominator made safe there, so neither
    branch sees a NaN."""
    q = quat_normalize(q)
    q = torch.where(q[..., 3:4] < 0.0, -q, q)
    v = q[..., :3]
    sin_half = torch.linalg.vector_norm(v, dim=-1)
    half_angle = torch.atan2(sin_half, q[..., 3])
    small = sin_half < 1e-6
    scale = torch.where(small, 2.0 + (2.0 / 3.0) * half_angle ** 2,
                        2.0 * half_angle / torch.where(small, 1.0, sin_half))
    return v * scale[..., None]


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Exp map: axis-angle vector in R^3 -> (x,y,z,w) unit quaternion."""
    angle = torch.linalg.vector_norm(phi, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-6
    k = torch.where(small, 0.5 - angle ** 2 / 48.0,
                    torch.sin(half) / torch.where(small, 1.0, angle))
    return torch.cat([phi * k, torch.cos(half)], dim=-1)


def _signed_sqrt_to_range(u: torch.Tensor, lower: float,
                          upper: float) -> torch.Tensor:
    """u in [-1, 1] through the sign-keeping square root, rescaled to
    [lower, upper]."""
    r = torch.where(u < 0.0, -torch.sqrt(-u), torch.sqrt(u))
    return (r + 1.0) / 2.0 * (upper - lower) + lower


def torch_rand_sqrt_float(gen: torch.Generator, lower: float, upper: float,
                          shape) -> torch.Tensor:
    """Signed-sqrt-shaped random floats in [lower, upper], on ``gen``'s
    device: u ~ U(-1, 1) through the sign-keeping square root, rescaled;
    the samples lean toward the interval's ends (used for velocity
    resets)."""
    u = torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0
    return _signed_sqrt_to_range(u, lower, upper)


def masked_update(mask: torch.Tensor, new: torch.Tensor,
                  old: torch.Tensor) -> torch.Tensor:
    """where(mask, new, old) with the (B,) mask broadcast over trailing
    dims: the per-env update primitive of the masked-reset style."""
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)
