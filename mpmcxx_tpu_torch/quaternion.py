"""Quaternion rotations on tensors.

JAX twin: mpmcxx_tpu/quaternion.py (src/Quaternion.cpp semantics:
axis-angle construction, Hamilton product, v' = q * v * q~, the
equivalent rotation matrix).  Quaternions
are ``[..., 4] = [w, x, y, z]``.
"""

from __future__ import annotations

import torch

from . import constants as const


def from_axis_angle(axis, angle_rad):
    """Quaternion rotating by ``angle_rad`` about ``axis`` (need not be
    normalised; a zero axis gives the identity)."""
    norm = torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    u = axis / torch.where(norm == 0.0, 1.0, norm)
    half = angle_rad / 2.0
    return torch.cat([torch.cos(half)[..., None],
                      u * torch.sin(half)[..., None]], dim=-1)


def from_axis_angle_deg(axis, angle_deg):
    return from_axis_angle(axis, angle_deg * const.pi / 180.0)


def multiply(q1, q2):
    """Hamilton product of ``[..., 4]`` quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(q, v):
    """Rotate vectors ``v[..., 3]`` by quaternion ``q[..., 4]``: q v q~."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return multiply(q, multiply(qv, conjugate(q)))[..., 1:]


def rotation_matrix(q):
    """The 3x3 rotation matrix of quaternion ``q[..., 4]`` (batched); a
    zero quaternion gives the identity."""
    w, x, y, z = q.unbind(-1)
    n = w * w + x * x + y * y + z * z
    s = torch.where(n == 0.0, 0.0, 2.0 / torch.where(n == 0.0, 1.0, n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)
