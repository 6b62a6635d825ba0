"""Batched quaternion algebra (port of ``dynamicfusion_tpu.core.quat``).

Quaternions are tensors of shape ``(..., 4)`` in ``(w, x, y, z)`` order;
every function broadcasts over leading dimensions. Sums over the four (or
three) components are written out left to right, the order the CUDA
kernels repeat, so that a kernel and its plain version round alike.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def identity(device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def sum4(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 4, left to right, keeping it."""
    return ((a[..., 0:1] + a[..., 1:2]) + a[..., 2:3]) + a[..., 3:4]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product p ⊗ q."""
    pw, px, py, pz = p.unbind(-1)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        dim=-1,
    )


def conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def norm(q: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def normalize(q: torch.Tensor) -> torch.Tensor:
    """q / |q|, gradient-safe at q = 0 (returned unchanged there): the norm
    is taken of a where-guarded value, so sqrt never differentiates at 0."""
    n2 = sum4(q * q)
    small = n2 < _EPS
    return q / torch.sqrt(torch.where(small, 1.0, n2))


def dot(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return sum4(p * q)[..., 0]


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for a rotation of ``angle`` radians about ``axis``
    (the axis is normalized first)."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=_EPS)
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)[..., None]
    half = 0.5 * angle
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def from_rotvec(r: torch.Tensor) -> torch.Tensor:
    """Exponential-map encoding: angle |r| about r / |r|; safe at r = 0."""
    n2 = (r * r).sum(dim=-1, keepdim=True)
    small = n2 < 1e-12
    angle = torch.sqrt(torch.where(small, 1.0, n2))
    half = 0.5 * angle
    k = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - n2 / 8.0, torch.cos(half))
    return torch.cat([w, r * k], dim=-1)


def to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`from_rotvec` for unit quaternions."""
    q = normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = torch.atan2(sin_half, w)
    small = sin_half < 1e-6
    scale = torch.where(small, 2.0 + 2.0 * half * half / 3.0, 2.0 * half / torch.clamp(sin_half, min=_EPS))
    return v * scale


def exp_pure(v: torch.Tensor) -> torch.Tensor:
    """Quaternion exponential of the pure quaternion (0, v): a rotation by
    2|v| about v / |v|. Differentiable at v = 0, where the warp solver
    linearizes: the norm is taken of a where-guarded value and the small
    branch is a polynomial in |v|^2."""
    n2 = (v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]) + v[..., 2:3] * v[..., 2:3]
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, 1.0, n2))
    k = torch.where(small, 1.0 - n2 / 6.0, torch.sin(n) / n)
    w = torch.where(small, 1.0 - n2 / 2.0, torch.cos(n))
    return torch.cat([w, v * k], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4) with the
    15-op form v + 2 u × (u × v + w v)."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * cross(u, uv + w * v)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> unit quaternion, branch-free: all four
    Shepperd candidates, the best-conditioned one selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    sw = torch.sqrt(torch.clamp(tw, min=_EPS)) * 2.0
    sx = torch.sqrt(torch.clamp(tx, min=_EPS)) * 2.0
    sy = torch.sqrt(torch.clamp(ty, min=_EPS)) * 2.0
    sz = torch.sqrt(torch.clamp(tz, min=_EPS)) * 2.0
    qw = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    qx = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    qy = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], dim=-1)
    qz = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], dim=-1)
    t = torch.stack([tw, tx, ty, tz], dim=-1)
    best = torch.argmax(t, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    q = torch.take_along_dim(cands, best[..., None, None].expand(best.shape + (1, 4)), dim=-2)[..., 0, :]
    return normalize(q)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical linear interpolation (shortest arc)."""
    d = dot(q0, q1)[..., None]
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / torch.clamp(sin_theta, min=_EPS))
    w1 = torch.where(small, t, torch.sin(t * theta) / torch.clamp(sin_theta, min=_EPS))
    return normalize(w0 * q0 + w1 * q1)
