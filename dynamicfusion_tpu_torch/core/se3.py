"""SE(3) rigid transforms as (4, 4) homogeneous matrices (port of
``dynamicfusion_tpu.core.se3``). Points are (..., 3); transforms broadcast.
Per-point products are written out, not matmuls (``rotate``)."""

from __future__ import annotations

import torch

_EPS = 1e-12


def identity(device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def rotation(m: torch.Tensor) -> torch.Tensor:
    return m[..., :3, :3]


def translation(m: torch.Tensor) -> torch.Tensor:
    return m[..., :3, 3]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b (apply b first)."""
    return a @ b


def _eye_like(shape, dtype, device) -> torch.Tensor:
    # from eye, not zeros plus `m[..., 3, 3] = 1.0`: writing a Python number
    # into a CUDA tensor copies it from the host and waits for the stream
    return torch.eye(4, dtype=dtype, device=device).expand(shape).clone()


def inverse(m: torch.Tensor) -> torch.Tensor:
    """Rigid inverse: [Rᵀ | -Rᵀ t]."""
    rt = rotation(m).transpose(-1, -2)
    out = _eye_like(m.shape, m.dtype, m.device)
    out[..., :3, :3] = rt
    out[..., :3, 3] = -(rt @ translation(m)[..., None])[..., 0]
    return out


def rotate(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3, 3) ``r`` applied to vectors (..., 3): three multiply-adds per
    component in a fixed order. Not a matmul: a threaded BLAS may round a
    row differently depending on how it splits the rows among threads."""
    return v[..., 0:1] * r[:, 0] + v[..., 1:2] * r[:, 1] + v[..., 2:3] * r[:, 2]


def transform_points(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) to points (..., 3)."""
    return rotate(rotation(m), p) + translation(m)


def rotate_dirs(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation (directions, normals)."""
    return rotate(rotation(m), v)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> (3, 3) rotation matrix, first-order near 0."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    small = theta < 1e-8
    k = rvec / torch.clamp(theta, min=_EPS)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    kmat = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], dim=-1).reshape(
        rvec.shape[:-1] + (3, 3)
    )
    st = torch.sin(theta)[..., None]
    ct = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    full = eye + st * kmat + (1.0 - ct) * (kmat @ kmat)
    rx, ry, rz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    lin = eye + torch.stack([zero, -rz, ry, rz, zero, -rx, -ry, rx, zero], dim=-1).reshape(
        rvec.shape[:-1] + (3, 3)
    )
    return torch.where(small[..., None], lin, full)


def exp_twist(xi: torch.Tensor) -> torch.Tensor:
    """6-vector (rx, ry, rz, tx, ty, tz) -> (4, 4) with R = rodrigues(r) and
    the literal translation t (the reference's ICP increment)."""
    m = _eye_like(xi.shape[:-1] + (4, 4), xi.dtype, xi.device)
    m[..., :3, :3] = rodrigues(xi[..., :3])
    m[..., :3, 3] = xi[..., 3:]
    return m
