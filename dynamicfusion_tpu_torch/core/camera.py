"""Pinhole projection helpers (port of ``dynamicfusion_tpu.core.camera``)."""

from __future__ import annotations

import torch

from dynamicfusion_tpu_torch.config import Intrinsics


def pixel_grid(rows: int, cols: int, device=None, dtype=torch.float32):
    """(u, v) coordinate grids of shape (rows, cols)."""
    v = torch.arange(rows, dtype=dtype, device=device)[:, None].expand(rows, cols)
    u = torch.arange(cols, dtype=dtype, device=device)[None, :].expand(rows, cols)
    return u, v


def _per(x: torch.Tensor, f: float) -> torch.Tensor:
    """x / f with f as a tensor: CUDA PyTorch multiplies by the reciprocal
    of a Python scalar, where kernel I (and the JAX package) divide."""
    return x / torch.tensor(f, dtype=x.dtype, device=x.device)


def backproject(intr: Intrinsics, u: torch.Tensor, v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixel (u, v) at depth z -> camera-space (..., 3)."""
    x = _per(z * (u - intr.cx), intr.fx)
    y = _per(z * (v - intr.cy), intr.fy)
    return torch.stack([x, y, z], dim=-1)


def ray_norms(intr: Intrinsics, rows: int, cols: int, device=None) -> torch.Tensor:
    """Per-pixel ||K⁻¹ (u, v, 1)||: z-depth to ray distance."""
    u, v = pixel_grid(rows, cols, device)
    xl = _per(u - intr.cx, intr.fx)
    yl = _per(v - intr.cy, intr.fy)
    return torch.sqrt(xl * xl + yl * yl + 1.0)
