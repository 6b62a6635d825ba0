"""Dual quaternions (..., 8) = (real wxyz, dual wxyz): the part of
``dynamicfusion_tpu.core.dualquat`` that the warp-field container needs."""

from __future__ import annotations

import torch


def identity(device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)
