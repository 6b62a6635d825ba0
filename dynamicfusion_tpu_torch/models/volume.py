"""The canonical TSDF volume (port of ``dynamicfusion_tpu.models.volume``).

Two dense (D, D, D) tensors indexed [x, y, z] (z innermost). Storage
dtypes follow the config: tsdf i16 fixed point (x 32767), f32 or bf16,
weight u16 fixed point (x 512) or f32; the plain path and the CUDA
kernels (csrc/common.cuh) take all six pairs. All arithmetic is float32; codes are
decoded through int32/float, never with int16 arithmetic (the weight code
reaches 64 x 512 = 32768, past int16). Rounding is half-to-even, as
``torch.round`` and the CUDA kernels' ``rintf`` do.

The port updates the volume IN PLACE (brick fusion writes the voxels it
touches); the JAX package returns new arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamicfusion_tpu_torch import device as device_mod
from dynamicfusion_tpu_torch.config import DynamicFusionConfig

TSDF_SCALE = 32767.0   # i16 in [-1, 1]
WEIGHT_SCALE = 512.0   # u16 counter in [0, 127]

_TSDF_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i16": torch.int16}
_WEIGHT_DTYPES = {"f32": torch.float32, "u16": torch.uint16}


class TsdfVolume(NamedTuple):
    tsdf: torch.Tensor    # (D, D, D) int16 (x 32767) | float32 | bfloat16
    weight: torch.Tensor  # (D, D, D) uint16 (x 512) | float32


def create(cfg: DynamicFusionConfig, device="cuda") -> TsdfVolume:
    """An empty volume on ``device`` (CUDA unless the CPU is asked for), in
    the config's storage; the kernels take every storage."""
    device = device_mod.resolve(device)
    d = cfg.volume_dims
    return TsdfVolume(
        tsdf=torch.zeros((d, d, d), dtype=_TSDF_DTYPES[cfg.tsdf_dtype], device=device),
        weight=torch.zeros((d, d, d), dtype=_WEIGHT_DTYPES[cfg.weight_dtype], device=device),
    )


def tsdf_decode_scale(dtype) -> float:
    """Factor turning stored tsdf values into float tsdf (apply after a gather)."""
    return 1.0 / TSDF_SCALE if dtype == torch.int16 else 1.0


def decode_tsdf(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32) * tsdf_decode_scale(a.dtype)


def encode_tsdf(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int16:
        return torch.round(torch.clamp(x, -1.0, 1.0) * TSDF_SCALE).to(torch.int16)
    return x.to(dtype)


def decode_weight(a: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.uint16:
        return a.to(torch.int32).to(torch.float32) * (1.0 / WEIGHT_SCALE)
    return a.to(torch.float32)


def encode_weight(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.uint16:
        code = torch.round(torch.clamp(x, 0.0, 65535.0 / WEIGHT_SCALE) * WEIGHT_SCALE)
        return code.to(torch.int32).to(torch.uint16)
    return x.to(dtype)


def storage_view(a: torch.Tensor) -> torch.Tensor:
    """A view whose dtype torch can scatter into: uint16 as int16 (the
    same bits; CPU torch has no index_put for uint16)."""
    return a.view(torch.int16) if a.dtype == torch.uint16 else a


def convert(vol: TsdfVolume, cfg: DynamicFusionConfig) -> TsdfVolume:
    """Re-encode a volume to the config's storage dtypes, on the volume's
    device (the checkpoint's migration across storage settings)."""
    return TsdfVolume(
        tsdf=encode_tsdf(decode_tsdf(vol.tsdf), _TSDF_DTYPES[cfg.tsdf_dtype]),
        weight=encode_weight(decode_weight(vol.weight), _WEIGHT_DTYPES[cfg.weight_dtype]),
    )


def trunc_dist(cfg: DynamicFusionConfig) -> float:
    """Effective truncation distance: max(configured, 2.1 * voxel size)."""
    return max(cfg.tsdf_trunc_dist, 2.1 * cfg.voxel_size)


def origin(cfg: DynamicFusionConfig, device=None) -> torch.Tensor:
    return device_mod.const(tuple(cfg.volume_origin), torch.float32, torch.device(device or "cpu"))
