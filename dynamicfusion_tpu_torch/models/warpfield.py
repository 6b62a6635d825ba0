"""The deformation warp field (port of the frame-0 part of
``dynamicfusion_tpu.models.warpfield``): the static-capacity node
container, ``create`` and first-frame node sampling. The rigid slice
samples nodes at frame 0 and carries them unchanged; KNN, blending and
insertion come with the non-rigid slice."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.core import compact, dualquat


@functools.lru_cache(maxsize=32)
def _fair_perm(p: int) -> np.ndarray:
    """Fixed permutation of [0, p) so that truncation at node capacity
    drops a spatially uniform subset (the JAX package's RandomState(0))."""
    return np.random.RandomState(0).permutation(p).astype(np.int64)


class WarpField(NamedTuple):
    positions: torch.Tensor     # (N, 3) canonical node positions
    dq: torch.Tensor            # (N, 8) node transforms
    radius: torch.Tensor        # (N,)
    active: torch.Tensor        # (N,) bool
    count: torch.Tensor         # () int32
    last_support: torch.Tensor  # (N,) int32


def create(cfg: DynamicFusionConfig, device=None) -> WarpField:
    n = cfg.max_nodes
    return WarpField(
        positions=torch.zeros((n, 3), dtype=torch.float32, device=device),
        dq=dualquat.identity(device).expand(n, 8).clone(),
        radius=torch.full((n,), cfg.node_radius, dtype=torch.float32, device=device),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        last_support=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def init_from_cloud(
    cfg: DynamicFusionConfig, points: torch.Tensor, valid: torch.Tensor
) -> WarpField:
    """Every ``node_sample_step``-th valid surface vertex becomes a node
    with identity transform; candidates are permuted first (``_fair_perm``)
    and truncated at ``max_nodes`` with a static-size compaction."""
    if cfg.node_radius_adaptive:
        raise NotImplementedError("adaptive node radius: non-rigid slice")
    dev = points.device
    pts = points[:: cfg.node_sample_step]
    val = valid[:: cfg.node_sample_step]
    n = cfg.max_nodes
    perm = torch.from_numpy(_fair_perm(pts.shape[0])).to(dev)
    pts = pts[perm]
    val = val[perm]
    sel = compact.first_true(val, n)
    ok = sel >= 0
    pos = torch.where(ok[:, None], pts[sel.clamp(min=0)], 0.0)
    return WarpField(
        positions=pos,
        dq=dualquat.identity(dev).expand(n, 8).clone(),
        radius=torch.full((n,), cfg.node_radius, dtype=torch.float32, device=dev),
        active=ok,
        count=ok.sum(dtype=torch.int32),
        last_support=torch.zeros((n,), dtype=torch.int32, device=dev),
    )
