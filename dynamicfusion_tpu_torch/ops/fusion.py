"""Non-rigid TSDF fusion through the warp field (port of the brick branch of
``dynamicfusion_tpu.ops.fusion``).

The warp is evaluated exactly on the coarse corner grid of the volume
((D / knn_field_stride + 1)^3 points: KNN + DQB, kernel E) once a frame;
that one evaluation gives the blended dual quaternion, the blend quality
and the warped corner, and is shared by the fusion (voxel positions and
observation weight, prolonged trilinearly inside kernel D) and by the
model-map warp (``warp_points_trilinear``, kernel E's trilinear entry).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.core import dualquat, se3
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.models import warpfield
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.models.warpfield import WarpField


def coarse_corner_points(cfg: DynamicFusionConfig, device=None) -> torch.Tensor:
    """World positions of the (D/stride + 1)^3 coarse voxel corners,
    flattened (Dc^3, 3) in x-major order."""
    s = cfg.knn_field_stride
    dc = cfg.volume_dims // s + 1
    ax = torch.arange(dc, dtype=torch.float32, device=device) * (s * cfg.voxel_size)
    org = volume_model.origin(cfg, device)
    cx = (ax + org[0])[:, None, None].expand(dc, dc, dc)
    cy = (ax + org[1])[None, :, None].expand(dc, dc, dc)
    cz = (ax + org[2])[None, None, :].expand(dc, dc, dc)
    return torch.stack([cx, cy, cz], dim=-1).reshape(-1, 3)


class CoarseField(NamedTuple):
    dq: torch.Tensor      # (Dc, Dc, Dc, 8) blended field dual quaternion
    q: torch.Tensor       # (Dc, Dc, Dc) blend quality clip(mean w, 0, 1)
    warped: torch.Tensor  # (Dc, Dc, Dc, 3) warped corner, world frame


def coarse_field(cfg: DynamicFusionConfig, field: WarpField, plain: bool = False) -> CoarseField:
    """ONE exact KNN + DQB evaluation of the field at the coarse corners."""
    dc = cfg.volume_dims // cfg.knn_field_stride + 1
    pts = coarse_corner_points(cfg, field.positions.device)
    r = warpfield.knn_blend(field, pts, cfg.knn_k, blend=True, warp=True, plain=plain)
    return CoarseField(r.blend.reshape(dc, dc, dc, 8), r.quality.reshape(dc, dc, dc), r.points.reshape(dc, dc, dc, 3))


def warp_points_trilinear_plain(
    cfg: DynamicFusionConfig, dq_grid: torch.Tensor, points: torch.Tensor, normals: Optional[torch.Tensor] = None
):
    """DQB-warp world points by the trilinear blend of the 8 coarse-grid
    dual quaternions around each point (sign pivot: the (0,0,0) corner);
    NaN inputs pass through."""
    dc = dq_grid.shape[0]
    cell = cfg.knn_field_stride * cfg.voxel_size
    org = volume_model.origin(cfg, points.device)
    g = (torch.nan_to_num(points) - org) / cell
    gi = torch.clamp(torch.floor(g), 0, dc - 2)
    f = torch.clamp(g - gi, 0.0, 1.0)
    gi = gi.to(torch.int64)
    base = (gi[..., 0] * dc + gi[..., 1]) * dc + gi[..., 2]
    flat = dq_grid.reshape(-1, 8)
    a, b, c = f[..., 0], f[..., 1], f[..., 2]
    corners, weights = [], []
    for dx in (0, 1):
        wx = a if dx else 1.0 - a
        for dy in (0, 1):
            wy = b if dy else 1.0 - b
            for dz in (0, 1):
                wz = c if dz else 1.0 - c
                corners.append(flat[base + (dx * dc + dy) * dc + dz])
                weights.append(wx * wy * wz)
    blended = dualquat.blend(torch.stack(weights, dim=-1), torch.stack(corners, dim=-2))
    return warpfield._warp_with(blended, points, normals)


def warp_points_trilinear(
    cfg: DynamicFusionConfig, dq_grid: torch.Tensor, points: torch.Tensor, normals: torch.Tensor, plain: bool = False
):
    """Kernel E's trilinear entry on CUDA tensors, the plain version on CPU
    tensors: (warped points, rotated normals), both (Q, 3)."""
    if plain or points.device.type == "cpu":
        return warp_points_trilinear_plain(cfg, dq_grid, points, normals)
    org = tuple(float(v) for v in cfg.volume_origin)
    return kernels.warp_trilinear(
        dq_grid.contiguous(), points.contiguous(), normals.contiguous(), org,
        cfg.knn_field_stride * cfg.voxel_size,
    )


def integrate_nonrigid(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    cf: CoarseField,
    dists: torch.Tensor,
    world2cam: torch.Tensor,
    intr: Intrinsics,
    ok: torch.Tensor,
    conf: Optional[torch.Tensor] = None,
    phase: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Fuse one live frame into the canonical volume through the warp
    field, IN PLACE: brick-sparse fusion (kernel D) of the warped coarse
    grid put into the camera frame, with the blend quality as the
    observation weight (voxels with quality <= fusion_quality_min are not
    updated) and, given ``conf``, the per-pixel incidence weight. ``ok`` (a
    () bool device tensor) gates the whole update. Returns the (3,) int32
    (band, wide, dropped) brick counts (zeros where ``ok`` is False)."""
    if cfg.integrate_mode != "brick":
        raise NotImplementedError("dense non-rigid integrate: a later slice")
    from dynamicfusion_tpu_torch.ops import bricks

    cam_grid = se3.transform_points(world2cam, cf.warped)
    return bricks.integrate_bricks(
        cfg, vol, dists, cam_grid, cfg.knn_field_stride, intr, ok=ok,
        q_grid=cf.q if cfg.fusion_quality_weight else None, conf=conf,
        phase=phase, split=cfg.fusion_phase_split, plain=plain,
    )
