"""Rigid projective point-to-plane ICP (port of
``dynamicfusion_tpu.solvers.icp``).

``_build_system`` owns CUDA kernel B (``csrc/icp_reduce.cu``): projective
association, the distance/angle gates and the 6x6 normal-equation
reduction. The coarse-to-fine Gauss-Newton loop stays on the device: the
JAX early exit (a ``while_loop`` on the step norm) becomes a fixed trip
count per level with an ``active`` mask that freezes the pose and the
health flag once the level has converged, so no iteration syncs with the
host. The kernel skips its work on inactive iterations.
``estimate_transform_depth`` is the reference's frame-to-frame variant:
it builds both vertex maps from depth pyramids (kernel I) and runs the
same loop.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.ops import preprocess


class IcpResult(NamedTuple):
    transform: torch.Tensor  # (4, 4) current camera frame -> previous
    ok: torch.Tensor         # () bool: the finest executed level stayed well-conditioned


def _rows_plain(
    intr: Intrinsics,
    t_cur: torch.Tensor,
    curr_pts: torch.Tensor,
    curr_nrm: torch.Tensor,
    prev_pts: torch.Tensor,
    prev_nrm: torch.Tensor,
    dist2_thres: float,
    min_cosine: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-pixel rows J = [s x n_d, n_d] (P, 6) and residuals
    r = n_d . (d - s) (P,). Rows come from the current pixels; the
    association targets the previous/model maps, whose shape sets the
    image bounds."""
    rows, cols = prev_pts.shape[:2]
    s = se3.transform_points(t_cur, curr_pts)
    valid_s = ~torch.isnan(curr_pts[..., 0])
    u = s[..., 0] * intr.fx / s[..., 2] + intr.cx
    v = s[..., 1] * intr.fy / s[..., 2] + intr.cy
    inb = (s[..., 2] > 0) & (u >= 0) & (v >= 0) & (u < cols) & (v < rows)
    ui = torch.nan_to_num(torch.floor(u), nan=0.0).clamp(0, cols - 1).to(torch.int64)
    vi = torch.nan_to_num(torch.floor(v), nan=0.0).clamp(0, rows - 1).to(torch.int64)
    flat = vi * cols + ui
    d = prev_pts.reshape(-1, 3)[flat]
    nd = prev_nrm.reshape(-1, 3)[flat]
    valid_d = ~torch.isnan(d[..., 0]) & ~torch.isnan(nd[..., 0])
    dist2 = ((s - d) ** 2).sum(dim=-1)
    ns = se3.rotate_dirs(t_cur, curr_nrm)
    cosine = torch.abs((ns * nd).sum(dim=-1))
    mask = valid_s & inb & valid_d & (dist2 < dist2_thres) & (cosine > min_cosine)
    s0 = torch.nan_to_num(s)
    d0 = torch.nan_to_num(d)
    nd0 = torch.nan_to_num(nd)
    row = torch.cat([torch.linalg.cross(s0, nd0), nd0], dim=-1) * mask[..., None]
    rhs = (nd0 * (d0 - s0)).sum(dim=-1)
    return row.reshape(-1, 6), rhs.reshape(-1)


def _build_system_plain(
    intr: Intrinsics,
    t_cur: torch.Tensor,
    curr_pts: torch.Tensor,
    curr_nrm: torch.Tensor,
    prev_pts: torch.Tensor,
    prev_nrm: torch.Tensor,
    dist2_thres: float,
    min_cosine: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked rows (``_rows_plain``) reduced to (A, b) of JᵀJ x = Jᵀr."""
    row, rhs = _rows_plain(intr, t_cur, curr_pts, curr_nrm, prev_pts, prev_nrm, dist2_thres, min_cosine)
    # reductions, not matmuls: a threaded BLAS splits the pixel sum by its
    # thread count, which may change from call to call, and ICP turns the
    # last-bit differences into pose differences
    a = (row[:, :, None] * row[:, None, :]).sum(dim=0)
    b = (row * rhs.reshape(-1, 1)).sum(dim=0)
    return a, b


def _build_system(
    intr: Intrinsics,
    t_cur: torch.Tensor,
    curr_pts: torch.Tensor,
    curr_nrm: torch.Tensor,
    prev_pts: torch.Tensor,
    prev_nrm: torch.Tensor,
    dist2_thres: float,
    min_cosine: float,
    active: torch.Tensor | None = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B on CUDA tensors (skipping its work where ``active`` is
    False), the plain version on CPU tensors or where the caller asks."""
    if plain or t_cur.device.type == "cpu":
        return _build_system_plain(
            intr, t_cur, curr_pts, curr_nrm, prev_pts, prev_nrm, dist2_thres, min_cosine
        )
    return kernels.icp_build_system(
        intr, t_cur, curr_pts, curr_nrm, prev_pts, prev_nrm, dist2_thres, min_cosine, active
    )


def _gn_update(
    a: torch.Tensor, b: torch.Tensor, t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One det-guarded Gauss-Newton step: (new t, good, step norm)."""
    det = torch.linalg.det(a)
    good = torch.isfinite(det) & (torch.abs(det) > 1e-15)
    eye = torch.eye(6, dtype=a.dtype, device=a.device)
    a_safe = torch.where(good, a, eye)
    b_safe = torch.where(good, b, torch.zeros_like(b))
    x = torch.linalg.solve_ex(a_safe, b_safe[:, None], check_errors=False)[0][:, 0]
    x = torch.where(good & torch.isfinite(x).all(), x, torch.zeros_like(x))
    t_new = torch.where(good, se3.compose(se3.exp_twist(x), t), t)
    step_norm = torch.where(good, torch.linalg.vector_norm(x), float("inf"))
    return t_new, good, step_norm


def estimate_transform(
    cfg: DynamicFusionConfig,
    curr_pts_pyr: List[torch.Tensor],
    curr_nrm_pyr: List[torch.Tensor],
    prev_pts_pyr: List[torch.Tensor],
    prev_nrm_pyr: List[torch.Tensor],
    level_offset: int = 0,
    plain: bool = False,
) -> IcpResult:
    """Coarse-to-fine Gauss-Newton over the pyramids (``cfg.icp_iters`` is
    fine -> coarse; levels run coarse -> fine). Singular iterations
    (|det A| <= 1e-15 or non-finite) skip the increment; ``ok`` is the
    health of the finest executed level's last iteration."""
    dist2_thres = cfg.icp_dist_thres * cfg.icp_dist_thres
    min_cos = math.cos(cfg.icp_angle_thres)
    dev = prev_pts_pyr[0].device
    t = se3.identity(dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for level in reversed(range(len(prev_pts_pyr))):
        iters = cfg.icp_iters[level]
        shp = prev_pts_pyr[level].shape
        if shp[0] * shp[1] < 96 or iters <= 0:
            continue
        intr_l = cfg.intr.level(level + level_offset)
        cp, cn = curr_pts_pyr[level], curr_nrm_pyr[level]
        pp, pn = prev_pts_pyr[level], prev_nrm_pyr[level]
        if level == 0 and cfg.icp_finest_stride > 1:
            st = cfg.icp_finest_stride
            cp, cn = cp[::st, ::st].contiguous(), cn[::st, ::st].contiguous()
        active = torch.ones((), dtype=torch.bool, device=dev)
        good = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            a, b = _build_system(
                intr_l, t, cp, cn, pp, pn, dist2_thres, min_cos, active, plain=plain
            )
            t_new, g, step_norm = _gn_update(a, b, t)
            t = torch.where(active, t_new, t)
            good = torch.where(active, g, good)
            active = active & (step_norm > cfg.icp_step_tol)
        ok = good
    return IcpResult(transform=t, ok=ok)


def depth_map_tasks(cfg: DynamicFusionConfig, curr_depth_pyr, prev_depth_pyr, level_offset: int = 0):
    """The depth-variant ICP's vertex maps as ``MapTask``s: every level of
    the current pyramid, then of the previous one (points only)."""
    levels = min(len(curr_depth_pyr), len(prev_depth_pyr))
    return [preprocess.MapTask(d, cfg.intr.level(lvl % levels + level_offset), 1, points=True, normals=False)
            for lvl, d in enumerate(list(curr_depth_pyr)[:levels] + list(prev_depth_pyr)[:levels])]


def estimate_transform_depth(
    cfg: DynamicFusionConfig,
    curr_depth_pyr: List[torch.Tensor],
    curr_nrm_pyr: List[torch.Tensor],
    prev_depth_pyr: List[torch.Tensor],
    prev_nrm_pyr: List[torch.Tensor],
    level_offset: int = 0,
    plain: bool = False,
) -> IcpResult:
    """The reference's depth-variant ICP (its ``USE_DEPTH`` compile path):
    frame-to-frame tracking whose association targets are back-projected
    from the PREVIOUS frame's depth pyramid instead of the raycast model
    maps. Per level both vertex maps come from the uint16 depth pyramids
    (kernel I's multi-map entry on CUDA tensors: one launch for both
    pyramids' points), then ``estimate_transform`` runs (kernel B)."""
    tasks = depth_map_tasks(cfg, curr_depth_pyr, prev_depth_pyr, level_offset)
    pts = [p for p, _, _ in preprocess.frame_maps(tasks, plain=plain)]
    curr_pts, prev_pts = pts[: len(tasks) // 2], pts[len(tasks) // 2:]
    return estimate_transform(
        cfg, curr_pts, list(curr_nrm_pyr), prev_pts, list(prev_nrm_pyr), level_offset=level_offset, plain=plain,
    )
