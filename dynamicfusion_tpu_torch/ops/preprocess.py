"""Depth-frame preprocessing (port of ``dynamicfusion_tpu.ops.preprocess``):
bilateral filter, depth pyramid, point/normal maps.

Conventions: raw depth (H, W) uint16 mm (0 = missing); dists (H, W)
float32 ray distance in meters; point/normal maps (H, W, 3) float32
camera-space, NaN = invalid.

``bilateral_filter`` owns CUDA kernel A (``csrc/bilateral.cu``); the other
stencils (dists and depth truncation, the depth pyramid, point/normal maps
with the fusion's incidence confidence, the 2x2 map resize) own kernel I
(``csrc/preprocess.cu``). CUDA tensors go through the kernels, CPU tensors
(or ``plain=True``) through the plain versions below.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.core import camera


def _shift(img: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], border filled."""
    h, w = img.shape[:2]
    out = torch.full_like(img, fill)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y0 < y1 and x0 < x1:
        out[y0:y1, x0:x1] = img[y0 + dy : y1 + dy, x0 + dx : x1 + dx]
    return out


def _inb(h: int, w: int, dy: int, dx: int, device) -> torch.Tensor:
    """Mask of pixels whose (y + dy, x + dx) neighbour lies in the image."""
    return _shift(torch.ones((h, w), dtype=torch.bool, device=device), dy, dx, False)


def bilateral_filter_plain(
    depth_mm: torch.Tensor,
    kernel_size: int = 7,
    sigma_spatial: float = 4.5,
    sigma_depth_m: float = 0.04,
) -> torch.Tensor:
    """7x7 bilateral filter on uint16 mm depth, weights
    exp(-(Δpx²/2σs² + Δmm²/2σd²)), window clamped to the image, output
    rounded half-to-even to integer mm."""
    d = depth_mm.to(torch.float32)
    sigma_depth_mm = sigma_depth_m * 1000.0
    inv_sp = 0.5 / (sigma_spatial * sigma_spatial)
    inv_sd = 0.5 / (sigma_depth_mm * sigma_depth_mm)
    half = kernel_size // 2
    h, w = d.shape
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            nbr = _shift(d, dy, dx, 0.0)
            diff = d - nbr
            space = float(dy * dy + dx * dx) * inv_sp  # double, as the JAX weak type
            wgt = torch.exp(-(space + diff * diff * inv_sd)) * _inb(h, w, dy, dx, d.device)
            num = num + nbr * wgt
            den = den + wgt
    out = torch.round(num / torch.clamp(den, min=1e-12))
    return out.to(torch.int32).to(depth_mm.dtype)


def bilateral_filter(
    depth_mm: torch.Tensor,
    kernel_size: int = 7,
    sigma_spatial: float = 4.5,
    sigma_depth_m: float = 0.04,
    plain: bool = False,
    reference: bool = False,
) -> torch.Tensor:
    """Kernel A (its reference mode with ``reference``) on CUDA tensors,
    the plain version on CPU tensors or where the caller asks for it."""
    if plain or depth_mm.device.type == "cpu":
        return bilateral_filter_plain(depth_mm, kernel_size, sigma_spatial, sigma_depth_m)
    return kernels.bilateral_filter(depth_mm, kernel_size, sigma_spatial, sigma_depth_m, reference=reference)


def _plain(t: torch.Tensor, plain: bool) -> bool:
    return plain or t.device.type == "cpu"


def truncate_depth(depth_mm: torch.Tensor, max_dist_m: float) -> torch.Tensor:
    """Zero out depth beyond max_dist meters."""
    far = depth_mm.to(torch.float32) > max_dist_m * 1000.0
    # through int32: CUDA PyTorch has no `where` for uint16
    return torch.where(far, 0, depth_mm.to(torch.int32)).to(depth_mm.dtype)


def depth_pyramid_down(depth_mm: torch.Tensor, sigma_depth_m: float = 0.04, plain: bool = False) -> torch.Tensor:
    """Depth-aware 2x downsample: mean of the 5x5 window around (2y, 2x)
    over values within 3σ of the centre (truncated to integer mm); kernel I
    on CUDA tensors."""
    if not _plain(depth_mm, plain):
        return kernels.pyramid_down(depth_mm, sigma_depth_m)
    d = depth_mm.to(torch.float32)
    h, w = d.shape
    thresh = sigma_depth_m * 1000.0 * 3.0
    s = torch.zeros_like(d)
    cnt = torch.zeros_like(d)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            nbr = _shift(d, dy, dx, 0.0)
            keep = (torch.abs(nbr - d) < thresh) & _inb(h, w, dy, dx, d.device)
            s = s + torch.where(keep, nbr, 0.0)
            cnt = cnt + keep
    out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
    out = out[: 2 * (h // 2) : 2, : 2 * (w // 2) : 2]
    return out.to(torch.int32).to(depth_mm.dtype)


def compute_points_normals(
    intr: Intrinsics, depth_mm: torch.Tensor, stride: int = 1, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertex map + forward-difference normal map of
    ``depth_mm[::stride, ::stride]``; a pixel is valid only if it and its
    right and lower neighbours have depth. Kernel I on CUDA tensors."""
    if not _plain(depth_mm, plain):
        p, n, _ = kernels.points_normals(depth_mm, intr, stride)
        return p, n
    z00 = depth_mm[::stride, ::stride].to(torch.float32) * 0.001
    z01 = _shift(z00, 0, 1, 0.0)
    z10 = _shift(z00, 1, 0, 0.0)
    h, w = z00.shape
    u, v = camera.pixel_grid(h, w, z00.device)
    v00 = camera.backproject(intr, u, v, z00)
    v01 = camera.backproject(intr, u + 1.0, v, z01)
    v10 = camera.backproject(intr, u, v + 1.0, z10)
    n = torch.linalg.cross(v01 - v00, v10 - v00)
    n = -(n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12))
    valid = ((z00 * z01 * z10) != 0.0) & (u < w - 1) & (v < h - 1)
    return (
        torch.where(valid[..., None], v00, float("nan")),
        torch.where(valid[..., None], n, float("nan")),
    )


def incidence_confidence(points: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Per-pixel |cos| of the live normal against the viewing ray, 0 where
    invalid: the fusion's incidence confidence (kernel I computes it with
    the level-0 maps)."""
    pn = points / torch.clamp(torch.linalg.vector_norm(points, dim=-1, keepdim=True), min=1e-9)
    return torch.nan_to_num(torch.abs((normals * pn).sum(dim=-1)))


def compute_dists(intr: Intrinsics, depth_mm: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """z-depth (mm) -> ray distance (m): d = z * ||K⁻¹ (u, v, 1)||; kernel I
    on CUDA tensors."""
    if not _plain(depth_mm, plain):
        return kernels.depth_dists(depth_mm, intr)[0]
    lam = camera.ray_norms(intr, *depth_mm.shape, device=depth_mm.device)
    return depth_mm.to(torch.float32) * lam * 0.001


def resize_points_normals(
    points: torch.Tensor, normals: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 block average of point+normal maps, valid only if all four points
    are; normals are not renormalized. Kernel I on CUDA tensors."""
    if not _plain(points, plain):
        return kernels.resize_maps(points.contiguous(), normals.contiguous())
    h, w = points.shape[:2]
    oh, ow = h // 2, w // 2
    p = points[: 2 * oh, : 2 * ow].reshape(oh, 2, ow, 2, 3)
    n = normals[: 2 * oh, : 2 * ow].reshape(oh, 2, ow, 2, 3)
    valid = ~torch.isnan(p[..., 0]).any(dim=3).any(dim=1)

    def mean4(a):
        # the block's sum in row-major order, as kernel I adds it
        return (a[:, 0, :, 0] + a[:, 0, :, 1] + a[:, 1, :, 0] + a[:, 1, :, 1]) / 4.0

    return (
        torch.where(valid[..., None], mean4(p), float("nan")),
        torch.where(valid[..., None], mean4(n), float("nan")),
    )


def build_frame_pyramid(
    cfg: DynamicFusionConfig,
    depth_mm: torch.Tensor,
    first_point_level: int = 0,
    plain: bool = False,
    with_conf: bool = False,
):
    """dists, bilateral filter, depth pyramid and per-level point/normal
    maps. Returns (depth_pyr, points_pyr, normals_pyr, dists), and with
    ``with_conf`` the level-0 incidence confidence as a fifth item (level 0
    is then computed whatever ``first_point_level`` says); point/normal
    maps below ``first_point_level`` are not computed (None)."""
    d0 = bilateral_filter(
        depth_mm, cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial,
        cfg.bilateral_sigma_depth, plain=plain,
    )
    trunc = cfg.icp_truncate_depth_dist > 0
    if _plain(depth_mm, plain):
        dists = compute_dists(cfg.intr, depth_mm, plain=True)
        if trunc:
            d0 = truncate_depth(d0, cfg.icp_truncate_depth_dist)
    else:
        # the dists and the truncation ride one launch of kernel I
        dists, d_t = kernels.depth_dists(depth_mm, cfg.intr, d0 if trunc else None, cfg.icp_truncate_depth_dist)
        d0 = d_t if trunc else d0
    depth_pyr = [d0]
    for _ in range(1, cfg.pyramid_levels):
        depth_pyr.append(depth_pyramid_down(depth_pyr[-1], cfg.bilateral_sigma_depth, plain=plain))
    points_pyr: List[Optional[torch.Tensor]] = []
    normals_pyr: List[Optional[torch.Tensor]] = []
    conf = None
    for lvl, d in enumerate(depth_pyr):
        intr = cfg.intr.level(lvl)
        if lvl == 0 and with_conf:
            if _plain(d, plain):
                p, n = compute_points_normals(intr, d, plain=True)
                conf = incidence_confidence(p, n)
            else:
                p, n, conf = kernels.points_normals(d, intr, conf=True)
        elif lvl < first_point_level:
            p = n = None
        else:
            p, n = compute_points_normals(intr, d, plain=plain)
        points_pyr.append(p)
        normals_pyr.append(n)
    if with_conf:
        return depth_pyr, points_pyr, normals_pyr, dists, conf
    return depth_pyr, points_pyr, normals_pyr, dists
