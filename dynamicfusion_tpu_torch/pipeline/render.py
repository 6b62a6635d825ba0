"""Rendering (port of ``dynamicfusion_tpu.pipeline.render``): a Phong-shaded
view and normal tangent colours of camera-frame point/normal maps; mode 0 =
Phong, 2 = normal colours, 3 = both side by side. Plain PyTorch on the
maps' device; images are (H, W, 3) uint8 tensors there."""

from __future__ import annotations

import numpy as np
import torch

from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.models import warpfield


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def phong(points: torch.Tensor, normals: torch.Tensor, light_pose) -> torch.Tensor:
    """(H, W, 3) uint8 Phong-shaded image of camera-frame maps (Ka 0.3, Kd
    0.5, Ks 0.2, n 20; invalid pixels show a vertical background
    gradient)."""
    h, w = points.shape[:2]
    dev = points.device
    valid = ~torch.isnan(points[..., 0])
    p = torch.nan_to_num(points)
    n = torch.nan_to_num(normals)
    light = torch.tensor(light_pose, dtype=torch.float32, device=dev)
    l_dir = _unit(light - p)
    v = _unit(-p)
    ndl = (n * l_dir).sum(dim=-1)
    r = _unit(2.0 * n * ndl[..., None] - l_dir)
    ka, kd, ks, spec_n = 0.3, 0.5, 0.2, 20.0
    ix = ka + kd * torch.clamp(ndl, min=0.0) + ks * torch.clamp((r * v).sum(dim=-1), min=0.0) ** spec_n
    shaded = torch.clamp(ix, 0.0, 1.0)[..., None].expand(h, w, 3)
    wgt = (torch.arange(h, dtype=torch.float32, device=dev) / h)[:, None, None]
    bg1 = torch.tensor([4.0, 2.0, 2.0], device=dev) / 255.0
    bg2 = torch.tensor([236.0, 120.0, 120.0], device=dev) / 255.0
    bg = (bg1 * (1 - wgt) + bg2 * wgt).expand(h, w, 3)
    out = torch.where(valid[..., None], shaded, bg)
    return (out * 255.0).to(torch.uint8)


def tangent_colors(normals: torch.Tensor) -> torch.Tensor:
    """Normal map -> uint8 RGB (n + 1) / 2, black where invalid."""
    valid = ~torch.isnan(normals[..., 0])
    c = (torch.nan_to_num(normals) * 0.5 + 0.5) * valid[..., None]
    return (torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_maps(cfg: DynamicFusionConfig, pts: torch.Tensor, nrm: torch.Tensor, mode: int = 0) -> torch.Tensor:
    if mode == 2:
        return tangent_colors(nrm)
    img = phong(pts, nrm, cfg.light_pose)
    if mode == 3:
        return torch.cat([img, tangent_colors(nrm)], dim=1)
    return img


def render_state(cfg: DynamicFusionConfig, state, mode: int = 0) -> torch.Tensor:
    """Render the last model maps at the full frame size (the maps live at
    1/raycast_subsample resolution and are pixel-replicated up)."""
    s = cfg.raycast_subsample
    pts, nrm = state.prev_points[0], state.prev_normals[0]
    if s > 1:
        pts = pts.repeat_interleave(s, 0).repeat_interleave(s, 1)
        nrm = nrm.repeat_interleave(s, 0).repeat_interleave(s, 1)
    return render_maps(cfg, pts, nrm, mode)


def overlay_nodes(cfg: DynamicFusionConfig, img, state, pose=None, color=(255, 64, 32), size: int = 1) -> np.ndarray:
    """A uint8 numpy copy of ``img`` with a (2 size + 1)² dot on each
    visible active node of the warp field, at its live position projected
    with ``pose`` (default the state's camera pose); on a mode-3 render the
    dots land on the left (Phong) panel."""
    out = np.array(img.cpu() if isinstance(img, torch.Tensor) else img, dtype=np.uint8, copy=True)
    if pose is None:
        pose = state.pose
    pose = torch.as_tensor(pose, dtype=torch.float32, device=state.warp.positions.device)
    live = warpfield.live_node_positions(state.warp)
    cam = se3.transform_points(se3.inverse(pose), live).cpu().numpy()
    active = state.warp.active.cpu().numpy()
    z = cam[:, 2]
    ok = active & (z > 1e-3)
    u = cfg.intr.fx * cam[:, 0] / np.where(ok, z, 1.0) + cfg.intr.cx
    v = cfg.intr.fy * cam[:, 1] / np.where(ok, z, 1.0) + cfg.intr.cy
    h, w = out.shape[0], min(out.shape[1], cfg.cols)
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok &= (ui >= size) & (ui < w - size) & (vi >= size) & (vi < h - size)
    col = np.asarray(color, np.uint8)
    for du in range(-size, size + 1):
        for dv in range(-size, size + 1):
            out[vi[ok] + dv, ui[ok] + du] = col
    return out
