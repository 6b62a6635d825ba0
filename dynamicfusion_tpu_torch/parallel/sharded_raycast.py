"""Slab-local sharded raycast (port of
``dynamicfusion_tpu.parallel.sharded_raycast``).

x(t) along a ray is monotonic, so each ray crosses each volume x-slab in
one contiguous t-interval with a closed form. Each shard marches only the
part of every ray inside its own slab, over its slab extended by ``HALO``
neighbour planes each side (exchanged once a raycast, ``Mesh.halo``), which
cover the bracket and refine reach of the march. Every shard samples the
same global grid of ray distances, t in {tmin + k step}: the start of its
window is snapped onto it, and the march is fixed-step (the adaptive
doubling depends on the ray's history and cannot be cut into slabs), so the
union of the slab marches is the whole-volume fixed-step march.

Ownership: the shard whose slab holds a bracket's start owns the
crossing; a crossing seen by two neighbours (their brackets differ, so
their refined t does) goes to the smaller refined t (a pmin), a ray whose
first event is exit geometry (where the whole march would stop and miss)
reports nothing, and a pmin on the shard index breaks exact ties. One psum
of (points, normals, hit) assembles the maps.

The march and refine are kernel C's slab mode on CUDA tensors
(``tsdf.march_slab``), its plain version on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops
from dynamicfusion_tpu_torch.parallel.mesh import Mesh

INF = float("inf")


def _halo_planes(cfg: DynamicFusionConfig) -> int:
    """x-planes of neighbour halo each side: the march and refine reach at
    most 2 march steps plus one interpolation cell."""
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    return int(math.ceil(2.0 * step / cfg.voxel_size)) + 2


def slab_window(cfg: DynamicFusionConfig, k: int, n: int, ray_org, dirs, tmin, tmax):
    """Shard ``k``'s march window of every ray: [tmin_k, tmax_k] inside the
    ray's interval where x(t) lies in the shard's slab [k D/n, (k+1) D/n)
    voxels, its start snapped up onto the global step grid tmin + j step
    (JAX ``sharded_raycast.py:207-240``); near-axial rays (|dx| <= 1e-9)
    take the whole interval where the origin is in the slab, none
    elsewhere."""
    d_loc = cfg.volume_dims // n
    vs = cfg.voxel_size
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    sx0 = (k * d_loc) * vs
    sx1 = (k * d_loc + d_loc) * vs
    ox, dx = ray_org[0], dirs[..., 0]
    dxs = torch.where(torch.abs(dx) > 1e-9, dx, 1e-9)
    ta = (sx0 - ox) / dxs
    tb = (sx1 - ox) / dxs
    t_in = torch.minimum(ta, tb)
    t_out = torch.maximum(ta, tb)
    axial = torch.abs(dx) <= 1e-9
    inside0 = (ox >= sx0) & (ox < sx1)
    t_in = torch.where(axial, torch.where(inside0, tmin, INF), t_in)
    t_out = torch.where(axial, torch.where(inside0, tmax, -INF), t_out)
    tmin_l = torch.maximum(tmin, t_in)
    k0 = torch.ceil(torch.clamp(tmin_l - tmin, min=0.0) / step - 1e-4)
    return (tmin + k0 * step).contiguous(), torch.minimum(tmax, t_out).contiguous()


def make_sharded_raycast(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``raycast_fn`` with ``tsdf.raycast``'s signature over the mesh's
    slabs (the volume a ``SlabVolume``, or a whole ``TsdfVolume`` that is
    split). Needs D/n >= HALO."""
    n = mesh.n
    d = cfg.volume_dims
    d_loc = d // n
    halo = _halo_planes(cfg)
    if d % n or d_loc < halo:
        raise ValueError(f"slab raycast: {d} planes over {n} shards, {halo} halo planes")

    def raycast_fn(
        cfg_: DynamicFusionConfig,
        vol,
        cam2vol: torch.Tensor,
        intr: Intrinsics,
        rows: int,
        cols: int,
        t_seed: Optional[torch.Tensor] = None,
        t_band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        plain: bool = plain,
    ) -> tsdf_ops.RaycastResult:
        if cfg_ != cfg:
            raise ValueError("the sharded raycast is built for one config")
        exts = mesh.halo(mesh.slabs(vol).tsdf, halo)
        ray_org, dirs, tmin, tmax = tsdf_ops.rays(cfg, cam2vol, intr, rows, cols, t_seed, t_band)
        outs = []
        for k, ext, org_k, dirs_k, tmin_k, tmax_k in zip(
            mesh.local, exts, *(mesh.replicate(a) for a in (ray_org, dirs, tmin, tmax))
        ):
            lo, hi = slab_window(cfg, k, n, org_k, dirs_k, tmin_k, tmax_k)
            outs.append(tsdf_ops.march_slab(cfg, ext, k * d_loc - halo, org_k, dirs_k, lo, hi, plain=plain))
        # ownership: the smallest refined t among the finders, unless an
        # exit event comes first; the smallest shard index on exact ties
        t_cand = [torch.where(f & torch.isfinite(ts), ts, INF) for f, ts, _, _, _ in outs]
        t_min = mesh.pmin(t_cand)
        behind_min = mesh.pmin([torch.nan_to_num(o[4], nan=INF) for o in outs])
        at_min = [o[0] & (tc == t_min.to(tc.device)) & (t_min <= behind_min).to(tc.device)
                  for o, tc in zip(outs, t_cand)]
        owner = mesh.pmin([torch.where(a, k, n).to(torch.int32) for k, a in zip(mesh.local, at_min)])
        r_vc = cam2vol[:3, :3].T
        pts, nrm, okf = [], [], []
        for k, a, (_, _, vertex, normal, _), org_k, r_k in zip(
            mesh.local, at_min, outs, mesh.replicate(ray_org), mesh.replicate(r_vc)
        ):
            mine = a & (owner.to(a.device) == k)
            nn = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
            normal_n = normal / torch.clamp(nn, min=1e-12)
            ok = mine & ~torch.isnan(normal_n).any(dim=-1) & (nn[..., 0] > 1e-12)
            pts.append(torch.where(ok[..., None], torch.nan_to_num(se3.rotate(r_k, vertex - org_k)), 0.0))
            nrm.append(torch.where(ok[..., None], torch.nan_to_num(se3.rotate(r_k, normal_n)), 0.0))
            okf.append(ok.to(torch.float32))
        hit = mesh.psum(okf) > 0.5
        return tsdf_ops.RaycastResult(
            points=torch.where(hit[..., None], mesh.psum(pts), tsdf_ops.NAN),
            normals=torch.where(hit[..., None], mesh.psum(nrm), tsdf_ops.NAN),
        )

    return raycast_fn
