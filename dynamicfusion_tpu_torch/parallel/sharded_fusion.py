"""Sharded non-rigid brick fusion, no collectives but the counts' (port of
``dynamicfusion_tpu.parallel.sharded_fusion``).

Brick work is independent over the volume's x-slabs: each shard classifies
and fuses only its own slab's bricks, in place. What a brick needs beyond
its voxels is small and replicated: the lookup image (the dists, or the
depth packed with the incidence confidence) and the coarse corner grid
warped into the camera frame (with the blend quality); a shard reads its
x-slab of the grid with the +1 overlap plane that its last bricks share
with the next shard (``bricks.corner_slab``). A shard holds (D/n)/B brick
planes, so its front and band caps are every local brick (those classes
never drop); the wide class (footprint larger than the band window) keeps
a cap of max(local bricks / 8, 16), the lowest local ids first, and what
it drops is counted. The brick x-plane phase of ``fusion_phase_split`` is
the GLOBAL plane. The frame's fusion gate masks the plan and the update
through the device flag kernels K and D read (no host branch), and one
psum returns the (band, wide, dropped) counts, zero on a gated frame.

The classification and list are kernel K's slab mode, the fuse kernel D's
(``bricks.plan_slab``, ``bricks.fuse``) on CUDA tensors; their plain
versions on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.ops import bricks
from dynamicfusion_tpu_torch.ops.fusion import CoarseField
from dynamicfusion_tpu_torch.parallel.mesh import Mesh, SlabVolume


def caps(cfg: DynamicFusionConfig, n: int):
    """(band cap, wide cap) of one shard's list: every local brick, and
    max(local bricks // 8, 16) wide ones (JAX ``sharded_fusion.py:145-150``)."""
    nb = cfg.volume_dims // cfg.brick_size
    nbr_loc = (nb // n) * nb * nb
    return nbr_loc, min(max(nbr_loc // 8, 16), nbr_loc)


def make_sharded_integrate(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``integrate_fn(cfg, vol, cf, dists, world2cam, intr, enabled, conf,
    phase) -> (vol, counts)``, the sharded counterpart of
    ``fusion.integrate_nonrigid`` for kinfu.step's integrate hook: the
    volume updated in place and returned as it came (a ``SlabVolume``, or a
    whole ``TsdfVolume`` fused through its slabs), the (3,) int32 counts
    psum'd over the shards."""
    n = mesh.n
    d, b, g = cfg.volume_dims, cfg.brick_size, cfg.knn_field_stride
    if cfg.integrate_mode != "brick" or d % n or (d // n) % b:
        raise ValueError(f"slab fusion needs brick fusion and whole brick planes a slab ({d} over {n}, brick {b})")
    nb_loc = d // n // b
    band_cap, wide_cap = caps(cfg, n)

    def integrate_fn(
        cfg_: DynamicFusionConfig,
        vol,
        cf: CoarseField,
        dists: torch.Tensor,
        world2cam: torch.Tensor,
        intr: Intrinsics,
        enabled: torch.Tensor,
        conf: Optional[torch.Tensor] = None,
        phase: Optional[torch.Tensor] = None,
        plain: bool = plain,
    ):
        if cfg_ != cfg:
            raise ValueError("the sharded integrate is built for one config")
        if (conf is not None) != cfg.fusion_incidence_weight:
            raise ValueError("conf must be given exactly when fusion_incidence_weight is on")
        sv = mesh.slabs(vol)
        # replicated, once a process: the corners in the camera frame, the
        # lookup image
        cam_grid = se3.transform_points(world2cam, cf.warped)
        q = cf.q if cfg.fusion_quality_weight else None
        lookup = dists if conf is None else bricks.pack_depth_conf(dists, conf)
        counts = []
        for i, k in enumerate(mesh.local):
            dev = sv.tsdf[i].device
            grid_k = bricks.corner_slab(cam_grid, k, n, b, g).to(dev)
            q_k = None if q is None else bricks.corner_slab(q, k, n, b, g).to(dev)
            dists_k, lookup_k, on_k = dists.to(dev), lookup.to(dev), enabled.to(dev)
            bp = bricks.plan_slab(
                cfg, dists_k, grid_k, g, intr, k * nb_loc, band_cap, wide_cap,
                phase=None if phase is None else phase.to(dev), split=cfg.fusion_phase_split, plain=plain, ok=on_k,
            )
            bricks.fuse(cfg, TsdfVolume(sv.tsdf[i], sv.weight[i]), lookup_k, grid_k, g, intr, bp, on_k,
                        q_k, conf is not None, plain=plain)
            counts.append(bp.work.counts)
        total = torch.where(enabled, mesh.psum(counts), 0).to(torch.int32)
        if not isinstance(vol, SlabVolume) and (
            mesh.group is not None or any(t.device != vol.tsdf.device for t in sv.tsdf)
        ):
            # the slabs were copies of the whole volume: write them back
            whole = mesh.whole(sv)
            vol.tsdf.copy_(whole.tsdf)
            vol.weight.copy_(whole.weight)
        return (sv if isinstance(vol, SlabVolume) else vol), total

    return integrate_fn
