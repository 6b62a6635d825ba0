"""The sharded frame step over a mesh (port of
``dynamicfusion_tpu.parallel.sharded``).

The volume splits on x into n slabs of D/n planes (a ``SlabVolume``); the
warp field, the pose and the model maps stay replicated (the JAX package
also row-splits the maps; here ICP and preprocessing run replicated on
them, they are small). The step is ``kinfu.step`` with the sharded pieces
in its hooks, chosen by the JAX package's static conditions
(``sharded.py:77-133``):

- the distributed PCG solve under ``solver_linear == "pcg"`` with
  ``solver_lagged_jtj``; otherwise, when not ``rigid_only``, the summed
  Schur assembly and, lagged, its candidate evaluation;
- the slab brick fusion for ``integrate_mode == "brick"`` with whole brick
  planes a slab;
- the slab raycast when D/n >= the raycast's halo.

Where those conditions send a piece to JAX's GSPMD partitioning (dense
fusion, slabs thinner than the halo, the rigid mode's fusion, the coarse
band's march, ``explicit_gn=False``), the port has no partitioner: the
step gathers the slabs, runs the single-device kernels on the whole
volume and splits it again, which computes what GSPMD computes. The
choice follows the same static conditions, never a failure.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dynamicfusion_tpu_torch import device as device_mod
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded_fusion, sharded_raycast
from dynamicfusion_tpu_torch.parallel.mesh import Mesh, SlabVolume
from dynamicfusion_tpu_torch.pipeline import kinfu


def make_mesh(n: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A one-process mesh of ``n`` shards: on ``devices`` where given (n of
    them; a device may repeat, ``["cpu"] * n`` on the CPU), else one card a
    shard where there are n cards, else n shards on the one card."""
    if devices is None:
        if n is None:
            raise ValueError("make_mesh needs n or the devices")
        count = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)] if count >= n else ["cuda"] * n
    devices = [device_mod.resolve(d) for d in devices]
    if n is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} shards")
    return Mesh(devices)


def _replicated(state: kinfu.PipelineState, dev: torch.device) -> kinfu.PipelineState:
    """The state's replicated fields on ``dev``."""
    def to(t):
        return t.to(dev)

    return state._replace(
        warp=type(state.warp)(*(to(a) for a in state.warp)), pose=to(state.pose),
        prev_points=tuple(map(to, state.prev_points)), prev_normals=tuple(map(to, state.prev_normals)),
        can_points=to(state.can_points), can_normals=to(state.can_normals), frame_idx=to(state.frame_idx),
    )


def shard_state(cfg: DynamicFusionConfig, mesh: Mesh, state: kinfu.PipelineState) -> kinfu.PipelineState:
    """The state laid out over the mesh: the volume's local slabs (copies:
    the sharded step updates them in place), the rest on ``mesh.device``."""
    if isinstance(state.vol, SlabVolume):
        return state
    if cfg.volume_dims % mesh.n:
        raise ValueError(f"{cfg.volume_dims} planes do not split into {mesh.n} slabs")
    sv = mesh.slabs(state.vol)
    return _replicated(state, mesh.device)._replace(
        vol=SlabVolume(tuple(t.clone() for t in sv.tsdf), tuple(t.clone() for t in sv.weight))
    )


def gather_state(mesh: Mesh, state: kinfu.PipelineState) -> kinfu.PipelineState:
    """The state with its volume gathered (on ``mesh.device``)."""
    return state._replace(vol=mesh.whole(state.vol))


def make_sharded_first_frame(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``first(state, depth) -> state``: frame 0 on the single-device path
    (integrate, node sampling, the model maps), then split, as the JAX
    package's dry run and multi-process worker lay it out."""

    def first(state: kinfu.PipelineState, depth: torch.Tensor) -> kinfu.PipelineState:
        whole = gather_state(mesh, state)
        return shard_state(cfg, mesh, kinfu.first_frame(cfg, whole, depth.to(mesh.device), plain=plain))

    return first


def make_sharded_step(cfg: DynamicFusionConfig, mesh: Mesh, explicit_gn: bool = True, plain: bool = False):
    """``step(state, depth) -> (state, outputs)`` of a sharded state: the
    dispatch of JAX ``sharded.py:77-133`` (module docstring); ``plain``
    runs every kernel's plain version. ``explicit_gn=False`` keeps JAX's
    signature: there it hands the whole step to GSPMD, here, with no
    partitioner, it is ``kinfu.step`` on the gathered volume."""
    n, d = mesh.n, cfg.volume_dims
    if d % n:
        raise ValueError(f"{d} planes do not split into {n} slabs")
    use_explicit = explicit_gn and not cfg.rigid_only
    use_pcg = use_explicit and cfg.solver_linear == "pcg" and cfg.solver_lagged_jtj
    solve_fn = distributed_gn.make_sharded_solve(cfg, mesh, plain) if use_pcg else None
    system_fn = distributed_gn.make_system_fn(cfg, mesh, plain) if use_explicit and not use_pcg else None
    eval_fn = (
        distributed_gn.make_eval_fn(cfg, mesh, plain)
        if use_explicit and not use_pcg and cfg.solver_lagged_jtj else None
    )
    integrate_fn = (
        sharded_fusion.make_sharded_integrate(cfg, mesh, plain)
        if use_explicit and cfg.integrate_mode == "brick" and (d // n) % cfg.brick_size == 0 else None
    )
    raycast_fn = (
        sharded_raycast.make_sharded_raycast(cfg, mesh, plain)
        if explicit_gn and d // n >= sharded_raycast._halo_planes(cfg) else None
    )
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    coarse_band = not cfg.raycast_temporal_band and kinfu._use_coarse_band(cfg, rows_t, cols_t)
    # a volume piece without a sharded form: gather, run it whole, split
    whole = cfg.rigid_only or integrate_fn is None or raycast_fn is None or coarse_band

    def step(state: kinfu.PipelineState, depth: torch.Tensor):
        if whole:
            state = gather_state(mesh, state)
        new_state, out = kinfu.step(
            cfg, state, depth.to(mesh.device), plain=plain, warp_system_fn=system_fn, warp_eval_fn=eval_fn,
            integrate_fn=integrate_fn, warp_solve_fn=solve_fn, raycast_fn=raycast_fn,
        )
        if whole:
            new_state = new_state._replace(vol=mesh.slabs(new_state.vol))
        return new_state, out

    step.pieces = dict(solve=solve_fn is not None, system=system_fn is not None, eval=eval_fn is not None,
                       integrate=integrate_fn is not None, raycast=raycast_fn is not None, whole=whole)
    # the warp solve's hooks alone: a single-device step with them solves
    # as this step does, so that its raycast and fusion can be held
    # against the slab ones on the same field
    step.solver_hooks = dict(warp_system_fn=system_fn, warp_eval_fn=eval_fn, warp_solve_fn=solve_fn)
    return step
