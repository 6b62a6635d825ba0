"""The warp solve over a mesh (port of
``dynamicfusion_tpu.parallel.distributed_gn``).

The data term's P surface points split across the shards; nodes and the
ARAP edge graph are replicated. Two modes, as in the JAX package:

- the summed (Schur) assembly, for the dense solves (the base config's
  direct one): each shard assembles the dense (6N, 6N) data Gram of its
  points (kernel N's shard mode) with the SAME int8 column scales, the
  pmax of every shard's, so each quantizes alike; one psum reduces the
  Grams, gradients and costs, and the edge system is added once
  (``make_system_fn``); a candidate's gradient and cost take one psum of
  ((6N,), ()) (``make_eval_fn``). ``warp_solver.solve`` takes them through
  its ``system_fn`` and ``eval_fn`` hooks;
- the distributed PCG (``make_sharded_solve``), for the presets'
  factored solve: the whole LM loop with each shard's bf16 rows kept
  unsummed, only (6N,)-sized psums and the (N, 6, 6) diagonal blocks once
  a solve; every PCG matvec psums the shards' data products
  (``warp_solver.solve``'s ``mesh`` mode).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.models.warpfield import WarpField
from dynamicfusion_tpu_torch.parallel.mesh import Mesh
from dynamicfusion_tpu_torch.solvers import warp_solver
from dynamicfusion_tpu_torch.solvers.warp_solver import SolveStructure, WarpSolveInputs

_POINT_FIELDS = ("p_can", "p_live", "n_live", "valid", "knn_idx", "w_knn", "t1", "t2", "p2p_sw", "knn_idx32")


def _pad_points(s: SolveStructure, n: int) -> SolveStructure:
    """Pad the point fields so that P divides the mesh: padded rows repeat
    the last point with ``valid=False``, so they add exact zeros to the
    system (finite rows times a zero weight)."""
    p = s.p_can.shape[0]
    pad = (-p) % n
    if pad == 0:
        return s

    def pz(a):
        if a is None:
            return None
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])

    s = s._replace(**{f: pz(getattr(s, f)) for f in _POINT_FIELDS})
    return s._replace(valid=torch.cat([s.valid[:p], torch.zeros(pad, dtype=torch.bool, device=s.valid.device)]))


def shard_structure(s: SolveStructure, mesh: Mesh) -> Tuple[SolveStructure, ...]:
    """The local shards' contiguous parts of a (padded) solve structure,
    each on its device with its own node-sorted entry lists; the edge
    fields stay the whole structure's."""
    s = _pad_points(s, mesh.n)
    n_nodes = s.pts_by_node.off.shape[0] - 1
    chunk = s.p_can.shape[0] // mesh.n
    out = []
    for k in mesh.local:
        dev = mesh.devices[k]
        part = {f: None if getattr(s, f) is None else getattr(s, f)[k * chunk:(k + 1) * chunk].to(dev).contiguous()
                for f in _POINT_FIELDS}
        out.append(s._replace(**part, pts_by_node=warp_solver.node_lists(part["knn_idx"], n_nodes)))
    return tuple(out)


def _cached_shards(cache: dict, s: SolveStructure, mesh: Mesh):
    """The shards of ``s``, split once a solve (the hooks see the same
    structure on every call of one solve)."""
    if cache.get("s") is not s:
        cache["s"], cache["shards"] = s, shard_structure(s, mesh)
    return cache["shards"]


def make_sharded_system(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``system(shards, s, dqs) -> (jtj, jtr, cost)`` over shard structures:
    each shard's data term and Gram (int8 with the pmax'd column scales),
    one psum, then the edge system once."""

    def system(shards, s: SolveStructure, dqs: torch.Tensor):
        dts = [warp_solver.data_term(cfg, sk, dq_k, system=True, plain=plain)
               for sk, dq_k in zip(shards, mesh.replicate(dqs))]
        scale = None
        if cfg.solver_jtj_int8:
            scale = mesh.pmax([warp_solver.gram_scales(sk, dt, plain=plain) for sk, dt in zip(shards, dts)])
        grams = [warp_solver.data_gram(cfg, sk, dt, sc, plain=plain)
                 for sk, dt, sc in zip(shards, dts, mesh.replicate(scale) if scale is not None else [None] * len(dts))]
        jtj_d = mesh.psum(grams)
        jtr_d = mesh.psum([dt.jtr for dt in dts])
        cost_d = mesh.psum([dt.cost for dt in dts])
        et = warp_solver.edge_term(cfg, s, dqs, plain=plain)
        return jtj_d + warp_solver.edge_jtj(s, et, plain=plain), jtr_d + et.jtr, cost_d + et.cost

    return system


def make_system_fn(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``system_fn(s, dqs)`` for ``warp_solver.solve``: the structure split
    over the mesh (padded), then ``make_sharded_system``."""
    system = make_sharded_system(cfg, mesh, plain)
    cache: dict = {}

    def system_fn(s: SolveStructure, dqs: torch.Tensor):
        return system(_cached_shards(cache, s, mesh), s, dqs)

    return system_fn


def make_sharded_eval(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``evaluate(shards, s, dqs) -> (jtr, cost)``: each shard's gradient
    and cost, one psum, then the edge term's once."""

    def evaluate(shards, s: SolveStructure, dqs: torch.Tensor):
        dts = [warp_solver.data_term(cfg, sk, dq_k, system=False, plain=plain)
               for sk, dq_k in zip(shards, mesh.replicate(dqs))]
        et = warp_solver.edge_term(cfg, s, dqs, plain=plain)
        return mesh.psum([dt.jtr for dt in dts]) + et.jtr, mesh.psum([dt.cost for dt in dts]) + et.cost

    return evaluate


def make_eval_fn(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``eval_fn(s, dqs)`` for the lagged-JᵀJ loop (companion of
    ``make_system_fn``)."""
    evaluate = make_sharded_eval(cfg, mesh, plain)
    cache: dict = {}

    def eval_fn(s: SolveStructure, dqs: torch.Tensor):
        return evaluate(_cached_shards(cache, s, mesh), s, dqs)

    return eval_fn


def shard_inputs(cfg: DynamicFusionConfig, inputs: WarpSolveInputs, mesh: Mesh):
    """(the local shards' point sets, the unpadded point count): the inputs
    NaN-padded to a multiple of n x the Hessian stride, so that each
    shard's strided subsample keeps the whole solve's phase (NaN rows are
    invalid), then cut into n contiguous parts (JAX
    ``distributed_gn.py:214-238``)."""
    p = inputs.p_can.shape[0]
    if inputs.p2p_gate is None:
        inputs = inputs._replace(p2p_gate=torch.ones((p, 1), device=inputs.p_can.device))
    pad = (-p) % (mesh.n * max(cfg.solver_hessian_stride, 1))
    if pad:
        inputs = WarpSolveInputs(*(
            torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), float("nan"), device=a.device)]) for a in inputs
        ))
    chunk = inputs.p_can.shape[0] // mesh.n
    parts = tuple(
        WarpSolveInputs(*(a[k * chunk:(k + 1) * chunk].to(mesh.devices[k]).contiguous() for a in inputs))
        for k in mesh.local
    )
    return parts, p


def make_sharded_solve(cfg: DynamicFusionConfig, mesh: Mesh, plain: bool = False):
    """``solve_fn(field, inputs) -> (field, stats)`` for kinfu.step's
    ``warp_solve_fn`` hook: the distributed PCG solve (needs
    ``solver_linear == "pcg"`` and ``solver_lagged_jtj``)."""
    if not (cfg.solver_linear == "pcg" and cfg.solver_lagged_jtj):
        raise ValueError("the distributed PCG solve needs solver_linear='pcg' and solver_lagged_jtj")

    def solve_fn(field: WarpField, inputs: WarpSolveInputs):
        parts, p = shard_inputs(cfg, inputs, mesh)
        return warp_solver.solve(cfg, field, parts, plain=plain, mesh=mesh, global_points=p)

    return solve_fn


def solve_distributed(
    cfg: DynamicFusionConfig, mesh: Mesh, field: WarpField, inputs: WarpSolveInputs, plain: bool = False,
) -> Tuple[WarpField, warp_solver.SolveStats]:
    """The whole warp solve with the summed assembly over the mesh: the
    same prepare, LM loop and linear solve as ``warp_solver.solve``, the
    normal equations assembled per point shard and psum'd."""
    return warp_solver.solve(
        cfg, field, inputs, plain=plain, system_fn=make_system_fn(cfg, mesh, plain),
        eval_fn=make_eval_fn(cfg, mesh, plain) if cfg.solver_lagged_jtj else None,
    )
