"""Non-rigid warp-field estimation (port of
``dynamicfusion_tpu.solvers.warp_solver``): Levenberg-Marquardt over
per-node 6-dof twists, a point-to-plane data term with Tukey weights (with
``solver_p2p_weight`` > 0 plus the tangential point terms, three residual
rows a point; with ``point_to_plane=False`` the point-to-point term, three
rows ``warp(p) - p_live``), ARAP edge term with Huber weights.

Unknowns are delta twists eps = (r, t) per node, applied as
dq <- from_twist(eps) ⊗ dq and re-linearized at eps = 0. The data term's
Jacobian is a point's (R, K, 6) rows over its K neighbour nodes (R = 1 or
3 residual rows), rounded to bf16 as the JAX package stores them. Two
linear solvers, as in the JAX package:

- ``solver_linear="pcg"`` (the presets): the normal equations stay
  factored (the bf16 rows, the per-node (N, 6, 6) diagonal blocks, the
  per-edge 6x6 blocks of the ARAP term) under the lagged JᵀJ, and the
  step is block-Jacobi PCG over matvecs of those factors plus the LM
  damping; with the tangential rows the matrix may keep only the plane
  rows (``solver_p2p_lag_hessian``) or the tangential rows of every s-th
  point scaled by sqrt(s) (``solver_p2p_hessian_stride``), while the
  gradient, the cost and the diagonal blocks keep every row. With the
  unlagged JᵀJ the step is block-Jacobi PCG over the dense damped matrix
  of the direct solve, rebuilt every LM iteration;
- ``solver_linear="direct"`` (the base config): the dense (6N, 6N)
  normal equations (the data Gram of the one-hot-expanded rows, int8 with
  per-column scales and an exact integer sum or bf16 with float32 sums,
  plus the ARAP blocks placed), damped, Cholesky-factored and solved;
  with the lagged JᵀJ or a fresh system every LM iteration
  (``solver_lagged_jtj=False``), and one factor reused across
  iterations under ``solver_chol_reuse``.

On CUDA tensors the data term is kernel F (``csrc/data_term.cu``); the
edge term, ``spd6_inv``, the matvec and the whole PCG solve are kernel G
(``csrc/pcg.cu``); the dense Gram with the edge blocks placed is kernel N
and the damping kernel O (``csrc/dense_system.cu``); the PCG over the
dense matrix is kernel P (``csrc/dense_pcg.cu``); the factor and its
solve are cuSOLVER's (``torch.linalg.cholesky_ex``, ``cholesky_solve``),
as the JAX package leaves them to its linear-algebra library. Their
reductions over nodes run through a per-solve node-sorted list of the
(point, neighbour) and (edge, dst) entries, in a fixed order: no float
atomics, so the LM accept/reject comparisons are bit-stable from run to
run. The plain versions here take their Jacobians from
``torch.func.jacrev``, as the JAX package takes them from ``jax.jacrev``;
the kernels use the closed form.

The JAX loops that exit early (PCG on its residual, LM on convergence)
become fixed trip counts with device-side flags that turn the remaining
iterations into no-ops: no step of a solve reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.core import dualquat, se3
from dynamicfusion_tpu_torch.models import warpfield
from dynamicfusion_tpu_torch.models.warpfield import WarpField


class SolveStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    accepted_steps: torch.Tensor


class WarpSolveInputs(NamedTuple):
    p_can: torch.Tensor   # (P, 3) canonical points, world frame (NaN = invalid)
    n_can: torch.Tensor   # (P, 3) canonical normals
    p_live: torch.Tensor  # (P, 3) live targets (NaN = invalid)
    n_live: torch.Tensor  # (P, 3) live normals
    # (P, 1) per-point gate in [0, 1] of the tangential term's weight
    # (solver_p2p_weight * gate); None means ones
    p2p_gate: Optional[torch.Tensor] = None


# --------------------------------------------------------------------------
# residuals and robust weights
# --------------------------------------------------------------------------


def tukey_sqrt_weight(r_norm: torch.Tensor, c: float) -> torch.Tensor:
    """sqrt of the Tukey biweight: 1 - (r/c)^2 inside |r| <= c, 0 outside."""
    x = r_norm / c
    return torch.where(torch.abs(x) <= 1.0, 1.0 - x * x, 0.0)


def huber_sqrt_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt of the Huber weight: 1 inside |r| <= delta, sqrt(delta/|r|) outside."""
    a = torch.abs(r_norm)
    return torch.where(a <= delta, 1.0, torch.sqrt(delta / torch.clamp(a, min=1e-20)))


def tukey_rho(rn: torch.Tensor, c: float) -> torch.Tensor:
    """Tukey's rho: (c^2/6)(1 - (1 - x^2)^3) inside, c^2/6 outside."""
    x2 = (rn / c) * (rn / c)
    t = 1.0 - x2
    return torch.where(x2 <= 1.0, (c * c / 6.0) * (1.0 - (t * t) * t), c * c / 6.0)


def huber_rho(ren: torch.Tensor, d: float) -> torch.Tensor:
    return torch.where(ren <= d, 0.5 * ren * ren, d * (ren - 0.5 * d))


def _warp_one(eps_k, dq_k, w_k, p):
    """One point warped by the DQB of its K neighbours with delta twists:
    blend(w, from_twist(eps) ⊗ dq)."""
    delta = dualquat.from_twist(eps_k[:, :3], eps_k[:, 3:])
    return dualquat.transform(dualquat.blend(w_k, dualquat.mul(delta, dq_k)), p)


def _data_residual_p2p(eps_k, dq_k, w_k, p_can, p_live):
    """Point-to-point residual warp(p_can) - p_live, (3,)."""
    return _warp_one(eps_k, dq_k, w_k, p_can) - p_live


def _data_residual(eps_k, dq_k, w_k, p_can, p_live, n_live):
    """Point-to-plane residual n_live · (warp(p_can) - p_live), (1,)."""
    d = _warp_one(eps_k, dq_k, w_k, p_can) - p_live
    return ((n_live[0] * d[0] + n_live[1] * d[1]) + n_live[2] * d[2]).reshape(1)


def _data_residual_tangential(eps_k, dq_k, w_k, p_can, p_live, n_live, t1, t2, sw):
    """Point-to-plane plus the per-point-weighted tangential point terms,
    (3,): [n · d, sw (t1 · d), sw (t2 · d)], d = warp(p_can) - p_live."""
    d = _warp_one(eps_k, dq_k, w_k, p_can) - p_live

    def dot(u):
        return (u[0] * d[0] + u[1] * d[1]) + u[2] * d[2]

    return torch.stack([dot(n_live), sw * dot(t1), sw * dot(t2)])


def tangent_basis(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, 3) unit normals -> orthonormal tangent frames (t1, t2): the world
    axis least aligned with n (the first on ties) as the helper; a zero
    normal gives zero tangents."""
    ax = torch.argmin(torch.abs(n), dim=-1)
    helper = (ax[:, None] == torch.arange(3, device=n.device)).to(n.dtype)
    t1 = torch.linalg.cross(n, helper)
    t1 = t1 / torch.clamp(_norm3(t1), min=1e-9)[:, None]
    return t1, torch.linalg.cross(n, t1)


def _edge_residual(eps_i, dq_i, eps_j, dq_j, v_j):
    """ARAP edge residual T_i(v_j) - T_j(v_j), (3,)."""
    di = dualquat.mul(dualquat.from_twist(eps_i[:3], eps_i[3:]), dq_i)
    dj = dualquat.mul(dualquat.from_twist(eps_j[:3], eps_j[3:]), dq_j)
    return dualquat.transform(di, v_j) - dualquat.transform(dj, v_j)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])


# --------------------------------------------------------------------------
# per-solve structure
# --------------------------------------------------------------------------


class NodeLists(NamedTuple):
    """Entries grouped by node: ``order`` lists entry ids sorted by their
    node (ties in entry order), node n owns order[off[n]:off[n + 1]];
    ``heavy`` (with ``node_lists(heavy=True)``) the nodes by descending
    list length, ties by index, the order in which kernel G's warps take
    them."""

    order: torch.Tensor  # (M,) int32
    off: torch.Tensor    # (N + 1,) int32
    heavy: Optional[torch.Tensor] = None  # (N,) int64


def node_lists(keys: torch.Tensor, n_nodes: int, heavy: bool = False) -> NodeLists:
    srt, order = torch.sort(keys.reshape(-1), stable=True)
    off = torch.searchsorted(srt, torch.arange(n_nodes + 1, device=keys.device, dtype=srt.dtype))
    lists = NodeLists(order.to(torch.int32), off.to(torch.int32))
    return lists._replace(heavy=heavy_order(lists)) if heavy else lists


def heavy_order(lists: NodeLists) -> torch.Tensor:
    """The nodes of ``lists`` by descending list length, ties by index."""
    return torch.sort(lists.off[1:] - lists.off[:-1], descending=True, stable=True).indices


def build_edges(field: WarpField, k_edge: int = 4, plain: bool = False):
    """k-NN node graph for the ARAP term: (src (E,), dst (E,), valid (E,))
    with E = N * k_edge, src = repeat(arange(N), k_edge); self edges and
    inactive endpoints are masked out."""
    n = field.positions.shape[0]
    _, idx = warpfield.knn(field, field.positions, k_edge + 1, plain=plain)
    dst = idx[:, 1 : k_edge + 1].reshape(-1)
    src = torch.arange(n, device=idx.device)[:, None].expand(n, k_edge).reshape(-1)
    valid = field.active[src] & field.active[dst] & (src != dst)
    return src, dst, valid


class SolveStructure(NamedTuple):
    """Per-solve constants, fixed across LM iterations."""

    p_can: torch.Tensor    # (P, 3) NaNs zeroed
    p_live: torch.Tensor
    n_live: torch.Tensor
    valid: torch.Tensor    # (P,) bool
    knn_idx: torch.Tensor  # (P, K) int64
    w_knn: torch.Tensor    # (P, K)
    e_src: torch.Tensor    # (E,) int64
    e_dst: torch.Tensor
    e_valid: torch.Tensor  # (E,) bool
    v_dst: torch.Tensor    # (E, 3)
    alpha: torch.Tensor    # (E,) ARAP edge weights
    pts_by_node: NodeLists  # the P*K (point, neighbour) entries by node
    edges_by_dst: NodeLists  # the E edges by dst node
    # the tangential term's tangent basis of n_live (P, 3) and per-point
    # sqrt weight (P,); None when solver_p2p_weight is 0 (one row a point)
    t1: Optional[torch.Tensor] = None
    t2: Optional[torch.Tensor] = None
    p2p_sw: Optional[torch.Tensor] = None
    # int32 copies of knn_idx and e_dst, as kernels G and N take them
    knn_idx32: Optional[torch.Tensor] = None
    e_dst32: Optional[torch.Tensor] = None


def _factored(cfg: DynamicFusionConfig) -> bool:
    """The solve runs kernel G's factored PCG (the lagged JᵀJ and the PCG;
    anything else assembles the dense system)."""
    return cfg.solver_linear == "pcg" and cfg.solver_lagged_jtj


def _tangential(cfg: DynamicFusionConfig) -> bool:
    """The data term has the tangential rows: point-to-plane with
    ``solver_p2p_weight`` > 0 (the JAX package's ``_data_fn_args`` order)."""
    return cfg.point_to_plane and cfg.solver_p2p_weight > 0.0


def prepare(
    cfg: DynamicFusionConfig, field: WarpField, inputs: WarpSolveInputs, plain: bool = False,
    global_points: Optional[int] = None, edges: Optional[SolveStructure] = None,
) -> SolveStructure:
    """Subsample by ``solver_hessian_stride`` (above 8192 points), KNN the
    solve points, build the edge graph and the node lists; with the
    tangential term, the tangent basis and the per-point weight
    sqrt(solver_p2p_weight * clip(gate, 0, 1)). The live normal must be
    finite only where a row projects on it (point-to-plane). The kernels'
    inputs are built here once a structure: the int32 copies of the
    neighbour ids and edge destinations (kernels G and N) and, where the
    solve runs kernel G's factored PCG, the heavy-first node order.

    ``global_points``: the whole solve's point count where ``inputs`` is
    one shard of it, so that the 8192-point and stride decisions are the
    whole solve's (JAX ``warp_solver.py:229-250``); ``edges``: a structure
    whose edge graph to reuse (the sharded solve builds it once)."""
    n = field.positions.shape[0]
    gp = inputs.p_can.shape[0] if global_points is None else global_points
    hs = cfg.solver_hessian_stride if gp > 8192 else 1
    p_can, p_live, n_live = (a[::hs] for a in (inputs.p_can, inputs.p_live, inputs.n_live))
    valid = ~torch.isnan(p_can[:, 0]) & ~torch.isnan(p_live[:, 0])
    if cfg.point_to_plane:
        valid = valid & ~torch.isnan(n_live[:, 0])
    p_can, p_live, n_live = (torch.nan_to_num(a) for a in (p_can, p_live, n_live))
    t1 = t2 = p2p_sw = None
    if _tangential(cfg):
        if inputs.p2p_gate is None:
            gate = torch.ones_like(p_can[:, 0])
        else:
            gate = torch.clamp(torch.nan_to_num(inputs.p2p_gate[::hs, 0]), 0.0, 1.0)
        p2p_sw = torch.sqrt(cfg.solver_p2p_weight * gate)
        t1, t2 = (a.contiguous() for a in tangent_basis(n_live))
    kb = warpfield.knn_blend(field, p_can, cfg.knn_k, plain=plain)
    wsum = kb.w[:, 0]
    for j in range(1, cfg.knn_k):
        wsum = wsum + kb.w[:, j]
    valid = valid & (wsum > 1e-8)
    if edges is None:
        e_src, e_dst, e_valid = build_edges(field, plain=plain)
        alpha = torch.maximum(field.radius[e_src], field.radius[e_dst]) * (1.0 / hs)
        v_dst, edges_by_dst = field.positions[e_dst].contiguous(), node_lists(e_dst, n)
        e_dst32 = e_dst.to(torch.int32)
    else:
        e_src, e_dst, e_valid, v_dst, alpha, edges_by_dst, e_dst32 = (
            edges.e_src, edges.e_dst, edges.e_valid, edges.v_dst, edges.alpha, edges.edges_by_dst, edges.e_dst32
        )
    return SolveStructure(
        p_can=p_can.contiguous(), p_live=p_live.contiguous(), n_live=n_live.contiguous(), valid=valid,
        knn_idx=kb.idx, w_knn=kb.w.contiguous(),
        e_src=e_src, e_dst=e_dst, e_valid=e_valid, v_dst=v_dst, alpha=alpha,
        pts_by_node=node_lists(kb.idx, n, heavy=_factored(cfg)), edges_by_dst=edges_by_dst,
        t1=t1, t2=t2, p2p_sw=p2p_sw, knn_idx32=kb.idx.to(torch.int32), e_dst32=e_dst32,
    )


# --------------------------------------------------------------------------
# data term: plain version of kernel F
# --------------------------------------------------------------------------


class DataTerm(NamedTuple):
    jtr: torch.Tensor              # (6N,) Jᵀr, node-major
    cost: torch.Tensor             # () Tukey cost at the linearization point
    rows: Optional[torch.Tensor]   # (P, R, K, 6) bf16 weighted Jacobian rows
    blocks: Optional[torch.Tensor]  # (N, 6, 6) per-node diagonal blocks


def data_residual_and_jac(cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor):
    """Weighted residuals (P, R), weighted Jacobians (P, R, K, 6) and the
    Tukey cost, with the Jacobian from ``torch.func.jacrev`` at eps = 0;
    R = 1 (point-to-plane) or 3 (with the tangential rows, ``s.t1``, or
    point-to-point, ``point_to_plane=False``). The Tukey weight and cost
    take the rows' joint norm."""
    p, k = s.knn_idx.shape
    dq_k = dqs[s.knn_idx]
    eps0 = torch.zeros((p, k, 6), dtype=torch.float32, device=dqs.device)
    args = (eps0, dq_k, s.w_knn, s.p_can, s.p_live, s.n_live)
    fn = _data_residual
    if s.t1 is not None:
        fn, args = _data_residual_tangential, args + (s.t1, s.t2, s.p2p_sw)
    elif not cfg.point_to_plane:
        fn, args = _data_residual_p2p, args[:5]
    r = torch.func.vmap(fn)(*args)
    jac = torch.func.vmap(torch.func.jacrev(fn))(*args)
    rr = r[:, 0] * r[:, 0]
    for j in range(1, r.shape[1]):
        rr = rr + r[:, j] * r[:, j]
    rn = torch.sqrt(rr)
    sw = tukey_sqrt_weight(rn, cfg.solver_tukey_c) * s.valid
    cost = (tukey_rho(rn, cfg.solver_tukey_c) * s.valid).sum()
    return r * sw[:, None], jac * sw[:, None, None, None], cost


def bf16_rows(jac: torch.Tensor, row_stride: int = 1) -> torch.Tensor:
    """The (P, R, K, 6) bf16 rows of the PCG matrix from the weighted
    Jacobian; with ``row_stride`` s > 1 the tangential rows of every s-th
    point are bf16(sqrt(s) jac), scaled before the rounding, as the JAX
    package's strided row matrix is."""
    rows = jac.to(torch.bfloat16)
    if row_stride > 1:
        rows[::row_stride, 1:] = (jac[::row_stride, 1:] * math.sqrt(row_stride)).to(torch.bfloat16)
    return rows


def data_term_plain(
    cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor, system: bool, row_stride: int = 1
) -> DataTerm:
    n = dqs.shape[0]
    r, jac, cost = data_residual_and_jac(cfg, s, dqs)
    flat = s.knn_idx.reshape(-1)
    # an entry's rows are summed first, then the entries by node
    jr = (jac * r[:, :, None, None]).sum(1).reshape(-1, 6)
    jtr = torch.zeros((n, 6), device=dqs.device).index_add_(0, flat, jr).reshape(-1)
    if not system:
        return DataTerm(jtr, cost, None, None)
    jf = jac.transpose(1, 2).reshape(-1, jac.shape[1], 6)
    outer = (jf[:, :, :, None] * jf[:, :, None, :]).sum(1)
    blocks = torch.zeros((n, 6, 6), device=dqs.device).index_add_(0, flat, outer)
    return DataTerm(jtr, cost, bf16_rows(jac, row_stride), blocks)


def data_term(
    cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor, system: bool, plain: bool = False,
    row_stride: int = 1,
) -> DataTerm:
    """Kernel F on CUDA tensors: Jᵀr and the cost, and with ``system`` the
    bf16 rows (``bf16_rows``) and the per-node diagonal blocks."""
    if plain or dqs.device.type == "cpu":
        return data_term_plain(cfg, s, dqs, system, row_stride)
    return DataTerm(*kernels.data_term(
        s.p_can, s.p_live, s.n_live, s.valid, s.knn_idx, s.w_knn, dqs,
        s.pts_by_node.order, s.pts_by_node.off, cfg.solver_tukey_c, system, s.t1, s.t2, s.p2p_sw,
        point=not cfg.point_to_plane, row_stride=row_stride,
    ))


# --------------------------------------------------------------------------
# edge term: plain version of kernel G's edge entry
# --------------------------------------------------------------------------


class EdgeTerm(NamedTuple):
    jtr: torch.Tensor    # (6N,)
    cost: torch.Tensor   # ()
    h_ii: torch.Tensor   # (E, 6, 6) per-edge blocks J_iᵀJ_i, J_jᵀJ_j, J_iᵀJ_j
    h_jj: torch.Tensor
    h_ij: torch.Tensor
    diag: torch.Tensor   # (N, 6, 6) the edge share of the diagonal blocks


def edge_residual_and_jac(cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor):
    """Huber- and alpha-weighted edge residuals (E, 3), Jacobians (E, 3, 6)
    for both endpoints, and the weighted Huber cost."""
    lam = cfg.solver_arap_weight
    e = s.e_src.shape[0]
    zero = torch.zeros((e, 6), dtype=torch.float32, device=dqs.device)
    args = (zero, dqs[s.e_src], zero, dqs[s.e_dst], s.v_dst)
    re = torch.func.vmap(_edge_residual)(*args)
    je_i, je_j = torch.func.vmap(torch.func.jacrev(_edge_residual, argnums=(0, 2)))(*args)
    ren = _norm3(re)
    swe = huber_sqrt_weight(ren, cfg.solver_huber_delta) * s.e_valid * torch.sqrt(lam * s.alpha)
    cost = (huber_rho(ren, cfg.solver_huber_delta) * s.e_valid * (lam * s.alpha)).sum()
    return re * swe[:, None], je_i * swe[:, None, None], je_j * swe[:, None, None], cost


def edge_term_plain(cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor) -> EdgeTerm:
    n = dqs.shape[0]
    re, je_i, je_j, cost = edge_residual_and_jac(cfg, s, dqs)
    h_ii = je_i.transpose(1, 2) @ je_i
    h_jj = je_j.transpose(1, 2) @ je_j
    h_ij = je_i.transpose(1, 2) @ je_j
    c = s.e_src.shape[0] // n
    diag = h_ii.reshape(n, c, 6, 6).sum(1) + torch.zeros((n, 6, 6), device=dqs.device).index_add_(0, s.e_dst, h_jj)
    g_i = (je_i * re[:, :, None]).sum(1)
    g_j = (je_j * re[:, :, None]).sum(1)
    jtr = g_i.reshape(n, c, 6).sum(1) + torch.zeros((n, 6), device=dqs.device).index_add_(0, s.e_dst, g_j)
    return EdgeTerm(jtr.reshape(-1), cost, h_ii, h_jj, h_ij, diag)


def edge_term(cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor, plain: bool = False) -> EdgeTerm:
    """Kernel G's edge entry on CUDA tensors."""
    if plain or dqs.device.type == "cpu":
        return edge_term_plain(cfg, s, dqs)
    return EdgeTerm(*kernels.edge_term(
        dqs, s.e_src, s.e_dst, s.e_valid, s.v_dst, s.alpha, s.edges_by_dst.order, s.edges_by_dst.off,
        cfg.solver_arap_weight, cfg.solver_huber_delta,
    ))


# --------------------------------------------------------------------------
# linear algebra: plain versions of kernel G's entries
# --------------------------------------------------------------------------


def _sym3_inv(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) symmetric matrices (adjugate / det)."""
    a11, a12, a13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a22, a23, a33 = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    det = a11 * c11 + a12 * c12 + a13 * c13
    inv_det = torch.sign(det) / torch.clamp(torch.abs(det), min=1e-30)
    out = torch.stack(
        [torch.stack([c11, c12, c13], -1), torch.stack([c12, c22, c23], -1), torch.stack([c13, c23, c33], -1)], -2
    )
    return out * inv_det[..., None, None]


def spd6_inv_plain(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (N, 6, 6) SPD matrices through the 2x2-block
    Schur complement with symmetric 3x3 adjugate inverses."""
    a, b, c = m[..., :3, :3], m[..., :3, 3:], m[..., 3:, 3:]
    a_inv = _sym3_inv(a)
    a_inv_b = a_inv @ b
    schur = c - b.transpose(-1, -2) @ a_inv_b
    s_inv = _sym3_inv(0.5 * (schur + schur.transpose(-1, -2)))
    tl = a_inv + (a_inv_b @ s_inv) @ a_inv_b.transpose(-1, -2)
    tr = -(a_inv_b @ s_inv)
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([tr.transpose(-1, -2), s_inv], -1)], -2)


def spd6_inv(m: torch.Tensor, plain: bool = False) -> torch.Tensor:
    if plain or m.device.type == "cpu":
        return spd6_inv_plain(m)
    return kernels.spd6_inv(m.contiguous())


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class System(NamedTuple):
    """The factored normal equations at one linearization point."""

    rows: torch.Tensor  # (P, R, K, 6) bf16
    edge: EdgeTerm
    damp: torch.Tensor  # (6N,) LM damping plus the unit diagonal of empty dofs
    # the row mode (``row_mode``): rows used of the R, and with R = 3 the
    # stride of the points whose tangential rows are in the matrix
    used: Optional[int] = None
    stride: int = 1


def row_mode(cfg: DynamicFusionConfig) -> Tuple[Optional[int], int]:
    """(rows used, tangential stride) of the factored PCG's row matrix (the
    JAX package's ``jac_rows`` and ``tang_stride``): with the tangential
    rows, the plane row only under ``solver_p2p_lag_hessian``, else the
    tangential rows of every ``solver_p2p_hessian_stride``-th point; all
    rows of every point otherwise."""
    if not _tangential(cfg):
        return None, 1
    if cfg.solver_p2p_lag_hessian:
        return 1, 1
    return 3, cfg.solver_p2p_hessian_stride


def _rows_in(sys: System, p: int) -> torch.Tensor:
    """(P, R) float32 mask of the rows in the matrix under the row mode."""
    r = sys.rows.shape[1]
    used = r if sys.used is None else sys.used
    mask = torch.ones((p, r), device=sys.rows.device)
    if used == 1:
        mask[:, 1:] = 0.0
    elif sys.stride > 1:
        keep = (torch.arange(p, device=sys.rows.device) % sys.stride) == 0
        mask[:, 1:] = keep[:, None].to(torch.float32)
    return mask


def data_matvec_plain(s: SolveStructure, sys: System, p: torch.Tensor) -> torch.Tensor:
    """The data product rows_bf16ᵀ · bf16(rows_bf16 · bf16(p)), (N, 6),
    accumulated in float32 (the JAX package's rounding points: t is
    rounded per (point, row)), over the rows of the row mode: the plain
    version of kernel G's shard entry (``kernels.data_matvec``), in
    torch's sum order (``data_matvec_ordered`` takes the kernel's)."""
    n = p.shape[0] // 6
    rows = sys.rows.to(torch.float32)
    if sys.used is not None or sys.stride > 1:
        rows = rows * _rows_in(sys, rows.shape[0])[:, :, None, None]
    pm = _bf16(p).reshape(n, 6)
    t = _bf16((rows * pm[s.knn_idx][:, None]).sum((2, 3)))
    return torch.zeros((n, 6), device=p.device).index_add_(
        0, s.knn_idx.reshape(-1), (rows * t[:, :, None, None]).sum(1).reshape(-1, 6)
    )


def edge_matvec_plain(s: SolveStructure, e: EdgeTerm, p: torch.Tensor) -> torch.Tensor:
    """The edge blocks' product, (N, 6)."""
    n = p.shape[0] // 6
    pv = p.reshape(n, 6)
    p_i, p_j = pv[s.e_src], pv[s.e_dst]
    q_i = (e.h_ii @ p_i[:, :, None] + e.h_ij @ p_j[:, :, None])[..., 0]
    q_j = (e.h_ij.transpose(1, 2) @ p_i[:, :, None] + e.h_jj @ p_j[:, :, None])[..., 0]
    c = s.e_src.shape[0] // n
    return q_i.reshape(n, c, 6).sum(1) + torch.zeros((n, 6), device=p.device).index_add_(0, s.e_dst, q_j)


def matvec_plain(s: SolveStructure, sys: System, p: torch.Tensor) -> torch.Tensor:
    """(rows_bf16ᵀ · bf16(rows_bf16 · bf16(p))) + edge blocks · p + damp * p
    (``data_matvec_plain``, ``edge_matvec_plain``)."""
    return (data_matvec_plain(s, sys, p) + edge_matvec_plain(s, sys.edge, p)).reshape(-1) + sys.damp * p


def matvec(s: SolveStructure, sys: System, p: torch.Tensor, plain: bool = False) -> torch.Tensor:
    if plain or p.device.type == "cpu":
        return matvec_plain(s, sys, p)
    return kernels.matvec(_kernel_system(s, sys), p, used=sys.used, stride=sys.stride)


def _apply_m(minv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (minv @ v.reshape(-1, 6, 1)).reshape(-1)


def pcg_plain(
    s: SolveStructure, sys: System, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float, active: torch.Tensor
) -> torch.Tensor:
    """Block-Jacobi PCG from x = 0 for at most ``iters`` iterations while
    rᵀr > rtol² bᵀb; once the test fails the remaining iterations change
    nothing (device flags, no host sync). ``active`` False returns 0."""
    x = torch.zeros_like(b)
    r = b
    z = _apply_m(minv, r)
    p = z
    stop2 = (rtol * rtol) * torch.dot(b, b)
    rz = torch.dot(r, z)
    run = active
    for _ in range(iters):
        run = run & (torch.dot(r, r) > stop2)
        ap = matvec_plain(s, sys, p)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        z = _apply_m(minv, r_n)
        rz_n = torch.dot(r_n, z)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z + beta * p
        x, r, p, rz = (torch.where(run, a, o) for a, o in ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return torch.where(active, x, 0.0)


def _kernel_system(s: SolveStructure, sys: System):
    """Kernel G's system; a structure prepared for the dense solve carries
    no heavy-first order, and gets one here."""
    e = sys.edge
    heavy = s.pts_by_node.heavy
    return kernels.FactoredSystem(
        rows=sys.rows, knn_idx=s.knn_idx32, pt_order=s.pts_by_node.order, pt_off=s.pts_by_node.off,
        heavy=heavy_order(s.pts_by_node) if heavy is None else heavy, h_ii=e.h_ii, h_jj=e.h_jj, h_ij=e.h_ij,
        e_dst=s.e_dst32,
        e_order=s.edges_by_dst.order, e_off=s.edges_by_dst.off, damp=sys.damp,
    )


def pcg(
    s: SolveStructure, sys: System, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float,
    active: torch.Tensor, plain: bool = False,
) -> torch.Tensor:
    """Kernel G's PCG entry (the whole solve in one cluster launch) on CUDA
    tensors."""
    if plain or b.device.type == "cpu":
        return pcg_plain(s, sys, minv, b, iters, rtol, active)
    return kernels.pcg(_kernel_system(s, sys), minv, b, iters, rtol, active, used=sys.used, stride=sys.stride)


class Shard(NamedTuple):
    """One shard's part of a sharded solve: its structure (its points; the
    edge fields are the shared graph's) and its bf16 rows."""

    s: SolveStructure
    rows: Optional[torch.Tensor] = None


def _seq_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right from 0 (a CUDA loop's ``s +=``
    without fused multiply-adds)."""
    s = torch.zeros_like(terms[..., 0])
    for k in range(terms.shape[-1]):
        s = s + terms[..., k]
    return s


def apply_m_ordered(minv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """z = M v per node in kernel P's order (``apply_m``): each entry the
    six rounded products summed left to right."""
    return _seq_sum(minv * v.reshape(-1, 1, 6)).reshape(-1)


def _block_tree(part: torch.Tensor) -> torch.Tensor:
    """The total of 1024 per-thread partial sums (last axis) as a
    1024-thread block adds them (``reduce.cuh``): a halving tree adds each
    warp's 32 partial sums and then the 32 warps' (``__shfl_down_sync`` by
    16, 8, 4, 2, 1)."""
    v = part.reshape(*part.shape[:-1], 32, 32)
    for _ in range(2):
        while v.shape[-1] > 1:
            h = v.shape[-1] // 2
            v = v[..., :h] + v[..., h:]
        v = v[..., 0]
    return v


def dot_ordered(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀb in kernel P's order (``node_dot``, then ``block_sum``): thread t
    of its 1024-thread block sums its nodes t, t + 1024, ... (six products
    each) in order, then ``_block_tree``."""
    threads = 1024
    n = a.shape[0] // 6
    k = -(-n // threads)
    prod = torch.zeros(k * threads * 6, dtype=a.dtype, device=a.device)
    prod[: 6 * n] = a * b
    return _block_tree(_seq_sum(prod.reshape(k, threads, 6).permute(1, 0, 2).reshape(threads, 6 * k)))


def sum_ordered(x: torch.Tensor) -> torch.Tensor:
    """The sum of x (M,) in the order of one 1024-thread block
    (``reduce.cuh`` ``ordered_sum``, kernel F's cost): thread t adds x[t],
    x[t + 1024], ... in order, then ``_block_tree``."""
    threads = 1024
    k = -(-x.shape[0] // threads)
    pad = torch.zeros(k * threads, dtype=x.dtype, device=x.device)
    pad[: x.shape[0]] = x
    return _block_tree(_seq_sum(pad.reshape(k, threads).T))


def _list_sums(values: torch.Tensor, lists: NodeLists, start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 6): node n's ``values`` rows at ``lists.order[off[n]:off[n + 1]]``
    added one by one in list order to ``start`` (default 0), as a kernel's
    per-node loop adds them."""
    off = lists.off.to(torch.int64)
    n = off.shape[0] - 1
    slot = off[:-1, None] + torch.arange(int((off[1:] - off[:-1]).max()) if n else 0, device=values.device)
    mine = slot < off[1:, None]
    picked = values[lists.order.to(torch.int64)[torch.where(mine, slot, 0)]]
    out = torch.zeros((n, 6), dtype=values.dtype, device=values.device) if start is None else start
    for k in range(slot.shape[1]):
        out = out + torch.where(mine[:, k, None], picked[:, k], 0.0)
    return out


def _lane_sums(values: torch.Tensor, lists: NodeLists, lanes: int = 32) -> torch.Tensor:
    """(N, C): node n's ``values`` rows (M, C) at ``lists.order[off[n]:off[n
    + 1]]`` summed as ``lanes`` threads of a kernel sum them (kernel G's
    ``lane_data`` and ``warp_sum6`` with one warp, kernel F's node pass with
    ``lanes`` a multiple of 32): lane l adds the rows l, l + lanes, ... one
    by one in list order from 0, a halving tree (16, 8, 4, 2, 1) adds each
    warp's 32 lanes, then another the node's warps."""
    off = lists.off.to(torch.int64)
    n = off.shape[0] - 1
    dev = values.device
    steps = -(-int((off[1:] - off[:-1]).max()) // lanes) if n else 0
    slot = off[:-1, None, None] + lanes * torch.arange(steps, device=dev)[:, None] + torch.arange(lanes, device=dev)
    mine = slot < off[1:, None, None]
    picked = values[lists.order.to(torch.int64)[torch.where(mine, slot, 0)]]
    v = torch.zeros((n, lanes, values.shape[1]), dtype=values.dtype, device=dev)
    for k in range(steps):
        v = v + torch.where(mine[:, k, :, None], picked[:, k], 0.0)
    v = v.reshape(n, lanes // 32, 32, -1)
    h = 16
    while h:
        v = v[:, :, :h] + v[:, :, h: 2 * h]
        h //= 2
    v = v[:, :, 0]
    h = lanes // 64
    while h:
        v = v[:, :h] + v[:, h: 2 * h]
        h //= 2
    return v[:, 0]


def data_matvec_ordered(s: SolveStructure, sys: System, p: torch.Tensor) -> torch.Tensor:
    """``data_matvec_plain`` in kernel G's order (``row_t``, ``lane_data``):
    each (point, row)'s 48 products summed left to right before t's bf16
    rounding, each entry's rows summed first, then a node's entries by one
    warp (``_lane_sums``). (N, 6)."""
    n = p.shape[0] // 6
    rows = sys.rows.to(torch.float32)
    if sys.used is not None or sys.stride > 1:
        rows = rows * _rows_in(sys, rows.shape[0])[:, :, None, None]
    pm = _bf16(p).reshape(n, 6)
    prod = rows * pm[s.knn_idx][:, None]
    t = _bf16(_seq_sum(prod.reshape(prod.shape[0], prod.shape[1], -1)))
    ent = rows * t[:, :, None, None]
    per_entry = ent[:, 0]
    for j in range(1, ent.shape[1]):
        per_entry = per_entry + ent[:, j]
    return _lane_sums(per_entry.reshape(-1, 6), s.pts_by_node)


def data_sums_ordered(jac: torch.Tensor, rw: torch.Tensor, lists: NodeLists, threads: int):
    """(Jᵀr (6N,), diagonal blocks (N, 6, 6)) of kernel F's node pass in its
    order, from its own float32 Jacobian ``jac`` (P, R, K, 6) and weighted
    residuals ``rw`` (P, R): each (point, neighbour) entry's six Jᵀr terms
    jac_0 r_0 + jac_1 r_1 + ... and 21 upper block terms jac_0a jac_0b +
    jac_1a jac_1b + ... (its rows summed first, left to right), then a
    node's entries by ``threads`` lanes (``_lane_sums``)."""
    p, r, k, _ = jac.shape
    iu, ju = torch.triu_indices(6, 6, device=jac.device)
    g = jac[:, 0] * rw[:, 0, None, None]
    h = jac[:, 0][..., iu] * jac[:, 0][..., ju]
    for j in range(1, r):
        g = g + jac[:, j] * rw[:, j, None, None]
        h = h + jac[:, j][..., iu] * jac[:, j][..., ju]
    sums = _lane_sums(torch.cat([g, h], -1).reshape(p * k, 27), lists, threads)
    blocks = torch.zeros((sums.shape[0], 6, 6), dtype=jac.dtype, device=jac.device)
    blocks[:, iu, ju] = sums[:, 6:]
    blocks[:, ju, iu] = sums[:, 6:]
    return sums[:, :6].reshape(-1), blocks


def edge_apply_plain(s: SolveStructure, e: EdgeTerm, p: torch.Tensor, apd: torch.Tensor,
                     damp: torch.Tensor) -> torch.Tensor:
    """(apd + edge blocks p) + damp p in kernel G's node order
    (``node_edge``): each edge's twelve products left to right, a node's
    source edges in edge order, then its destination edges in
    ``edges_by_dst`` order."""
    n = p.shape[0] // 6
    pv = p.reshape(n, 6)
    p_i, p_j = pv[s.e_src], pv[s.e_dst]
    q_i = _seq_sum(torch.cat([e.h_ii * p_i[:, None, :], e.h_ij * p_j[:, None, :]], -1))
    q_j = _seq_sum(torch.cat([e.h_ij.transpose(1, 2) * p_i[:, None, :], e.h_jj * p_j[:, None, :]], -1))
    edg = torch.zeros((n, 6), device=p.device)
    for q in q_i.reshape(n, -1, 6).unbind(1):
        edg = edg + q
    edg = _list_sums(q_j, s.edges_by_dst, start=edg)
    return (apd + edg.reshape(-1)) + damp * p


def pcg_sharded_plain(
    mesh, shards, s: SolveStructure, sys: System, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float,
    active: torch.Tensor,
) -> torch.Tensor:
    """``pcg_plain`` under a mesh: every matvec is the psum of the shards'
    data products (each shard's rows) plus the edge blocks and the damping
    applied once (JAX ``warp_solver.py:1228-1240`` under ``axis_name``).
    ``s`` and ``sys`` give the edge graph, its blocks and the damping;
    ``shards`` the local ``Shard``s. Every sum takes the kernels' order
    (``data_matvec_ordered``, ``edge_apply_plain``, ``dot_ordered``,
    ``apply_m_ordered``), so that with the same psum each iteration rounds
    as ``pcg_sharded``'s kernels do."""
    x = torch.zeros_like(b)
    r = b
    z = apply_m_ordered(minv, r)
    p = z
    stop2 = (rtol * rtol) * dot_ordered(b, b)
    rz = dot_ordered(r, z)
    run = active
    for _ in range(iters):
        run = run & (dot_ordered(r, r) > stop2)
        data = mesh.psum([
            data_matvec_ordered(sh.s, sys._replace(rows=sh.rows), p_k).reshape(-1)
            for sh, p_k in zip(shards, mesh.replicate(p))
        ])
        ap = edge_apply_plain(s, sys.edge, p, data, sys.damp)
        alpha = rz / torch.clamp(dot_ordered(p, ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        z = apply_m_ordered(minv, r_n)
        rz_n = dot_ordered(r_n, z)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z + beta * p
        x, r, p, rz = (torch.where(run, a, o) for a, o in ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return torch.where(active, x, 0.0)


def pcg_sharded(
    mesh, shards, s: SolveStructure, sys: System, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float,
    active: torch.Tensor, plain: bool = False,
) -> torch.Tensor:
    """The distributed PCG: kernel G's data-only matvec on every shard
    (``kernels.data_matvec``), the psum, then G's per-iteration step with
    kernel P's init and update (``kernels.pcg_sharded_step``) on CUDA
    tensors; the loop's stop flag stays in device memory."""
    if plain or b.device.type == "cpu":
        return pcg_sharded_plain(mesh, shards, s, sys, minv, b, iters, rtol, active)
    x, work = kernels.pcg_sharded_init(minv, b, iters, rtol, active)
    dof = b.shape[0]
    p, state = work[2 * dof: 3 * dof], work[4 * dof:]
    ks = _kernel_system(s, sys)
    # shards split by ``distributed_gn.shard_structure`` carry no order
    heavy = [sh.s.pts_by_node.heavy if sh.s.pts_by_node.heavy is not None else heavy_order(sh.s.pts_by_node)
             for sh in shards]
    for _ in range(iters):
        parts = [
            kernels.data_matvec(sh.rows, sh.s.knn_idx32, sh.s.pts_by_node.order, sh.s.pts_by_node.off, hv, p_k,
                                used=sys.used, stride=sys.stride, state=st_k)
            for sh, hv, p_k, st_k in zip(shards, heavy, mesh.replicate(p), mesh.replicate(state))
        ]
        kernels.pcg_sharded_step(ks, minv, mesh.psum(parts), x, work)
    return x


# --------------------------------------------------------------------------
# the dense normal equations: plain versions of kernels N and O, the factor
# --------------------------------------------------------------------------


def dense_rows(rows: torch.Tensor, knn_idx: torch.Tensor, n: int) -> torch.Tensor:
    """The (P R, 6N) float32 one-hot-expanded rows of the bf16 (P, R, K, 6)
    Jacobian rows, node-major columns (the JAX package's ``a``): a point's
    K neighbours are distinct, so each entry is one bf16 row value."""
    p, r, k, _ = rows.shape
    a = torch.zeros((p, r, n, 6), dtype=torch.float32, device=rows.device)
    ip = torch.arange(p, device=rows.device)[:, None, None]
    ir = torch.arange(r, device=rows.device)[None, :, None]
    a[ip, ir, knn_idx[:, None, :]] = rows.to(torch.float32)
    return a.reshape(p * r, 6 * n)


def gram_scales_plain(a: torch.Tensor) -> torch.Tensor:
    """Per-column int8 scales c = max(max |a|, 1e-12) / 127, taken as the
    jitted JAX package takes them: XLA folds the division by the constant
    127 into a product with its float32 reciprocal."""
    cmax = torch.abs(a).amax(0)
    return torch.clamp(cmax, min=1e-12) * torch.full((), 1.0 / 127.0, device=a.device)


def gram_codes_plain(rows: torch.Tensor, knn_idx: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel N's int8 codes (P, R, K, 6): each bf16 row value quantized once
    by the scale of its column 6 knn[p, k] + d, clip(round(v / c), ±127) (a
    true division), the entries of the expanded rows that ``dense_gram_plain``
    quantizes."""
    c = scale.reshape(-1, 6)[knn_idx][:, None]
    return torch.clamp(torch.round(rows.to(torch.float32) / c), -127.0, 127.0).to(torch.int8)


def block_gram_plain(vals: torch.Tensor, knn_idx: torch.Tensor, n: int) -> torch.Tensor:
    """The (6N, 6N) float64 data Gram summed over the 6x6 blocks that exist,
    as kernel N sums it: each point adds sum_r v[p,r,i]ᵀ v[p,r,j] to block
    (knn[p, i], knn[p, j]) for its K x K neighbour pairs (``vals`` the int8
    codes, exact, or the bf16 rows). The blocks of distinct neighbours are
    the expanded rows' Gram."""
    v = vals.to(torch.float64)
    blocks = torch.einsum("prka,prlb->pklab", v, v)
    cell = (knn_idx[:, :, None] * n + knn_idx[:, None, :]).reshape(-1)
    out = torch.zeros((n * n, 6, 6), dtype=torch.float64, device=vals.device)
    out.index_add_(0, cell, blocks.reshape(-1, 6, 6))
    return out.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)


def dense_gram_plain(
    rows: torch.Tensor, knn_idx: torch.Tensor, int8: bool, h_ij: Optional[torch.Tensor], diag: Optional[torch.Tensor],
    e_src: Optional[torch.Tensor], e_dst: Optional[torch.Tensor], scale: Optional[torch.Tensor] = None,
    n: Optional[int] = None,
) -> torch.Tensor:
    """The dense (6N, 6N) normal equations of the lagged or fresh system:
    the data Gram of the one-hot-expanded bf16 rows plus the ARAP blocks
    placed, summed as the JAX package sums them, data + ((A + Aᵀ) + D)
    with A the h_ij blocks at (src, dst) and D the diagonal blocks. With
    ``int8`` the rows are quantized per column, q = clip(round(a / c),
    ±127) (a true division, as XLA keeps it), and the Gram is float(QᵀQ)
    (c_i c_j), QᵀQ summed exactly in float64 (exact below 2^53; int32
    matrix products do not run on CUDA); else the bf16 rows' Gram summed
    exactly and rounded once. Shard mode (kernel N's): ``scale`` the
    column scales to quantize with, and without ``h_ij`` the data Gram
    alone of ``n`` nodes."""
    n = diag.shape[0] if diag is not None else n
    a = dense_rows(rows, knn_idx, n)
    if int8:
        c = gram_scales_plain(a) if scale is None else scale
        q = torch.clamp(torch.round(a / c), -127.0, 127.0).to(torch.float64)
        data = (q.T @ q).to(torch.float32) * (c[:, None] * c[None, :])
    else:
        a = a.to(torch.float64)
        data = (a.T @ a).to(torch.float32)
    if h_ij is None:
        return data
    blocks = torch.zeros((n, 6, n, 6), dtype=torch.float32, device=rows.device)
    blocks[e_src, :, e_dst, :] = h_ij
    ar = torch.arange(n, device=rows.device)
    d = torch.zeros_like(blocks)
    d[ar, :, ar, :] = diag
    edge = (blocks + blocks.permute(2, 3, 0, 1)) + d
    return data + edge.reshape(6 * n, 6 * n)


def dense_gram(cfg: DynamicFusionConfig, s: SolveStructure, dt: DataTerm, et: EdgeTerm, plain: bool = False):
    """Kernel N on CUDA tensors: the dense normal equations from kernel F's
    bf16 rows and kernel G's edge blocks (``solver_jtj_int8`` picks the
    Gram)."""
    if plain or dt.rows.device.type == "cpu":
        return dense_gram_plain(dt.rows, s.knn_idx, cfg.solver_jtj_int8, et.h_ij, et.diag, s.e_src, s.e_dst)
    return kernels.dense_gram(
        dt.rows, s.knn_idx32, s.pts_by_node.order, s.pts_by_node.off, et.h_ij, et.diag, s.e_dst32,
        s.edges_by_dst.order, s.edges_by_dst.off, cfg.solver_jtj_int8,
    )


def gram_scales(s: SolveStructure, dt: DataTerm, plain: bool = False) -> torch.Tensor:
    """The int8 column scales of the data term's rows (kernel N's scale
    entry on CUDA tensors)."""
    if plain or dt.rows.device.type == "cpu":
        return gram_scales_plain(dense_rows(dt.rows, s.knn_idx, s.pts_by_node.off.shape[0] - 1))
    return kernels.gram_scales(dt.rows, s.pts_by_node.order, s.pts_by_node.off)


def data_gram(cfg: DynamicFusionConfig, s: SolveStructure, dt: DataTerm, scale: Optional[torch.Tensor],
              plain: bool = False) -> torch.Tensor:
    """One shard's data Gram with the given int8 column scales (None for
    the bf16 Gram), no edge blocks: kernel N's shard mode on CUDA tensors."""
    n = s.pts_by_node.off.shape[0] - 1
    if plain or dt.rows.device.type == "cpu":
        return dense_gram_plain(dt.rows, s.knn_idx, cfg.solver_jtj_int8, None, None, None, None, scale=scale, n=n)
    return kernels.dense_gram(dt.rows, s.knn_idx32, s.pts_by_node.order, s.pts_by_node.off, None, None, None, None,
                              None, cfg.solver_jtj_int8, scale=scale, edges=False)


def edge_jtj(s: SolveStructure, et: EdgeTerm, plain: bool = False) -> torch.Tensor:
    """The ARAP blocks placed in a dense (6N, 6N) matrix alone: kernel N
    (``dense_gram``) over no data rows, 0 + the edge share, exact."""
    n = et.diag.shape[0]
    dev = et.diag.device
    rows = torch.zeros((0, 1, 8, 6), dtype=torch.bfloat16, device=dev)
    if plain or dev.type == "cpu":
        return dense_gram_plain(rows, torch.zeros((0, 8), dtype=torch.int64, device=dev), False, et.h_ij, et.diag,
                                s.e_src, s.e_dst)
    empty = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    return kernels.dense_gram(rows, empty[:0].view(0, 8), empty[:0], empty, et.h_ij, et.diag, s.e_dst32,
                              s.edges_by_dst.order, s.edges_by_dst.off, False)


def _damping_from_diag(floor: float, active: torch.Tensor, diag: torch.Tensor):
    """(diag_eff, unit) of the LM damping lambda * diag_eff + unit: the
    diagonal floored at ``floor`` times its mean over active dofs, and a
    unit diagonal on dofs the system does not see (1e-8 on the others)."""
    active_dof = active[:, None].expand(active.shape[0], 6).reshape(-1)
    mean_diag = torch.where(active_dof, diag, 0.0).sum() / torch.clamp(active_dof.sum().to(torch.float32), min=1.0)
    diag_eff = torch.maximum(diag, floor * mean_diag)
    unit = torch.where(active_dof & (diag > 1e-12), 1e-8, 1.0)
    return diag_eff, unit


def dense_damp_plain(jtj: torch.Tensor, lm_lambda: torch.Tensor, active: torch.Tensor, floor: float) -> torch.Tensor:
    """The damped dense system: (jtj_ii + lambda diag_eff_i) + unit_i on the
    diagonal, jtj elsewhere; the damping from the matrix's own diagonal."""
    diag = torch.diagonal(jtj)
    diag_eff, unit = _damping_from_diag(floor, active, diag)
    out = jtj.clone()
    out.diagonal().copy_((diag + lm_lambda * diag_eff) + unit)
    return out


def dense_damp(jtj: torch.Tensor, lm_lambda: torch.Tensor, active: torch.Tensor, floor: float, plain: bool = False):
    """Kernel O on CUDA tensors; ``lm_lambda`` a () device tensor."""
    if plain or jtj.device.type == "cpu":
        return dense_damp_plain(jtj, lm_lambda, active, floor)
    return kernels.dense_damp(jtj, lm_lambda, active, floor)


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor, NaN where ``a`` is not positive definite
    (the JAX package's ``cho_factor`` gives NaN there; ``cholesky_ex``
    gives a finite partial factor and ``info`` > 0): no host sync."""
    chol, info = torch.linalg.cholesky_ex(a, check_errors=False)
    return chol.masked_fill_(info != 0, float("nan"))


def cholesky(a: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The factor: cuSOLVER's on CUDA tensors (``kernels.cholesky``)."""
    if plain or a.device.type == "cpu":
        return cholesky_plain(a)
    return kernels.cholesky(a)


def chol_step(chol: torch.Tensor, jtr: torch.Tensor) -> torch.Tensor:
    """The Gauss-Newton step -(L Lᵀ)⁻¹ Jᵀr (NaN from a NaN factor)."""
    return -torch.cholesky_solve(jtr[:, None], chol)[:, 0]


# --------------------------------------------------------------------------
# the dense-matrix PCG: plain version of kernel P
# --------------------------------------------------------------------------


def diag_blocks(a: torch.Tensor) -> torch.Tensor:
    """The (N, 6, 6) diagonal blocks of a (6N, 6N) matrix."""
    n = a.shape[0] // 6
    return torch.diagonal(a.reshape(n, 6, n, 6), dim1=0, dim2=2).permute(2, 0, 1).contiguous()


def dense_pcg_plain(
    a: torch.Tensor, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float, active: torch.Tensor
) -> torch.Tensor:
    """Block-Jacobi PCG from x = 0 over the dense matrix ``a`` with the
    preconditioner ``minv`` (N, 6, 6), at most ``iters`` iterations while
    rᵀr > rtol² bᵀb, the remaining iterations no-ops (device flags);
    ``active`` False returns 0 (the JAX package's ``_pcg`` over a @ p)."""
    x = torch.zeros_like(b)
    r = b
    z = _apply_m(minv, r)
    p = z
    stop2 = (rtol * rtol) * torch.dot(b, b)
    rz = torch.dot(r, z)
    run = active
    for _ in range(iters):
        run = run & (torch.dot(r, r) > stop2)
        ap = a @ p
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        z = _apply_m(minv, r_n)
        rz_n = torch.dot(r_n, z)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z + beta * p
        x, r, p, rz = (torch.where(run, v, o) for v, o in ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return torch.where(active, x, 0.0)


def dense_pcg(
    a: torch.Tensor, b: torch.Tensor, iters: int, rtol: float, active: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """The dense-matrix PCG's solution of a x = b (the JAX package's
    ``_pcg_solve``): the preconditioner is ``spd6_inv`` (kernel G's entry)
    of ``a``'s diagonal blocks; the iterations are kernel P on CUDA
    tensors."""
    minv = spd6_inv(diag_blocks(a), plain=plain)
    if plain or a.device.type == "cpu":
        return dense_pcg_plain(a, minv, b, iters, rtol, active)
    return kernels.dense_pcg(a, minv, b, iters, rtol, active)


# --------------------------------------------------------------------------
# rigid pre-alignment
# --------------------------------------------------------------------------


def rigid_prealign(
    cfg: DynamicFusionConfig, field: WarpField, inputs: WarpSolveInputs, stride: int = 4, iters: int = 3,
    plain: bool = False,
) -> torch.Tensor:
    """Robust 6-dof rigid fit of the live surface to the warped canonical
    model (every ``stride``-th point), to fold into the camera pose before
    the non-rigid solve. Returns T (4, 4): pose <- T @ pose."""
    p_can = inputs.p_can[::stride]
    p_live = inputs.p_live[::stride]
    n_live = inputs.n_live[::stride]
    valid = ~torch.isnan(p_can[:, 0]) & ~torch.isnan(p_live[:, 0]) & ~torch.isnan(n_live[:, 0])
    p_can, p_live, n_live = (torch.nan_to_num(a) for a in (p_can, p_live, n_live))
    w_can = warpfield.warp_points(field, p_can, k=cfg.knn_k, plain=plain)
    valid = valid & torch.isfinite(w_can).all(dim=-1)
    w_can = torch.nan_to_num(w_can)
    dev = p_can.device
    t_acc = se3.identity(dev)
    eye6 = torch.eye(6, device=dev)
    for _ in range(iters):
        pl = se3.transform_points(t_acc, p_live)
        nl = se3.rotate_dirs(t_acc, n_live)
        d = w_can - pl
        r = (nl[:, 0] * d[:, 0] + nl[:, 1] * d[:, 1]) + nl[:, 2] * d[:, 2]
        sw = tukey_sqrt_weight(r, cfg.solver_tukey_c) * valid
        row = torch.cat([torch.linalg.cross(pl, nl), nl], dim=-1) * sw[:, None]
        rhs = r * sw
        a = (row[:, :, None] * row[:, None, :]).sum(0)
        b = (row * rhs[:, None]).sum(0)
        det = torch.linalg.det(a)
        good = torch.isfinite(det) & (torch.abs(det) > 1e-15)
        x = torch.linalg.solve_ex(torch.where(good, a, eye6), torch.where(good, b, 0.0)[:, None], check_errors=False)[0][:, 0]
        x = torch.where(good & torch.isfinite(x).all(), x, 0.0)
        t_acc = torch.where(good, se3.compose(se3.exp_twist(x), t_acc), t_acc)
    return t_acc


# --------------------------------------------------------------------------
# the solver
# --------------------------------------------------------------------------


def _check_cfg(cfg: DynamicFusionConfig) -> None:
    """Refuse solver options that have no meaning (the JAX package fails on
    them inside its trace): a tangential row stride below 1."""
    if _tangential(cfg) and cfg.solver_p2p_hessian_stride < 1:
        raise ValueError(f"solver_p2p_hessian_stride must be >= 1, got {cfg.solver_p2p_hessian_stride}")


def damping_terms(cfg: DynamicFusionConfig, active: torch.Tensor, blocks: torch.Tensor):
    """(diag_eff, unit) of the factored system's LM damping, from the
    (N, 6, 6) diagonal blocks' diagonal (``_damping_from_diag``)."""
    diag = torch.diagonal(blocks, dim1=-2, dim2=-1).reshape(-1)
    return _damping_from_diag(cfg.solver_damping_floor, active, diag)


def solve(
    cfg: DynamicFusionConfig, field: WarpField, inputs, plain: bool = False, system_fn=None, eval_fn=None,
    mesh=None, global_points: Optional[int] = None, trace: Optional[list] = None,
) -> Tuple[WarpField, SolveStats]:
    """Estimate the warp field for the current frame:
    ``cfg.solver_nonlinear_iters`` LM iterations. Under the lagged JᵀJ the
    system is assembled ONCE at the start and each candidate is evaluated
    exactly (gradient and cost); with ``solver_lagged_jtj=False`` (dense
    only) the system is rebuilt at the current point every iteration and
    candidates are scored by their cost. A candidate is accepted if the
    cost falls, and the loop stops (no-op iterations) once an accepted step
    improves the cost by <= solver_function_tolerance.

    The dense path's factor under ``solver_chol_reuse`` (lagged only) is
    the factor of the system damped with the lambda of its last rebuild
    (iteration 0 or after a rejected step): the loop has no host branch, so
    it factors every iteration, but a matrix equal to the reused one.

    The sharded step's hooks (JAX ``warp_solver.py:963-1118``):
    ``system_fn(s, dqs) -> (jtj, jtr, cost)`` assembles the dense normal
    equations (``parallel.distributed_gn.make_system_fn``: shard Grams,
    one psum, the edge blocks once) and ``eval_fn(s, dqs) -> (jtr, cost)``
    evaluates a candidate (``make_eval_fn``); a ``system_fn`` takes the
    dense path. ``mesh`` is the distributed PCG mode (JAX's ``axis_name``
    and ``axis_size``): ``inputs`` is a tuple of the mesh's local shards'
    point sets, ``global_points`` the whole solve's (unpadded) point count;
    each shard keeps its own bf16 rows, the gradient, the cost and the
    (N, 6, 6) diagonal blocks are psum'd, and every PCG matvec is the psum
    of the shards' data products plus the edge blocks and the damping
    applied once (``pcg_sharded``). Needs the lagged JᵀJ and the PCG.

    ``trace``, a list, receives each LM iteration's (point, candidate,
    candidate's cost, the cost it is tested against, accepted, running)
    as device tensors, for holding one solve's iterations against
    another's; nothing is recorded without it."""
    _check_cfg(cfg)
    n = field.positions.shape[0]
    dev = field.dq.device
    lagged = cfg.solver_lagged_jtj
    if mesh is not None:
        if not (lagged and cfg.solver_linear == "pcg"):
            raise ValueError("the distributed PCG solve needs solver_lagged_jtj and solver_linear='pcg'")
        if system_fn is not None or eval_fn is not None:
            raise ValueError("the distributed PCG solve takes no system_fn or eval_fn")
        if len(inputs) != len(mesh.local):
            raise ValueError(f"expected {len(mesh.local)} local shards' inputs, got {len(inputs)}")
        if global_points is None:
            # JAX's fallback: the padded count, every shard as large as this one
            global_points = inputs[0].p_can.shape[0] * mesh.n
        s = None
        shards = []
        for inp, fk in zip(inputs, zip(*(mesh.replicate(a) for a in field))):
            sk = prepare(cfg, WarpField(*fk), inp, plain=plain, global_points=global_points, edges=s)
            s = sk if s is None else s
            shards.append(Shard(sk))
    else:
        s = prepare(cfg, field, inputs, plain=plain)
    dqs = field.dq
    # the dense system: the direct solve (anything but "pcg", as in the JAX
    # package), or the PCG over the dense matrix with the unlagged JᵀJ or
    # an assembly hook
    dense = not _factored(cfg) or system_fn is not None
    direct = cfg.solver_linear != "pcg"
    reuse = direct and lagged and cfg.solver_chol_reuse
    floor = cfg.solver_damping_floor

    def data_terms(dq, system: bool, row_stride: int = 1):
        """(jtr, cost, blocks) of the data term at ``dq`` and the shards'
        rows: psum'd over the mesh's shards, else the one data term."""
        if mesh is None:
            dt = data_term(cfg, s, dq, system=system, plain=plain, row_stride=row_stride)
            return dt.jtr, dt.cost, dt.blocks, [dt.rows]
        dts = [data_term(cfg, sh.s, dq_k, system=system, plain=plain, row_stride=row_stride)
               for sh, dq_k in zip(shards, mesh.replicate(dq))]
        blocks = mesh.psum([d.blocks for d in dts]) if system else None
        return mesh.psum([d.jtr for d in dts]), mesh.psum([d.cost for d in dts]), blocks, [d.rows for d in dts]

    def evaluate(dq):
        """(jtr, cost) of a candidate (``eval_fn``'s, else the data and edge
        terms'; an unlagged solve scores by the cost alone)."""
        if eval_fn is not None:
            return eval_fn(s, dq)
        jtr_d, cost_d, _, _ = data_terms(dq, system=False)
        ec = edge_term(cfg, s, dq, plain=plain)
        return jtr_d + ec.jtr, cost_d + ec.cost

    lm_lambda = torch.full((), cfg.solver_lm_lambda_init, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    running = torch.ones((), dtype=torch.bool, device=dev)
    rebuild = torch.ones((), dtype=torch.bool, device=dev)  # iteration 0, or the last step was rejected
    used, stride = row_mode(cfg)
    if lagged:
        if system_fn is not None:
            jtj, jtr, cost_prev = system_fn(s, dqs)
        else:
            jtr_d, cost_d, blocks_d, rows = data_terms(dqs, system=True, row_stride=1 if dense else stride)
            et = edge_term(cfg, s, dqs, plain=plain)
            jtr = jtr_d + et.jtr
            cost_prev = cost_d + et.cost
            if dense:
                jtj = dense_gram(cfg, s, DataTerm(jtr_d, cost_d, rows[0], blocks_d), et, plain=plain)
            else:
                blocks_full = blocks_d + et.diag
                diag_eff, unit = damping_terms(cfg, field.active, blocks_full)
                if mesh is not None:
                    shards = [sh._replace(rows=r) for sh, r in zip(shards, rows)]
        cost0 = cost_prev
    minv = lam_f = None
    for it in range(cfg.solver_nonlinear_iters):
        if not lagged:
            # relinearize at the current point: after a rejected step the
            # point is unchanged and the deterministic kernels give the same
            # system again, as the JAX package's kept one
            if system_fn is not None:
                jtj, jtr, cost_lin = system_fn(s, dqs)
            else:
                dt = data_term(cfg, s, dqs, system=True, plain=plain)
                et = edge_term(cfg, s, dqs, plain=plain)
                jtj = dense_gram(cfg, s, dt, et, plain=plain)
                jtr = dt.jtr + et.jtr
                cost_lin = dt.cost + et.cost
            cost_prev = cost_lin if it == 0 else torch.where(running, cost_lin, cost_prev)
            if it == 0:
                cost0 = cost_lin
        if direct:
            lam_f = lm_lambda if lam_f is None or not reuse else torch.where(rebuild, lm_lambda, lam_f)
            step = chol_step(cholesky(dense_damp(jtj, lam_f, field.active, floor, plain=plain), plain=plain), jtr)
        elif dense:
            damped = dense_damp(jtj, lm_lambda, field.active, floor, plain=plain)
            step = -dense_pcg(damped, jtr, cfg.solver_linear_iters, cfg.solver_linear_tol, running, plain=plain)
        else:
            damp = lm_lambda * diag_eff + unit
            sys = System(rows[0], et, damp, used, stride)
            fresh = spd6_inv(blocks_full + torch.diag_embed(damp.reshape(n, 6)), plain=plain)
            minv = fresh if minv is None else torch.where(rebuild, fresh, minv)
            if mesh is None:
                step = -pcg(s, sys, minv, jtr, cfg.solver_linear_iters, cfg.solver_linear_tol, running, plain=plain)
            else:
                step = -pcg_sharded(mesh, shards, s, sys, minv, jtr, cfg.solver_linear_iters, cfg.solver_linear_tol,
                                    running, plain=plain)
        step = step.reshape(n, 6)
        step = torch.where(field.active[:, None] & torch.isfinite(step).all(-1, keepdim=True), step, 0.0)
        sn = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
        step = step * torch.clamp(cfg.solver_max_step / torch.clamp(sn, min=1e-12), max=1.0)
        cand = dualquat.normalize(dualquat.mul(dualquat.from_twist(step[:, :3], step[:, 3:]), dqs))
        jtr_c, cand_cost = evaluate(cand)
        better = running & (cand_cost < cost_prev)
        if trace is not None:
            trace.append((dqs, cand, cand_cost, cost_prev, better, running))
        improvement = torch.where(better, cost_prev - cand_cost, 0.0)
        dqs = torch.where(better, cand, dqs)
        if lagged:
            jtr = torch.where(better, jtr_c, jtr)
        cost_prev = torch.where(better, cand_cost, cost_prev)
        lm_lambda = torch.where(running, torch.clamp(torch.where(better, lm_lambda * 0.5, lm_lambda * 8.0), 1e-8, 1e6), lm_lambda)
        accepted = accepted + better.to(torch.int32)
        rebuild = ~better
        converged = better & (improvement <= cfg.solver_function_tolerance * torch.clamp(cost_prev, min=1e-20))
        running = running & ~converged
    new_field = field._replace(dq=torch.where(field.active[:, None], dqs, field.dq))
    return new_field, SolveStats(cost0, cost_prev, accepted)
