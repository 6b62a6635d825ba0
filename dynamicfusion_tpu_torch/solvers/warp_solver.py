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
  damping;
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
and the damping kernel O (``csrc/dense_system.cu``); the factor and its
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

Not ported (off in every preset; ``_check_cfg``): the dense-matrix PCG
of ``solver_linear="pcg"`` with the unlagged JᵀJ, and the tangential
rows subsampled in or kept out of the PCG matrix.
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
    node (ties in entry order), node n owns order[off[n]:off[n + 1]]."""

    order: torch.Tensor  # (M,) int32
    off: torch.Tensor    # (N + 1,) int32


def node_lists(keys: torch.Tensor, n_nodes: int) -> NodeLists:
    srt, order = torch.sort(keys.reshape(-1), stable=True)
    off = torch.searchsorted(srt, torch.arange(n_nodes + 1, device=keys.device, dtype=srt.dtype))
    return NodeLists(order.to(torch.int32), off.to(torch.int32))


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


def _tangential(cfg: DynamicFusionConfig) -> bool:
    """The data term has the tangential rows: point-to-plane with
    ``solver_p2p_weight`` > 0 (the JAX package's ``_data_fn_args`` order)."""
    return cfg.point_to_plane and cfg.solver_p2p_weight > 0.0


def prepare(cfg: DynamicFusionConfig, field: WarpField, inputs: WarpSolveInputs, plain: bool = False) -> SolveStructure:
    """Subsample by ``solver_hessian_stride`` (above 8192 points), KNN the
    solve points, build the edge graph and the node lists; with the
    tangential term, the tangent basis and the per-point weight
    sqrt(solver_p2p_weight * clip(gate, 0, 1)). The live normal must be
    finite only where a row projects on it (point-to-plane)."""
    n = field.positions.shape[0]
    hs = cfg.solver_hessian_stride if inputs.p_can.shape[0] > 8192 else 1
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
    e_src, e_dst, e_valid = build_edges(field, plain=plain)
    alpha = torch.maximum(field.radius[e_src], field.radius[e_dst]) * (1.0 / hs)
    return SolveStructure(
        p_can=p_can.contiguous(), p_live=p_live.contiguous(), n_live=n_live.contiguous(), valid=valid,
        knn_idx=kb.idx, w_knn=kb.w.contiguous(),
        e_src=e_src, e_dst=e_dst, e_valid=e_valid, v_dst=field.positions[e_dst].contiguous(), alpha=alpha,
        pts_by_node=node_lists(kb.idx, n), edges_by_dst=node_lists(e_dst, n),
        t1=t1, t2=t2, p2p_sw=p2p_sw,
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


def data_term_plain(cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor, system: bool) -> DataTerm:
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
    return DataTerm(jtr, cost, jac.to(torch.bfloat16), blocks)


def data_term(cfg: DynamicFusionConfig, s: SolveStructure, dqs: torch.Tensor, system: bool, plain: bool = False) -> DataTerm:
    """Kernel F on CUDA tensors: Jᵀr and the cost, and with ``system`` the
    bf16 rows and the per-node diagonal blocks."""
    if plain or dqs.device.type == "cpu":
        return data_term_plain(cfg, s, dqs, system)
    return DataTerm(*kernels.data_term(
        s.p_can, s.p_live, s.n_live, s.valid, s.knn_idx, s.w_knn, dqs,
        s.pts_by_node.order, s.pts_by_node.off, cfg.solver_tukey_c, system, s.t1, s.t2, s.p2p_sw,
        point=not cfg.point_to_plane,
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


def matvec_plain(s: SolveStructure, sys: System, p: torch.Tensor) -> torch.Tensor:
    """(rows_bf16ᵀ · bf16(rows_bf16 · bf16(p))) + edge blocks · p + damp * p,
    accumulated in float32 (the JAX package's rounding points: t is
    rounded per (point, row))."""
    n = sys.damp.shape[0] // 6
    rows = sys.rows.to(torch.float32)
    pm = _bf16(p).reshape(n, 6)
    t = _bf16((rows * pm[s.knn_idx][:, None]).sum((2, 3)))
    data = torch.zeros((n, 6), device=p.device).index_add_(
        0, s.knn_idx.reshape(-1), (rows * t[:, :, None, None]).sum(1).reshape(-1, 6)
    )
    pv = p.reshape(n, 6)
    p_i, p_j = pv[s.e_src], pv[s.e_dst]
    e = sys.edge
    q_i = (e.h_ii @ p_i[:, :, None] + e.h_ij @ p_j[:, :, None])[..., 0]
    q_j = (e.h_ij.transpose(1, 2) @ p_i[:, :, None] + e.h_jj @ p_j[:, :, None])[..., 0]
    c = s.e_src.shape[0] // n
    edge = q_i.reshape(n, c, 6).sum(1) + torch.zeros((n, 6), device=p.device).index_add_(0, s.e_dst, q_j)
    return (data + edge).reshape(-1) + sys.damp * p


def matvec(s: SolveStructure, sys: System, p: torch.Tensor, plain: bool = False) -> torch.Tensor:
    if plain or p.device.type == "cpu":
        return matvec_plain(s, sys, p)
    return kernels.matvec(_kernel_system(s, sys), p)


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
    e = sys.edge
    return kernels.FactoredSystem(
        rows=sys.rows, knn_idx=s.knn_idx, pt_order=s.pts_by_node.order, pt_off=s.pts_by_node.off,
        h_ii=e.h_ii, h_jj=e.h_jj, h_ij=e.h_ij, e_dst=s.e_dst,
        e_order=s.edges_by_dst.order, e_off=s.edges_by_dst.off, damp=sys.damp,
    )


def pcg(
    s: SolveStructure, sys: System, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float,
    active: torch.Tensor, plain: bool = False,
) -> torch.Tensor:
    """Kernel G's PCG entry (the whole solve in one launch) on CUDA tensors."""
    if plain or b.device.type == "cpu":
        return pcg_plain(s, sys, minv, b, iters, rtol, active)
    return kernels.pcg(_kernel_system(s, sys), minv, b, iters, rtol, active)


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


def dense_gram_plain(
    rows: torch.Tensor, knn_idx: torch.Tensor, int8: bool, h_ij: torch.Tensor, diag: torch.Tensor,
    e_src: torch.Tensor, e_dst: torch.Tensor,
) -> torch.Tensor:
    """The dense (6N, 6N) normal equations of the lagged or fresh system:
    the data Gram of the one-hot-expanded bf16 rows plus the ARAP blocks
    placed, summed as the JAX package sums them, data + ((A + Aᵀ) + D)
    with A the h_ij blocks at (src, dst) and D the diagonal blocks. With
    ``int8`` the rows are quantized per column, q = clip(round(a / c),
    ±127) (a true division, as XLA keeps it), and the Gram is float(QᵀQ)
    (c_i c_j), QᵀQ summed exactly in float64 (exact below 2^53; int32
    matrix products do not run on CUDA); else the bf16 rows' Gram summed
    exactly and rounded once."""
    n = diag.shape[0]
    a = dense_rows(rows, knn_idx, n)
    if int8:
        c = gram_scales_plain(a)
        q = torch.clamp(torch.round(a / c), -127.0, 127.0).to(torch.float64)
        data = (q.T @ q).to(torch.float32) * (c[:, None] * c[None, :])
    else:
        a = a.to(torch.float64)
        data = (a.T @ a).to(torch.float32)
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
        dt.rows, s.knn_idx, s.pts_by_node.order, s.pts_by_node.off, et.h_ij, et.diag, s.e_dst,
        s.edges_by_dst.order, s.edges_by_dst.off, cfg.solver_jtj_int8,
    )


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
    """Refuse, one option at a time, what the port does not solve."""
    if cfg.solver_linear == "pcg" and not cfg.solver_lagged_jtj:
        raise NotImplementedError(
            "solver_linear='pcg' with solver_lagged_jtj=False (the dense-matrix PCG) is not ported")
    if _tangential(cfg):
        if cfg.solver_p2p_hessian_stride > 1:
            raise NotImplementedError(
                f"solver_p2p_hessian_stride={cfg.solver_p2p_hessian_stride} (tangential rows subsampled in the "
                "PCG matrix) is not ported")
        if cfg.solver_p2p_lag_hessian:
            raise NotImplementedError(
                "solver_p2p_lag_hessian=True (tangential rows kept out of the PCG matrix) is not ported")


def damping_terms(cfg: DynamicFusionConfig, active: torch.Tensor, blocks: torch.Tensor):
    """(diag_eff, unit) of the factored system's LM damping, from the
    (N, 6, 6) diagonal blocks' diagonal (``_damping_from_diag``)."""
    diag = torch.diagonal(blocks, dim1=-2, dim2=-1).reshape(-1)
    return _damping_from_diag(cfg.solver_damping_floor, active, diag)


def solve(
    cfg: DynamicFusionConfig, field: WarpField, inputs: WarpSolveInputs, plain: bool = False
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
    it factors every iteration, but a matrix equal to the reused one."""
    _check_cfg(cfg)
    n = field.positions.shape[0]
    dev = field.dq.device
    s = prepare(cfg, field, inputs, plain=plain)
    dqs = field.dq
    dense = cfg.solver_linear != "pcg"  # anything else is the direct solve, as in the JAX package
    lagged = cfg.solver_lagged_jtj
    reuse = dense and lagged and cfg.solver_chol_reuse
    floor = cfg.solver_damping_floor

    lm_lambda = torch.full((), cfg.solver_lm_lambda_init, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    running = torch.ones((), dtype=torch.bool, device=dev)
    rebuild = torch.ones((), dtype=torch.bool, device=dev)  # iteration 0, or the last step was rejected
    if lagged:
        dt = data_term(cfg, s, dqs, system=True, plain=plain)
        et = edge_term(cfg, s, dqs, plain=plain)
        jtr = dt.jtr + et.jtr
        cost_prev = dt.cost + et.cost
        cost0 = cost_prev
        if dense:
            jtj = dense_gram(cfg, s, dt, et, plain=plain)
        else:
            blocks_full = dt.blocks + et.diag
            diag_eff, unit = damping_terms(cfg, field.active, blocks_full)
    minv = lam_f = None
    for it in range(cfg.solver_nonlinear_iters):
        if not lagged:
            # relinearize at the current point: after a rejected step the
            # point is unchanged and the deterministic kernels give the same
            # system again, as the JAX package's kept one
            dt = data_term(cfg, s, dqs, system=True, plain=plain)
            et = edge_term(cfg, s, dqs, plain=plain)
            jtj = dense_gram(cfg, s, dt, et, plain=plain)
            jtr = dt.jtr + et.jtr
            cost_lin = dt.cost + et.cost
            cost_prev = cost_lin if it == 0 else torch.where(running, cost_lin, cost_prev)
            if it == 0:
                cost0 = cost_lin
        if dense:
            lam_f = lm_lambda if lam_f is None or not reuse else torch.where(rebuild, lm_lambda, lam_f)
            step = chol_step(cholesky(dense_damp(jtj, lam_f, field.active, floor, plain=plain), plain=plain), jtr)
        else:
            damp = lm_lambda * diag_eff + unit
            sys = System(dt.rows, et, damp)
            fresh = spd6_inv(blocks_full + torch.diag_embed(damp.reshape(n, 6)), plain=plain)
            minv = fresh if minv is None else torch.where(rebuild, fresh, minv)
            step = -pcg(s, sys, minv, jtr, cfg.solver_linear_iters, cfg.solver_linear_tol, running, plain=plain)
        step = step.reshape(n, 6)
        step = torch.where(field.active[:, None] & torch.isfinite(step).all(-1, keepdim=True), step, 0.0)
        sn = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
        step = step * torch.clamp(cfg.solver_max_step / torch.clamp(sn, min=1e-12), max=1.0)
        cand = dualquat.normalize(dualquat.mul(dualquat.from_twist(step[:, :3], step[:, 3:]), dqs))
        dc = data_term(cfg, s, cand, system=False, plain=plain)
        ec = edge_term(cfg, s, cand, plain=plain)
        cand_cost = dc.cost + ec.cost
        better = running & (cand_cost < cost_prev)
        improvement = torch.where(better, cost_prev - cand_cost, 0.0)
        dqs = torch.where(better, cand, dqs)
        if lagged:
            jtr = torch.where(better, dc.jtr + ec.jtr, jtr)
        cost_prev = torch.where(better, cand_cost, cost_prev)
        lm_lambda = torch.where(running, torch.clamp(torch.where(better, lm_lambda * 0.5, lm_lambda * 8.0), 1e-8, 1e6), lm_lambda)
        accepted = accepted + better.to(torch.int32)
        rebuild = ~better
        converged = better & (improvement <= cfg.solver_function_tolerance * torch.clamp(cost_prev, min=1e-20))
        running = running & ~converged
    new_field = field._replace(dq=torch.where(field.active[:, None], dqs, field.dq))
    return new_field, SolveStats(cost0, cost_prev, accepted)
