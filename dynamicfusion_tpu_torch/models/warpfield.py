"""The deformation warp field (port of ``dynamicfusion_tpu.models.warpfield``):
a static-capacity set of nodes with an active mask, exact brute-force KNN,
Gaussian blending weights, DQB warps, and node insertion with its capacity
lifecycle.

KNN, the blend, the point warp and the adaptive node radius are CUDA
kernel E (``csrc/knn_blend.cu``) on CUDA tensors; the insertion's
decimation, ranking and slot allocation are kernel H
(``csrc/insert_nodes.cu``); frame 0's node sampling is kernel L
(``csrc/extract.cu``); the removal of the net rigid motion is kernel Q
(``csrc/net_rigid.cu``). The plain versions here do the
same arithmetic for CPU tensors (or where the caller asks for them). The
squared distance is the JAX package's expansion
``(|q|^2 - 2 q.n) + |n|^2 (+ 1e9 for inactive nodes)``, clamped at 0 after
the selection; neighbours come in ascending distance, ties to the lower
node index (``lax.top_k``'s order), and the blend takes its sign pivot
from the first neighbour.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dynamicfusion_tpu_torch import device as device_mod, kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.core import compact, dualquat, quat

_BIG = 1e9
_CHUNK = 4096  # queries per distance-matrix chunk of the plain versions


@functools.lru_cache(maxsize=32)
def _fair_perm(p: int) -> np.ndarray:
    """Fixed permutation of [0, p) so that truncation at node capacity
    drops a spatially uniform subset (the JAX package's RandomState(0))."""
    return np.random.RandomState(0).permutation(p).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _fair_perm_on(p: int, device: torch.device) -> torch.Tensor:
    """``_fair_perm`` on the device, copied once per size (a copy from
    pageable host memory waits for the device)."""
    return torch.from_numpy(_fair_perm(p)).to(device)


class WarpField(NamedTuple):
    positions: torch.Tensor     # (N, 3) canonical node positions
    dq: torch.Tensor            # (N, 8) node transforms
    radius: torch.Tensor        # (N,)
    active: torch.Tensor        # (N,) bool
    count: torch.Tensor         # () int32
    last_support: torch.Tensor  # (N,) int32 frame of the last canonical-surface support


def create(cfg: DynamicFusionConfig, device="cuda") -> WarpField:
    """An empty field on ``device`` (CUDA unless the CPU is asked for)."""
    device = device_mod.resolve(device)
    n = cfg.max_nodes
    return WarpField(
        positions=torch.zeros((n, 3), dtype=torch.float32, device=device),
        dq=dualquat.identity(device).expand(n, 8).clone(),
        radius=torch.full((n,), cfg.node_radius, dtype=torch.float32, device=device),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        last_support=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def _sample_nodes_plain(points: torch.Tensor, valid: torch.Tensor, step: int, perm: torch.Tensor, n: int):
    """The plain version of kernel L's node sampling: (positions, active,
    count) of the first ``n`` valid candidates of ``points[::step]`` in the
    order ``perm``, by a static-size compaction."""
    pts = points[::step][perm]
    sel = compact.first_true(valid[::step][perm], n)
    ok = sel >= 0
    pos = torch.where(ok[:, None], pts[sel.clamp(min=0)], 0.0)
    return pos, ok, ok.sum(dtype=torch.int32)


def init_from_cloud(
    cfg: DynamicFusionConfig, points: torch.Tensor, valid: torch.Tensor, plain: bool = False
) -> WarpField:
    """Every ``node_sample_step``-th valid surface vertex becomes a node
    with identity transform; candidates are permuted first (``_fair_perm``)
    and truncated at ``max_nodes``; with ``node_radius_adaptive`` each node
    takes the radius of its own sampling density (``adaptive_radius``).
    Kernel L on CUDA tensors, the plain version on CPU tensors or where the
    caller asks."""
    dev = points.device
    step = cfg.node_sample_step
    n = cfg.max_nodes
    perm = _fair_perm_on((points.shape[0] + step - 1) // step, dev)
    if plain or dev.type == "cpu":
        pos, ok, count = _sample_nodes_plain(points, valid, step, perm, n)
    else:
        pos, ok, count = kernels.sample_nodes(points.contiguous(), valid.contiguous(), step, perm, n)
    if cfg.node_radius_adaptive:
        radius = torch.where(ok, adaptive_radius(cfg, pos, pos, ok, self_ref=True, plain=plain), cfg.node_radius)
    else:
        radius = torch.full((n,), cfg.node_radius, dtype=torch.float32, device=dev)
    return WarpField(
        positions=pos,
        dq=dualquat.identity(dev).expand(n, 8).clone(),
        radius=radius,
        active=ok,
        count=count,
        last_support=torch.zeros((n,), dtype=torch.int32, device=dev),
    )


# --------------------------------------------------------------------------
# plain versions of kernel E
# --------------------------------------------------------------------------


def _dist2_rows(q: torch.Tensor, nodes: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared distances by the expansion, written out per component
    in the order kernel E computes it."""
    qq = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    nn = (nodes[:, 0] * nodes[:, 0] + nodes[:, 1] * nodes[:, 1]) + nodes[:, 2] * nodes[:, 2]
    qn = (q[:, None, 0] * nodes[None, :, 0] + q[:, None, 1] * nodes[None, :, 1]) + q[:, None, 2] * nodes[None, :, 2]
    big = torch.where(active, 0.0, _BIG)
    return ((qq[:, None] - 2.0 * qn) + nn[None, :]) + big[None, :]


def _knn_plain(field: WarpField, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    q = torch.nan_to_num(queries)
    d2s, idxs = [], []
    for s in range(0, max(q.shape[0], 1), _CHUNK):
        d2 = _dist2_rows(q[s : s + _CHUNK], field.positions, field.active)
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        d2s.append(vals[:, :k])
        idxs.append(idx[:, :k])
    return torch.clamp(torch.cat(d2s), min=0.0), torch.cat(idxs)


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x y + z in float32 with one rounding, as a fused multiply-add: the
    float64 product of two float32 values is exact, the float64 sum is
    rounded once more before float32 (a double rounding that moves the
    result by one ulp only when the float64 sum falls on a float32
    tie, ~2^-29 of sums)."""
    return (x.double() * y.double() + z.double()).float()


def _dist2_fma(q: torch.Tensor, nodes: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared distances by the expansion with each three-term sum a
    chain of fused multiply-adds, as the JAX package's jitted
    ``_adaptive_radius`` takes them on the CPU (XLA contracts the products
    of its dot and of its fused row sums)."""

    def sq(v):
        return _fma(v[:, 2], v[:, 2], _fma(v[:, 1], v[:, 1], v[:, 0] * v[:, 0]))

    qn = _fma(q[:, None, 2], nodes[None, :, 2], _fma(q[:, None, 1], nodes[None, :, 1], q[:, None, 0] * nodes[None, :, 0]))
    big = torch.where(ok, 0.0, _BIG)
    return ((sq(q)[:, None] - 2.0 * qn) + sq(nodes)[None, :]) + big[None, :]


def _adaptive_radius_plain(
    cfg: DynamicFusionConfig, positions: torch.Tensor, ref_pos: torch.Tensor, ref_ok: torch.Tensor, k: int
) -> torch.Tensor:
    d2s = []
    for s in range(0, max(positions.shape[0], 1), _CHUNK):
        d2 = _dist2_fma(positions[s : s + _CHUNK], ref_pos, ref_ok)
        d2s.append(torch.kthvalue(d2, k, dim=1).values)
    dk = torch.sqrt(torch.clamp(torch.cat(d2s), min=0.0))
    return torch.clamp(cfg.node_radius_scale * dk, cfg.node_radius_min, cfg.node_radius_max)


def adaptive_radius(
    cfg: DynamicFusionConfig, positions: torch.Tensor, ref_pos: torch.Tensor, ref_ok: torch.Tensor,
    self_ref: bool, plain: bool = False,
) -> torch.Tensor:
    """(M,) radius of each (finite) position from the local node density:
    ``node_radius_scale`` times the distance to the ``node_radius_knn``-th
    nearest reference node (one more when the references are the positions
    themselves, ``self_ref``), clipped to [``node_radius_min``,
    ``node_radius_max``]; references not ``ref_ok`` are 1e9 further away.
    The distance is the expansion, its sums fused multiply-adds
    (``_dist2_fma``). Kernel E on CUDA tensors."""
    k = cfg.node_radius_knn + (1 if self_ref else 0)
    if plain or positions.device.type == "cpu":
        return _adaptive_radius_plain(cfg, positions, ref_pos, ref_ok, k)
    return kernels.node_radius(ref_pos, ref_ok, positions.contiguous(), k, cfg.node_radius_scale,
                               cfg.node_radius_min, cfg.node_radius_max)


def weights_from_dist2(radius: torch.Tensor, dist2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gaussian blending weights exp(-d^2 / (2 r^2)); inactive (1e9-away)
    neighbours underflow to exactly 0."""
    r = radius[idx]
    return torch.exp(-dist2 / (2.0 * r * r))


def quality(w: torch.Tensor) -> torch.Tensor:
    """Blend quality clip(mean_k w_k, 0, 1), summed over k in order."""
    acc = w[..., 0]
    for j in range(1, w.shape[-1]):
        acc = acc + w[..., j]
    return torch.clamp(acc / w.shape[-1], 0.0, 1.0)


def _warp_with(blended: torch.Tensor, points: torch.Tensor, normals: Optional[torch.Tensor]):
    """Transform points (and rotate normals) by per-point blended dual
    quaternions; NaN inputs give NaN outputs."""
    warped = dualquat.transform(blended, torch.nan_to_num(points))
    warped = torch.where(torch.isnan(points[..., :1]), float("nan"), warped)
    if normals is None:
        return warped, None
    wn = dualquat.rotate(blended, torch.nan_to_num(normals))
    wn = torch.where(torch.isnan(normals[..., :1]), float("nan"), wn)
    return warped, wn


class KnnBlend(NamedTuple):
    d2: torch.Tensor                  # (Q, k) squared distances, >= 0
    idx: torch.Tensor                 # (Q, k) int64 node ids, nearest first
    w: torch.Tensor                   # (Q, k) Gaussian weights
    blend: Optional[torch.Tensor]     # (Q, 8) DQB-blended dual quaternion
    quality: Optional[torch.Tensor]   # (Q,) clip(mean w, 0, 1)
    points: Optional[torch.Tensor]    # (Q, 3) warped queries, NaN passed through
    normals: Optional[torch.Tensor]   # (Q, 3) rotated normals


def knn_blend_plain(
    field: WarpField, queries: torch.Tensor, k: int, blend: bool = False,
    warp: bool = False, normals: Optional[torch.Tensor] = None,
) -> KnnBlend:
    d2, idx = _knn_plain(field, queries, k)
    w = weights_from_dist2(field.radius, d2, idx)
    b = dualquat.blend(w, field.dq[idx]) if (blend or warp) else None
    wp = wn = None
    if warp:
        wp, wn = _warp_with(b, queries, normals)
    return KnnBlend(d2, idx, w, b, quality(w) if blend else None, wp, wn)


def knn_blend(
    field: WarpField, queries: torch.Tensor, k: int, blend: bool = False,
    warp: bool = False, normals: Optional[torch.Tensor] = None, plain: bool = False,
) -> KnnBlend:
    """Kernel E on CUDA tensors, the plain version on CPU tensors or where
    the caller asks: the k nearest active nodes of each query, their
    weights and, on request, the blend with its quality (``blend``) and the
    warped queries and normals (``warp``)."""
    if plain or queries.device.type == "cpu":
        return knn_blend_plain(field, queries, k, blend, warp, normals)
    out = kernels.knn_blend(
        field.positions, field.active, field.radius, field.dq, queries.contiguous(), k,
        blend=blend, warp=warp, normals=None if normals is None else normals.contiguous(),
    )
    return KnnBlend(*out)


def knn(field: WarpField, queries: torch.Tensor, k: int, plain: bool = False):
    """(dist2 (Q, k), idx (Q, k)) of the k nearest active nodes."""
    r = knn_blend(field, queries, k, plain=plain)
    return r.d2, r.idx


def warp_points(
    field: WarpField, points: torch.Tensor, normals: Optional[torch.Tensor] = None,
    k: int = 8, plain: bool = False,
):
    """DQB-warp a point set (and optionally normals) by the field; NaN
    inputs pass through."""
    shape = points.shape
    r = knn_blend(
        field, points.reshape(-1, 3), k, warp=True,
        normals=None if normals is None else normals.reshape(-1, 3), plain=plain,
    )
    if normals is None:
        return r.points.reshape(shape)
    return r.points.reshape(shape), r.normals.reshape(shape)


def warp_dq_at(field: WarpField, points: torch.Tensor, k: int = 8, plain: bool = False) -> torch.Tensor:
    """The blended dual quaternion of the field at the given points."""
    return knn_blend(field, points, k, blend=True, plain=plain).blend


def _mutual_nearest_plain(field: WarpField, candidates: torch.Tensor, valid: torch.Tensor):
    q = torch.nan_to_num(candidates)
    cand, node = [], torch.full((field.positions.shape[0],), _BIG, device=q.device)
    for s in range(0, max(q.shape[0], 1), _CHUNK):
        d2 = _dist2_rows(q[s : s + _CHUNK], field.positions, field.active)
        cand.append(d2.amin(dim=1))
        node = torch.minimum(node, torch.where(valid[s : s + _CHUNK, None], d2, _BIG).amin(dim=0))
    return torch.clamp(torch.cat(cand), min=0.0), torch.clamp(node, min=0.0)


def mutual_nearest(field: WarpField, candidates: torch.Tensor, valid: torch.Tensor, plain: bool = False):
    """Per candidate, the squared distance to its nearest active node (the
    coverage test); per node, to its nearest VALID candidate (the support
    test). Kernel E on CUDA tensors."""
    if plain or candidates.device.type == "cpu":
        return _mutual_nearest_plain(field, candidates, valid)
    return kernels.mutual_nearest(field.positions, field.active, candidates.contiguous(), valid.contiguous())


def nearest_dist2(field: WarpField, queries: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Squared distance to the nearest active node, (Q,)."""
    ones = torch.ones(queries.shape[0], dtype=torch.bool, device=queries.device)
    return mutual_nearest(field, queries, ones, plain=plain)[0]


# --------------------------------------------------------------------------
# node insertion and the capacity lifecycle
# --------------------------------------------------------------------------


def _cell_ids(candidates: torch.Tensor, cov: float) -> torch.Tensor:
    """The JAX package's int32 coverage-cell hash, with its wrapping
    multiplies done in int64 and cut back to 32 bits."""
    cell = torch.floor(torch.nan_to_num(candidates) / cov).to(torch.int32).to(torch.int64)
    h = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791)
    h = h & 0xFFFFFFFF
    return torch.where(h >= 2**31, h - 2**32, h)


class InsertPlan(NamedTuple):
    slots: torch.Tensor    # (N,) int64: slot the r-th new node goes to, N = none
    new_pos: torch.Tensor  # (N, 3) its position


def _insert_select_plain(
    cfg: DynamicFusionConfig, field: WarpField, candidates: torch.Tensor, valid: torch.Tensor,
    cand_d2: torch.Tensor, gate: torch.Tensor,
) -> InsertPlan:
    """Coverage-cell decimation (first occurrence in candidate order wins a
    cell), farthest-first ranking (ties to the lower index) and ascending
    free-slot allocation."""
    cov = cfg.node_coverage
    cap = field.positions.shape[0]
    dev = candidates.device
    uncovered = valid & (cand_d2 > cov * cov)
    cell_id = _cell_ids(candidates, cov)
    order = torch.sort(cell_id, stable=True)[1]
    sorted_id = cell_id[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sorted_id[1:] != sorted_id[:-1]])
    keep = torch.zeros_like(uncovered).scatter(0, order, uncovered[order] & first)
    free = torch.clamp(cap - field.count, min=0)
    score = torch.where(keep, cand_d2, -float("inf"))
    k = min(cap, score.shape[0])
    vals, sel_idx = torch.sort(score, descending=True, stable=True)
    sel = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    sel[:k] = torch.where(torch.isfinite(vals[:k]), sel_idx[:k], -1)
    rank = torch.arange(cap, device=dev)
    ok = (sel >= 0) & (rank < free) & gate
    free_idx = compact.first_true(~field.active, cap, fill=cap)
    slots = torch.where(ok, free_idx, cap)
    return InsertPlan(slots=slots, new_pos=candidates[sel.clamp(min=0)])


def _put_rows(dst: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """dst with dst[slots[r]] = rows[r] where slots[r] < len(dst); the
    others land in a spare row that is dropped."""
    ext = torch.cat([dst, dst[:1]])
    ext = ext.index_put((slots,), rows)
    return ext[: dst.shape[0]]


def _insert_apply_plain(
    field: WarpField, plan: InsertPlan, seed_dq: torch.Tensor, frame_idx: torch.Tensor, new_radius: torch.Tensor
) -> WarpField:
    """Write the new nodes into their slots as the JAX package's delta
    scatter does (old + (new - old)), the r-th with ``new_radius[r]``."""
    cap = field.positions.shape[0]
    s = plan.slots
    sc = s.clamp(max=cap - 1)
    upd = s < cap
    pos = _put_rows(field.positions, s, field.positions[sc] + (plan.new_pos - field.positions[sc]))
    dq = _put_rows(field.dq, s, field.dq[sc] + (seed_dq - field.dq[sc]))
    radius = _put_rows(field.radius, s, field.radius[sc] + (new_radius - field.radius[sc]))
    active = _put_rows(field.active, s, torch.ones_like(upd))
    fi = frame_idx.to(torch.int32)
    ls = _put_rows(field.last_support, s, field.last_support[sc] + (fi - field.last_support[sc]))
    count = field.count + upd.sum(dtype=torch.int32)
    return WarpField(pos, dq, radius, active, count, ls)


def insert_nodes(
    cfg: DynamicFusionConfig,
    field: WarpField,
    candidates: torch.Tensor,
    valid: torch.Tensor,
    frame_idx: torch.Tensor,
    plain: bool = False,
) -> WarpField:
    """Refresh every active node's ``last_support`` (nearest valid
    candidate within ``node_support_radius``), retire nodes unsupported
    for more than ``node_retire_after`` frames while the field is full,
    then, while ``count < cap`` (a device flag: nothing syncs), insert
    uncovered candidates (nearest node farther than ``node_coverage``)
    decimated to one per coverage cell, farthest first, into free slots,
    with transforms seeded from the field's blend at their positions and,
    with ``node_radius_adaptive``, radii from the density of the field's
    nodes after the retirement."""
    cap = field.positions.shape[0]
    cand_d2, node_d2 = mutual_nearest(field, candidates, valid, plain=plain)
    fi = frame_idx.to(torch.int32)
    if cfg.node_retire_after > 0:
        r = cfg.node_support_radius
        supported = field.active & (node_d2 < r * r)
        last_support = torch.where(supported, fi, field.last_support)
        full = field.count >= cap
        retire = full & field.active & ((fi - last_support) > cfg.node_retire_after)
        active = field.active & ~retire
        field = field._replace(active=active, count=active.sum(dtype=torch.int32), last_support=last_support)
    gate = field.count < cap
    if plain or candidates.device.type == "cpu":
        plan = _insert_select_plain(cfg, field, candidates, valid, cand_d2, gate)
    else:
        plan = InsertPlan(*kernels.insert_select(
            candidates.contiguous(), cand_d2, valid.contiguous(), field.active, field.count, gate,
            cfg.node_coverage,
        ))
    new_pos = torch.nan_to_num(plan.new_pos)
    seed_dq = warp_dq_at(field, new_pos, k=min(8, cap), plain=plain)
    if cfg.node_radius_adaptive:
        new_radius = adaptive_radius(cfg, new_pos, field.positions, field.active, self_ref=False, plain=plain)
    else:
        new_radius = torch.full((cap,), cfg.node_radius, dtype=torch.float32, device=candidates.device)
    if plain or candidates.device.type == "cpu":
        return _insert_apply_plain(field, plan, seed_dq, fi, new_radius)
    return WarpField(*kernels.insert_apply(
        field.positions, field.dq, field.radius, field.active, field.count, field.last_support,
        plan.slots, plan.new_pos, seed_dq, fi, new_radius,
    ))


# --------------------------------------------------------------------------
# the net rigid removal: plain version of kernel Q
# --------------------------------------------------------------------------


def _dot3_rows(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m @ v for a 3x3 m, each row's sum written out left to right."""
    return (m[:, 0] * v[0] + m[:, 1] * v[1]) + m[:, 2] * v[2]


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
            + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))


def _remove_net_rigid_plain(prev: WarpField, new: WarpField, alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    p = prev.positions
    w = prev.active.to(torch.float32)
    wsum = w.sum()
    cnt = torch.clamp(wsum, min=1.0)
    a = dualquat.transform(prev.dq, p)  # pre-solve live node positions
    b = dualquat.transform(new.dq, p)   # post-solve
    ca = (a * w[:, None]).sum(0) / cnt
    cb = (b * w[:, None]).sum(0) / cnt
    h = (((a - ca) * w[:, None])[:, :, None] * (b - cb)[:, None, :]).sum(0)
    # the SVD in float64 (the kernel's precision); R = V diag(1, 1, det(V Uᵀ)) Uᵀ
    u, _, vh = torch.linalg.svd(h.double())
    v = vh.T
    d = _det3(v) * _det3(u)
    r = (v * torch.stack([torch.ones_like(d), torch.ones_like(d), d])[None, :] @ u.T).to(torch.float32)
    t = cb - _dot3_rows(r, ca)
    rt = r.T.contiguous()
    g = dualquat.from_rot_trans(quat.from_matrix(rt), -_dot3_rows(rt, t))
    if alpha < 1.0:
        g = dualquat.normalize(alpha * g + (1.0 - alpha) * dualquat.identity(p.device))
    cleaned = dualquat.normalize(dualquat.mul(g[None], new.dq))
    ok = (wsum >= 3.0) & torch.isfinite(r).all() & torch.isfinite(t).all() & torch.isfinite(cleaned).all()
    return torch.where(ok & new.active[:, None], cleaned, new.dq), g


def remove_net_rigid(prev: WarpField, new: WarpField, alpha: float = 1.0, plain: bool = False) -> WarpField:
    """Project the net rigid component out of one frame's warp increment
    (the JAX package's leaky gauge anchor): the weighted Kabsch fit G of
    the active nodes' pre-solve (``prev``) to post-solve (``new``) live
    positions, its inverse blended toward the identity by ``alpha``, is
    left-multiplied into every active node's transform; nothing changes
    unless at least three nodes are active and everything is finite.
    Kernel Q on CUDA tensors (no host sync); the plain version takes the
    3x3 SVD from ``torch.linalg.svd``."""
    if plain or new.dq.device.type == "cpu":
        dq, _ = _remove_net_rigid_plain(prev, new, alpha)
    else:
        dq, _ = kernels.net_rigid(prev.positions, prev.dq, prev.active, new.dq, new.active, alpha)
    return new._replace(dq=dq)


def live_node_positions(field: WarpField) -> torch.Tensor:
    """Node positions warped into the live frame, positions + t(dq) (the
    warp graph as the renders overlay it)."""
    return field.positions + dualquat.translation(field.dq)
