"""Kernel F's node pass and cost, and kernel E's split scan, in their
order on the CPU.

- ``warp_solver.data_sums_ordered`` (Jᵀr and the diagonal blocks summed as
  kernel F's node pass sums them, which the card's kernel must equal bit
  for bit) against a literal numpy transcription of the lane walk and its
  trees, and against ``data_term_plain``'s ``index_add_`` sums;
  ``warp_solver.sum_ordered`` (the cost in the order of one 1024-thread
  block) against its transcription and the plain cost.
- Kernel E's selection with a query's scan split over S lanes: lane s
  keeps the K best of the nodes s, s + S, ... (buffering candidates until
  its warp inserts them), then K rounds of a shuffle butterfly merge the
  lists (a numpy transcription of
  ``csrc/knn_blend.cu``'s ``knn_blend_kernel``) against the one-pass
  selection (its ``knn_serial_kernel``) and the plain version's stable
  sort, on node sets with exact distance ties and inactive nodes.

Inputs: seeded skewed lists (node 0 in about half of the points, so its
list is longer than 1 000 entries) over ``tests/torch_nonrigid_cases.py``'s
sphere solve, in the four modes of kernel F (one row, the tangential rows,
the point-to-point rows, the tangential rows with a row stride); the
Jacobian and residuals are the plain version's (``data_residual_and_jac``).
No JAX compile.

Tolerances, each with its reason:
- the transcriptions: bit for bit (the same float32 operations in the
  same order; the selection compares the same float32 distances);
- against ``data_term_plain``: TOL_DATA_REL of the largest entry
  (relative), as ``chip_smoke.py`` holds kernel F against it: the
  entries of a node are summed in another order.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

TOL_DATA_REL = 1e-4

N = 96
P = 2400
# kernel F's modes: one row; the tangential rows; point-to-point; the
# tangential rows with every 4th point's bf16 rows scaled (the Jacobian and
# the sums are the tangential mode's)
MODES = {
    "one_row": dict(),
    "tangential": dict(solver_p2p_weight=0.25),
    "point": dict(point_to_plane=False),
    "strided": dict(solver_p2p_weight=0.25, solver_p2p_hessian_stride=4),
}
LANES = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _case(mode):
    """(structure with seeded skewed lists, weighted Jacobian (P, R, 8, 6),
    weighted residuals (P, R), per-point Tukey costs (P,), config, dqs)."""
    cfg = dataclasses.replace(TCfg.small(), **MODES[mode])
    _, field, _, inputs = cases.sphere_problem(3, N, P)
    s = ts.prepare(cfg, field, inputs)
    rng = np.random.RandomState(7)
    knn = 1 + rng.rand(P, N - 1).argsort(1)[:, :8]
    knn[:, 0] = np.where(rng.rand(P) < 0.5, 0, knn[:, 0])
    knn = np.stack([rng.permutation(r) for r in knn])
    idx = torch.from_numpy(knn)
    s = s._replace(knn_idx=idx, knn_idx32=idx.to(torch.int32), pts_by_node=ts.node_lists(idx, N))
    rw, jac, _ = ts.data_residual_and_jac(cfg, s, field.dq)
    # the per-point costs, as the kernel's pass 1 writes them
    rho = ts.tukey_rho(_row_norm(cfg, s, field.dq), cfg.solver_tukey_c) * s.valid
    return s, jac, rw, rho, cfg, field.dq


def _row_norm(cfg, s, dq):
    """The joint norm of each point's unweighted residual rows, as
    ``data_residual_and_jac`` takes it."""
    p, k = s.knn_idx.shape
    fn, args = ts._data_residual, (torch.zeros((p, k, 6)), dq[s.knn_idx], s.w_knn, s.p_can, s.p_live, s.n_live)
    if s.t1 is not None:
        fn, args = ts._data_residual_tangential, args + (s.t1, s.t2, s.p2p_sw)
    elif not cfg.point_to_plane:
        fn, args = ts._data_residual_p2p, args[:5]
    res = torch.func.vmap(fn)(*args)
    rr = res[:, 0] * res[:, 0]
    for j in range(1, res.shape[1]):
        rr = rr + res[:, j] * res[:, j]
    return torch.sqrt(rr)


def _halve(v):
    """A halving tree over the first axis: v[:h] + v[h:2h], h = len / 2, ..."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        v = v[:h] + v[h:]
    return v[0]


def _node_walk(jac, rw, order, off, lanes):
    """Kernel F's node pass in numpy float32: each entry's 6 + 21 terms
    (its rows summed first), lane l of a node adds its entries l, l +
    lanes, ... in list order, a shuffle tree adds each warp's 32 lanes,
    then a halving tree the node's warps."""
    npt, r = rw.shape
    iu, ju = np.triu_indices(6)
    g = jac[:, 0] * rw[:, 0, None, None]
    h = jac[:, 0][..., iu] * jac[:, 0][..., ju]
    for j in range(1, r):
        g = g + jac[:, j] * rw[:, j, None, None]
        h = h + jac[:, j][..., iu] * jac[:, j][..., ju]
    terms = np.concatenate([g, h], -1).reshape(npt * 8, 27)
    jtr = np.zeros((N, 6), np.float32)
    blocks = np.zeros((N, 6, 6), np.float32)
    for nd in range(N):
        acc = np.zeros((lanes, 27), np.float32)
        for lane in range(lanes):
            for q in range(off[nd] + lane, off[nd + 1], lanes):
                acc[lane] = acc[lane] + terms[order[q]]
        warps = np.stack([_halve(acc[w * 32:(w + 1) * 32]) for w in range(lanes // 32)])
        tot = _halve(warps)
        jtr[nd] = tot[:6]
        blocks[nd][iu, ju] = tot[6:]
        blocks[nd][ju, iu] = tot[6:]
    return jtr.reshape(-1), blocks


def _cost_walk(rho):
    """The cost in the order of one 1024-thread block: thread t adds its
    points t, t + 1024, ..., a shuffle tree each warp's 32 threads, then
    the 32 warps'."""
    part = np.zeros(1024, np.float32)
    for t in range(1024):
        for i in range(t, rho.shape[0], 1024):
            part[t] = part[t] + rho[i]
    return _halve(np.stack([_halve(part[w * 32:(w + 1) * 32]) for w in range(32)]))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ordered_data_sums_are_the_node_walk(mode, lanes):
    """``data_sums_ordered`` and ``sum_ordered`` bit for bit against the
    transcription of kernel F's node pass and cost block, with a node of
    more than 1 000 entries."""
    s, jac, rw, rho, _, _ = _case(mode)
    counts = (s.pts_by_node.off[1:] - s.pts_by_node.off[:-1]).numpy()
    assert counts[0] > 1000 and jac.shape[1] == (1 if mode == "one_row" else 3)
    jtr, blocks = ts.data_sums_ordered(jac, rw, s.pts_by_node, lanes)
    want_jtr, want_blocks = _node_walk(jac.numpy(), rw.numpy(), s.pts_by_node.order.numpy(),
                                       s.pts_by_node.off.numpy(), lanes)
    np.testing.assert_array_equal(jtr.numpy(), want_jtr)
    np.testing.assert_array_equal(blocks.numpy(), want_blocks)
    if lanes == LANES[0]:
        assert np.array_equal(ts.sum_ordered(rho).numpy(), _cost_walk(rho.numpy()))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ordered_data_sums_match_plain(mode):
    """The kernel's order against ``data_term_plain``'s (``index_add_`` by
    node, torch's sum of the costs) in each mode; the lane counts part in
    the last bits."""
    s, jac, rw, rho, cfg, dq = _case(mode)
    ref = ts.data_term_plain(cfg, s, dq, True, row_stride=cfg.solver_p2p_hessian_stride)
    sums = {lanes: ts.data_sums_ordered(jac, rw, s.pts_by_node, lanes) for lanes in LANES}
    for jtr, blocks in sums.values():
        assert float((jtr - ref.jtr).abs().max()) <= TOL_DATA_REL * float(ref.jtr.abs().max())
        assert float((blocks - ref.blocks).abs().max()) <= TOL_DATA_REL * float(ref.blocks.abs().max())
    cost = ts.sum_ordered(rho)
    assert abs(float(cost - ref.cost)) <= TOL_DATA_REL * abs(float(ref.cost))
    assert not all(torch.equal(sums[LANES[0]][0], jtr) for jtr, _ in sums.values())


# --------------------------------------------------------------------------
# kernel E: the split scan and its merge
# --------------------------------------------------------------------------


def _insert(bd, bi, cd, ci):
    """Kernel E's insertion into a sorted (distance, index) list."""
    if not cd < bd[-1]:
        return
    for s in range(len(bd)):
        if cd < bd[s] or (cd == bd[s] and ci < bi[s]):
            bd[s], cd = cd, bd[s]
            bi[s], ci = ci, bi[s]


def _serial(d, k):
    """The one-thread-a-query scan (``knn_serial_kernel``) over a row of
    float32 distances."""
    bd, bi = [np.float32(np.inf)] * k, [0x7FFFFFFF] * k
    for j in range(d.shape[0]):
        _insert(bd, bi, d[j], j)
    return bd, bi


def _split(d, k, lanes, buffer=4):
    """``knn_blend_kernel``'s scan over ``lanes`` lanes and its merge: at
    step t lane s takes node t * lanes + s into its buffer if it beats the
    lane's K-th; when a lane holds ``buffer`` candidates, every lane
    inserts its buffer in order (the kernel flushes when a lane of its warp
    may lack room for the next four nodes: the lists do not depend on
    when); then K rounds, each a butterfly (xor 1, 2, ...) of the lanes'
    heads under (distance, index), the lane whose head won dropping it."""
    inf, empty = np.float32(np.inf), 0x7FFFFFFF
    lists = [([inf] * k, [empty] * k) for _ in range(lanes)]
    held = [[] for _ in range(lanes)]

    def flush():
        for (bd, bi), h in zip(lists, held):
            for cd, ci in h:
                _insert(bd, bi, cd, ci)
            h.clear()

    for step in range(-(-d.shape[0] // lanes)):
        for s, (bd, bi) in enumerate(lists):
            j = step * lanes + s
            if j < d.shape[0] and d[j] < bd[-1]:
                held[s].append((d[j], j))
        if any(len(h) == buffer for h in held):
            flush()
    flush()
    out_d, out_i = [], []
    for _ in range(k):
        cur = [(bd[0], bi[0]) for bd, bi in lists]
        o = 1
        while o < lanes:
            nxt = []
            for lane in range(lanes):
                (cd, ci), (od, oi) = cur[lane], cur[lane ^ o]
                nxt.append((od, oi) if od < cd or (od == cd and oi < ci) else (cd, ci))
            cur, o = nxt, o * 2
        wd, wi = cur[0]
        assert all(c == cur[0] for c in cur)  # every lane holds the winner
        out_d.append(wd)
        out_i.append(wi)
        for bd, bi in lists:
            if bi[0] == wi and bd[0] == wd:
                bd[:] = bd[1:] + [inf]
                bi[:] = bi[1:] + [empty]
    return out_d, out_i


def _tie_field(seed, n=96):
    """Nodes on a 1/8 m grid (every coordinate exact in float32), some of
    them repeated at other indices, about a quarter inactive; queries on
    the same grid and off it, so that many distances tie exactly."""
    rng = np.random.RandomState(seed)
    pos = rng.randint(-4, 5, (n, 3)).astype(np.float32) / 8.0
    pos[n // 2:n // 2 + 8] = pos[:8]  # repeated positions: ties at every query
    active = rng.rand(n) > 0.25
    queries = np.concatenate([rng.randint(-4, 5, (24, 3)).astype(np.float32) / 8.0,
                              (rng.randn(8, 3) * 0.3).astype(np.float32)])
    field = tw.WarpField(torch.from_numpy(pos), torch.zeros((n, 8)), torch.full((n,), 0.05),
                         torch.from_numpy(active), torch.tensor(int(active.sum()), dtype=torch.int32),
                         torch.zeros(n, dtype=torch.int32))
    return field, torch.from_numpy(queries)


@pytest.mark.parametrize("k", (5, 8))
@pytest.mark.parametrize("seed", (0, 1))
def test_split_scan_is_the_one_pass_selection(seed, k):
    """The split scan and merge for S = 1, 4, 8 and 16 (with the kernel's
    buffer of 4 candidates, and 1 and 8) equal the one-pass selection bit
    for bit (distances and indices), and the plain version's stable sort of
    the same distances; the inputs hold exact ties."""
    field, queries = _tie_field(seed)
    d = tw._dist2_rows(queries, field.positions, field.active).numpy()
    assert any(len(set(row.tolist())) < row.shape[0] - 8 for row in d)  # exact ties
    assert not field.active.all()
    sd, si = torch.sort(torch.from_numpy(d), dim=-1, stable=True)
    for q in range(d.shape[0]):
        want_d, want_i = _serial(d[q], k)
        assert want_i == si[q, :k].tolist()
        assert np.array_equal(np.array(want_d, np.float32).view(np.int32), sd[q, :k].numpy().view(np.int32))
        for lanes, buffer in ((1, 4), (4, 4), (8, 4), (8, 1), (16, 8)):
            got_d, got_i = _split(d[q], k, lanes, buffer)
            assert got_i == want_i
            assert np.array_equal(np.array(got_d, np.float32).view(np.int32),
                                  np.array(want_d, np.float32).view(np.int32))
