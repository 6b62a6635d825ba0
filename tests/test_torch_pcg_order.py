"""Kernel G's per-lane sum order on the CPU: the data-only matvec's plain
version in the kernel's order (``warp_solver.data_matvec_ordered``, which
the card's ``data_matvec`` must equal bit for bit) against a literal numpy
transcription of the warp walk, against the plain matvec in torch's order,
and the heavy-first node order that ``prepare`` hands the kernels.

Inputs: seeded skewed lists (node 0 in about half of the points, so its
list is longer than 1 000 entries; every other node's longer than 32) and
``tests/torch_nonrigid_cases.py``'s sphere solve. No JAX compile.

Tolerances, each with its reason:
- the transcription: bit for bit (the same float32 operations in the same
  order);
- against ``data_matvec_plain``: TOL_MV of the largest entry (relative),
  as ``tests/test_torch_warp_solver.py`` holds the factored matvec: the
  48 products of t and each node's entries are summed in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

TOL_MV = 1e-4

N = 96
P = 2400
# (rows a point, rows used, tangential stride): one row; three rows; the
# plane rows only (solver_p2p_lag_hessian); the tangential rows of every
# 4th point (solver_p2p_hessian_stride=4)
MODES = {"one_row": (1, None, 1), "three_rows": (3, None, 1), "lag": (3, 1, 1), "stride4": (3, 3, 4)}


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 -> float32, round to nearest even (finite x)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _skewed(nrows, seed=5):
    """(structure, rows (P, R, 8, 6) bf16, p (6N,)): each point's 8
    distinct neighbours from nodes 1 .. N - 1, node 0 in place of the first
    for about half of the points."""
    rng = np.random.RandomState(seed)
    knn = 1 + rng.rand(P, N - 1).argsort(1)[:, :8]
    knn[:, 0] = np.where(rng.rand(P) < 0.5, 0, knn[:, 0])
    knn = np.stack([rng.permutation(r) for r in knn])
    idx = torch.from_numpy(knn)
    rows = torch.from_numpy(rng.randn(P, nrows, 8, 6).astype(np.float32)).to(torch.bfloat16)
    p = torch.from_numpy(rng.randn(6 * N).astype(np.float32))
    prob = cases.sphere_problem(1, N, 64)
    s = ts.prepare(TCfg.small(), prob[1], prob[3])
    s = s._replace(knn_idx=idx, knn_idx32=idx.to(torch.int32), pts_by_node=ts.node_lists(idx, N, heavy=True))
    return s, rows, p


def _system(rows, used, stride):
    zeros = torch.zeros((4 * N, 6, 6))
    edge = ts.EdgeTerm(torch.zeros(6 * N), torch.zeros(()), zeros, zeros, zeros, torch.zeros((N, 6, 6)))
    return ts.System(rows, edge, torch.zeros(6 * N), used, stride)


def _warp_walk(knn, order, off, rows, p, used, stride):
    """Kernel G's row_t, lane_data and warp_sum6 in numpy float32, one
    operation at a time."""
    npt, r = rows.shape[:2]
    used = r if used is None else used

    def rows_in(pt):
        if used == 1:
            return 1
        return r if pt % stride == 0 else 1

    pb = _bf16(p)
    acc = np.zeros((npt, r), np.float32)  # every (point, row) at once, each in the kernel's order
    for k in range(8):
        for d in range(6):
            acc = acc + rows[:, :, k, d] * pb[6 * knn[:, k] + d][:, None]
    t = _bf16(acc)
    out = np.zeros((N, 6), np.float32)
    for nd in range(N):
        lanes = np.zeros((32, 6), np.float32)
        for lane in range(32):
            for q in range(off[nd] + lane, off[nd + 1], 32):
                ent = order[q]
                pt, k = divmod(int(ent), 8)
                s = rows[pt, 0, k] * t[pt, 0]
                for j in range(1, rows_in(pt)):
                    s = s + rows[pt, j, k] * t[pt, j]
                lanes[lane] = lanes[lane] + s
        for o in (16, 8, 4, 2, 1):
            lanes[:o] = lanes[:o] + lanes[o:2 * o]
        out[nd] = lanes[0]
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ordered_data_matvec_is_the_warp_walk(mode):
    """``data_matvec_ordered`` bit for bit against the transcription of the
    kernel's walk: lane l sums a node's entries l, l + 32, ... in list
    order, then the shuffle tree (16, 8, 4, 2, 1) adds the lanes."""
    nrows, used, stride = MODES[mode]
    s, rows, p = _skewed(nrows)
    counts = (s.pts_by_node.off[1:] - s.pts_by_node.off[:-1]).numpy()
    assert counts[0] > 1000 and counts[1:].min() > 32
    got = ts.data_matvec_ordered(s, _system(rows, used, stride), p).numpy()
    want = _warp_walk(s.knn_idx.numpy(), s.pts_by_node.order.numpy(), s.pts_by_node.off.numpy(),
                      rows.float().numpy(), p.numpy(), used, stride)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ordered_data_matvec_matches_plain(mode):
    """The kernel's order against torch's (``data_matvec_plain``), in each
    row mode, with a node of more than 1 000 entries and every other of
    more than 32."""
    nrows, used, stride = MODES[mode]
    s, rows, p = _skewed(nrows, seed=6)
    sysm = _system(rows, used, stride)
    got = ts.data_matvec_ordered(s, sysm, p)
    ref = ts.data_matvec_plain(s, sysm, p)
    assert float((got - ref).abs().max()) <= TOL_MV * float(ref.abs().max())
    # the row mode leaves rows out
    if used is not None or stride > 1:
        assert not torch.equal(got, ts.data_matvec_ordered(s, _system(rows, None, 1), p))


def _check_heavy(lists):
    counts = (lists.off[1:] - lists.off[:-1]).numpy()
    heavy = lists.heavy.numpy()
    assert lists.heavy.dtype == torch.int64
    assert sorted(heavy.tolist()) == list(range(counts.shape[0]))  # a permutation
    keys = [(-int(counts[i]), int(i)) for i in heavy]  # by descending count, ties by index
    assert keys == sorted(keys)


def test_prepare_gives_the_heavy_first_order_and_int32_copies():
    """``prepare``'s node order (built where the solve runs kernel G's
    factored PCG) is a permutation by descending entry count, ties by
    index, and its int32 copies equal the int64 ids; a structure prepared
    for the dense solve carries the int32 copies (kernel N reads them) and
    no order, and kernel G's system builds it there; the sharded dense
    system's shards carry their own int32 ids."""
    direct = TCfg.small()
    assert direct.solver_linear != "pcg"
    factored = dataclasses.replace(direct, solver_linear="pcg")
    prob = cases.sphere_problem(2, 64, 900)
    s = ts.prepare(factored, prob[1], prob[3])
    _check_heavy(s.pts_by_node)
    counts = s.pts_by_node.off[1:] - s.pts_by_node.off[:-1]
    assert len(set(counts.tolist())) < counts.shape[0]  # ties exist and are ordered by index
    assert s.knn_idx32.dtype == torch.int32 and torch.equal(s.knn_idx32.long(), s.knn_idx)
    assert s.e_dst32.dtype == torch.int32 and torch.equal(s.e_dst32.long(), s.e_dst)
    assert s.edges_by_dst.heavy is None  # the edge lists need no order
    d = ts.prepare(direct, prob[1], prob[3])
    assert d.pts_by_node.heavy is None
    assert torch.equal(d.knn_idx32, s.knn_idx32) and torch.equal(d.e_dst32, s.e_dst32)
    n = d.pts_by_node.off.shape[0] - 1
    sys_d = ts.System(torch.zeros((d.p_can.shape[0], 1, 8, 6), dtype=torch.bfloat16),
                      ts.EdgeTerm(None, None, None, None, None, None), torch.zeros(6 * n))
    assert torch.equal(ts._kernel_system(d, sys_d).heavy, s.pts_by_node.heavy)
    mesh = sharded.make_mesh(3, devices=["cpu"] * 3)
    for sk in distributed_gn.shard_structure(s, mesh):
        assert sk.pts_by_node.heavy is None
        assert sk.knn_idx32.dtype == torch.int32 and torch.equal(sk.knn_idx32.long(), sk.knn_idx)


def test_heavy_order_ties_by_index():
    """Equal counts keep index order; the heaviest node comes first."""
    keys = torch.tensor([3, 1, 3, 0, 2, 1, 3, 1])
    lists = ts.node_lists(keys, 5, heavy=True)
    assert lists.heavy.tolist() == [1, 3, 0, 2, 4]
    assert ts.node_lists(keys, 5).heavy is None
