"""Kernel G's one-launch edge term and kernel E's one-launch mutual-nearest
pass (``csrc/pcg.cu``, ``csrc/knn_blend.cu``) in their own order on the
CPU.

Edge term. The kernel gives a block eight nodes; the block's jobs are
the nodes' source edges (e = node * kc + c), then the nodes' destination
edges in ``e_order`` (evaluated again by this block), taken 85 a round;
thread (node, entry) adds the round's terms of its node to its one sum in
job order. ``split_sums`` transcribes that split in numpy float32, with
the kernel's per-edge terms (each block entry (x0p y0q + x1p y1q) + x2p
y2q of the three weighted Jacobian rows, each gradient entry of the rows
and the weighted residual), and is held bit for bit against a node's
terms added one at a time in list order (the three-launch kernel's walk):
at the kernel's split and at splits whose rounds cut a node's lists. The
per-edge terms come from the port's plain ``edge_residual_and_jac``. The
sums, the blocks and the cost (``warp_solver.sum_ordered``, the kernel's
cost order) are held within TOL_EDGE of the port's ``edge_term_plain`` and
of the JAX package's jitted ``edge_residual_and_jac``, ``edge_blocks``
and ``edge_jtr``. Every case has invalid edges (inactive endpoints) and a
node with no incoming edge (moved away from the others); the Huber delta
sits above every edge's residual norm, at the median, and exactly at one
edge's norm.

Mutual nearest. The kernel takes each node's minimum over the
candidates with atomicMin on the bits of the clamped float; a minimum is exact in any order, so its outputs equal the plain
version's bit for bit on the card. Here the plain version is held bit for
bit against the JAX package's jitted ``_mutual_nearest`` on
``chip_smoke.mutual_case``'s adversarial cases (the same the card holds
the kernel to), whose coordinates lie on a 1/256 grid: every product and
sum of the expansion is exact there, so XLA's dot product and the port's
written-out sums agree, and what is held is the semantics (inactive nodes'
1e9, NaN candidates, no valid candidate, no candidate, ties).

~20 s on one process (a few small JAX compiles).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from chip_smoke import MUTUAL_CASES, mutual_case
from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

TOL_EDGE = 1e-5  # relative to the largest entry: two Jacobians (closed form / jacrev) and two sum orders
N, P = 96, 600
KERNEL_SPLIT = (8, 85)  # edge_term_kernel's kEdgeNodes, kEdgeSlots
SPLITS = (KERNEL_SPLIT, (4, 40), (3, 7))
DELTAS = ("above", "median", "at")


def _rel(got, ref):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _problem():
    """(JAX field, port field, JAX inputs, port inputs): the sphere problem
    with a fifth of the nodes inactive and node 0 moved 0.5 m away, so
    that no node lists it among its nearest."""
    jf, tf, ji, ti = cases.sphere_problem(4, N, P, active_frac=0.8)
    pos = np.array(jf.positions)
    pos[0] += [0.5, 0.0, 0.0]
    active = np.array(jf.active)
    active[0] = True
    jf = jf._replace(positions=jnp.asarray(pos), active=jnp.asarray(active), count=jnp.int32(active.sum()))
    tf = tf._replace(positions=torch.from_numpy(pos), active=torch.from_numpy(active),
                     count=torch.tensor(int(active.sum()), dtype=torch.int32))
    return jf, tf, ji, ti


def _norms(cfg, s, dq):
    """Each edge's unweighted residual norm, as the plain version takes it."""
    zero = torch.zeros((s.e_src.shape[0], 6))
    return ts._norm3(torch.func.vmap(ts._edge_residual)(zero, dq[s.e_src], zero, dq[s.e_dst], s.v_dst))


@functools.lru_cache(maxsize=None)
def _case(delta):
    """(port config, port structure, JAX config, JAX structure), the
    delta above every valid edge's residual norm, at their median, or
    equal to one of them."""
    jf, tf, ji, ti = _problem()
    tc = TCfg.small()
    s = ts.prepare(tc, tf, ti)
    ren = _norms(tc, s, tf.dq)[s.e_valid]
    d = {"above": float(ren.max()) * 2.0, "median": float(ren.median()), "at": float(ren[len(ren) // 3])}[delta]
    tc = dataclasses.replace(tc, solver_huber_delta=d)
    jc = dataclasses.replace(JCfg.small(), solver_huber_delta=d)
    return tc, ts.prepare(tc, tf, ti), jc, js.prepare(jc, jf, ji, True)


def kernel_terms(rows_i, rows_j, rw):
    """The kernel's per-edge blocks h_ii, h_jj, h_ij (E, 36) and gradients
    g_i, g_j (E, 6) from the weighted rows (E, 3, 6) and residual (E, 3),
    in numpy float32: (x0p y0q + x1p y1q) + x2p y2q."""
    def jtj(x, y):
        return ((x[:, 0, :, None] * y[:, 0, None, :] + x[:, 1, :, None] * y[:, 1, None, :])
                + x[:, 2, :, None] * y[:, 2, None, :]).reshape(-1, 36)

    def jtr(x):
        return (x[:, 0] * rw[:, 0, None] + x[:, 1] * rw[:, 1, None]) + x[:, 2] * rw[:, 2, None]

    return jtj(rows_i, rows_i), jtj(rows_j, rows_j), jtj(rows_i, rows_j), jtr(rows_i), jtr(rows_j)


def split_sums(src_terms, dst_terms, order, off, n, kc, nodes, slots):
    """(N, 42) as edge_term_kernel sums them at ``nodes`` a block and
    ``slots`` jobs a round: the 36 diagonal entries, then the 6 of Jᵀr."""
    out = np.zeros((n, 42), np.float32)
    for n0 in range(0, n, nodes):
        nb = min(nodes, n - n0)
        ns, q0 = nb * kc, off[n0]
        jobs = ns + (off[n0 + nb] - q0)
        acc = np.zeros((nb, 42), np.float32)
        for j0 in range(0, jobs, slots):
            m = min(slots, jobs - j0)
            for k in range(nb):
                for j in range(max(k * kc, j0), min(k * kc + kc, j0 + m)):
                    acc[k] = acc[k] + src_terms[n0 * kc + j]
                for j in range(max(ns + off[n0 + k] - q0, j0), min(ns + off[n0 + k + 1] - q0, j0 + m)):
                    acc[k] = acc[k] + dst_terms[order[q0 + j - ns]]
        out[n0:n0 + nb] = acc
    return out


def list_walk(src_terms, dst_terms, order, off, n, kc):
    """(N, 42): each node's source edges, then its destination edges in
    list order, added one at a time from zero."""
    out = np.zeros((n, 42), np.float32)
    for nd in range(n):
        acc = np.zeros(42, np.float32)
        for c in range(kc):
            acc = acc + src_terms[nd * kc + c]
        for q in range(off[nd], off[nd + 1]):
            acc = acc + dst_terms[order[q]]
        out[nd] = acc
    return out


@functools.lru_cache(maxsize=None)
def _split_inputs(delta):
    """(source-side terms (E, 42), destination-side terms (E, 42), the
    kernel's per-edge blocks and gradients, e_order, e_off, kc, per-edge
    costs) of a case."""
    tc, s, _, _ = _case(delta)
    _, tf, _, _ = _problem()
    re, je_i, je_j, _ = ts.edge_residual_and_jac(tc, s, tf.dq)
    h_ii, h_jj, h_ij, g_i, g_j = kernel_terms(je_i.numpy(), je_j.numpy(), re.numpy())
    order, off = s.edges_by_dst.order.numpy().astype(np.int64), s.edges_by_dst.off.numpy().astype(np.int64)
    la = tc.solver_arap_weight * s.alpha
    cost_e = (ts.huber_rho(_norms(tc, s, tf.dq), tc.solver_huber_delta) * s.e_valid) * la
    return (np.concatenate([h_ii, g_i], 1), np.concatenate([h_jj, g_j], 1), (h_ii, h_jj, h_ij, g_i, g_j),
            order, off, s.e_src.shape[0] // N, cost_e)


def test_cases_cover_the_edges():
    """Invalid edges, a node with no incoming edge, and residual norms on
    both sides of (and, for "at", equal to) the delta."""
    for delta in DELTAS:
        tc, s, _, js_ = _case(delta)
        _, tf, _, _ = _problem()
        for name in ("e_src", "e_dst", "e_valid"):
            np.testing.assert_array_equal(getattr(s, name).numpy(), np.asarray(getattr(js_, name)))
        off = s.edges_by_dst.off
        assert int(off[1] - off[0]) == 0  # node 0: no incoming edge
        assert 0 < int((~s.e_valid).sum()) < s.e_valid.shape[0]
        ren = _norms(tc, s, tf.dq)[s.e_valid]
        above = int((ren > tc.solver_huber_delta).sum())
        if delta == "above":
            assert above == 0
        else:
            assert 0 < above < ren.shape[0]
        if delta == "at":
            assert bool((ren == np.float32(tc.solver_huber_delta)).any())


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("delta", DELTAS)
def test_split_is_the_list_walk(delta, split):
    """The one launch's work split sums each node's entries in the
    three-launch kernel's order, bit for bit (zeros' signs too)."""
    src, dst, _, order, off, kc, _ = _split_inputs(delta)
    got = split_sums(src, dst, order, off, N, kc, *split)
    ref = list_walk(src, dst, order, off, N, kc)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("delta", DELTAS)
def test_split_matches_plain_and_jax(delta):
    """The split's sums, the kernel's per-edge blocks and its cost order
    within TOL_EDGE of the plain version and of the JAX package's jitted
    edge terms."""
    tc, s, jc, js_ = _case(delta)
    jf, tf, _, _ = _problem()
    src, dst, (h_ii, h_jj, h_ij, _, _), order, off, kc, cost_e = _split_inputs(delta)
    sums = split_sums(src, dst, order, off, N, kc, *KERNEL_SPLIT)
    diag, jtr = sums[:, :36].reshape(N, 6, 6), sums[:, 36:].reshape(-1)
    cost = ts.sum_ordered(cost_e)
    plain = ts.edge_term_plain(tc, s, tf.dq)
    re, je_i, je_j, jcost = jax.jit(js.edge_residual_and_jac, static_argnums=0)(jc, js_, jf.dq)
    eb = jax.jit(js.edge_blocks, static_argnums=3)(js_, je_i, je_j, N)
    jjtr = jax.jit(js.edge_jtr, static_argnums=4)(js_, je_i, je_j, re, N)
    for got, pl, jx in ((h_ii, plain.h_ii, eb["h_ii"]), (h_jj, plain.h_jj, eb["h_jj"]),
                        (h_ij, plain.h_ij, eb["h_ij"]), (diag, plain.diag, eb["diag_blocks"]),
                        (jtr, plain.jtr, jjtr), (cost.numpy(), plain.cost, jcost)):
        got = np.asarray(got).reshape(np.shape(jx))
        assert _rel(got, pl.numpy().reshape(np.shape(jx))) <= TOL_EDGE
        assert _rel(got, jx) <= TOL_EDGE


_jmutual = jax.jit(jw._mutual_nearest)


def _fields(case):
    pos, act = case["positions"], case["active"]
    n = pos.shape[0]
    jf = jw.WarpField(jnp.asarray(pos), jnp.zeros((n, 8), jnp.float32), jnp.full((n,), 0.05, jnp.float32),
                      jnp.asarray(act), jnp.int32(act.sum()), jnp.zeros((n,), jnp.int32))
    return jf, tw.WarpField(*(torch.from_numpy(np.array(a)) for a in jf))


@pytest.mark.parametrize("name", MUTUAL_CASES)
def test_mutual_nearest_plain_is_jax(name):
    """``_mutual_nearest_plain`` bit-equal to the jitted JAX
    ``_mutual_nearest`` on the adversarial cases, and the kernel's
    semantics: a node with no valid candidate reads 1e9, both outputs are
    clamped at 0."""
    case = mutual_case(name, 300, 96)
    jf, tf = _fields(case)
    jc, jn = _jmutual(jf, jnp.asarray(case["cand"]), jnp.asarray(case["valid"]))
    tc, tn = tw._mutual_nearest_plain(tf, torch.from_numpy(case["cand"]), torch.from_numpy(case["valid"]))
    np.testing.assert_array_equal(tc.numpy().view(np.int32), np.asarray(jc).view(np.int32))
    np.testing.assert_array_equal(tn.numpy().view(np.int32), np.asarray(jn).view(np.int32))
    assert tc.shape == (case["cand"].shape[0],) and bool((tc >= 0).all()) and bool((tn >= 0).all())
    if not case["valid"].any():
        assert bool((tn == np.float32(1e9)).all())
