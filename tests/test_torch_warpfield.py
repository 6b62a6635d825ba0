"""The port's quaternion algebra, warp field (KNN, blend, warps, node
insertion) and coarse field against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
squared distances are the same expansion in both, but XLA and PyTorch may
round the 3-term dot product differently, so a query whose k-th and
(k+1)-th nodes are within an ulp of a tie may list them in the other
order; random queries have none, and the coarse grid's 33^3-style lattice
is held on the queries where both packages list the same neighbours.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import dualquat as jdq
from dynamicfusion_tpu.core import quat as jq
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.ops import fusion as jf
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu.solvers import warp_solver as jsolver
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.core import dualquat as tdq
from dynamicfusion_tpu_torch.core import quat as tq
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.ops import fusion as tf
from dynamicfusion_tpu_torch.solvers import warp_solver as tsolver

TOL_QUAT = 1e-6    # quaternion / dual-quaternion algebra, float32 ulps of O(1) values
TOL_D2 = 1e-6      # squared distances (m^2)
TOL_FIELD = 1e-5   # blended dual quaternions, quality, warped points (m)
TOL_TIE_FRAC = 1e-3  # lattice queries whose neighbour lists differ at a near tie
# Gaussian weights exp(-d^2 / (2 r^2)) at r = 5 cm amplify a d^2 difference
# of 1e-7 m^2 (the two packages' 3-term dot products) 200 times
TOL_W_REL = 1e-4

N = 96
JC = dataclasses.replace(JCfg.small(dims=32, rows=60, cols=80), max_nodes=N)
TC = dataclasses.replace(TCfg.small(dims=32, rows=60, cols=80), max_nodes=N)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rng(seed=0):
    return np.random.RandomState(seed)


def _field(seed=0, frac_active=0.8, twist=0.05):
    """A field of N nodes around z = 1 m (volume frame of small()), some
    inactive, with random node transforms; as (JAX field, port field)."""
    rng = _rng(seed)
    pos = (rng.uniform(-0.3, 0.3, (N, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    act = rng.rand(N) < frac_active
    dq = np.asarray(jdq.from_twist(jnp.asarray(rng.randn(N, 3).astype(np.float32) * twist),
                                   jnp.asarray(rng.randn(N, 3).astype(np.float32) * twist * 0.2)))
    rad = np.full(N, 0.05, np.float32)
    ls = rng.randint(0, 5, N).astype(np.int32)
    jfield = jw.WarpField(jnp.asarray(pos), jnp.asarray(dq), jnp.asarray(rad), jnp.asarray(act),
                          jnp.int32(act.sum()), jnp.asarray(ls))
    return jfield, tw.WarpField(*(_t(a) for a in jfield))


def _queries(rng, m, nan_every=0):
    q = (rng.uniform(-0.35, 0.35, (m, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    if nan_every:
        q[::nan_every] = np.nan
    return q


# ---------------------------------------------------------------- quaternions


def _quats(rng, m=64):
    q = rng.randn(m, 4).astype(np.float32)
    q[0] = 0.0
    q[1] = [1e-7, 0.0, 0.0, 0.0]
    return q


def _unit(rng, m=64):
    q = rng.randn(m, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


QUAT_CASES = {
    "mul": lambda m, r: (m.mul, (_quats(r), _quats(r))),
    "conj": lambda m, r: (m.conj, (_quats(r),)),
    "normalize": lambda m, r: (m.normalize, (_quats(r),)),
    "dot": lambda m, r: (m.dot, (_quats(r), _quats(r))),
    "exp_pure": lambda m, r: (m.exp_pure, (np.concatenate([np.zeros((2, 3)), [[1e-7, 0, 0]], r.randn(61, 3)]).astype(np.float32),)),
    "from_rotvec": lambda m, r: (m.from_rotvec, (np.concatenate([np.zeros((1, 3)), r.randn(63, 3)]).astype(np.float32),)),
    "to_rotvec": lambda m, r: (m.to_rotvec, (_unit(r),)),
    "rotate": lambda m, r: (m.rotate, (_unit(r), r.randn(64, 3).astype(np.float32))),
    "to_matrix": lambda m, r: (m.to_matrix, (_unit(r),)),
    "from_matrix": lambda m, r: (m.from_matrix, (np.asarray(jq.to_matrix(jnp.asarray(_unit(r)))),)),
    "slerp": lambda m, r: (lambda a, b: m.slerp(a, b, 0.3), (_unit(r), _unit(r))),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_matches_jax(name):
    jfn, args = QUAT_CASES[name](jq, _rng(1))
    tfn, _ = QUAT_CASES[name](tq, _rng(1))
    ref = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = tfn(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_QUAT, rtol=TOL_QUAT)


def _dqs(rng, m=64):
    return np.asarray(jdq.from_twist(jnp.asarray(rng.randn(m, 3).astype(np.float32) * 0.5),
                                     jnp.asarray(rng.randn(m, 3).astype(np.float32))))


DQ_CASES = {
    "from_rot_trans": lambda m, r: (m.from_rot_trans, (_unit(r), r.randn(64, 3).astype(np.float32))),
    "from_twist": lambda m, r: (m.from_twist, (r.randn(64, 3).astype(np.float32), r.randn(64, 3).astype(np.float32))),
    "translation": lambda m, r: (m.translation, (_dqs(r),)),
    "mul": lambda m, r: (m.mul, (_dqs(r), _dqs(r))),
    "conj": lambda m, r: (m.conj, (_dqs(r),)),
    "normalize": lambda m, r: (m.normalize, (np.concatenate([np.zeros((1, 8)), r.randn(63, 8)]).astype(np.float32),)),
    "transform": lambda m, r: (m.transform, (_dqs(r), r.randn(64, 3).astype(np.float32))),
    "rotate": lambda m, r: (m.rotate, (_dqs(r), r.randn(64, 3).astype(np.float32))),
    "blend": lambda m, r: (m.blend, (r.rand(16, 8).astype(np.float32),
                                     _dqs(r, 128).reshape(16, 8, 8) * np.where(r.rand(16, 8, 1) < 0.3, -1, 1).astype(np.float32))),
    "to_matrix": lambda m, r: (m.to_matrix, (_dqs(r),)),
    "from_matrix": lambda m, r: (m.from_matrix, (np.asarray(jdq.to_matrix(jnp.asarray(_dqs(r)))),)),
}


@pytest.mark.parametrize("name", sorted(DQ_CASES))
def test_dualquat_matches_jax(name):
    jfn, args = DQ_CASES[name](jdq, _rng(2))
    tfn, _ = DQ_CASES[name](tdq, _rng(2))
    ref = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = tfn(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_QUAT, rtol=TOL_QUAT)


def test_exp_pure_and_normalize_differentiate_at_zero():
    """The solver linearizes exactly at 0: the where-guarded forms give
    finite derivatives there, and the same as JAX's."""
    import jax

    z = np.zeros(3, np.float32)
    jj = np.asarray(jax.jacrev(jq.exp_pure)(jnp.asarray(z)))
    tj = torch.func.jacrev(tq.exp_pure)(_t(z)).numpy()
    np.testing.assert_allclose(tj, jj, atol=TOL_QUAT)
    z4 = np.zeros(4, np.float32)
    tn = torch.func.jacrev(tq.normalize)(_t(z4)).numpy()
    assert np.isfinite(tn).all()
    np.testing.assert_allclose(tn, np.asarray(jax.jacrev(jq.normalize)(jnp.asarray(z4))), atol=TOL_QUAT)


# ---------------------------------------------------------------- KNN, blend, warps


@pytest.mark.parametrize("k", [8, 5])
def test_knn_matches_jax(k):
    jfield, tfield = _field(0)
    q = _queries(_rng(3), 700, nan_every=9)
    jd2, jidx = jw.knn(jfield, jnp.asarray(q), k)
    td2, tidx = tw.knn(tfield, _t(q), k)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), atol=TOL_D2, rtol=0)
    jwts = jw.weights_from_dist2(jfield, jd2, jidx)
    twts = tw.weights_from_dist2(tfield.radius, td2, tidx)
    np.testing.assert_allclose(twts.numpy(), np.asarray(jwts), atol=1e-30, rtol=TOL_W_REL)


def test_warp_points_and_warp_dq_at_match_jax():
    jfield, tfield = _field(1)
    rng = _rng(4)
    q = _queries(rng, 500, nan_every=7)
    n = rng.randn(500, 3).astype(np.float32)
    n[::11] = np.nan
    jp, jn = jw.warp_points(jfield, jnp.asarray(q), jnp.asarray(n))
    tp, tn = tw.warp_points(tfield, _t(q), _t(n))
    for a, b in ((jp, tp), (jn, tn)):
        a = np.asarray(a)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b.numpy()))
        np.testing.assert_allclose(b.numpy(), a, atol=TOL_FIELD, rtol=0)
    qq = np.nan_to_num(q)
    np.testing.assert_allclose(tw.warp_dq_at(tfield, _t(qq)).numpy(), np.asarray(jw.warp_dq_at(jfield, jnp.asarray(qq))),
                               atol=TOL_FIELD, rtol=0)


def test_coarse_field_matches_jax():
    jfield, tfield = _field(2)
    jdq_grid, jq_grid = jf.coarse_field(JC, jfield)
    cf = tf.coarse_field(TC, tfield)
    pts = tf.coarse_corner_points(TC).numpy()
    np.testing.assert_array_equal(pts, np.asarray(jf._coarse_corner_points(JC)))
    same = (np.asarray(jw.knn(jfield, jnp.asarray(pts), JC.knn_k)[1]) == tw.knn(tfield, _t(pts), TC.knn_k)[1].numpy()).all(1)
    assert (~same).mean() <= TOL_TIE_FRAC
    dc = cf.dq.shape[0]
    for j, t, w in ((jdq_grid, cf.dq, 8), (jq_grid, cf.q, 1), (jf.warp_coarse_grid(JC, jfield, jdq_grid), cf.warped, 3)):
        a = np.asarray(j).reshape(dc ** 3, -1)[same]
        b = t.numpy().reshape(dc ** 3, -1)[same]
        np.testing.assert_allclose(b, a, atol=TOL_FIELD, rtol=0)


def test_warp_points_trilinear_matches_jax():
    jfield, _ = _field(3)
    jdq_grid, _ = jf.coarse_field(JC, jfield)
    rng = _rng(5)
    q = _queries(rng, 600, nan_every=13)
    n = rng.randn(600, 3).astype(np.float32)
    jp, jn = jf.warp_points_trilinear(JC, jdq_grid, jnp.asarray(q), jnp.asarray(n))
    tp, tn = tf.warp_points_trilinear(TC, _t(jdq_grid), _t(q), _t(n))
    for a, b in ((jp, tp), (jn, tn)):
        a = np.asarray(a)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b.numpy()))
        np.testing.assert_allclose(b.numpy(), a, atol=TOL_FIELD, rtol=0)


def test_mutual_nearest_matches_jax():
    jfield, tfield = _field(4)
    rng = _rng(6)
    c = _queries(rng, 900, nan_every=5)
    valid = ~np.isnan(c[:, 0]) & (rng.rand(900) < 0.7)
    jc, jn = jw._mutual_nearest(jfield, jnp.asarray(c), jnp.asarray(valid))
    tc, tn = tw.mutual_nearest(tfield, _t(c), _t(valid))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL_D2, rtol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=TOL_D2, rtol=1e-7)
    np.testing.assert_allclose(tw.nearest_dist2(tfield, _t(c)).numpy(), np.asarray(jw.nearest_dist2(jfield, jnp.asarray(c))),
                               atol=TOL_D2, rtol=0)


def test_build_edges_matches_jax():
    jfield, tfield = _field(5)
    for a, b in zip(jsolver.build_edges(jfield), tsolver.build_edges(tfield)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------- insertion and lifecycle


@pytest.mark.parametrize(
    "case", ["free_slots", "full_no_retire", "full_retires", "holes"],
)
def test_insert_nodes_matches_jax(case):
    """Free slots: uncovered candidates decimated per coverage cell fill
    them farthest first. Full: only the lifecycle runs, and nodes stale for
    more than node_retire_after frames retire; their slots are refilled in
    the same call. Holes: free slots scattered through the table."""
    frac = {"free_slots": 0.5, "full_no_retire": 1.0, "full_retires": 1.0, "holes": 0.85}[case]
    jfield, tfield = _field(6, frac_active=frac)
    rng = _rng(7)
    cand = _queries(rng, 1500, nan_every=17) * np.array([1.6, 1.6, 1.0], np.float32)
    valid = ~np.isnan(cand[:, 0])
    fi = {"full_retires": 70}.get(case, 9)
    jout = jw.insert_nodes(JC, jfield, jnp.asarray(cand), jnp.asarray(valid), frame_idx=jnp.int32(fi))
    tout = tw.insert_nodes(TC, tfield, _t(cand), _t(valid), torch.tensor(fi, dtype=torch.int32))
    for name, a, b in zip(tw.WarpField._fields, jout, tout):
        a = np.asarray(a)
        if a.dtype == np.float32:
            np.testing.assert_allclose(b.numpy(), a, atol=TOL_FIELD, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    grew = int(tout.count) - int(tfield.count)
    if case in ("free_slots", "holes", "full_retires"):
        assert grew != 0 or case == "full_retires"
    else:
        assert grew == 0


def test_interop_carries_the_warp_field():
    js = jkinfu.init_state(JC)
    jfield, _ = _field(8)
    js = js._replace(warp=jfield)
    ts = interop.state_from_numpy(jax_np(js), "cpu")
    for a, b in zip(jfield, ts.warp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = interop.state_to_numpy(ts)["warp"]
    for name, a in zip(tw.WarpField._fields, jfield):
        np.testing.assert_array_equal(back[name], np.asarray(a))
        assert back[name].dtype == np.asarray(a).dtype


def jax_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)
