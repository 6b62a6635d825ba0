"""The port's warp-field options against the JAX package, on the CPU: the
adaptive node radius (``node_radius_adaptive``: ``_adaptive_radius`` at
frame 0 and at node insertion) and the removal of the net rigid motion
(``solver_remove_net_rigid``: ``remove_net_rigid``).

Inputs are made from a seed with numpy and handed to both packages.
Tolerances, each with its reason:
- the radius within TOL_RADIUS_ULPS (one float32 ulp) of the jitted JAX
  package's (its pipeline runs it jitted), and bit-equal on most nodes:
  XLA takes the expansion's three-term sums on the CPU as chains of fused
  multiply-adds, and so does the port (kernel E with ``__fmaf_rn``, its
  plain version with an exact float64 product rounded once more); the
  squared distances then agree bit for bit with the expression jitted on
  its own, but XLA's fusion of the whole function moves an occasional
  k-th squared distance by one ulp of itself (one node in 96 here), half
  an ulp of its root. Op by op JAX sums the squares without the fusion,
  which the expansion's cancellation turns into up to ~100 ulps of a
  radius;
- the net rigid removal within TOL_DQ of the jitted JAX package's unit
  dual quaternions: the centroids and the 3x3 H are float32 sums in two
  orders, and the port takes the SVD in float64 (kernel Q's precision)
  where JAX takes it in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import dualquat as jdq
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import warpfield as tw

TOL_DQ = 1e-6  # unit dual quaternions after the net rigid removal
TOL_RADIUS_ULPS = 1  # the adaptive radius against the jitted JAX package's

N = 96
ADAPT = dict(max_nodes=N, node_radius_adaptive=True)
JC = dataclasses.replace(JCfg.small(dims=32, rows=60, cols=80), **ADAPT)
TC = dataclasses.replace(TCfg.small(dims=32, rows=60, cols=80), **ADAPT)

j_radius = jax.jit(jw._adaptive_radius, static_argnums=(0, 4))
j_net_rigid = jax.jit(jw.remove_net_rigid, static_argnums=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_within_ulps(got, ref, ulps=TOL_RADIUS_ULPS):
    """Positive float32 arrays within ``ulps`` units in the last place."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert (got > 0).all() and (ref > 0).all()
    diff = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    assert diff.max() <= ulps, (diff.max(), int((diff > 0).sum()))


def _field(seed, frac_active=0.8, half_width=0.12, twist=0.02):
    """N nodes around z = 1 m, dense enough that the adaptive radius falls
    inside its clip, some inactive, with random transforms; as (JAX
    field, port field)."""
    rng = np.random.RandomState(seed)
    pos = (rng.uniform(-half_width, half_width, (N, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    act = rng.rand(N) < frac_active
    dq = np.asarray(jdq.from_twist(jnp.asarray(rng.randn(N, 3).astype(np.float32) * twist),
                                   jnp.asarray(rng.randn(N, 3).astype(np.float32) * twist * 0.2)))
    rad = np.full(N, JC.node_radius, np.float32)
    ls = rng.randint(0, 5, N).astype(np.int32)
    jfield = jw.WarpField(jnp.asarray(pos), jnp.asarray(dq), jnp.asarray(rad), jnp.asarray(act),
                          jnp.int32(act.sum()), jnp.asarray(ls))
    return jfield, tw.WarpField(*(_t(a) for a in jfield))


# ---------------------------------------------------------------- the adaptive radius


@pytest.mark.parametrize("self_ref", [True, False], ids=["self", "other"])
def test_adaptive_radius_matches_jax(self_ref):
    """Each node against the others (frame 0) or candidates against the
    field (insertion), inactive references 1e9 away: within one ulp of
    the jitted JAX package's, most radii inside the clip."""
    jfield, tfield = _field(0)
    rng = np.random.RandomState(1)
    q = np.asarray(jfield.positions) if self_ref else (
        rng.uniform(-0.15, 0.15, (200, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    ref = j_radius(JC, jnp.asarray(q), jfield.positions, jfield.active, self_ref)
    got = tw.adaptive_radius(TC, _t(q), tfield.positions, tfield.active, self_ref)
    _assert_within_ulps(got.numpy(), ref)
    inside = (got > TC.node_radius_min) & (got < TC.node_radius_max)
    assert float(inside.float().mean()) > 0.5
    # the inactive references count: with every node active the radii shrink
    all_on = tw.adaptive_radius(TC, _t(q), tfield.positions, torch.ones(N, dtype=torch.bool), self_ref)
    assert bool((all_on <= got).all()) and bool((all_on < got).any())


def test_adaptive_radius_tracks_density_as_jax():
    """The JAX package's own scene (tests/test_warpfield.py): six clustered
    and three spread-out nodes; the radii within one ulp of the jitted JAX
    package's, small in the cluster and large outside it."""
    changes = dict(node_radius_adaptive=True, node_sample_step=1, node_radius_min=0.01, node_radius_max=0.5,
                   node_radius_knn=2)
    jc, tc = (dataclasses.replace(c.small(), **changes) for c in (JCfg, TCfg))
    pts = np.array(
        [[0, 0, 1], [0.02, 0, 1], [0, 0.02, 1], [0.02, 0.02, 1], [0.01, 0.01, 1.02], [0.02, 0, 1.02],
         [0.4, 0.4, 1.4], [-0.4, 0.4, 1.4], [0.4, -0.4, 1.4]], np.float32)
    jf = jax.jit(lambda p, v: jw.init_from_cloud(jc, p, v))(jnp.asarray(pts), jnp.ones(9, bool))
    tf = tw.init_from_cloud(tc, _t(pts), torch.ones(9, dtype=torch.bool))
    for name in ("positions", "active", "count"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), err_msg=name)
    _assert_within_ulps(tf.radius.numpy(), jf.radius)
    pos, act, rad = tf.positions.numpy(), tf.active.numpy(), tf.radius.numpy()

    def radius_of(p):
        d = np.linalg.norm(pos - p, axis=-1)
        i = int(np.argmin(np.where(act, d, 1e9)))
        assert d[i] < 1e-5
        return rad[i]

    assert max(radius_of(p) for p in pts[:6]) < 0.05
    assert min(radius_of(p) for p in pts[6:]) > 0.2
    assert bool((tf.radius[~tf.active] == tc.node_radius).all())


def test_init_from_cloud_adaptive_matches_jax():
    """Frame 0's node sampling with the adaptive radius on a surface cloud
    (more candidates than slots, some invalid)."""
    rng = np.random.RandomState(2)
    m = 900
    pts = (rng.uniform(-0.15, 0.15, (m, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    valid = rng.rand(m) < 0.9
    pts[~valid] = np.nan
    jc, tc = (dataclasses.replace(c, node_sample_step=3) for c in (JC, TC))
    jf = jax.jit(lambda p, v: jw.init_from_cloud(jc, p, v))(jnp.asarray(pts), jnp.asarray(valid))
    tf = tw.init_from_cloud(tc, _t(pts), _t(valid))
    for name, a, b in zip(tw.WarpField._fields, jf, tf):
        if name == "radius":
            _assert_within_ulps(b.numpy(), a)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(tf.count) == N and len(set(tf.radius.tolist())) > N // 2


@pytest.mark.parametrize("case", ["free_slots", "full_retires"])
def test_insert_nodes_adaptive_matches_jax(case):
    """Node insertion with the adaptive radius: the new nodes' radii from
    the field's nodes after the retirement (full_retires frees slots in
    the same call), equal to the jitted JAX package's."""
    jfield, tfield = _field(3, frac_active=0.5 if case == "free_slots" else 1.0)
    rng = np.random.RandomState(4)
    # candidates over the +x half and beyond: the -x nodes lose their support
    cand = (rng.uniform([0.02, -0.2, -0.2], [0.35, 0.2, 0.2], (800, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
    cand[::13] = np.nan
    valid = ~np.isnan(cand[:, 0])
    fi = 70 if case == "full_retires" else 9
    jc, tc = (dataclasses.replace(c, node_coverage=0.02) for c in (JC, TC))
    jout = jax.jit(lambda f, c, v: jw.insert_nodes(jc, f, c, v, frame_idx=jnp.int32(fi)))(
        jfield, jnp.asarray(cand), jnp.asarray(valid))
    tout = tw.insert_nodes(tc, tfield, _t(cand), _t(valid), torch.tensor(fi, dtype=torch.int32))
    for name, a, b in zip(tw.WarpField._fields, jout, tout):
        a = np.asarray(a)
        if name == "dq":
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=0, err_msg=name)
        elif name == "radius":
            # a slot's radius is old + (new - old), as JAX's delta scatter
            np.testing.assert_allclose(b.numpy(), a, atol=2e-9, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    new = tout.active & (tout.positions != tfield.positions).any(-1)  # retired slots are refilled too
    assert int(new.sum()) > 0
    assert bool((tout.radius[new] != tc.node_radius).any())


# ---------------------------------------------------------------- the net rigid removal


def _moved(jfield, twist, noise, seed=5):
    """``jfield`` with every transform left-multiplied by the rigid motion
    exp(twist) and perturbed by ``noise`` (a per-node deformation)."""
    g = jdq.from_matrix(jse3.exp_twist(jnp.asarray(twist, jnp.float32)))
    dq = np.asarray(jdq.normalize(jdq.mul(g[None], jfield.dq)))
    dq = dq + noise * np.random.RandomState(seed).randn(*dq.shape).astype(np.float32)
    return jfield._replace(dq=jnp.asarray(dq))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_remove_net_rigid_matches_jax(alpha):
    jfield, tfield = _field(6)
    jnew = _moved(jfield, [0.01, -0.02, 0.015, 0.02, 0.01, -0.03], 1e-3)
    tnew = tfield._replace(dq=_t(jnew.dq))
    ref = np.asarray(j_net_rigid(jfield, jnew, alpha).dq)
    got = tw.remove_net_rigid(tfield, tnew, alpha).dq.numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_DQ, rtol=0)
    # the removal moved the active nodes, left the inactive ones
    act = tfield.active.numpy()
    assert np.abs(got - np.asarray(jnew.dq))[act].max() > 1e-3
    np.testing.assert_array_equal(got[~act], np.asarray(jnew.dq)[~act])


def test_remove_net_rigid_near_identity_with_close_singular_values():
    """The static camera's case: a net motion of ~1e-5 and nodes on the
    axes and diagonals of shells (an isotropic second moment: N = 96 is 14
    directions on 6 radii plus 12 spare nodes at the centre), so H is a
    multiple of the identity but for the motion and its singular values
    nearly equal; the rotation R is still unique and the port's within
    TOL_DQ of JAX's."""
    axes = [[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0]]
    dirs = np.array(axes + [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    shells = np.concatenate([r * dirs for r in (0.05, 0.08, 0.1, 0.12, 0.15, 0.2)] + [np.zeros((N - 84, 3))])
    pos = (shells + [0.0, 0.0, 1.0]).astype(np.float32)
    jfield, tfield = _field(8, frac_active=1.0, twist=0.0)
    jfield = jfield._replace(positions=jnp.asarray(pos))
    tfield = tfield._replace(positions=_t(pos))
    jnew = _moved(jfield, [1e-5, -2e-5, 1e-5, 3e-5, -1e-5, 2e-5], 1e-6)
    ref = np.asarray(j_net_rigid(jfield, jnew, 1.0).dq)
    got = tw.remove_net_rigid(tfield, tfield._replace(dq=_t(jnew.dq)), 1.0).dq.numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_DQ, rtol=0)


def test_remove_net_rigid_needs_three_active_nodes():
    jfield, tfield = _field(9)
    act = np.zeros(N, bool)
    act[:2] = True
    jfield = jfield._replace(active=jnp.asarray(act))
    tfield = tfield._replace(active=_t(act))
    jnew = _moved(jfield, [0.01, 0.0, 0.0, 0.02, 0.0, 0.0], 1e-3)
    ref = np.asarray(j_net_rigid(jfield, jnew, 1.0).dq)
    got = tw.remove_net_rigid(tfield, tfield._replace(dq=_t(jnew.dq)), 1.0).dq.numpy()
    np.testing.assert_array_equal(ref, np.asarray(jnew.dq))
    np.testing.assert_array_equal(got, ref)
