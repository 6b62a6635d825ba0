"""Parity of the port's dense fusion (kernels F1 and F2's plain versions on
the CPU) with the JAX package's ``integrate_mode="dense"`` branches: the
rigid integrate (``ops/tsdf.py:214-256``) over two frames, at an offset
pose, on a volume that already holds a surface, gated off; the non-rigid
integrate (``ops/fusion.py:263-322``) with the same warp field's coarse
corners handed to both packages, with and without the incidence
confidence, with the phase split, and at a coarse stride whose
prolongation weights do not multiply exactly. Inputs are made with numpy
from seeds (depth rendered once) and handed to both packages.

Tolerances: codes within 1 LSB (a division may round apart by an ulp
between the libraries), weights equal (the update masks agree on every
voxel); the prolongation equal to JAX's einsums bit for bit."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import dualquat as jdq
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.models import volume as jvolume
from dynamicfusion_tpu.models import warpfield as jwarp
from dynamicfusion_tpu.models.volume import TsdfVolume as JVol
from dynamicfusion_tpu.ops import fusion as jfusion
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu.ops import tsdf as jtsdf
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models.volume import TsdfVolume as TVol
from dynamicfusion_tpu_torch.ops import fusion as tfusion
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf

# A process's first torch.sqrt runs on one thread: MKL's vectorized sqrt,
# which CPU torch calls, has returned one thread's chunk at ~12 bits when
# that first call ran on several threads at once
torch.sqrt(torch.ones(1))

KW = dict(integrate_mode="dense")
JC = dataclasses.replace(JCfg.small(dims=64, rows=120, cols=160), **KW)
TC = dataclasses.replace(TCfg.small(dims=64, rows=120, cols=160), **KW)
TARGET = (0.0, 0.0, 0.9)
SCENE = dict(
    spheres=[
        dict(center=(0.0, 0.0, 0.9), radius=0.2),
        dict(center=(0.25, 0.15, 1.0), radius=0.12),
        dict(center=(-0.22, 0.12, 0.85), radius=0.1),
        dict(center=(0.1, -0.2, 0.95), radius=0.1),
    ],
    plane_z=1.2,
)
MAX_LSB = 1
# the offset pose of tests/test_bricks.py (a twist of the camera)
TWIST = (0.03, -0.02, 0.01, 0.02, 0.01, -0.015)


@functools.lru_cache(maxsize=None)
def _depth(angle):
    return synthetic.scene_depth(JC.intr, JC.rows, JC.cols, synthetic.orbit_pose(angle, target=TARGET), **SCENE)


def _dists(angle):
    return np.array(jpre.compute_dists(JC.intr, jnp.asarray(_depth(angle))))


def _vol2cam(pose):
    return np.array(jse3.compose(jse3.inverse(jnp.asarray(pose)), jkinfu._vol_pose(JC)))


def _tvol(np_vol):
    return TVol(torch.from_numpy(np_vol[0].copy()), torch.from_numpy(np_vol[1].copy()))


def _np_vol(v):
    return np.array(v.tsdf), np.array(v.weight)


def _assert_close(jv, tv):
    """Codes within MAX_LSB, weights equal (the update masks agree)."""
    jt, jw = jv
    dt = np.abs(jt.astype(np.int64) - tv.tsdf.numpy().astype(np.int64))
    assert dt.max() <= MAX_LSB
    np.testing.assert_array_equal(jw, tv.weight.numpy())


def _empty():
    return np.zeros((64,) * 3, np.int16), np.zeros((64,) * 3, np.uint16)


@pytest.fixture(scope="module")
def surface_vol():
    """A JAX dense volume after one frame of the orbit, as numpy."""
    v = jkinfu.init_state(JC).vol
    v = jtsdf.integrate(JC, v, jnp.asarray(_dists(0.0)), jnp.asarray(_vol2cam(synthetic.orbit_pose(0.0, target=TARGET))),
                        JC.intr)
    return _np_vol(v)


def _rigid_both(vol, dists, vol2cam, ok=True):
    jv = jtsdf.integrate(JC, JVol(jnp.asarray(vol[0]), jnp.asarray(vol[1])), jnp.asarray(dists),
                         jnp.asarray(vol2cam), JC.intr, with_counts=True)
    tv = _tvol(vol)
    counts = ttsdf.integrate(TC, tv, torch.from_numpy(dists), torch.from_numpy(vol2cam), TC.intr,
                             ok=torch.tensor(ok))
    assert counts.dtype == torch.int32 and counts.tolist() == [0, 0, 0]
    np.testing.assert_array_equal(np.asarray(jv[1]), counts.numpy())
    return _np_vol(jv[0]), tv


def test_dense_integrate_two_frames():
    """The same frame twice from an empty volume at the identity camera
    (tests/test_bricks.py's first case): the second accumulates."""
    dists = _dists(0.0)
    vol2cam = _vol2cam(np.eye(4, dtype=np.float32))
    vol = _empty()
    for _ in range(2):
        jv, tv = _rigid_both(vol, dists, vol2cam)
        _assert_close(jv, tv)
        vol = jv
    assert int(vol[1].max()) == 2 * 512  # weight 2 where both frames saw the voxel


def test_dense_integrate_offset_pose(surface_vol):
    """An offset camera (a twist) onto a volume that holds a surface."""
    pose = np.array(jse3.exp_twist(jnp.asarray(TWIST)))
    jv, tv = _rigid_both(surface_vol, _dists(0.03), _vol2cam(pose))
    _assert_close(jv, tv)
    assert (jv[1] != surface_vol[1]).mean() > 0.01


def test_dense_integrate_orbit_frame(surface_vol):
    """The next orbit frame into the volume of the first (running average
    of observed voxels, weights > 1)."""
    pose = synthetic.orbit_pose(0.04, target=TARGET)
    jv, tv = _rigid_both(surface_vol, _dists(0.04), _vol2cam(pose))
    _assert_close(jv, tv)
    assert int(jv[1].max()) == 2 * 512


def test_dense_integrate_gated_off(surface_vol):
    """``ok`` False leaves the volume as it was (no host sync needed)."""
    tv = _tvol(surface_vol)
    counts = ttsdf.integrate(TC, tv, torch.from_numpy(_dists(0.04)),
                             torch.from_numpy(_vol2cam(synthetic.orbit_pose(0.04, target=TARGET))), TC.intr,
                             ok=torch.zeros((), dtype=torch.bool))
    assert counts.tolist() == [0, 0, 0]
    np.testing.assert_array_equal(tv.tsdf.numpy(), surface_vol[0])
    np.testing.assert_array_equal(tv.weight.numpy(), surface_vol[1])


# ---------------------------------------------------------------- non-rigid


def _field(cfg, seed=1):
    """A non-trivial warp field over the visible surface (the construction
    of tests/test_bricks.py's ``_warped_field``)."""
    rng = np.random.RandomState(seed)
    n = 64
    pos = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(0.6, 1.1, n)
    r = jnp.asarray(rng.uniform(-0.05, 0.05, (n, 3)), jnp.float32)
    t = jnp.asarray(rng.uniform(-0.02, 0.02, (n, 3)), jnp.float32)
    return jwarp.WarpField(
        positions=jnp.asarray(pos), dq=jdq.from_twist(r, t), radius=jnp.full((n,), 0.08, jnp.float32),
        active=jnp.ones((n,), bool), count=jnp.asarray(n, jnp.int32),
    )


def _coarse(cfg, field):
    """JAX's coarse field (dq, q) and warped corners, and the port's
    CoarseField of the same arrays."""
    dq, q = jfusion.coarse_field(cfg, field)
    warped = jfusion.warp_coarse_grid(cfg, field, dq)
    cf = tfusion.CoarseField(*(torch.from_numpy(np.array(a)) for a in (dq, q, warped)))
    return dq, q, cf


def _conf(seed=4):
    rng = np.random.RandomState(seed)
    c = rng.uniform(0.0, 1.0, (JC.rows, JC.cols)).astype(np.float32)
    c[rng.rand(JC.rows, JC.cols) < 0.1] = 0.0
    return c


CASES = {
    "q_only": dict(conf=False, split=1, phase=0, stride=2),
    "incidence": dict(conf=True, split=1, phase=0, stride=2),
    "phase_split2": dict(conf=True, split=2, phase=1, stride=2),
    "stride4": dict(conf=True, split=1, phase=0, stride=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_nonrigid_matches(surface_vol, case):
    c = CASES[case]
    ch = dict(knn_method="exact", knn_field_stride=c["stride"], fusion_phase_split=c["split"], fusion_interval=2,
              fusion_incidence_weight=c["conf"], fusion_sdf_incidence_scale=c["conf"], fusion_incidence_floor=0.35)
    jc, tc = dataclasses.replace(JC, **ch), dataclasses.replace(TC, **ch)
    field = _field(jc)
    dq, q, cf = _coarse(jc, field)
    pose = np.array(jse3.exp_twist(jnp.asarray(TWIST)))
    world2cam = np.linalg.inv(pose).astype(np.float32)
    dists = _dists(0.03)
    conf = _conf() if c["conf"] else None
    # op by op, where JAX's three prolongation einsums are the port's sums
    # bit for bit (test_prolongation_matches_jax): jitted inside the
    # integrate, XLA fuses them otherwise and the positions part by ulps
    jv = jfusion.integrate_nonrigid(
        jc, JVol(jnp.asarray(surface_vol[0]), jnp.asarray(surface_vol[1])), field, jnp.asarray(dists),
        jnp.asarray(world2cam), jc.intr, dq_grid=dq, q_grid=q, conf=None if conf is None else jnp.asarray(conf),
        phase=c["phase"], split=c["split"],
    )
    tv = _tvol(surface_vol)
    counts = tfusion.integrate_nonrigid(
        tc, tv, cf, torch.from_numpy(dists), torch.from_numpy(world2cam), tc.intr, torch.ones((), dtype=torch.bool),
        conf=None if conf is None else torch.from_numpy(conf), phase=torch.tensor(c["phase"]),
    )
    assert counts.tolist() == [0, 0, 0]
    jv = _np_vol(jv)
    _assert_close(jv, tv)
    updated = jv[1] != surface_vol[1]
    assert updated.mean() > 0.005
    if c["split"] > 1:
        # only the brick x-planes of this phase changed
        bx = (np.arange(64) // jc.brick_size) % c["split"]
        assert not updated[bx != c["phase"]].any() and updated[bx == c["phase"]].any()


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_prolongation_matches_jax(stride):
    """The warped voxel positions and the prolonged blend quality equal
    JAX's ``warp_voxel_field`` and its three q einsums bit for bit: XLA's
    dot on the CPU sums each two-term row as fma(w1, x1, w0 * x0)."""
    jc = dataclasses.replace(JC, knn_method="exact", knn_field_stride=stride)
    tc = dataclasses.replace(TC, knn_field_stride=stride)
    field = _field(jc, seed=2)
    dq, q, cf = _coarse(jc, field)
    jx, jy, jz = jfusion.warp_voxel_field(jc, field, dq)
    tw = tfusion.warp_voxel_field(tc, cf).numpy()
    for a, ja in enumerate((jx, jy, jz)):
        np.testing.assert_array_equal(np.asarray(ja), tw[..., a])
    pm = jfusion._prolong_matrix(64, stride)
    jq = np.asarray(jnp.einsum("kc,ijc->ijk", pm, jnp.einsum("jb,ibc->ijc", pm, jnp.einsum("ia,abc->ibc", pm, q))))
    tq = tfusion.prolong(cf.q, 64, stride).numpy()
    assert 0.0 < float(jq.max()) <= 1.0
    if stride < 8:
        np.testing.assert_array_equal(jq, tq)
    else:
        # XLA takes this shape's first dot, (64, 9) by (9, 81), without
        # fused multiply-adds (its choice of dot emitter depends on the
        # shape; at the preset's 256^3 / 33^3 grid every stage is an FMA
        # chain): a few ulps of q here, and nowhere in the positions
        np.testing.assert_allclose(jq, tq, rtol=5e-7, atol=0)
        assert (jq != tq).any()


def test_unpack_depth_conf_matches_jitted_jax():
    """The packed depth + incidence confidence unpack bit for bit as the
    jitted JAX ``unpack_depth_conf``: XLA takes v / 15 and dq / 4000 as
    products with the float32 reciprocals (kernels D and F2 and the port's
    plain version multiply so too); op by op JAX divides, and differs."""
    from dynamicfusion_tpu.ops import bricks as jbricks
    from dynamicfusion_tpu_torch.ops import bricks as tbricks

    rng = np.random.RandomState(6)
    d = rng.uniform(0.3, 4.0, 100_000).astype(np.float32)
    d[rng.rand(d.size) < 0.1] = 0.0
    c = rng.uniform(0.0, 1.0, d.size).astype(np.float32)
    v = np.asarray(jbricks.pack_depth_conf(jnp.asarray(d), jnp.asarray(c)))
    np.testing.assert_array_equal(v, tbricks.pack_depth_conf(torch.from_numpy(d), torch.from_numpy(c)).numpy())
    jd, jcf = (np.asarray(a) for a in jax.jit(jbricks.unpack_depth_conf)(jnp.asarray(v)))
    td, tcf = (a.numpy() for a in tbricks.unpack_depth_conf(torch.from_numpy(v.copy())))
    np.testing.assert_array_equal(jd, td)
    np.testing.assert_array_equal(jcf, tcf)
    od, ocf = (np.asarray(a) for a in jbricks.unpack_depth_conf(jnp.asarray(v)))
    assert (od != td).any() and (ocf != tcf).any()


def test_volume_codec_round_trip_is_identity():
    """The dense update re-encodes untouched voxels: the i16/u16 round trip
    is the identity on every code, as in JAX."""
    codes = np.arange(-32767, 32768, dtype=np.int16)
    back = np.asarray(jvolume.encode_tsdf(jvolume.decode_tsdf(jnp.asarray(codes)), jnp.int16))
    np.testing.assert_array_equal(back, codes)
    from dynamicfusion_tpu_torch.models import volume as tvolume

    t = torch.from_numpy(codes)
    np.testing.assert_array_equal(tvolume.encode_tsdf(tvolume.decode_tsdf(t), torch.int16).numpy(), codes)
    w = torch.arange(0, 65536, dtype=torch.int32).to(torch.uint16)
    assert torch.equal(tvolume.encode_weight(tvolume.decode_weight(w), torch.uint16).to(torch.int32),
                       w.to(torch.int32))
