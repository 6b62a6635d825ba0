"""Parity of the port's TSDF ops (plain PyTorch on the CPU) with the JAX
package: trilinear samplers, brick-sparse fusion (kernel D's plain
version) with its counts, the raycast march and secant refine (kernel C's
plain version), surface extraction, frame-0 node sampling and the march
band helpers. Volumes come from JAX integrates of a seeded synthetic scene
and are handed to both packages as numpy arrays."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.models import warpfield as jwarp
from dynamicfusion_tpu.models.volume import TsdfVolume as JVol
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu.ops import tsdf as jtsdf
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import warpfield as twarp
from dynamicfusion_tpu_torch.models.volume import TsdfVolume as TVol
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KW = dict(max_nodes=64, node_sample_step=17, rigid_only=True)
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
# volume codes: arithmetic in float32 in the same order, so a code may
# differ by one LSB where the two libraries round a division differently;
# more than one LSB in no voxel
MAX_LSB = 1
MAX_LSB_FRAC = 1e-3


def _pose(angle):
    return synthetic.orbit_pose(angle, target=TARGET)


# rendered once per frame: the plane's depths sit on whole millimetres,
# where the last bit of the float64 render decides the uint16 truncation,
# and both packages must see the same array
@functools.lru_cache(maxsize=None)
def _depth(angle):
    return synthetic.scene_depth(JC.intr, JC.rows, JC.cols, _pose(angle), **SCENE)


def _vol2cam(pose):
    return np.array(jse3.compose(jse3.inverse(jnp.asarray(pose)), jkinfu._vol_pose(JC)))


def _jax_integrate(vol, angle, cfg=JC):
    dists = jpre.compute_dists(cfg.intr, jnp.asarray(_depth(angle)))
    return jtsdf.integrate(cfg, vol, dists, jnp.asarray(_vol2cam(_pose(angle))), cfg.intr, with_counts=True)


@pytest.fixture(scope="module")
def vol2():
    """A JAX volume after two frames, as numpy (tsdf int16, weight uint16)."""
    vol = jkinfu.init_state(JC).vol
    for angle in (0.0, 0.02):
        vol, _ = _jax_integrate(vol, angle)
    return np.array(vol.tsdf), np.array(vol.weight)


def _tvol(np_vol):
    return TVol(torch.from_numpy(np_vol[0].copy()), torch.from_numpy(np_vol[1].copy()))


def _assert_codes_close(jv, tv):
    dt = np.abs(np.asarray(jv.tsdf).astype(np.int64) - tv.tsdf.numpy().astype(np.int64))
    assert dt.max() <= MAX_LSB and (dt > 0).mean() <= MAX_LSB_FRAC
    np.testing.assert_array_equal(np.asarray(jv.weight), tv.weight.numpy())


CAPS = {
    "default": {},
    # caps that overflow: the prioritized band order and the exact
    # (band, wide, dropped) counts decide which bricks are fused
    "capped": dict(integrate_band_cap=6, integrate_wide_cap=1, integrate_rect=16),
}


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_integrate_bricks_matches(vol2, caps):
    jc = dataclasses.replace(JC, **CAPS[caps])
    tc = dataclasses.replace(TC, **CAPS[caps])
    angle = 0.04
    jv, jcounts = _jax_integrate(JVol(jnp.asarray(vol2[0]), jnp.asarray(vol2[1])), angle, jc)
    tv = _tvol(vol2)
    dists = tpre.compute_dists(tc.intr, torch.from_numpy(_depth(angle)))
    tcounts = ttsdf.integrate(tc, tv, dists, torch.from_numpy(_vol2cam(_pose(angle))), tc.intr)
    np.testing.assert_array_equal(np.asarray(jcounts), tcounts.numpy())
    if caps == "capped":
        assert int(tcounts[2]) > 0
    _assert_codes_close(jv, tv)


def test_integrate_skipped_when_not_ok(vol2):
    tv = _tvol(vol2)
    dists = tpre.compute_dists(TC.intr, torch.from_numpy(_depth(0.04)))
    counts = ttsdf.integrate(
        TC, tv, dists, torch.from_numpy(_vol2cam(_pose(0.04))), TC.intr, ok=torch.zeros((), dtype=torch.bool)
    )
    assert counts.tolist() == [0, 0, 0]
    np.testing.assert_array_equal(tv.tsdf.numpy(), vol2[0])
    np.testing.assert_array_equal(tv.weight.numpy(), vol2[1])


def _sample_points(n, d, seed):
    rng = np.random.RandomState(seed)
    p = rng.uniform(-1.5, d + 0.5, (n, 3)).astype(np.float32)
    # exact half-voxel ties (round half to even) and points on cell faces
    p[: n // 8] = np.round(p[: n // 8]) + 0.5
    p[n // 8 : n // 4] = np.round(p[n // 8 : n // 4])
    return p


def test_samplers_match(vol2):
    d = JC.volume_dims
    p = _sample_points(4000, d, 0)
    jt, tt = jnp.asarray(vol2[0]), torch.from_numpy(vol2[0].copy())
    np.testing.assert_array_equal(
        np.asarray(jtsdf.fetch_nearest(jt, jnp.asarray(p))), ttsdf.fetch_nearest(tt, torch.from_numpy(p)).numpy()
    )
    # trilinear: the same float32 expression in the same order
    np.testing.assert_allclose(
        np.asarray(jtsdf.interpolate(jt, jnp.asarray(p))),
        ttsdf.interpolate(tt, torch.from_numpy(p)).numpy(), atol=1e-6, rtol=0,
    )
    jv, jg = jtsdf.interpolate_with_gradient(jt, jnp.asarray(p))
    tv, tg = ttsdf.interpolate_with_gradient(tt, torch.from_numpy(p))
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jg), tg.numpy(), atol=1e-6, rtol=0)
    assert np.isnan(tv.numpy()).any() and not np.isnan(tv.numpy()).all()


def test_march_step_cap():
    """The JAX march checks its trip count every two steps, so a ray takes
    up to n_steps rounded up to even."""
    for cfg in (TC, TCfg.rigid_slice(), TCfg.default_kinfu()):
        step = max(cfg.tsdf_trunc_dist, 2.1 * cfg.voxel_size) * cfg.raycast_step_factor
        n = int(np.ceil(np.sqrt(3.0) * cfg.volume_size / step)) + 1
        assert ttsdf.march_steps(cfg) == n + n % 2
    assert ttsdf.march_steps(TCfg.rigid_slice()) == 60


def _raycast_both(vol, angle, band, refine="secant"):
    jc = dataclasses.replace(JC, raycast_refine=refine)
    tc = dataclasses.replace(TC, raycast_refine=refine)
    pose = _pose(angle)
    cam2vol = np.array(jse3.compose(jse3.inverse(jkinfu._vol_pose(JC)), jnp.asarray(pose)))
    rows, cols = JC.rows // JC.raycast_subsample, JC.cols // JC.raycast_subsample
    intr = JC.intr.level(JC.raycast_shift)
    t_band = None
    if band:
        rng = np.random.RandomState(5)
        lo = rng.uniform(0.2, 0.8, (rows, cols)).astype(np.float32)
        t_band = (lo, lo + rng.uniform(0.1, 0.6, (rows, cols)).astype(np.float32))
    jr = jtsdf.raycast(
        jc, JVol(jnp.asarray(vol[0]), jnp.asarray(vol[1])), jnp.asarray(cam2vol), intr, rows, cols,
        t_band=None if t_band is None else tuple(map(jnp.asarray, t_band)),
    )
    tr = ttsdf.raycast(
        tc, _tvol(vol), torch.from_numpy(cam2vol), tc.intr.level(tc.raycast_shift), rows, cols,
        t_band=None if t_band is None else tuple(map(torch.from_numpy, t_band)),
    )
    return jr, tr


@pytest.mark.parametrize("band", [False, True], ids=["full_ray", "band"])
def test_raycast_secant_matches(vol2, band):
    jr, tr = _raycast_both(vol2, 0.03, band)
    jp, tp = np.asarray(jr.points), tr.points.numpy()
    jn, tn = np.asarray(jr.normals), tr.normals.numpy()
    vj, vt = ~np.isnan(jp[..., 0]), ~np.isnan(tp[..., 0])
    # hit/miss agree on every ray; points within 1e-5 m, normals 1e-4
    np.testing.assert_array_equal(vj, vt)
    assert vj.mean() > 0.1
    both = vj & vt
    assert np.abs(jp[both] - tp[both]).max() <= 1e-5
    assert np.abs(jn[both] - tn[both]).max() <= 1e-4


@pytest.mark.parametrize("band", [False, True], ids=["full_ray", "band"])
def test_raycast_newton8_matches(vol2, band):
    """The dynamicfusion preset's refine: the secant of the march's
    nearest-fetched bracket values, one fused value+gradient fetch there
    and one clamped Newton step; the normal is the gradient at the secant
    point. Found mask exact, points 1e-5 m, normals 1e-4 (float32 in the
    same order; the libraries may round a division apart by an ulp)."""
    jr, tr = _raycast_both(vol2, 0.03, band, refine="newton8")
    jp, tp = np.asarray(jr.points), tr.points.numpy()
    jn, tn = np.asarray(jr.normals), tr.normals.numpy()
    vj, vt = ~np.isnan(jp[..., 0]), ~np.isnan(tp[..., 0])
    np.testing.assert_array_equal(vj, vt)
    assert vj.mean() > 0.1
    assert np.abs(jp[vj] - tp[vj]).max() <= 1e-5
    assert np.abs(jn[vj] - tn[vj]).max() <= 1e-4
    # not the secant's answer: the refine changed the crossings
    _, ts = _raycast_both(vol2, 0.03, band)
    assert np.nanmax(np.abs(ts.points.numpy() - tp)) > 1e-5


@pytest.mark.parametrize("smooth", [False, True], ids=["cell_normal", "grad6"])
def test_every_refine_runs(vol2, smooth):
    """All four refines (kernel C's codes 0-3) run in either normal mode
    and give unit normals on the rays that hit; an unknown refine name is
    refused. tests/test_torch_raycast_variants.py holds them against JAX."""
    cam2vol = torch.from_numpy(np.array(jse3.compose(jse3.inverse(jkinfu._vol_pose(JC)), jnp.asarray(_pose(0.03)))))
    intr = TC.intr.level(TC.raycast_shift)
    for code, refine in enumerate(ttsdf.REFINES):
        cfg = dataclasses.replace(TC, raycast_refine=refine, raycast_smooth_normals=smooth)
        assert ttsdf._refine_mode(cfg) == code
        r = ttsdf.raycast(cfg, _tvol(vol2), cam2vol, intr, 60, 80)
        hit = ~torch.isnan(r.points[..., 0])
        assert r.points.shape == r.normals.shape == (60, 80, 3) and float(hit.float().mean()) > 0.1
        assert torch.allclose(torch.linalg.vector_norm(r.normals[hit], dim=-1), torch.ones(()), atol=1e-5)
    with pytest.raises(ValueError, match="raycast_refine"):
        ttsdf.raycast(dataclasses.replace(TC, raycast_refine="newton4"), _tvol(vol2), cam2vol, intr, 8, 8)


@pytest.mark.parametrize("max_points", [1 << 16, 700])
def test_extract_cloud_matches(vol2, max_points):
    jv = JVol(jnp.asarray(vol2[0]), jnp.asarray(vol2[1]))
    jc = jtsdf.extract_cloud(JC, jv, max_points=max_points, min_weight=1.0)
    tc = ttsdf.extract_cloud(TC, _tvol(vol2), max_points=max_points, min_weight=1.0)
    assert int(jc.count) == int(tc.count) and int(tc.count) > 700
    np.testing.assert_array_equal(np.asarray(jc.valid), tc.valid.numpy())
    np.testing.assert_allclose(np.asarray(jc.points), tc.points.numpy(), atol=1e-6, rtol=0)


def test_init_from_cloud_matches(vol2):
    jv = JVol(jnp.asarray(vol2[0]), jnp.asarray(vol2[1]))
    jc = jtsdf.extract_cloud(JC, jv, max_points=1 << 16, min_weight=1.0)
    jf = jwarp.init_from_cloud(JC, jc.points, jc.valid)
    tf = twarp.init_from_cloud(TC, torch.from_numpy(np.array(jc.points)), torch.from_numpy(np.array(jc.valid)))
    assert int(jf.count) == int(tf.count) == JC.max_nodes
    np.testing.assert_array_equal(np.asarray(jf.active), tf.active.numpy())
    np.testing.assert_array_equal(np.asarray(jf.positions), tf.positions.numpy())
    np.testing.assert_array_equal(np.asarray(jf.dq), tf.dq.numpy())
    np.testing.assert_array_equal(np.asarray(jf.radius), tf.radius.numpy())


def test_march_band_helpers_match():
    rng = np.random.RandomState(2)
    cfg_j = dataclasses.replace(JC, raycast_seed_margin=0.1, raycast_temporal_band=True)
    cfg_t = dataclasses.replace(TC, raycast_seed_margin=0.1, raycast_temporal_band=True)
    dists = np.array(jpre.compute_dists(JC.intr, jnp.asarray(_depth(0.01))))
    dists[rng.rand(*dists.shape) < 0.1] = 0.0
    rows, cols = JC.rows // JC.raycast_subsample, JC.cols // JC.raycast_subsample
    prev = rng.uniform(-0.3, 1.2, (rows, cols, 3)).astype(np.float32)
    prev[rng.rand(rows, cols) < 0.3] = np.nan
    jlo, jhi = jkinfu._temporal_band(cfg_j, jnp.asarray(prev), jnp.asarray(dists))
    tlo, thi = tkinfu._temporal_band(cfg_t, torch.from_numpy(prev), torch.from_numpy(dists))
    np.testing.assert_allclose(np.asarray(jlo), tlo.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jhi), thi.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        np.asarray(jkinfu._raycast_seed(cfg_j, jnp.asarray(dists))),
        tkinfu._raycast_seed(cfg_t, torch.from_numpy(dists)).numpy(),
    )


@pytest.mark.parametrize("case", ["all_miss", "zero_dists"])
def test_march_band_helpers_match_at_the_edges(case):
    """The plain band and seed (kernel J's plain versions) against JAX's
    ``_temporal_band`` and ``_raycast_seed`` where no ray can be banded
    from the model (a model map that misses everywhere) and where the live
    frame has no depth (all-zero dists: no seed, the band from the model
    alone)."""
    rng = np.random.RandomState(4)
    cfg_j = dataclasses.replace(JC, raycast_seed_margin=0.1, raycast_temporal_band=True)
    cfg_t = dataclasses.replace(TC, raycast_seed_margin=0.1, raycast_temporal_band=True)
    dists = np.array(jpre.compute_dists(JC.intr, jnp.asarray(_depth(0.01))))
    rows, cols = JC.rows // JC.raycast_subsample, JC.cols // JC.raycast_subsample
    prev = rng.uniform(-0.3, 1.2, (rows, cols, 3)).astype(np.float32)
    if case == "all_miss":
        prev[:] = np.nan
    else:
        dists[:] = 0.0
    jlo, jhi = jkinfu._temporal_band(cfg_j, jnp.asarray(prev), jnp.asarray(dists))
    tlo, thi = tkinfu._temporal_band(cfg_t, torch.from_numpy(prev), torch.from_numpy(dists))
    np.testing.assert_allclose(np.asarray(jlo), tlo.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jhi), thi.numpy(), atol=1e-6, rtol=0)
    jseed = np.asarray(jkinfu._raycast_seed(cfg_j, jnp.asarray(dists)))
    np.testing.assert_array_equal(jseed, tkinfu._raycast_seed(cfg_t, torch.from_numpy(dists)).numpy())
    if case == "zero_dists":
        assert not jseed.any() and bool((thi > tlo).any())
    else:
        assert bool((thi > tlo).any()) and bool((tlo[thi > 0] > 0).any())
