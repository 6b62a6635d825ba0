"""Parity of the port's raycast variants (kernel C's plain version on the
CPU) with the JAX package: the newton16 and hybrid16 refines, each with and
without ``raycast_smooth_normals``, and the six-sample normal on the
secant and newton8 refines, for the full ray and in a march band, on a JAX
volume of a seeded synthetic scene handed to both packages as numpy
arrays. Tolerances as ``test_raycast_newton8_matches``: the found mask
exact, points 1e-5 m, normals 1e-4 (float32 in the same order; the
libraries may round a division apart by an ulp)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.models.volume import TsdfVolume as JVol
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu.ops import tsdf as jtsdf
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models.volume import TsdfVolume as TVol
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# A process's first torch.sqrt runs on one thread: MKL's vectorized sqrt,
# which CPU torch calls, has returned one thread's chunk at ~12 bits when
# that first call ran on several threads at once
torch.sqrt(torch.ones(1))

JC = JCfg.small(dims=64, rows=120, cols=160)
TC = TCfg.small(dims=64, rows=120, cols=160)
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
TOL_POINT_M = 1e-5
TOL_NORMAL = 1e-4
# (refine, raycast_smooth_normals): the two new refines in both normal
# modes, and the six-sample normal on the two refines ported before
VARIANTS = [("newton16", False), ("newton16", True), ("hybrid16", False), ("hybrid16", True),
            ("secant", True), ("newton8", True)]


def _pose(angle):
    return synthetic.orbit_pose(angle, target=TARGET)


@functools.lru_cache(maxsize=None)
def _depth(angle):
    return synthetic.scene_depth(JC.intr, JC.rows, JC.cols, _pose(angle), **SCENE)


@pytest.fixture(scope="module")
def vol2():
    """A JAX volume after two frames, as numpy (tsdf int16, weight uint16)."""
    vol = jkinfu.init_state(JC).vol
    for angle in (0.0, 0.02):
        dists = jpre.compute_dists(JC.intr, jnp.asarray(_depth(angle)))
        vol2cam = jse3.compose(jse3.inverse(jnp.asarray(_pose(angle))), jkinfu._vol_pose(JC))
        vol = jtsdf.integrate(JC, vol, dists, vol2cam, JC.intr)
    return np.array(vol.tsdf), np.array(vol.weight)


def _raycast_both(vol, refine, smooth, band):
    jc = dataclasses.replace(JC, raycast_refine=refine, raycast_smooth_normals=smooth)
    tc = dataclasses.replace(TC, raycast_refine=refine, raycast_smooth_normals=smooth)
    cam2vol = np.array(jse3.compose(jse3.inverse(jkinfu._vol_pose(JC)), jnp.asarray(_pose(0.03))))
    rows, cols = JC.rows // JC.raycast_subsample, JC.cols // JC.raycast_subsample
    t_band = None
    if band:
        rng = np.random.RandomState(5)
        lo = rng.uniform(0.2, 0.8, (rows, cols)).astype(np.float32)
        t_band = (lo, lo + rng.uniform(0.1, 0.6, (rows, cols)).astype(np.float32))
    # JAX finishes before the port starts (see tests/test_torch_dense_fusion.py)
    jr = jax.block_until_ready(jtsdf.raycast(
        jc, JVol(jnp.asarray(vol[0]), jnp.asarray(vol[1])), jnp.asarray(cam2vol), JC.intr.level(JC.raycast_shift),
        rows, cols, t_band=None if t_band is None else tuple(map(jnp.asarray, t_band)),
    ))
    tr = ttsdf.raycast(
        tc, TVol(torch.from_numpy(vol[0].copy()), torch.from_numpy(vol[1].copy())), torch.from_numpy(cam2vol),
        tc.intr.level(tc.raycast_shift), rows, cols,
        t_band=None if t_band is None else tuple(map(torch.from_numpy, t_band)),
    )
    return jr, tr


@pytest.mark.parametrize("band", [False, True], ids=["full_ray", "band"])
@pytest.mark.parametrize("refine,smooth", VARIANTS, ids=[f"{r}-{'grad6' if s else 'cell'}" for r, s in VARIANTS])
def test_raycast_variant_matches(vol2, refine, smooth, band):
    jr, tr = _raycast_both(vol2, refine, smooth, band)
    jp, tp = np.asarray(jr.points), tr.points.numpy()
    jn, tn = np.asarray(jr.normals), tr.normals.numpy()
    vj, vt = ~np.isnan(jp[..., 0]), ~np.isnan(tp[..., 0])
    np.testing.assert_array_equal(vj, vt)
    assert vj.mean() > 0.1
    assert np.abs(jp[vj] - tp[vj]).max() <= TOL_POINT_M
    assert np.abs(jn[vj] - tn[vj]).max() <= TOL_NORMAL
    # the variant is not the preset's answer: the refine or the normal changed
    _, base = _raycast_both(vol2, "newton8", False, band)
    changed = tn if smooth else tp
    ref = base.normals.numpy() if smooth else base.points.numpy()
    assert np.nanmax(np.abs(changed - ref)) > (1e-3 if smooth else 1e-5)


def test_grad6_matches(vol2):
    """The six-sample central difference at seeded points (NaN where a
    sample leaves the volume) against JAX's ``_grad6``, within float32
    rounding of the trilinear samples."""
    d = JC.volume_dims
    rng = np.random.RandomState(3)
    p = rng.uniform(-1.0, d + 0.5, (4000, 3)).astype(np.float32)
    jt = jnp.asarray(vol2[0])
    jg = np.asarray(jtsdf._grad6(lambda q: jtsdf.interpolate(jt, q), jnp.asarray(p),
                                 jnp.full((3,), JC.gradient_delta_factor, jnp.float32)))
    tg = ttsdf._grad6(torch.from_numpy(vol2[0].copy()), torch.from_numpy(p), TC.gradient_delta_factor).numpy()
    np.testing.assert_array_equal(np.isnan(jg), np.isnan(tg))
    ok = ~np.isnan(jg)
    assert 0.1 < ok.mean() < 1.0
    assert np.abs(jg[ok] - tg[ok]).max() <= 1e-6
