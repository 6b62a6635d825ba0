"""Parity of the port's preprocessing and ICP (plain PyTorch on the CPU)
with the JAX package: bilateral filter (kernel A's plain version), the
frame pyramid, the ICP normal equations (kernel B's plain version) and the
coarse-to-fine pose estimate. Inputs are made with numpy from a seed."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pyramid_frame
from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu.solvers import icp as jicp
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.solvers import icp as ticp
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


# rendered once per frame: the plane's depths sit on whole millimetres,
# where the last bit of the float64 render decides the uint16 truncation,
# and both packages must see the same array
@functools.lru_cache(maxsize=None)
def _depth(angle, noise_seed=None):
    d = synthetic.scene_depth(JC.intr, JC.rows, JC.cols, synthetic.orbit_pose(angle, target=TARGET), **SCENE)
    if noise_seed is not None:
        rng = np.random.RandomState(noise_seed)
        d = d.astype(np.int32)
        d = np.where(d > 0, d + rng.randint(-6, 7, d.shape), 0)
        d = np.where(rng.rand(*d.shape) < 0.02, 0, d)  # sensor holes
        d = d.astype(np.uint16)
    return d


@pytest.mark.parametrize("noise_seed", [None, 0, 1])
def test_bilateral_filter_matches(noise_seed):
    d = _depth(0.0, noise_seed)
    ref = np.asarray(jpre.bilateral_filter(jnp.asarray(d))).astype(np.int64)
    got = tpre.bilateral_filter(torch.from_numpy(d)).numpy().astype(np.int64)
    # tolerance: the two exp implementations may differ by an ulp, which can
    # flip the half-to-even rounding of an exact .5 mm tie: <= 1 mm, rarely
    diff = np.abs(ref - got)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_truncate_and_pyramid_down_match():
    d = _depth(0.02, noise_seed=2)
    np.testing.assert_array_equal(
        np.asarray(jpre.truncate_depth(jnp.asarray(d), 1.0)),
        tpre.truncate_depth(torch.from_numpy(d), 1.0).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jpre.depth_pyramid_down(jnp.asarray(d))),
        tpre.depth_pyramid_down(torch.from_numpy(d)).numpy(),
    )


@pytest.mark.parametrize("shape", [(61, 83), (97, 203)])
def test_depth_pyramid_levels_match_jax_on_threshold_edges(shape):
    """The port's plain all-levels pyramid (``depth_pyramid``, kernel I's
    one-launch entry on the card) against JAX's ``depth_pyramid_down``
    applied level by level, bit for bit, on ``chip_smoke.pyramid_frame``
    at odd sizes: holes, depths in 65 000-65 535, neighbours at and one mm
    either side of the 3-sigma threshold."""
    d = pyramid_frame(*shape, seed=shape[0])

    @jax.jit
    def levels(x):
        out = [x]
        for _ in range(3):
            out.append(jpre.depth_pyramid_down(out[-1]))
        return out

    jl = levels(jnp.asarray(d))
    tl = tpre.depth_pyramid(torch.from_numpy(d), 4)
    assert len(tl) == 4
    for k, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"level {k}")


def _assert_maps_close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, atol=atol, rtol=0, equal_nan=True)


def test_build_frame_pyramid_matches():
    d = _depth(0.03)
    jd, jp, jn, jdist = jpre.build_frame_pyramid(JC, jnp.asarray(d))
    td, tp, tn, tdist = tpre.build_frame_pyramid(TC, torch.from_numpy(d))
    np.testing.assert_allclose(np.asarray(jdist), tdist.numpy(), rtol=1e-6, atol=0)
    for lvl in range(JC.pyramid_levels):
        np.testing.assert_array_equal(np.asarray(jd[lvl]), td[lvl].numpy())
        # points/normals: float32 arithmetic in the same order, 1e-5 m / 1e-5
        _assert_maps_close(jp[lvl], tp[lvl].numpy(), 1e-5)
        _assert_maps_close(jn[lvl], tn[lvl].numpy(), 1e-5)
    p, n = jpre.resize_points_normals(jp[1], jn[1])
    tp2, tn2 = tpre.resize_points_normals(tp[1], tn[1])
    _assert_maps_close(p, tp2.numpy(), 1e-6)
    _assert_maps_close(n, tn2.numpy(), 1e-6)


@pytest.mark.parametrize("level", [0, 2])
def test_points_normals_match_on_noisy_depth(level):
    d = _depth(0.01, noise_seed=4)
    intr_j, intr_t = JC.intr.level(level), TC.intr.level(level)
    jp, jn = jpre.compute_points_normals(intr_j, jnp.asarray(d))
    tp, tn = tpre.compute_points_normals(intr_t, torch.from_numpy(d))
    _assert_maps_close(jp, tp.numpy(), 1e-5)
    _assert_maps_close(jn, tn.numpy(), 1e-5)


@pytest.mark.parametrize("stride", [2, 4])
def test_strided_points_normals_match(stride):
    """The raw-depth points of the solve: the port reads depth[::s, ::s]
    in place (kernel I's stride), JAX takes the strided copy; the float32
    arithmetic is the same, 1e-5 m / 1e-5 as above."""
    d = _depth(0.01, noise_seed=5)
    lvl = int(math.log2(stride))
    jp, jn = jpre.compute_points_normals(JC.intr.level(lvl), jnp.asarray(d[::stride, ::stride]))
    tp, tn = tpre.compute_points_normals(TC.intr.level(lvl), torch.from_numpy(d), stride=stride)
    _assert_maps_close(jp, tp.numpy(), 1e-5)
    _assert_maps_close(jn, tn.numpy(), 1e-5)


@pytest.mark.parametrize("truncate", [0.0, 1.05])
def test_frame_pyramid_with_confidence_matches(truncate):
    """build_frame_pyramid with the fusion's incidence confidence (JAX
    computes it in kinfu.step, kinfu.py:633-635) and with the depth
    truncation on and off: depths exact, maps 1e-5, confidence 1e-5 (a
    cosine of unit vectors made in the same order)."""
    jc = dataclasses.replace(JC, icp_truncate_depth_dist=truncate)
    tc = dataclasses.replace(TC, icp_truncate_depth_dist=truncate)
    d = _depth(0.03, noise_seed=6)
    jd, jp, jn, jdist = jpre.build_frame_pyramid(jc, jnp.asarray(d))
    pn = jp[0] / jnp.maximum(jnp.linalg.norm(jp[0], axis=-1, keepdims=True), 1e-9)
    jconf = np.asarray(jnp.nan_to_num(jnp.abs(jnp.sum(jn[0] * pn, axis=-1))))
    td, tp, tn, tdist, tconf = tpre.build_frame_pyramid(tc, torch.from_numpy(d), first_point_level=2, with_conf=True)
    np.testing.assert_allclose(np.asarray(jdist), tdist.numpy(), rtol=1e-6, atol=0)
    for lvl in range(jc.pyramid_levels):
        np.testing.assert_array_equal(np.asarray(jd[lvl]), td[lvl].numpy())
    if truncate:
        assert (np.asarray(jd[0]) == 0).mean() > (d == 0).mean()
    # level 0 comes with the confidence; level 1 is below first_point_level
    assert tp[1] is None and tn[1] is None
    for lvl in (0, 2, 3):
        _assert_maps_close(jp[lvl], tp[lvl].numpy(), 1e-5)
        _assert_maps_close(jn[lvl], tn[lvl].numpy(), 1e-5)
    assert (jconf > 0.5).mean() > 0.1
    np.testing.assert_allclose(jconf, tconf.numpy(), atol=1e-5, rtol=0)


def _maps(angle, noise_seed):
    d = _depth(angle, noise_seed)
    _, jp, jn, _ = jpre.build_frame_pyramid(JC, jnp.asarray(d))
    return [np.array(a) for a in jp], [np.array(a) for a in jn]


@pytest.mark.parametrize("level", [1, 2])
def test_build_system_matches(level):
    cp, cn = _maps(0.02, 5)
    pp, pn = _maps(0.0, 6)
    rng = np.random.RandomState(level)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = rng.uniform(-0.01, 0.01, 3)
    intr = JC.intr.level(level)
    args = (JC.icp_dist_thres ** 2, math.cos(JC.icp_angle_thres))
    a_j, b_j = jicp._build_system(intr, jnp.asarray(t), cp[level], cn[level], pp[level], pn[level], *args)
    a_t, b_t = ticp._build_system(
        TC.intr.level(level), torch.from_numpy(t), *(torch.from_numpy(m[level]) for m in (cp, cn, pp, pn)), *args
    )
    # sums over thousands of pixels in another order: relative 1e-5
    scale = float(np.abs(np.asarray(a_j)).max())
    assert float(np.abs(np.asarray(a_j) - a_t.numpy()).max()) <= 1e-5 * scale
    assert float(np.abs(np.asarray(b_j) - b_t.numpy()).max()) <= 1e-5 * max(float(np.abs(np.asarray(b_j)).max()), 1.0)


def test_estimate_transform_matches():
    shift = JC.raycast_shift
    cp, cn = _maps(0.02, None)
    pp, pn = _maps(0.0, None)
    jr = jicp.estimate_transform(JC, cp[shift:], cn[shift:], pp[shift:], pn[shift:], level_offset=shift)
    tr = ticp.estimate_transform(
        TC, [torch.from_numpy(a) for a in cp[shift:]], [torch.from_numpy(a) for a in cn[shift:]],
        [torch.from_numpy(a) for a in pp[shift:]], [torch.from_numpy(a) for a in pn[shift:]],
        level_offset=shift,
    )
    assert bool(jr.ok) == bool(tr.ok)
    # the fixed-cap loop with a frozen `active` mask reproduces the early exit
    np.testing.assert_allclose(np.asarray(jr.transform), tr.transform.numpy(), atol=1e-5, rtol=0)
    # and it tracked: the relative orbit motion is recovered to a few mm
    rel = np.linalg.inv(synthetic.orbit_pose(0.0, target=TARGET)) @ synthetic.orbit_pose(0.02, target=TARGET)
    assert np.abs(tr.transform.numpy()[:3, 3] - rel[:3, 3]).max() < 5e-3


def test_gn_update_det_guard():
    """A singular system skips the increment and reports unhealthy."""
    t = torch.eye(4)
    t_new, good, step = ticp._gn_update(torch.zeros((6, 6)), torch.ones(6), t)
    assert not bool(good) and torch.equal(t_new, t) and bool(torch.isinf(step))
