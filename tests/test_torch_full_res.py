"""The port's full-resolution raycasts against the JAX package, on the CPU:
the coarse-band prepass (``ops/tsdf.raycast_coarse_band``), the rigid
KinectFusion step at the reference's resolution (``raycast_subsample=1``,
which turns the prepass on), the renders, and the fresh canonical raycast
of ``reuse_model_raycast=False``.

- The coarse band at ``small()``: the port's band of JAX's own coarse hits
  equals JAX's band but for the last bit of |p| (TOL_BAND_ULP_M), with the
  same empty windows; the whole prepass (the port's coarse march in place
  of JAX's) agrees on all but TOL_BAND_FRAC of the pixels. The scene has
  no back plane, so whole 3x3 coarse windows miss.
- Four rigid orbit frames at ``small(dims=64, rows=240, cols=320)`` with
  ``raycast_subsample=1`` (a 60x80 coarse grid, 4 800 coarse rays): the
  port's step from JAX's previous state against JAX's step (pose, and at
  JAX's pose the fusion, brick counts and the 320x240 model maps), as
  tests/test_torch_slice.py holds the 1/2-resolution slice.
- ``render_state`` modes 0, 2, 3 and ``DynamicFusion.render(pose=...)``
  against JAX's ``render_state`` and ``render``: uint8 images within one
  level on all but TOL_IMAGE_FRAC of the pixels (a raycast hit may flip at
  a silhouette, and the Phong power rounds differently).
- Two non-rigid steps of the slice's ``small()`` settings with
  ``reuse_model_raycast=False`` from JAX's state
  (tests/test_torch_full_res_fresh.py), and the pipeline options that once
  refused (tests/test_torch_full_res_options.py): files of their own, so
  that ``--dist loadfile`` spreads the JAX compiles over the workers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.ops import tsdf as jtsdf
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu.pipeline import render as jrender
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from dynamicfusion_tpu_torch.pipeline import render as trender

FULL = dict(max_nodes=64, node_sample_step=17, rigid_only=True, raycast_subsample=1)
JC = dataclasses.replace(JCfg.small(dims=64, rows=240, cols=320), **FULL)
TC = dataclasses.replace(TCfg.small(dims=64, rows=240, cols=320), **FULL)
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
ANGLES = (0.0, 0.02, 0.04, 0.06)

# tolerances
TOL_BAND_ULP_M = 1e-6      # band of the same coarse hits: |p| rounds in another order
TOL_BAND_FRAC = 5e-3       # pixels whose band differs when each package marches its own coarse rays
TOL_POSE = 1e-4            # every entry of the pose, the port's step from JAX's state
TOL_LSB_FRAC = 1e-4        # voxels whose tsdf codes differ by more than 1 LSB
TOL_MAP_VALID_FRAC = 1e-3  # model-map pixels valid in one package only
TOL_MAP_M = 1e-5           # model-map points where both are valid, ...
TOL_MAP_FRAC = 1e-2        # ... except on this fraction of pixels (a one-LSB code
TOL_MAP_MAX_M = 1e-3       # difference moves a crossing), where they stay below this
TOL_NRM = 1e-4             # normals (unit vectors) on the same terms, but a
TOL_NRM_MAX = 1e-2         # crossing 1e-4 m away in the neighbouring voxel cell
TOL_NRM_CELL_FRAC = 1e-4   # takes that cell's trilinear gradient (1 pixel in 5e4 here)
TOL_TRUTH_M = 5e-3         # pose against the analytic orbit
TOL_IMAGE_FRAC = 2e-3      # image pixels more than one level apart


def test_reference_parity_rigid_uses_the_coarse_band():
    """``reference_parity()`` runs its model maps at 640x480 and so the
    coarse-band prepass on a 160x120 coarse grid; the presets' 160x120 maps
    do not; the small full-resolution config here does (60x80)."""
    ref = TCfg.reference_parity()
    assert ref.raycast_subsample == 1 and ref.raycast_shift == 0 and ref.track_levels == 4
    assert tkinfu._use_coarse_band(ref, ref.rows, ref.cols)
    pre = TCfg.default_dynamicfusion()
    assert not tkinfu._use_coarse_band(pre, pre.rows // 4, pre.cols // 4)
    assert tkinfu._use_coarse_band(TC, TC.rows, TC.cols)
    for c in (TC, TCfg.small(), pre, ref):
        for rows, cols in ((c.rows, c.cols), (c.rows // 4, c.cols // 4)):
            jc = JCfg(**{f.name: getattr(c, f.name) for f in dataclasses.fields(c) if f.name != "intr"})
            assert tkinfu._use_coarse_band(c, rows, cols) == jkinfu._use_coarse_band(jc, rows, cols)


@functools.lru_cache(maxsize=1)
def _depths():
    return [
        synthetic.scene_depth(JC.intr, JC.rows, JC.cols, synthetic.orbit_pose(a, target=TARGET), **SCENE)
        for a in ANGLES
    ]


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def jax_run():
    """JAX over the orbit, jitted: per frame (state, outputs) as numpy."""
    first = jax.jit(lambda s, d: jkinfu.first_frame(JC, s, d))
    step = jax.jit(lambda s, d: jkinfu.step(JC, s, d))
    depths = _depths()
    js = first(jkinfu.init_state(JC), jnp.asarray(depths[0]))
    frames = [(_np(js), None)]
    for d in depths[1:]:
        js, jo = step(js, jnp.asarray(d))
        frames.append((_np(js), _np(jo)))
    return frames


# --------------------------------------------------------------------------
# the coarse band
# --------------------------------------------------------------------------


def _spheres_volume():
    """The port's frame-0 volume of the orbit's spheres with no plane behind
    them (at the small slice's 120x160, 64^3), and a camera 0.03 rad round
    the orbit: (JAX config, port config, numpy volume, cam2vol)."""
    jc = dataclasses.replace(JCfg.small(), rigid_only=True, max_nodes=64, node_sample_step=17)
    tc = dataclasses.replace(TCfg.small(), rigid_only=True, max_nodes=64, node_sample_step=17)
    scene = dict(spheres=SCENE["spheres"])
    depth = synthetic.scene_depth(jc.intr, jc.rows, jc.cols, synthetic.orbit_pose(0.0, target=TARGET), **scene)
    ts = tkinfu.first_frame(tc, tkinfu.init_state(tc, "cpu"), torch.from_numpy(depth))
    pose = synthetic.orbit_pose(0.03, target=TARGET)
    cam2vol = jse3.compose(jse3.inverse(jkinfu._vol_pose(jc)), jnp.asarray(pose))
    return jc, tc, tuple(a.numpy().copy() for a in ts.vol), np.asarray(cam2vol)


def test_coarse_band_matches_jax():
    jc, tc, vol, cam2vol = _spheres_volume()
    rows, cols = jc.rows, jc.cols
    f = jc.raycast_coarse_factor
    jvol = jkinfu.TsdfVolume(*(jnp.asarray(a) for a in vol))

    @jax.jit
    def jax_band(v, c):  # JAX's prepass, and its coarse march alone
        coarse = jtsdf.raycast(jc, v, c, jc.intr.level(2), rows // f, cols // f)
        return jtsdf.raycast_coarse_band(jc, v, c, jc.intr, rows, cols), coarse.points

    (jlo, jhi), coarse = jax_band(jvol, jnp.asarray(cam2vol))
    jlo, jhi = np.asarray(jlo), np.asarray(jhi)
    # the band of JAX's own coarse hits
    lo, hi = (a.numpy() for a in ttsdf.coarse_band_plain(torch.from_numpy(np.asarray(coarse)), f,
                                                          tc.raycast_band_margin))
    assert lo.shape == jlo.shape == (rows, cols)
    np.testing.assert_array_equal(lo == 0, jlo == 0)
    np.testing.assert_array_equal(hi == 0, jhi == 0)
    np.testing.assert_allclose(lo, jlo, atol=TOL_BAND_ULP_M, rtol=0)
    np.testing.assert_allclose(hi, jhi, atol=TOL_BAND_ULP_M, rtol=0)
    empty = jhi == 0
    assert 0.05 < empty.mean() < 0.95  # whole windows missed, and some hit
    # the port's whole prepass (its own coarse march) on the same volume
    tvol = tkinfu.TsdfVolume(*(torch.from_numpy(a.copy()) for a in vol))
    tlo, thi = (a.numpy() for a in ttsdf.raycast_coarse_band(tc, tvol, torch.from_numpy(cam2vol), tc.intr, rows, cols))
    far = (np.abs(tlo - jlo) > TOL_BAND_ULP_M) | (np.abs(thi - jhi) > TOL_BAND_ULP_M)
    assert far.mean() <= TOL_BAND_FRAC, far.mean()
    # each coarse value covers an f x f block of fine pixels
    np.testing.assert_array_equal(tlo[::f, ::f].repeat(f, 0).repeat(f, 1), tlo)


# --------------------------------------------------------------------------
# the rigid step at the reference's resolution
# --------------------------------------------------------------------------


def _check_volume(jv, tv):
    jt, tt = jv.tsdf.astype(np.int64), tv.tsdf.numpy().astype(np.int64)
    assert (np.abs(jt - tt) > 1).mean() < TOL_LSB_FRAC
    np.testing.assert_array_equal(jv.weight, tv.weight.numpy())


def _check_maps(j_maps, t_maps, normals=False):
    tol, tol_max = (TOL_NRM, TOL_NRM_MAX) if normals else (TOL_MAP_M, TOL_MAP_MAX_M)
    for jm, tm in zip(j_maps, t_maps):
        tm = np.asarray(tm)
        assert jm.shape == tm.shape
        vj, vt = ~np.isnan(jm[..., 0]), ~np.isnan(tm[..., 0])
        assert (vj != vt).mean() <= TOL_MAP_VALID_FRAC
        both = vj & vt
        assert both.mean() > 0.3
        err = np.abs(jm[both] - tm[both]).max(axis=-1)
        assert (err > tol).mean() <= TOL_MAP_FRAC
        assert (err > tol_max).mean() <= (TOL_NRM_CELL_FRAC if normals else 0.0)


def test_first_frame_at_full_resolution_matches_jax(jax_run):
    j = jax_run[0][0]
    ts = tkinfu.first_frame(TC, tkinfu.init_state(TC, "cpu"), torch.from_numpy(_depths()[0]))
    _check_volume(j.vol, ts.vol)
    assert ts.can_points.shape == (TC.rows, TC.cols, 3) and len(ts.prev_points) == 4
    _check_maps((j.can_points, *j.prev_points), (ts.can_points, *ts.prev_points))
    _check_maps((j.can_normals, *j.prev_normals), (ts.can_normals, *ts.prev_normals), normals=True)


@pytest.mark.parametrize("frame", range(1, len(ANGLES)))
def test_full_resolution_step_from_jax_state_matches(jax_run, frame):
    """ICP at 320x240 / 160x120 / 80x60 against JAX's 320x240 maps, then at
    JAX's pose the fusion and the coarse-banded 320x240 model maps."""
    (j_prev, _), (j, jo) = jax_run[frame - 1], jax_run[frame]
    depth = torch.from_numpy(_depths()[frame])
    _, to = tkinfu.step(TC, interop.state_from_numpy(j_prev, "cpu"), depth)
    assert bool(to.icp_ok) and bool(jo.icp_ok)
    assert np.abs(jo.pose - to.pose.numpy()).max() <= TOL_POSE
    truth = synthetic.orbit_pose(ANGLES[frame], target=TARGET)
    assert np.linalg.norm(to.pose.numpy()[:3, 3] - truth[:3, 3]) < TOL_TRUTH_M

    st = interop.state_from_numpy(j_prev, "cpu")
    pose = torch.from_numpy(jo.pose)
    dists = tpre.compute_dists(TC.intr, depth)
    vol2cam = tkinfu.se3.compose(tkinfu.se3.inverse(pose), tkinfu._vol_pose(TC, "cpu"))
    counts = ttsdf.integrate(TC, st.vol, dists, vol2cam, TC.intr, ok=torch.tensor(True))
    np.testing.assert_array_equal(jo.brick_counts, counts.numpy())
    _check_volume(j.vol, st.vol)
    (pts, nrm), can_pts, can_nrm = tkinfu._model_maps(TC, st.vol, pose)
    _check_maps((j.can_points, *j.prev_points), (can_pts, *pts))
    _check_maps((j.can_normals, *j.prev_normals), (can_nrm, *nrm), normals=True)


def test_interop_round_trips_full_resolution_state(jax_run):
    """A 320x240 JAX state with its four-level map pyramid crosses to the
    port and back unchanged."""
    j = jax_run[-1][0]
    back = interop.state_to_numpy(interop.state_from_numpy(j, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(j), jax.tree_util.tree_leaves(
            (back["vol"]["tsdf"], back["vol"]["weight"], *back["warp"].values(), back["pose"], back["prev_points"],
             back["prev_normals"], back["can_points"], back["can_normals"], back["frame_idx"]))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert [p.shape for p in back["prev_points"]] == [(240, 320, 3), (120, 160, 3), (60, 80, 3), (30, 40, 3)]


# --------------------------------------------------------------------------
# renders
# --------------------------------------------------------------------------


def _check_image(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    far = np.abs(ref.astype(np.int32) - got.astype(np.int32)).max(-1) > 1
    assert far.mean() <= TOL_IMAGE_FRAC, far.mean()
    assert got.std() > 1.0


@pytest.mark.parametrize("mode", [0, 2, 3])
def test_render_state_matches_jax(jax_run, mode):
    """From the last model maps; the 1/2-resolution slice's maps are
    pixel-replicated to the frame."""
    sub = dataclasses.replace(TC, raycast_subsample=2)
    for cfg_t, cfg_j in ((TC, JC), (sub, dataclasses.replace(JC, raycast_subsample=2))):
        j = jax_run[-1][0]
        if cfg_t is sub:  # a half-resolution pyramid: every other pixel of the full one
            j = j._replace(prev_points=tuple(p[::2, ::2] for p in j.prev_points[:3]),
                           prev_normals=tuple(n[::2, ::2] for n in j.prev_normals[:3]))
        ref = jrender.render_state(cfg_j, j, mode)
        got = trender.render_state(cfg_t, interop.state_from_numpy(j, "cpu"), mode)
        assert got.shape == (cfg_t.rows, cfg_t.cols * (2 if mode == 3 else 1), 3)
        _check_image(ref, got)


def test_render_from_a_pose_matches_jax(jax_run):
    """A fresh full-resolution raycast with no band from a viewpoint the
    frames never took (the orbit 0.15 rad on), in the JAX package's and the
    port's ``render``; node overlay on the Phong panel."""
    j = jax_run[-1][0]
    pose = synthetic.orbit_pose(0.15, target=TARGET)
    cam2vol = jse3.compose(jse3.inverse(jkinfu._vol_pose(JC)), jnp.asarray(pose))
    jvol = jkinfu.TsdfVolume(*(jnp.asarray(a) for a in j.vol))
    res = jtsdf.raycast(JC, jvol, cam2vol, JC.intr, JC.rows, JC.cols)
    df = tkinfu.DynamicFusion(TC, device="cpu")
    df.state = interop.state_from_numpy(j, "cpu")
    for mode in (0, 3):
        got = df.render(mode, pose=pose)
        _check_image(jrender.render_maps(JC, res.points, res.normals, mode), got)
    img = df.render(0, pose=pose)
    over = trender.overlay_nodes(TC, img, df.state, pose=pose)
    ref = jrender.overlay_nodes(JC, np.asarray(img), j._replace(warp=jkinfu.WarpField(*map(jnp.asarray, j.warp))),
                                pose=pose)
    np.testing.assert_array_equal(over, ref)
    assert (over != img.numpy()).any()
