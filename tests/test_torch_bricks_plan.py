"""Parity of the port's brick plan (kernel K's plain version, on the CPU)
with the JAX package: the min/max/all-valid depth mip, the brick classes
with their band windows and surface flags, and the fusion's work list
(front bricks, then band bricks with the surface ones first and the rest
in the fixed permutation's order, then wide bricks; the caps and the
(band, wide, dropped) counts). At ``small()`` and at the dynamicfusion
preset's own grid (256^3 in 4 096 bricks of 16^3, 640x480 dists, 11 mip
levels, the caps 2 048 / 128) and at ``default_kinfu()``'s (512^3 in
32 768 bricks), which is cheap on the CPU.

Every pool and window is a min or a max and the float arithmetic runs in
the same order, so everything is held exactly. Inputs: the synthetic
sphere-and-plane scene with seeded noise and holes, and a camera-frame
grid (rigid, or with seeded jitter standing in for a warp), made with
numpy and handed to both packages."""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.ops import bricks as jbricks
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.ops import bricks as tbricks

SCENE = dict(
    spheres=[
        dict(center=(0.0, 0.0, 0.9), radius=0.2),
        dict(center=(0.25, 0.15, 1.0), radius=0.12),
        dict(center=(-0.22, 0.12, 0.85), radius=0.1),
        dict(center=(0.1, -0.2, 0.95), radius=0.1),
    ],
    plane_z=1.2,
)

# name: (config maker, overrides, grid stride (None: brick size), jitter (m), phase split, camera z shift (m))
CASES = {
    "small_rigid": ("small", {}, None, 0.0, 1, 0.0),
    "small_capped_warped": ("small", dict(integrate_band_cap=6, integrate_wide_cap=1, integrate_rect=16), 2, 2e-3, 1,
                            0.0),
    "preset_warped": ("default_dynamicfusion", {}, 8, 2e-3, 1, 0.0),
    "preset_rigid_split": ("default_dynamicfusion", dict(fusion_phase_split=2), None, 0.0, 2, 0.0),
    # the camera 0.3 m closer: the nearest bricks' footprints pass the band window (wide)
    "preset_capped_near": ("default_dynamicfusion", dict(integrate_band_cap=300, integrate_wide_cap=8), 8, 2e-3, 1,
                           0.3),
    # default_kinfu(): 512^3 over 3 m in 32 768 bricks of 16^3 (kernel K's
    # 32^3 brick grid), its own intrinsics, the warped grid at stride 8
    "kinfu_warped": ("default_kinfu", {}, 8, 2e-3, 1, 0.0),
}


def _configs(name):
    maker, kw = CASES[name][:2]
    return (dataclasses.replace(getattr(JCfg, maker)(), **kw), dataclasses.replace(getattr(TCfg, maker)(), **kw))


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(dists (H, W), cam_grid (G, G, G, 3), g) as numpy, seeded."""
    jc, _ = _configs(name)
    _, _, stride, jitter, _, near = CASES[name]
    g = stride or jc.brick_size
    pose = synthetic.orbit_pose(0.03, target=(0.0, 0.0, 0.9))
    pose[2, 3] += near
    depth = synthetic.scene_depth(jc.intr, jc.rows, jc.cols, pose, **SCENE)
    rng = np.random.RandomState(len(name))
    d = depth.astype(np.int32)
    d = np.where(d > 0, d + rng.randint(-4, 5, d.shape), 0)
    # sensor holes: a dropout region and a few scattered pixels (the rest of
    # the frame stays whole, so front bricks occur)
    h, w = d.shape
    d[h // 4 : h // 2, : w // 3] = 0
    d = np.where(rng.rand(*d.shape) < 2e-4, 0, d).astype(np.uint16)
    dists = np.asarray(jpre.compute_dists(jc.intr, jnp.asarray(d)))
    gp = jc.volume_dims // g + 1
    ax = np.arange(gp, dtype=np.float64) * g * jc.voxel_size
    world = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1) + np.asarray(jc.volume_origin)
    w2c = np.linalg.inv(pose)
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    cam = cam + jitter * rng.randn(*cam.shape)
    return dists.astype(np.float32), cam.astype(np.float32), g


def _jax_plan(jc, dists, cam, g, phase, split):
    """The JAX package's classification and its integrate_bricks work list
    (bricks.py:594-649), with the counts of :757-762."""
    rows, cols = dists.shape
    nbr = (jc.volume_dims // jc.brick_size) ** 3
    rect = min(jc.integrate_rect, 1 << int(math.log2(min(rows, cols))))
    levels = int(math.ceil(math.log2(max(rows, cols)))) + 1
    pyr = jbricks.build_depth_pyramid(jnp.asarray(dists), levels)
    bc = jbricks.classify(jc, jnp.asarray(cam), g, pyr, jc.intr, rows, cols, rect)
    cls = bc.cls
    if split > 1:
        nb_x = jc.volume_dims // jc.brick_size
        bx = jnp.arange(nbr, dtype=jnp.int32) // (nb_x * nb_x)
        cls = jnp.where((bx % split) == phase, cls, jbricks.SKIP)
    band_cap = min(max(jc.integrate_band_cap // split, 1), nbr)
    wide_cap = min(max(jc.integrate_wide_cap // split, 1), nbr)
    (front_ids,) = jnp.nonzero(cls == jbricks.FRONT, size=nbr, fill_value=nbr)
    band = cls == jbricks.BAND
    (ids_hi,) = jnp.nonzero(band & bc.surf, size=band_cap, fill_value=nbr)
    n_hi = jnp.minimum(jnp.sum(band & bc.surf), band_cap)
    perm = jbricks._brick_perm(nbr)
    lo_mask = jnp.take(band & ~bc.surf, perm)
    (ids_lo_p,) = jnp.nonzero(lo_mask, size=band_cap, fill_value=nbr)
    ids_lo = jnp.where(ids_lo_p < nbr, jnp.take(perm, jnp.minimum(ids_lo_p, nbr - 1)), nbr)
    slot = jnp.arange(band_cap)
    band_ids = jnp.where(slot < n_hi, ids_hi, jnp.take(ids_lo, jnp.clip(slot - n_hi, 0, band_cap - 1)))
    (wide_ids,) = jnp.nonzero(cls == jbricks.WIDE, size=wide_cap, fill_value=nbr)
    n_band = int(jnp.sum(band))
    n_wide = int(jnp.sum(cls == jbricks.WIDE))
    n_front = int(jnp.sum(cls == jbricks.FRONT))
    counts = [n_band, n_wide, max(n_band - band_cap, 0) + max(n_wide - wide_cap, 0)]
    # the port's one list: front, band, wide, then the fill
    n_b, n_w = min(n_band, band_cap), min(n_wide, wide_cap)
    ids = np.full(nbr, nbr, np.int64)
    kind = np.zeros(nbr, np.int64)
    parts = ((np.asarray(front_ids)[:n_front], jbricks.FRONT), (np.asarray(band_ids)[:n_b], jbricks.BAND),
             (np.asarray(wide_ids)[:n_w], jbricks.WIDE))
    at = 0
    for part, k in parts:
        ids[at:at + len(part)] = part
        kind[at:at + len(part)] = k
        at += len(part)
    return pyr, bc._replace(cls=cls), ids, kind, at, counts


@pytest.mark.parametrize("name", sorted(CASES))
def test_brick_plan_matches(name):
    jc, tc = _configs(name)
    dists, cam, g = _inputs(name)
    split = CASES[name][4]
    phase = 1 if split > 1 else None
    jpyr, jbc, jids, jkind, jcount, jcounts = _jax_plan(jc, dists, cam, g, phase, split)

    tpyr = tbricks.build_depth_pyramid(torch.from_numpy(dists), jpyr.levels)
    assert tpyr.offsets == jpyr.offsets and tpyr.widths == jpyr.widths
    for a in ("dmin", "dmax", "allvalid"):
        np.testing.assert_array_equal(np.asarray(getattr(jpyr, a)), getattr(tpyr, a).numpy(), err_msg=a)

    tphase = None if phase is None else torch.tensor(phase, dtype=torch.int32)
    bp = tbricks.plan(tc, torch.from_numpy(dists), torch.from_numpy(cam), g, tc.intr, tphase, split)
    for a in ("cls", "u0", "v0", "surf"):
        np.testing.assert_array_equal(np.asarray(getattr(jbc, a)), getattr(bp.classes, a).numpy(), err_msg=a)
    assert int(bp.work.count[0]) == jcount
    np.testing.assert_array_equal(bp.work.ids.numpy(), jids)
    np.testing.assert_array_equal(bp.work.kind.numpy(), jkind)
    assert bp.work.counts.tolist() == jcounts
    if "capped" in name:
        assert jcounts[2] > 0
    if name.startswith("preset"):
        assert jpyr.levels == 11 and bp.classes.cls.shape == (4096,)
    if name.startswith("kinfu"):
        assert jpyr.levels == 11 and bp.classes.cls.shape == (32768,) and jcount > 0


def test_cases_cover_every_class():
    """Across the cases every class occurs, at the preset size too."""
    seen, seen_preset = set(), set()
    for name in CASES:
        _, tc = _configs(name)
        dists, cam, g = _inputs(name)
        split = CASES[name][4]
        phase = torch.tensor(1, dtype=torch.int32) if split > 1 else None
        bp = tbricks.plan(tc, torch.from_numpy(dists), torch.from_numpy(cam), g, tc.intr, phase, split)
        found = set(np.unique(bp.classes.cls.numpy()).tolist())
        seen |= found
        if name.startswith("preset"):
            seen_preset |= found
    everything = {tbricks.SKIP, tbricks.FRONT, tbricks.BAND, tbricks.WIDE}
    assert seen == everything and seen_preset == everything
