"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one. On a machine with
a card (and without JAX, which this file does not import) run

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Small shapes (the ``small()`` preset); ``chip_smoke.py`` holds the kernels
at the full slice's shapes.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.io import synthetic
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.ops import bricks, preprocess, tsdf
from dynamicfusion_tpu_torch.pipeline import kinfu
from dynamicfusion_tpu_torch.solvers import icp

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(
    DynamicFusionConfig.small(dims=64, rows=120, cols=160), max_nodes=64, node_sample_step=17, rigid_only=True
)
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
DEPTHS = [
    synthetic.scene_depth(CFG.intr, CFG.rows, CFG.cols, synthetic.orbit_pose(a, target=TARGET), **SCENE)
    for a in ANGLES
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def model(dev):
    """Plain-path state after three frames on the card."""
    df = kinfu.DynamicFusion(CFG, device=dev, plain=True)
    for d in DEPTHS[:3]:
        df(d)
    return df.state


def test_bilateral_kernel(dev):
    rng = np.random.RandomState(0)
    d = DEPTHS[0].astype(np.int32)
    d = torch.from_numpy(np.where(d > 0, d + rng.randint(-6, 7, d.shape), 0).astype(np.uint16)).to(dev)
    got = preprocess.bilateral_filter(d).to(torch.int32)
    ref = preprocess.bilateral_filter_plain(d).to(torch.int32)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    # exact but for a half-millimetre tie that an ulp of expf flips
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


def test_icp_kernel(dev, model):
    _, pts, nrm, _ = preprocess.build_frame_pyramid(CFG, torch.from_numpy(DEPTHS[3]).to(dev), CFG.raycast_shift)
    lvl = CFG.raycast_shift
    args = (CFG.intr.level(lvl), torch.eye(4, device=dev), pts[lvl], nrm[lvl], model.prev_points[0],
            model.prev_normals[0], CFG.icp_dist_thres ** 2, math.cos(CFG.icp_angle_thres))
    a, b = icp._build_system(*args)
    a0, b0 = icp._build_system(*args, plain=True)
    scale = float(a0.abs().max())
    assert float((a - a0).abs().max()) <= 1e-5 * scale
    assert float((b - b0).abs().max()) <= 1e-5 * max(float(b0.abs().max()), 1.0)
    # an inactive iteration does no work and returns zeros
    a_off, b_off = kernels.icp_build_system(*args, active=torch.zeros((), dtype=torch.bool, device=dev))
    assert not bool(a_off.any()) and not bool(b_off.any())


def test_raycast_kernel(dev, model):
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(CFG, dev)), model.pose)
    rows, cols = CFG.rows // CFG.raycast_subsample, CFG.cols // CFG.raycast_subsample
    rays = tsdf.rays(CFG, cam2vol, CFG.intr.level(CFG.raycast_shift), rows, cols)
    fk, vk, nk = tsdf.march_and_refine(CFG, model.vol.tsdf, *rays)
    fp, vp, np_ = tsdf.march_and_refine(CFG, model.vol.tsdf, *rays, plain=True)
    assert torch.equal(fk, fp) and float(fk.float().mean()) > 0.3
    assert float((vk - vp)[fk].abs().max()) <= 1e-5
    assert float(torch.nan_to_num((nk - np_)[fk].abs()).max()) <= 1e-5


@pytest.mark.parametrize("ok", [True, False])
def test_fuse_kernel(dev, model, ok):
    dists = preprocess.compute_dists(CFG.intr, torch.from_numpy(DEPTHS[3]).to(dev))
    vol2cam = se3.compose(se3.inverse(model.pose), kinfu._vol_pose(CFG, dev))
    grid = tsdf.brick_grid(CFG, vol2cam)
    bp = bricks.plan(CFG, dists, grid, CFG.brick_size, CFG.intr)
    ok_t = torch.tensor(ok, device=dev)
    vk = TsdfVolume(model.vol.tsdf.clone(), model.vol.weight.clone())
    vp = TsdfVolume(model.vol.tsdf.clone(), model.vol.weight.clone())
    bricks.fuse(CFG, vk, dists, grid, CFG.brick_size, CFG.intr, bp, ok_t)
    bricks.fuse(CFG, vp, dists, grid, CFG.brick_size, CFG.intr, bp, ok_t, plain=True)
    dt = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    assert int(dt.max()) <= 1 and float((dt > 0).float().mean()) <= 1e-4
    assert torch.equal(vk.weight.to(torch.int32), vp.weight.to(torch.int32))
    if not ok:
        assert torch.equal(vk.tsdf, model.vol.tsdf)


def test_slice_on_the_card_goes_through_every_kernel(dev):
    kernels.reset_launches()
    df = kinfu.DynamicFusion(CFG, device=dev)
    for d in DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    assert all(n > 0 for n in kernels.launches.values()), kernels.launches
    ref = kinfu.DynamicFusion(CFG, device="cpu")
    for d in DEPTHS:
        ref(d)
    assert bool(df.last_outputs.icp_ok)
    assert float((df.get_pose().cpu() - ref.get_pose()).abs().max()) <= 1e-3
