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
    assert all(kernels.launches[k] > 0 for k in ("bilateral", "icp_reduce", "raycast", "fuse_bricks")), kernels.launches
    ref = kinfu.DynamicFusion(CFG, device="cpu")
    for d in DEPTHS:
        ref(d)
    assert bool(df.last_outputs.icp_ok)
    assert float((df.get_pose().cpu() - ref.get_pose()).abs().max()) <= 1e-3


# ---------------------------------------------------------------- the non-rigid slice

NR = dataclasses.replace(
    DynamicFusionConfig.small(), solver_linear="pcg", solver_linear_iters=12, fusion_incidence_weight=True,
    fusion_incidence_floor=0.35, fusion_sdf_incidence_scale=True, raycast_temporal_band=True,
)


NR_DEPTHS = synthetic.deforming_frames(NR.intr, NR.rows, NR.cols, 4)


@pytest.fixture
def nr_model(dev):
    """Plain-path non-rigid state after three frames on the card, and the
    next frame's solve structure and inputs."""
    from dynamicfusion_tpu_torch.solvers import warp_solver

    df = kinfu.DynamicFusion(NR, device=dev, plain=True)
    for d in NR_DEPTHS[:3]:
        df(d)
    st = df.state
    pts = torch.nan_to_num(st.can_points.reshape(-1, 3)) + 0.0
    live = kinfu.se3.transform_points(st.pose, st.prev_points[0]).reshape(-1, 3)
    nrm = kinfu.se3.rotate_dirs(st.pose, st.prev_normals[0]).reshape(-1, 3)
    can = kinfu.se3.transform_points(st.pose, st.can_points).reshape(-1, 3)
    inputs = warp_solver.WarpSolveInputs(can, can, live + 0.002 * nrm, nrm)
    return st, inputs, pts


def _close(a, b, rel):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) <= rel * scale


def test_knn_blend_kernels(dev, nr_model):
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import fusion

    st, inputs, _ = nr_model
    q = fusion.coarse_corner_points(NR, dev)
    k = warpfield.knn_blend(st.warp, q, 8, blend=True, warp=True)
    p = warpfield.knn_blend(st.warp, q, 8, blend=True, warp=True, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(k.idx, p.idx)
    assert float((k.d2 - p.d2).abs().max()) <= 1e-6
    for a, b in ((k.w, p.w), (k.blend, p.blend), (k.quality, p.quality), (k.points, p.points)):
        assert float((a - b).abs().max()) <= 1e-5
    pts = inputs.p_can
    nrm = inputs.n_live
    cf = fusion.coarse_field(NR, st.warp, plain=True)
    wk = fusion.warp_points_trilinear(NR, cf.dq, pts, nrm)
    wp = fusion.warp_points_trilinear(NR, cf.dq, pts, nrm, plain=True)
    for a, b in zip(wk, wp):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert float(torch.nan_to_num((a - b).abs()).max()) <= 1e-5
    ck, nk = warpfield.mutual_nearest(st.warp, pts, ~torch.isnan(pts[:, 0]))
    cp, np_ = warpfield.mutual_nearest(st.warp, pts, ~torch.isnan(pts[:, 0]), plain=True)
    assert torch.equal(ck, cp) and torch.equal(nk, np_)


def test_solver_kernels(dev, nr_model):
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    st, inputs, _ = nr_model
    s = ws.prepare(NR, st.warp, inputs)
    dk = ws.data_term(NR, s, st.warp.dq, True)
    dp = ws.data_term(NR, s, st.warp.dq, True, plain=True)
    torch.cuda.synchronize()
    assert _close(dk.jtr, dp.jtr, 1e-4) and _close(dk.blocks, dp.blocks, 1e-4) and _close(dk.cost, dp.cost, 1e-5)
    assert _close(dk.rows.float(), dp.rows.float(), 1e-2)
    ek = ws.edge_term(NR, s, st.warp.dq)
    ep = ws.edge_term(NR, s, st.warp.dq, plain=True)
    for a, b in zip(ek, ep):
        assert _close(a, b, 1e-5)
    blocks = dp.blocks + ep.diag + torch.diag_embed(torch.ones(st.warp.dq.shape[0], 6, device=dev))
    assert _close(ws.spd6_inv(blocks), ws.spd6_inv(blocks, plain=True), 1e-4)
    sysm = ws.System(dp.rows, ep, torch.ones(6 * st.warp.dq.shape[0], device=dev))
    pv = torch.randn(6 * st.warp.dq.shape[0], generator=torch.Generator().manual_seed(0)).to(dev)
    assert _close(ws.matvec(s, sysm, pv), ws.matvec(s, sysm, pv, plain=True), 1e-3)
    minv = ws.spd6_inv(blocks, plain=True)
    on = torch.ones((), dtype=torch.bool, device=dev)
    xk = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on)
    xp = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on, plain=True)
    assert _close(xk, xp, 1e-2)
    assert not bool(ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, ~on).any())


def test_insert_kernel(dev, nr_model):
    from dynamicfusion_tpu_torch.models import warpfield

    st, inputs, _ = nr_model
    half = torch.arange(st.warp.active.shape[0], device=dev) % 2 == 0
    field = st.warp._replace(active=st.warp.active & half, count=(st.warp.active & half).sum(dtype=torch.int32))
    cand = inputs.p_can + 0.03
    valid = ~torch.isnan(cand[:, 0])
    fi = torch.tensor(9, dtype=torch.int32, device=dev)
    k = warpfield.insert_nodes(NR, field, cand, valid, fi)
    p = warpfield.insert_nodes(NR, field, cand, valid, fi, plain=True)
    torch.cuda.synchronize()
    assert int(k.count) > int(field.count)
    for name, a, b in zip(warpfield.WarpField._fields, k, p):
        if a.dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-5, name
        else:
            assert torch.equal(a, b), name


def test_fuse_kernel_nonrigid(dev, nr_model):
    from dynamicfusion_tpu_torch.ops import fusion

    st, _, _ = nr_model
    depth = torch.from_numpy(NR_DEPTHS[3]).to(dev)
    _, pts, nrm, dists = preprocess.build_frame_pyramid(NR, depth)
    conf = kinfu.incidence_confidence(pts[0], nrm[0])
    cf = fusion.coarse_field(NR, st.warp, plain=True)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    w2c = se3.inverse(st.pose)
    vk = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    vp = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    ck = fusion.integrate_nonrigid(NR, vk, cf, dists, w2c, NR.intr, ok, conf=conf)
    cp = fusion.integrate_nonrigid(NR, vp, cf, dists, w2c, NR.intr, ok, conf=conf, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp)
    # codes differing by more than 1 LSB on < 1e-4 of voxels, weights within
    # 1 LSB: on CUDA tensors PyTorch divides by a Python scalar as a product
    # with its reciprocal, so the plain version's unpacked depth and
    # confidence may differ from the kernel's true quotients in the last bit
    dt = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    dw = (vk.weight.to(torch.int32) - vp.weight.to(torch.int32)).abs()
    assert float((dt > 1).float().mean()) < 1e-4 and int(dw.max()) <= 1
    assert not torch.equal(vk.tsdf, st.vol.tsdf)


def test_nonrigid_slice_on_the_card_goes_through_every_kernel(dev):
    kernels.reset_launches()
    df = kinfu.DynamicFusion(NR, device=dev)
    for d in NR_DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    # small() is below the full-scale branches: the trilinear map warp does not run
    path = [k for k in kernels.KERNELS if k not in ("matvec", "warp_trilinear")]
    assert all(kernels.launches[k] > 0 for k in path), kernels.launches
    ref = kinfu.DynamicFusion(NR, device="cpu")
    for d in NR_DEPTHS:
        ref(d)
    assert bool(df.last_outputs.icp_ok)
    assert float(df.last_outputs.solver_cost1) <= float(df.last_outputs.solver_cost0)
    # twice the JAX package's own third-step spread at small() under a 1e-7
    # perturbation of its node positions (1.4e-3 m, 4.1e-3 rotation entry;
    # tests/torch_nonrigid_cases.py): a last bit moves the bf16 LM step
    a, b = df.get_pose().cpu(), ref.get_pose()
    assert float((a[:3, 3] - b[:3, 3]).abs().max()) <= 3e-3
    assert float((a[:3, :3] - b[:3, :3]).abs().max()) <= 8e-3
