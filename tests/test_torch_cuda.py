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

from chip_smoke import (EXTRACT_CASES, INSERT_CASES, MUTUAL_CASES, PLAN_CASES, border_frame, extract_block_cut,
                        extract_case, plan_inputs)
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
    """Kernel A (the tiled filter) against the plain version, and bit for
    bit against its reference mode on a noisy frame and on one whose depth
    edges and holes cross all four borders, at 7x7 and 5x5."""
    rng = np.random.RandomState(0)
    d = DEPTHS[0].astype(np.int32)
    d = torch.from_numpy(np.where(d > 0, d + rng.randint(-6, 7, d.shape), 0).astype(np.uint16)).to(dev)
    got = preprocess.bilateral_filter(d).to(torch.int32)
    ref = preprocess.bilateral_filter_plain(d).to(torch.int32)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    # exact but for a half-millimetre tie that an ulp of expf flips
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    border = torch.from_numpy(border_frame(CFG.rows, CFG.cols, 4)).to(dev)
    for frame in (d, border):
        for size in (7, 5):
            tiled = preprocess.bilateral_filter(frame, size)
            assert torch.equal(tiled, preprocess.bilateral_filter(frame, size, reference=True))


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


def test_icp_kernel_one_launch_is_two_pass(dev, model):
    """Kernel B's one launch bit for bit against its two-pass mode (the
    same order of sums), at the tracking level and at level 0 against the
    model maps, at the identity and at a small twist; an inactive call
    writes zeros and every call leaves the device's ticket at zero."""
    _, pts, nrm, _ = preprocess.build_frame_pyramid(CFG, torch.from_numpy(DEPTHS[3]).to(dev))
    twist = se3.exp_twist(torch.tensor([0.003, -0.002, 0.001, 0.004, 0.002, -0.003], device=dev)).contiguous()
    for lvl in (CFG.raycast_shift, 0):
        for t in (torch.eye(4, device=dev), twist):
            args = (CFG.intr.level(lvl), t, pts[lvl], nrm[lvl], model.prev_points[0], model.prev_normals[0],
                    CFG.icp_dist_thres ** 2, math.cos(CFG.icp_angle_thres))
            n0 = kernels.launches["icp_reduce"]
            a, b = kernels.icp_build_system(*args)
            a2, b2 = kernels.icp_build_system(*args, two_pass=True)
            off = kernels.icp_build_system(*args, active=torch.zeros((), dtype=torch.bool, device=dev))
            torch.cuda.synchronize()
            assert kernels.launches["icp_reduce"] == n0 + 3
            assert torch.equal(a.view(torch.int32), a2.view(torch.int32)) and torch.equal(a, a.T)
            assert torch.equal(b.view(torch.int32), b2.view(torch.int32))
            assert not bool(off[0].any()) and not bool(off[1].any())
            assert int(kernels._ticket(t.device)) == 0
            a0, _ = icp._build_system(*args, plain=True)
            assert float((a - a0).abs().max()) <= 1e-4 * float(a0.abs().max())


@pytest.mark.parametrize("refine", ["secant", "newton8"])
def test_raycast_kernel(dev, model, refine):
    cfg = dataclasses.replace(CFG, raycast_refine=refine)
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), model.pose)
    rows, cols = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    rays = tsdf.rays(cfg, cam2vol, cfg.intr.level(cfg.raycast_shift), rows, cols)
    before = kernels.launches["raycast"]
    fk, vk, nk = tsdf.march_and_refine(cfg, model.vol.tsdf, *rays)
    fp, vp, np_ = tsdf.march_and_refine(cfg, model.vol.tsdf, *rays, plain=True)
    assert kernels.launches["raycast"] == before + 1
    assert torch.equal(fk, fp) and float(fk.float().mean()) > 0.3
    assert float((vk - vp)[fk].abs().max()) <= 1e-5
    assert float(torch.nan_to_num((nk - np_)[fk].abs()).max()) <= 1e-5


def test_preprocess_kernels(dev):
    """Kernel I against its plain versions on the card. The pyramid and the
    resize are exact (sums of whole millimetres; the same sum order); the
    dists, points and normals may differ in the last bits, since CUDA
    PyTorch divides by a Python scalar as a product with its reciprocal
    where the kernel divides (as the JAX package does): dists 1e-6
    relative, points 1e-6 m, normals and confidence 1e-4 on all but 1e-3 of
    the valid pixels (a normal amplifies its points' last bits)."""
    rng = np.random.RandomState(3)
    d = DEPTHS[1].astype(np.int32)
    d = np.where(d > 0, d + rng.randint(-4, 5, d.shape), 0)
    d = torch.from_numpy(np.where(rng.rand(*d.shape) < 0.02, 0, d).astype(np.uint16)).to(dev)
    dk = preprocess.compute_dists(CFG.intr, d)
    dp = preprocess.compute_dists(CFG.intr, d, plain=True)
    assert float(((dk - dp).abs() / dp.clamp(min=1e-6)).max()) <= 1e-6
    dists, trunc = kernels.depth_dists(d, CFG.intr, d, 0.95)
    assert torch.equal(dists, dk)
    assert torch.equal(trunc.to(torch.int32), preprocess.truncate_depth(d, 0.95).to(torch.int32))
    lvl = d
    for _ in range(3):
        nk = preprocess.depth_pyramid_down(lvl, CFG.bilateral_sigma_depth)
        np_ = preprocess.depth_pyramid_down(lvl, CFG.bilateral_sigma_depth, plain=True)
        assert torch.equal(nk.to(torch.int32), np_.to(torch.int32))
        lvl = nk
    for stride in (1, 2):
        pk, nk, ck = kernels.points_normals(d, CFG.intr, stride, conf=True)
        pp, npl = preprocess.compute_points_normals(CFG.intr, d, stride=stride, plain=True)
        cp = preprocess.incidence_confidence(pp, npl)
        valid = ~torch.isnan(pp[..., 0])
        assert torch.equal(torch.isnan(pk), torch.isnan(pp)) and torch.equal(torch.isnan(nk), torch.isnan(npl))
        assert float(valid.float().mean()) > 0.5
        assert float((pk - pp)[valid].abs().max()) <= 1e-6
        assert float(((nk - npl)[valid].abs().amax(-1) > 1e-4).float().mean()) <= 1e-3
        assert float(((ck - cp).abs() > 1e-4).float().mean()) <= 1e-3
    pts, nrm = pk.contiguous(), nk.contiguous()
    rk = preprocess.resize_points_normals(pts, nrm)
    rp = preprocess.resize_points_normals(pts, nrm, plain=True)
    for a, b in zip(rk, rp):
        assert torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _map_task_sets(dev):
    """Kernel I's multi-map task sets at small(): the non-rigid step's
    (``kinfu.track_maps``), the rigid step's, shift 0's, the depth ICP's
    eight, widths that are no multiple of the pixels a thread, and every
    output alone."""
    from dynamicfusion_tpu_torch.solvers import icp as icp_

    rng = np.random.RandomState(4)
    d = DEPTHS[2].astype(np.int32)
    d = torch.from_numpy(np.where(d > 0, d + rng.randint(-4, 5, d.shape), 0).astype(np.uint16)).to(dev)
    sets = {}
    for name, cfg, maps in (("nonrigid", NR, kinfu.track_maps(NR)), ("rigid", CFG, dict(first_point_level=2)),
                            ("shift0", CFG, dict(first_point_level=0, with_conf=True, raw=(CFG.intr, 1)))):
        pyr = preprocess.build_frame_pyramid(cfg, d, **maps)
        sets[name] = preprocess.pyramid_map_tasks(cfg, pyr[0], d, **maps)[0]
    pyr = preprocess.build_frame_pyramid(CFG, d)
    sets["depth_icp"] = icp_.depth_map_tasks(CFG, pyr[0], pyr[0])
    odd = torch.from_numpy(np.where(rng.rand(37, 53) < 0.1, 0, rng.randint(400, 3000, (37, 53))).astype(np.uint16))
    odd = odd.to(dev)
    sets["odd"] = [kernels.MapTask(odd, CFG.intr, s, conf=True) for s in (1, 2, 3)] + [
        kernels.MapTask(odd[:8, :6].contiguous(), CFG.intr, 1, conf=True)]
    sets["alone"] = [kernels.MapTask(d, CFG.intr, s, points=o == 0, normals=o == 1, conf=o == 2)
                     for s in (1, 4) for o in range(3)]
    return sets


@pytest.mark.parametrize("name", ["nonrigid", "rigid", "shift0", "depth_icp", "odd", "alone"])
def test_frame_maps_is_the_single_map_kernel(dev, name):
    """Kernel I's multi-map entry bit for bit (NaNs alike) against the
    single-map kernel at every task, one device kernel a call."""
    tasks = _map_task_sets(dev)[name]
    before = kernels.device_kernels["frame_maps"]
    outs = kernels.frame_maps(tasks)
    assert kernels.device_kernels["frame_maps"] == before + 1
    for t, got in zip(tasks, outs):
        ref = kernels.points_normals(t.depth, t.intr, t.stride, normals=t.normals, conf=t.conf)
        assert (_same_bits(got[0], ref[0]) if t.points else got[0] is None)
        assert _same_bits(got[1], ref[1]) and _same_bits(got[2], ref[2])


def test_frame_maps_past_one_launch(dev):
    """More than MAP_TASKS tasks take one launch more, with the same maps."""
    tasks = _map_task_sets(dev)["alone"] * 2
    assert len(tasks) > kernels.MAP_TASKS
    before = kernels.device_kernels["frame_maps"]
    outs = kernels.frame_maps(tasks)
    assert kernels.device_kernels["frame_maps"] == before + 2
    for a, b in zip(outs[: len(tasks) // 2], outs[len(tasks) // 2:]):
        assert all(_same_bits(x, y) for x, y in zip(a, b))


def _damped_case(dev, n, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, 6, 6).astype(np.float32)
    blocks = torch.from_numpy(a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)).to(dev)
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws
    diag_eff, unit = ws.damping_terms(NR, torch.from_numpy(rng.rand(n) > 0.1).to(dev), blocks)
    return blocks, diag_eff, unit


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1024])
@pytest.mark.parametrize("rebuild", [True, False])
def test_spd6_inv_damped_is_the_composition(dev, n, rebuild):
    """Kernel G's damped entry bit for bit (NaNs alike) against the
    composition it replaced in the LM loop (the damping, the reference
    mode's inverse of blocks + diag_embed(damp), where), one device kernel
    a call; its undamped entry against the reference mode."""
    blocks, diag_eff, unit = _damped_case(dev, n)
    lm = torch.full((), 0.37, device=dev)
    flag = torch.full((), rebuild, dtype=torch.bool, device=dev)
    last = kernels.spd6_inv(blocks, reference=True)
    minv = last.clone()
    before = kernels.device_kernels["spd6_inv"]
    damp = kernels.spd6_inv_damped(blocks, diag_eff, unit, lm, flag, minv)
    assert kernels.device_kernels["spd6_inv"] == before + 1
    ref_damp = lm * diag_eff + unit
    fresh = kernels.spd6_inv(blocks + torch.diag_embed(ref_damp.reshape(n, 6)), reference=True)
    assert _same_bits(damp, ref_damp) and _same_bits(minv, torch.where(flag, fresh, last))
    m = blocks + torch.diag_embed(ref_damp.reshape(n, 6))
    assert _same_bits(kernels.spd6_inv(m), kernels.spd6_inv(m, reference=True))


def test_coarse_band_kernel(dev, model):
    """Kernel J's coarse band equals its plain version bit for bit, from the
    coarse march of the slice's volume at a quarter of 160x120 and at the
    reference resolution's 160x120 coarse grid of the same volume."""
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(CFG, dev)), model.pose)
    for rows, cols in ((120, 160), (480, 640)):
        intr = CFG.intr if rows == CFG.rows else DynamicFusionConfig.small(rows=rows, cols=cols).intr
        coarse = tsdf.raycast(CFG, model.vol, cam2vol, intr.level(2), rows // 4, cols // 4, plain=True)
        before = kernels.launches["coarse_band"]
        lo, hi = kernels.coarse_band(coarse.points.contiguous(), 4, CFG.raycast_band_margin)
        plo, phi = tsdf.coarse_band_plain(coarse.points, 4, CFG.raycast_band_margin)
        torch.cuda.synchronize()
        assert kernels.launches["coarse_band"] == before + 1
        assert lo.shape == (rows, cols)
        assert torch.equal(lo, plo) and torch.equal(hi, phi)
        assert bool((hi > lo).any()) and bool((hi == 0).any())


def _gate_field(dev, h=120, w=160, seed=7):
    """A random gate input: depths over every bin, unit normals, motions,
    holes; and a translating sphere over a plane."""
    rng = np.random.RandomState(seed)
    u, v = np.meshgrid(np.arange(w) - w / 2, np.arange(h) - h / 2)
    f = 570.342 / 4
    z = rng.uniform(0.1, 2.2, (h, w))
    z[rng.rand(h, w) < 0.05] = np.nan
    prev = np.stack([u / f * z, v / f * z, z], -1)
    nrm = rng.randn(h, w, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[rng.rand(h, w) < 0.03] = np.nan
    live = prev + rng.normal(0, 0.004, (h, w, 3))
    def on_card(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in arrays)

    out = [on_card(live, nrm, prev, live[..., 2])]
    r, z0 = 0.12, 0.9
    x, y = u * z0 / f, v * z0 / f
    on = x * x + y * y < (r * 0.95) ** 2
    zs = z0 - np.sqrt(np.maximum(r * r - x * x - y * y, 1e-9))
    pts = np.stack([x, y, np.where(on, zs, 1.3)], -1)
    n = np.where(on[..., None], np.stack([x / r, y / r, (zs - z0) / r], -1), np.array([0.0, 0.0, -1.0]))
    live = pts + np.where(on[..., None], np.array([0.005, 0.0, 0.0]), 0.0)
    out.append(on_card(live, n, pts, live[..., 2]))
    return out


def test_p2p_gate_kernel(dev):
    """Kernel M: the gate and the depth bins equal the plain version's bit
    for bit (the same sums in the same order, the closed form under
    -fmad=false with true divisions)."""
    cfg = DynamicFusionConfig.quality_dynamicfusion()
    opened = 0
    for inputs in _gate_field(dev):
        before = kernels.launches["p2p_gate"]
        gk = kinfu.p2p_gate(cfg, *inputs)
        gp = kinfu.p2p_gate(cfg, *inputs, plain=True)
        _, bins = kinfu.p2p_gate_kernel(cfg, *inputs)
        torch.cuda.synchronize()
        assert kernels.launches["p2p_gate"] == before + 2
        assert torch.equal(bins.long(), kinfu.gate_bins(inputs[3]))
        assert torch.equal(gk, gp)
        opened += int((gk > 0).sum())
    assert opened > 0  # the translating sphere opens the gate


def test_bands_kernel(dev, model):
    """Kernel J: band and seed equal the plain versions bit for bit."""
    cfg = dataclasses.replace(CFG, raycast_temporal_band=True, raycast_seed_margin=0.1)
    dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(DEPTHS[3]).to(dev))
    seed, (lo, hi) = kinfu._march_bands(cfg, model.can_points, dists)
    assert torch.equal(seed, kinfu._raycast_seed(cfg, dists))
    plo, phi = kinfu._temporal_band(cfg, model.can_points, dists)
    assert torch.equal(lo, plo) and torch.equal(hi, phi) and bool((hi > lo).any())


@pytest.mark.parametrize("warped", [False, True])
def test_brick_plan_kernel(dev, model, warped):
    """Kernel K: the mip, classes, windows, surface flags and work list
    equal the plain version's bit for bit; ``warped`` uses a jittered
    coarse grid (stride 2) and a phase split."""
    dists = preprocess.compute_dists(CFG.intr, torch.from_numpy(DEPTHS[3]).to(dev))
    vol2cam = se3.compose(se3.inverse(model.pose), kinfu._vol_pose(CFG, dev))
    cfg, g, phase, split = CFG, CFG.brick_size, None, 1
    grid = tsdf.brick_grid(cfg, vol2cam)
    if warped:
        cfg = dataclasses.replace(CFG, brick_size=16, integrate_band_cap=20, integrate_wide_cap=2)
        g, split = 2, 2
        phase = torch.ones((), dtype=torch.int32, device=dev)
        d = cfg.volume_dims
        ax = torch.arange(d // g + 1, dtype=torch.float32, device=dev) * (g * cfg.voxel_size)
        pts = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
        grid = se3.transform_points(vol2cam, pts)
        grid = (grid + 2e-3 * torch.from_numpy(np.random.RandomState(4).randn(*grid.shape).astype(np.float32)).to(dev)).contiguous()
    bk = bricks.plan(cfg, dists, grid, g, cfg.intr, phase, split)
    bp = bricks.plan(cfg, dists, grid, g, cfg.intr, phase, split, plain=True)
    for a, b in zip(bk.classes, bp.classes):
        assert torch.equal(a, b)
    for a, b in zip(bk.work, bp.work):
        assert torch.equal(a, b)
    assert int(bk.work.count[0]) > 0
    rows, cols = dists.shape
    levels = int(math.ceil(math.log2(max(rows, cols)))) + 1
    (mk, xk, ak), _, _ = kernels.brick_plan(
        dists, grid, cfg.brick_size, g, cfg.intr, bk.rect, 0.04, 1e-3, levels,
        bricks._brick_perm_on(bk.classes.cls.shape[0], dev), 8, 2,
    )
    pyr = bricks.build_depth_pyramid(dists, levels)
    assert torch.equal(mk, pyr.dmin) and torch.equal(xk, pyr.dmax) and torch.equal(ak, pyr.allvalid)


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


@pytest.mark.parametrize("storage", [("i16", "u16"), ("i16", "f32"), ("f32", "u16"), ("f32", "f32"), ("bf16", "u16"),
                                     ("bf16", "f32")], ids=lambda s: "-".join(s))
@pytest.mark.parametrize("max_points", [1 << 16, 700, "block"])
def test_extract_kernel(dev, model, max_points, storage):
    """Kernel L (the row listing): the cloud (points, flags, uncapped
    count) equals its plain version and its reference mode bit for bit at
    every storage pair, capped or not (``block``: a cap inside one block's
    run), two device kernels a call; the node sampling equals its plain
    version."""
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.models import warpfield

    cfg = dataclasses.replace(CFG, tsdf_dtype=storage[0], weight_dtype=storage[1])
    vol = volume_model.convert(model.vol, cfg)
    if max_points == "block":
        max_points = extract_block_cut(torch, cfg, vol)
    before = kernels.device_kernels["extract_cloud"]
    ck = tsdf.extract_cloud(cfg, vol, max_points, min_weight=1.0)
    assert kernels.device_kernels["extract_cloud"] == before + 2
    cr = tsdf.extract_cloud(cfg, vol, max_points, min_weight=1.0, reference=True)
    cp = tsdf.extract_cloud(cfg, vol, max_points, min_weight=1.0, plain=True)
    torch.cuda.synchronize()
    assert int(cp.count) > 700
    for other in (cp, cr):
        assert torch.equal(ck.count, other.count) and torch.equal(ck.valid, other.valid)
        assert torch.equal(torch.isnan(ck.points), torch.isnan(other.points))
        assert torch.equal(torch.nan_to_num(ck.points), torch.nan_to_num(other.points))
    fk = warpfield.init_from_cloud(cfg, cp.points, cp.valid)
    fp = warpfield.init_from_cloud(cfg, cp.points, cp.valid, plain=True)
    for name, a, b in zip(warpfield.WarpField._fields, fk, fp):
        assert torch.equal(a, b), name
    # every valid candidate of the (capped) cloud, up to the node capacity
    assert int(fk.count) == min(cfg.max_nodes, int(cp.valid[:: cfg.node_sample_step].sum())) > 0


@pytest.mark.parametrize("case", sorted(EXTRACT_CASES))
def test_extract_kernel_edge_values(dev, case):
    """Kernel L on ``chip_smoke.EXTRACT_CASES`` (edge codes and values,
    weights at the threshold): bit-equal to its plain version and its
    reference mode, uncapped and at half the count."""
    cfg, vol = extract_case(torch, dev, case)
    n = int(tsdf.extract_cloud(cfg, vol, 1, min_weight=1.0, plain=True).count)
    assert n > 1000
    for max_points in (n + 100, n // 2 + 1):
        ck = tsdf.extract_cloud(cfg, vol, max_points, min_weight=1.0)
        for other in (tsdf.extract_cloud(cfg, vol, max_points, min_weight=1.0, plain=True),
                      tsdf.extract_cloud(cfg, vol, max_points, min_weight=1.0, reference=True)):
            assert torch.equal(ck.count, other.count) and torch.equal(ck.valid, other.valid)
            assert _same_map(ck.points, other.points)


def test_slice_on_the_card_goes_through_every_kernel(dev):
    kernels.reset_launches()
    df = kinfu.DynamicFusion(CFG, device=dev)
    for d in DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    rigid = ("bilateral", "icp_reduce", "raycast", "fuse_bricks", "depth_dists", "pyramid_down", "frame_maps",
             "resize_maps", "brick_plan")
    assert all(kernels.launches[k] > 0 for k in rigid), kernels.launches
    # kernel I's maps: one launch a step, the single-map kernel on no path
    assert kernels.launches["frame_maps"] == len(DEPTHS) - 1 and kernels.launches["points_normals"] == 0
    ref = kinfu.DynamicFusion(CFG, device="cpu")
    for d in DEPTHS:
        ref(d)
    assert bool(df.last_outputs.icp_ok)
    assert float((df.get_pose().cpu() - ref.get_pose()).abs().max()) <= 1e-3


# ---------------------------------------------------------------- the non-rigid slice

NR = dataclasses.replace(
    DynamicFusionConfig.small(), solver_linear="pcg", solver_linear_iters=12, fusion_incidence_weight=True,
    fusion_incidence_floor=0.35, fusion_sdf_incidence_scale=True, raycast_temporal_band=True, raycast_refine="newton8",
)


NR_DEPTHS = synthetic.deforming_frames(NR.intr, NR.rows, NR.cols, 4)
# the direct solve's kernels (N, O) and its factor; the PCG presets do not run them
DENSE = ("gram_scales", "dense_gram", "dense_damp", "cholesky")
# the kernels no preset's frame step runs: those of options that no preset
# turns on, the adaptive node radius (E's radius entry), the dense-matrix
# PCG (P), the net rigid removal (Q) and the dense fusion (F1, F2), the
# export path's extracted normals (R), and the sharded step's distributed
# PCG (G's cluster launch of the solve); and the reference modes that no
# path asks for: kernel I's single-map entry (of its frame maps) and the
# distributed PCG's composition (G's data-only matvec and step, P's init)
SHARDED = ("pcg_sharded",)
SHARDED_REFERENCE = ("data_matvec", "pcg_init", "pcg_step")
OPTIONS = ("node_radius", "dense_pcg", "net_rigid", "integrate_dense", "integrate_dense_nonrigid",
           "extract_normals", "points_normals") + SHARDED + SHARDED_REFERENCE


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


def test_solver_kernels_tangential(dev, nr_model):
    """Kernels F and G with the tangential rows (three a point) against
    their plain versions: the data term, one matvec and the PCG."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = dataclasses.replace(NR, solver_p2p_weight=0.25)
    st, inputs, _ = nr_model
    n = st.warp.dq.shape[0]
    s = ws.prepare(cfg, st.warp, inputs)
    dk = ws.data_term(cfg, s, st.warp.dq, True)
    dp = ws.data_term(cfg, s, st.warp.dq, True, plain=True)
    torch.cuda.synchronize()
    assert dk.rows.shape == dp.rows.shape == (s.p_can.shape[0], 3, 8, 6)
    assert _close(dk.jtr, dp.jtr, 1e-4) and _close(dk.blocks, dp.blocks, 1e-4) and _close(dk.cost, dp.cost, 1e-5)
    assert _close(dk.rows.float(), dp.rows.float(), 1e-2)
    ev = ws.data_term(cfg, s, st.warp.dq, False)
    assert _close(ev.jtr, dp.jtr, 1e-4) and ev.rows is None
    ep = ws.edge_term(cfg, s, st.warp.dq, plain=True)
    blocks = dp.blocks + ep.diag + torch.diag_embed(torch.ones(n, 6, device=dev))
    sysm = ws.System(dp.rows, ep, torch.ones(6 * n, device=dev))
    pv = torch.randn(6 * n, generator=torch.Generator().manual_seed(0)).to(dev)
    assert _close(ws.matvec(s, sysm, pv), ws.matvec(s, sysm, pv, plain=True), 1e-3)
    minv = ws.spd6_inv(blocks, plain=True)
    on = torch.ones((), dtype=torch.bool, device=dev)
    xk = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on)
    xp = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on, plain=True)
    assert _close(xk, xp, 1e-2)


@pytest.mark.parametrize("copies", [1, 5])
def test_insert_kernel(dev, nr_model, copies):
    """Kernel H's insertion; with five shifted copies of the candidates
    (past 16 384 of them)."""
    from dynamicfusion_tpu_torch.models import warpfield

    st, inputs, _ = nr_model
    half = torch.arange(st.warp.active.shape[0], device=dev) % 2 == 0
    field = st.warp._replace(active=st.warp.active & half, count=(st.warp.active & half).sum(dtype=torch.int32))
    cand = torch.cat([inputs.p_can + 0.03 * (c + 1) for c in range(copies)])
    assert (cand.shape[0] > 16384) == (copies > 1)
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


@pytest.mark.parametrize("name", INSERT_CASES)
@pytest.mark.parametrize("nc, cap", [(600, 64), (4800, 1024), (4800, 2048)])
def test_insert_select_kernel_adversarial(dev, name, nc, cap):
    """Kernel H's select bit for bit against the plain select on the
    adversarial cases (``chip_smoke.insert_case``), the table in shared
    and in device memory; past 1 024 slots the kept keys sort in shared
    memory, not in registers."""
    from chip_smoke import insert_case, select_inputs
    from dynamicfusion_tpu_torch.models import warpfield

    cfg, field, cand, valid, d2, gate = select_inputs(torch, insert_case(name, nc, cap), dev)
    ref = warpfield._insert_select_plain(cfg, field, cand, valid, d2, gate)
    for device_table in (False, True):
        kept = torch.zeros((), dtype=torch.int32, device=dev)
        slots, new_pos = kernels.insert_select(cand, d2, valid, field.active, field.count, gate, cfg.node_coverage,
                                               device_table=device_table, kept=kept)
        torch.cuda.synchronize()
        assert kernels.insert_plan(nc, cap, device_table, dev)[1] == device_table
        assert int(kept) > 0
        assert torch.equal(slots, ref.slots)
        assert torch.equal(new_pos.view(torch.int32), ref.new_pos.view(torch.int32))


def test_edge_term_one_launch_is_three_launch(dev, nr_model):
    """Kernel G's edge term in one launch within 1e-5 of the plain version
    and bit for bit against the three-launch mode in all six outputs; one
    device kernel a call, three in that mode; the ticket back at zero."""
    from chip_smoke import edge_args
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    st, inputs, _ = nr_model
    s = ws.prepare(NR, st.warp, inputs)
    args = edge_args(NR, s, st.warp.dq)
    k0 = kernels.device_kernels["edge_term"]
    one = kernels.edge_term(*args)
    k1 = kernels.device_kernels["edge_term"]
    three = kernels.edge_term(*args, three_launch=True)
    assert (k1 - k0, kernels.device_kernels["edge_term"] - k1) == (1, 3)
    plain = ws.edge_term(NR, s, st.warp.dq, plain=True)
    torch.cuda.synchronize()
    for a, b, c in zip(one, three, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert _close(a, c, 1e-5)
    assert int(kernels._ticket(dev)) == 0


@pytest.mark.parametrize("name", MUTUAL_CASES)
@pytest.mark.parametrize("nc, n", [(300, 96), (4800, 1024)])
def test_mutual_nearest_kernel_adversarial(dev, name, nc, n):
    """Kernel E's mutual-nearest pass in one launch bit for bit against the
    plain version and the three-launch mode on the adversarial cases
    (``chip_smoke.mutual_case``); one device kernel a call, three in that
    mode (two without a candidate); the node scratch and the ticket back
    at rest."""
    from chip_smoke import mutual_case
    from dynamicfusion_tpu_torch.models import warpfield

    case = mutual_case(name, nc, n)
    act = torch.from_numpy(case["active"]).to(dev)
    field = warpfield.WarpField(torch.from_numpy(case["positions"]).to(dev), torch.zeros((n, 8), device=dev),
                                torch.full((n,), 0.05, device=dev), act, act.sum(dtype=torch.int32),
                                torch.zeros((n,), dtype=torch.int32, device=dev))
    cand, valid = torch.from_numpy(case["cand"]).to(dev), torch.from_numpy(case["valid"]).to(dev)
    ref = warpfield.mutual_nearest(field, cand, valid, plain=True)
    k0 = kernels.device_kernels["mutual_nearest"]
    outs = [kernels.mutual_nearest(field.positions, act, cand, valid)]
    k1 = kernels.device_kernels["mutual_nearest"]
    outs.append(kernels.mutual_nearest(field.positions, act, cand, valid, three_launch=True))
    assert (k1 - k0, kernels.device_kernels["mutual_nearest"] - k1) == (1, 3 if len(cand) else 2)
    torch.cuda.synchronize()
    for got in outs:
        for a, b in zip(got, ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((kernels._node_bits(dev, n) == kernels._BIG_BITS).all()) and int(kernels._ticket(dev)) == 0


def test_fuse_kernel_nonrigid(dev, nr_model):
    from dynamicfusion_tpu_torch.ops import fusion

    st, _, _ = nr_model
    depth = torch.from_numpy(NR_DEPTHS[3]).to(dev)
    _, pts, nrm, dists = preprocess.build_frame_pyramid(NR, depth)
    conf = preprocess.incidence_confidence(pts[0], nrm[0])
    cf = fusion.coarse_field(NR, st.warp, plain=True)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    w2c = se3.inverse(st.pose)
    vk = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    vp = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    ck = fusion.integrate_nonrigid(NR, vk, cf, dists, w2c, NR.intr, ok, conf=conf)
    cp = fusion.integrate_nonrigid(NR, vp, cf, dists, w2c, NR.intr, ok, conf=conf, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp)
    # codes differing by more than 1 LSB on < 1e-4 of voxels, weights equal:
    # the kernel and the plain version unpack the packed depth and confidence
    # with the same products by float32 reciprocals
    dt = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    dw = (vk.weight.to(torch.int32) - vp.weight.to(torch.int32)).abs()
    assert float((dt > 1).float().mean()) < 1e-4 and int(dw.max()) == 0
    assert not torch.equal(vk.tsdf, st.vol.tsdf)


@pytest.mark.parametrize("point_to_plane", [True, False])
def test_dense_kernels(dev, nr_model, point_to_plane):
    """Kernel N (int8: bit-equal to the plain version, whose float64 sum of
    the integer products is exact; bf16 within float32 sum-order bits),
    kernel O (off-diagonal bit-equal, the diagonal within the mean's sum
    order) and kernel F's point-to-point rows."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = dataclasses.replace(NR, solver_linear="direct", point_to_plane=point_to_plane)
    st, inputs, _ = nr_model
    n = st.warp.dq.shape[0]
    s = ws.prepare(cfg, st.warp, inputs)
    dk = ws.data_term(cfg, s, st.warp.dq, True)
    dp = ws.data_term(cfg, s, st.warp.dq, True, plain=True)
    torch.cuda.synchronize()
    assert dk.rows.shape == dp.rows.shape == (s.p_can.shape[0], 1 if point_to_plane else 3, 8, 6)
    assert _close(dk.jtr, dp.jtr, 1e-4) and _close(dk.blocks, dp.blocks, 1e-4) and _close(dk.cost, dp.cost, 1e-5)
    et = ws.edge_term(cfg, s, st.warp.dq)
    for int8 in (False, True):  # the int8 Gram (the base config's) last, for O and the factor
        c8 = dataclasses.replace(cfg, solver_jtj_int8=int8)
        gk = ws.dense_gram(c8, s, dk, et)
        gp = ws.dense_gram(c8, s, dk, et, plain=True)
        torch.cuda.synchronize()
        if int8:
            assert torch.equal(gk, gp)
        else:
            assert _close(gk, gp, 1e-6)
    lam = torch.tensor(1e-4, device=dev)
    ok = ws.dense_damp(gk, lam, st.warp.active, cfg.solver_damping_floor)
    op = ws.dense_damp(gk, lam, st.warp.active, cfg.solver_damping_floor, plain=True)
    off = ~torch.eye(6 * n, dtype=torch.bool, device=dev)
    assert torch.equal(ok[off], op[off]) and _close(ok.diagonal(), op.diagonal(), 1e-6)
    chol = ws.cholesky(ok)
    assert torch.equal(chol, ws.cholesky(ok, plain=True))
    bad = ok.clone()
    bad[3, 3] = -1.0
    assert not bool(torch.isfinite(ws.chol_step(ws.cholesky(bad), dk.jtr)).any())


def test_gram_launch_takes_any_node_count(dev):
    """Kernel N keeps its shared memory fixed (a tile of 128 column nodes a
    block, the library's geometry), so the 1 614-node refusal of its
    one-block-a-node design is gone; the grid of N x ceil(N / 128) blocks
    below 2^31 is its limit."""
    assert kernels.gram_launch(2048) == (2048 * 16, 288, 128)
    assert kernels.gram_launch(1615) == (1615 * 13, 288, 128)
    assert kernels.gram_launch(1) == (1, 288, 128)
    with pytest.raises(ValueError, match="at least one node"):
        kernels.gram_launch(0)
    with pytest.raises(ValueError, match="2\\^31"):
        kernels.gram_launch(600_000)


@pytest.mark.parametrize("n,npt", [(2048, 2048), (301, 512)], ids=["2048_nodes", "301_nodes"])
@pytest.mark.parametrize("nrows", [1, 3])
def test_dense_gram_kernel_any_node_count(dev, n, npt, nrows):
    """Kernel N past the 1 614 nodes its one-block-a-node design took, and at
    an odd node count (8-byte stores, a ragged last tile): a skewed node and
    empty nodes; the int8 Gram bit-equal to the plain version, the bf16 one
    within 1e-6 of the largest entry and the same on a second call, the
    shard mode (given scales, no edges) bit-equal, the edge-only call
    exact."""
    from chip_smoke import skewed_gram_inputs
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    rows, knn, lists, h_ij, diag, e_src, e_dst, e_lists = skewed_gram_inputs(torch, dev, n, npt, nrows, n + nrows)
    assert int((lists.off[1:] - lists.off[:-1]).argmax()) == 0 and bool((lists.off[-n // 32:] == lists.off[-1]).all())
    knn32, dst32 = knn.to(torch.int32), e_dst.to(torch.int32)  # the ids as a prepared structure holds them
    args = (rows, knn32, lists.order, lists.off, h_ij, diag, dst32, e_lists.order, e_lists.off)
    gk = kernels.dense_gram(*args, True)
    assert torch.equal(gk, ws.dense_gram_plain(rows, knn, True, h_ij, diag, e_src, e_dst))
    bk = kernels.dense_gram(*args, False)
    assert _close(bk, ws.dense_gram_plain(rows, knn, False, h_ij, diag, e_src, e_dst), 1e-6)
    assert torch.equal(bk, kernels.dense_gram(*args, False))
    scale = kernels.gram_scales(rows, lists.order, lists.off)
    sk = kernels.dense_gram(rows, knn32, lists.order, lists.off, None, None, None, None, None, True, scale=scale,
                            edges=False)
    assert torch.equal(sk, ws.dense_gram_plain(rows, knn, True, None, None, None, None, scale=scale, n=n))
    rows0 = rows[:0, :1]
    off0 = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    ek = kernels.dense_gram(rows0, knn32[:0], off0[:0], off0, h_ij, diag, dst32, e_lists.order, e_lists.off, False)
    assert torch.equal(ek, ws.dense_gram_plain(rows0, knn[:0], False, h_ij, diag, e_src, e_dst))


def test_base_config_on_the_card_goes_through_every_kernel(dev):
    """The base config (the direct solve: kernels N and O, cuSOLVER's
    factor) at small(): every kernel of its path launches, and the kernel
    path's pose stays within the plain path's reach."""
    cfg = DynamicFusionConfig.small()
    kernels.reset_launches()
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in NR_DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    # no temporal band or seed (march_bands), the PCG's kernels, the
    # incidence-weighted fusion's packed lookup is kernel D's other argument
    off = ("matvec", "pcg", "spd6_inv", "warp_trilinear", "coarse_band", "p2p_gate", "march_bands") + OPTIONS
    path = [k for k in kernels.KERNELS if k not in off]
    assert all(kernels.launches[k] > 0 for k in path), kernels.launches
    assert kernels.launches["cholesky"] == (len(NR_DEPTHS) - 1) * cfg.solver_nonlinear_iters
    ref = kinfu.DynamicFusion(cfg, device="cpu")
    for d in NR_DEPTHS:
        ref(d)
    assert bool(df.last_outputs.icp_ok)
    assert float(df.last_outputs.solver_cost1) <= float(df.last_outputs.solver_cost0)
    a, b = df.get_pose().cpu(), ref.get_pose()
    assert float((a[:3, 3] - b[:3, 3]).abs().max()) <= 3e-3


@pytest.mark.parametrize("p2p", [0.0, 0.25])
def test_nonrigid_slice_on_the_card_goes_through_every_kernel(dev, p2p):
    """The preset's slice and, with the tangential term, the quality
    preset's: every kernel launches (kernel L once, in frame 0)."""
    cfg = dataclasses.replace(NR, solver_p2p_weight=p2p)
    kernels.reset_launches()
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in NR_DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    # small() is below the full-scale branches: the trilinear map warp does
    # not run; nor do the coarse band (160x120 maps) and the aperture gate
    # (test_adaptive_slice_on_the_card_goes_through_every_kernel), nor the
    # direct solve's kernels (test_base_config_on_the_card_goes_through_every_kernel)
    path = [k for k in kernels.KERNELS
            if k not in ("matvec", "warp_trilinear", "coarse_band", "p2p_gate") + DENSE + OPTIONS]
    assert all(kernels.launches[k] > 0 for k in path), kernels.launches
    assert kernels.launches["extract_cloud"] == kernels.launches["sample_nodes"] == 1
    ref = kinfu.DynamicFusion(cfg, device="cpu")
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


def test_adaptive_slice_on_the_card_goes_through_every_kernel(dev):
    """The quality preset's slice with the aperture gate: kernel M launches
    once a step, and the kernel path's pose stays within the plain path's
    reach as the gate-off slice's does."""
    cfg = dataclasses.replace(NR, solver_p2p_weight=0.25, solver_p2p_adaptive=True)
    kernels.reset_launches()
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in NR_DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    path = [k for k in kernels.KERNELS if k not in ("matvec", "warp_trilinear", "coarse_band") + DENSE + OPTIONS]
    assert all(kernels.launches[k] > 0 for k in path), kernels.launches
    assert kernels.launches["p2p_gate"] == len(NR_DEPTHS) - 1
    ref = kinfu.DynamicFusion(cfg, device="cpu")
    for d in NR_DEPTHS:
        ref(d)
    assert bool(df.last_outputs.icp_ok)
    a, b = df.get_pose().cpu(), ref.get_pose()
    assert float((a[:3, 3] - b[:3, 3]).abs().max()) <= 3e-3


# ---------------------------------------------------------------- the solver and warp-field options


@pytest.mark.parametrize("self_ref", [True, False])
def test_node_radius_kernel(dev, nr_model, self_ref):
    """Kernel E's radius entry, bit-equal to its plain version (both take
    the expansion's sums as fused multiply-adds), with inactive
    references; and kernel H's insertion with those radii."""
    from dynamicfusion_tpu_torch.models import warpfield

    cfg = dataclasses.replace(NR, node_radius_adaptive=True)
    st, inputs, _ = nr_model
    f = st.warp
    q = f.positions if self_ref else torch.nan_to_num(inputs.p_can[::7])
    rk = warpfield.adaptive_radius(cfg, q, f.positions, f.active, self_ref)
    rp = warpfield.adaptive_radius(cfg, q, f.positions, f.active, self_ref, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp)
    assert bool(((rk > cfg.node_radius_min) & (rk < cfg.node_radius_max)).any())
    if not self_ref:
        half = torch.arange(f.active.shape[0], device=dev) % 2 == 0
        field = f._replace(active=f.active & half, count=(f.active & half).sum(dtype=torch.int32))
        fi = torch.tensor(9, dtype=torch.int32, device=dev)
        valid = ~torch.isnan(inputs.p_can[:, 0])
        k = warpfield.insert_nodes(cfg, field, inputs.p_can, valid, fi)
        p = warpfield.insert_nodes(cfg, field, inputs.p_can, valid, fi, plain=True)
        assert int(k.count) > int(field.count)
        assert torch.equal(k.radius, p.radius) and torch.equal(k.active, p.active)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_net_rigid_kernel(dev, nr_model, alpha):
    """Kernel Q against its plain version (float64 SVD): a field moved by
    a small rigid motion plus noise, and a field with two active nodes,
    which stays as it is."""
    from dynamicfusion_tpu_torch.core import dualquat, quat
    from dynamicfusion_tpu_torch.models import warpfield

    st, _, _ = nr_model
    prev = st.warp
    g = dualquat.from_rot_trans(quat.from_rotvec(torch.tensor([0.01, -0.02, 0.015], device=dev)),
                                torch.tensor([0.02, 0.01, -0.03], device=dev))
    noise = 1e-3 * torch.randn(prev.dq.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    new = prev._replace(dq=dualquat.normalize(dualquat.mul(g[None], prev.dq)) + noise)
    k = warpfield.remove_net_rigid(prev, new, alpha)
    p = warpfield.remove_net_rigid(prev, new, alpha, plain=True)
    torch.cuda.synchronize()
    assert float((k.dq - p.dq).abs().max()) <= 1e-5
    assert float((k.dq - new.dq)[prev.active].abs().max()) > 1e-3
    assert torch.equal(k.dq[~new.active], new.dq[~new.active])
    two = prev.active & (torch.cumsum(prev.active.int(), 0) <= 2)
    few = warpfield.remove_net_rigid(prev._replace(active=two), new, alpha)
    assert torch.equal(few.dq, new.dq)


def test_net_rigid_kernel_close_singular_values(dev):
    """Kernel Q's one-sided Jacobi SVD where H is a multiple of the
    identity but for the motion (nodes on the axes and diagonals of three
    shells, whose second moment is isotropic; a net motion of ~1e-5, as a
    static camera's), against the plain version's float64 SVD."""
    from dynamicfusion_tpu_torch.core import dualquat, quat
    from dynamicfusion_tpu_torch.models import warpfield

    axes = [[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0]]
    dirs = torch.tensor(axes + [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)])
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    pos = (torch.cat([r * dirs for r in (0.1, 0.15, 0.2)]) + torch.tensor([0.0, 0.0, 1.0])).to(dev)
    n = pos.shape[0]
    dq = dualquat.identity(dev).expand(n, 8).clone()
    on = torch.ones(n, dtype=torch.bool, device=dev)
    prev = warpfield.WarpField(pos, dq, torch.full((n,), 0.05, device=dev), on,
                               torch.tensor(n, dtype=torch.int32, device=dev), torch.zeros(n, dtype=torch.int32,
                                                                                          device=dev))
    m = dualquat.from_rot_trans(quat.from_rotvec(torch.tensor([1e-5, -2e-5, 1e-5], device=dev)),
                                torch.tensor([3e-5, -1e-5, 2e-5], device=dev))
    g = torch.Generator().manual_seed(4)
    new = prev._replace(dq=dualquat.normalize(dualquat.mul(m[None], dq))
                        + 1e-6 * torch.randn((n, 8), generator=g).to(dev))
    k = warpfield.remove_net_rigid(prev, new, 1.0)
    p = warpfield.remove_net_rigid(prev, new, 1.0, plain=True)
    torch.cuda.synchronize()
    assert float((k.dq - p.dq).abs().max()) <= 1e-6


@pytest.mark.parametrize("mode", ["stride2", "stride4", "lag"])
def test_solver_kernels_row_modes(dev, nr_model, mode):
    """Kernels F and G under the tangential rows' row modes: F's strided
    rows (bf16 of sqrt(s) jac) equal to the plain version's within one bf16
    rounding, G's matvec and PCG over the rows of the mode."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    changes = dict(solver_p2p_lag_hessian=True) if mode == "lag" else dict(solver_p2p_hessian_stride=int(mode[-1]))
    cfg = dataclasses.replace(NR, solver_p2p_weight=0.25, **changes)
    st, inputs, _ = nr_model
    n = st.warp.dq.shape[0]
    used, stride = ws.row_mode(cfg)
    s = ws.prepare(cfg, st.warp, inputs)
    dk = ws.data_term(cfg, s, st.warp.dq, True, row_stride=stride)
    dp = ws.data_term(cfg, s, st.warp.dq, True, plain=True, row_stride=stride)
    torch.cuda.synchronize()
    assert _close(dk.rows.float(), dp.rows.float(), 1e-2) and _close(dk.blocks, dp.blocks, 1e-4)
    ep = ws.edge_term(cfg, s, st.warp.dq, plain=True)
    blocks = dp.blocks + ep.diag + torch.diag_embed(torch.ones(n, 6, device=dev))
    sysm = ws.System(dp.rows, ep, torch.ones(6 * n, device=dev), used, stride)
    full = ws.System(dp.rows, ep, torch.ones(6 * n, device=dev))
    pv = torch.randn(6 * n, generator=torch.Generator().manual_seed(0)).to(dev)
    ak = ws.matvec(s, sysm, pv)
    assert _close(ak, ws.matvec(s, sysm, pv, plain=True), 1e-3)
    assert not _close(ak, ws.matvec(s, full, pv), 1e-3)  # the mode leaves rows out
    minv = ws.spd6_inv(blocks, plain=True)
    on = torch.ones((), dtype=torch.bool, device=dev)
    xk = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on)
    xp = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on, plain=True)
    assert _close(xk, xp, 1e-2)


def _bits(t):
    """A tensor's bits (float32 as int32, bfloat16 as int16), None as is."""
    if t is None:
        return None
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


DATA_MODES = {"one_row": dict(), "tangential": dict(solver_p2p_weight=0.25), "point": dict(point_to_plane=False),
              "strided": dict(solver_p2p_weight=0.25, solver_p2p_hessian_stride=4)}


@pytest.mark.parametrize("mode", sorted(DATA_MODES))
def test_data_term_kernel_in_its_order(dev, nr_model, mode):
    """Kernel F bit for bit against its order, with and without the system:
    Jᵀr and the blocks against ``data_sums_ordered`` of its own Jacobian and
    residuals in the library's node lanes, the cost against
    ``sum_ordered`` of its per-point costs, the bf16 rows against
    ``bf16_rows`` of its Jacobian."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = dataclasses.replace(NR, **DATA_MODES[mode])
    st, inputs, _ = nr_model
    _, stride = ws.row_mode(cfg)
    s = ws.prepare(cfg, st.warp, inputs)
    lanes = kernels.data_term_lanes()[1]
    for system in (True, False):
        jtr, cost, rows, blocks, jac, rw, rho = kernels.data_term(
            s.p_can, s.p_live, s.n_live, s.valid, s.knn_idx, s.w_knn, st.warp.dq, s.pts_by_node.order,
            s.pts_by_node.off, cfg.solver_tukey_c, system, s.t1, s.t2, s.p2p_sw, point=not cfg.point_to_plane,
            row_stride=stride, internals=True)
        ojtr, oblocks = ws.data_sums_ordered(jac, rw, s.pts_by_node, lanes)
        torch.cuda.synchronize()
        assert torch.equal(_bits(jtr), _bits(ojtr)) and torch.equal(_bits(cost), _bits(ws.sum_ordered(rho)))
        if system:
            assert torch.equal(_bits(blocks), _bits(oblocks))
            assert torch.equal(_bits(rows), _bits(ws.bf16_rows(jac, stride)))


def _tie_field(dev, n=48, seed=0):
    """Nodes on a 1/8 m grid (exact in float32), eight of them repeated at
    other indices, about a quarter inactive; queries on the grid and off
    it: many exact distance ties."""
    from dynamicfusion_tpu_torch.core import dualquat
    from dynamicfusion_tpu_torch.models import warpfield

    rng = np.random.RandomState(seed)
    pos = rng.randint(-4, 5, (n, 3)).astype(np.float32) / 8.0
    pos[n // 2:n // 2 + 8] = pos[:8]
    active = rng.rand(n) > 0.25
    queries = np.concatenate([rng.randint(-4, 5, (200, 3)).astype(np.float32) / 8.0,
                              (rng.randn(56, 3) * 0.3).astype(np.float32)])
    dq = dualquat.from_twist(torch.from_numpy(rng.randn(n, 3).astype(np.float32) * 0.01),
                             torch.from_numpy(rng.randn(n, 3).astype(np.float32) * 0.002))
    field = warpfield.WarpField(torch.from_numpy(pos).to(dev), dq.to(dev), torch.full((n,), 0.2, device=dev),
                                torch.from_numpy(active).to(dev), torch.tensor(int(active.sum()), device=dev),
                                torch.zeros(n, dtype=torch.int32, device=dev))
    return field, torch.from_numpy(queries).to(dev)


@pytest.mark.parametrize("lanes", [None, 1, 2, 4, 8, 16])
def test_knn_blend_split_scan_is_the_serial_scan(dev, nr_model, lanes):
    """Kernel E with a query's scan over ``lanes`` lanes (None: the wrapper's
    choice) bit for bit against the one-thread-a-query kernel
    (``lanes=0``): at the coarse corners (blend and warp),
    the solve points (k = 8), the nodes (k = 5), warped points with their
    normals, and on a node set with exact ties and inactive nodes."""
    from dynamicfusion_tpu_torch.ops import fusion

    st, inputs, pts = nr_model
    f = st.warp
    tie_field, tie_q = _tie_field(dev)
    cases = [
        (f, fusion.coarse_corner_points(NR, dev), 8, dict(blend=True, warp=True)),
        (f, pts, 8, dict()),
        (f, f.positions, 5, dict()),
        (f, inputs.p_can.contiguous(), 8, dict(warp=True, normals=inputs.n_live.contiguous())),
        (tie_field, tie_q, 8, dict(blend=True, warp=True)),
        (tie_field, tie_q, 5, dict()),
    ]
    for field, q, k, kw in cases:
        args = (field.positions, field.active, field.radius, field.dq, q, k)
        split = kernels.knn_blend(*args, **kw, lanes=lanes)
        serial = kernels.knn_blend(*args, **kw, lanes=0)
        torch.cuda.synchronize()
        for a, b in zip(split, serial):
            assert (a is None and b is None) or torch.equal(_bits(a), _bits(b))


PCG_MODES = {"one_row": dict(), "three_rows": dict(solver_p2p_weight=0.25),
             "stride4": dict(solver_p2p_weight=0.25, solver_p2p_hessian_stride=4),
             "lag": dict(solver_p2p_weight=0.25, solver_p2p_lag_hessian=True)}


@pytest.mark.parametrize("mode", sorted(PCG_MODES))
def test_cluster_pcg_kernel(dev, nr_model, mode):
    """Kernel G's cluster PCG in each row mode against the plain PCG (the
    sums' order differs: 1e-2 of the largest entry, as above), the same
    bits on a second launch, p in device memory bit-equal to p in shared
    memory (the same sums), one launch a solve, and inactive as x = 0."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = dataclasses.replace(NR, **PCG_MODES[mode])
    st, inputs, _ = nr_model
    n = st.warp.dq.shape[0]
    used, stride = ws.row_mode(cfg)
    s = ws.prepare(cfg, st.warp, inputs)
    dp = ws.data_term(cfg, s, st.warp.dq, True, plain=True, row_stride=stride)
    ep = ws.edge_term(cfg, s, st.warp.dq, plain=True)
    blocks = dp.blocks + ep.diag + torch.diag_embed(torch.ones(n, 6, device=dev))
    sysm = ws.System(dp.rows, ep, torch.ones(6 * n, device=dev), used, stride)
    minv = ws.spd6_inv(blocks, plain=True)
    on = torch.ones((), dtype=torch.bool, device=dev)
    before = kernels.launches["pcg"]
    xk = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on)
    assert kernels.launches["pcg"] == before + 1
    xp = ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on, plain=True)
    assert bool(torch.isfinite(xk).all()) and _close(xk, xp, 1e-2)
    assert torch.equal(xk, ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, on))
    ks = ws._kernel_system(s, sysm)
    assert torch.equal(xk, kernels.pcg(ks, minv, dp.jtr, 12, 1e-3, on, used=used, stride=stride, shared_p=False))
    assert not bool(ws.pcg(s, sysm, minv, dp.jtr, 12, 1e-3, ~on).any())


def test_dense_pcg_kernel(dev, nr_model):
    """Kernel P on the damped dense system of the unlagged solve, against
    its plain version; ``active`` False gives zeros."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = dataclasses.replace(NR, solver_lagged_jtj=False)
    st, inputs, _ = nr_model
    s = ws.prepare(cfg, st.warp, inputs)
    dt = ws.data_term(cfg, s, st.warp.dq, True, plain=True)
    et = ws.edge_term(cfg, s, st.warp.dq, plain=True)
    a = ws.dense_damp(ws.dense_gram(cfg, s, dt, et, plain=True), torch.tensor(8.0, device=dev), st.warp.active,
                      cfg.solver_damping_floor, plain=True)
    b = dt.jtr + et.jtr
    on = torch.ones((), dtype=torch.bool, device=dev)
    xk = ws.dense_pcg(a, b, cfg.solver_linear_iters, cfg.solver_linear_tol, on)
    xp = ws.dense_pcg(a, b, cfg.solver_linear_iters, cfg.solver_linear_tol, on, plain=True)
    torch.cuda.synchronize()
    assert _close(xk, xp, 1e-3)
    assert torch.equal(xk, ws.dense_pcg(a, b, cfg.solver_linear_iters, cfg.solver_linear_tol, on))
    assert not bool(ws.dense_pcg(a, b, cfg.solver_linear_iters, cfg.solver_linear_tol, ~on).any())


def test_options_on_the_card_go_through_their_kernels(dev):
    """The quality slice with the adaptive radius, the strided tangential
    rows and the net rigid removal, then a step with the dense-matrix PCG:
    each option's kernel launches."""
    cfg = dataclasses.replace(NR, solver_p2p_weight=0.25, solver_p2p_hessian_stride=4, node_radius_adaptive=True,
                              solver_remove_net_rigid=True, solver_net_rigid_alpha=0.5)
    kernels.reset_launches()
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in NR_DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    assert kernels.launches["net_rigid"] == len(NR_DEPTHS) - 1
    assert kernels.launches["node_radius"] >= 1 + (len(NR_DEPTHS) - 1)
    assert bool(df.last_outputs.icp_ok)
    assert float(df.last_outputs.solver_cost1) <= float(df.last_outputs.solver_cost0)
    radius = df.state.warp.radius[df.state.warp.active]
    assert bool((radius != cfg.node_radius).any())
    base = dataclasses.replace(DynamicFusionConfig.small(), solver_linear="pcg", solver_lagged_jtj=False)
    kernels.reset_launches()
    st = kinfu.first_frame(base, kinfu.init_state(base, dev), torch.from_numpy(NR_DEPTHS[0]).to(dev))
    _, o = kinfu.step(base, st, torch.from_numpy(NR_DEPTHS[1]).to(dev))
    assert kernels.launches["dense_pcg"] == base.solver_nonlinear_iters
    assert bool(o.icp_ok) and float(o.solver_cost1) <= float(o.solver_cost0)


def test_full_resolution_rigid_on_the_card(dev):
    """``raycast_subsample=1``: the model maps at the frame size through the
    coarse band (kernels C and J) every frame, and the renders."""
    cfg = dataclasses.replace(
        DynamicFusionConfig.small(dims=64, rows=240, cols=320), max_nodes=64, node_sample_step=17, rigid_only=True,
        raycast_subsample=1,
    )
    depths = [synthetic.scene_depth(cfg.intr, cfg.rows, cfg.cols, synthetic.orbit_pose(a, target=TARGET), **SCENE)
              for a in ANGLES]
    kernels.reset_launches()
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths:
        df(d, block=False)
    torch.cuda.synchronize()
    assert kernels.launches["coarse_band"] == len(depths)
    assert kernels.launches["raycast"] == 2 * len(depths)
    ref = kinfu.DynamicFusion(cfg, device="cpu")
    for d in depths:
        ref(d)
    assert float((df.get_pose().cpu() - ref.get_pose()).abs().max()) <= 1e-3
    for mode, shape in ((0, (240, 320, 3)), (3, (240, 640, 3))):
        img = df.render(mode)
        assert img.device.type == "cuda" and img.dtype == torch.uint8 and tuple(img.shape) == shape
    img = df.render(0, pose=df.get_pose())
    ref_img = ref.render(0, pose=ref.get_pose())
    assert float((img.cpu().int() - ref_img.int()).abs().amax(-1).gt(1).float().mean()) <= 1e-3


# ---------------------------------------------------------------- the raycast variants and dense fusion

VARIANTS = [("newton16", False), ("newton16", True), ("hybrid16", False), ("hybrid16", True),
            ("secant", True), ("newton8", True)]


@pytest.mark.parametrize("refine,smooth", VARIANTS, ids=[f"{r}-{'grad6' if s else 'cell'}" for r, s in VARIANTS])
def test_raycast_kernel_variants(dev, model, refine, smooth):
    """Kernel C's refine codes 2 and 3 and its six-sample normal mode
    against the plain version: the found mask exact, vertices and normals
    within 1e-5 (float32 in the same order under -fmad=false)."""
    cfg = dataclasses.replace(CFG, raycast_refine=refine, raycast_smooth_normals=smooth)
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), model.pose)
    rows, cols = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    rays = tsdf.rays(cfg, cam2vol, cfg.intr.level(cfg.raycast_shift), rows, cols)
    before = kernels.launches["raycast"]
    fk, vk, nk = tsdf.march_and_refine(cfg, model.vol.tsdf, *rays)
    fp, vp, np_ = tsdf.march_and_refine(cfg, model.vol.tsdf, *rays, plain=True)
    assert kernels.launches["raycast"] == before + 1
    assert torch.equal(fk, fp) and float(fk.float().mean()) > 0.3
    assert float((vk - vp)[fk].abs().max()) <= 1e-5
    assert torch.equal(torch.isnan(nk[fk]), torch.isnan(np_[fk]))
    assert float(torch.nan_to_num((nk - np_)[fk].abs()).max()) <= 1e-5


@pytest.mark.parametrize("ok", [True, False])
def test_dense_fuse_kernel(dev, model, ok):
    """Kernel F1 against its plain version: codes within 1 LSB, weights
    equal; nothing changes where ``ok`` is False."""
    cfg = dataclasses.replace(CFG, integrate_mode="dense")
    dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(DEPTHS[3]).to(dev))
    vol2cam = se3.compose(se3.inverse(model.pose), kinfu._vol_pose(cfg, dev))
    ok_t = torch.tensor(ok, device=dev)
    vk = TsdfVolume(model.vol.tsdf.clone(), model.vol.weight.clone())
    vp = TsdfVolume(model.vol.tsdf.clone(), model.vol.weight.clone())
    before = kernels.launches["integrate_dense"]
    ck = tsdf.integrate(cfg, vk, dists, vol2cam, cfg.intr, ok=ok_t)
    tsdf.integrate(cfg, vp, dists, vol2cam, cfg.intr, ok=ok_t, plain=True)
    torch.cuda.synchronize()
    assert kernels.launches["integrate_dense"] == before + 1 and ck.tolist() == [0, 0, 0]
    dt = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    assert int(dt.max()) <= 1
    assert torch.equal(vk.weight.to(torch.int32), vp.weight.to(torch.int32))
    assert torch.equal(vk.tsdf, model.vol.tsdf) != ok


@pytest.mark.parametrize("stride,split", [(2, 1), (4, 2)])
def test_dense_fuse_kernel_nonrigid(dev, nr_model, stride, split):
    """Kernel F2 against its plain version with the incidence confidence:
    codes within 1 LSB, weights equal; with the phase split only the
    phase's brick x-planes change. Stride 4 takes the prolongation's
    inexact weights (its fused multiply-adds)."""
    from dynamicfusion_tpu_torch.ops import fusion

    st, _, _ = nr_model
    cfg = dataclasses.replace(NR, integrate_mode="dense", knn_field_stride=stride, fusion_phase_split=split,
                              fusion_interval=2)
    depth = torch.from_numpy(NR_DEPTHS[3]).to(dev)
    _, pts, nrm, dists = preprocess.build_frame_pyramid(cfg, depth)
    conf = preprocess.incidence_confidence(pts[0], nrm[0])
    cf = fusion.coarse_field(cfg, st.warp, plain=True)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    phase = torch.ones((), dtype=torch.int32, device=dev) if split > 1 else None
    w2c = se3.inverse(st.pose)
    vk = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    vp = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    before = kernels.launches["integrate_dense_nonrigid"]
    fusion.integrate_nonrigid(cfg, vk, cf, dists, w2c, cfg.intr, ok, conf=conf, phase=phase)
    fusion.integrate_nonrigid(cfg, vp, cf, dists, w2c, cfg.intr, ok, conf=conf, phase=phase, plain=True)
    torch.cuda.synchronize()
    assert kernels.launches["integrate_dense_nonrigid"] == before + 1
    dt = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    assert int(dt.max()) <= 1
    assert torch.equal(vk.weight.to(torch.int32), vp.weight.to(torch.int32))
    changed = (vk.weight.to(torch.int32) != st.vol.weight.to(torch.int32)).any(dim=2).any(dim=1)
    assert bool(changed.any())
    if split > 1:
        bx = (torch.arange(cfg.volume_dims, device=dev) // cfg.brick_size) % split
        assert not bool(changed[bx != 1].any())


def test_dense_configs_on_the_card_go_through_their_kernels(dev):
    """Dense rigid fusion with the six-sample normals, and dense non-rigid
    fusion with newton16 then hybrid16: F1 in frame 0 and each rigid step,
    F2 on each fusion step, C every frame; poses within the plain path's
    reach."""
    rigid = dataclasses.replace(CFG, integrate_mode="dense", raycast_smooth_normals=True)
    kernels.reset_launches()
    df = kinfu.DynamicFusion(rigid, device=dev)
    for d in DEPTHS:
        df(d, block=False)
    torch.cuda.synchronize()
    assert kernels.launches["integrate_dense"] == len(DEPTHS) and kernels.launches["fuse_bricks"] == 0
    ref = kinfu.DynamicFusion(rigid, device="cpu")
    for d in DEPTHS:
        ref(d)
    assert bool(df.last_outputs.icp_ok)
    assert float((df.get_pose().cpu() - ref.get_pose()).abs().max()) <= 1e-3
    for refine in ("newton16", "hybrid16"):
        cfg = dataclasses.replace(NR, integrate_mode="dense", raycast_refine=refine)
        kernels.reset_launches()
        df = kinfu.DynamicFusion(cfg, device=dev)
        for d in NR_DEPTHS:
            df(d, block=False)
        torch.cuda.synchronize()
        assert kernels.launches["integrate_dense"] == 1
        assert kernels.launches["integrate_dense_nonrigid"] == len(NR_DEPTHS) - 1
        assert kernels.launches["fuse_bricks"] == 0 and kernels.launches["brick_plan"] == 0
        assert bool(df.last_outputs.icp_ok)
        assert float(df.last_outputs.solver_cost1) <= float(df.last_outputs.solver_cost0)


@pytest.mark.parametrize("max_points", [1 << 16, 700])
def test_extract_normals_kernel(dev, model, max_points):
    """Kernel R on kernel L's cloud (the NaN tail included) and on points
    leaving the volume: bit-equal to its plain version."""
    cloud = tsdf.extract_cloud(CFG, model.vol, max_points, min_weight=1.0).points
    o = torch.tensor(CFG.volume_origin, device=dev)
    edge = torch.tensor([[-0.01, 0.3, 0.3], [0.999, 0.3, 0.3], [float("nan"), 0.0, 0.0]], device=dev) + o
    pts = torch.cat([cloud, edge])
    kernels.reset_launches()
    got = tsdf.extract_normals(CFG, model.vol, pts)
    ref = tsdf.extract_normals(CFG, model.vol, pts, plain=True)
    torch.cuda.synchronize()
    assert kernels.launches["extract_normals"] == 1
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    valid = ~torch.isnan(got[:, 0])
    assert int(valid.sum()) > 500 and bool(torch.isnan(got[-3:]).all())


def test_depth_icp_kernels(dev):
    """The depth-variant ICP (kernels I and B) against its plain version on
    the same pyramids, and the camera's motion recovered."""
    delta = np.array([0.004, -0.003, 0.005])
    pose1 = synthetic.orbit_pose(0.0, target=TARGET)
    pose1[:3, 3] += pose1[:3, :3] @ delta
    pyr = [preprocess.build_frame_pyramid(CFG, torch.from_numpy(synthetic.scene_depth(
        CFG.intr, CFG.rows, CFG.cols, p, **SCENE)).to(dev)) for p in (pose1, synthetic.orbit_pose(0.0, target=TARGET))]
    args = (pyr[0][0], pyr[0][2], pyr[1][0], pyr[1][2])
    kernels.reset_launches()
    got = icp.estimate_transform_depth(CFG, *args)
    torch.cuda.synchronize()
    # both pyramids' point maps in one launch of kernel I's multi-map entry
    assert kernels.launches["frame_maps"] == 1 and kernels.launches["points_normals"] == 0
    assert kernels.launches["icp_reduce"] > 0
    ref = icp.estimate_transform_depth(CFG, *args, plain=True)
    assert bool(got.ok) and bool(ref.ok)
    a, b = got.transform.cpu(), ref.transform.cpu()
    assert float((a[:3, 3] - b[:3, 3]).abs().max()) <= 1e-4
    assert float((a[:3, :3] - b[:3, :3]).abs().max()) <= 1e-5
    assert np.abs(a[:3, 3].numpy() - delta).max() <= 2e-3


# ---------------------------------------------------------------- the sharded step's modes


def _ext_slab(tsdf_vol, k, n, halo):
    """(x_off, shard k's extended slab): its D/n planes and ``halo``
    wrapped planes each side, as ``mesh.halo`` builds it."""
    d = tsdf_vol.shape[0]
    x_off = k * (d // n) - halo
    ext = tsdf_vol[max(x_off, 0): x_off + d // n + 2 * halo]
    if x_off < 0:
        ext = torch.cat([tsdf_vol[x_off:], ext])
    if ext.shape[0] < d // n + 2 * halo:
        ext = torch.cat([ext, tsdf_vol[: d // n + 2 * halo - ext.shape[0]]])
    return x_off, ext.contiguous()


def test_slab_raycast_kernel(dev, model):
    """Kernel C's slab mode on each shard's extended slab (4 shards) against
    its plain version: found and the first exit event's t equal, the
    refined t and the vertex within 1e-4 m where found, the normal within
    1e-5 (NaN alike)."""
    from dynamicfusion_tpu_torch.parallel import sharded_raycast

    cfg = dataclasses.replace(CFG, raycast_adaptive_step=False)
    d, n, halo = cfg.volume_dims, 4, sharded_raycast._halo_planes(cfg)
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), model.pose)
    org, dirs, tmin, tmax = tsdf.rays(cfg, cam2vol, cfg.intr, cfg.rows, cfg.cols)
    for k in range(n):
        x_off, ext = _ext_slab(model.vol.tsdf, k, n, halo)
        lo, hi = sharded_raycast.slab_window(cfg, k, n, org, dirs, tmin, tmax)
        got = tsdf.march_slab(cfg, ext, x_off, org, dirs, lo, hi)
        ref = tsdf.march_slab(cfg, ext, x_off, org, dirs, lo, hi, plain=True)
        torch.cuda.synchronize()
        f = ref[0]
        assert torch.equal(got[0], f) and torch.equal(got[4], ref[4])
        assert float((got[1][f] - ref[1][f]).abs().max()) <= 1e-4
        assert float((got[2][f] - ref[2][f]).abs().max()) <= 1e-4
        # a hit whose refined point left the volume carries a NaN normal in both
        assert torch.equal(torch.isnan(got[3][f]), torch.isnan(ref[3][f]))
        assert float(torch.nan_to_num((got[3][f] - ref[3][f]).abs(), nan=0.0).max()) <= 1e-5
        assert bool(torch.isnan(got[1][~f]).all())


@pytest.mark.parametrize("split", [1, 2])
def test_slab_brick_plan_and_fuse_kernels(dev, nr_model, split):
    """Kernels K and D's slab modes (4 slabs of the non-rigid state): the
    classes and the work list equal the plain version's bit for bit (the
    phase on the global brick plane), the fused codes within 1 LSB on a
    1e-4 share and the weights equal."""
    from dynamicfusion_tpu_torch.ops import fusion
    from dynamicfusion_tpu_torch.parallel import sharded_fusion

    cfg = dataclasses.replace(NR, fusion_phase_split=split, fusion_interval=2)
    st, _, _ = nr_model
    n, b, g = 4, cfg.brick_size, cfg.knn_field_stride
    dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(NR_DEPTHS[3]).to(dev))
    cf = fusion.coarse_field(cfg, st.warp, plain=True)
    grid = se3.transform_points(se3.inverse(st.pose), cf.warped)
    band_cap, wide_cap = sharded_fusion.caps(cfg, n)
    phase = torch.ones((), dtype=torch.int32, device=dev)
    dl = cfg.volume_dims // n
    for k in range(n):
        gk = bricks.corner_slab(grid, k, n, b, g).contiguous()
        qk = bricks.corner_slab(cf.q, k, n, b, g).contiguous()
        bk = bricks.plan_slab(cfg, dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap, phase, split)
        bp = bricks.plan_slab(cfg, dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap, phase, split, plain=True)
        for a, c in zip(bk.classes, bp.classes):
            assert torch.equal(a, c)
        for a, c in zip(bk.work, bp.work):
            assert torch.equal(a, c)
        vk = TsdfVolume(st.vol.tsdf[k * dl:(k + 1) * dl].clone(), st.vol.weight[k * dl:(k + 1) * dl].clone())
        vp = TsdfVolume(vk.tsdf.clone(), vk.weight.clone())
        on = torch.ones((), dtype=torch.bool, device=dev)
        bricks.fuse(cfg, vk, dists, gk, g, cfg.intr, bk, on, qk)
        bricks.fuse(cfg, vp, dists, gk, g, cfg.intr, bp, on, qk, plain=True)
        dt = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
        assert int(dt.max()) <= 1 and float((dt > 0).float().mean()) <= 1e-4
        assert torch.equal(vk.weight.to(torch.int32), vp.weight.to(torch.int32))


def test_distributed_pcg_and_shard_gram_kernels(dev, nr_model):
    """G's data-only matvec of each of 4 shards against its plain version
    (one bf16 rounding of t may flip with the sum order) and bit-equal to
    the plain version in its order, the distributed PCG bit-equal to the
    plain distributed PCG (every sum in the kernels' order), a finished loop as no-op launches, and N's shard mode
    with the pmax'd scales bit-equal to its plain version, whose psum with
    the edge blocks placed once is the single-device int8 Gram within the
    float sums of the shards' dequantized Grams."""
    from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    st, inputs, _ = nr_model
    mesh = sharded.make_mesh(4, devices=[dev] * 4)
    n = st.warp.dq.shape[0]
    s = ws.prepare(NR, st.warp, inputs)
    shards = distributed_gn.shard_structure(s, mesh)
    dts = [ws.data_term(NR, sk, st.warp.dq, True, plain=True) for sk in shards]
    et = ws.edge_term(NR, s, st.warp.dq, plain=True)
    pv = torch.randn(6 * n, generator=torch.Generator().manual_seed(0)).to(dev)
    sys0 = ws.System(dts[0].rows, et, torch.ones(6 * n, device=dev))
    for sk, dt in zip(shards, dts):
        got = kernels.data_matvec(dt.rows, sk.knn_idx32, sk.pts_by_node.order, sk.pts_by_node.off,
                                  ws.heavy_order(sk.pts_by_node), pv)
        ref = ws.data_matvec_plain(sk, sys0._replace(rows=dt.rows), pv).reshape(-1)
        assert _close(got, ref, 1e-3)
        assert torch.equal(got, ws.data_matvec_ordered(sk, sys0._replace(rows=dt.rows), pv).reshape(-1))
    blocks = mesh.psum([dt.blocks for dt in dts]) + et.diag
    damp = 1e-3 * torch.diagonal(blocks, dim1=-2, dim2=-1).reshape(-1) + 1e-8
    sysm = ws.System(dts[0].rows, et, damp)
    minv = ws.spd6_inv(blocks + torch.diag_embed(damp.reshape(n, 6)), plain=True)
    b = mesh.psum([dt.jtr for dt in dts]) + et.jtr
    on = torch.ones((), dtype=torch.bool, device=dev)
    parts = [ws.Shard(sk, dt.rows) for sk, dt in zip(shards, dts)]
    xk = ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, on)
    xp = ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, on, plain=True)
    assert torch.equal(xk, xp)  # the plain version sums in the kernels' order
    assert torch.equal(xk, ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, on, reference=True))
    assert not bool(ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, ~on).any())
    cfg = dataclasses.replace(NR, solver_linear="direct")
    scale = mesh.pmax([ws.gram_scales(sk, dt) for sk, dt in zip(shards, dts)])
    grams = []
    for sk, dt in zip(shards, dts):
        gk = ws.data_gram(cfg, sk, dt, scale)
        assert torch.equal(gk, ws.data_gram(cfg, sk, dt, scale, plain=True))
        grams.append(gk)
    whole = ws.data_term(cfg, s, st.warp.dq, True, plain=True)
    one = ws.dense_gram(cfg, s, whole, et)
    summed = mesh.psum(grams) + ws.edge_jtj(s, et)
    assert torch.equal(ws.edge_jtj(s, et), ws.edge_jtj(s, et, plain=True))
    assert _close(summed, one, 1e-6)


# (R, rows used, tangential stride): every row of R = 1 and of R = 3, the
# plane rows only, the strided tangential rows
SHARD_ROW_MODES = [(1, None, 1), (3, None, 1), (3, 1, 1), (3, None, 4)]


def sharded_system(dev, nr_model, n_shards, nrows):
    """(mesh, Shards, structure, damped system without its row mode, the
    preconditioner, b) of the next frame's solve cut into ``n_shards``
    shards on the card; with R = 3 the tangential rows are seeded bf16
    values beside the plane rows (the holds compare bits, not solves)."""
    from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    st, inputs, _ = nr_model
    mesh = sharded.make_mesh(n_shards, devices=[dev] * n_shards)
    n = st.warp.dq.shape[0]
    s = ws.prepare(NR, st.warp, inputs)
    shards = distributed_gn.shard_structure(s, mesh)
    dts = [ws.data_term(NR, sk, st.warp.dq, True, plain=True) for sk in shards]
    et = ws.edge_term(NR, s, st.warp.dq, plain=True)
    rows = [dt.rows for dt in dts]
    if nrows == 3:
        gen = torch.Generator().manual_seed(3)
        scale = 0.3 * float(rows[0].float().abs().mean())
        rows = [torch.cat([r, (scale * torch.randn((r.shape[0], 2, 8, 6), generator=gen)).to(dev, torch.bfloat16)],
                          1).contiguous() for r in rows]
    blocks = mesh.psum([dt.blocks for dt in dts]) + et.diag
    damp = 1e-3 * torch.diagonal(blocks, dim1=-2, dim2=-1).reshape(-1) + 1e-8
    minv = ws.spd6_inv(blocks + torch.diag_embed(damp.reshape(n, 6)), plain=True)
    b = mesh.psum([dt.jtr for dt in dts]) + et.jtr
    parts = [ws.Shard(sk, r) for sk, r in zip(shards, rows)]
    return mesh, parts, s, ws.System(rows[0], et, damp), minv, b


@pytest.mark.parametrize("nrows, used, stride", SHARD_ROW_MODES)
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_pcg_one_launch(dev, nr_model, n_shards, nrows, used, stride):
    """The distributed PCG as one cluster launch (p in shared and in device
    memory) bit-equal to the plain distributed PCG and to the composition
    it replaced, one device kernel a solve; inactive gives zeros."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    mesh, parts, s, sysm, minv, b = sharded_system(dev, nr_model, n_shards, nrows)
    sysm = sysm._replace(used=used, stride=stride)
    on = torch.ones((), dtype=torch.bool, device=dev)
    before = kernels.device_kernels["pcg_sharded"]
    xk = ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, on)
    assert kernels.device_kernels["pcg_sharded"] - before == 1
    assert torch.equal(xk, ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, on, plain=True))
    assert torch.equal(xk, ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, on, reference=True))
    ks = ws._kernel_system(s, sysm)
    data = [kernels.ShardData(sh.rows, sh.s.knn_idx32, sh.s.pts_by_node.order, sh.s.pts_by_node.off,
                              ws.heavy_order(sh.s.pts_by_node)) for sh in parts]
    xd = kernels.pcg_sharded(ks, data, minv, b, 12, 1e-3, on, used=used, stride=stride, shared_p=False)
    assert torch.equal(xk, xd)
    # the two-launch mode of a process group, with the identity as the ranks' sum
    xg = kernels.pcg_sharded(ks, data, minv, b, 12, 1e-3, on, used=used, stride=stride, reduce=lambda v: v.clone())
    assert torch.equal(xk, xg)
    assert bool(torch.isfinite(xk).all())
    assert not bool(ws.pcg_sharded(mesh, parts, s, sysm, minv, b, 12, 1e-3, ~on).any())
    assert not bool(kernels.pcg_sharded(ks, data, minv, b, 12, 1e-3, ~on, used=used, stride=stride,
                                        reduce=lambda v: v.clone()).any())


@pytest.mark.parametrize("name", INSERT_CASES)
@pytest.mark.parametrize("nc, cap", [(600, 64), (4800, 1024), (4800, 2048)])
def test_insert_apply_one_launch(dev, name, nc, cap):
    """Kernel H's apply, one launch, bit-equal to the plain delta scatter
    and to the design before (the reference mode) on the select of each
    adversarial case, the field's old values seeded."""
    from chip_smoke import insert_case, select_inputs
    from dynamicfusion_tpu_torch.models import warpfield

    cfg, field, cand, valid, d2, gate = select_inputs(torch, insert_case(name, nc, cap), dev)
    gen = torch.Generator().manual_seed(5)
    field = field._replace(positions=torch.randn((cap, 3), generator=gen).to(dev),
                           dq=torch.randn((cap, 8), generator=gen).to(dev),
                           radius=torch.rand((cap,), generator=gen).to(dev),
                           last_support=torch.randint(0, 50, (cap,), generator=gen, dtype=torch.int32).to(dev))
    plan = warpfield.InsertPlan(*kernels.insert_select(cand, d2, valid, field.active, field.count, gate,
                                                       cfg.node_coverage))
    seed = torch.randn((cap, 8), generator=gen).to(dev)
    rad = torch.rand((cap,), generator=gen).to(dev)
    fi = torch.tensor(77, dtype=torch.int32, device=dev)
    before = kernels.device_kernels["insert_apply"]
    got = kernels.insert_apply(*field, plan.slots, plan.new_pos, seed, fi, rad)
    assert kernels.device_kernels["insert_apply"] - before == 1
    ref = kernels.insert_apply(*field, plan.slots, plan.new_pos, seed, fi, rad, reference=True)
    plain = warpfield._insert_apply_plain(field, plan, seed, fi, rad)
    bits = [[t.view(torch.int32) if t.dtype == torch.float32 else t for t in f] for f in (got, ref, plain)]
    for a, b, c in zip(*bits):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_sharded_step_on_the_card_goes_through_its_kernels(dev):
    """The preset's slice over 4 shards on one card: the slab modes of C,
    K and D and the distributed PCG launch; each step against the
    single-device fixed-step step from the same state (pose 1e-4)."""
    from dynamicfusion_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh(4, devices=[dev] * 4)
    step = sharded.make_sharded_step(NR, mesh)
    ref_cfg = dataclasses.replace(NR, raycast_adaptive_step=False)
    state = sharded.make_sharded_first_frame(NR, mesh)(kinfu.init_state(NR, dev), torch.from_numpy(NR_DEPTHS[0]))
    kernels.reset_launches()
    for d in NR_DEPTHS[1:]:
        whole = sharded.gather_state(mesh, state)
        _, ro = kinfu.step(ref_cfg, whole._replace(vol=TsdfVolume(whole.vol.tsdf.clone(), whole.vol.weight.clone())),
                           torch.from_numpy(d).to(dev))
        state, out = step(state, torch.from_numpy(d))
        assert bool(out.icp_ok)
        assert float((out.pose - ro.pose).abs().max()) <= 1e-4
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in ("raycast", "brick_plan", "fuse_bricks") + SHARDED), kernels.launches


# ---------------------------------------------------------------- the float volume storages

# the (tsdf, weight) storages of the JAX config beside the default (i16, u16)
STORAGES = [("i16", "f32"), ("f32", "u16"), ("f32", "f32"), ("bf16", "u16"), ("bf16", "f32")]
STORAGE_IDS = [f"{t}-{w}" for t, w in STORAGES]
# kernels C and R read the tsdf only: its two float storages
TSDF_STORAGES = ["f32", "bf16"]
RAYCAST_MODES = [("secant", False), ("newton8", False)] + VARIANTS


def _stored(cfg, vol, tsdf_dtype, weight_dtype="u16"):
    """(the config with that storage, ``vol`` re-encoded into it)."""
    from dynamicfusion_tpu_torch.models import volume as volume_model

    c = dataclasses.replace(cfg, tsdf_dtype=tsdf_dtype, weight_dtype=weight_dtype)
    return c, volume_model.convert(vol, c)


def _bits(t):
    """A volume tensor's stored bits."""
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def _same_volume(a, b):
    return torch.equal(_bits(a.tsdf), _bits(b.tsdf)) and torch.equal(_bits(a.weight), _bits(b.weight))


def _same_map(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _clones(vol):
    return (TsdfVolume(vol.tsdf.clone(), vol.weight.clone()), TsdfVolume(vol.tsdf.clone(), vol.weight.clone()))


@pytest.mark.parametrize("tsdf_dtype", TSDF_STORAGES)
@pytest.mark.parametrize("refine,smooth", RAYCAST_MODES, ids=[f"{r}-{'grad6' if s else 'cell'}" for r, s in RAYCAST_MODES])
def test_raycast_kernel_float_storages(dev, model, refine, smooth, tsdf_dtype):
    """Kernel C on a float tsdf, every refine and normal mode: found,
    vertices and normals bit-equal to its plain version (the decode is by
    1, the float32 arithmetic the same)."""
    cfg, vol = _stored(dataclasses.replace(CFG, raycast_refine=refine, raycast_smooth_normals=smooth), model.vol,
                       tsdf_dtype)
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), model.pose)
    rows, cols = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    rays = tsdf.rays(cfg, cam2vol, cfg.intr.level(cfg.raycast_shift), rows, cols)
    before = kernels.launches["raycast"]
    got = tsdf.march_and_refine(cfg, vol.tsdf, *rays)
    ref = tsdf.march_and_refine(cfg, vol.tsdf, *rays, plain=True)
    assert kernels.launches["raycast"] == before + 1
    f = ref[0]
    assert torch.equal(got[0], f) and float(f.float().mean()) > 0.3
    # rays that found nothing: NaN from the kernel, unused in the plain version
    assert _same_map(got[1][f], ref[1][f]) and _same_map(got[2][f], ref[2][f])


@pytest.mark.parametrize("tsdf_dtype", TSDF_STORAGES)
def test_slab_raycast_kernel_float_storages(dev, model, tsdf_dtype):
    """Kernel C's slab mode on a float tsdf: every output bit-equal to its
    plain version on each of 4 shards' extended slabs."""
    from dynamicfusion_tpu_torch.parallel import sharded_raycast

    cfg, vol = _stored(dataclasses.replace(CFG, raycast_adaptive_step=False), model.vol, tsdf_dtype)
    n, halo = 4, sharded_raycast._halo_planes(cfg)
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), model.pose)
    org, dirs, tmin, tmax = tsdf.rays(cfg, cam2vol, cfg.intr, cfg.rows, cfg.cols)
    for k in range(n):
        x_off, ext = _ext_slab(vol.tsdf, k, n, halo)
        lo, hi = sharded_raycast.slab_window(cfg, k, n, org, dirs, tmin, tmax)
        got = tsdf.march_slab(cfg, ext, x_off, org, dirs, lo, hi)
        ref = tsdf.march_slab(cfg, ext, x_off, org, dirs, lo, hi, plain=True)
        f = ref[0]
        assert torch.equal(got[0], f) and torch.equal(got[4], ref[4])
        assert all(_same_map(a[f], b[f]) for a, b in zip(got[1:4], ref[1:4]))


@pytest.mark.parametrize("tsdf_dtype,weight_dtype", STORAGES, ids=STORAGE_IDS)
@pytest.mark.parametrize("mode", ["rigid", "nonrigid", "slab"])
def test_fuse_kernel_float_storages(dev, model, nr_model, mode, tsdf_dtype, weight_dtype):
    """Kernel D at each storage pair, rigid, non-rigid (warped grid, blend
    quality, packed confidence) and on 4 shards' slabs: the volume bit-equal
    to its plain version's."""
    from dynamicfusion_tpu_torch.ops import fusion
    from dynamicfusion_tpu_torch.parallel import sharded_fusion

    on = torch.ones((), dtype=torch.bool, device=dev)
    if mode == "rigid":
        cfg, vol = _stored(CFG, model.vol, tsdf_dtype, weight_dtype)
        dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(DEPTHS[3]).to(dev))
        grid = tsdf.brick_grid(cfg, se3.compose(se3.inverse(model.pose), kinfu._vol_pose(cfg, dev)))
        bp = bricks.plan(cfg, dists, grid, cfg.brick_size, cfg.intr)
        vk, vp = _clones(vol)
        bricks.fuse(cfg, vk, dists, grid, cfg.brick_size, cfg.intr, bp, on)
        bricks.fuse(cfg, vp, dists, grid, cfg.brick_size, cfg.intr, bp, on, plain=True)
        assert _same_volume(vk, vp) and not torch.equal(_bits(vk.tsdf), _bits(vol.tsdf))
        return
    st = nr_model[0]
    cfg, vol = _stored(NR, st.vol, tsdf_dtype, weight_dtype)
    depth = torch.from_numpy(NR_DEPTHS[3]).to(dev)
    _, pts, nrm, dists = preprocess.build_frame_pyramid(cfg, depth)
    conf = preprocess.incidence_confidence(pts[0], nrm[0])
    cf = fusion.coarse_field(cfg, st.warp, plain=True)
    w2c = se3.inverse(st.pose)
    if mode == "nonrigid":
        vk, vp = _clones(vol)
        ck = fusion.integrate_nonrigid(cfg, vk, cf, dists, w2c, cfg.intr, on, conf=conf)
        cp = fusion.integrate_nonrigid(cfg, vp, cf, dists, w2c, cfg.intr, on, conf=conf, plain=True)
        assert torch.equal(ck, cp) and _same_volume(vk, vp) and not torch.equal(_bits(vk.tsdf), _bits(vol.tsdf))
        return
    n, b, g = 4, cfg.brick_size, cfg.knn_field_stride
    grid = se3.transform_points(w2c, cf.warped)
    lookup = bricks.pack_depth_conf(dists, conf)
    band_cap, wide_cap = sharded_fusion.caps(cfg, n)
    dl = cfg.volume_dims // n
    for k in range(n):
        gk = bricks.corner_slab(grid, k, n, b, g).contiguous()
        qk = bricks.corner_slab(cf.q, k, n, b, g).contiguous()
        bp = bricks.plan_slab(cfg, dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap, plain=True)
        slab = TsdfVolume(vol.tsdf[k * dl:(k + 1) * dl], vol.weight[k * dl:(k + 1) * dl])
        vk, vp = _clones(slab)
        bricks.fuse(cfg, vk, lookup, gk, g, cfg.intr, bp, on, qk, packed=True)
        bricks.fuse(cfg, vp, lookup, gk, g, cfg.intr, bp, on, qk, packed=True, plain=True)
        assert _same_volume(vk, vp)


@pytest.mark.parametrize("tsdf_dtype,weight_dtype", STORAGES, ids=STORAGE_IDS)
@pytest.mark.parametrize("nonrigid", [False, True], ids=["F1", "F2"])
def test_dense_fuse_kernels_float_storages(dev, model, nr_model, nonrigid, tsdf_dtype, weight_dtype):
    """Kernels F1 and F2 (with the incidence confidence and the phase
    split) at each storage pair: the volume bit-equal to its plain
    version's."""
    from dynamicfusion_tpu_torch.ops import fusion

    ok = torch.ones((), dtype=torch.bool, device=dev)
    if not nonrigid:
        cfg, vol = _stored(dataclasses.replace(CFG, integrate_mode="dense"), model.vol, tsdf_dtype, weight_dtype)
        dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(DEPTHS[3]).to(dev))
        vol2cam = se3.compose(se3.inverse(model.pose), kinfu._vol_pose(cfg, dev))
        vk, vp = _clones(vol)
        tsdf.integrate(cfg, vk, dists, vol2cam, cfg.intr, ok=ok)
        tsdf.integrate(cfg, vp, dists, vol2cam, cfg.intr, ok=ok, plain=True)
    else:
        st = nr_model[0]
        cfg, vol = _stored(dataclasses.replace(NR, integrate_mode="dense", fusion_phase_split=2, fusion_interval=2),
                           st.vol, tsdf_dtype, weight_dtype)
        _, pts, nrm, dists = preprocess.build_frame_pyramid(cfg, torch.from_numpy(NR_DEPTHS[3]).to(dev))
        conf = preprocess.incidence_confidence(pts[0], nrm[0])
        cf = fusion.coarse_field(cfg, st.warp, plain=True)
        phase = torch.ones((), dtype=torch.int32, device=dev)
        w2c = se3.inverse(st.pose)
        vk, vp = _clones(vol)
        fusion.integrate_nonrigid(cfg, vk, cf, dists, w2c, cfg.intr, ok, conf=conf, phase=phase)
        fusion.integrate_nonrigid(cfg, vp, cf, dists, w2c, cfg.intr, ok, conf=conf, phase=phase, plain=True)
    torch.cuda.synchronize()
    assert _same_volume(vk, vp) and not torch.equal(_bits(vk.weight), _bits(vol.weight))


@pytest.mark.parametrize("tsdf_dtype,weight_dtype", STORAGES, ids=STORAGE_IDS)
def test_extract_kernels_float_storages(dev, model, tsdf_dtype, weight_dtype):
    """Kernels L and R at each storage pair: the cloud, its flags and count,
    and its normals bit-equal to their plain versions."""
    cfg, vol = _stored(CFG, model.vol, tsdf_dtype, weight_dtype)
    ck = tsdf.extract_cloud(cfg, vol, 1 << 16, min_weight=1.0)
    cp = tsdf.extract_cloud(cfg, vol, 1 << 16, min_weight=1.0, plain=True)
    assert torch.equal(ck.count, cp.count) and torch.equal(ck.valid, cp.valid) and int(cp.count) > 700
    assert _same_map(ck.points, cp.points)
    got = tsdf.extract_normals(cfg, vol, cp.points)
    ref = tsdf.extract_normals(cfg, vol, cp.points, plain=True)
    assert _same_map(got, ref) and int((~torch.isnan(got[:, 0])).sum()) > 500


@pytest.mark.parametrize("tsdf_dtype,weight_dtype", STORAGES, ids=STORAGE_IDS)
def test_float_storages_on_the_card_go_through_their_kernels(dev, tsdf_dtype, weight_dtype):
    """The non-rigid slice and its dense variant in each storage: the
    volume keeps its storage, C, D, L (F1, F2 dense) launch, each step
    against the plain step from the same state (pose 1e-5)."""
    from dynamicfusion_tpu_torch.models import volume as volume_model

    for mode in ("brick", "dense"):
        cfg = dataclasses.replace(NR, integrate_mode=mode, tsdf_dtype=tsdf_dtype, weight_dtype=weight_dtype)
        kernels.reset_launches()
        state = kinfu.first_frame(cfg, kinfu.init_state(cfg, dev), torch.from_numpy(NR_DEPTHS[0]).to(dev))
        for d in NR_DEPTHS[1:]:
            prev = state._replace(vol=TsdfVolume(state.vol.tsdf.clone(), state.vol.weight.clone()))
            _, ref = kinfu.step(cfg, prev, torch.from_numpy(d).to(dev), plain=True)
            state, out = kinfu.step(cfg, state, torch.from_numpy(d).to(dev))
            assert bool(out.icp_ok) and float((out.pose - ref.pose).abs().max()) <= 1e-5
        torch.cuda.synchronize()
        assert state.vol.tsdf.dtype == volume_model._TSDF_DTYPES[tsdf_dtype]
        assert state.vol.weight.dtype == volume_model._WEIGHT_DTYPES[weight_dtype]
        fused = ("integrate_dense", "integrate_dense_nonrigid") if mode == "dense" else ("fuse_bricks",)
        assert all(kernels.launches[k] > 0 for k in ("raycast", "extract_cloud") + fused), kernels.launches


# ---------------------------------------------------------------- K's cluster and D's persistent grid


def _same_plan(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.classes, b.classes)) and all(
        torch.equal(x, y) for x, y in zip(a.work, b.work))


def _device_kernels(name, fn):
    before = kernels.device_kernels[name]
    out = fn()
    return out, kernels.device_kernels[name] - before


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_brick_plan_cluster_is_one_block(dev, case):
    """Kernel K's cluster bit for bit against its one-block mode and the
    plain version (the preset's 4 096 bricks, 32^3 at ``default_kinfu()``,
    the capped lists, the phase split, ``small()``), two device kernels a
    call in each mode; gated (ok false): count 0 and counts 0 in each."""
    cfg, dists, grid, g, phase, split = plan_inputs(torch, dev, case)
    bk, n_new = _device_kernels("brick_plan", lambda: bricks.plan(cfg, dists, grid, g, cfg.intr, phase, split))
    b1, n_one = _device_kernels("brick_plan", lambda: bricks.plan(cfg, dists, grid, g, cfg.intr, phase, split,
                                                                  reference=True))
    bp = bricks.plan(cfg, dists, grid, g, cfg.intr, phase, split, plain=True)
    assert _same_plan(bk, b1) and _same_plan(bk, bp) and (n_new, n_one) == (2, 2)
    assert int(bk.work.count[0]) > 0
    if "capped" in case:
        c = bk.classes
        n_hi = int(((c.cls == bricks.BAND) & c.surf).sum())
        cap = min(cfg.integrate_band_cap, c.cls.shape[0])
        # the permuted rest of the band fills the cap; some bricks dropped
        assert n_hi < cap < int((c.cls == bricks.BAND).sum()) and int(bk.work.counts[2]) > 0
    off = torch.zeros((), dtype=torch.bool, device=dev)
    for kw in (dict(), dict(reference=True), dict(plain=True)):
        gated = bricks.plan(cfg, dists, grid, g, cfg.intr, phase, split, ok=off, **kw)
        assert int(gated.work.count[0]) == 0 and gated.work.counts.tolist() == [0, 0, 0]


@pytest.mark.parametrize("split", [1, 2])
def test_brick_plan_cluster_slab_mode(dev, split):
    """K's slab mode at the preset's 4 shards x 1 024 bricks (the sharded
    fusion's caps, the phase on the global brick plane): the cluster bit
    for bit against its one-block mode and the plain version."""
    from dynamicfusion_tpu_torch.parallel import sharded_fusion

    cfg, dists, grid, g, _, _ = plan_inputs(torch, dev, "preset_warped")
    cfg = dataclasses.replace(cfg, fusion_phase_split=split)
    phase = torch.ones((), dtype=torch.int32, device=dev)
    n, b = 4, cfg.brick_size
    band_cap, wide_cap = sharded_fusion.caps(cfg, n)
    dl = cfg.volume_dims // n
    listed = 0
    for k in range(n):
        gk = bricks.corner_slab(grid, k, n, b, g).contiguous()
        args = (cfg, dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap, phase, split)
        bk = bricks.plan_slab(*args)
        assert bk.classes.cls.shape == (1024,)
        assert _same_plan(bk, bricks.plan_slab(*args, reference=True))
        assert _same_plan(bk, bricks.plan_slab(*args, plain=True))
        listed += int(bk.work.count[0])
    assert listed > 0


def test_gated_integrate_leaves_the_volume(dev, nr_model):
    """``integrate_bricks`` with ok false: K plans nothing, D fuses
    nothing, the counts are zero."""
    from dynamicfusion_tpu_torch.ops import fusion

    st = nr_model[0]
    dists = preprocess.compute_dists(NR.intr, torch.from_numpy(NR_DEPTHS[3]).to(dev))
    cf = fusion.coarse_field(NR, st.warp, plain=True)
    grid = se3.transform_points(se3.inverse(st.pose), cf.warped)
    vol = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    off = torch.zeros((), dtype=torch.bool, device=dev)
    counts = bricks.integrate_bricks(NR, vol, dists, grid, NR.knn_field_stride, NR.intr, ok=off, q_grid=cf.q)
    assert counts.tolist() == [0, 0, 0] and _same_volume(vol, st.vol)


@pytest.mark.parametrize("tsdf_dtype,weight_dtype", [("i16", "u16")] + STORAGES,
                         ids=["i16-u16"] + STORAGE_IDS)
@pytest.mark.parametrize("mode", ["rigid", "nonrigid", "slab"])
def test_fuse_persistent_is_reference(dev, model, nr_model, mode, tsdf_dtype, weight_dtype):
    """Kernel D's persistent grid bit for bit against its reference mode
    (a block a slot) at each storage pair, rigid (b = g = 16), non-rigid
    (g 2, the blend quality, the packed confidence) and on 4 shards'
    slabs; one device kernel a call in each mode."""
    from dynamicfusion_tpu_torch.ops import fusion
    from dynamicfusion_tpu_torch.parallel import sharded_fusion

    on = torch.ones((), dtype=torch.bool, device=dev)
    if mode == "rigid":
        cfg, vol = _stored(CFG, model.vol, tsdf_dtype, weight_dtype)
        dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(DEPTHS[3]).to(dev))
        grid = tsdf.brick_grid(cfg, se3.compose(se3.inverse(model.pose), kinfu._vol_pose(cfg, dev)))
        g = cfg.brick_size
        jobs = [(vol, dists, grid, None, False, bricks.plan(cfg, dists, grid, g, cfg.intr))]
    else:
        st = nr_model[0]
        cfg, vol = _stored(NR, st.vol, tsdf_dtype, weight_dtype)
        depth = torch.from_numpy(NR_DEPTHS[3]).to(dev)
        _, pts, nrm, dists = preprocess.build_frame_pyramid(cfg, depth)
        lookup = bricks.pack_depth_conf(dists, preprocess.incidence_confidence(pts[0], nrm[0]))
        cf = fusion.coarse_field(cfg, st.warp, plain=True)
        grid = se3.transform_points(se3.inverse(st.pose), cf.warped)
        g, b = cfg.knn_field_stride, cfg.brick_size
        if mode == "nonrigid":
            jobs = [(vol, lookup, grid, cf.q, True, bricks.plan(cfg, dists, grid, g, cfg.intr))]
        else:
            n = 4
            band_cap, wide_cap = sharded_fusion.caps(cfg, n)
            dl = cfg.volume_dims // n
            jobs = []
            for k in range(n):
                gk = bricks.corner_slab(grid, k, n, b, g).contiguous()
                qk = bricks.corner_slab(cf.q, k, n, b, g).contiguous()
                slab = TsdfVolume(vol.tsdf[k * dl:(k + 1) * dl], vol.weight[k * dl:(k + 1) * dl])
                jobs.append((slab, lookup, gk, qk, True,
                             bricks.plan_slab(cfg, dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap)))
    changed = False
    for v, lookup, gk, qk, packed, bp in jobs:
        vk, vr = _clones(v)
        assert kernels.fuse_bricks_persistent(vk.tsdf, vk.weight, cfg.brick_size, g)
        _, n_new = _device_kernels("fuse_bricks", lambda: bricks.fuse(cfg, vk, lookup, gk, g, cfg.intr, bp, on, qk,
                                                                      packed))
        _, n_ref = _device_kernels("fuse_bricks", lambda: bricks.fuse(cfg, vr, lookup, gk, g, cfg.intr, bp, on, qk,
                                                                      packed, reference=True))
        assert _same_volume(vk, vr) and (n_new, n_ref) == (1, 1)
        changed = changed or not _same_volume(vk, v)
    assert changed


@pytest.mark.parametrize("g", [8, 16])
def test_fuse_persistent_is_reference_full_size(dev, g):
    """D's persistent grid against its reference mode at the preset's 256^3
    (g 8 with a blend quality and the packed lookup, g 16 rigid) on a
    volume of seeded codes: bit for bit, and ok false changes nothing."""
    case = "preset_warped" if g == 8 else "preset_rigid_split"
    cfg, dists, grid, g_, _, _ = plan_inputs(torch, dev, case)
    assert g_ == g
    bp = bricks.plan(cfg, dists, grid, g, cfg.intr)
    rng = np.random.RandomState(g)
    d = cfg.volume_dims
    tsdf_codes = torch.from_numpy(rng.randint(-32767, 32768, (d, d, d)).astype(np.int16)).to(dev)
    w_codes = torch.from_numpy(rng.randint(0, 4096, (d, d, d)).astype(np.int16)).to(dev).view(torch.uint16)
    vol = TsdfVolume(tsdf_codes, w_codes)
    q, lookup, packed = None, dists, g == 8
    if packed:
        conf = torch.from_numpy(rng.rand(*dists.shape).astype(np.float32)).to(dev)
        lookup = bricks.pack_depth_conf(dists, conf)
        q = torch.from_numpy(rng.rand(*grid.shape[:3]).astype(np.float32)).to(dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    vk, vr = _clones(vol)
    bricks.fuse(cfg, vk, lookup, grid, g, cfg.intr, bp, on, q, packed)
    bricks.fuse(cfg, vr, lookup, grid, g, cfg.intr, bp, on, q, packed, reference=True)
    assert _same_volume(vk, vr) and not _same_volume(vk, vol)
    bricks.fuse(cfg, vk, lookup, grid, g, cfg.intr, bp, ~on, q, packed)
    assert _same_volume(vk, vr)
