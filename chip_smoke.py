#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dynamicfusion_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames N] [--nr-frames M] [--profile DIR]

Phases (any failure exits non-zero; nothing is caught and ignored):

1. build the CUDA kernels from ``dynamicfusion_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build time;
2. run each kernel on the card at the main paths' shapes, on seeded
   synthetic inputs, hold it against its plain PyTorch version on the same
   inputs, and time both: kernels A-D at the rigid slice's (640x480 depth,
   256^3 volume, 160x120 model maps), kernels E-H and D's non-rigid
   arguments at the dynamicfusion preset's (1024 nodes, 33^3 coarse
   corners, 19 200 map points, 3 200 solve points, 4 096 edges, 4 800
   insertion candidates), and at the preset's shapes kernel C's newton8
   branch, kernel I (dists, the depth pyramid to 80x60, point/normal maps
   with the incidence confidence, the 2x2 map resize), kernel J (the
   160x120 march band) and kernel K (the 11-level mip, 4 096 brick classes
   and the work list, which must equal the plain version's bit for bit);
3. drive ``DynamicFusion`` on the rigid slice config for N frames of a
   sphere+plane orbit, with every launch counter reset just before and
   read just after; kernels A-D (C's secant branch) and I-K must have
   launched and ICP must succeed on every frame; then the same frames
   through the plain path, poses compared, the final pose held against the
   analytic orbit;
4. drive ``DynamicFusion`` on the dynamicfusion preset itself
   (``default_dynamicfusion()``: 640x480 / 256^3 / 1024 nodes, the newton8
   refine) for M frames of ``bench.py``'s deforming scene, counters reset
   just before and read just after, the steady frames under
   ``torch.cuda.set_sync_debug_mode("error")`` (a step that waits for the
   device raises); every kernel of the path (A-K) must have launched, ICP
   must succeed and the solve must not raise its cost on every frame,
   fusion must run on the frames 6, 12, 18, ...; then the plain path's
   step from each of the kernel path's states, pose and initial solve
   cost held against the kernel path's; then the same frames through the
   plain path free running, node sets held equal, poses printed beside
   both paths' own spread (the solve's bf16 rows make the trajectories
   part chaotically, by up to ~1 mm in 20 frames);
5. print the per-kernel JSON line, the card's name and power limit, and
   last the result line ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a torch.profiler table and trace of 3 non-rigid
frames and prints the device's busy time and idle share over them.
``--dump-solve FILE`` writes the warp field and the solve's point sets of
the phase-2 state (the preset after three frames, the next frame tracked)
to an ``.npz``, for holding another solver against the same system.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

# tolerances (kernel vs its plain version on the same inputs, same card)
TOL_BILATERAL_MM = 1          # max |diff| in mm; ties of round-half-even may flip
TOL_BILATERAL_FRAC = 1e-4     # fraction of pixels allowed to differ at all
TOL_ICP_REL = 1e-4            # max |diff| of A and b over max |entry|: sum order differs
TOL_RAYCAST_FOUND_FRAC = 1e-3  # fraction of rays whose hit/miss differs
TOL_RAYCAST_M = 1e-4          # max vertex diff (m) where both hit
TOL_FUSE_LSB = 1              # max code diff of tsdf/weight
TOL_FUSE_FRAC = 1e-4          # fraction of voxels whose codes differ at all
# non-rigid fusion: codes differing by more than 1 LSB on < 1e-4 of voxels,
# weights within 1 LSB (PyTorch on CUDA divides by a Python scalar as a
# product with its reciprocal: the plain unpacked depth and confidence may
# differ from the kernel's quotients in the last bit)
TOL_FUSE_NR_FRAC = 1e-4
TOL_KNN_IDX_FRAC = 1e-4       # queries whose neighbour lists differ (a tie within an ulp)
TOL_FIELD = 1e-5              # blended dual quaternions, quality, warped points (m), weights
TOL_D2 = 1e-6                 # squared distances (m^2)
TOL_DATA_REL = 1e-4           # data term Jᵀr, blocks, cost: sum order differs
TOL_EDGE_REL = 1e-5           # edge term
TOL_SPD6_REL = 1e-4           # spd6_inv on the damped solver blocks
TOL_MATVEC_REL = 1e-3         # one bf16 rounding of t may flip with the sum order (2^-8 of one entry)
TOL_PCG_REL = 1e-2            # 12 iterations amplify such a flip
TOL_POSE_PLAIN_M = 1e-3       # kernel path vs plain path, any frame's translation
# non-rigid: the plain step from the kernel path's previous state. ICP, the
# pre-alignment and the solve's initial cost see the same inputs and differ
# only by the two implementations' roundings (sum orders of the ICP
# system); one flipped projective association moves a pose by ~1e-5 m
TOL_STEP_POSE = 1e-5          # translation (m) and rotation entries
TOL_STEP_COST0_REL = 1e-4     # the solve's initial cost, relative
# non-rigid, free running (printed, not a check): the bf16 rows of the solve
# let a last bit move the LM step and ICP carries it into the pose, so the
# two paths part by up to ~1 mm in 20 frames; the print sets the distance
# beside max(TOL_POSE_PLAIN_M, SPREAD x the paths' own spread: the kernel
# path from frame-0 node positions moved by 1e-7 relative, the plain path
# run again, whose index_add_ sums in atomic order)
SPREAD = 2.0
PERTURB_SEEDS = (0, 1)
TOL_POSE_TRUTH_M = 0.01       # kernel path vs analytic orbit, final translation
# kernel I: CUDA PyTorch divides by a Python scalar as a product with its
# reciprocal where the kernel divides (as the JAX package does), so dists,
# points and normals may differ in the last bits; the pyramid and the
# resize are exact (sums of whole millimetres, the same sum order)
TOL_DISTS_REL = 1e-6          # dists, relative
TOL_POINTS_M = 1e-6           # point maps (m)
TOL_NORMAL = 1e-4             # normals and incidence confidence, ...
TOL_NORMAL_FRAC = 1e-3        # ... except on this fraction of valid pixels

# H100 SXM peaks (NVIDIA data sheet): memory 3.35 TB/s, float32 (no tensor core) 67 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# four spheres and a plane: one sphere centred over a plane is symmetric
# about the plane's normal through its centre, which leaves the rotation
# about that axis unobservable to point-to-plane ICP
SCENE = dict(
    spheres=[
        dict(center=(0.0, 0.0, 1.0), radius=0.2),
        dict(center=(0.25, 0.15, 1.1), radius=0.12),
        dict(center=(-0.22, 0.12, 0.95), radius=0.1),
        dict(center=(0.1, -0.2, 1.05), radius=0.1),
    ],
    plane_z=1.3,
)
TARGET = (0.0, 0.0, 1.0)
ANGLE_STEP = 0.005  # rad per frame, ~5 mm of camera motion

RIGID_KERNELS = ("bilateral", "icp_reduce", "raycast", "fuse_bricks")
# the kernels of the per-frame stencils and the brick plan (I-K): both paths run them
STENCIL_KERNELS = ("depth_dists", "pyramid_down", "points_normals", "resize_maps", "march_bands", "brick_plan")
# (source, the TPU kernel-role function it replaces) of each JSON row; a
# row's launches are its counter's (the row name, but for the rows below)
# on the rigid path for A-D and on the preset's path for the rest
ROWS = {
    "bilateral": ("bilateral.cu", "dynamicfusion_tpu/ops/preprocess.py:43"),
    "icp_reduce": ("icp_reduce.cu", "dynamicfusion_tpu/solvers/icp.py:38"),
    "raycast": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:386"),
    "raycast_newton8": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:529"),
    "fuse_bricks": ("fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552"),
    "fuse_bricks_nonrigid": ("fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552"),
    "depth_dists": ("preprocess.cu", "dynamicfusion_tpu/ops/preprocess.py:165"),
    "pyramid_down": ("preprocess.cu", "dynamicfusion_tpu/ops/preprocess.py:91"),
    "points_normals": ("preprocess.cu", "dynamicfusion_tpu/ops/preprocess.py:124"),
    "resize_maps": ("preprocess.cu", "dynamicfusion_tpu/ops/preprocess.py:172"),
    "march_bands": ("bands.cu", "dynamicfusion_tpu/pipeline/kinfu.py:107"),
    "brick_plan": ("classify.cu", "dynamicfusion_tpu/ops/bricks.py:213"),
    "knn_blend": ("knn_blend.cu", "dynamicfusion_tpu/models/warpfield.py:148"),
    "mutual_nearest": ("knn_blend.cu", "dynamicfusion_tpu/models/warpfield.py:267"),
    "warp_trilinear": ("knn_blend.cu", "dynamicfusion_tpu/ops/fusion.py:109"),
    "data_term": ("data_term.cu", "dynamicfusion_tpu/solvers/warp_solver.py:299"),
    "edge_term": ("pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:341"),
    "spd6_inv": ("pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:792"),
    "pcg": ("pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:823"),
    "insert_select": ("insert_nodes.cu", "dynamicfusion_tpu/models/warpfield.py:372"),
    "insert_apply": ("insert_nodes.cu", "dynamicfusion_tpu/models/warpfield.py:433"),
}
COUNTER = {"raycast_newton8": "raycast", "fuse_bricks_nonrigid": "fuse_bricks"}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() over reps calls between two CUDA events. A spin
    kernel queued first holds the stream until every launch is enqueued,
    so a kernel's time is its device time, not its host launch cost; a
    function that syncs with the host (the plain versions) still counts
    its host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / PEAK_BYTES * 1e3
    to = flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(name: str, ok: bool, msg: str) -> None:
    print(f"[check] {name}: {msg} -> {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} failed: {msg}")


def rel_err(torch, a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def abs_err(torch, a, b) -> float:
    return float(torch.nan_to_num((a.float() - b.float()).abs(), nan=0.0).max())


def rigid_kernels(torch, args, report, dev, card):
    """Phase 2 for kernels A-D at the rigid slice's shapes."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.ops import bricks, preprocess, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import icp

    cfg = DynamicFusionConfig.rigid_slice()
    intr = cfg.intr
    rng = np.random.RandomState(0)
    frame = rigid_frame_fn(cfg)

    depth0 = frame(0).astype(np.int32)
    noisy = np.where(depth0 > 0, depth0 + rng.randint(-3, 4, depth0.shape), 0)
    d_t = torch.from_numpy(noisy.astype(np.uint16)).to(dev)

    # A: bilateral
    k_out = preprocess.bilateral_filter(d_t, cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial, cfg.bilateral_sigma_depth)
    p_out = preprocess.bilateral_filter_plain(d_t, cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial, cfg.bilateral_sigma_depth)
    diff = (k_out.to(torch.int32) - p_out.to(torch.int32)).abs()
    err = int(diff.max())
    frac = float((diff > 0).float().mean())
    check("bilateral", err <= TOL_BILATERAL_MM and frac <= TOL_BILATERAL_FRAC,
          f"max |diff| {err} mm (tol {TOL_BILATERAL_MM}), differing {frac:.2e} (tol {TOL_BILATERAL_FRAC})")
    h, w = cfg.rows, cfg.cols
    half = cfg.bilateral_kernel_size // 2
    taps = sum((h - abs(dy)) * (w - abs(dx)) for dy in range(-half, half + 1) for dx in range(-half, half + 1))
    args_a = (cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial, cfg.bilateral_sigma_depth)
    report["bilateral"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.bilateral_filter(d_t, *args_a)),
        plain_ms=cuda_ms(torch, lambda: preprocess.bilateral_filter_plain(d_t, *args_a), reps=5),
        bound=bound_ms(h * w * 2 * 2, taps * 10.0),
        library_ms=None,
    )

    # a model volume from a few plain-path frames (the kernels' inputs)
    plain_df = kinfu.DynamicFusion(cfg, device=dev, plain=True)
    for i in range(4):
        plain_df(torch.from_numpy(frame(i)).to(dev))
    st = plain_df.state
    dnext = torch.from_numpy(frame(4)).to(dev)
    dists = preprocess.compute_dists(intr, dnext)
    pose = st.pose

    # D: brick fusion on clones of the volume
    vol2cam = se3.compose(se3.inverse(pose), kinfu._vol_pose(cfg, dev))
    g = cfg.brick_size
    cam_grid = tsdf_ops.brick_grid(cfg, vol2cam)
    rows, cols = dists.shape
    nbr = (cfg.volume_dims // g) ** 3
    bp = bricks.plan(cfg, dists, cam_grid, g, intr)
    work = bp.work
    ok_t = torch.ones((), dtype=torch.bool, device=dev)
    vk = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    vp = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())

    def fuse_kernel(v):
        bricks.fuse(cfg, v, dists, cam_grid, g, intr, bp, ok_t)

    def fuse_plain(v):
        bricks.fuse(cfg, v, dists, cam_grid, g, intr, bp, ok_t, plain=True)

    fuse_kernel(vk)
    fuse_plain(vp)
    dt_ = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    dw_ = (vk.weight.to(torch.int32) - vp.weight.to(torch.int32)).abs()
    err = int(torch.maximum(dt_.max(), dw_.max()))
    frac = float(((dt_ > 0) | (dw_ > 0)).float().mean())
    n_work = int(work.count[0])
    kinds = work.kind[:n_work]
    n_front = int((kinds == bricks.FRONT).sum())
    check("fuse_bricks", err <= TOL_FUSE_LSB and frac <= TOL_FUSE_FRAC,
          f"max |code diff| {err} (tol {TOL_FUSE_LSB}), differing {frac:.2e} (tol {TOL_FUSE_FRAC}); "
          f"{n_work} bricks listed ({n_front} front), counts {work.counts.tolist()}")
    bv = g ** 3
    nvox = n_work * bv
    fuse_bytes = nvox * 8 + rows * cols * 4 + cam_grid.numel() * 4 + nbr * 4 * 4
    fuse_flops = n_front * bv * 8.0 + (n_work - n_front) * bv * 70.0
    scratch = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    report["fuse_bricks"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: fuse_kernel(scratch)),
        plain_ms=cuda_ms(torch, lambda: fuse_plain(scratch), reps=3),
        bound=bound_ms(fuse_bytes, fuse_flops),
        library_ms=None,
    )
    del scratch, vk, vp

    # C: ray march + refine at the model-map resolution with the temporal band
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    intr_t = intr.level(cfg.raycast_shift)
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), pose)
    band = kinfu._temporal_band(cfg, st.can_points, dists)
    ray_org, dirs, tmin, tmax = tsdf_ops.rays(cfg, cam2vol, intr_t, rows_t, cols_t, t_band=band)
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    fk, vk_, nk_ = tsdf_ops.march_and_refine(cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax)
    fp, vp_, np_ = tsdf_ops.march_and_refine_plain(cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax)
    both = fk & fp
    found_frac = float((fk != fp).float().mean())
    err = float((vk_ - vp_)[both].abs().max()) if bool(both.any()) else 0.0
    # a hit whose refined point left the volume carries a NaN normal in both
    nan_same = torch.equal(torch.isnan(nk_[both]), torch.isnan(np_[both]))
    nerr = float(torch.nan_to_num((nk_ - np_)[both].abs(), nan=0.0).max()) if bool(both.any()) else 0.0
    check("raycast", found_frac <= TOL_RAYCAST_FOUND_FRAC and err <= TOL_RAYCAST_M and nan_same,
          f"hit/miss differs on {found_frac:.2e} of rays (tol {TOL_RAYCAST_FOUND_FRAC}), "
          f"max vertex diff {err:.3e} m (tol {TOL_RAYCAST_M}), max normal diff {nerr:.3e}; "
          f"{int(fk.sum())} of {fk.numel()} rays hit")
    n_samples = march_samples(torch, cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax) + 24.0 * int(fk.sum())
    n_rays = rows_t * cols_t
    report["raycast"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.march_and_refine(
            st.vol.tsdf, ray_org, dirs, tmin, tmax, cfg.voxel_size, step, tsdf_ops.march_steps(cfg),
            cfg.raycast_adaptive_step)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.march_and_refine_plain(cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax), reps=3),
        bound=bound_ms(n_samples * 2 + n_rays * (12 + 8 + 1 + 24), n_samples * 12.0 + int(fk.sum()) * 250.0),
        library_ms=None,
    )

    # B: ICP system at the tracking resolution (live frame vs the model maps)
    _, pts_pyr, nrm_pyr, _ = preprocess.build_frame_pyramid(cfg, dnext, first_point_level=cfg.raycast_shift)
    cp, cn = pts_pyr[cfg.raycast_shift], nrm_pyr[cfg.raycast_shift]
    pp, pn = st.prev_points[0], st.prev_normals[0]
    dist2 = cfg.icp_dist_thres ** 2
    min_cos = math.cos(cfg.icp_angle_thres)
    t_cur = torch.eye(4, device=dev)
    ak, bk = icp._build_system(intr_t, t_cur, cp, cn, pp, pn, dist2, min_cos)
    ap_, bp_ = icp._build_system_plain(intr_t, t_cur, cp, cn, pp, pn, dist2, min_cos)
    scale = float(torch.maximum(ap_.abs().max(), bp_.abs().max()))
    err = float(torch.maximum((ak - ap_).abs().max(), (bk - bp_).abs().max()))
    check("icp_reduce", err <= TOL_ICP_REL * scale,
          f"max |diff| {err:.3e} over max |entry| {scale:.3e} (rel tol {TOL_ICP_REL})")
    npx = cp.shape[0] * cp.shape[1]
    n_model = pp.shape[0] * pp.shape[1]
    report["icp_reduce"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.icp_build_system(intr_t, t_cur, cp, cn, pp, pn, dist2, min_cos)),
        plain_ms=cuda_ms(torch, lambda: icp._build_system_plain(intr_t, t_cur, cp, cn, pp, pn, dist2, min_cos)),
        # live points+normals and model points+normals read once, pose in, 27 sums out;
        # ~100 float operations a pixel (transform, projection, gates, 27 products)
        bound=bound_ms((npx + n_model) * 24 * 2 + 64 + 27 * 4, npx * 100.0),
        library_ms=None,
    )


def march_samples(torch, cfg, tsdf, ray_org, dirs, tmin, tmax) -> float:
    """The nearest-voxel samples this run's rays march (counted as the
    plain loop runs them): the data-dependent work of kernel C's march."""
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    inv_vs = 1.0 / cfg.voxel_size
    t = tmin.clone()
    done = tmin >= tmax
    prev = tsdf_ops.fetch_nearest(tsdf, (ray_org + dirs * t[..., None]) * inv_vs)
    samples = torch.ones_like(t)
    for _ in range(tsdf_ops.march_steps(cfg)):
        dtt = torch.where(prev > 0.99, 2.0 * step, step)
        tn = t + dtt
        act = ~done & (t < tmax)
        nxt = tsdf_ops.fetch_nearest(tsdf, (ray_org + dirs * tn[..., None]) * inv_vs)
        samples = samples + act.float()
        done = done | (act & (((prev > 0) & (nxt < 0)) | ((prev < 0) & (nxt > 0)))) | (tn >= tmax)
        t = torch.where(act, tn, t)
        prev = torch.where(act, nxt, prev)
    return float(samples.sum())


def rigid_frame_fn(cfg):
    from dynamicfusion_tpu_torch.io import synthetic

    def frame(i: int) -> np.ndarray:
        pose = synthetic.orbit_pose(ANGLE_STEP * i, target=TARGET)
        return synthetic.scene_depth(cfg.intr, cfg.rows, cfg.cols, pose, **SCENE)

    return frame


def nonrigid_kernels(torch, args, report, dev, nr_depths):
    """Phase 2 for kernels E-H and D's non-rigid arguments at the preset's
    shapes, on the state after three frames of the kernel path; then C's
    newton8 branch and kernels I-K (``stencil_kernels``)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import bricks, fusion
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = DynamicFusionConfig.default_dynamicfusion()
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in nr_depths[:3]:
        df(d)
    st = df.state
    field = st.warp
    n = field.positions.shape[0]
    # the next frame tracked (ICP, pre-alignment) as the step tracks it
    tr = kinfu.track(cfg, st, torch.from_numpy(nr_depths[3]).to(dev))
    inputs, pts_pyr, nrm_pyr, dists = tr.inputs, tr.points, tr.normals, tr.dists
    check("nonrigid_state", bool(tr.icp_res.ok), f"nodes {int(field.count)} of {n}, solve inputs P = "
          f"{inputs.p_can.shape[0]}, ICP ok on the next frame")
    if args.dump_solve:
        np.savez_compressed(
            args.dump_solve, **{f"warp_{k}": v.cpu().numpy() for k, v in field._asdict().items()},
            **{f"inputs_{k}": v.cpu().numpy() for k, v in inputs._asdict().items()},
        )
        print(f"[dump] warp field and solve inputs -> {args.dump_solve}", flush=True)
    stencil_kernels(torch, report, dev, cfg, st, nr_depths[3])

    # E: KNN + DQB blend + warp at the coarse corners (the shared coarse field)
    q = fusion.coarse_corner_points(cfg, dev)
    nq = q.shape[0]
    k8 = cfg.knn_k
    kb = warpfield.knn_blend(field, q, k8, blend=True, warp=True)
    pb = warpfield.knn_blend(field, q, k8, blend=True, warp=True, plain=True)
    same = (kb.idx == pb.idx).all(dim=1)
    idx_frac = float((~same).float().mean())
    err = max(abs_err(torch, a[same], b[same]) for a, b in
              ((kb.w, pb.w), (kb.blend, pb.blend), (kb.quality, pb.quality), (kb.points, pb.points)))
    d2err = abs_err(torch, kb.d2, pb.d2)
    check("knn_blend", idx_frac <= TOL_KNN_IDX_FRAC and err <= TOL_FIELD and d2err <= TOL_D2,
          f"{nq} corners x {n} nodes: neighbour lists differ on {idx_frac:.2e} (tol {TOL_KNN_IDX_FRAC}), "
          f"max d2 diff {d2err:.2e} (tol {TOL_D2}), max weight/blend/quality/point diff {err:.2e} (tol {TOL_FIELD})")
    node_b = n * (12 + 1 + 4 + 32)
    report["knn_blend"] = dict(
        err=max(err, d2err),
        ms=cuda_ms(torch, lambda: kernels.knn_blend(field.positions, field.active, field.radius, field.dq, q, k8,
                                                     blend=True, warp=True)),
        plain_ms=cuda_ms(torch, lambda: warpfield.knn_blend(field, q, k8, blend=True, warp=True, plain=True), reps=3),
        # nodes and queries in; d2, idx, w, blend, quality, warped point out;
        # ~10 operations a (query, node) pair for the expansion and the compare
        bound=bound_ms(node_b + nq * 12 + nq * (k8 * 16 + 32 + 4 + 12), nq * n * 10.0 + nq * k8 * 250.0),
        library_ms=None,
    )

    # E: the mutual-nearest distances of node insertion
    ins = cfg.node_insert_stride
    cand = inputs.p_can[::ins].contiguous()
    valid = ~torch.isnan(cand[:, 0])
    nc = cand.shape[0]
    ck, nk = warpfield.mutual_nearest(field, cand, valid)
    cp, npl = warpfield.mutual_nearest(field, cand, valid, plain=True)
    err = max(abs_err(torch, ck, cp), abs_err(torch, nk, npl))
    check("mutual_nearest", err <= TOL_D2,
          f"{nc} candidates x {n} nodes: max d2 diff {err:.2e} (tol {TOL_D2})")
    report["mutual_nearest"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.mutual_nearest(field.positions, field.active, cand, valid)),
        plain_ms=cuda_ms(torch, lambda: warpfield.mutual_nearest(field, cand, valid, plain=True), reps=5),
        bound=bound_ms(n * 13 + nc * 13 + (nc + n) * 4, nc * n * 11.0),
        library_ms=None,
    )

    # E: the trilinear warp of the model maps through the coarse grid
    cf = fusion.coarse_field(cfg, field)
    mp = se3.transform_points(st.pose, st.can_points).reshape(-1, 3).contiguous()
    mn = se3.rotate_dirs(st.pose, st.can_normals).reshape(-1, 3).contiguous()
    nm = mp.shape[0]
    wk = fusion.warp_points_trilinear(cfg, cf.dq, mp, mn)
    wpl = fusion.warp_points_trilinear(cfg, cf.dq, mp, mn, plain=True)
    nan_same = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(wk, wpl))
    err = max(abs_err(torch, a, b) for a, b in zip(wk, wpl))
    check("warp_trilinear", nan_same and err <= TOL_FIELD,
          f"{nm} map points: NaNs alike {nan_same}, max point/normal diff {err:.2e} (tol {TOL_FIELD})")
    org = tuple(float(v) for v in cfg.volume_origin)
    cell = cfg.knn_field_stride * cfg.voxel_size
    report["warp_trilinear"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.warp_trilinear(cf.dq, mp, mn, org, cell)),
        plain_ms=cuda_ms(torch, lambda: fusion.warp_points_trilinear(cfg, cf.dq, mp, mn, plain=True), reps=5),
        bound=bound_ms(cf.dq.numel() * 4 + nm * 48, nm * 400.0),
        library_ms=None,
    )

    # F: the data term with the system (rows, blocks) at the solve points
    s = ws.prepare(cfg, field, inputs)
    npt = s.p_can.shape[0]
    dk = ws.data_term(cfg, s, field.dq, True)
    dp = ws.data_term(cfg, s, field.dq, True, plain=True)
    errs = [rel_err(torch, dk.jtr, dp.jtr), rel_err(torch, dk.blocks, dp.blocks), rel_err(torch, dk.cost, dp.cost)]
    check("data_term", max(errs) <= TOL_DATA_REL,
          f"{npt} points: relative diff Jᵀr {errs[0]:.2e}, blocks {errs[1]:.2e}, cost {errs[2]:.2e} (tol {TOL_DATA_REL})")
    lists_b = (npt * 8 + n + 1) * 4
    report["data_term"] = dict(
        err=max(abs_err(torch, dk.jtr, dp.jtr), abs_err(torch, dk.blocks, dp.blocks)),
        ms=cuda_ms(torch, lambda: ws.data_term(cfg, s, field.dq, True)),
        plain_ms=cuda_ms(torch, lambda: ws.data_term(cfg, s, field.dq, True, plain=True), reps=3),
        # points, normals, targets, valid, 8 ids and weights in, the node
        # table, the node lists; bf16 rows, blocks, Jᵀr and cost out;
        # ~1500 operations a point (blend, chain rule, 8 twist rows) and
        # 48 a (point, neighbour) entry for its share of Jᵀr and the block
        bound=bound_ms(npt * (36 + 1 + 64 + 32) + n * 32 + lists_b + npt * 96 + n * 144 + n * 24 + 4,
                       npt * 1500.0 + npt * 8 * 48.0),
        library_ms=None,
    )

    # G: the edge term, spd6_inv, one matvec and the PCG solve
    ne = s.e_src.shape[0]
    ek = ws.edge_term(cfg, s, field.dq)
    ep = ws.edge_term(cfg, s, field.dq, plain=True)
    err = max(rel_err(torch, a, b) for a, b in zip(ek, ep))
    check("edge_term", err <= TOL_EDGE_REL, f"{ne} edges: max relative diff {err:.2e} (tol {TOL_EDGE_REL})")
    report["edge_term"] = dict(
        err=max(abs_err(torch, a, b) for a, b in zip(ek, ep)),
        ms=cuda_ms(torch, lambda: ws.edge_term(cfg, s, field.dq)),
        plain_ms=cuda_ms(torch, lambda: ws.edge_term(cfg, s, field.dq, plain=True), reps=3),
        # node table, endpoints, valid, v_dst, alpha, the dst lists in; three
        # 6x6 blocks an edge, Jᵀr, the diagonal share and the cost out; ~2000
        # operations an edge (two 3x6 Jacobians, three 6x6 products)
        bound=bound_ms(n * 32 + ne * (16 + 1 + 12 + 4 + 4) + (n + 1) * 4 + ne * 3 * 144 + n * (24 + 144) + 4,
                       ne * 2000.0),
        library_ms=None,
    )
    # the first LM iteration's damped blocks, as the solve builds them
    blocks_full = dp.blocks + ep.diag
    diag_eff, unit = ws.damping_terms(cfg, field.active, blocks_full)
    damp = cfg.solver_lm_lambda_init * diag_eff + unit
    m = blocks_full + torch.diag_embed(damp.reshape(n, 6))
    # spd6_inv is held on well-conditioned SPD blocks: on the solver's
    # blocks the closed form (the JAX package's) cancels, since a node's
    # rotation about the world origin and its translation are nearly the
    # same motion, and any two float32 roundings part ways there (printed)
    a = torch.from_numpy(np.random.RandomState(2).randn(n, 6, 6).astype(np.float32)).to(dev)
    spd = a @ a.transpose(1, 2) + 0.5 * torch.eye(6, device=dev)
    ik, ip = ws.spd6_inv(spd), ws.spd6_inv(spd, plain=True)
    exact = torch.linalg.inv(spd.double())
    err, ek = rel_err(torch, ik, ip), rel_err(torch, ik.double(), exact)
    check("spd6_inv", err <= TOL_SPD6_REL and ek <= TOL_SPD6_REL,
          f"({n}, 6, 6) random SPD blocks: kernel vs plain {err:.2e}, kernel vs float64 inverse {ek:.2e} "
          f"(tol {TOL_SPD6_REL})")
    mk, mp_ = ws.spd6_inv(m), ws.spd6_inv(m, plain=True)
    exact_m = torch.linalg.inv(m.double())
    print(f"[info] spd6_inv on the solver's damped blocks: condition numbers median "
          f"{float(torch.linalg.cond(m.double()).median()):.2e}; relative error against the float64 inverse: "
          f"kernel {rel_err(torch, mk.double(), exact_m):.2e}, plain {rel_err(torch, mp_.double(), exact_m):.2e}; "
          f"non-finite entries: kernel {int((~torch.isfinite(mk)).sum())}, plain {int((~torch.isfinite(mp_)).sum())}",
          flush=True)
    report["spd6_inv"] = dict(
        err=abs_err(torch, ik, ip),
        ms=cuda_ms(torch, lambda: kernels.spd6_inv(m)),
        plain_ms=cuda_ms(torch, lambda: ws.spd6_inv(m, plain=True)),
        bound=bound_ms(n * 144 * 2, n * 450.0),
        library_ms=cuda_ms(torch, lambda: torch.linalg.inv(m)),
    )
    sysm = ws.System(dp.rows, ep, damp)
    pv = torch.from_numpy(np.random.RandomState(1).randn(6 * n).astype(np.float32)).to(dev)
    err = rel_err(torch, ws.matvec(s, sysm, pv), ws.matvec(s, sysm, pv, plain=True))
    check("matvec", err <= TOL_MATVEC_REL, f"6N = {6 * n}: max relative diff {err:.2e} (tol {TOL_MATVEC_REL})")
    on = torch.ones((), dtype=torch.bool, device=dev)
    iters, rtol = cfg.solver_linear_iters, cfg.solver_linear_tol
    b = dp.jtr + ep.jtr
    xs = [ws.pcg(s, sysm, mk, b, iters, rtol, on), ws.pcg(s, sysm, mp_, b, iters, rtol, on, plain=True)]
    print(f"[info] PCG on the solver's system with the closed-form preconditioners: non-finite entries "
          f"kernel {int((~torch.isfinite(xs[0])).sum())}, plain {int((~torch.isfinite(xs[1])).sum())} of {6 * n}",
          flush=True)
    # the PCG kernel is held on the same system with the float64 inverse of
    # its blocks as the preconditioner
    ip = exact_m.float().contiguous()
    xk = ws.pcg(s, sysm, ip, b, iters, rtol, on)
    xp = ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True)
    finite = bool(torch.isfinite(xk).all()) and bool(torch.isfinite(xp).all())
    err = rel_err(torch, xk, xp) if finite else float("inf")
    check("pcg", finite and err <= TOL_PCG_REL and not bool(ws.pcg(s, sysm, ip, b, iters, rtol, ~on).any()),
          f"up to {iters} iterations over 6N = {6 * n}: finite {finite}, max relative diff {err:.2e} "
          f"(tol {TOL_PCG_REL}); inactive -> 0")
    ran = pcg_iterations(torch, ws, s, sysm, ip, b, iters, rtol)
    per_iter = npt * 8 * 6 * 2 * 2 + ne * 2 * 72 * 2 + n * (72 + 60)
    report["pcg"] = dict(
        err=abs_err(torch, xk, xp),
        ms=cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on)),
        plain_ms=cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True), reps=5),
        # bf16 rows, neighbour ids and node lists, the edge blocks and lists,
        # damping, preconditioner and right-hand side read once, x written;
        # the iterations this right-hand side runs (``ran``)
        bound=bound_ms(npt * (96 + 32) + lists_b + ne * (3 * 144 + 8 + 4) + (n + 1) * 4 + n * (24 + 144 + 24) + n * 24,
                       ran * per_iter + n * 72.0),
        library_ms=None,
        iterations=ran,
    )

    # H: insertion into a field with half its slots free
    half = torch.arange(n, device=dev) % 2 == 0
    act = field.active & half
    hfield = field._replace(active=act, count=act.sum(dtype=torch.int32))
    hcand = (cand + 0.03).contiguous()
    hvalid = ~torch.isnan(hcand[:, 0])
    fi = torch.tensor(9, dtype=torch.int32).to(dev)
    hk = warpfield.insert_nodes(cfg, hfield, hcand, hvalid, fi)
    hp = warpfield.insert_nodes(cfg, hfield, hcand, hvalid, fi, plain=True)
    grew = int(hk.count) - int(hfield.count)
    err = 0.0
    exact = True
    for name, a, b_ in zip(warpfield.WarpField._fields, hk, hp):
        if a.dtype == torch.float32:
            err = max(err, abs_err(torch, a, b_))
        else:
            exact = exact and torch.equal(a, b_)
    check("insert_nodes", exact and err <= TOL_FIELD and grew > 0,
          f"{nc} candidates, {n - int(hfield.count)} free slots: {grew} inserted; slots, active set, counts "
          f"equal {exact}; max position/dq diff {err:.2e} (tol {TOL_FIELD})")
    cd2, _ = warpfield.mutual_nearest(hfield, hcand, hvalid)
    gate = hfield.count < n
    plan = warpfield.InsertPlan(*kernels.insert_select(hcand, cd2, hvalid, hfield.active, hfield.count, gate,
                                                       cfg.node_coverage))
    seed = warpfield.warp_dq_at(hfield, torch.nan_to_num(plan.new_pos), k=k8)
    np2 = max(1024, 1 << (nc - 1).bit_length())
    sort_ops = 2 * (np2 // 2) * int(math.log2(np2)) * (int(math.log2(np2)) + 1) // 2
    report["insert_select"] = dict(
        err=0.0 if exact else 1.0,
        ms=cuda_ms(torch, lambda: kernels.insert_select(hcand, cd2, hvalid, hfield.active, hfield.count, gate,
                                                        cfg.node_coverage)),
        plain_ms=cuda_ms(torch, lambda: warpfield._insert_select_plain(cfg, hfield, hcand, hvalid, cd2, gate), reps=5),
        # candidates, their distances and flags, the active mask in; slots
        # and positions out; two bitonic sorts of the padded keys
        bound=bound_ms(nc * 17 + n + 5 + n * 20, float(sort_ops + nc * 12)),
        library_ms=None,
    )
    report["insert_apply"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.insert_apply(
            hfield.positions, hfield.dq, hfield.radius, hfield.active, hfield.count, hfield.last_support,
            plan.slots, plan.new_pos, seed, fi, cfg.node_radius)),
        plain_ms=cuda_ms(torch, lambda: warpfield._insert_apply_plain(cfg, hfield, plan, seed, fi), reps=5),
        bound=bound_ms(n * 53 * 2 + n * 52 + 8, n * 60.0),
        library_ms=None,
    )

    # D with the non-rigid arguments: warped coarse grid, blend quality, packed confidence
    conf = tr.conf
    w2c = se3.inverse(tr.pose)
    ok_t = torch.ones((), dtype=torch.bool, device=dev)
    vk = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    vp = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    cnt_k = fusion.integrate_nonrigid(cfg, vk, cf, dists, w2c, cfg.intr, ok_t, conf=conf)
    cnt_p = fusion.integrate_nonrigid(cfg, vp, cf, dists, w2c, cfg.intr, ok_t, conf=conf, plain=True)
    dt_ = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    dw_ = (vk.weight.to(torch.int32) - vp.weight.to(torch.int32)).abs()
    frac = float((dt_ > 1).float().mean())
    changed = int((vk.tsdf != st.vol.tsdf).sum())
    check("fuse_bricks_nonrigid", torch.equal(cnt_k, cnt_p) and frac < TOL_FUSE_NR_FRAC and int(dw_.max()) <= 1
          and changed > 0,
          f"counts {cnt_k.tolist()} / {cnt_p.tolist()}; codes > 1 LSB apart on {frac:.2e} (tol {TOL_FUSE_NR_FRAC}), "
          f"max code diff {int(dt_.max())}, max weight diff {int(dw_.max())} (tol 1); {changed} voxels changed")
    g = cfg.knn_field_stride
    cam_grid = se3.transform_points(w2c, cf.warped)
    bp = bricks.plan(cfg, dists, cam_grid, g, cfg.intr)
    lookup = bricks.pack_depth_conf(dists, conf)
    scratch = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    n_work = int(bp.work.count[0])
    n_front = int((bp.work.kind[:n_work] == bricks.FRONT).sum())
    bv = cfg.brick_size ** 3
    nbr = (cfg.volume_dims // cfg.brick_size) ** 3

    def fuse(plain):
        bricks.fuse(cfg, scratch, lookup, cam_grid, g, cfg.intr, bp, ok_t, q_grid=cf.q, packed=True, plain=plain)

    report["fuse_bricks_nonrigid"] = dict(
        err=int(torch.maximum(dt_.max(), dw_.max())),
        ms=cuda_ms(torch, lambda: fuse(False)),
        plain_ms=cuda_ms(torch, lambda: fuse(True), reps=3),
        bound=bound_ms(n_work * bv * 8 + lookup.numel() * 4 + cam_grid.numel() * 4 + cf.q.numel() * 4 + nbr * 16,
                       n_front * bv * 8.0 + (n_work - n_front) * bv * 100.0),
        library_ms=None,
    )
    del scratch, vk, vp, df


def stencil_kernels(torch, report, dev, cfg, st, depth_np):
    """Phase 2 for kernel C's newton8 branch and kernels I-K at the preset's
    shapes: the preset's state after three frames, its next depth frame
    with seeded noise and holes."""
    import torch.nn.functional as F

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.ops import bricks, fusion, preprocess, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu

    intr = cfg.intr
    rng = np.random.RandomState(5)
    d = depth_np.astype(np.int32)
    d = np.where(d > 0, d + rng.randint(-3, 4, d.shape), 0)
    d = np.where(rng.rand(*d.shape) < 0.01, 0, d)  # sensor holes
    d_t = torch.from_numpy(d.astype(np.uint16)).to(dev)
    rows, cols = d_t.shape
    npx = rows * cols

    # I: dists (and the truncation, off in the preset, in the same launch)
    dk = preprocess.compute_dists(intr, d_t)
    dp = preprocess.compute_dists(intr, d_t, plain=True)
    err = float(((dk - dp).abs() / dp.clamp(min=1e-6)).max())
    check("depth_dists", err <= TOL_DISTS_REL, f"{cols}x{rows}: max relative diff {err:.2e} (tol {TOL_DISTS_REL})")
    report["depth_dists"] = dict(
        err=abs_err(torch, dk, dp),
        ms=cuda_ms(torch, lambda: kernels.depth_dists(d_t, intr)),
        plain_ms=cuda_ms(torch, lambda: preprocess.compute_dists(intr, d_t, plain=True)),
        # uint16 depth in, float32 dists out; ~12 operations a pixel
        bound=bound_ms(npx * (2 + 4), npx * 12.0),
        library_ms=None,
    )

    # I: the depth pyramid (exact); the row times the 640x480 -> 320x240 call
    sig = cfg.bilateral_sigma_depth
    f0 = preprocess.bilateral_filter(d_t, cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial, sig)
    pyr, exact = [f0], True
    for _ in range(1, cfg.pyramid_levels):
        nk = preprocess.depth_pyramid_down(pyr[-1], sig)
        exact = exact and torch.equal(nk.to(torch.int32), preprocess.depth_pyramid_down(pyr[-1], sig, plain=True).to(torch.int32))
        pyr.append(nk)
    check("pyramid_down", exact, f"levels {' -> '.join(f'{p.shape[1]}x{p.shape[0]}' for p in pyr)} equal the plain version's")
    report["pyramid_down"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.pyramid_down(f0, sig)),
        plain_ms=cuda_ms(torch, lambda: preprocess.depth_pyramid_down(f0, sig, plain=True)),
        # the level read once, the half-size level written; 25 taps of ~5 operations an output pixel
        bound=bound_ms(npx * 2 + npx // 4 * 2, npx // 4 * 25 * 5.0),
        library_ms=None,
    )

    # I: point/normal maps: level 0 with the incidence confidence, the
    # tracking levels 2 and 3, the raw level-2 points of the solve (stride 4)
    worst = [0.0, 0.0, 0.0]
    for img, stride, lvl, conf in ((pyr[0], 1, 0, True), (pyr[2], 1, 2, False), (pyr[3], 1, 3, False), (d_t, 4, 2, False)):
        pk, nk, ck = kernels.points_normals(img, intr.level(lvl), stride, conf=conf)
        pp, npl = preprocess.compute_points_normals(intr.level(lvl), img, stride=stride, plain=True)
        valid = ~torch.isnan(pp[..., 0])
        same_nan = torch.equal(torch.isnan(pk), torch.isnan(pp)) and torch.equal(torch.isnan(nk), torch.isnan(npl))
        perr = float((pk - pp)[valid].abs().max())
        nfrac = float(((nk - npl)[valid].abs().amax(-1) > TOL_NORMAL).float().mean())
        cfrac = float(((ck - preprocess.incidence_confidence(pp, npl)).abs() > TOL_NORMAL).float().mean()) if conf else 0.0
        check("points_normals", same_nan and perr <= TOL_POINTS_M and nfrac <= TOL_NORMAL_FRAC and cfrac <= TOL_NORMAL_FRAC,
              f"level {lvl} stride {stride} ({pp.shape[1]}x{pp.shape[0]}, {float(valid.float().mean()):.3f} valid): "
              f"NaNs alike {same_nan}, max point diff {perr:.2e} m (tol {TOL_POINTS_M}), normals > {TOL_NORMAL} apart "
              f"on {nfrac:.2e}, confidence on {cfrac:.2e} (tol {TOL_NORMAL_FRAC})")
        worst = [max(worst[0], perr), max(worst[1], abs_err(torch, nk[valid], npl[valid])), worst[2]]

    def pn_plain():
        p, n = preprocess.compute_points_normals(intr, f0, plain=True)
        return preprocess.incidence_confidence(p, n)

    report["points_normals"] = dict(
        err=max(worst),
        ms=cuda_ms(torch, lambda: kernels.points_normals(f0, intr, conf=True)),
        plain_ms=cuda_ms(torch, pn_plain),
        # level-0 depth in; points, normals and confidence out; ~90 operations a pixel
        bound=bound_ms(npx * (2 + 12 + 12 + 4), npx * 90.0),
        library_ms=None,
    )

    # I: the 2x2 resize of the warped model maps (exact)
    mp, mn = st.prev_points[0], st.prev_normals[0]
    rk = preprocess.resize_points_normals(mp, mn)
    rp = preprocess.resize_points_normals(mp, mn, plain=True)
    exact = all(torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                for a, b in zip(rk, rp))
    check("resize_maps", exact, f"{mp.shape[1]}x{mp.shape[0]} -> {rk[0].shape[1]}x{rk[0].shape[0]} equal the plain version's")
    stack6 = torch.cat([mp, mn], dim=-1).permute(2, 0, 1)[None].contiguous()
    nm = mp.shape[0] * mp.shape[1]
    report["resize_maps"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.resize_maps(mp, mn)),
        plain_ms=cuda_ms(torch, lambda: preprocess.resize_points_normals(mp, mn, plain=True)),
        bound=bound_ms(nm * 24 + nm // 4 * 24, nm // 4 * 6 * 4.0),
        library_ms=cuda_ms(torch, lambda: F.avg_pool2d(stack6, 2)),
    )

    # J: the temporal march band (exact)
    (_, bk), (_, bp) = kinfu._march_bands(cfg, st.can_points, dk), kinfu._march_bands(cfg, st.can_points, dk, plain=True)
    exact = torch.equal(bk[0], bp[0]) and torch.equal(bk[1], bp[1])
    check("march_bands", exact and bool((bk[1] > bk[0]).any()),
          f"{bk[0].shape[1]}x{bk[0].shape[0]} band equal the plain version's; {int((bk[1] > bk[0]).sum())} rays banded")
    can = st.can_points.contiguous()
    nt = can.shape[0] * can.shape[1]
    lo_src = bk[0][None, None].contiguous()
    report["march_bands"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.march_bands(dk, cfg.raycast_subsample, can, cfg.raycast_band_margin, False)),
        plain_ms=cuda_ms(torch, lambda: kinfu._march_bands(cfg, st.can_points, dk, plain=True)),
        # strided dists and the model map in, lo and hi out; 25 taps of ~6 operations
        bound=bound_ms(nt * (4 + 12 + 8), nt * (25 * 6.0 + 10.0)),
        library_ms=cuda_ms(torch, lambda: F.max_pool2d(lo_src, 5, 1, padding=2)),
    )

    # C: the newton8 branch, in the band, at the preset's model-map resolution
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), st.pose)
    ray_org, dirs, tmin, tmax = tsdf_ops.rays(cfg, cam2vol, intr.level(cfg.raycast_shift), rows_t, cols_t, t_band=bk)
    fk, vk_, nk_ = tsdf_ops.march_and_refine(cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax)
    fp, vp_, np_ = tsdf_ops.march_and_refine_plain(cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax)
    both = fk & fp
    found_frac = float((fk != fp).float().mean())
    err = float((vk_ - vp_)[both].abs().max()) if bool(both.any()) else 0.0
    nan_same = torch.equal(torch.isnan(nk_[both]), torch.isnan(np_[both]))
    nerr = float(torch.nan_to_num((nk_ - np_)[both].abs(), nan=0.0).max()) if bool(both.any()) else 0.0
    check("raycast_newton8", found_frac <= TOL_RAYCAST_FOUND_FRAC and err <= TOL_RAYCAST_M and nan_same,
          f"hit/miss differs on {found_frac:.2e} of rays (tol {TOL_RAYCAST_FOUND_FRAC}), "
          f"max vertex diff {err:.3e} m (tol {TOL_RAYCAST_M}), max normal diff {nerr:.3e}; "
          f"{int(fk.sum())} of {fk.numel()} rays hit")
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    n_samples = march_samples(torch, cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax) + 8.0 * int(fk.sum())
    report["raycast_newton8"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.march_and_refine(
            st.vol.tsdf, ray_org, dirs, tmin, tmax, cfg.voxel_size, step, tsdf_ops.march_steps(cfg),
            cfg.raycast_adaptive_step, refine=1)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.march_and_refine_plain(cfg, st.vol.tsdf, ray_org, dirs, tmin, tmax), reps=3),
        # int16 samples (march + 8 corners a hit), the rays in, found/vertex/normal out
        bound=bound_ms(n_samples * 2 + rows_t * cols_t * (12 + 8 + 1 + 24), n_samples * 12.0 + int(fk.sum()) * 120.0),
        library_ms=None,
    )

    # K: the brick plan at the preset's non-rigid fusion grid (exact)
    g = cfg.knn_field_stride
    cf = fusion.coarse_field(cfg, st.warp)
    cam_grid = se3.transform_points(se3.inverse(st.pose), cf.warped).contiguous()
    pk_ = bricks.plan(cfg, dk, cam_grid, g, intr)
    pp_ = bricks.plan(cfg, dk, cam_grid, g, intr, plain=True)
    exact = all(torch.equal(a, b) for a, b in zip(pk_.classes, pp_.classes)) and all(
        torch.equal(a, b) for a, b in zip(pk_.work, pp_.work))
    nbr = pk_.classes.cls.shape[0]
    levels = int(math.ceil(math.log2(max(rows, cols)))) + 1
    pyr_ref = bricks.build_depth_pyramid(dk, levels)
    kargs = (dk, cam_grid, cfg.brick_size, g, intr, pk_.rect, volume_model.trunc_dist(cfg), bricks._ZEPS, levels,
             bricks._brick_perm_on(nbr, dev), min(cfg.integrate_band_cap, nbr), min(cfg.integrate_wide_cap, nbr))
    (mk, xk, ak), _, _ = kernels.brick_plan(*kargs)
    exact_mip = torch.equal(mk, pyr_ref.dmin) and torch.equal(xk, pyr_ref.dmax) and torch.equal(ak, pyr_ref.allvalid)
    hist = torch.bincount(pk_.classes.cls, minlength=4).tolist()
    check("brick_plan", exact and exact_mip,
          f"{levels}-level mip equal {exact_mip}; {nbr} bricks (skip, front, band, wide) {hist}, work list of "
          f"{int(pk_.work.count[0])}, counts {pk_.work.counts.tolist()}: classes and list equal the plain version's {exact}")
    gp = cam_grid.shape[0]
    total = mk.numel()
    report["brick_plan"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.brick_plan(*kargs)),
        plain_ms=cuda_ms(torch, lambda: bricks.plan(cfg, dk, cam_grid, g, intr, plain=True)),
        # dists, the grid and the permutation in; the mip, classes, windows,
        # flags and the list out; ~3 operations a mip cell, ~25 a grid point
        # of a brick's window, ~50 a mip query
        bound=bound_ms(npx * 4 + gp ** 3 * 12 + nbr * 8 + total * 12 + nbr * (8 + 4 + 4 + 1 + 8) + 16,
                       total * 3.0 + nbr * (27 * 25.0 + 16 * 50.0)),
        library_ms=None,
    )


def pcg_iterations(torch, ws, s, sysm, minv, b, iters, rtol) -> int:
    """The iterations the plain PCG runs on this right-hand side before
    rᵀr <= rtol² bᵀb (the work this run's data needs)."""
    x = torch.zeros_like(b)
    r = b
    z = ws._apply_m(minv, r)
    p = z
    rz = torch.dot(r, z)
    stop2 = rtol * rtol * float(torch.dot(b, b))
    for it in range(iters):
        if not float(torch.dot(r, r)) > stop2:
            return it
        ap = ws.matvec(s, sysm, p, plain=True)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x, r = x + alpha * p, r - alpha * ap
        z = ws._apply_m(minv, r)
        rz_n = torch.dot(r, z)
        p = z + rz_n / torch.clamp(rz, min=1e-30) * p
        rz = rz_n
    return iters


def rigid_main(torch, args, dev, card):
    """Phase 3: the rigid slice's frame loop, kernel path and plain path."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = DynamicFusionConfig.rigid_slice()
    frame = rigid_frame_fn(cfg)
    frames = [frame(i) for i in range(args.frames)]
    truth = [synthetic.orbit_pose(ANGLE_STEP * i, target=TARGET) for i in range(args.frames)]
    df = kinfu.DynamicFusion(cfg, device=dev)
    kernels.reset_launches()
    oks, counts, frame_ms = [], [], []
    for i, d in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df(d, block=False)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i > 0:
            oks.append(df.last_outputs.icp_ok)
            counts.append(df.last_outputs.brick_counts)
    launches = dict(kernels.launches)
    poses_k = [p.cpu().numpy() for p in df.poses]
    oks = [bool(o) for o in oks]
    counts = [c.tolist() for c in counts]
    print(f"[rigid] {args.frames} frames at {cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3; launches {launches}", flush=True)
    print(f"[rigid] icp_ok {sum(oks)}/{len(oks)}; brick counts (band, wide, dropped) first {counts[0]} last {counts[-1]}")
    check("rigid_launches", all(launches[k] > 0 for k in RIGID_KERNELS + STENCIL_KERNELS),
          f"kernels A-D and I-K launched: {launches}")
    check("rigid_icp_ok", all(oks), f"ICP healthy on every tracked frame ({sum(oks)}/{len(oks)})")
    steady = sorted(frame_ms[2:])
    print(f"[time] {card} | rigid frame ms median {steady[len(steady) // 2]:.3f} (frames 2..{args.frames - 1}), "
          f"frame 0 {frame_ms[0]:.3f}, min {steady[0]:.3f}, max {steady[-1]:.3f}", flush=True)

    plain = kinfu.DynamicFusion(cfg, device=dev, plain=True)
    plain_ms = []
    for d in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(d, block=False)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    poses_p = [p.cpu().numpy() for p in plain.poses]
    per_frame = [float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(poses_k, poses_p)]
    rot = [float(np.abs(a[:3, :3] - b[:3, :3]).max()) for a, b in zip(poses_k, poses_p)]
    print(f"[rigid-plain] pose diff kernel vs plain path: max translation {max(per_frame):.3e} m, max rotation entry "
          f"{max(rot):.3e}; final {per_frame[-1]:.3e} m")
    psteady = sorted(plain_ms[2:])
    print(f"[time] {card} | rigid plain-path frame ms median {psteady[len(psteady) // 2]:.3f}")
    check("rigid_pose_vs_plain", max(per_frame) <= TOL_POSE_PLAIN_M,
          f"max |t_kernel - t_plain| {max(per_frame):.3e} m (tol {TOL_POSE_PLAIN_M})")
    err_truth = float(np.linalg.norm(poses_k[-1][:3, 3] - truth[-1][:3, 3]))
    err_rot = float(np.abs(poses_k[-1][:3, :3] - truth[-1][:3, :3]).max())
    check("rigid_pose_vs_truth", err_truth <= TOL_POSE_TRUTH_M,
          f"final |t - t_orbit| {err_truth:.3e} m (tol {TOL_POSE_TRUTH_M}), max rotation entry diff {err_rot:.3e}")
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("rigid_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    return launches


def nonrigid_main(torch, args, dev, card, nr_depths):
    """Phase 4: the dynamicfusion preset's frame loop, kernel path (steady
    frames under the sync debug mode) and plain path."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.pipeline import kinfu

    from dynamicfusion_tpu_torch.models.volume import TsdfVolume

    cfg = DynamicFusionConfig.default_dynamicfusion()
    frames = nr_depths[: args.nr_frames]
    df = kinfu.DynamicFusion(cfg, device=dev)
    kernels.reset_launches()
    outs, frame_ms, states = [], [], []
    for i, d in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i >= 2:  # steady frames: any wait for the device inside the step raises
            torch.cuda.set_sync_debug_mode("error")
        try:
            df(d, block=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i > 0:
            outs.append(df.last_outputs)
        # the state after this frame, for the plain step from it (the step
        # updates the volume in place; every other field is made anew)
        st = df.state
        states.append(st._replace(vol=TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())))
    launches = dict(kernels.launches)
    poses_k = [p.cpu().numpy() for p in df.poses]
    rows = [dict(ok=bool(o.icp_ok), c0=float(o.solver_cost0), c1=float(o.solver_cost1), nodes=int(o.node_count),
                 bricks=o.brick_counts.tolist()) for o in outs]
    print(f"[nonrigid] {len(frames)} frames at {cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3 / {cfg.max_nodes} nodes; "
          f"launches {launches}", flush=True)
    for i, r in enumerate(rows, start=1):
        print(f"[nonrigid] frame {i:2d}: icp_ok {r['ok']}, solver_cost0 {r['c0']:.6e}, solver_cost1 {r['c1']:.6e}, "
              f"nodes {r['nodes']}, bricks (band, wide, dropped) {r['bricks']}")
    path = [k for k in kernels.KERNELS if k != "matvec"]  # the PCG launch does its own matvecs
    check("nonrigid_launches", all(launches[k] > 0 for k in path), f"every kernel of the path launched: {launches}")
    check("nonrigid_icp_ok", all(r["ok"] for r in rows),
          f"ICP healthy on every tracked frame ({sum(r['ok'] for r in rows)}/{len(rows)})")
    check("nonrigid_solver", all(r["c1"] <= r["c0"] and r["c0"] > 0 for r in rows),
          "solver_cost1 <= solver_cost0 on every frame")
    fused = [i for i, r in enumerate(rows, start=1) if r["bricks"][0] + r["bricks"][1] > 0]
    due = [i for i in range(1, len(frames)) if i % cfg.fusion_interval == 0]
    check("nonrigid_fusion", fused == due, f"fusion on frames {fused} (due {due})")
    check("nonrigid_no_sync", True, f"frames 2..{len(frames) - 1} ran under set_sync_debug_mode('error')")
    # the camera of the deforming scene does not move: the pose's distance
    # from the identity is the tracker's drift
    drift_t = float(np.abs(poses_k[-1][:3, 3]).max())
    drift_r = float(np.abs(poses_k[-1][:3, :3] - np.eye(3)).max())
    print(f"[nonrigid] drift of the static camera after {len(frames) - 1} steps: max |t| {drift_t:.3e} m, "
          f"max rotation entry {drift_r:.3e}")
    steady = sorted(frame_ms[2:])
    med = steady[len(steady) // 2]
    print(f"[time] {card} | non-rigid frame ms median {med:.3f} (frames 2..{len(frames) - 1}), "
          f"frame 0 {frame_ms[0]:.3f}, frame 1 {frame_ms[1]:.3f}, min {steady[0]:.3f}, max {steady[-1]:.3f}", flush=True)

    # the plain step from the kernel path's previous state, frame by frame
    step_t, step_r, step_c, step_same = [], [], [], True
    for f in range(1, len(frames)):
        _, o = kinfu.step(cfg, states[f - 1], torch.from_numpy(frames[f]).to(dev), plain=True)
        pk, pp = poses_k[f], o.pose.cpu().numpy()
        step_t.append(float(np.abs(pk[:3, 3] - pp[:3, 3]).max()))
        step_r.append(float(np.abs(pk[:3, :3] - pp[:3, :3]).max()))
        step_c.append(abs(float(o.solver_cost0) - rows[f - 1]["c0"]) / rows[f - 1]["c0"])
        step_same = step_same and bool(o.icp_ok) == rows[f - 1]["ok"] and int(o.node_count) == rows[f - 1]["nodes"]
    del states
    print(f"[nonrigid-step] plain step from the kernel path's state, per frame: translation diff (m) "
          f"{' '.join(f'{v:.2e}' for v in step_t)}; rotation entry {' '.join(f'{v:.2e}' for v in step_r)}; "
          f"initial solve cost, relative {' '.join(f'{v:.2e}' for v in step_c)}")
    check("nonrigid_step_vs_plain",
          step_same and max(step_t) <= TOL_STEP_POSE and max(step_r) <= TOL_STEP_POSE
          and max(step_c) <= TOL_STEP_COST0_REL,
          f"ICP health and node counts equal {step_same}; max translation diff {max(step_t):.3e} m, rotation "
          f"entry {max(step_r):.3e} (tol {TOL_STEP_POSE}); initial solve cost {max(step_c):.3e} relative "
          f"(tol {TOL_STEP_COST0_REL})")

    plain = kinfu.DynamicFusion(cfg, device=dev, plain=True)
    plain_ms = []
    for d in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(d, block=False)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    poses_p = [p.cpu().numpy() for p in plain.poses]
    per_frame = [float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(poses_k, poses_p)]
    rot = [float(np.abs(a[:3, :3] - b[:3, :3]).max()) for a, b in zip(poses_k, poses_p)]
    wk, wp = df.state.warp, plain.state.warp
    both = wk.active & wp.active
    dq_err = float((wk.dq - wp.dq)[both].abs().max())
    psteady = sorted(plain_ms[2:])
    print(f"[nonrigid-plain] pose diff kernel vs plain path per frame (m): "
          f"{' '.join(f'{v:.2e}' for v in per_frame)}; max rotation entry {max(rot):.3e}")
    print(f"[nonrigid-plain] node dq max diff {dq_err:.3e} over {int(both.sum())} nodes active in both; "
          f"nodes {int(wk.count)} / {int(wp.count)}")
    print(f"[time] {card} | non-rigid plain-path frame ms median {psteady[len(psteady) // 2]:.3f}")
    # the paths' own sensitivity: the kernel path again from frame-0 node
    # positions moved by 1e-7 relative (the bf16 rows of the solve let a
    # last bit move the LM step, and ICP carries it into the pose), and the
    # plain path run again
    spread = [0.0] * len(frames)
    for seed in PERTURB_SEEDS:
        poses_s = perturbed_run(torch, kinfu, cfg, dev, frames, seed)
        spread = [max(v, float(np.abs(a[:3, 3] - b[:3, 3]).max())) for v, a, b in zip(spread, poses_s, poses_k)]
    print(f"[nonrigid-spread] kernel path vs itself from perturbed nodes, per frame (m): "
          f"{' '.join(f'{v:.2e}' for v in spread)}")
    plain2 = kinfu.DynamicFusion(cfg, device=dev, plain=True)
    for d in frames:
        plain2(d, block=False)
    rerun = [float(np.abs(a[:3, 3] - b.cpu().numpy()[:3, 3]).max()) for a, b in zip(poses_p, plain2.poses)]
    del plain2
    print(f"[nonrigid-spread] plain path vs itself run again, per frame (m): {' '.join(f'{v:.2e}' for v in rerun)}")
    spread = [max(a, b) for a, b in zip(spread, rerun)]
    tol = [max(TOL_POSE_PLAIN_M, SPREAD * v) for v in spread]
    worst = max(range(len(frames)), key=lambda i: per_frame[i] / tol[i])
    print(f"[nonrigid-plain] free running: max |t_kernel - t_plain| {max(per_frame):.3e} m; frames past "
          f"max({TOL_POSE_PLAIN_M}, {SPREAD} x spread): {[i for i in range(len(frames)) if per_frame[i] > tol[i]]}; "
          f"worst at frame {worst}: {per_frame[worst]:.3e} m against {tol[worst]:.3e}")
    check("nonrigid_nodes_vs_plain", int(wk.count) == int(wp.count) and torch.equal(wk.active, wp.active),
          f"node count {int(wk.count)} / {int(wp.count)}, active sets equal")
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("nonrigid_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"warped model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    return launches, df


def perturbed_run(torch, kinfu, cfg, dev, frames, seed):
    """Poses of the kernel path with its frame-0 node positions moved by
    1e-7 relative (seeded)."""
    df = kinfu.DynamicFusion(cfg, device=dev)
    df(frames[0])
    st = df.state
    pos = st.warp.positions
    noise = torch.from_numpy(np.random.RandomState(seed).randn(*pos.shape).astype(np.float32)).to(dev)
    df.state = st._replace(warp=st.warp._replace(positions=pos * (1.0 + 1e-7 * noise)))
    for d in frames[1:]:
        df(d, block=False)
    return [p.cpu().numpy() for p in df.poses]


def profile_frames(torch, args, dev, card, df, depths):
    """3 non-rigid frames under torch.profiler: the table, the trace, and
    the device's busy time over the frames' wall time."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    out = Path(args.profile)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in depths:
            df(d, block=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    (out / "frame_profile.txt").write_text(f"{card}\n{table}\n")
    prof.export_chrome_trace(str(out / "frame_trace.json"))
    events = json.loads((out / "frame_trace.json").read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    launches = sum(1 for e in events if e.get("name") in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    syncs = sum(1 for e in events if "Synchronize" in str(e.get("name", "")))
    print(f"[profile] {card} | {len(depths)} non-rigid frames: wall {wall_ms:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1.0 - busy / 1e3 / wall_ms:.3f}; {len(spans)} device ops, {launches} kernel launches, "
          f"{syncs} synchronize calls -> {out}/frame_profile.txt", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=15, help="frames of the rigid slice")
    ap.add_argument("--nr-frames", type=int, default=20, help="frames of the non-rigid slice")
    ap.add_argument("--profile", default=None, help="write a torch.profiler table of 3 non-rigid frames here")
    ap.add_argument("--dump-solve", default=None, help="write the phase-2 warp field and solve inputs to this .npz")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from dynamicfusion_tpu_torch import kernels
        from dynamicfusion_tpu_torch.config import DynamicFusionConfig
        from dynamicfusion_tpu_torch.io import synthetic
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()

    # ---------------- 1. build ----------------
    t0 = time.perf_counter()
    kernels.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_info.get('seconds', 0.0):.2f} s) "
          f"-> {kernels.build_info.get('library')}", flush=True)
    for line in str(kernels.build_info.get("ptxas", "")).splitlines():
        if "registers" in line or line.startswith("=="):
            print("  " + line.strip())

    # ---------------- 2. kernels vs plain ----------------
    nr = DynamicFusionConfig.default_dynamicfusion()
    n_prof = 3 if args.profile else 0
    nr_depths = synthetic.deforming_frames(nr.intr, nr.rows, nr.cols, max(args.nr_frames, 4) + n_prof)
    report = {}
    rigid_kernels(torch, args, report, dev, card)
    nonrigid_kernels(torch, args, report, dev, nr_depths)
    print(f"[phase] kernels checked at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 3. the rigid main path ----------------
    rigid_launches = rigid_main(torch, args, dev, card)
    print(f"[phase] rigid path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 4. the non-rigid main path ----------------
    nr_launches, df = nonrigid_main(torch, args, dev, card, nr_depths)
    print(f"[phase] non-rigid path done at {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.profile:
        profile_frames(torch, args, dev, card, df, nr_depths[args.nr_frames:])

    # ---------------- 5. report ----------------
    rows_out = []
    for name, (src, rep) in ROWS.items():
        r = report[name]
        rigid = name in RIGID_KERNELS
        n_launch = (rigid_launches if rigid else nr_launches)[COUNTER.get(name, name)]
        rows_out.append(dict(
            name=name, route="cuda", source=f"dynamicfusion_tpu_torch/csrc/{src}", replaces=rep,
            launches=n_launch, max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"], path="rigid" if rigid else "nonrigid",
        ))
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[kernel] {card} | {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}), library {lib}, launches {n_launch} ({'rigid' if rigid else 'non-rigid'} path)"
              + (f", {r['iterations']} iterations" if "iterations" in r else ""))
    print(f"[phase] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"{card}")
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
