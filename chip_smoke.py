#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dynamicfusion_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames N] [--nr-frames M] [--profile DIR]

Phases (any failure exits non-zero; nothing is caught and ignored):

1. build the CUDA kernels from ``dynamicfusion_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build time;
2. run each kernel on the card at the slices' shapes, on seeded synthetic
   inputs, hold it against its plain PyTorch version on the same inputs,
   and time both: kernels A-D at the rigid slice's (640x480 depth, 256^3
   volume, 160x120 model maps), kernels E-H and D's non-rigid arguments at
   the non-rigid slice's (1024 nodes, 33^3 coarse corners, 19 200 map
   points, 3 200 solve points, 4 096 edges, 4 800 insertion candidates);
3. drive ``DynamicFusion`` on the rigid slice config for N frames of a
   sphere+plane orbit, with every launch counter reset just before and
   read just after; kernels A-D must have launched and ICP must succeed on
   every frame; then the same frames through the plain path, poses
   compared, the final pose held against the analytic orbit;
4. drive ``DynamicFusion`` on the non-rigid slice config
   (``nonrigid_slice()``: 640x480 / 256^3 / 1024 nodes) for M frames of
   ``bench.py``'s deforming scene, counters reset just before and read just
   after, the steady frames under ``torch.cuda.set_sync_debug_mode("error")``
   (a step that waits for the device raises); every kernel of the path must
   have launched, ICP must succeed and the solve must not raise its cost on
   every frame, fusion must run on the frames 6, 12, 18, ...; then the same
   frames through the plain path, poses and node transforms compared;
5. print the per-kernel JSON line, the card's name and power limit, and
   last the result line ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a torch.profiler table and trace of 3 non-rigid
frames and prints the device's busy time and idle share over them.

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
# non-rigid: per frame within max(TOL_POSE_PLAIN_M, SPREAD x the kernel path's
# own spread under a 1e-7 perturbation of its frame-0 node positions)
SPREAD = 2.0
PERTURB_SEEDS = (0, 1)
TOL_POSE_TRUTH_M = 0.01       # kernel path vs analytic orbit, final translation

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
# (source, the TPU kernel-role function it replaces) of each JSON row
ROWS = {
    "bilateral": ("bilateral.cu", "dynamicfusion_tpu/ops/preprocess.py:43"),
    "icp_reduce": ("icp_reduce.cu", "dynamicfusion_tpu/solvers/icp.py:38"),
    "raycast": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:386"),
    "fuse_bricks": ("fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552"),
    "fuse_bricks_nonrigid": ("fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552"),
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
    # samples this run's rays need: march steps (counted as the plain loop runs them)
    inv_vs = 1.0 / cfg.voxel_size
    t = tmin.clone()
    done = tmin >= tmax
    prev = tsdf_ops.fetch_nearest(st.vol.tsdf, (ray_org + dirs * t[..., None]) * inv_vs)
    samples = torch.ones_like(t)
    for _ in range(tsdf_ops.march_steps(cfg)):
        dtt = torch.where(prev > 0.99, 2.0 * step, step)
        tn = t + dtt
        act = ~done & (t < tmax)
        nxt = tsdf_ops.fetch_nearest(st.vol.tsdf, (ray_org + dirs * tn[..., None]) * inv_vs)
        samples = samples + act.float()
        done = done | (act & (((prev > 0) & (nxt < 0)) | ((prev < 0) & (nxt > 0)))) | (tn >= tmax)
        t = torch.where(act, tn, t)
        prev = torch.where(act, nxt, prev)
    n_samples = float(samples.sum()) + 24.0 * int(fk.sum())
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


def rigid_frame_fn(cfg):
    from dynamicfusion_tpu_torch.io import synthetic

    def frame(i: int) -> np.ndarray:
        pose = synthetic.orbit_pose(ANGLE_STEP * i, target=TARGET)
        return synthetic.scene_depth(cfg.intr, cfg.rows, cfg.cols, pose, **SCENE)

    return frame


def nonrigid_kernels(torch, report, dev, nr_depths):
    """Phase 2 for kernels E-H and D's non-rigid arguments at the non-rigid
    slice's shapes, on the state after three frames of the kernel path."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import bricks, fusion
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = DynamicFusionConfig.nonrigid_slice()
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
    conf = kinfu.incidence_confidence(pts_pyr[0], nrm_pyr[0])
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
    check("rigid_launches", all(launches[k] > 0 for k in RIGID_KERNELS), f"kernels A-D launched: {launches}")
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
    """Phase 4: the non-rigid slice's frame loop, kernel path (steady
    frames under the sync debug mode) and plain path."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = DynamicFusionConfig.nonrigid_slice()
    frames = nr_depths[: args.nr_frames]
    df = kinfu.DynamicFusion(cfg, device=dev)
    kernels.reset_launches()
    outs, frame_ms = [], []
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
    # the path's own sensitivity: the kernel path again from frame-0 node
    # positions moved by 1e-7 relative (the bf16 rows of the solve let a
    # last bit move the LM step, and ICP carries it into the pose)
    spread = [0.0] * len(frames)
    for seed in PERTURB_SEEDS:
        poses_s = perturbed_run(torch, kinfu, cfg, dev, frames, seed)
        spread = [max(v, float(np.abs(a[:3, 3] - b[:3, 3]).max())) for v, a, b in zip(spread, poses_s, poses_k)]
    print(f"[nonrigid-spread] kernel path vs itself from perturbed nodes, per frame (m): "
          f"{' '.join(f'{v:.2e}' for v in spread)}")
    tol = [max(TOL_POSE_PLAIN_M, SPREAD * v) for v in spread]
    worst = max(range(len(frames)), key=lambda i: per_frame[i] / tol[i])
    check("nonrigid_pose_vs_plain", all(a <= t for a, t in zip(per_frame, tol)),
          f"max |t_kernel - t_plain| {max(per_frame):.3e} m; worst against its tolerance at frame {worst}: "
          f"{per_frame[worst]:.3e} m (tol max({TOL_POSE_PLAIN_M}, {SPREAD} x spread) = {tol[worst]:.3e})")
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
    nr = DynamicFusionConfig.nonrigid_slice()
    n_prof = 3 if args.profile else 0
    nr_depths = synthetic.deforming_frames(nr.intr, nr.rows, nr.cols, max(args.nr_frames, 4) + n_prof)
    report = {}
    rigid_kernels(torch, args, report, dev, card)
    nonrigid_kernels(torch, report, dev, nr_depths)
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
        counter = "fuse_bricks" if name == "fuse_bricks_nonrigid" else name
        n_launch = (rigid_launches if rigid else nr_launches)[counter]
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
