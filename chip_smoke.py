#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dynamicfusion_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames N] [--profile DIR]

Phases (any failure exits non-zero; nothing is caught and ignored):

1. build the CUDA kernels from ``dynamicfusion_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build time;
2. run each kernel on the card at the rigid slice's shapes (640x480 depth,
   256^3 volume, 160x120 model maps) on seeded synthetic inputs, hold it
   against its plain PyTorch version on the same inputs, and time both;
3. drive ``DynamicFusion`` on the rigid slice config for N frames of a
   sphere+plane orbit, with every kernel launch counter reset just before
   and read just after; every kernel must have launched and ICP must
   succeed on every frame;
4. run the same frames through the plain path on the card and compare
   poses; hold the final pose against the analytic orbit pose;
5. print the per-kernel JSON line, the card's name and power limit, and
   last the result line ``{"ok": true, "device": {...}}``.

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
TOL_POSE_PLAIN_M = 1e-3       # kernel path vs plain path, any frame's translation
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--profile", default=None, help="write a torch.profiler table of 3 frames here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from dynamicfusion_tpu_torch import kernels
        from dynamicfusion_tpu_torch.config import DynamicFusionConfig
        from dynamicfusion_tpu_torch.core import se3
        from dynamicfusion_tpu_torch.io import synthetic
        from dynamicfusion_tpu_torch.models import volume as volume_model
        from dynamicfusion_tpu_torch.ops import bricks, preprocess, tsdf as tsdf_ops
        from dynamicfusion_tpu_torch.pipeline import kinfu
        from dynamicfusion_tpu_torch.solvers import icp
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---------------- 1. build ----------------
    t0 = time.perf_counter()
    kernels.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_info.get('seconds', 0.0):.2f} s) "
          f"-> {kernels.build_info.get('library')}", flush=True)
    for line in str(kernels.build_info.get("ptxas", "")).splitlines():
        if "registers" in line or line.startswith("=="):
            print("  " + line.strip())

    cfg = DynamicFusionConfig.rigid_slice()
    intr = cfg.intr
    rng = np.random.RandomState(0)

    def frame(i: int) -> np.ndarray:
        pose = synthetic.orbit_pose(ANGLE_STEP * i, target=TARGET)
        d = synthetic.scene_depth(intr, cfg.rows, cfg.cols, pose, **SCENE)
        return d

    # ---------------- 2. kernels vs plain ----------------
    report = {}
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
    del plain_df, st

    # ---------------- 3. the main path through the kernels ----------------
    frames = [frame(i) for i in range(args.frames)]
    truth = [synthetic.orbit_pose(ANGLE_STEP * i, target=TARGET) for i in range(args.frames)]
    df = kinfu.DynamicFusion(cfg, device=dev)
    kernels.reset_launches()
    oks, counts, frame_ms = [], [], []
    for i, d in enumerate(frames):
        dd = torch.from_numpy(d).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df(dd, block=False)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i > 0:
            oks.append(df.last_outputs.icp_ok)
            counts.append(df.last_outputs.brick_counts)
    launches = dict(kernels.launches)
    poses_k = [p.cpu().numpy() for p in df.poses]
    oks = [bool(o) for o in oks]
    counts = [c.tolist() for c in counts]
    print(f"[main] {args.frames} frames at {cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3; launches {launches}", flush=True)
    print(f"[main] icp_ok {sum(oks)}/{len(oks)}; brick counts (band, wide, dropped) first {counts[0]} last {counts[-1]}; "
          f"nodes {int(df.state.warp.count)}")
    check("launches", all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    check("icp_ok", all(oks), f"ICP healthy on every tracked frame ({sum(oks)}/{len(oks)})")
    steady = sorted(frame_ms[2:])
    med = steady[len(steady) // 2]
    print(f"[time] {card} | frame ms median {med:.3f} (frames 2..{args.frames - 1}), frame 0 {frame_ms[0]:.3f}, "
          f"min {steady[0]:.3f}, max {steady[-1]:.3f}", flush=True)

    if args.profile:
        from pathlib import Path
        from torch.profiler import ProfilerActivity, profile

        Path(args.profile).mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for d in frames[:3]:
                df(torch.from_numpy(d).to(dev), block=False)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        (Path(args.profile) / "frame_profile.txt").write_text(f"{card}\n{table}\n")
        prof.export_chrome_trace(str(Path(args.profile) / "frame_trace.json"))
        print(f"[profile] 3 frames -> {args.profile}/frame_profile.txt")

    # ---------------- 4. the plain path on the card ----------------
    plain = kinfu.DynamicFusion(cfg, device=dev, plain=True)
    plain_ms = []
    for d in frames:
        dd = torch.from_numpy(d).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(dd, block=False)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    poses_p = [p.cpu().numpy() for p in plain.poses]
    per_frame = [float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(poses_k, poses_p)]
    rot = [float(np.abs(a[:3, :3] - b[:3, :3]).max()) for a, b in zip(poses_k, poses_p)]
    print(f"[plain] pose diff kernel vs plain path: max translation {max(per_frame):.3e} m, max rotation entry "
          f"{max(rot):.3e}; final {per_frame[-1]:.3e} m")
    psteady = sorted(plain_ms[2:])
    print(f"[time] {card} | plain-path frame ms median {psteady[len(psteady) // 2]:.3f}")
    check("pose_vs_plain", max(per_frame) <= TOL_POSE_PLAIN_M,
          f"max |t_kernel - t_plain| {max(per_frame):.3e} m (tol {TOL_POSE_PLAIN_M})")
    err_truth = float(np.linalg.norm(poses_k[-1][:3, 3] - truth[-1][:3, 3]))
    err_rot = float(np.abs(poses_k[-1][:3, :3] - truth[-1][:3, :3]).max())
    check("pose_vs_truth", err_truth <= TOL_POSE_TRUTH_M,
          f"final |t - t_orbit| {err_truth:.3e} m (tol {TOL_POSE_TRUTH_M}), max rotation entry diff {err_rot:.3e}")
    mp = df.last_outputs.model_points
    check("model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")

    # ---------------- 5. report ----------------
    replaces = {
        "bilateral": ("dynamicfusion_tpu_torch/csrc/bilateral.cu", "dynamicfusion_tpu/ops/preprocess.py:43"),
        "icp_reduce": ("dynamicfusion_tpu_torch/csrc/icp_reduce.cu", "dynamicfusion_tpu/solvers/icp.py:38"),
        "raycast": ("dynamicfusion_tpu_torch/csrc/raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:386"),
        "fuse_bricks": ("dynamicfusion_tpu_torch/csrc/fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552"),
    }
    rows_out = []
    for name in kernels.KERNELS:
        r = report[name]
        src, rep = replaces[name]
        rows_out.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
        ))
        print(f"[kernel] {card} | {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}), launches {launches[name]}")
    print(f"{card}")
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
