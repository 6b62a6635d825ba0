#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dynamicfusion_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames N] [--nr-frames M] [--q-frames Q] [--a-frames A] [--p-frames P]
                          [--d-frames D] [--r-frames R] [--o-frames O] [--profile DIR] [--dump-solve FILE]

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
   kernels F and G with the tangential rows of ``quality_dynamicfusion()``
   (three residual rows a point) on the same state; kernel L (frame 0's
   extraction into 1 << 20 rows and node sampling into 1 024 slots) on the
   preset's frame-0 volume, bit-equal to its plain version; kernel M (the
   aperture gate of ``solver_p2p_adaptive``) on the phase-2 state at
   160x120, gate and depth bins bit-equal to its plain version, some
   pixels open part way (the closed form exercised); and at the
   reference resolution of ``reference_parity()`` on the phase-2 volume:
   kernel C's 160x120 coarse march, kernel J's coarse band (640x480,
   bit-equal), C at 640x480 in that band and as ``render(pose)``'s full
   march, kernel B at 640x480; and on the base ``DynamicFusionConfig()``'s
   state after three frames (3 200 solve points, 6N = 6 144): kernel N's
   column scales and int8 Gram (bit-equal), its bf16 Gram, kernel O,
   cuSOLVER's factor (an all-NaN factor where the matrix is not positive
   definite), kernel F's point-to-point rows and kernel P (the PCG over
   the damped dense matrix, within four times the plain PCG's own spread
   under a one-ulp move of the matrix); and for the options, on the
   preset's phase-2 state: kernel E's adaptive radius at frame 0's 1024
   nodes and at the insertion shape (bit-equal), kernel Q on a real
   pre/post-solve pair and on a field with two active nodes (left as it
   is), kernels F and G with the tangential rows of every 2nd and 4th
   point and with the plane rows only;
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
   device raises); every kernel of the path (A-L) must have launched, L
   once, ICP must succeed and the solve must not raise its cost on every
   frame, fusion must run on the frames 6, 12, 18, ...; then the plain
   path's step from each of the kernel path's states, pose and initial
   solve cost held against the kernel path's; then the same frames through
   the plain path free running, node sets held equal, poses printed beside
   both paths' own spread (the solve's bf16 rows make the trajectories
   part chaotically, by up to ~1 mm in 20 frames);
5. the same for ``quality_dynamicfusion()`` (the preset with the
   tangential data term) over Q frames of ``bench.py``'s hinge scene (two
   spheres scissoring about a hinge over a plane): the same checks, the
   plain step from each state; free-running poses printed;
6. ``quality_dynamicfusion()`` with ``solver_p2p_adaptive`` (the aperture
   gate) over A hinge frames: the checks of phase 5, kernel M once a step,
   the plain step from each state, kernel M held bit-equal to its plain
   version on every step's inputs (some pixels open part way); the mean
   gate over the spheres and over the plane printed; then 8 frames of
   ``bench.py``'s bulge scene (a bump travelling over a plane): M held on
   every step's inputs, the rest printed only;
7. ``reference_parity()`` with ``rigid_only`` (the reference's
   KinectFusion at its own resolution: 640x480 model maps, the coarse band
   every frame) over P frames of the rigid orbit: C and J's coarse band on
   every frame, ICP, the pose against the orbit and the plain path; then
   ``render(0)``, ``render(3)`` and ``render(pose=...)`` (a fresh 640x480
   march), the last against the plain path's render of the same state;
8. three frames of ``default_dynamicfusion()`` with
   ``reuse_model_raycast=False`` (a fresh canonical raycast every step),
   the plain step from each state;
9. the base ``DynamicFusionConfig()`` non-rigid (the direct solve: kernels
   N and O and cuSOLVER's factor under the lagged JᵀJ with one factor
   reused; secant refine, fusion every 2nd frame, no incidence weight, no
   temporal band) over D frames of the deforming scene: the checks of
   phase 4, one Gram a step and a factor every LM iteration, the plain
   step from each state, a profile of 3 more frames (device busy and idle
   shares, launches a frame);
10. the base config's dense variants, three steps each from its state
   after frame 3 (``solver_jtj_int8=False``, ``solver_lagged_jtj=False``,
   ``point_to_plane=False``, and ``solver_linear="pcg"`` with
   ``solver_lagged_jtj=False``: kernel P), each step held against the
   plain step;
11. the options cell: ``quality_dynamicfusion()`` with the aperture gate,
   ``solver_p2p_hessian_stride=4``, ``node_radius_adaptive`` and
   ``solver_remove_net_rigid`` at alpha 0.5 over O hinge frames, the
   quality cell's checks, kernel E's radius in frame 0 and M, Q and E's
   radius once a step; then three steps with ``solver_p2p_lag_hessian``
   from its state after frame 3, each held against the plain step;
12. ``reference_parity()`` non-rigid (640x480 maps, 12 800 solve points)
   over R frames, known unstable as a running configuration: the plain
   step from each state; P, the factor's time and its ``info`` printed;
13. print the per-kernel JSON line, the card's name and power limit, and
   last the result line ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a torch.profiler table and trace of 3 frames of
each non-rigid preset, of the adaptive-gate path, of the options cell and
of the reference-resolution rigid path (after each run) and prints the device's
busy time, idle share and busiest kernels over them; the base config's 3
frames are profiled in every run (into DIR, else ``build/profile``).
``--dump-solve FILE`` writes the warp field and the solve's point sets of
the phase-2 state (the preset after three frames, the next frame tracked)
to an ``.npz``, for holding another solver against the same system.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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
# kernel M: the same sums in the same order and the closed form under
# -fmad=false with true divisions; the plain version divides by tensors
TOL_GATE = 0.0                # max |gate_kernel - gate_plain|; the depth bins bit for bit
TOL_IMAGE_FRAC = 1e-3         # render pixels more than one level from the plain render (a hit may flip)
# kernel N: the int8 Gram bit-equal (integer sums are exact in any order, the
# plain version sums the integer products exactly in float64, the scale
# product in the same order); the bf16 Gram within the float32 sums' order
TOL_GRAM_BF16_REL = 1e-6      # max |diff| over max |entry|
# kernel O: off the diagonal a copy; the diagonal within the mean's sum order
TOL_DAMP_REL = 1e-6
# kernel Q against its plain version (a float64 SVD through
# torch.linalg.svd): the centroids and H are float32 sums in two orders;
# the transforms are unit dual quaternions
TOL_NET_RIGID = 1e-5
# kernel P, and kernel G under the tangential rows' row modes, against the
# plain PCG on the same system: within SPREAD_PCG times the plain PCG's own
# spread when every entry of the matrix (P) or of the right-hand side (G)
# moves by one ulp (the systems are ill conditioned at small lambda, and a
# flipped bf16 rounding of G's t grows over the iterations: the strided
# mode read 1.39e-02 against the plain version where the three-row mode
# read 8.46e-03), and never held tighter than TOL_DENSE_PCG_FLOOR (P) or
# TOL_PCG_REL (G)
SPREAD_PCG = 4.0
TOL_DENSE_PCG_FLOOR = 1e-5

# H100 SXM peaks (NVIDIA data sheet): memory 3.35 TB/s, float32 (no tensor core) 67 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12

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
BULGE_FRAMES = 8    # of the bulge scene under the aperture gate (printed, not checked)

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
    "extract_cloud": ("extract.cu", "dynamicfusion_tpu/ops/tsdf.py:669"),
    "sample_nodes": ("extract.cu", "dynamicfusion_tpu/models/warpfield.py:105"),
    "data_term_tangential": ("data_term.cu", "dynamicfusion_tpu/solvers/warp_solver.py:299"),
    "pcg_tangential": ("pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:823"),
    "p2p_gate": ("p2p_gate.cu", "dynamicfusion_tpu/pipeline/kinfu.py:205"),
    "coarse_band": ("bands.cu", "dynamicfusion_tpu/ops/tsdf.py:620"),
    "raycast_coarse": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:386"),
    "raycast_full_res": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:386"),
    "raycast_render": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:386"),
    "icp_reduce_full_res": ("icp_reduce.cu", "dynamicfusion_tpu/solvers/icp.py:38"),
    "data_term_p2p": ("data_term.cu", "dynamicfusion_tpu/solvers/warp_solver.py:76"),
    "insert_select_full_res": ("insert_nodes.cu", "dynamicfusion_tpu/models/warpfield.py:372"),
    "gram_scales": ("dense_system.cu", "dynamicfusion_tpu/solvers/warp_solver.py:505"),
    "dense_gram": ("dense_system.cu", "dynamicfusion_tpu/solvers/warp_solver.py:505"),
    "dense_gram_bf16": ("dense_system.cu", "dynamicfusion_tpu/solvers/warp_solver.py:505"),
    "dense_damp": ("dense_system.cu", "dynamicfusion_tpu/solvers/warp_solver.py:479"),
    # the factor is cuSOLVER's (the JAX package's is its library's too)
    "cholesky": ("dynamicfusion_tpu_torch/kernels/__init__.py", "dynamicfusion_tpu/solvers/warp_solver.py:872"),
    "node_radius": ("knn_blend.cu", "dynamicfusion_tpu/models/warpfield.py:78"),
    "node_radius_insert": ("knn_blend.cu", "dynamicfusion_tpu/models/warpfield.py:78"),
    "net_rigid": ("net_rigid.cu", "dynamicfusion_tpu/models/warpfield.py:463"),
    "data_term_strided": ("data_term.cu", "dynamicfusion_tpu/solvers/warp_solver.py:1063"),
    "pcg_strided": ("pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:1035"),
    "pcg_lagged": ("pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:1035"),
    "dense_pcg": ("dense_pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:860"),
}
COUNTER = {"raycast_newton8": "raycast", "fuse_bricks_nonrigid": "fuse_bricks", "data_term_tangential": "data_term",
           "pcg_tangential": "pcg", "raycast_coarse": "raycast", "raycast_full_res": "raycast",
           "raycast_render": "raycast", "icp_reduce_full_res": "icp_reduce", "data_term_p2p": "data_term",
           "dense_gram_bf16": "dense_gram", "insert_select_full_res": "insert_select",
           "node_radius_insert": "node_radius", "data_term_strided": "data_term", "pcg_strided": "pcg",
           "pcg_lagged": "pcg"}
# the run whose counters a row's launches are: kernels A-D the rigid path's,
# kernel L the preset's (frame 0), the tangential rows the quality preset's,
# kernel M the adaptive-gate path's, the full-resolution rows the
# reference-resolution rigid path's (the render's march its render calls'),
# the options' rows the options cell's (the plane-rows-only PCG its lagged
# steps', kernel P the base config's dense-PCG variant's), the rest the
# preset's
PATH = {**dict.fromkeys(RIGID_KERNELS, "rigid"), "extract_cloud": "frame0", "sample_nodes": "frame0",
        "data_term_tangential": "quality", "pcg_tangential": "quality", "p2p_gate": "adaptive",
        **dict.fromkeys(("coarse_band", "raycast_coarse", "raycast_full_res", "icp_reduce_full_res"), "parity_rigid"),
        "raycast_render": "render",
        **dict.fromkeys(("gram_scales", "dense_gram", "dense_damp", "cholesky"), "base"),
        "dense_gram_bf16": "base_bf16", "data_term_p2p": "base_p2p", "insert_select_full_res": "parity_nr",
        **dict.fromkeys(("node_radius", "node_radius_insert", "net_rigid", "data_term_strided", "pcg_strided"),
                        "options"),
        "pcg_lagged": "options_lag", "dense_pcg": "base_pcg"}
# the options cell (phase 11): quality_dynamicfusion() with these
OPTIONS = dict(solver_p2p_adaptive=True, solver_p2p_hessian_stride=4, node_radius_adaptive=True,
               solver_remove_net_rigid=True, solver_net_rigid_alpha=0.5)
# the direct solve's kernels (N, O) and its factor: the PCG presets run none
# of them, the base config none of the PCG's
DENSE_KERNELS = ("gram_scales", "dense_gram", "dense_damp", "cholesky")
PCG_KERNELS = ("spd6_inv", "pcg")
# the base config's dense variants, three steps each from its state
VARIANTS = (("bf16", dict(solver_jtj_int8=False)), ("unlagged", dict(solver_lagged_jtj=False)),
            ("p2p", dict(point_to_plane=False)), ("pcg_unlagged", dict(solver_linear="pcg", solver_lagged_jtj=False)))


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


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F32):
    """max(bytes / the memory rate, operations / ``peak``) in ms."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(name: str, ok: bool, msg: str) -> None:
    print(f"[check] {name}: {msg} -> {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} failed: {msg}")


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's scatter sums (``index_add_``) on the card in a fixed order
    (each node's entries in entry order, as the kernels sum them), for the
    plain PCG references and the plain systems they are held on: in atomic
    order their last bits change run to run, and twelve iterations amplify
    a flipped bf16 rounding past the tolerance in some runs (the preset's
    PCG check read 4.51e-03 in one run and 1.10e-02 in another with the
    same kernel G, the system's sums in atomic order)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def ulp_moves(torch, t):
    """``t`` with every entry moved by one ulp: up, down, and alternately
    up and down (a symmetric matrix stays symmetric only under the first
    two); one at a time, for the plain PCGs' own spread."""
    up = torch.full_like(t, float("inf"))
    yield torch.nextafter(t, up)
    yield torch.nextafter(t, -up)
    if t.dim() == 1:
        sign = torch.where(torch.arange(t.shape[0], device=t.device) % 2 == 0, 1.0, -1.0)
        yield torch.nextafter(t, sign * up)


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
    hold_raycast(torch, report, "raycast", cfg, st.vol.tsdf,
                 tsdf_ops.rays(cfg, cam2vol, intr_t, rows_t, cols_t, t_band=band), 24)

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
    with deterministic(torch):  # the PCG below is held on this system: the same one every run
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
    with deterministic(torch):
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
    with deterministic(torch):
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
    tangential_kernels(torch, report, dev, field, inputs)
    option_kernels(torch, report, dev, nr_depths, field, inputs)
    gate_kernels(torch, report, dev, st, tr)
    full_res_kernels(torch, report, dev, st, nr_depths[3])

    # H: insertion into a field with half its slots free
    hcand = (cand + 0.03).contiguous()
    hvalid = ~torch.isnan(hcand[:, 0])
    fi = torch.tensor(9, dtype=torch.int32).to(dev)
    hfield, exact, err = hold_insert(torch, "insert_nodes", cfg, field, hcand, hvalid, fi)
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
    rad = torch.full((n,), cfg.node_radius, device=dev)
    report["insert_apply"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.insert_apply(
            hfield.positions, hfield.dq, hfield.radius, hfield.active, hfield.count, hfield.last_support,
            plan.slots, plan.new_pos, seed, fi, rad)),
        plain_ms=cuda_ms(torch, lambda: warpfield._insert_apply_plain(hfield, plan, seed, fi, rad), reps=5),
        bound=bound_ms(n * 53 * 2 + n * 56 + 8, n * 60.0),
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


def hold_insert(torch, name, cfg, field, cand, valid, fi, min_candidates=1):
    """Kernel H's insertion of ``cand`` into ``field`` with half its slots
    freed, held against the plain version (slots, active set and counts
    equal, positions and dqs within TOL_FIELD, some nodes inserted).
    Returns (the half-free field, exact, max float diff)."""
    from dynamicfusion_tpu_torch.models import warpfield

    n = field.positions.shape[0]
    act = field.active & (torch.arange(n, device=cand.device) % 2 == 0)
    hfield = field._replace(active=act, count=act.sum(dtype=torch.int32))
    hk = warpfield.insert_nodes(cfg, hfield, cand, valid, fi)
    hp = warpfield.insert_nodes(cfg, hfield, cand, valid, fi, plain=True)
    grew = int(hk.count) - int(hfield.count)
    exact, err = True, 0.0
    for a, b in zip(hk, hp):
        if a.dtype == torch.float32:
            err = max(err, abs_err(torch, a, b))
        else:
            exact = exact and torch.equal(a, b)
    nc = cand.shape[0]
    check(name, exact and err <= TOL_FIELD and grew > 0 and nc >= min_candidates,
          f"{nc} candidates (need >= {min_candidates}), {n - int(hfield.count)} free slots: {grew} inserted; slots, "
          f"active set, counts equal {exact}; max position/dq diff {err:.2e} (tol {TOL_FIELD})")
    return hfield, exact, err


def tangential_kernels(torch, report, dev, field, inputs):
    """Phase 2 for kernels F and G with the tangential rows of
    ``quality_dynamicfusion()`` (three residual rows a point) on the
    preset's phase-2 state: the data term, one matvec and the PCG solve."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = DynamicFusionConfig.quality_dynamicfusion()
    n = field.positions.shape[0]
    s = ws.prepare(cfg, field, inputs)
    npt = s.p_can.shape[0]
    dk = ws.data_term(cfg, s, field.dq, True)
    with deterministic(torch):  # the PCG below is held on this system: the same one every run
        dp = ws.data_term(cfg, s, field.dq, True, plain=True)
    errs = [rel_err(torch, dk.jtr, dp.jtr), rel_err(torch, dk.blocks, dp.blocks), rel_err(torch, dk.cost, dp.cost)]
    check("data_term_tangential", max(errs) <= TOL_DATA_REL and tuple(dk.rows.shape) == (npt, 3, 8, 6),
          f"{npt} points x 3 rows: relative diff Jᵀr {errs[0]:.2e}, blocks {errs[1]:.2e}, cost {errs[2]:.2e} "
          f"(tol {TOL_DATA_REL}); rows {tuple(dk.rows.shape)}")
    lists_b = (npt * 8 + n + 1) * 4
    report["data_term_tangential"] = dict(
        err=max(abs_err(torch, dk.jtr, dp.jtr), abs_err(torch, dk.blocks, dp.blocks)),
        ms=cuda_ms(torch, lambda: ws.data_term(cfg, s, field.dq, True)),
        plain_ms=cuda_ms(torch, lambda: ws.data_term(cfg, s, field.dq, True, plain=True), reps=3),
        # as the one-row term, plus the tangent basis and weight in and
        # three rows out; ~1500 operations a point and row, 48 a (point,
        # neighbour, row) entry
        bound=bound_ms(npt * (36 + 1 + 64 + 32 + 24 + 4) + n * 32 + lists_b + npt * 3 * 96 + n * 144 + n * 24 + 4,
                       npt * 3 * 1500.0 + npt * 8 * 3 * 48.0),
        library_ms=None,
    )
    with deterministic(torch):
        ep = ws.edge_term(cfg, s, field.dq, plain=True)
    blocks_full = dp.blocks + ep.diag
    diag_eff, unit = ws.damping_terms(cfg, field.active, blocks_full)
    damp = cfg.solver_lm_lambda_init * diag_eff + unit
    sysm = ws.System(dp.rows, ep, damp)
    pv = torch.from_numpy(np.random.RandomState(1).randn(6 * n).astype(np.float32)).to(dev)
    err = rel_err(torch, ws.matvec(s, sysm, pv), ws.matvec(s, sysm, pv, plain=True))
    check("matvec_tangential", err <= TOL_MATVEC_REL,
          f"6N = {6 * n}, {npt} x 3 rows: max relative diff {err:.2e} (tol {TOL_MATVEC_REL})")
    # the PCG is held with the float64 inverse of the damped blocks as the
    # preconditioner, as the one-row PCG is
    m = blocks_full + torch.diag_embed(damp.reshape(n, 6))
    ip = torch.linalg.inv(m.double()).float().contiguous()
    b = dp.jtr + ep.jtr
    on = torch.ones((), dtype=torch.bool, device=dev)
    iters, rtol = cfg.solver_linear_iters, cfg.solver_linear_tol
    xk = ws.pcg(s, sysm, ip, b, iters, rtol, on)
    with deterministic(torch):
        xp = ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True)
    finite = bool(torch.isfinite(xk).all()) and bool(torch.isfinite(xp).all())
    err = rel_err(torch, xk, xp) if finite else float("inf")
    check("pcg_tangential", finite and err <= TOL_PCG_REL and not bool(ws.pcg(s, sysm, ip, b, iters, rtol, ~on).any()),
          f"up to {iters} iterations over 6N = {6 * n}, {npt} x 3 rows: finite {finite}, max relative diff "
          f"{err:.2e} (tol {TOL_PCG_REL}); inactive -> 0")
    ran = pcg_iterations(torch, ws, s, sysm, ip, b, iters, rtol)
    ne = s.e_src.shape[0]
    per_iter = npt * 3 * 8 * 6 * 2 * 2 + ne * 2 * 72 * 2 + n * (72 + 60)
    report["pcg_tangential"] = dict(
        err=abs_err(torch, xk, xp),
        ms=cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on)),
        plain_ms=cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True), reps=5),
        # as the one-row PCG with three bf16 rows a point
        bound=bound_ms(npt * (3 * 96 + 32) + lists_b + ne * (3 * 144 + 8 + 4) + (n + 1) * 4 + n * (24 + 144 + 24)
                       + n * 24, ran * per_iter + n * 72.0),
        library_ms=None,
        iterations=ran,
    )


def options_config():
    """The options cell's configuration: ``quality_dynamicfusion()`` with
    the aperture gate, the tangential rows of every 4th point in the PCG
    matrix, the adaptive node radius and half the net rigid motion removed
    a frame."""
    import dataclasses

    from dynamicfusion_tpu_torch.config import DynamicFusionConfig

    return dataclasses.replace(DynamicFusionConfig.quality_dynamicfusion(), **OPTIONS)


def _bf16_ulps(torch, a, b) -> int:
    """Largest distance in bf16 steps between two bf16 tensors."""
    def ordered(t):
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return int((ordered(a) - ordered(b)).abs().max())


def option_kernels(torch, report, dev, nr_depths, field, inputs):
    """Phase 2 for the solver and warp-field options on the preset's
    phase-2 state (1024 nodes, 3 200 solve points): kernel E's radius entry
    at frame 0's nodes and at the insertion shape (1024 candidates against
    the field), bit-equal; kernel Q on the pre/post-solve pair of the
    quality preset's solve and on a field with two active nodes (which it
    must leave as it is), no host sync; kernels F and G under the
    tangential rows' row modes (every 2nd and 4th point, and the plane rows
    only), as the three-row mode is held."""
    import dataclasses

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = options_config()
    n = field.positions.shape[0]

    # E: the adaptive radius at frame 0 (each node against the others) and
    # at insertion (candidates against the field's nodes)
    f0 = kinfu.first_frame(cfg, kinfu.init_state(cfg, dev), torch.from_numpy(nr_depths[0]).to(dev)).warp
    cand = torch.nan_to_num(inputs.p_can[~torch.isnan(inputs.p_can[:, 0])][:n]).contiguous()
    for name, q, ref, ok, self_ref in (("node_radius", f0.positions, f0.positions, f0.active, True),
                                       ("node_radius_insert", cand, field.positions, field.active, False)):
        k = cfg.node_radius_knn + int(self_ref)
        rk = warpfield.adaptive_radius(cfg, q, ref, ok, self_ref)
        rp = warpfield.adaptive_radius(cfg, q, ref, ok, self_ref, plain=True)
        same = torch.equal(rk, rp)
        inside = float(((rk > cfg.node_radius_min) & (rk < cfg.node_radius_max)).float().mean())
        check(name, same, f"{q.shape[0]} queries x {ref.shape[0]} nodes ({int(ok.sum())} active), k = {k}: bit-equal "
              f"to the plain version {same} (max |diff| {abs_err(torch, rk, rp):.2e}); radii {float(rk.min()):.4f}.."
              f"{float(rk.max()):.4f} m, {inside:.3f} of them inside the clip")
        m, nn = q.shape[0], ref.shape[0]
        report[name] = dict(
            err=abs_err(torch, rk, rp),
            ms=cuda_ms(torch, lambda: kernels.node_radius(ref, ok, q, k, cfg.node_radius_scale, cfg.node_radius_min,
                                                          cfg.node_radius_max)),
            plain_ms=cuda_ms(torch, lambda: warpfield.adaptive_radius(cfg, q, ref, ok, self_ref, plain=True), reps=5),
            # queries and nodes in, radii out; ~10 operations a (query, node)
            # pair for the expansion and the compare
            bound=bound_ms(m * 12 + nn * 13 + m * 4, m * nn * 10.0),
            library_ms=cuda_ms(torch, lambda: torch.topk(torch.cdist(q, ref), k, largest=False)),
        )

    # Q: the net rigid removal on the quality preset's solve from this state
    qcfg = DynamicFusionConfig.quality_dynamicfusion()
    solved, _ = ws.solve(qcfg, field, inputs)
    alpha = cfg.solver_net_rigid_alpha
    dk, gk = kernels.net_rigid(field.positions, field.dq, field.active, solved.dq, solved.active, alpha)
    dp, gp = warpfield._remove_net_rigid_plain(field, solved, alpha)
    err = abs_err(torch, dk, dp)
    gerr = abs_err(torch, gk, gp)
    moved = abs_err(torch, dk, solved.dq)
    two = field.active & (torch.cumsum(field.active.to(torch.int32), 0) <= 2)
    few = kernels.net_rigid(field.positions, field.dq, two, solved.dq, solved.active, alpha)[0]
    h3 = torch.randn((3, 3), generator=torch.Generator().manual_seed(3)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.net_rigid(field.positions, field.dq, field.active, solved.dq, solved.active, alpha)
        try:
            torch.linalg.svd(h3)
            svd_syncs = False
        except RuntimeError:
            svd_syncs = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[info] torch.linalg.svd of a 3x3 on the card {'waits for the device (a host sync)' if svd_syncs else 'does not sync'}"
          f" under set_sync_debug_mode('error'); kernel Q does not", flush=True)
    check("net_rigid", err <= TOL_NET_RIGID and gerr <= TOL_NET_RIGID and torch.equal(few, solved.dq),
          f"{int(field.active.sum())} active nodes, alpha {alpha}: transforms max |diff| {err:.2e}, G⁻¹ {gerr:.2e} "
          f"(tol {TOL_NET_RIGID}); the removal moves them by up to {moved:.2e}; two active nodes leave the field as "
          f"it is {torch.equal(few, solved.dq)}")
    report["net_rigid"] = dict(
        err=max(err, gerr),
        ms=cuda_ms(torch, lambda: kernels.net_rigid(field.positions, field.dq, field.active, solved.dq, solved.active,
                                                    alpha)),
        plain_ms=cuda_ms(torch, lambda: warpfield._remove_net_rigid_plain(field, solved, alpha), reps=5),
        # positions, both transform sets and both masks in, the transforms
        # out; two transforms, H's products and the cleaned product a node
        bound=bound_ms(n * (12 + 32 + 32 + 2) + n * 32 + 32, n * 400.0),
        library_ms=cuda_ms(torch, lambda: torch.linalg.svd(h3)),
    )

    # F and G under the row modes of the tangential rows
    lists_b = None
    for tag, changes in (("stride2", dict(solver_p2p_hessian_stride=2)), ("strided", dict(solver_p2p_hessian_stride=4)),
                         ("lagged", dict(solver_p2p_lag_hessian=True))):
        mcfg = dataclasses.replace(qcfg, **changes)
        used, stride = ws.row_mode(mcfg)
        s = ws.prepare(mcfg, field, inputs)
        npt, ne = s.p_can.shape[0], s.e_src.shape[0]
        lists_b = (npt * 8 + n + 1) * 4
        dk_ = ws.data_term(mcfg, s, field.dq, True, row_stride=stride)
        with deterministic(torch):  # the PCG below is held on this system: the same one every run
            dp_ = ws.data_term(mcfg, s, field.dq, True, plain=True, row_stride=stride)
        ulps = _bf16_ulps(torch, dk_.rows, dp_.rows)
        errs = [rel_err(torch, dk_.jtr, dp_.jtr), rel_err(torch, dk_.blocks, dp_.blocks)]
        check(f"data_term_{tag}", ulps <= 1 and max(errs) <= TOL_DATA_REL,
              f"{npt} points x 3 rows, row stride {stride}: bf16 rows within {ulps} bf16 step of the plain version's "
              f"(tol 1); relative diff Jᵀr {errs[0]:.2e}, blocks {errs[1]:.2e} (tol {TOL_DATA_REL})")
        if tag == "strided":
            report["data_term_strided"] = dict(
                err=max(abs_err(torch, dk_.jtr, dp_.jtr), abs_err(torch, dk_.blocks, dp_.blocks)),
                ms=cuda_ms(torch, lambda: ws.data_term(mcfg, s, field.dq, True, row_stride=stride)),
                plain_ms=cuda_ms(torch, lambda: ws.data_term(mcfg, s, field.dq, True, plain=True, row_stride=stride),
                                 reps=3),
                bound=bound_ms(npt * (36 + 1 + 64 + 32 + 24 + 4) + n * 32 + lists_b + npt * 3 * 96 + n * 144 + n * 24
                               + 4, npt * 3 * 1500.0 + npt * 8 * 3 * 48.0),
                library_ms=None,
            )
        with deterministic(torch):
            ep = ws.edge_term(mcfg, s, field.dq, plain=True)
        blocks_full = dp_.blocks + ep.diag
        diag_eff, unit = ws.damping_terms(mcfg, field.active, blocks_full)
        damp = mcfg.solver_lm_lambda_init * diag_eff + unit
        sysm = ws.System(dp_.rows, ep, damp, used, stride)
        pv = torch.from_numpy(np.random.RandomState(1).randn(6 * n).astype(np.float32)).to(dev)
        ak = ws.matvec(s, sysm, pv)
        err = rel_err(torch, ak, ws.matvec(s, sysm, pv, plain=True))
        apart = rel_err(torch, ak, ws.matvec(s, ws.System(dp_.rows, ep, damp), pv))
        check(f"matvec_{tag}", err <= TOL_MATVEC_REL and apart > TOL_MATVEC_REL,
              f"6N = {6 * n}, rows used {used or 3}, stride {stride}: max relative diff {err:.2e} (tol "
              f"{TOL_MATVEC_REL}); {apart:.2e} from the all-rows matvec")
        m = blocks_full + torch.diag_embed(damp.reshape(n, 6))
        ip = torch.linalg.inv(m.double()).float().contiguous()
        b = dp_.jtr + ep.jtr
        on = torch.ones((), dtype=torch.bool, device=dev)
        iters, rtol = mcfg.solver_linear_iters, mcfg.solver_linear_tol
        xk = ws.pcg(s, sysm, ip, b, iters, rtol, on)
        with deterministic(torch):
            xp = ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True)
            spread = max(rel_err(torch, ws.pcg(s, sysm, ip, b1, iters, rtol, on, plain=True), xp)
                         for b1 in ulp_moves(torch, b))
        finite = bool(torch.isfinite(xk).all()) and bool(torch.isfinite(xp).all())
        err = rel_err(torch, xk, xp) if finite else float("inf")
        tol = max(TOL_PCG_REL, SPREAD_PCG * spread)
        check(f"pcg_{tag}", finite and err <= tol,
              f"up to {iters} iterations over 6N = {6 * n}, rows used {used or 3}, stride {stride}: finite {finite}, "
              f"max relative diff {err:.2e} (tol max({TOL_PCG_REL}, {SPREAD_PCG} x the plain PCG's one-ulp spread "
              f"{spread:.2e}))")
        if tag == "stride2":
            continue
        ran = pcg_iterations(torch, ws, s, sysm, ip, b, iters, rtol)
        # the rows in the matrix: every point's plane row, the tangential
        # rows of one point in ``stride`` (none with the plane rows only)
        rows_in = npt + (0 if used == 1 else 2 * ((npt + stride - 1) // stride))
        per_iter = rows_in * 8 * 6 * 2 * 2 + ne * 2 * 72 * 2 + n * (72 + 60)
        report[f"pcg_{tag}"] = dict(
            err=abs_err(torch, xk, xp),
            ms=cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on)),
            plain_ms=cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True), reps=5),
            bound=bound_ms(rows_in * 96 + npt * 32 + lists_b + ne * (3 * 144 + 8 + 4) + (n + 1) * 4
                           + n * (24 + 144 + 24) + n * 24, ran * per_iter + n * 72.0),
            library_ms=None,
            iterations=ran,
        )


def hold_raycast(torch, report, name, cfg, tsdf, rays, refine_gathers):
    """Kernel C against its plain version on the same rays (hit/miss, vertex
    and normal), timed, with its bound for this run's march: the samples
    the rays take plus ``refine_gathers`` corner loads a hit."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    ray_org, dirs, tmin, tmax = rays
    fk, vk_, nk_ = tsdf_ops.march_and_refine(cfg, tsdf, ray_org, dirs, tmin, tmax)
    fp, vp_, np_ = tsdf_ops.march_and_refine_plain(cfg, tsdf, ray_org, dirs, tmin, tmax)
    both = fk & fp
    found_frac = float((fk != fp).float().mean())
    err = float((vk_ - vp_)[both].abs().max()) if bool(both.any()) else 0.0
    # a hit whose refined point left the volume carries a NaN normal in both
    nan_same = torch.equal(torch.isnan(nk_[both]), torch.isnan(np_[both]))
    nerr = float(torch.nan_to_num((nk_ - np_)[both].abs(), nan=0.0).max()) if bool(both.any()) else 0.0
    check(name, found_frac <= TOL_RAYCAST_FOUND_FRAC and err <= TOL_RAYCAST_M and nan_same,
          f"{dirs.shape[1]}x{dirs.shape[0]}: hit/miss differs on {found_frac:.2e} of rays "
          f"(tol {TOL_RAYCAST_FOUND_FRAC}), "
          f"max vertex diff {err:.3e} m (tol {TOL_RAYCAST_M}), max normal diff {nerr:.3e}; "
          f"{int(fk.sum())} of {fk.numel()} rays hit")
    hits = int(fk.sum())
    n_samples = march_samples(torch, cfg, tsdf, ray_org, dirs, tmin, tmax) + refine_gathers * hits
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    refine = tsdf_ops._refine_mode(cfg)
    report[name] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.march_and_refine(
            tsdf, ray_org, dirs, tmin, tmax, cfg.voxel_size, step, tsdf_ops.march_steps(cfg),
            cfg.raycast_adaptive_step, refine=refine)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.march_and_refine_plain(cfg, tsdf, ray_org, dirs, tmin, tmax), reps=3),
        # int16 samples (the march, the refine's corners), the rays in,
        # found/vertex/normal out; ~12 operations a sample, the refine's a hit
        bound=bound_ms(n_samples * 2 + fk.numel() * (12 + 8 + 1 + 24),
                       n_samples * 12.0 + hits * (250.0 if refine == 0 else 120.0)),
        library_ms=None,
    )
    return fk


def gate_inputs(torch, cfg, st, tr):
    """Kernel M's inputs as ``track`` builds them from the state before a
    step and its tracking: the filtered live points and normals at the ICP
    pose, the previous warped model map (world frame), the live depth."""
    from dynamicfusion_tpu_torch.core import se3

    s = cfg.raycast_shift
    pose = torch.where(tr.icp_res.ok, se3.compose(st.pose, tr.icp_res.transform), st.pose)
    return (se3.transform_points(pose, tr.points[s]).contiguous(), se3.rotate_dirs(pose, tr.normals[s]).contiguous(),
            se3.transform_points(st.pose, st.prev_points[0]).contiguous(), tr.points[s][..., 2].contiguous())


def hold_gate(torch, cfg, gin):
    """Kernel M against its plain version on ``gin``: (kernel gate, its
    depth bins, bins equal, max |gate diff|, pixels not bit-equal, pixels
    with the gate strictly between 0 and 1)."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    gk, bins = kinfu.p2p_gate_kernel(cfg, *gin)
    gp = kinfu.p2p_gate(cfg, *gin, plain=True)
    bins_same = torch.equal(bins.long(), kinfu.gate_bins(gin[3]))
    return (gk, bins, bins_same, float((gk - gp).abs().max()), int((gk != gp).sum()),
            int(((gk > 0) & (gk < 1)).sum()))


def gate_kernels(torch, report, dev, st, tr):
    """Phase 2 for kernel M under the adaptive-gate configuration
    (``quality_dynamicfusion()`` with ``solver_p2p_adaptive``) on the
    preset's phase-2 state: the gate of the next frame as ``track`` makes
    it (the filtered live surface at the ICP pose against the previous
    warped model map, 160x120), depth bins and gate held to the plain
    version. Some pixels must open the gate part way, so that the closed
    form is exercised, not only the empty windows' zeros (phase 6 holds M
    again on every state of the hinge and the bulge)."""
    import dataclasses

    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = dataclasses.replace(DynamicFusionConfig.quality_dynamicfusion(), solver_p2p_adaptive=True)
    gin = gate_inputs(torch, cfg, st, tr)
    w = cfg.solver_p2p_gate_window
    gk, bins, bins_same, err, n_diff, n_part = hold_gate(torch, cfg, gin)
    rows, cols = gk.shape
    check("p2p_gate", bins_same and err <= TOL_GATE and n_part > 0,
          f"{cols}x{rows}, {w}x{w} window: depth bins equal the plain version's {bins_same}; max |gate diff| "
          f"{err:.3e} (tol {TOL_GATE}), {n_diff} pixels not bit-equal; mean gate {float(gk.mean()):.4f}, "
          f"{int((gk > 0).sum())} pixels open, {n_part} of them part way (need > 0), "
          f"{len(torch.unique(bins))} bins in use")
    npx = rows * cols
    report["p2p_gate"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kinfu.p2p_gate_kernel(cfg, *gin)),
        plain_ms=cuda_ms(torch, lambda: kinfu.p2p_gate(cfg, *gin, plain=True), reps=3),
        # the function's least work: three point/normal maps and the depth
        # in, the gate and its bins out (48 bytes a pixel); box sums by
        # running sums, one add and one subtract a (bin, channel) along
        # each axis (2 x 2 x 16 x 11), the three bins' 11 sums added (66),
        # ~150 operations of features and closed form a pixel
        bound=bound_ms(npx * (3 * 12 + 4) + npx * (4 + 4),
                       npx * (2.0 * 2 * kinfu.GATE_BINS * kinfu.GATE_CHANNELS + 66 + 150)),
        library_ms=None,
    )


def full_res_kernels(torch, report, dev, st, depth_np):
    """Phase 2 for the reference resolution of ``reference_parity()`` (rigid,
    640x480 model maps) on the preset's phase-2 volume at its camera: kernel
    C's coarse march (160x120, no band), kernel J's coarse band (bit-equal
    to its plain version from the same coarse hits), C at 640x480 in that
    band and as the full march of ``render(pose)``, and kernel B at 640x480
    (the next frame's level-0 maps against the banded model maps)."""
    import dataclasses

    import torch.nn.functional as F

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.ops import preprocess, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import icp

    cfg = dataclasses.replace(DynamicFusionConfig.reference_parity(), rigid_only=True, raycast_refine="secant")
    rows, cols, intr = cfg.rows, cfg.cols, cfg.intr
    f = cfg.raycast_coarse_factor
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), st.pose)
    tsdf = st.vol.tsdf

    # C: the coarse march
    hold_raycast(torch, report, "raycast_coarse", cfg, tsdf, tsdf_ops.rays(cfg, cam2vol, intr.level(2), rows // f,
                                                                          cols // f), 24)
    # J: the coarse band from the kernel's coarse hits (exact)
    coarse = tsdf_ops.raycast(cfg, st.vol, cam2vol, intr.level(2), rows // f, cols // f)
    pts_c = coarse.points.contiguous()
    m = cfg.raycast_band_margin
    bk = kernels.coarse_band(pts_c, f, m)
    bp = tsdf_ops.coarse_band_plain(pts_c, f, m)
    exact = torch.equal(bk[0], bp[0]) and torch.equal(bk[1], bp[1])
    banded = int((bk[1] > bk[0]).sum())
    check("coarse_band", exact and 0 < banded < rows * cols,
          f"{cols // f}x{rows // f} coarse hits -> {cols}x{rows} band equal the plain version's bit for bit {exact}; "
          f"{banded} rays banded, {rows * cols - banded} empty")
    n_c = pts_c.shape[0] * pts_c.shape[1]
    t_src = torch.linalg.vector_norm(pts_c, dim=-1)[None, None].contiguous()
    report["coarse_band"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.coarse_band(pts_c, f, m)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.coarse_band_plain(pts_c, f, m)),
        # the coarse hits in, lo and hi at the fine resolution out; ~6
        # operations a coarse |p| and 9 taps of ~3 a fine pixel
        bound=bound_ms(n_c * 12 + rows * cols * 8, n_c * 6.0 + rows * cols * 30.0),
        library_ms=cuda_ms(torch, lambda: F.max_pool2d(t_src, 3, 1, padding=1)),
    )
    # C: 640x480 in the coarse band, and the render's full march
    hold_raycast(torch, report, "raycast_full_res", cfg, tsdf, tsdf_ops.rays(cfg, cam2vol, intr, rows, cols, t_band=bk),
                 24)
    hold_raycast(torch, report, "raycast_render", cfg, tsdf, tsdf_ops.rays(cfg, cam2vol, intr, rows, cols), 24)

    # B: the ICP system at 640x480
    model = tsdf_ops.raycast(cfg, st.vol, cam2vol, intr, rows, cols, t_band=bk)
    _, pts_pyr, nrm_pyr, _ = preprocess.build_frame_pyramid(cfg, torch.from_numpy(depth_np).to(dev))
    cp, cn, pp, pn = pts_pyr[0], nrm_pyr[0], model.points.contiguous(), model.normals.contiguous()
    dist2 = cfg.icp_dist_thres ** 2
    min_cos = math.cos(cfg.icp_angle_thres)
    t_cur = torch.eye(4, device=dev)
    ak, bk_ = icp._build_system(intr, t_cur, cp, cn, pp, pn, dist2, min_cos)
    ap_, bp_ = icp._build_system_plain(intr, t_cur, cp, cn, pp, pn, dist2, min_cos)
    scale = float(torch.maximum(ap_.abs().max(), bp_.abs().max()))
    err = float(torch.maximum((ak - ap_).abs().max(), (bk_ - bp_).abs().max()))
    check("icp_reduce_full_res", err <= TOL_ICP_REL * scale and scale > 0,
          f"{cols}x{rows}: max |diff| {err:.3e} over max |entry| {scale:.3e} (rel tol {TOL_ICP_REL}); "
          f"{int(torch.isfinite(pp[..., 0]).sum())} model pixels")
    npx = cp.shape[0] * cp.shape[1]
    report["icp_reduce_full_res"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.icp_build_system(intr, t_cur, cp, cn, pp, pn, dist2, min_cos)),
        plain_ms=cuda_ms(torch, lambda: icp._build_system_plain(intr, t_cur, cp, cn, pp, pn, dist2, min_cos)),
        bound=bound_ms((npx + pp.shape[0] * pp.shape[1]) * 24 * 2 + 64 + 27 * 4, npx * 100.0),
        library_ms=None,
    )


def extract_kernels(torch, report, dev, nr_depths):
    """Phase 2 for kernel L on the preset's frame-0 volume of the deforming
    scene: the extraction and the node sampling, each bit-equal to its
    plain version."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = DynamicFusionConfig.default_dynamicfusion()
    df = kinfu.DynamicFusion(cfg, device=dev)
    df(nr_depths[0])
    vol = df.state.vol
    maxp = max(cfg.max_nodes * cfg.node_sample_step, 1 << 20)
    ck = tsdf_ops.extract_cloud(cfg, vol, maxp, min_weight=1.0)
    cp = tsdf_ops.extract_cloud(cfg, vol, maxp, min_weight=1.0, plain=True)
    count = int(cp.count)
    same = (torch.equal(ck.valid, cp.valid) and torch.equal(ck.count, cp.count)
            and torch.equal(torch.isnan(ck.points), torch.isnan(cp.points))
            and torch.equal(torch.nan_to_num(ck.points), torch.nan_to_num(cp.points)))
    check("extract_cloud", same and 0 < count,
          f"{cfg.volume_dims}^3 frame-0 volume: {count} crossings into {maxp} rows; points, flags and count "
          f"equal the plain version's bit for bit {same}")
    fk = warpfield.init_from_cloud(cfg, cp.points, cp.valid)
    fp = warpfield.init_from_cloud(cfg, cp.points, cp.valid, plain=True)
    same_n = all(torch.equal(a, b) for a, b in zip(fk, fp))
    path_same = torch.equal(df.state.warp.positions, fp.positions) and torch.equal(df.state.warp.active, fp.active)
    mc = (maxp + cfg.node_sample_step - 1) // cfg.node_sample_step
    check("sample_nodes", same_n and path_same and int(fk.count) > 0,
          f"{mc} candidates -> {int(fk.count)} of {cfg.max_nodes} nodes: field equal the plain version's bit for bit "
          f"{same_n}; DynamicFusion's frame-0 field the same {path_same}")
    d = cfg.volume_dims
    org = tuple(float(v) for v in cfg.volume_origin)
    perm = warpfield._fair_perm_on(mc, dev)
    report["extract_cloud"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.extract_cloud(vol.tsdf, vol.weight, 1.0, maxp, cfg.voxel_size, org)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.extract_cloud_plain(cfg, vol, maxp, 1.0), reps=3),
        # tsdf and weight read once, points and flags written, the count;
        # ~8 operations a crossing test, ~10 a crossing
        bound=bound_ms(d ** 3 * 4 + maxp * 13 + 4, 3.0 * (d - 1) * d * d * 8.0 + count * 10.0),
        library_ms=None,
    )
    nsel = int(fk.count)
    report["sample_nodes"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.sample_nodes(cp.points, cp.valid, cfg.node_sample_step, perm, cfg.max_nodes)),
        plain_ms=cuda_ms(torch, lambda: warpfield._sample_nodes_plain(cp.points, cp.valid, cfg.node_sample_step, perm,
                                                                       cfg.max_nodes)),
        # the permutation and the candidates' flags read, the chosen rows
        # read, positions, flags and the count written
        bound=bound_ms(mc * (8 + 1) + nsel * 12 + cfg.max_nodes * 13 + 4, float(mc + cfg.max_nodes)),
        library_ms=None,
    )
    del df


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
    hold_raycast(torch, report, "raycast_newton8", cfg, st.vol.tsdf,
                 tsdf_ops.rays(cfg, cam2vol, intr.level(cfg.raycast_shift), rows_t, cols_t, t_band=bk), 8)

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


def clone_state(st):
    """A state whose volume the next step may update in place (every other
    field the step makes anew)."""
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume

    return st._replace(vol=TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone()))


def drive_kernel_path(torch, cfg, dev, frames):
    """The kernel path over ``frames`` through ``DynamicFusion``: every
    launch counter reset just before and read just after, the steady
    frames under ``set_sync_debug_mode("error")``. Returns (the DynamicFusion,
    launches, per-frame output rows, frame ms, the state after each frame)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.pipeline import kinfu

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
        # the state after this frame, for the plain step from it
        states.append(clone_state(df.state))
    launches = dict(kernels.launches)
    rows = [dict(ok=bool(o.icp_ok), c0=float(o.solver_cost0), c1=float(o.solver_cost1), nodes=int(o.node_count),
                 bricks=o.brick_counts.tolist()) for o in outs]
    return df, launches, rows, frame_ms, states


def check_nonrigid_run(tag, card, cfg, frames, launches, rows, frame_ms, poses_k):
    """A non-rigid run's checks: every kernel of the path (A-L) launched,
    kernel L once (frame 0), ICP healthy and the solve's cost not raised
    on every frame, fusion on the due frames."""
    from dynamicfusion_tpu_torch import kernels

    print(f"[{tag}] {len(frames)} frames at {cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3 / {cfg.max_nodes} nodes; "
          f"launches {launches}", flush=True)
    for i, r in enumerate(rows, start=1):
        print(f"[{tag}] frame {i:2d}: icp_ok {r['ok']}, solver_cost0 {r['c0']:.6e}, solver_cost1 {r['c1']:.6e}, "
              f"nodes {r['nodes']}, bricks (band, wide, dropped) {r['bricks']}")
    # the PCG launch does its own matvecs; the coarse band runs with model
    # maps at the frame size only; the aperture gate with solver_p2p_adaptive;
    # the direct solve runs N, O and the factor in place of the PCG's; kernel
    # J's march bands need the temporal band or a raycast seed
    off = {"matvec", "coarse_band"} | (set() if cfg.solver_p2p_adaptive else {"p2p_gate"})
    off |= set(PCG_KERNELS if cfg.solver_linear == "direct" else DENSE_KERNELS)
    if cfg.solver_linear == "direct" and not cfg.solver_jtj_int8:
        off.add("gram_scales")
    # the options' kernels: the adaptive radius (E), the net rigid removal
    # (Q); the dense-matrix PCG (P) runs only in the dense variants
    off |= {"dense_pcg"} | (set() if cfg.node_radius_adaptive else {"node_radius"})
    off |= set() if cfg.solver_remove_net_rigid else {"net_rigid"}
    if not cfg.raycast_temporal_band and cfg.raycast_seed_margin <= 0.0:
        off.add("march_bands")
    path = [k for k in kernels.KERNELS if k not in off]
    check(f"{tag}_launches", all(launches[k] > 0 for k in path), f"every kernel of the path launched: {launches}")
    if cfg.solver_p2p_adaptive:
        check(f"{tag}_gate_launches", launches["p2p_gate"] == len(frames) - 1,
              f"kernel M once a step: {launches['p2p_gate']} launches in {len(frames) - 1} steps")
    check(f"{tag}_frame0_kernels", launches["extract_cloud"] == 1 and launches["sample_nodes"] == 1,
          f"kernel L once in frame 0: extract_cloud {launches['extract_cloud']}, sample_nodes "
          f"{launches['sample_nodes']}")
    check(f"{tag}_icp_ok", all(r["ok"] for r in rows),
          f"ICP healthy on every tracked frame ({sum(r['ok'] for r in rows)}/{len(rows)})")
    check(f"{tag}_solver", all(r["c1"] <= r["c0"] and r["c0"] > 0 for r in rows),
          "solver_cost1 <= solver_cost0 on every frame")
    fused = [i for i, r in enumerate(rows, start=1) if r["bricks"][0] + r["bricks"][1] > 0]
    due = [i for i in range(1, len(frames)) if i % cfg.fusion_interval == 0]
    check(f"{tag}_fusion", fused == due, f"fusion on frames {fused} (due {due})")
    check(f"{tag}_no_sync", True, f"frames 2..{len(frames) - 1} ran under set_sync_debug_mode('error')")
    # the camera of the scene does not move: the pose's distance from the
    # identity is the tracker's drift
    drift_t = float(np.abs(poses_k[-1][:3, 3]).max())
    drift_r = float(np.abs(poses_k[-1][:3, :3] - np.eye(3)).max())
    print(f"[{tag}] drift of the static camera after {len(frames) - 1} steps: max |t| {drift_t:.3e} m, "
          f"max rotation entry {drift_r:.3e}")
    steady = sorted(frame_ms[2:])
    slowest = max(range(2, len(frame_ms)), key=frame_ms.__getitem__)
    print(f"[time] {card} | {tag} frame ms median {steady[len(steady) // 2]:.3f} (frames 2..{len(frames) - 1}), "
          f"frame 0 {frame_ms[0]:.3f}, frame 1 {frame_ms[1]:.3f}, min {steady[0]:.3f}, max {steady[-1]:.3f} "
          f"(frame {slowest})", flush=True)


def check_steps_vs_plain(torch, tag, cfg, dev, frames, states, poses_k, rows):
    """The plain path's step from each of the kernel path's states: pose
    and initial solve cost held against the kernel path's, ICP health and
    node counts equal."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    step_t, step_r, step_c, step_same = [], [], [], True
    for f in range(1, len(frames)):
        _, o = kinfu.step(cfg, states[f - 1], torch.from_numpy(frames[f]).to(dev), plain=True)
        pk, pp = poses_k[f], o.pose.cpu().numpy()
        step_t.append(float(np.abs(pk[:3, 3] - pp[:3, 3]).max()))
        step_r.append(float(np.abs(pk[:3, :3] - pp[:3, :3]).max()))
        step_c.append(abs(float(o.solver_cost0) - rows[f - 1]["c0"]) / rows[f - 1]["c0"])
        step_same = step_same and bool(o.icp_ok) == rows[f - 1]["ok"] and int(o.node_count) == rows[f - 1]["nodes"]
    print(f"[{tag}-step] plain step from the kernel path's state, per frame: translation diff (m) "
          f"{' '.join(f'{v:.2e}' for v in step_t)}; rotation entry {' '.join(f'{v:.2e}' for v in step_r)}; "
          f"initial solve cost, relative {' '.join(f'{v:.2e}' for v in step_c)}")
    check(f"{tag}_step_vs_plain",
          step_same and max(step_t) <= TOL_STEP_POSE and max(step_r) <= TOL_STEP_POSE
          and max(step_c) <= TOL_STEP_COST0_REL,
          f"ICP health and node counts equal {step_same}; max translation diff {max(step_t):.3e} m, rotation "
          f"entry {max(step_r):.3e} (tol {TOL_STEP_POSE}); initial solve cost {max(step_c):.3e} relative "
          f"(tol {TOL_STEP_COST0_REL})")


def run_plain_path(torch, cfg, dev, frames):
    """The plain path free running over ``frames``: (the DynamicFusion, frame ms)."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    plain = kinfu.DynamicFusion(cfg, device=dev, plain=True)
    plain_ms = []
    for d in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(d, block=False)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    return plain, plain_ms


def nonrigid_main(torch, args, dev, card, nr_depths):
    """Phase 4: the dynamicfusion preset's frame loop, kernel path (steady
    frames under the sync debug mode) and plain path."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = DynamicFusionConfig.default_dynamicfusion()
    frames = nr_depths[: args.nr_frames]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    check_nonrigid_run("nonrigid", card, cfg, frames, launches, rows, frame_ms, poses_k)
    check_steps_vs_plain(torch, "nonrigid", cfg, dev, frames, states, poses_k, rows)
    del states

    plain, plain_ms = run_plain_path(torch, cfg, dev, frames)
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


def quality_main(torch, args, dev, card):
    """Phase 5: ``quality_dynamicfusion()`` (the preset with the tangential
    data term) over ``bench.py``'s hinge scene, kernel path and the plain
    step from each of its states; free-running poses printed."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic

    cfg = DynamicFusionConfig.quality_dynamicfusion()
    n_prof = 3 if args.profile else 0
    frames = synthetic.hinge_frames(cfg.intr, cfg.rows, cfg.cols, args.q_frames + n_prof)
    frames, prof_frames = frames[: args.q_frames], frames[args.q_frames:]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    check_nonrigid_run("quality", card, cfg, frames, launches, rows, frame_ms, poses_k)
    check_steps_vs_plain(torch, "quality", cfg, dev, frames, states, poses_k, rows)
    del states
    plain, plain_ms = run_plain_path(torch, cfg, dev, frames)
    per_frame = [float(np.abs(a[:3, 3] - b.cpu().numpy()[:3, 3]).max()) for a, b in zip(poses_k, plain.poses)]
    psteady = sorted(plain_ms[2:])
    print(f"[quality-plain] free running, pose diff kernel vs plain path per frame (m; printed, not checked): "
          f"{' '.join(f'{v:.2e}' for v in per_frame)}; nodes {int(df.state.warp.count)} / {int(plain.state.warp.count)}")
    print(f"[time] {card} | quality plain-path frame ms median {psteady[len(psteady) // 2]:.3f}")
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("quality_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"warped model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    if args.profile:
        profile_frames(torch, args, dev, card, df, prof_frames, tag="quality")
    return launches


def gate_means(torch, tag, cfg, dev, frames, states, moving):
    """Per step, the mean aperture gate over the moving part's pixels and
    over the rest of the surface, from ``track`` on the kernel path's
    state before the step (``moving(cam_z)`` marks the moving part by the
    live depth in m). Kernel M is held to its plain version on every
    step's inputs: bins equal, the gate within TOL_GATE, and some pixels
    open part way over the run."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    out, same, err, n_diff, n_part = [], True, 0.0, 0, 0
    for f in range(1, len(frames)):
        tr = kinfu.track(cfg, states[f - 1], torch.from_numpy(frames[f]).to(dev))
        gin = gate_inputs(torch, cfg, states[f - 1], tr)
        gk, _, b_same, e, nd, npart = hold_gate(torch, cfg, gin)
        same, err, n_diff, n_part = same and b_same, max(err, e), n_diff + nd, n_part + npart
        z = gin[3]
        mov = moving(z) & torch.isfinite(z)
        rest = torch.isfinite(z) & ~mov
        out.append((float(gk[mov].mean()), float(gk[rest].mean())))
    check(f"{tag}_p2p_gate", same and err <= TOL_GATE and n_part > 0,
          f"kernel M on the {len(frames) - 1} steps' inputs: depth bins equal the plain version's {same}; "
          f"max |gate diff| {err:.3e} (tol {TOL_GATE}), {n_diff} pixels not bit-equal; {n_part} pixel-steps "
          f"open part way (need > 0)")
    return out


def adaptive_main(torch, args, dev, card):
    """Phase 6: ``quality_dynamicfusion()`` with the aperture gate
    (``solver_p2p_adaptive``) over ``bench.py``'s hinge scene, kernel path
    and the plain step from each of its states; then the bulge scene (a
    bump travelling over a plane), printed only. The mean gate over the
    moving part and over the rest of the surface is printed for both."""
    import dataclasses

    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic

    cfg = dataclasses.replace(DynamicFusionConfig.quality_dynamicfusion(), solver_p2p_adaptive=True)
    n_prof = 3 if args.profile else 0
    frames = synthetic.hinge_frames(cfg.intr, cfg.rows, cfg.cols, args.a_frames + n_prof)
    frames, prof_frames = frames[: args.a_frames], frames[args.a_frames:]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    check_nonrigid_run("adaptive", card, cfg, frames, launches, rows, frame_ms, poses_k)
    check_steps_vs_plain(torch, "adaptive", cfg, dev, frames, states, poses_k, rows)
    # the spheres stand in front of the plane z = 1.3
    means = gate_means(torch, "adaptive", cfg, dev, frames, states, lambda z: z < 1.25)
    print(f"[adaptive] hinge, mean gate per step (spheres / plane): "
          f"{' '.join(f'{a:.3f}/{b:.3f}' for a, b in means)}")
    del states
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("adaptive_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"warped model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    if args.profile:
        profile_frames(torch, args, dev, card, df, prof_frames, tag="adaptive", focus=("gate_",))
    del df

    bulge = synthetic.bulge_frames(cfg.intr, cfg.rows, cfg.cols, BULGE_FRAMES)
    df, b_launches, b_rows, b_ms, b_states = drive_kernel_path(torch, cfg, dev, bulge)
    steady = sorted(b_ms[2:])
    # the bump rises up to 8 cm from the plane z = 1.1
    means = gate_means(torch, "bulge", cfg, dev, bulge, b_states, lambda z: z < 1.095)
    costs = " ".join("{:.3e}->{:.3e}".format(r["c0"], r["c1"]) for r in b_rows)
    print(f"[adaptive] bulge, {len(bulge)} frames (printed, not checked): icp_ok {[r['ok'] for r in b_rows]}, "
          f"solver cost0 -> cost1 {costs}; frame ms median {steady[len(steady) // 2]:.3f}; kernel M launches "
          f"{b_launches['p2p_gate']}")
    print(f"[adaptive] bulge, mean gate per step (bump / plane): {' '.join(f'{a:.3f}/{b:.3f}' for a, b in means)}")
    del df, b_states
    return launches


def parity_main(torch, args, dev, card):
    """Phase 7: ``reference_parity()`` with ``rigid_only`` (the reference's
    KinectFusion at its own resolution: 640x480 model maps, ICP at 640x480
    down to 80x60, the coarse band every frame, fusion every frame) over the
    rigid orbit, kernel path and plain path; then the renders. Returns (the
    path's launches, the render calls' launches)."""
    import dataclasses

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = dataclasses.replace(DynamicFusionConfig.reference_parity(), rigid_only=True)
    frame = rigid_frame_fn(cfg)
    frames = [frame(i) for i in range(args.p_frames)]
    prof_frames = [frame(i) for i in range(args.p_frames, args.p_frames + 3)] if args.profile else []
    truth = [synthetic.orbit_pose(ANGLE_STEP * i, target=TARGET) for i in range(args.p_frames)]
    df = kinfu.DynamicFusion(cfg, device=dev)
    kernels.reset_launches()
    oks, frame_ms = [], []
    for i, d in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df(d, block=False)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i > 0:
            oks.append(df.last_outputs.icp_ok)
    launches = dict(kernels.launches)
    poses_k = [p.cpu().numpy() for p in df.poses]
    oks = [bool(o) for o in oks]
    n = len(frames)
    print(f"[parity] reference_parity() rigid: {n} frames at {cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3, model maps "
          f"{cfg.cols // cfg.raycast_subsample}x{cfg.rows // cfg.raycast_subsample}, refine {df.cfg.raycast_refine}; "
          f"launches {launches}", flush=True)
    check("parity_launches", all(launches[k] > 0 for k in RIGID_KERNELS + STENCIL_KERNELS if k != "march_bands")
          and launches["coarse_band"] == n and launches["raycast"] == 2 * n,
          f"kernels A-D, I, K launched; the coarse band once a frame ({launches['coarse_band']} in {n} frames) and C "
          f"twice, its coarse march and the banded march ({launches['raycast']})")
    check("parity_icp_ok", all(oks), f"ICP healthy on every tracked frame ({sum(oks)}/{len(oks)})")
    steady = sorted(frame_ms[2:])
    print(f"[time] {card} | parity frame ms median {steady[len(steady) // 2]:.3f} (frames 2..{n - 1}), "
          f"frame 0 {frame_ms[0]:.3f}, min {steady[0]:.3f}, max {steady[-1]:.3f}", flush=True)

    plain, plain_ms = run_plain_path(torch, cfg, dev, frames)
    poses_p = [p.cpu().numpy() for p in plain.poses]
    per_frame = [float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(poses_k, poses_p)]
    psteady = sorted(plain_ms[2:])
    print(f"[parity-plain] pose diff kernel vs plain path per frame (m): {' '.join(f'{v:.2e}' for v in per_frame)}")
    print(f"[time] {card} | parity plain-path frame ms median {psteady[len(psteady) // 2]:.3f}")
    check("parity_pose_vs_plain", max(per_frame) <= TOL_POSE_PLAIN_M,
          f"max |t_kernel - t_plain| {max(per_frame):.3e} m (tol {TOL_POSE_PLAIN_M})")
    err_truth = float(np.linalg.norm(poses_k[-1][:3, 3] - truth[-1][:3, 3]))
    check("parity_pose_vs_truth", err_truth <= TOL_POSE_TRUTH_M,
          f"final |t - t_orbit| {err_truth:.3e} m (tol {TOL_POSE_TRUTH_M})")
    mp = df.last_outputs.model_points
    check("parity_model_maps", tuple(mp.shape) == (cfg.rows, cfg.cols, 3) and bool(torch.isfinite(mp).any()),
          f"model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    del plain
    if args.profile:
        profile_frames(torch, args, dev, card, df, prof_frames, tag="parity", focus=("coarse_band", "raycast"))

    # the renders: from the last model maps, and a fresh full march at the
    # current pose; the plain path renders the same state
    pose = df.get_pose()
    kernels.reset_launches()
    imgs = {0: df.render(0), 3: df.render(3)}
    t0 = time.perf_counter()
    imgs["pose"] = df.render(0, pose=pose)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    render_launches = dict(kernels.launches)
    ref = kinfu.DynamicFusion(cfg, device=dev, plain=True)
    st = df.state
    ref.state = st._replace(vol=TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone()))
    ref_img = ref.render(0, pose=pose)
    shapes = {0: (cfg.rows, cfg.cols, 3), 3: (cfg.rows, 2 * cfg.cols, 3), "pose": (cfg.rows, cfg.cols, 3)}
    ok = all(imgs[k].dtype == torch.uint8 and imgs[k].device.type == "cuda" and tuple(imgs[k].shape) == shapes[k]
             and float(imgs[k].float().std()) > 1.0 for k in imgs)
    far = float((imgs["pose"].int() - ref_img.int()).abs().amax(-1).gt(1).float().mean())
    check("render", ok and far <= TOL_IMAGE_FRAC and render_launches["raycast"] == 1,
          f"render(0) {tuple(imgs[0].shape)}, render(3) {tuple(imgs[3].shape)}, render(pose) "
          f"{tuple(imgs['pose'].shape)}: uint8 on the card, not constant {ok}; render(pose) against the plain "
          f"path's render of the same state: {far:.2e} of pixels more than one level apart (tol {TOL_IMAGE_FRAC}); "
          f"one march ({render_launches['raycast']}) in {render_ms:.3f} ms")
    return launches, render_launches


def fresh_main(torch, args, dev, card, nr_depths):
    """Phase 8: ``default_dynamicfusion()`` with ``reuse_model_raycast=False``
    (a fresh canonical raycast in the temporal band every frame) for three
    frames; the plain step from each of the kernel path's states."""
    import dataclasses

    from dynamicfusion_tpu_torch.config import DynamicFusionConfig

    cfg = dataclasses.replace(DynamicFusionConfig.default_dynamicfusion(), reuse_model_raycast=False)
    frames = nr_depths[:3]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    print(f"[fresh] reuse_model_raycast=False: {len(frames)} frames, raycast launches {launches['raycast']} "
          f"(two a step), frame ms {' '.join(f'{v:.3f}' for v in frame_ms)}", flush=True)
    check("fresh_launches", launches["raycast"] == 2 * (len(frames) - 1) + 1 and all(r["ok"] for r in rows)
          and all(r["c1"] <= r["c0"] for r in rows),
          f"the fresh raycast and the model raycast every step ({launches['raycast']}); ICP healthy and the solve's "
          f"cost not raised on every step")
    check_steps_vs_plain(torch, "fresh", cfg, dev, frames, states, poses_k, rows)


def dense_kernels(torch, report, dev, nr_depths):
    """Phase 2 for kernels N, O, F's point-to-point rows and the factor on
    the base config's state after three frames of the kernel path, the
    next frame tracked (3 200 solve points, 6N = 6 144)."""
    import dataclasses

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = DynamicFusionConfig()
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in nr_depths[:3]:
        df(d)
    st = df.state
    field = st.warp
    n = field.positions.shape[0]
    tr = kinfu.track(cfg, st, torch.from_numpy(nr_depths[3]).to(dev))
    s = ws.prepare(cfg, field, tr.inputs)
    npt = s.p_can.shape[0]
    ne = s.e_src.shape[0]
    dt = ws.data_term(cfg, s, field.dq, True)
    et = ws.edge_term(cfg, s, field.dq)
    check("dense_state", bool(tr.icp_res.ok), f"base config: nodes {int(field.count)} of {n}, solve points P = {npt}, "
          f"6N = {6 * n}, ICP ok on the next frame")
    lists_b = (npt * 8 + n + 1) * 4
    mat_b = (6 * n) ** 2 * 4
    # rows, neighbour ids, node lists, edge blocks, dsts and lists, diagonal
    # blocks in; the matrix out
    gram_in = npt * (96 + 64) + lists_b + ne * (144 + 8 + 4) + (n + 1) * 4 + n * 144

    # N, the int8 Gram (the base config's) and its column scales
    a = ws.dense_rows(dt.rows, s.knn_idx, n)
    ck = kernels.gram_scales(dt.rows, s.pts_by_node.order, s.pts_by_node.off)
    cp = ws.gram_scales_plain(a)
    check("gram_scales", torch.equal(ck, cp), f"{6 * n} column scales bit-equal to the plain version's")
    report["gram_scales"] = dict(
        err=abs_err(torch, ck, cp),
        ms=cuda_ms(torch, lambda: kernels.gram_scales(dt.rows, s.pts_by_node.order, s.pts_by_node.off)),
        plain_ms=cuda_ms(torch, lambda: ws.gram_scales_plain(ws.dense_rows(dt.rows, s.knn_idx, n)), reps=5),
        bound=bound_ms(npt * 96 + lists_b + 6 * n * 4, npt * 8 * 6 * 2.0),
        library_ms=cuda_ms(torch, lambda: torch.abs(a).amax(0)),
    )
    gk = ws.dense_gram(cfg, s, dt, et)
    gp = ws.dense_gram(cfg, s, dt, et, plain=True)
    same = torch.equal(gk, gp)
    check("dense_gram", same, f"({6 * n})^2 int8 Gram plus the edge blocks, {npt} x 1 rows: bit-equal to the plain "
          f"version {same} (max |diff| {abs_err(torch, gk, gp):.3e})")
    q = torch.clamp(torch.round(a / cp), -127.0, 127.0).to(torch.int8)
    qt = q.T.contiguous()
    products = npt * 8 * 288 * dt.rows.shape[1]  # each entry's (k, a, b) products over its rows
    report["dense_gram"] = dict(
        err=abs_err(torch, gk, gp),
        ms=cuda_ms(torch, lambda: ws.dense_gram(cfg, s, dt, et), reps=10),
        plain_ms=cuda_ms(torch, lambda: ws.dense_gram(cfg, s, dt, et, plain=True), reps=3),
        bound=bound_ms(gram_in + mat_b, 2.0 * products, PEAK_INT8),
        # JAX's syrk itself on the expanded int8 rows (the scales and the
        # edge blocks not included)
        library_ms=cuda_ms(torch, lambda: torch._int_mm(qt, qt.T), reps=10),
    )
    del q, qt
    cfg16 = dataclasses.replace(cfg, solver_jtj_int8=False)
    bk = ws.dense_gram(cfg16, s, dt, et)
    bp = ws.dense_gram(cfg16, s, dt, et, plain=True)
    err = rel_err(torch, bk, bp)
    check("dense_gram_bf16", err <= TOL_GRAM_BF16_REL,
          f"({6 * n})^2 bf16 Gram plus the edge blocks: max relative diff {err:.2e} (tol {TOL_GRAM_BF16_REL})")
    ab = a.to(torch.bfloat16)
    report["dense_gram_bf16"] = dict(
        err=abs_err(torch, bk, bp),
        ms=cuda_ms(torch, lambda: ws.dense_gram(cfg16, s, dt, et), reps=10),
        plain_ms=cuda_ms(torch, lambda: ws.dense_gram(cfg16, s, dt, et, plain=True), reps=3),
        bound=bound_ms(gram_in + mat_b, 2.0 * products, PEAK_BF16),
        library_ms=cuda_ms(torch, lambda: torch.matmul(ab.T, ab), reps=10),
    )
    del bk, bp, ab, a

    # O, the damping at the solve's first lambda
    lam = torch.full((), cfg.solver_lm_lambda_init, device=dev)
    floor = cfg.solver_damping_floor
    ok_ = ws.dense_damp(gk, lam, field.active, floor)
    op_ = ws.dense_damp(gk, lam, field.active, floor, plain=True)
    off = ~torch.eye(6 * n, dtype=torch.bool, device=dev)
    off_same = torch.equal(ok_[off], op_[off])
    err = rel_err(torch, ok_.diagonal(), op_.diagonal())
    del off
    check("dense_damp", off_same and err <= TOL_DAMP_REL,
          f"({6 * n})^2 damped: off the diagonal bit-equal {off_same}; diagonal max relative diff {err:.2e} "
          f"(tol {TOL_DAMP_REL})")
    report["dense_damp"] = dict(
        err=abs_err(torch, ok_, op_),
        ms=cuda_ms(torch, lambda: ws.dense_damp(gk, lam, field.active, floor)),
        plain_ms=cuda_ms(torch, lambda: ws.dense_damp(gk, lam, field.active, floor, plain=True)),
        bound=bound_ms(2 * mat_b + n + 4, 6 * n * 6.0),
        library_ms=None,
    )
    del op_

    # the factor: cuSOLVER through cholesky_ex, NaN where not positive definite
    chol = ws.cholesky(ok_)
    info = int(torch.linalg.cholesky_ex(ok_, check_errors=False)[1])
    same = torch.equal(torch.nan_to_num(chol, nan=7.0), torch.nan_to_num(ws.cholesky(ok_, plain=True), nan=7.0))
    bad = ok_.clone()
    bad[5, 5] = -1.0
    nan_bad = not bool(torch.isfinite(ws.cholesky(bad)).any())
    del bad
    step = ws.chol_step(chol, dt.jtr + et.jtr)
    check("cholesky", same and nan_bad and (info != 0 or bool(torch.isfinite(step).all())),
          f"6N = {6 * n}: info {info}; the wrapper's factor equals the plain call's {same}; a matrix that is not "
          f"positive definite gives an all-NaN factor {nan_bad}; the step finite where info is 0")
    dof = 6 * n
    report["cholesky"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: ws.cholesky(ok_), reps=10),
        plain_ms=cuda_ms(torch, lambda: ws.cholesky(ok_, plain=True), reps=10),
        # n^3 / 3 float32 operations (cuSOLVER's potrf, no tensor cores)
        bound=bound_ms(2 * mat_b, dof ** 3 / 3.0),
        library_ms=cuda_ms(torch, lambda: torch.linalg.cholesky_ex(ok_, check_errors=False), reps=10),
        solve_ms=cuda_ms(torch, lambda: ws.chol_step(chol, dt.jtr + et.jtr), reps=10),
        info=info,
    )
    print(f"[info] the factor at 6N = {dof}: {report['cholesky']['ms']:.3f} ms, info {info}; its solve "
          f"{report['cholesky']['solve_ms']:.3f} ms", flush=True)
    del ok_, chol
    dense_pcg_kernel(torch, report, dev, cfg, field, gk, dt.jtr + et.jtr)
    del gk, gp

    # F with the point-to-point rows (point_to_plane=False)
    cfg_p = dataclasses.replace(cfg, point_to_plane=False)
    sp = ws.prepare(cfg_p, field, tr.inputs)
    dk = ws.data_term(cfg_p, sp, field.dq, True)
    dp = ws.data_term(cfg_p, sp, field.dq, True, plain=True)
    errs = [rel_err(torch, dk.jtr, dp.jtr), rel_err(torch, dk.blocks, dp.blocks), rel_err(torch, dk.cost, dp.cost)]
    check("data_term_p2p", max(errs) <= TOL_DATA_REL and tuple(dk.rows.shape) == (npt, 3, 8, 6),
          f"{npt} points x 3 point-to-point rows: relative diff Jᵀr {errs[0]:.2e}, blocks {errs[1]:.2e}, cost "
          f"{errs[2]:.2e} (tol {TOL_DATA_REL}); rows {tuple(dk.rows.shape)}")
    report["data_term_p2p"] = dict(
        err=max(abs_err(torch, dk.jtr, dp.jtr), abs_err(torch, dk.blocks, dp.blocks)),
        ms=cuda_ms(torch, lambda: ws.data_term(cfg_p, sp, field.dq, True)),
        plain_ms=cuda_ms(torch, lambda: ws.data_term(cfg_p, sp, field.dq, True, plain=True), reps=3),
        # as the tangential rows' without the basis and weight
        bound=bound_ms(npt * (36 + 1 + 64 + 32) + n * 32 + lists_b + npt * 3 * 96 + n * 144 + n * 24 + 4,
                       npt * 3 * 1500.0 + npt * 8 * 3 * 48.0),
        library_ms=None,
    )
    del df


def dense_pcg_iterations(torch, ws, a, minv, b, iters, rtol) -> int:
    """The iterations the plain dense-matrix PCG runs on this system before
    rᵀr <= rtol² bᵀb (the work this run's data needs)."""
    r = b
    z = ws._apply_m(minv, r)
    p = z
    rz = torch.dot(r, z)
    stop2 = rtol * rtol * float(torch.dot(b, b))
    for it in range(iters):
        if not float(torch.dot(r, r)) > stop2:
            return it
        ap = a @ p
        r = r - rz / torch.clamp(torch.dot(p, ap), min=1e-30) * ap
        z = ws._apply_m(minv, r)
        rz_n = torch.dot(r, z)
        p = z + rz_n / torch.clamp(rz, min=1e-30) * p
        rz = rz_n
    return iters


def dense_pcg_kernel(torch, report, dev, cfg, field, jtj, b):
    """Phase 2 for kernel P (the PCG of solver_linear="pcg" with the
    unlagged JᵀJ) on the base config's dense system: damped with the
    solve's first lambda, or the first lambda after rejected steps (x8
    each) on which the plain PCG's solution is finite; held against the
    plain PCG within its own spread under a one-ulp move of every matrix
    entry."""
    import dataclasses

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    pcfg = dataclasses.replace(cfg, solver_linear="pcg", solver_lagged_jtj=False)
    iters, rtol = pcfg.solver_linear_iters, pcfg.solver_linear_tol
    on = torch.ones((), dtype=torch.bool, device=dev)
    lam = pcfg.solver_lm_lambda_init
    for tries in range(8):
        a = ws.dense_damp(jtj, torch.full((), lam, device=dev), field.active, pcfg.solver_damping_floor)
        minv = ws.spd6_inv(ws.diag_blocks(a))
        xp = ws.dense_pcg_plain(a, minv, b, iters, rtol, on)
        xk = kernels.dense_pcg(a, minv, b, iters, rtol, on)
        if tries == 0:
            print(f"[info] kernel P at the first lambda {lam:.1e}: non-finite entries kernel "
                  f"{int((~torch.isfinite(xk)).sum())}, plain {int((~torch.isfinite(xp)).sum())} of {b.shape[0]}",
                  flush=True)
        if bool(torch.isfinite(xp).all()):
            break
        lam *= 8.0
    spread = max(rel_err(torch, ws.dense_pcg_plain(a1, minv, b, iters, rtol, on), xp) for a1 in ulp_moves(torch, a))
    finite = bool(torch.isfinite(xk).all())
    err = rel_err(torch, xk, xp) if finite else float("inf")
    tol = max(TOL_DENSE_PCG_FLOOR, SPREAD_PCG * spread)
    again = torch.equal(xk, kernels.dense_pcg(a, minv, b, iters, rtol, on))
    off = not bool(kernels.dense_pcg(a, minv, b, iters, rtol, ~on).any())
    ran = dense_pcg_iterations(torch, ws, a, minv, b, iters, rtol)
    check("dense_pcg", finite and err <= tol and again and off,
          f"6N = {b.shape[0]}, lambda {lam:.1e}, {ran} of {iters} iterations: finite {finite}, max relative diff "
          f"{err:.2e} (tol max({TOL_DENSE_PCG_FLOOR}, {SPREAD_PCG} x the plain PCG's one-ulp spread {spread:.2e})); "
          f"the same bits run again {again}; inactive -> 0 {off}")
    dof = b.shape[0]
    pv = xp.contiguous()
    report["dense_pcg"] = dict(
        err=abs_err(torch, xk, xp),
        ms=cuda_ms(torch, lambda: kernels.dense_pcg(a, minv, b, iters, rtol, on), reps=10),
        plain_ms=cuda_ms(torch, lambda: ws.dense_pcg_plain(a, minv, b, iters, rtol, on), reps=3),
        # the matrix, the preconditioner and b read once, x written (the
        # matrix does not fit in L2: each iteration reads it again, 151 MB
        # at 6N = 6 144); 2 (6N)^2 operations an iteration
        bound=bound_ms(dof * dof * 4 + dof * 6 * 4 + dof * 8, ran * 2.0 * dof * dof),
        # one GEMV of the damped matrix, as one iteration's matvec
        library_ms=cuda_ms(torch, lambda: torch.mv(a, pv), reps=10),
        iterations=ran,
        iteration_ms=None,
    )
    report["dense_pcg"]["iteration_ms"] = report["dense_pcg"]["ms"] / max(ran, 1)
    print(f"[info] kernel P: {report['dense_pcg']['ms']:.4f} ms a solve of {ran} iterations "
          f"({report['dense_pcg']['iteration_ms']:.4f} ms an iteration, one torch.mv "
          f"{report['dense_pcg']['library_ms']:.4f} ms, the matrix read {dof * dof * 4 / 3.35e9:.4f} ms at 3.35 TB/s)",
          flush=True)


def base_main(torch, args, dev, card, nr_depths):
    """Phase 9: the base ``DynamicFusionConfig()`` non-rigid (the direct
    solve: kernels N and O, cuSOLVER's factor, the lagged JᵀJ with one
    factor reused; secant refine, fusion every 2nd frame without the
    incidence weight, no temporal band) over ``bench.py``'s deforming
    scene: the preset's checks, the plain step from each state, a profile
    of 3 more frames. Returns (launches, the states after each frame)."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig

    cfg = DynamicFusionConfig()
    frames = nr_depths[: args.d_frames]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    check_nonrigid_run("base", card, cfg, frames, launches, rows, frame_ms, poses_k)
    steps = len(frames) - 1
    check("base_dense_launches", launches["cholesky"] == steps * cfg.solver_nonlinear_iters
          and launches["dense_gram"] == steps and launches["dense_damp"] == launches["cholesky"],
          f"one Gram a step ({launches['dense_gram']}), a damping and a factor every LM iteration "
          f"({launches['dense_damp']}, {launches['cholesky']}) in {steps} steps")
    check_steps_vs_plain(torch, "base", cfg, dev, frames, states, poses_k, rows)
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("base_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"warped model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    prof = profile_frames(torch, args, dev, card, df, nr_depths[args.d_frames: args.d_frames + 3], tag="base",
                          focus=("dense_gram", "damp_", "potrf", "trsm", "trsv"))
    per = {k: launches[k] / steps for k in ("gram_scales", "dense_gram", "dense_damp", "cholesky")}
    steady = sorted(frame_ms[2:])
    print(f"[base] {card} | frame ms median {steady[len(steady) // 2]:.3f}; device busy "
          f"{prof['busy_ms'] / prof['wall_ms']:.3f}, idle {1.0 - prof['busy_ms'] / prof['wall_ms']:.3f} of 3 profiled "
          f"frames; {prof['launches'] / 3:.0f} kernel launches a frame; a step: N {per['dense_gram']:.1f} "
          f"(+ {per['gram_scales']:.1f} scale passes), O {per['dense_damp']:.1f}, factor {per['cholesky']:.1f}",
          flush=True)
    del df
    return launches, states


def variants_main(torch, args, dev, card, nr_depths, base_states):
    """Phase 10: the base config's dense variants (the bf16 Gram, the
    unlagged JᵀJ, the point-to-point term, and the PCG over the dense
    matrix with the unlagged JᵀJ: kernel P), three steps each from the base
    config's state after frame 3, each step held against the plain step
    from the same state. Returns each variant's launches."""
    import dataclasses

    from dynamicfusion_tpu_torch.config import DynamicFusionConfig

    out = {}
    for name, changes in VARIANTS:
        cfg = dataclasses.replace(DynamicFusionConfig(), **changes)
        # the direct variants factor; the dense-matrix PCG runs kernel P instead
        must = ("dense_gram", "dense_pcg") if cfg.solver_linear == "pcg" else ("dense_gram", "cholesky")
        out[name] = hold_variant(torch, name, cfg, dev, nr_depths[4:7], base_states[3], must)
    return out


def hold_variant(torch, name, cfg, dev, frames, state, must):
    """Three (``len(frames)``) kernel-path steps of a variant from
    ``state``, each held against the plain step from the same state (pose
    TOL_STEP_POSE, initial cost TOL_STEP_COST0_REL relative, ICP health
    and node counts equal, the cost not raised); the kernels ``must`` have
    launched. Returns the steps' launches."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.pipeline import kinfu

    st = clone_state(state)
    kernels.reset_launches()
    t_err, c_err, same, ms = [], [], True, []
    for d in frames:
        depth = torch.from_numpy(d).to(dev)
        before = clone_state(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, o = kinfu.step(cfg, st, depth)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        _, op = kinfu.step(cfg, before, depth, plain=True)
        pk, pp = o.pose.cpu().numpy(), op.pose.cpu().numpy()
        t_err.append(max(float(np.abs(pk[:3, 3] - pp[:3, 3]).max()), float(np.abs(pk[:3, :3] - pp[:3, :3]).max())))
        c_err.append(abs(float(op.solver_cost0) - float(o.solver_cost0)) / float(o.solver_cost0))
        same = same and bool(o.icp_ok) == bool(op.icp_ok) and bool(o.icp_ok) and int(o.node_count) == int(
            op.node_count) and float(o.solver_cost1) <= float(o.solver_cost0)
    out = dict(kernels.launches)
    print(f"[variant] {name}: {len(frames)} steps, ms {' '.join(f'{v:.3f}' for v in ms)}; launches "
          f"{ {k: out[k] for k in must + ('data_term', 'pcg') if out[k]} }", flush=True)
    check(f"variant_{name}_step_vs_plain",
          same and max(t_err) <= TOL_STEP_POSE and max(c_err) <= TOL_STEP_COST0_REL and all(out[k] > 0 for k in must),
          f"ICP healthy, node counts equal, cost not raised {same}; plain step pose diff "
          f"{' '.join(f'{v:.2e}' for v in t_err)} (tol {TOL_STEP_POSE}), initial cost relative "
          f"{' '.join(f'{v:.2e}' for v in c_err)} (tol {TOL_STEP_COST0_REL}); {', '.join(must)} launched")
    return out


def options_main(torch, args, dev, card):
    """Phase 11: the options cell, ``quality_dynamicfusion()`` with the
    aperture gate, the tangential rows of every 4th point in the PCG
    matrix, the adaptive node radius and the net rigid removal at alpha
    0.5 (``OPTIONS``), over O frames of the hinge scene: the quality
    cell's checks, kernel L and E's radius entry in frame 0, and M, Q and
    E's radius (at insertion) once a step; the plain step from each state;
    then three steps with ``solver_p2p_lag_hessian`` (the plane rows only
    in the PCG matrix) from the state after frame 3. Returns (the cell's
    launches, the lagged steps' launches)."""
    import dataclasses

    from dynamicfusion_tpu_torch.io import synthetic

    cfg = options_config()
    n_prof = 3 if args.profile else 0
    frames = synthetic.hinge_frames(cfg.intr, cfg.rows, cfg.cols, args.o_frames + n_prof)
    frames, prof_frames = frames[: args.o_frames], frames[args.o_frames:]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    check_nonrigid_run("options", card, cfg, frames, launches, rows, frame_ms, poses_k)
    steps = len(frames) - 1
    check("options_per_step", launches["node_radius"] == 1 + steps and launches["net_rigid"] == steps
          and launches["p2p_gate"] == steps,
          f"E's radius once in frame 0 and once a step ({launches['node_radius']}), Q once a step "
          f"({launches['net_rigid']}), M once a step ({launches['p2p_gate']}) in {steps} steps")
    w = df.state.warp
    radius = w.radius[w.active]
    inside = float(((radius > cfg.node_radius_min) & (radius < cfg.node_radius_max)).float().mean())
    check("options_radius", inside > 0.0,
          f"{int(w.count)} nodes, radius min {float(radius.min()):.4f} median {float(radius.median()):.4f} max "
          f"{float(radius.max()):.4f} m; {inside:.3f} inside the clip [{cfg.node_radius_min}, {cfg.node_radius_max}]")
    check_steps_vs_plain(torch, "options", cfg, dev, frames, states, poses_k, rows)
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("options_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"warped model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    if args.profile:
        profile_frames(torch, args, dev, card, df, prof_frames, tag="options", focus=("net_rigid", "node_radius"))
    del df
    lag = hold_variant(torch, "options_lag", dataclasses.replace(cfg, solver_p2p_lag_hessian=True), dev, frames[4:7],
                       states[3], ("pcg", "net_rigid", "node_radius"))
    del states
    return launches, lag


def parity_nonrigid_main(torch, args, dev, card, nr_depths, report):
    """Phase 11: ``reference_parity()`` non-rigid (maps at 640x480, 12 800
    solve points after the stride, node radius 3, Tukey c 0.01, ARAP 200,
    fusion every frame) over 5 frames of the deforming scene. Known
    unstable as a running configuration (the JAX package's config.py), so
    only the plain step from each kernel-path state is checked; printed a
    frame: P, the factor's time and whether it succeeded (info). Kernel
    H is held at this path's 19 200 insertion candidates (its sort keys in
    device memory). Returns the path's launches."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = DynamicFusionConfig.reference_parity()
    frames = nr_depths[: args.r_frames]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    del df

    # H: the first step's candidates into the frame-0 field, past the
    # 16 384 whose sort keys fit in shared memory
    tr = kinfu.track(cfg, states[0], torch.from_numpy(frames[1]).to(dev))
    cand = tr.inputs.p_can[:: cfg.node_insert_stride].contiguous()
    valid = ~torch.isnan(cand[:, 0])
    n = states[0].warp.positions.shape[0]
    nc = cand.shape[0]
    hfield, exact, _ = hold_insert(torch, "insert_nodes_full_res", cfg, states[0].warp, cand, valid,
                                   states[0].frame_idx, min_candidates=16385)
    cd2, _ = warpfield.mutual_nearest(hfield, cand, valid)
    gate = hfield.count < n
    np2 = 1 << (nc - 1).bit_length()
    sort_ops = 2 * (np2 // 2) * int(math.log2(np2)) * (int(math.log2(np2)) + 1) // 2
    report["insert_select_full_res"] = dict(
        err=0.0 if exact else 1.0,
        ms=cuda_ms(torch, lambda: kernels.insert_select(cand, cd2, valid, hfield.active, hfield.count, gate,
                                                        cfg.node_coverage)),
        plain_ms=cuda_ms(torch, lambda: warpfield._insert_select_plain(cfg, hfield, cand, valid, cd2, gate), reps=5),
        bound=bound_ms(nc * 17 + n + 5 + n * 20, float(sort_ops + nc * 12)),
        library_ms=None,
    )
    del tr
    for i, r in enumerate(rows, start=1):
        tr = kinfu.track(cfg, states[i - 1], torch.from_numpy(frames[i]).to(dev))
        s = ws.prepare(cfg, states[i - 1].warp, tr.inputs)
        dt = ws.data_term(cfg, s, states[i - 1].warp.dq, True)
        et = ws.edge_term(cfg, s, states[i - 1].warp.dq)
        damped = ws.dense_damp(ws.dense_gram(cfg, s, dt, et), torch.full((), cfg.solver_lm_lambda_init, device=dev),
                               states[i - 1].warp.active, cfg.solver_damping_floor)
        f_ms = cuda_ms(torch, lambda: torch.linalg.cholesky_ex(damped, check_errors=False), reps=3, warmup=1)
        info = int(torch.linalg.cholesky_ex(damped, check_errors=False)[1])
        print(f"[parity-nr] frame {i}: icp_ok {r['ok']}, P = {s.p_can.shape[0]}, solver_cost0 {r['c0']:.6e}, "
              f"solver_cost1 {r['c1']:.6e}, nodes {r['nodes']}, factor {f_ms:.3f} ms at the first lambda, info {info}, "
              f"frame {frame_ms[i]:.3f} ms", flush=True)
        del damped
    check("parity_nr_launches", all(launches[k] > 0 for k in DENSE_KERNELS) and launches["coarse_band"] > 0,
          f"N, O, the factor and the coarse band launched: {launches}")
    check_steps_vs_plain(torch, "parity_nr", cfg, dev, frames, states, poses_k, rows)
    return launches


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


def profile_frames(torch, args, dev, card, df, depths, tag="nonrigid", focus=()):
    """3 frames under torch.profiler: the table, the trace, the device's
    busy time over the frames' wall time, the device time of the busiest
    kernels and of those whose names hold a ``focus`` string (files named
    by ``tag``)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    out = Path(args.profile or "build/profile")
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in depths:
            df(d, block=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    (out / f"{tag}_profile.txt").write_text(f"{card}\n{table}\n")
    prof.export_chrome_trace(str(out / f"{tag}_trace.json"))
    events = json.loads((out / f"{tag}_trace.json").read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    launches = sum(1 for e in events if e.get("name") in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    syncs = sum(1 for e in events if "Synchronize" in str(e.get("name", "")))
    print(f"[profile] {card} | {len(depths)} {tag} frames: wall {wall_ms:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1.0 - busy / 1e3 / wall_ms:.3f}; {len(spans)} device ops, {launches} kernel launches, "
          f"{syncs} synchronize calls -> {out}/{tag}_profile.txt", flush=True)
    result = dict(wall_ms=wall_ms, busy_ms=busy / 1e3, launches=launches)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            n, us = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, us + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    top += [kv for kv in by_name.items() if any(f in kv[0] for f in focus) and kv not in top]
    for name, (n, us) in top:
        print(f"[profile] {tag}: {name[:90]}: {us / 1e3:.3f} ms in {n} launches, {us / busy:.3f} of device busy")
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=15, help="frames of the rigid slice")
    ap.add_argument("--nr-frames", type=int, default=20, help="frames of the dynamicfusion preset")
    ap.add_argument("--q-frames", type=int, default=20, help="frames of the quality preset (the hinge scene)")
    ap.add_argument("--a-frames", type=int, default=20,
                    help="hinge frames of the quality preset with the aperture gate")
    ap.add_argument("--p-frames", type=int, default=15, help="frames of reference_parity() rigid at 640x480")
    ap.add_argument("--d-frames", type=int, default=20, help="frames of the base DynamicFusionConfig() non-rigid")
    ap.add_argument("--r-frames", type=int, default=5, help="frames of reference_parity() non-rigid")
    ap.add_argument("--o-frames", type=int, default=20, help="hinge frames of the options cell")
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler tables of 3 frames of each non-rigid preset and of the reference-"
                         "resolution rigid path here")
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
    # the deforming scene's frames, and 3 more after the longest run for the profiles
    n_depths = max(args.nr_frames, args.d_frames, args.r_frames, 7) + 3
    nr_depths = synthetic.deforming_frames(nr.intr, nr.rows, nr.cols, n_depths)
    report = {}
    rigid_kernels(torch, args, report, dev, card)
    nonrigid_kernels(torch, args, report, dev, nr_depths)
    extract_kernels(torch, report, dev, nr_depths)
    dense_kernels(torch, report, dev, nr_depths)
    print(f"[phase] kernels checked at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 3. the rigid main path ----------------
    rigid_launches = rigid_main(torch, args, dev, card)
    print(f"[phase] rigid path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 4. the non-rigid main path ----------------
    nr_launches, df = nonrigid_main(torch, args, dev, card, nr_depths)
    print(f"[phase] non-rigid path done at {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.profile:
        profile_frames(torch, args, dev, card, df, nr_depths[args.nr_frames: args.nr_frames + 3])
    del df

    # ---------------- 5. the quality preset ----------------
    q_launches = quality_main(torch, args, dev, card)
    print(f"[phase] quality path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 6. the quality preset with the aperture gate ----------------
    a_launches = adaptive_main(torch, args, dev, card)
    print(f"[phase] adaptive-gate path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 7. reference_parity() rigid at 640x480, the renders ----------------
    p_launches, r_launches = parity_main(torch, args, dev, card)
    print(f"[phase] reference-resolution rigid path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 8. the fresh canonical raycast ----------------
    fresh_main(torch, args, dev, card, nr_depths)
    print(f"[phase] fresh-raycast steps done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 9. the base config: the direct solve ----------------
    base_launches, base_states = base_main(torch, args, dev, card, nr_depths)
    print(f"[phase] base-config path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 10. its dense variants ----------------
    v_launches = variants_main(torch, args, dev, card, nr_depths, base_states)
    del base_states
    print(f"[phase] dense variants done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 11. the options cell ----------------
    o_launches, lag_launches = options_main(torch, args, dev, card)
    print(f"[phase] options cell done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 12. reference_parity() non-rigid ----------------
    pnr_launches = parity_nonrigid_main(torch, args, dev, card, nr_depths, report)
    print(f"[phase] reference-parity non-rigid steps done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 13. report ----------------
    runs = {"rigid": rigid_launches, "nonrigid": nr_launches, "frame0": nr_launches, "quality": q_launches,
            "adaptive": a_launches, "parity_rigid": p_launches, "render": r_launches, "base": base_launches,
            "base_bf16": v_launches["bf16"], "base_p2p": v_launches["p2p"], "parity_nr": pnr_launches,
            "options": o_launches, "options_lag": lag_launches, "base_pcg": v_launches["pcg_unlagged"]}
    rows_out = []
    for name, (src, rep) in ROWS.items():
        r = report[name]
        path = PATH.get(name, "nonrigid")
        n_launch = runs[path][COUNTER.get(name, name)]
        rows_out.append(dict(
            name=name, route="cuda", source=src if "/" in src else f"dynamicfusion_tpu_torch/csrc/{src}", replaces=rep,
            launches=n_launch, max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"], path=path,
        ))
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[kernel] {card} | {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}), library {lib}, launches {n_launch} ({path} path)"
              + (f", {r['iterations']} iterations" if "iterations" in r else ""))
    print(f"[phase] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"{card}")
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
