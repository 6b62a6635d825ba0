#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dynamicfusion_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames N] [--nr-frames M] [--q-frames Q] [--a-frames A] [--p-frames P]
                          [--d-frames D] [--r-frames R] [--o-frames O] [--dn-frames E] [--demo-frames F]
                          [--s-frames S] [--f-frames F] [--k-frames K] [--profile DIR] [--dump-solve FILE]

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
   branch, kernel I (dists, the depth pyramid to 80x60 in one launch,
   every level bit-equal to the plain version, its one-level-a-launch
   reference mode and its library route on the preset's frame, a 481x641
   frame and ``pyramid_frame``'s threshold edges; point/normal maps
   with the incidence confidence, the 2x2 map resize), kernel J (the
   160x120 march band and seed from 16x8 shared-memory tiles, bit-equal
   to plain and to its reference mode on the preset's state, a map that
   misses, zero dists and raycast strides 1, 2 and 4) and kernel K (the 11-level mip, 4 096 brick classes
   and the work list, which must equal the plain version's bit for bit);
   kernels F and G with the tangential rows of ``quality_dynamicfusion()``
   (three residual rows a point) on the same state; kernel L (frame 0's
   extraction into 1 << 20 rows and node sampling into 1 024 slots) on the
   preset's frame-0 volume, bit-equal to its plain version, the
   extraction (a warp a voxel row, two device kernels a call) also to its
   reference mode (four), and to its library route (``library_extract``),
   uncapped, cut inside one block's run (``extract_block_cut``) and at 700
   rows, and timed beside them (``hold_extract``; also at every storage in
   phase 20 and at 512^3 in phase 23); kernel A (the tiled filter) bit
   for bit against its reference mode on the rigid slice's noisy frame
   and on ``border_frame`` (``hold_bilateral``), timed beside it and its
   library route (``library_bilateral``); kernel M (the
   aperture gate of ``solver_p2p_adaptive``) on the phase-2 state at
   160x120, gate and depth bins bit-equal to its plain version and to its
   reference mode (``hold_gate``), some pixels open part way (the closed
   form exercised), and the same on the numpy-made ``GATE_CASES``, with
   the library route (``library_p2p_gate``: ``avg_pool2d`` box sums)
   within TOL_GATE_LIBRARY, each timed; and at the
   reference resolution of ``reference_parity()`` on the phase-2 volume:
   kernel C's 160x120 coarse march, kernel J's coarse band (640x480,
   bit-equal), C at 640x480 in that band and as ``render(pose)``'s full
   march, kernel B at 640x480; and on the base ``DynamicFusionConfig()``'s
   state after three frames (3 200 solve points, 6N = 6 144): kernel N's
   column scales and int8 Gram (bit-equal), its bf16 Gram (within 1e-6,
   the same on a second call), each timed beside its PyTorch route (the
   expansion, quantization, product, scale product and edge blocks in
   PyTorch calls), and N at 2048 nodes on seeded skewed rows (every mode
   held), kernel O,
   cuSOLVER's factor (an all-NaN factor where the matrix is not positive
   definite), kernel F's point-to-point rows and kernel P (the PCG over
   the damped dense matrix, within four times the plain PCG's own spread
   under a one-ulp move of the matrix); and for the options, on the
   preset's phase-2 state: kernel E's adaptive radius at frame 0's 1024
   nodes and at the insertion shape (bit-equal), kernel Q on a real
   pre/post-solve pair and on a field with two active nodes (left as it
   is), kernels F and G with the tangential rows of every 2nd and 4th
   point and with the plane rows only; kernel C's refine codes 2
   (newton16) and 3 (hybrid16) and its six-sample normal on every refine,
   at the preset's 160x120 maps and at 640x480, the hit mask exact; and
   kernels F1 and F2 (the dense fusion) at 256^3 on the preset's phase-2
   state and the next frame, F2 with the incidence confidence and the
   phase split, codes within 1 LSB and weights equal, F1's tiled design
   bit-equal to its reference mode there and at ``dense_poses`` (turned
   away, the volume's centre in the image plane, a border cutting it;
   ``hold_dense_reference``) and timed beside it, then each against
   the brick path (K + D) on the same frame and volume (printed); every
   hold of kernel G's cluster PCG (``hold_pcg``: one row, three rows, the
   row modes, and at 2048 seeded skewed nodes with one and three rows)
   is within max(TOL_PCG_REL, SPREAD_PCG x the plain PCG's own one-ulp
   spread) of the plain PCG, and also needs the same bits on a second
   launch, p in device memory bit-equal to p in shared memory, inactive as
   x = 0, and the library route (``library_pcg_factored``: cuSPARSE CSR
   products) within the hold's tolerance; it prints the cluster, one
   iteration's time and how far a PCG with bf16 vectors lands (a control
   the tolerance must tell apart); kernel F in every mode (and at 2048
   seeded skewed nodes) bit for bit against its order
   (``hold_data_order``: Jᵀr and blocks against
   ``warp_solver.data_sums_ordered`` of the kernel's own Jacobian, the
   cost against ``sum_ordered``, the bf16 rows against ``bf16_rows``);
   kernel E at the coarse corners, the solve points, the nodes (k = 5)
   and the demo's mesh (``knn_row``): against its plain version, bit for
   bit against the one-thread-a-query kernel (``lanes=0``), its library
   route (``library_knn``) held to its neighbour lists; E's rows count the
   launches of their kind of call (``kernels.knn_kinds``); kernel H's
   select (``hold_select``) with its table in shared and in device memory,
   slots and new positions bit-equal to the plain select at 4 800 and
   19 200 candidates and on the adversarial ``INSERT_CASES`` (also at
   65 536 candidates), k printed; kernel B (``hold_icp``) at each shape
   bit for bit against its two-pass mode, inactive as zeros, the ticket
   back at zero, within TOL_ICP_REL of plain, beside ``library_icp``;
   kernel G's edge term (``hold_edge_order``, also on the base config's
   state in phase 9 and on the sharded solves' edge terms in phases 17
   and 18) bit for bit against its three-launch mode in all six outputs;
   kernel E's mutual-nearest pass (``hold_mutual``, also at phase 12's
   19 200 candidates) bit for bit against the plain version and its
   three-launch mode at 4 800 candidates and on the adversarial
   ``MUTUAL_CASES``, beside ``library_mutual_nearest``; in every hold each
   one device kernel a call, three in its three-launch mode, as its C
   entry reports them (``kernels.device_kernels``), and one a call on
   every non-rigid run of the main path; kernel D's launch on a frame that
   does not fuse (ok false) timed; kernel K's cluster (``hold_plan``) bit
   for bit against its plain version and its one-block mode, two device
   kernels a call in each, on the preset's grid and the numpy-made
   ``PLAN_CASES`` (the capped lists, the phase split, 32^3 bricks,
   ``small()``), and on 4 slabs in phase 17 and at 32^3 in phase 23, each
   also gated (ok false: count 0, counts 0); the gated frame's integrate
   leaves the volume as it is; kernel D's persistent grid
   (``hold_fuse``) bit for bit against its reference mode (a block a
   slot), rigid and non-rigid here, on 4 slabs in phase 17, at the five
   float storages rigid, non-rigid and on 4 slabs in phase 20 and at
   512^3 in phase 23, each gated too, each mode timed fusing and gated;
   kernel G's damped block inverse (``hold_spd6``: one launch of the LM
   iteration's damping, inverse and keep rule) bit for bit, NaNs alike,
   against the composition it replaced (two damping kernels,
   ``diag_embed`` and the add, the reference mode, ``where``) with rebuild
   true and false, one device kernel a call, on the preset's damped blocks
   at five lambdas, on random SPD blocks (and within TOL_SPD6_REL of
   plain there) and on the sharded solve's psum'd blocks (phase 17), its
   undamped entry against the reference mode on the base config's dense
   diagonal blocks (``hold_spd6_undamped``); kernel I's multi-map entry
   (``hold_maps``) bit for bit against the single-map kernel at every task
   of the preset's frame, every map of its shapes and every output alone,
   one launch a call, then on the last frame of every run (phases 3-23,
   ``hold_step_maps``) and on the depth-variant ICP's pyramids (phase 15),
   and one launch a step on every run;
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
   version and its reference mode on every step's inputs (some pixels
   open part way); the mean gate over the spheres and over the plane
   printed; then 8 frames of ``bench.py``'s bulge scene (a bump travelling
   over a plane): M held on every step's inputs, the rest printed only;
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
13. the reference-shaped rigid cell: ``reference_parity()`` with
   ``rigid_only``, ``integrate_mode="dense"`` and
   ``raycast_smooth_normals`` over P orbit frames (kernel F1 every frame,
   C's six-sample normal in the coarse and the banded march): the checks
   and renders of phase 7, 3 more frames profiled, and F1's tiled design
   bit-equal to its reference mode on the run's last state and its next
   frame at ``dense_poses``;
14. the dense non-rigid cell: ``default_dynamicfusion()`` with
   ``integrate_mode="dense"`` and ``raycast_refine="newton16"`` over E
   deforming-scene frames (F1 in frame 0, F2 every step, C's code 2): the
   checks of phase 4 (fusion read from the volume), the plain step from
   each state, 3 more frames profiled; then three steps each of hybrid16
   and of the six-sample normal on newton8, newton16 and hybrid16 from its
   state after frame 3, each held against the plain step;
15. the depth-variant ICP (``estimate_transform_depth``, frame to frame)
   at ``rigid_slice()``'s 640x480 on two orbit frames, the camera moved by
   (4, -3, 5) mm: kernels I and B launched, the pose against the plain
   path on the same pyramids (1e-4 m, rotation 1e-5) and against the
   motion (2e-3 m); I and B timed at its level-0 shapes;
16. ``apps/demo_torch.py``'s ``main`` in this process on ``synthetic:F``
   (F = 10) under ``default_dynamicfusion()`` into a temporary directory,
   counters reset just before and read just after (every kernel of the
   preset's path, R once); then kernel R on the final cloud's 1 << 20
   rows, bit-equal to its plain version; kernel E's ``warp_points`` at the
   canonical mesh's vertex count (neighbour lists by the near-tie rule);
   the checkpoint into a fresh ``DynamicFusion``, every leaf bit-equal,
   and one more step from it and from the live state with equal poses and
   volumes; the PLYs' vertex and face counts; the host times of the mesh
   extraction, the writers and the checkpoint printed;
17. ``default_dynamicfusion()`` over ``parallel.sharded.make_mesh(4)`` on
   the one card (64-plane slabs: kernel C's slab mode, K's and D's, the
   distributed PCG of G's data-only matvec and step with P's init and
   update) for S frames (``--s-frames``), counters reset just before and
   read just after; every step after frame 2 held against the
   single-device step with the fixed-step march from the same state (pose,
   initial cost, the canonical model maps, the volume's codes); at full
   width the slab modes against their plain versions on every shard, the
   distributed PCG against the plain one, ``enabled=False`` as the
   identity; 3 sharded frames profiled beside 3 single-device frames (n
   shards on one card: the cost of sharding, not a multi-card rate);
18. three steps of the base ``DynamicFusionConfig()`` over ``make_mesh(4)``
   (the summed assembly: kernel N's shard mode with the pmax'd column
   scales), each held as in phase 17; N's shard mode bit-equal to its plain
   version, the psum'd Gram against the single-device N on the same rows;
19. ``python -m dynamicfusion_tpu_torch.parallel.multihost`` as two
   processes on the card over gloo, two shards each, 3 preset frames: the
   ranks equal and every step bit-equal to the one-process mesh (NCCL only
   with a card a rank, else a line says it did not run);
20. kernels C, D, F1, F2, L and R at the float volume storages, at full
   width on the preset's state after three frames re-encoded into each
   storage (and its frame-0 volume for L and R), each bit-equal to its
   plain version: C's every refine with the in-cell and the six-sample
   normal, and its slab mode on 4 shards, and R at the f32 and bf16 tsdf;
   D rigid, non-rigid and on 4 slabs, F1, F2 (phase split, incidence
   confidence) and L at the five (tsdf, weight) pairs beside i16/u16; F1's
   tiled design also bit-equal to its reference mode at each pair, both
   timed;
21. ``default_dynamicfusion()`` at each pair through ``DynamicFusion``:
   f32/f32 for F frames (``--f-frames``), the others for 7 (frame 6
   fuses), phase 4's checks and the plain step from each state, then the
   demo's export from the final state (L's cloud, R's normals); 3 steps of
   the dense non-rigid cell (F1, F2, C's newton16) at every pair and of the
   reference-shaped rigid cell (F1, C's six-sample normal) under f32/f32,
   each against the plain step;
22. the preset under f32/f32 over ``make_mesh(4)`` for 7 frames, the last
   3 steps held as phase 17 holds its steps;
23. ``default_kinfu()`` (512^3 over 3 m, the direct solve) over K frames
   (``--k-frames``) of the deforming scene rendered with its own
   intrinsics: phase 9's checks, the plain step from each state, 3 more
   frames profiled; kernel K at its 32^3 brick grid and L at 512^3 against
   their plain versions, timed;
24. print the per-kernel JSON line, the card's name and power limit, and
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
import dataclasses
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

# tolerances (kernel vs its plain version on the same inputs, same card)
TOL_BILATERAL_MM = 1          # max |diff| in mm; ties of round-half-even may flip
TOL_BILATERAL_FRAC = 1e-4     # fraction of pixels allowed to differ at all
TOL_ICP_REL = 1e-4            # max |diff| of A and b over max |entry|: sum order differs
TOL_RAYCAST_FOUND_FRAC = 1e-3  # fraction of rays whose hit/miss differs
TOL_RAYCAST_M = 1e-4          # max vertex diff (m) where both hit
TOL_RAYCAST_NORMAL = 1e-5     # max normal diff where both hit (the same float32 operations)
TOL_FUSE_LSB = 1              # max code diff of tsdf/weight
TOL_FUSE_FRAC = 1e-4          # fraction of voxels whose codes differ at all
# non-rigid fusion: codes differing by more than 1 LSB on < 1e-4 of voxels,
# weights equal (kernel D and its plain version unpack the packed depth and
# confidence with the same products by float32 reciprocals)
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
# kernel M's yardstick (PyTorch calls) against the plain version: where
# avg_pool2d's box sums and b as a sum add in another order than the taps',
# the sums move by ulps, and the closed form's det and ratios grow that
# where a window's second moment nearly cancels; the card gave at most
# 8.941e-07 over phase 2 and the GATE_CASES (at 640x480; NVIDIA H100 80GB
# HBM3, 700.00 W; on the CPU the two are bit-equal:
# tests/test_torch_gate_library.py)
TOL_GATE_LIBRARY = 1e-5
TOL_IMAGE_FRAC = 1e-3         # render pixels more than one level from the plain render (a hit may flip)
# kernel N: the int8 Gram bit-equal (integer sums are exact in any order, the
# plain version sums the integer products exactly in float64, the scale
# product in the same order); the bf16 Gram within the float32 sums' order
TOL_GRAM_BF16_REL = 1e-6      # max |diff| over max |entry|
# kernel J's yardsticks (PyTorch calls): |p| by vector_norm, not in the kernel's order
TOL_BAND_LIBRARY_M = 1e-6
# kernel N's yardsticks (PyTorch calls) against the plain version: the edge
# blocks added one after the other, data + A + Aᵀ + D, not data + ((A + Aᵀ)
# + D), and (bf16) the product summed in another order
TOL_GRAM_LIBRARY_REL = 1e-5
# kernel O: off the diagonal a copy; the diagonal within the mean's sum order
TOL_DAMP_REL = 1e-6
# kernel Q against its plain version (a float64 SVD through
# torch.linalg.svd): the centroids and H are float32 sums in two orders;
# the transforms are unit dual quaternions
TOL_NET_RIGID = 1e-5
# kernel P, and kernel G in every PCG hold (``hold_pcg``), against the
# plain PCG on the same system: within SPREAD_PCG times the plain PCG's own
# spread when every entry of the matrix (P) or of the right-hand side (G)
# moves by one ulp (the systems are ill conditioned at small lambda, and a
# flipped bf16 rounding of G's t grows over the iterations: on the
# three-row system the plain PCG parts from itself by ~9e-3 under such a
# move, so a fixed 1e-2 sits at the noise floor), and never held tighter
# than TOL_DENSE_PCG_FLOOR (P) or TOL_PCG_REL (G)
SPREAD_PCG = 4.0
TOL_DENSE_PCG_FLOOR = 1e-5
# the depth-variant ICP (phase 15): kernel path against plain on the same
# pyramids, and against the camera's known motion (as tests/test_icp.py
# holds JAX)
TOL_T1_M = 1e-4
TOL_T1_ROT = 1e-5
TOL_T1_TRUTH_M = 2e-3
T1_DELTA = (0.004, -0.003, 0.005)  # the camera's motion between the two frames (m, camera frame)

# H100 SXM peaks (NVIDIA data sheet): memory 3.35 TB/s, float32 (no tensor core) 67 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# the special-function units (ex2 and the like): 16 results a clock on each
# of 132 SMs at the 1.98 GHz boost clock
PEAK_SFU = 16 * 132 * 1.98e9
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
STENCIL_KERNELS = ("depth_dists", "depth_pyramid", "frame_maps", "resize_maps", "march_bands", "brick_plan")
# (source, the TPU kernel-role function it replaces) of each JSON row; a
# row's launches are its counter's (the row name, but for the rows below;
# kernel E's rows count the launches of their kind of call,
# ``knn_counted``) on the rigid path for A-D and on the preset's path for
# the rest
ROWS = {
    "bilateral": ("bilateral.cu", "dynamicfusion_tpu/ops/preprocess.py:43"),
    "icp_reduce": ("icp_reduce.cu", "dynamicfusion_tpu/solvers/icp.py:38"),
    "raycast": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:386"),
    "raycast_newton8": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:529"),
    "fuse_bricks": ("fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552"),
    "fuse_bricks_nonrigid": ("fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552"),
    "depth_dists": ("preprocess.cu", "dynamicfusion_tpu/ops/preprocess.py:165"),
    "depth_pyramid": ("preprocess.cu", "dynamicfusion_tpu/ops/preprocess.py:91"),
    "frame_maps": ("preprocess.cu", "dynamicfusion_tpu/ops/preprocess.py:124"),
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
    "mutual_nearest_full_res": ("knn_blend.cu", "dynamicfusion_tpu/models/warpfield.py:267"),
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
    "raycast_newton16": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:529"),
    "raycast_hybrid16": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:475"),
    "raycast_grad6_coarse": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:610"),
    "raycast_full_res_grad6_secant": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:610"),
    "raycast_grad6_newton8": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:610"),
    "raycast_grad6_newton16": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:610"),
    "raycast_grad6_hybrid16": ("raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:610"),
    "integrate_dense": ("fuse_dense.cu", "dynamicfusion_tpu/ops/tsdf.py:169"),
    "integrate_dense_nonrigid": ("fuse_dense.cu", "dynamicfusion_tpu/ops/fusion.py:174"),
    "points_normals_depth": ("preprocess.cu", "dynamicfusion_tpu/solvers/icp.py:188"),
    "icp_reduce_depth": ("icp_reduce.cu", "dynamicfusion_tpu/solvers/icp.py:188"),
    "extract_normals": ("normals.cu", "dynamicfusion_tpu/ops/tsdf.py:724"),
    "knn_blend_mesh": ("knn_blend.cu", "dynamicfusion_tpu/models/warpfield.py:233"),
    "knn_blend_points": ("knn_blend.cu", "dynamicfusion_tpu/solvers/warp_solver.py:268"),
    "knn_blend_nodes": ("knn_blend.cu", "dynamicfusion_tpu/solvers/warp_solver.py:170"),
}
COUNTER = {"raycast_newton8": "raycast", "fuse_bricks_nonrigid": "fuse_bricks", "data_term_tangential": "data_term",
           "pcg_tangential": "pcg", "raycast_coarse": "raycast", "raycast_full_res": "raycast",
           "raycast_render": "raycast", "icp_reduce_full_res": "icp_reduce", "data_term_p2p": "data_term",
           "dense_gram_bf16": "dense_gram", "insert_select_full_res": "insert_select",
           "mutual_nearest_full_res": "mutual_nearest",
           "node_radius_insert": "node_radius", "data_term_strided": "data_term", "pcg_strided": "pcg",
           "pcg_lagged": "pcg", "points_normals_depth": "frame_maps", "icp_reduce_depth": "icp_reduce",
           "knn_blend": "knn_blend[k8 blend warp]", "knn_blend_points": "knn_blend[k8]",
           "knn_blend_nodes": "knn_blend[k5]", "knn_blend_mesh": "knn_blend[k8 warp normals]",
           **{k: "raycast" for k in ("raycast_newton16", "raycast_hybrid16", "raycast_grad6_coarse",
                                     "raycast_full_res_grad6_secant", "raycast_grad6_newton8",
                                     "raycast_grad6_newton16", "raycast_grad6_hybrid16")}}
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
        "mutual_nearest_full_res": "parity_nr",
        **dict.fromkeys(("node_radius", "node_radius_insert", "net_rigid", "data_term_strided", "pcg_strided"),
                        "options"),
        "pcg_lagged": "options_lag", "dense_pcg": "base_pcg",
        # the reference-shaped rigid cell (phase 13): F1 and C's six-sample
        # normal; the dense non-rigid cell (phase 14): F2, C's newton16, and
        # its variants' three steps
        **dict.fromkeys(("integrate_dense", "raycast_grad6_coarse", "raycast_full_res_grad6_secant"), "ref_rigid"),
        "integrate_dense_nonrigid": "dense_nr", "raycast_newton16": "dense_nr",
        "raycast_hybrid16": "dense_nr_hybrid16", "raycast_grad6_newton8": "dense_nr_newton8_grad6",
        "raycast_grad6_newton16": "dense_nr_newton16_grad6", "raycast_grad6_hybrid16": "dense_nr_hybrid16_grad6",
        # the depth-variant ICP (phase 15) and the demo (phase 16: R, E at the mesh)
        "points_normals_depth": "depth_icp", "icp_reduce_depth": "depth_icp",
        "extract_normals": "demo", "knn_blend_mesh": "demo"}
# the options cell (phase 11): quality_dynamicfusion() with these
OPTIONS = dict(solver_p2p_adaptive=True, solver_p2p_hessian_stride=4, node_radius_adaptive=True,
               solver_remove_net_rigid=True, solver_net_rigid_alpha=0.5)
# the direct solve's kernels (N, O) and its factor: the PCG presets run none
# of them, the base config none of the PCG's
DENSE_KERNELS = ("gram_scales", "dense_gram", "dense_damp", "cholesky")
PCG_KERNELS = ("spd6_inv", "pcg")
# the sharded step's distributed PCG: G's cluster launch of the whole solve
# with P's init and update; and the composition it replaced (G's data-only
# matvec and step, P's init), its reference mode, which no path runs
SHARD_KERNELS = ("pcg_sharded",)
SHARD_REFERENCE = ("data_matvec", "pcg_init", "pcg_step")
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


def same_bits(torch, a, b) -> bool:
    """a and b alike in shape, type and every bit (NaNs by their bits)."""
    if a is None or b is None:
        return a is None and b is None
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a if view is None else a.view(view), b if view is None else b.view(view))


def hold_data_order(torch, name, cfg, s, dq, row_stride=1, what=""):
    """Kernel F bit for bit against its order (with and without the system):
    Jᵀr and the diagonal blocks against ``warp_solver.data_sums_ordered`` of
    the kernel's own float32 Jacobian and residuals in the library's node
    lanes, the cost against ``warp_solver.sum_ordered`` of its per-point
    costs (the order of the one-block sum the node pass's cost block
    replaced), the bf16 rows against ``bf16_rows`` of its Jacobian."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    point_lanes, lanes = kernels.data_term_lanes()
    parts = {}
    for system in (True, False):
        jtr, cost, rows, blocks, jac, rw, rho = kernels.data_term(
            s.p_can, s.p_live, s.n_live, s.valid, s.knn_idx, s.w_knn, dq, s.pts_by_node.order, s.pts_by_node.off,
            cfg.solver_tukey_c, system, s.t1, s.t2, s.p2p_sw, point=not cfg.point_to_plane, row_stride=row_stride,
            internals=True)
        ojtr, oblocks = ws.data_sums_ordered(jac, rw, s.pts_by_node, lanes)
        tag = "system" if system else "no system"
        parts[f"jtr ({tag})"] = same_bits(torch, jtr, ojtr)
        parts[f"cost ({tag})"] = same_bits(torch, cost, ws.sum_ordered(rho))
        if system:
            parts["blocks"] = same_bits(torch, blocks, oblocks)
            parts["bf16 rows"] = same_bits(torch, rows, ws.bf16_rows(jac, row_stride))
    emax, emean, _ = entry_counts(torch, s.pts_by_node.off)
    check(name, all(parts.values()),
          f"{s.p_can.shape[0]} points x {jac.shape[1]} rows{what}, {point_lanes} lanes a point, {lanes} lanes a node "
          f"(entries a node max {emax}, mean {emean:.1f}): bit for bit against data_sums_ordered / sum_ordered / "
          f"bf16_rows {parts}")


def library_knn(torch, field, q, k, blend=False, warp=False, normals=None, margin=8):
    """Kernel E's function in PyTorch calls (its library column; the port
    never calls it): the squared distances as one ``torch.addmm`` of the
    expansion (|q|^2 + |n|^2 + the inactive offset - 2 q nᵀ) and the
    k + ``margin`` nearest by ``torch.topk(largest=False)``; those
    candidates re-scored by the kernel's expression ((|q|^2 - 2 q.n) +
    |n|^2) + offset and the k best taken under (distance, index) by a
    stable sort (the addmm's rounding alone decides near-ties otherwise: it
    parted from the kernel on 2.75e-3 of the coarse corners); then the
    plain weights, quality, blend and warp."""
    from dynamicfusion_tpu_torch.core import dualquat
    from dynamicfusion_tpu_torch.models import warpfield

    qn = torch.nan_to_num(q)
    pos = field.positions
    big = torch.where(field.active, 0.0, 1e9)
    d = torch.addmm((qn * qn).sum(1, keepdim=True) + ((pos * pos).sum(1) + big), qn, pos.T, alpha=-2.0)
    cand = torch.sort(torch.topk(d, k + margin, dim=1, largest=False, sorted=False).indices, dim=1).values
    c = pos[cand]
    qq = (qn[:, 0] * qn[:, 0] + qn[:, 1] * qn[:, 1]) + qn[:, 2] * qn[:, 2]
    cn = (c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]) + c[..., 2] * c[..., 2]
    dot = (qn[:, None, 0] * c[..., 0] + qn[:, None, 1] * c[..., 1]) + qn[:, None, 2] * c[..., 2]
    dc = ((qq[:, None] - 2.0 * dot) + cn) + big[cand]
    d2, order = torch.sort(dc, dim=1, stable=True)
    idx = torch.gather(cand, 1, order[:, :k])
    d2 = d2[:, :k].clamp(min=0.0)
    w = warpfield.weights_from_dist2(field.radius, d2, idx)
    b = dualquat.blend(w, field.dq[idx]) if blend or warp else None
    wp, wn = warpfield._warp_with(b, q, normals) if warp else (None, None)
    return d2, idx, w, b, warpfield.quality(w) if blend else None, wp, wn


def knn_row(torch, report, name, field, q, k, what, blend=False, warp=False, normals=None):
    """Kernel E at one shape: held against its plain version (neighbour
    lists within TOL_KNN_IDX_FRAC, distances, weights, blend, quality,
    warped points and normals), bit for bit against the one-thread-a-query
    kernel (``lanes=0``), its library route (``library_knn``) held to its
    neighbour lists within TOL_KNN_IDX_FRAC; the kernel, the serial kernel,
    the plain version and the library route timed."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models import warpfield

    nq, n = q.shape[0], field.positions.shape[0]
    kw = dict(blend=blend, warp=warp, normals=normals)
    args = (field.positions, field.active, field.radius, field.dq, q, k)
    kb = warpfield.knn_blend(field, q, k, **kw)
    pb = warpfield.knn_blend(field, q, k, plain=True, **kw)
    same = (kb.idx == pb.idx).all(dim=1)
    idx_frac = float((~same).float().mean())
    err = max(abs_err(torch, a[same], b[same]) for a, b in zip(kb[2:], pb[2:]) if a is not None)
    d2err = abs_err(torch, kb.d2, pb.d2)
    check(name, idx_frac <= TOL_KNN_IDX_FRAC and err <= TOL_FIELD and d2err <= TOL_D2,
          f"{nq} {what} x {n} nodes, k = {k}: neighbour lists differ on {idx_frac:.2e} (tol {TOL_KNN_IDX_FRAC}), "
          f"max d2 diff {d2err:.2e} (tol {TOL_D2}), max weight/blend/quality/point/normal diff {err:.2e} "
          f"(tol {TOL_FIELD})")
    serial = kernels.knn_blend(*args, **kw, lanes=0)
    split_same = {f: same_bits(torch, a, b) for f, a, b in zip(kb._fields, kb, serial)}
    check(f"{name}_split", all(split_same.values()),
          f"the split scan ({kernels.knn_lanes(nq)} lanes a query) against the one-thread-a-query kernel, bit for bit: "
          f"{split_same}")
    lib = library_knn(torch, field, q, k, **kw)
    lib_frac = float((lib[1] != kb.idx).any(dim=1).float().mean())
    check(f"{name}_library", lib_frac <= TOL_KNN_IDX_FRAC,
          f"library route (addmm, topk, re-scored): neighbour lists differ from the kernel's on {lib_frac:.2e} of the "
          f"queries "
          f"(tol {TOL_KNN_IDX_FRAC})")
    # the nodes (positions, active, radius; the transforms where blended)
    # and the queries (and normals) in; d2, idx, w, blend, quality and the
    # warped queries (and normals) out; ~10 operations a (query, node) pair
    # for the expansion and the compare, ~250 a neighbour for the blend
    moved = blend or warp
    nbytes = (n * (12 + 1 + 4 + (32 if moved else 0)) + nq * (12 + (12 if normals is not None else 0))
              + nq * (k * 16 + (36 if blend else 0) + (12 if warp else 0) + (12 if normals is not None else 0)))
    report[name] = dict(
        err=max(err, d2err),
        ms=cuda_ms(torch, lambda: kernels.knn_blend(*args, **kw)),
        serial_ms=cuda_ms(torch, lambda: kernels.knn_blend(*args, **kw, lanes=0)),
        plain_ms=cuda_ms(torch, lambda: warpfield.knn_blend(field, q, k, plain=True, **kw), reps=3),
        bound=bound_ms(nbytes, nq * n * 10.0 + (nq * k * 250.0 if moved else 0.0)),
        library_ms=cuda_ms(torch, lambda: library_knn(torch, field, q, k, **kw)),
    )
    r = report[name]
    print(f"[time] {smi()} | E {name} ({nq} {what}, k = {k}): {r['ms']:.4f} ms ({kernels.knn_lanes(nq)} lanes a query), "
          f"one thread a query {r['serial_ms']:.4f} ms, library {r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
          f"ms; bound {r['bound'][0]:.5f} ms ({r['bound'][1]})", flush=True)


def skewed_data_structure(torch, dev, n, npt, nrows, seed):
    """Kernel F's inputs at ``n`` nodes on ``skewed_gram_inputs``' neighbour
    lists (node 0 in 60% of the points): nodes in a 1 m cube with small
    seeded transforms, each point beside its first neighbour, its live
    position ~1 cm away, a seeded unit normal, weights in [0.1, 1], 5% of
    the points invalid; one row (the preset), or three with the tangent
    basis and sqrt(0.25) as the tangential weight (the quality preset).
    Returns (config, structure, node transforms)."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import dualquat
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = DynamicFusionConfig.default_dynamicfusion() if nrows == 1 else DynamicFusionConfig.quality_dynamicfusion()
    g = skewed_gram_inputs(torch, dev, n, npt, nrows, seed)
    rng = np.random.default_rng(seed + 100)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    dq = dualquat.from_twist(f32(rng.standard_normal((n, 3)) * 0.01),
                             f32(rng.standard_normal((n, 3)) * 0.002)).contiguous()
    pos = rng.uniform(-0.5, 0.5, (n, 3))
    p_can = pos[g.knn[:, 0].cpu().numpy()] + rng.normal(0.0, 0.01, (npt, 3))
    nrm = rng.standard_normal((npt, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    n_live = f32(nrm)
    t1 = t2 = sw = None
    if nrows == 3:
        t1, t2 = (a.contiguous() for a in ws.tangent_basis(n_live))
        sw = torch.full((npt,), float(np.sqrt(0.25)), device=dev)
    s = ws.SolveStructure(
        p_can=f32(p_can), p_live=f32(p_can + rng.normal(0.0, 0.01, (npt, 3))), n_live=n_live,
        valid=torch.from_numpy(rng.random(npt) < 0.95).to(dev), knn_idx=g.knn,
        w_knn=f32(rng.uniform(0.1, 1.0, (npt, 8))), e_src=None, e_dst=None, e_valid=None, v_dst=None, alpha=None,
        pts_by_node=g.lists, edges_by_dst=None, t1=t1, t2=t2, p2p_sw=sw)
    return cfg, s, dq


def data_2048(torch, dev, n=2048, npt=6400):
    """Phase 2 for kernel F at 2048 nodes on ``skewed_data_structure`` (node
    0 in 60% of 6 400 points), one row and three: held bit for bit against
    its order (``hold_data_order``) and within TOL_DATA_REL against the
    plain version, and timed."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    for nrows in (1, 3):
        cfg, s, dq = skewed_data_structure(torch, dev, n, npt, nrows, seed=30 + nrows)
        hold_data_order(torch, f"data_term_2048_r{nrows}_order", cfg, s, dq, what=f", {n} skewed nodes")
        dk = ws.data_term(cfg, s, dq, True)
        with deterministic(torch):
            dp = ws.data_term(cfg, s, dq, True, plain=True)
        errs = [rel_err(torch, dk.jtr, dp.jtr), rel_err(torch, dk.blocks, dp.blocks), rel_err(torch, dk.cost, dp.cost)]
        check(f"data_term_2048_r{nrows}", max(errs) <= TOL_DATA_REL,
              f"{n} nodes, {npt} x {nrows} rows: relative diff Jᵀr {errs[0]:.2e}, blocks {errs[1]:.2e}, cost "
              f"{errs[2]:.2e} (tol {TOL_DATA_REL})")
        ms = cuda_ms(torch, lambda: ws.data_term(cfg, s, dq, True))
        print(f"[time] {smi()} | F at {n} skewed nodes, {npt} x {nrows} rows: {ms:.4f} ms", flush=True)


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
    border_t = torch.from_numpy(border_frame(h, w, 1)).to(dev)
    hold_bilateral(torch, "bilateral_tiled", d_t, args_a, "the noisy frame")
    hold_bilateral(torch, "bilateral_tiled_border", border_t, args_a, "a frame whose depth edges cross the border")
    report["bilateral"] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.bilateral_filter(d_t, *args_a)),
        reference_ms=cuda_ms(torch, lambda: kernels.bilateral_filter(d_t, *args_a, reference=True)),
        plain_ms=cuda_ms(torch, lambda: preprocess.bilateral_filter_plain(d_t, *args_a), reps=5),
        # the bytes; ~10 float operations a tap; one ex2 a tap on the
        # special-function units
        bound=max(bound_ms(h * w * 2 * 2, taps * 10.0), (taps / PEAK_SFU * 1e3, "operations")),
        library_ms=cuda_ms(torch, lambda: library_bilateral(torch, d_t, *args_a)),
    )
    r = report["bilateral"]
    print(f"[time] {smi()} | A {w}x{h}: tiled {r['ms']:.4f} ms, reference mode {r['reference_ms']:.4f} ms, library "
          f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; bound {r['bound'][0]:.5f} ms ({r['bound'][1]})",
          flush=True)

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
    # D (the persistent grid) against its reference mode, fusing and gated
    ref, ref_gated, gated = hold_fuse(torch, "fuse_bricks_reference", cfg, st.vol, dists, cam_grid, g, bp,
                                      what="rigid, ")
    report["fuse_bricks"].update(reference_ms=ref, gated_ms=gated, reference_gated_ms=ref_gated)
    print(f"[time] fuse_bricks: a fusing launch {report['fuse_bricks']['ms']:.4f} ms (reference mode {ref:.4f}), "
          f"a gated launch {gated:.4f} ms (reference mode {ref_gated:.4f})", flush=True)

    # C: ray march + refine at the model-map resolution with the temporal band
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    intr_t = intr.level(cfg.raycast_shift)
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), pose)
    band = kinfu._temporal_band(cfg, st.can_points, dists)
    hold_raycast(torch, report, "raycast", cfg, st.vol.tsdf,
                 tsdf_ops.rays(cfg, cam2vol, intr_t, rows_t, cols_t, t_band=band))

    # B: ICP system at the tracking resolution (live frame vs the model maps)
    _, pts_pyr, nrm_pyr, _ = preprocess.build_frame_pyramid(cfg, dnext, first_point_level=cfg.raycast_shift)
    cp, cn = pts_pyr[cfg.raycast_shift], nrm_pyr[cfg.raycast_shift]
    pp, pn = st.prev_points[0], st.prev_normals[0]
    dist2 = cfg.icp_dist_thres ** 2
    min_cos = math.cos(cfg.icp_angle_thres)
    t_cur = torch.eye(4, device=dev)
    npx = cp.shape[0] * cp.shape[1]
    n_model = pp.shape[0] * pp.shape[1]
    # live points+normals and model points+normals read once, pose in, A and b out
    hold_icp(torch, report, "icp_reduce", intr_t, t_cur, cp, cn, pp, pn, dist2, min_cos,
             (npx + n_model) * 24 + 64 + 42 * 4)


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


def library_bilateral(torch, depth_mm, kernel_size, sigma_spatial, sigma_depth_m):
    """Kernel A's function in PyTorch calls (its library column; the port
    never calls it): ``F.unfold`` of the frame padded with -1, the window's
    weights from ``kernels.bilateral_space_table`` (0 where the neighbour is
    the padding), and the two sums over the window in the kernel's tap
    order (the last row of ``torch.cumsum`` over the window; ``sum``'s tree
    order flipped the rounding of 1.2e-4 of the pixels of the rigid
    slice's noisy frame, past the kernel's tolerance)."""
    import torch.nn.functional as F

    from dynamicfusion_tpu_torch import kernels

    h = kernel_size // 2
    rows, cols = depth_mm.shape
    d = depth_mm.to(torch.float32)
    nbr = F.unfold(F.pad(d[None, None], (h, h, h, h), value=-1.0), kernel_size)[0]
    space = torch.from_numpy(kernels.bilateral_space_table(kernel_size, sigma_spatial)).to(d.device)[:, None]
    sigma_depth_mm = sigma_depth_m * 1000.0
    diff = d.reshape(1, -1) - nbr
    wgt = torch.exp(-(space + diff * diff * (0.5 / (sigma_depth_mm * sigma_depth_mm)))) * (nbr >= 0.0)
    num = torch.cumsum(nbr * wgt, 0)[-1]
    den = torch.cumsum(wgt, 0)[-1]
    return torch.round(num / torch.clamp(den, min=1e-12)).to(torch.int32).to(depth_mm.dtype).reshape(rows, cols)


def hold_bilateral(torch, name, depth, args, what):
    """Kernel A (the tiled filter) bit for bit against its reference mode,
    within the existing tolerance of the plain version, and the library
    route (``library_bilateral``) within the same tolerance."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.ops import preprocess

    got = kernels.bilateral_filter(depth, *args)
    ref = kernels.bilateral_filter(depth, *args, reference=True)
    errs = {}
    for tag, other in (("plain", preprocess.bilateral_filter_plain(depth, *args)),
                       ("library", library_bilateral(torch, depth, *args))):
        diff = (got.to(torch.int32) - other.to(torch.int32)).abs()
        errs[tag] = (int(diff.max()), float((diff > 0).float().mean()))
    ok = torch.equal(got, ref) and all(e <= TOL_BILATERAL_MM and f <= TOL_BILATERAL_FRAC for e, f in errs.values())
    check(name, ok, f"{what} ({depth.shape[1]}x{depth.shape[0]}): the tiled kernel equals the reference mode bit for "
          f"bit {torch.equal(got, ref)}; against plain and the library route (max |diff| mm, differing) {errs} (tol "
          f"{TOL_BILATERAL_MM}, {TOL_BILATERAL_FRAC})")


def border_frame(rows: int, cols: int, seed: int = 0) -> np.ndarray:
    """A seeded (rows, cols) uint16 depth frame (mm) whose depth edges cross
    all four borders: a slanted plane with vertical steps of 150 and 30 mm
    (crossing the top and bottom rows) and horizontal steps of -200 and 45
    mm (crossing the left and right columns), +-4 mm of noise, and holes
    (0) on every border, for kernel A's border blocks."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:rows, 0:cols]
    d = 1200.0 + 0.8 * x - 0.5 * y
    d += np.where((x // 23) % 2 == 0, 150.0, 0.0) + np.where((x // 7) % 3 == 0, 30.0, 0.0)
    d += np.where((y // 17) % 3 == 0, -200.0, 0.0) + np.where((y // 5) % 4 == 0, 45.0, 0.0)
    d += rng.randint(-4, 5, (rows, cols))
    d[(x < 5) & (y % 40 < 12)] = 0.0
    d[(x >= cols - 4) & (y % 50 < 9)] = 0.0
    d[(y < 3) & (x % 60 < 15)] = 0.0
    d[(y >= rows - 5) & (x % 70 < 20)] = 0.0
    return d.astype(np.uint16)


def pyramid_frame(rows: int, cols: int, seed: int = 0, thresh: int = 120) -> np.ndarray:
    """A seeded (rows, cols) uint16 depth frame (mm) for kernel I's pyramid
    at its edges: 8x8 patches of one base depth whose pixels sit 0, +-1
    mm of, or exactly +-``thresh`` (3 sigma, the preset's 120 mm) from it,
    so that window neighbours differ from a centre by exactly the
    threshold and one mm either side; a band of rows in 65 000-65 535 (a
    window's sum near 25 x 2^16); holes (0) scattered and in blocks."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:rows, 0:cols]
    base = rng.randint(thresh + 2, 65000 - thresh - 2, ((rows + 7) // 8, (cols + 7) // 8))
    d = base[y // 8, x // 8] + rng.choice(np.array([0, 0, -1, 1, -thresh, thresh, -thresh - 1, thresh + 1,
                                                    -thresh + 1, thresh - 1]), (rows, cols))
    high = (y // 16) % 5 == 2
    d = np.where(high, rng.randint(65000, 65536, (rows, cols)), d)
    d = np.where(rng.rand(rows, cols) < 0.05, 0, d)
    d[(y // 12) % 7 == 3] *= ((x[(y // 12) % 7 == 3] // 10) % 4 != 0)
    return d.astype(np.uint16)


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
    k8 = cfg.knn_k
    knn_row(torch, report, "knn_blend", field, q, k8, "corners", blend=True, warp=True)

    # E: the mutual-nearest distances of node insertion
    ins = cfg.node_insert_stride
    cand = inputs.p_can[::ins].contiguous()
    valid = ~torch.isnan(cand[:, 0])
    nc = cand.shape[0]
    hold_mutual(torch, report, "mutual_nearest", field, cand, valid)
    hold_mutual_cases(torch, dev, nc, n)

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
    # E at the solve points (prepare's KNN) and at the nodes (build_edges' k = 5)
    knn_row(torch, report, "knn_blend_points", field, s.p_can, k8, "solve points")
    knn_row(torch, report, "knn_blend_nodes", field, field.positions, 5, "nodes")
    hold_data_order(torch, "data_term_order", cfg, s, field.dq)
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
    three = hold_edge_order(torch, "edge_term_order", cfg, s, field.dq, "the preset's phase-2 state: ")
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
        reference_ms=three,
    )
    print(f"[time] edge_term: one launch {report['edge_term']['ms']:.4f} ms, three-launch mode {three:.4f} ms, "
          f"plain {report['edge_term']['plain_ms']:.4f} ms", flush=True)
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
    on = torch.ones((), dtype=torch.bool, device=dev)
    lm0 = torch.full((), cfg.solver_lm_lambda_init, device=dev)
    dk_ = torch.empty_like(spd)
    ws.spd6_inv_damped(spd, diag_eff, unit, lm0, on, dk_)
    dp_ = torch.empty_like(spd)
    ws.spd6_inv_damped(spd, diag_eff, unit, lm0, on, dp_, plain=True)
    err = rel_err(torch, dk_, dp_)
    check("spd6_inv_damped_plain", err <= TOL_SPD6_REL,
          f"the damped entry on the random SPD blocks: kernel vs plain {err:.2e} (tol {TOL_SPD6_REL})")
    hold_spd6(torch, "spd6_inv_random", spd, diag_eff, unit, cfg.solver_lm_lambda_init, "random SPD blocks: ")
    # the solve's own lambdas: lambda_init (timed), after one to three
    # rejections (x8 each), and the clamp's floor
    for lam in [cfg.solver_lm_lambda_init * 8.0 ** k for k in range(1, 4)] + [1e-8]:
        hold_spd6(torch, "spd6_inv_damped", blocks_full, diag_eff, unit, lam, "the preset's phase-2 damped blocks: ")
    ms_d, ms_ref, ms_kept = hold_spd6(torch, "spd6_inv_damped", blocks_full, diag_eff, unit,
                                      cfg.solver_lm_lambda_init, "the preset's phase-2 damped blocks: ", timed=True)
    mk, mp_ = ws.spd6_inv(m), ws.spd6_inv(m, plain=True)
    exact_m = torch.linalg.inv(m.double())
    print(f"[info] spd6_inv on the solver's damped blocks: condition numbers median "
          f"{float(torch.linalg.cond(m.double()).median()):.2e}; relative error against the float64 inverse: "
          f"kernel {rel_err(torch, mk.double(), exact_m):.2e}, plain {rel_err(torch, mp_.double(), exact_m):.2e}; "
          f"non-finite entries: kernel {int((~torch.isfinite(mk)).sum())}, plain {int((~torch.isfinite(mp_)).sum())}",
          flush=True)
    scratch = torch.empty_like(m)
    report["spd6_inv"] = dict(
        err=max(abs_err(torch, ik, ip), abs_err(torch, dk_, dp_)),
        # the LM iteration's whole preconditioner step (damping, inverse,
        # the keep rule) at lambda_init; rebuild false: kept_ms
        ms=ms_d,
        plain_ms=cuda_ms(torch, lambda: ws.spd6_inv_damped(blocks_full, diag_eff, unit, lm0, on, scratch, plain=True)),
        # blocks, diag_eff, unit and lambda in; minv and damp out; ~450
        # operations a node's inverse, 18 its damping
        bound=bound_ms(n * (144 + 24 + 24 + 144 + 24) + 5, n * 468.0),
        library_ms=cuda_ms(torch, lambda: torch.linalg.inv(m)),
        reference_ms=ms_ref,
        kept_ms=ms_kept,
    )
    print(f"[time] spd6_inv: damped entry {ms_d:.4f} ms (rebuild false {ms_kept:.4f}), the composition it replaced "
          f"(two damping kernels, diag_embed, the add, the reference mode, where) {ms_ref:.4f}, undamped "
          f"{cuda_ms(torch, lambda: kernels.spd6_inv(m)):.4f}, reference mode "
          f"{cuda_ms(torch, lambda: kernels.spd6_inv(m, reference=True)):.4f}", flush=True)
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
    hold_pcg(torch, report, "pcg", s, sysm, ip, b, iters, rtol, f"up to {iters} iterations over 6N = {6 * n}")
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
    hold_select(torch, "insert_select", cfg, hfield, hcand, hvalid, cd2, gate)
    hold_select(torch, "insert_select_device_table", cfg, hfield, hcand, hvalid, cd2, gate, device_table=True)
    hold_select_cases(torch, dev, nc, n)
    hold_select_cases(torch, dev, nc, 2 * n, names=("overflow", "ties"))
    plan = warpfield.InsertPlan(*kernels.insert_select(hcand, cd2, hvalid, hfield.active, hfield.count, gate,
                                                       cfg.node_coverage))
    seed = warpfield.warp_dq_at(hfield, torch.nan_to_num(plan.new_pos), k=k8)
    report["insert_select"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.insert_select(hcand, cd2, hvalid, hfield.active, hfield.count, gate,
                                                        cfg.node_coverage)),
        plain_ms=cuda_ms(torch, lambda: warpfield._insert_select_plain(cfg, hfield, hcand, hvalid, cd2, gate), reps=5),
        # candidates, their distances and flags, the active mask, the count
        # and the gate in; slots and positions out; the cell arithmetic
        bound=bound_ms(nc * 17 + n + 5 + n * 20, nc * 12.0),
        library_ms=cuda_ms(torch, lambda: library_insert_select(torch, cfg, hfield, hcand, hvalid, cd2, gate),
                           reps=5),
    )
    rad = torch.full((n,), cfg.node_radius, device=dev)
    apply = lambda reference=False: kernels.insert_apply(*hfield, plan.slots, plan.new_pos, seed, fi, rad,  # noqa: E731
                                                         reference=reference)
    got, one = kernels_a_call("insert_apply", apply)
    ref, ref_ops = kernels_a_call("insert_apply", lambda: apply(True))
    plain = warpfield._insert_apply_plain(hfield, plan, seed, fi, rad)
    same = all(same_bits(torch, a, b) and same_bits(torch, a, c) for a, b, c in zip(got, ref, plain))
    check("insert_apply", same and one == 1 and int(got[4]) > int(hfield.count),
          f"kernel H's apply, {int(got[4]) - int(hfield.count)} nodes into {n} slots: one device kernel {one} (the "
          f"reference mode's {ref_ops}: six copies and the one-block kernel); bit-equal to the plain delta scatter "
          f"and to the reference mode {same}")
    report["insert_apply"] = dict(
        err=err,
        ms=cuda_ms(torch, apply),
        reference_ms=cuda_ms(torch, lambda: apply(True)),
        plain_ms=cuda_ms(torch, lambda: warpfield._insert_apply_plain(hfield, plan, seed, fi, rad), reps=5),
        # the old field, the plan (slots, positions, seeds, radii) and the
        # frame index in, the new field out; a few operations a slot
        bound=bound_ms(n * 53 * 2 + n * 56 + 8, n * 60.0),
        library_ms=None,
    )
    print(f"[time] kernel H's apply {report['insert_apply']['ms']:.4f} ms in {one} device kernel; the reference "
          f"mode {report['insert_apply']['reference_ms']:.4f} ms in {ref_ops}", flush=True)

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
    check("fuse_bricks_nonrigid", torch.equal(cnt_k, cnt_p) and frac < TOL_FUSE_NR_FRAC and int(dw_.max()) == 0
          and changed > 0,
          f"counts {cnt_k.tolist()} / {cnt_p.tolist()}; codes > 1 LSB apart on {frac:.2e} (tol {TOL_FUSE_NR_FRAC}), "
          f"max code diff {int(dt_.max())}, max weight diff {int(dw_.max())} (tol 0); {changed} voxels changed")
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
    # the launch of a frame that does not fuse (fusion_interval): ok false
    # on the device, every block returns at once
    off_t = torch.zeros((), dtype=torch.bool, device=dev)
    before = scratch.tsdf.clone()
    bricks.fuse(cfg, scratch, lookup, cam_grid, g, cfg.intr, bp, off_t, q_grid=cf.q, packed=True)
    check("fuse_bricks_nonrigid_gated", torch.equal(scratch.tsdf, before), "ok false leaves the volume as it is")
    gated = cuda_ms(torch, lambda: bricks.fuse(cfg, scratch, lookup, cam_grid, g, cfg.intr, bp, off_t, q_grid=cf.q,
                                               packed=True))
    report["fuse_bricks_nonrigid"]["gated_ms"] = gated
    ref, ref_gated, _ = hold_fuse(torch, "fuse_bricks_nonrigid_reference", cfg, st.vol, lookup, cam_grid, g, bp, cf.q,
                                  True, what="non-rigid, ")
    report["fuse_bricks_nonrigid"].update(reference_ms=ref, reference_gated_ms=ref_gated)
    print(f"[time] fuse_bricks_nonrigid: a fusing launch {report['fuse_bricks_nonrigid']['ms']:.4f} ms (reference "
          f"mode {ref:.4f}), a gated launch (ok false) {gated:.4f} ms (reference mode {ref_gated:.4f})", flush=True)
    del scratch, vk, vp, df
    dense_fusion_kernels(torch, report, dev, cfg, st, tr, cf)


def hold_dense(torch, name, fuse, vol, launches):
    """A dense fusion kernel (``fuse(v, plain)`` fuses volume ``v`` in place
    and returns the plain version's update mask) against its plain version
    on clones of ``vol``: codes within TOL_FUSE_LSB, weights equal. Returns
    (the kernel's volume, the update mask, max code diff, share of voxels
    whose codes differ)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume

    vk = TsdfVolume(vol.tsdf.clone(), vol.weight.clone())
    vp = TsdfVolume(vol.tsdf.clone(), vol.weight.clone())
    before = kernels.launches[launches]
    fuse(vk, False)
    upd = fuse(vp, True)
    dt_ = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
    w_same = torch.equal(vk.weight.view(torch.int16), vp.weight.view(torch.int16))
    err = int(dt_.max())
    frac = float((dt_ > 0).float().mean())
    n_upd = int(upd.sum())
    check(name, err <= TOL_FUSE_LSB and w_same and n_upd > 0 and kernels.launches[launches] == before + 1,
          f"{tuple(vol.tsdf.shape)}: max code diff {err} (tol {TOL_FUSE_LSB}), codes differ on {frac:.2e} of "
          f"voxels, weights equal {w_same} (the update masks agree on every voxel); {n_upd} voxels updated")
    return vk, upd, err, frac


def word_bits(torch, t):
    """A volume's codes or floats as integers of their width, elementwise
    (CUDA PyTorch compares no uint16)."""
    return t.view({torch.float32: torch.int32}.get(t.dtype, torch.int16))


def dense_poses(torch, cfg, vol2cam):
    """Kernel F1's held poses beside ``vol2cam`` (a (4, 4) volume-to-camera
    pose): "away" turned half round about the camera's y axis (every voxel
    behind the camera: none updates), "inside" moved along the
    camera's z axis to put the volume's centre in the image plane (blocks
    straddle z = 0), "border" moved by half the volume along x (the
    image's side cuts the volume)."""
    half = 0.5 * cfg.volume_dims * cfg.voxel_size
    centre = vol2cam[:3, :3] @ torch.full((3,), half, device=vol2cam.device) + vol2cam[:3, 3]
    away = vol2cam.clone()
    away[0] = -vol2cam[0]
    away[2] = -vol2cam[2]
    inside = vol2cam.clone()
    inside[2, 3] -= centre[2]
    border = vol2cam.clone()
    border[0, 3] += half
    return {"tracked": vol2cam, "away": away, "inside": inside, "border": border}


def hold_dense_reference(torch, name, cfg, vol, dists, vol2cam, poses=None, what=""):
    """Kernel F1's tiled design bit for bit against its reference mode (a
    thread a voxel), tsdf and weight, on clones of ``vol`` fused from
    ``dists`` at ``vol2cam`` (and, with ``poses``, at ``dense_poses``');
    with ok false both leave the volume as it is. Returns whether the tiled
    design ran (``kernels.integrate_dense_tiled``)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    on = torch.ones((), dtype=torch.bool, device=dists.device)
    tiled = kernels.integrate_dense_tiled(vol.tsdf, vol.weight)
    held, changed = [], {}
    for tag, pose in (dense_poses(torch, cfg, vol2cam) if poses else {"tracked": vol2cam}).items():
        for ok in (on, ~on):
            vt = TsdfVolume(vol.tsdf.clone(), vol.weight.clone())
            vr = TsdfVolume(vol.tsdf.clone(), vol.weight.clone())
            tsdf_ops.integrate_dense(cfg, vt, dists, pose, cfg.intr, ok)
            tsdf_ops.integrate_dense(cfg, vr, dists, pose, cfg.intr, ok, reference=True)
            held.append(same_volume(torch, vt, vr) and (bool(ok) or same_volume(torch, vt, vol)))
            if bool(ok):
                changed[tag] = int((word_bits(torch, vt.weight) != word_bits(torch, vol.weight)).sum())
    check(name, all(held) and tiled and changed["tracked"] > 0 and changed.get("away", 0) == 0,
          f"{what}{tuple(vol.tsdf.shape)} {vol.tsdf.dtype}/{vol.weight.dtype}, the tiled design "
          f"({'ran' if tiled else 'did NOT run'}): bit-equal to the reference mode at every pose, ok true and false "
          f"{all(held)}; voxels updated by pose {changed}")
    return tiled


def dense_fusion_kernels(torch, report, dev, cfg, st, tr, cf):
    """Phase 2 for kernels F1 and F2 at 256^3 on the preset's phase-2 state
    and the next deforming-scene frame (tracked): F1 at the tracked pose,
    F2 with the incidence confidence and ``fusion_phase_split=2`` (phase
    1), each against its plain version; then, on the same frame and
    volume, F1 against the brick path (K + D) and F2 (no split) against
    D's non-rigid entry (K + D), timed and compared voxel by voxel."""
    import dataclasses

    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.ops import bricks, fusion, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu

    dense = dataclasses.replace(cfg, integrate_mode="dense")
    dists, conf, intr = tr.dists, tr.conf, cfg.intr
    d = cfg.volume_dims
    nvox = d ** 3
    rows, cols = dists.shape
    ok_t = torch.ones((), dtype=torch.bool, device=dev)
    vol2cam = se3.compose(se3.inverse(tr.pose), kinfu._vol_pose(cfg, dev))
    w2c = se3.inverse(tr.pose)
    phase = torch.ones((), dtype=torch.int32, device=dev)
    split2 = dataclasses.replace(dense, fusion_phase_split=2)

    def f1(v, plain):
        if plain:
            return tsdf_ops.integrate_dense_plain(dense, v, dists, vol2cam, intr, ok_t)
        tsdf_ops.integrate(dense, v, dists, vol2cam, intr, ok=ok_t)

    def f2(c):
        lookup = bricks.pack_depth_conf(dists, conf)

        def run(v, plain):
            if plain:
                return fusion.integrate_dense_nonrigid_plain(c, v, cf, lookup, w2c, intr, ok_t, True, phase)
            fusion.integrate_nonrigid(c, v, cf, dists, w2c, intr, ok_t, conf=conf, phase=phase)
        return run

    scratch = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    out = {}
    hold_dense_reference(torch, "integrate_dense_reference", dense, st.vol, dists, vol2cam, poses=True)
    for name, fuse, c, prolong in (("integrate_dense", f1, dense, False),
                                   ("integrate_dense_nonrigid", f2(split2), split2, True)):
        vk, upd, err, frac = hold_dense(torch, name, fuse, st.vol, name)
        n_upd = int(upd.sum())
        # the least work: the updated voxels' codes read and written (8 B),
        # the image (and F2's grid) read once; ~30 operations a voxel's
        # projection (F2: + 4 channels x 7 of the prolongation), ~20 an update
        nbytes = n_upd * 8 + rows * cols * 4 + 48 + (cf.warped.numel() * 4 + cf.q.numel() * 4 if prolong else 0)
        vox = nvox // 2 if prolong else nvox  # F2 projects the phase's half of the x-planes
        flops = vox * (30.0 + (28.0 if prolong else 0.0)) + n_upd * 20.0
        report[name] = dict(
            err=err,
            ms=cuda_ms(torch, lambda: fuse(scratch, False)),
            plain_ms=cuda_ms(torch, lambda: fuse(scratch, True), reps=3),
            bound=bound_ms(nbytes, flops),
            library_ms=None,
        )
        out[name] = (vk, frac)
    r = report["integrate_dense"]
    r["reference_ms"] = cuda_ms(torch, lambda: tsdf_ops.integrate_dense(dense, scratch, dists, vol2cam, intr, ok_t,
                                                                         reference=True))
    print(f"[time] {smi()} | F1 {d}^3: tiled {r['ms']:.4f} ms, reference mode {r['reference_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})", flush=True)
    print(f"[dense] F1 codes differ from the plain version's on {out['integrate_dense'][1]:.2e} of voxels, F2 (split 2) "
          f"on {out['integrate_dense_nonrigid'][1]:.2e}; weights equal in both", flush=True)

    # the dense fusion against the brick path on the same frame and volume
    def rigid(c):
        return lambda: tsdf_ops.integrate(c, scratch, dists, vol2cam, intr, ok=ok_t)

    def nonrigid(c):
        return lambda: fusion.integrate_nonrigid(c, scratch, cf, dists, w2c, intr, ok_t, conf=conf, phase=phase)

    for tag, make in (("rigid", rigid), ("non-rigid", nonrigid)):
        ms = {m: cuda_ms(torch, make(dataclasses.replace(cfg, integrate_mode=m))) for m in ("brick", "dense")}
        ms["brick_2"] = cuda_ms(torch, make(cfg))
        ms["dense_2"] = cuda_ms(torch, make(dense))
        vols = {}
        for m in ("brick", "dense"):
            v = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
            c = dataclasses.replace(cfg, integrate_mode=m)
            if tag == "rigid":
                tsdf_ops.integrate(c, v, dists, vol2cam, intr, ok=ok_t)
            else:
                fusion.integrate_nonrigid(c, v, cf, dists, w2c, intr, ok_t, conf=conf, phase=phase)
            vols[m] = v
        dt_ = (vols["brick"].tsdf.to(torch.int32) - vols["dense"].tsdf.to(torch.int32)).abs()
        dw_ = vols["brick"].weight.to(torch.int32) != vols["dense"].weight.to(torch.int32)
        print(f"[compare] {tag} fusion at {d}^3, {cols}x{rows}, same frame and volume: brick (K + D) "
              f"{ms['brick']:.4f} / {ms['brick_2']:.4f} ms, dense ({'F2' if tag != 'rigid' else 'F1'}) "
              f"{ms['dense']:.4f} / {ms['dense_2']:.4f} ms (two turns each); the two volumes' codes differ on "
              f"{float((dt_ > 0).float().mean()):.3e} of voxels (by more than 1 LSB on "
              f"{float((dt_ > 1).float().mean()):.3e}), weights on {float(dw_.float().mean()):.3e}", flush=True)
    del scratch, out


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


# kernel H's adversarial select inputs (made with numpy from a seed; the
# CPU tests hold the same cases against the JAX package): candidates
# repeating a few cells; NaN and negative coordinates; invalid and covered
# candidates ahead of a valid one in their cell; two distinct cells with
# one hash; equal distances; more kept candidates than slots; the gate
# closed; no free slot; infinite and NaN distances
INSERT_CASES = ("repeated", "nan_negative", "shared_cell", "hash_twins", "ties", "overflow", "gate_closed", "full",
                "nonfinite")


# kernel E's adversarial mutual-nearest inputs (made with numpy from a
# seed; the CPU tests hold the plain version bit for bit against the JAX
# package on the same cases): coordinates on a 1/256 grid, where every
# product and sum of the distance expansion is exact; a quarter of the
# nodes inactive, and nodes at the origin (|n|^2 = 0, active and
# inactive); half the nodes inactive with the candidates around them;
# NaN coordinates, some in rows the caller calls valid; no valid
# candidate; no candidate; a count that is no multiple of a block;
# candidates at equal distances from several nodes
MUTUAL_CASES = ("inactive", "nan", "all_invalid", "empty", "odd", "ties")


def mutual_case(name: str, nc: int, n: int, seed: int = 11) -> dict:
    """One of ``MUTUAL_CASES`` as numpy arrays: positions (n, 3) float32,
    active (n,), cand (nc', 3) float32, valid (nc',) (nc' = nc, but 0 for
    "empty" and nc + 37 for "odd")."""
    rs = np.random.RandomState(seed + MUTUAL_CASES.index(name))
    nc = {"empty": 0, "odd": nc + 37}.get(name, nc)
    grid, centre = 1.0 / 256.0, np.array([0.0, 0.0, 1.0])
    pos = (rs.randint(-64, 64, size=(n, 3)) * grid + centre).astype(np.float32)
    pos[0] = 0.0
    active = rs.rand(n) < 0.75
    active[0] = True
    if n > 1:
        pos[1], active[1] = 0.0, False
    cand = (rs.randint(-72, 72, size=(nc, 3)) * grid + centre).astype(np.float32)
    valid = rs.rand(nc) < 0.8
    if name == "inactive":
        active = rs.rand(n) < 0.5
        near = np.nonzero(~active)[0]
        pick = near[rs.randint(0, len(near), size=nc)]
        cand = (pos[pick] + rs.randint(-3, 4, size=(nc, 3)) * grid).astype(np.float32)
    elif name == "nan":
        rows = rs.rand(nc) < 0.2
        cand[rows, rs.randint(0, 3, size=int(rows.sum()))] = np.nan
        cand[rs.rand(nc) < 0.05] = np.nan
        valid[rows & (rs.rand(nc) < 0.5)] = True  # NaN rows the caller calls valid
    elif name == "all_invalid":
        valid[:] = False
    elif name == "ties":
        axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])
        cand = (pos[rs.randint(0, n, size=nc)] + 2 * grid * axes[rs.randint(0, 6, size=nc)]).astype(np.float32)
        cand[1::7] = cand[::7][: len(cand[1::7])]
    return dict(positions=pos, active=active, cand=cand, valid=valid)


# kernel K's held cases beside the main paths' states: name: (config
# maker, overrides, grid stride (None: the brick size), grid jitter (m)
# standing in for a warp, phase split, camera z shift (m)); "capped" and
# "small_capped_warped": a band cap above the surface band bricks but
# below all band bricks, so the permuted rest of the band fills the cap,
# and a wide cap below the wide bricks ("capped": the camera 0.3 m closer)
PLAN_CASES = {
    "preset_warped": ("default_dynamicfusion", {}, 8, 2e-3, 1, 0.0),
    "preset_rigid_split": ("default_dynamicfusion", dict(fusion_phase_split=2), None, 0.0, 2, 0.0),
    "capped": ("default_dynamicfusion", dict(integrate_band_cap=1300, integrate_wide_cap=8), 8, 2e-3, 1, 0.3),
    "kinfu_warped": ("default_kinfu", {}, 8, 2e-3, 1, 0.0),
    "small_capped_warped": ("small", dict(integrate_band_cap=47, integrate_wide_cap=1), 2, 2e-3, 1, 0.0),
}


def plan_inputs(torch, dev, name, seed: int = 3):
    """(config, dists, camera-frame corner grid, stride, phase, split) of
    ``PLAN_CASES[name]`` on ``dev``: the four-sphere scene at the config's
    own size with seeded sensor noise and a dropout region, the corner
    grid at the stride with seeded jitter, made with numpy."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.ops import preprocess

    maker, kw, stride, jitter, split, near = PLAN_CASES[name]
    cfg = dataclasses.replace(getattr(DynamicFusionConfig, maker)(), **kw)
    g = stride or cfg.brick_size
    pose = synthetic.orbit_pose(0.03, target=TARGET)
    pose[2, 3] += near
    rng = np.random.RandomState(seed)
    d = synthetic.scene_depth(cfg.intr, cfg.rows, cfg.cols, pose, **SCENE).astype(np.int32)
    d = np.where(d > 0, d + rng.randint(-4, 5, d.shape), 0)
    d[cfg.rows // 4: cfg.rows // 2, : cfg.cols // 3] = 0
    dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(d.astype(np.uint16)).to(dev))
    gp = cfg.volume_dims // g + 1
    ax = np.arange(gp, dtype=np.float64) * g * cfg.voxel_size
    world = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1) + np.asarray(cfg.volume_origin)
    w2c = np.linalg.inv(pose)
    cam = world @ w2c[:3, :3].T + w2c[:3, 3] + jitter * rng.randn(gp, gp, gp, 3)
    phase = torch.ones((), dtype=torch.int32, device=dev) if split > 1 else None
    return cfg, dists, torch.from_numpy(cam.astype(np.float32)).to(dev), g, phase, split


def hash_twins(cov: float, seed: int = 0, span: int = 512):
    """Two distinct integer cells whose int32 cell hashes are equal (a
    birthday search over seeded random cells)."""
    rs = np.random.RandomState(seed)
    c = rs.randint(-span, span, size=(1 << 18, 3)).astype(np.int64)
    h = ((c[:, 0] * 73856093) ^ (c[:, 1] * 19349663) ^ (c[:, 2] * 83492791)) & 0xFFFFFFFF
    order = np.argsort(h, kind="stable")
    hs = h[order]
    for d in np.nonzero(hs[1:] == hs[:-1])[0]:
        a, b = c[order[d]], c[order[d + 1]]
        if (a != b).any():
            return a, b
    raise RuntimeError("no two cells with one hash")


def insert_case(name: str, nc: int, cap: int, cov: float = 0.025, seed: int = 7) -> dict:
    """One of ``INSERT_CASES`` as numpy arrays: cand (nc, 3) float32, valid
    (nc,), d2 (nc,) float32 (the squared distance to the nearest node),
    active (cap,), count, gate, cov."""
    rs = np.random.RandomState(seed + INSERT_CASES.index(name))
    cov2 = float(np.float32(cov) * np.float32(cov))
    ncell = {"repeated": max(cap // 3, 1), "overflow": nc}.get(name, max(nc // 3, 1))
    cells = rs.randint(-60, 60, size=(ncell, 3))
    pick = rs.randint(0, ncell, size=nc) if name != "overflow" else rs.permutation(nc) % ncell
    cand = ((cells[pick] + rs.uniform(0.05, 0.95, size=(nc, 3))) * cov).astype(np.float32)
    valid = rs.rand(nc) > 0.1
    d2 = (rs.uniform(1.5, 9.0, size=nc) * cov2).astype(np.float32)
    d2[rs.rand(nc) < 0.25] = np.float32(0.5 * cov2)  # covered
    active = rs.rand(cap) < 0.5
    count, gate = int(active.sum()), True
    if name == "nan_negative":
        cand -= np.float32(4.0)
        rows = rs.rand(nc) < 0.15
        cand[rows, rs.randint(0, 3, size=int(rows.sum()))] = np.nan
        valid[rows & (np.arange(nc) < nc // 2)] = True  # NaN rows the caller calls valid
    elif name == "shared_cell":
        # per cell: an invalid, then a covered, then a valid uncovered candidate
        for j in range(0, nc - 2, 9):
            cand[j + 1] = cand[j + 2] = cand[j]
            valid[j], valid[j + 1], valid[j + 2] = False, True, True
            d2[j + 1], d2[j + 2] = np.float32(0.5 * cov2), np.float32(4.0 * cov2)
    elif name == "hash_twins":
        a, b = hash_twins(cov)
        for j in range(0, nc - 1, 50):
            cand[j] = ((a + 0.5) * cov).astype(np.float32)
            cand[j + 1] = ((b + 0.5) * cov).astype(np.float32)
            valid[j] = valid[j + 1] = True
            d2[j] = d2[j + 1] = np.float32(6.0 * cov2)
    elif name == "ties":
        d2 = (np.array([2.0, 3.0, 5.0], np.float32)[rs.randint(0, 3, size=nc)] * np.float32(cov2)).astype(np.float32)
    elif name == "gate_closed":
        gate = False
    elif name == "full":
        active[:] = True
        count = cap
    elif name == "nonfinite":
        d2[rs.rand(nc) < 0.05] = np.inf
        d2[rs.rand(nc) < 0.05] = np.nan
    return dict(cand=cand, valid=valid, d2=d2, active=active, count=count, gate=gate, cov=cov)


def select_inputs(torch, case: dict, dev):
    """(cfg, field, cand, valid, d2, gate) on ``dev`` for the plain and the
    kernel select of an ``insert_case``."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.models import warpfield

    cap = case["active"].shape[0]
    cfg = dataclasses.replace(DynamicFusionConfig.default_dynamicfusion(), node_coverage=case["cov"], max_nodes=cap)
    field = warpfield.WarpField(
        torch.zeros((cap, 3), device=dev), torch.zeros((cap, 8), device=dev), torch.zeros((cap,), device=dev),
        torch.from_numpy(case["active"]).to(dev), torch.tensor(case["count"], dtype=torch.int32, device=dev),
        torch.zeros((cap,), dtype=torch.int32, device=dev))
    return (cfg, field, torch.from_numpy(case["cand"]).to(dev), torch.from_numpy(case["valid"]).to(dev),
            torch.from_numpy(case["d2"]).to(dev), torch.tensor(case["gate"], device=dev))


def hold_select(torch, name, cfg, field, cand, valid, d2, gate, device_table=False) -> int:
    """Kernel H's select bit for bit against the plain select (slots and
    new positions, NaNs by their bits); returns the kept count k."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models import warpfield

    cap, nc = field.active.shape[0], cand.shape[0]
    kept = torch.zeros((), dtype=torch.int32, device=cand.device)
    slots, new_pos = kernels.insert_select(cand, d2, valid, field.active, field.count, gate, cfg.node_coverage,
                                           device_table=device_table, kept=kept)
    ref = warpfield._insert_select_plain(cfg, field, cand, valid, d2, gate)
    ok = torch.equal(slots, ref.slots) and same_bits(torch, new_pos, ref.new_pos)
    words, in_device, smem = kernels.insert_plan(nc, cap, device_table, cand.device)
    k = int(kept)
    check(name, ok, f"{nc} candidates, k = {k} kept, {cap} slots ({cap - int(field.count)} free), gate "
                    f"{bool(gate)}; table of {words} words in {'device' if in_device else 'shared'} memory "
                    f"({smem} B shared): slots and new positions bit-equal to the plain select "
                    f"({int((slots < cap).sum())} inserted)")
    return k


def hold_select_cases(torch, dev, nc: int, cap: int, names=INSERT_CASES) -> None:
    """``hold_select`` on the adversarial cases at (nc, cap), with the table
    where it fits and in device memory."""
    for name in names:
        cfg, field, cand, valid, d2, gate = select_inputs(torch, insert_case(name, nc, cap), dev)
        for dt in (False, True):
            hold_select(torch, f"insert_select_{name}_{nc}{'_device_table' if dt else ''}", cfg, field, cand, valid,
                        d2, gate, device_table=dt)


def library_insert_select(torch, cfg, field, cand, valid, d2, gate):
    """Kernel H's select as PyTorch calls (a stable sort of the cell ids,
    ``topk`` of the kept candidates' distances, ``nonzero`` of the free
    slots): the yardstick of ``library_ms``; the port never calls it."""
    from dynamicfusion_tpu_torch.models import warpfield

    cov, cap, dev = cfg.node_coverage, field.active.shape[0], cand.device
    cell = warpfield._cell_ids(cand, cov)
    order = torch.sort(cell, stable=True)[1]
    sid = cell[order]
    first = torch.ones_like(valid)
    first[order[1:]] = sid[1:] != sid[:-1]
    keep = first & valid & (d2 > cov * cov)
    k = min(cap, cand.shape[0])
    vals, idx = torch.topk(torch.where(keep, d2, -float("inf")), k)
    sel = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    sel[:k] = torch.where(torch.isfinite(vals), idx, -1)
    nz = torch.nonzero(~field.active).flatten()
    free_idx = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    free_idx[: nz.shape[0]] = nz
    ok = (sel >= 0) & (torch.arange(cap, device=dev) < torch.clamp(cap - field.count, min=0)) & gate
    return torch.where(ok, free_idx, cap), cand[sel.clamp(min=0)]


def library_icp(torch, intr, t_cur, cp, cn, pp, pn, dist2, min_cos):
    """Kernel B's system as PyTorch calls: the plain rows and one
    ``torch.mm`` of [J | r]ᵀ J (the JAX package's einsum): the yardstick of
    ``library_ms``; the port never calls it."""
    from dynamicfusion_tpu_torch.solvers import icp

    row, rhs = icp._rows_plain(intr, t_cur, cp, cn, pp, pn, dist2, min_cos)
    m = torch.mm(torch.cat([row, rhs[:, None]], dim=1).T, row)
    return m[:6], m[6]


def hold_icp(torch, report, name, intr, t_cur, cp, cn, pp, pn, dist2, min_cos, nbytes, what=""):
    """Kernel B (one launch) within TOL_ICP_REL of the plain system, bit
    for bit against its two-pass mode, zeros when inactive and the ticket
    back at zero; timed beside the two-pass mode, the plain version and
    ``library_icp``."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.solvers import icp

    args = (intr, t_cur, cp, cn, pp, pn, dist2, min_cos)
    ak, bk = icp._build_system(*args)
    ap_, bp_ = icp._build_system_plain(*args)
    a2, b2 = kernels.icp_build_system(*args, two_pass=True)
    off = kernels.icp_build_system(*args, active=torch.zeros((), dtype=torch.bool, device=t_cur.device))
    torch.cuda.synchronize()
    scale = float(torch.maximum(ap_.abs().max(), bp_.abs().max()))
    err = float(torch.maximum((ak - ap_).abs().max(), (bk - bp_).abs().max()))
    check(name, err <= TOL_ICP_REL * scale and scale > 0,
          f"{what}max |diff| {err:.3e} over max |entry| {scale:.3e} (rel tol {TOL_ICP_REL})")
    ticket = int(kernels._ticket(t_cur.device))
    check(f"{name}_order", same_bits(torch, ak, a2) and same_bits(torch, bk, b2)
          and not bool(off[0].any()) and not bool(off[1].any()) and ticket == 0,
          f"one launch bit-equal to the two-pass mode, A symmetric {bool(torch.equal(ak, ak.T))}; inactive "
          f"zeros; ticket back at {ticket}")
    npx = cp.shape[0] * cp.shape[1]
    report[name] = dict(
        err=err,
        ms=cuda_ms(torch, lambda: kernels.icp_build_system(*args)),
        plain_ms=cuda_ms(torch, lambda: icp._build_system_plain(*args)),
        # ~100 float operations a pixel (transform, projection, gates, 27 products)
        bound=bound_ms(nbytes, npx * 100.0),
        library_ms=cuda_ms(torch, lambda: library_icp(torch, *args)),
    )
    two = cuda_ms(torch, lambda: kernels.icp_build_system(*args, two_pass=True))
    print(f"[time] {name}: one launch {report[name]['ms']:.4f} ms, two-pass mode {two:.4f} ms, library "
          f"{report[name]['library_ms']:.4f} ms, plain {report[name]['plain_ms']:.4f} ms", flush=True)


def kernels_a_call(name, fn):
    """(fn's result, the device kernels the C entry of wrapper ``name``
    reported launching in it: ``kernels.device_kernels``)."""
    from dynamicfusion_tpu_torch import kernels

    before = kernels.device_kernels[name]
    out = fn()
    return out, kernels.device_kernels[name] - before


# the device kernels a call of each wrapper whose C entry reports them
# (``kernels.device_kernels``): G's edge term and E's mutual-nearest pass
# one launch, K's plan the mip tiles and the cluster, D's fuse one, L's
# extraction the count with its scan and the write, G's spd6_inv (either
# entry), I's frame maps and I's pyramid (every level) one, M's gate two
# (the features and the clusters)
DEVICE_KERNELS_A_CALL = {"pcg_sharded": 1, "insert_apply": 1, "edge_term": 1, "mutual_nearest": 1, "brick_plan": 2,
                         "fuse_bricks": 1, "extract_cloud": 2,
                         "spd6_inv": 1, "frame_maps": 1, "depth_pyramid": 1, "p2p_gate": 2}


def hold_spd6(torch, name, blocks, diag_eff, unit, lam, what="", timed=False):
    """Kernel G's damped entry bit for bit (NaNs alike) against the
    composition it replaced in the LM loop (damp = lambda diag_eff + unit,
    the reference mode's inverse of blocks + diag_embed(damp), kept by
    ``where(rebuild, ., minv)``) with rebuild true and false, the last
    result the inverse at 8 lambda; the undamped entry against the
    reference mode on the same damped blocks; one device kernel a call.
    With ``timed``: (the damped entry's ms, the composition's ms, the
    entry's ms with rebuild false)."""
    from dynamicfusion_tpu_torch import kernels

    n, dev = blocks.shape[0], blocks.device
    lm = torch.full((), lam, dtype=torch.float32, device=dev)
    last = kernels.spd6_inv(blocks + torch.diag_embed((lm * 8.0 * diag_eff + unit).reshape(n, 6)), reference=True)
    flags = {r: torch.full((), r, dtype=torch.bool, device=dev) for r in (True, False)}

    def composition(flag, minv):
        damp = lm * diag_eff + unit
        fresh = kernels.spd6_inv(blocks + torch.diag_embed(damp.reshape(n, 6)), reference=True)
        return damp, torch.where(flag, fresh, minv)

    parts, calls = {}, []
    for r, flag in flags.items():
        minv = last.clone()
        damp, k = kernels_a_call("spd6_inv", lambda: kernels.spd6_inv_damped(blocks, diag_eff, unit, lm, flag, minv))
        rd, rm = composition(flag, last)
        parts[f"rebuild {r}"] = same_bits(torch, damp, rd) and same_bits(torch, minv, rm)
        calls.append(k)
    m = blocks + torch.diag_embed((lm * diag_eff + unit).reshape(n, 6))
    tile, k = kernels_a_call("spd6_inv", lambda: kernels.spd6_inv(m))
    parts["undamped"] = same_bits(torch, tile, kernels.spd6_inv(m, reference=True))
    calls.append(k)
    bad = int((~torch.isfinite(tile).all(-1).all(-1)).sum())
    check(name, all(parts.values()) and calls == [1, 1, 1],
          f"{what}{n} nodes at lambda {lam:.1e} ({bad} non-finite inverses): bit for bit against the composition "
          f"(glue, the reference mode, where) {parts}; device kernels a call {calls}")
    if not timed:
        return None
    scratch = last.clone()
    return (cuda_ms(torch, lambda: kernels.spd6_inv_damped(blocks, diag_eff, unit, lm, flags[True], scratch)),
            cuda_ms(torch, lambda: composition(flags[True], last)),
            cuda_ms(torch, lambda: kernels.spd6_inv_damped(blocks, diag_eff, unit, lm, flags[False], scratch)))


def hold_spd6_undamped(torch, name, m, what=""):
    """Kernel G's undamped entry bit for bit (NaNs alike) against its
    reference mode, one device kernel a call."""
    from dynamicfusion_tpu_torch import kernels

    out, k = kernels_a_call("spd6_inv", lambda: kernels.spd6_inv(m))
    same = same_bits(torch, out, kernels.spd6_inv(m, reference=True))
    check(name, same and k == 1, f"{what}{m.shape[0]} blocks: bit for bit against the reference mode {same}, "
                                 f"{k} device kernel a call")


def hold_maps(torch, name, tasks, what=""):
    """Kernel I's multi-map entry bit for bit (NaNs alike) against the
    single-map kernel (its reference mode) at every task: each map a task
    asks for, None for the others; one device kernel a call (up to
    ``kernels.MAP_TASKS`` tasks)."""
    from dynamicfusion_tpu_torch import kernels

    outs, k = kernels_a_call("frame_maps", lambda: kernels.frame_maps(tasks))
    parts = []
    for t, (p, n, c) in zip(tasks, outs):
        rp, rn, rc = kernels.points_normals(t.depth, t.intr, t.stride, normals=t.normals, conf=t.conf)
        parts.append((same_bits(torch, p, rp) if t.points else p is None) and same_bits(torch, n, rn)
                     and same_bits(torch, c, rc))
    shapes = ", ".join(f"{t.depth.shape[1] // t.stride}x{t.depth.shape[0] // t.stride}/{t.stride}"
                       f"{'p' if t.points else ''}{'n' if t.normals else ''}{'c' if t.conf else ''}" for t in tasks)
    want = -(-len(tasks) // kernels.MAP_TASKS)
    check(name, all(parts) and k == want,
          f"{what}{len(tasks)} tasks ({shapes}): bit for bit against the single-map kernel {parts}; {k} device "
          f"kernels a call (want {want})")
    return outs


def hold_step_maps(torch, name, cfg, depth):
    """``hold_maps`` at every task of one frame of ``cfg``'s step: ``track``'s
    maps (``kinfu.track_maps``), or the rigid step's from ``raycast_shift``,
    on the kernel path's pyramid of ``depth``."""
    from dynamicfusion_tpu_torch.ops import preprocess
    from dynamicfusion_tpu_torch.pipeline import kinfu

    d = depth if isinstance(depth, torch.Tensor) else torch.from_numpy(np.asarray(depth))
    d = d.to(torch.device("cuda"))
    maps = dict(first_point_level=cfg.raycast_shift) if cfg.rigid_only else kinfu.track_maps(cfg)
    pyr = preprocess.build_frame_pyramid(cfg, d, **maps)
    tasks, _ = preprocess.pyramid_map_tasks(cfg, pyr[0], d, **maps)
    return hold_maps(torch, name, tasks, f"{cfg.cols}x{cfg.rows}, shift {cfg.raycast_shift}: ")


def same_plan(torch, a, b) -> bool:
    """Two brick plans alike bit for bit: classes, windows, surface flags
    and the work list (ids, kinds, count, counts)."""
    return all(torch.equal(x, y) for x, y in zip(a.classes, b.classes)) and all(
        torch.equal(x, y) for x, y in zip(a.work, b.work))


def same_volume(torch, a, b) -> bool:
    return same_bits(torch, a.tsdf, b.tsdf) and same_bits(torch, a.weight, b.weight)


def hold_plan(torch, name, cfg, dists, grid, g, phase=None, split=1, slab=None, what=""):
    """Kernel K (the cluster) bit for bit against its plain version and its
    one-block mode: classes, windows, surface flags and the work list; two
    device kernels a call in either mode (``kernels_a_call``); the gated
    call (ok false) gives count 0 and counts (0, 0, 0) in both modes and in
    the plain version. ``slab``: ``plan_slab``'s (x_brick0, band_cap,
    wide_cap). Returns (the plan, the one-block mode's ms, a gated call's
    ms)."""
    from dynamicfusion_tpu_torch.ops import bricks

    def run(**kw):
        if slab is None:
            return bricks.plan(cfg, dists, grid, g, cfg.intr, phase, split, **kw)
        return bricks.plan_slab(cfg, dists, grid, g, cfg.intr, *slab, phase, split, **kw)

    pk, k_new = kernels_a_call("brick_plan", run)
    p1, k_one = kernels_a_call("brick_plan", lambda: run(reference=True))
    exact = same_plan(torch, pk, run(plain=True)) and same_plan(torch, pk, p1)
    on = torch.ones((), dtype=torch.bool, device=dists.device)
    off = torch.zeros_like(on)
    zero = all(int(b.work.count[0]) == 0 and b.work.counts.tolist() == [0, 0, 0]
               for b in (run(ok=off), run(ok=off, reference=True), run(ok=off, plain=True)))
    c = pk.classes
    n_hi = int(((c.cls == bricks.BAND) & c.surf).sum())
    check(name, exact and zero and (k_new, k_one) == (2, 2),
          f"{what}{c.cls.shape[0]} bricks (skip, front, band, wide) {torch.bincount(c.cls, minlength=4).tolist()}, "
          f"{n_hi} surface band bricks, a list of {int(pk.work.count[0])}, counts {pk.work.counts.tolist()}: the "
          f"cluster equals the plain version and the one-block mode bit for bit {exact}; ok false gives count 0 "
          f"and counts 0 in each {zero}; device kernels a call {k_new} (one-block mode {k_one})")
    return pk, cuda_ms(torch, lambda: run(ok=on, reference=True)), cuda_ms(torch, lambda: run(ok=off))


def hold_fuse(torch, name, cfg, vol, lookup, grid, g, bp, q_grid=None, packed=False, what=""):
    """Kernel D (the persistent grid) bit for bit against its reference
    mode (a block a slot) on clones of ``vol``: the persistent kernel
    launched (a compiled (b, g), aligned volumes), one device kernel a call
    in either mode, the volume changed; then a gated call (ok false) in
    each mode leaves the volume as it is. Returns (the reference mode's
    ms, its gated ms, the persistent kernel's gated ms)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.ops import bricks

    on = torch.ones((), dtype=torch.bool, device=lookup.device)
    off = torch.zeros_like(on)

    def clone(v):
        return TsdfVolume(v.tsdf.clone(), v.weight.clone())

    def fuse(v, ok, reference=False):
        bricks.fuse(cfg, v, lookup, grid, g, cfg.intr, bp, ok, q_grid, packed, reference=reference)

    vk, vr = clone(vol), clone(vol)
    persistent = kernels.fuse_bricks_persistent(vk.tsdf, vk.weight, cfg.brick_size, g)
    _, k_new = kernels_a_call("fuse_bricks", lambda: fuse(vk, on))
    _, k_ref = kernels_a_call("fuse_bricks", lambda: fuse(vr, on, True))
    same, changed = same_volume(torch, vk, vr), not same_volume(torch, vk, vol)
    before = clone(vk)
    fuse(vk, off)
    fuse(vr, off, True)
    gated = same_volume(torch, vk, before) and same_volume(torch, vr, before)
    check(name, persistent and same and changed and gated and (k_new, k_ref) == (1, 1),
          f"{what}{vol.tsdf.dtype}/{vol.weight.dtype} {tuple(vol.tsdf.shape)}, {int(bp.work.count[0])} listed "
          f"bricks, stride {g}: the persistent kernel ({persistent}) equals the reference mode bit for bit {same}, "
          f"the volume changed {changed}; ok false leaves it as it is in both {gated}; device kernels a call "
          f"{k_new} (reference {k_ref})")
    del vk, vr, before
    scratch = clone(vol)
    return (cuda_ms(torch, lambda: fuse(scratch, on, True)), cuda_ms(torch, lambda: fuse(scratch, off, True)),
            cuda_ms(torch, lambda: fuse(scratch, off)))


def edge_args(cfg, s, dq):
    return (dq, s.e_src, s.e_dst, s.e_valid, s.v_dst, s.alpha, s.edges_by_dst.order, s.edges_by_dst.off,
            cfg.solver_arap_weight, cfg.solver_huber_delta)


def hold_edge_order(torch, name, cfg, s, dq, what=""):
    """Kernel G's edge term (one launch) bit for bit against its
    three-launch mode in all six outputs (Jᵀr, cost, h_ii, h_jj, h_ij, the
    diagonal share); one device kernel a call against three
    (``kernels_a_call``); the ticket back at zero. Returns the three-launch
    mode's time."""
    from dynamicfusion_tpu_torch import kernels

    args = edge_args(cfg, s, dq)
    one, k1 = kernels_a_call("edge_term", lambda: kernels.edge_term(*args))
    three, k3 = kernels_a_call("edge_term", lambda: kernels.edge_term(*args, three_launch=True))
    same = [same_bits(torch, a, b) for a, b in zip(one, three)]
    ticket = int(kernels._ticket(dq.device))
    check(name, all(same) and (k1, k3) == (1, 3) and ticket == 0,
          f"{what}{s.e_src.shape[0]} edges, {dq.shape[0]} nodes: one launch bit-equal to the three-launch mode in "
          f"(Jᵀr, cost, h_ii, h_jj, h_ij, diag) {same}; device kernels a call {k1} (three-launch mode {k3}); "
          f"ticket back at {ticket}")
    return cuda_ms(torch, lambda: kernels.edge_term(*args, three_launch=True))


def library_mutual_nearest(torch, field, cand, valid):
    """Kernel E's mutual-nearest pass as PyTorch calls (one ``torch.addmm``
    of the expansion, then the two masked ``amin``s): the yardstick of
    ``library_ms``; the port never calls it."""
    q = torch.nan_to_num(cand)
    pos = field.positions
    nn = (pos * pos).sum(1) + torch.where(field.active, 0.0, 1e9)
    d2 = torch.addmm(nn[None, :] + (q * q).sum(1, keepdim=True), q, pos.T, alpha=-2.0)
    return d2.amin(1).clamp(min=0.0), torch.where(valid[:, None], d2, 1e9).amin(0).clamp(min=0.0)


def hold_mutual(torch, report, name, field, cand, valid, what=""):
    """Kernel E's mutual-nearest pass (one launch) bit for bit against the
    plain version and the three-launch mode; one device kernel a call
    against three (two without a candidate: ``kernels_a_call``); the ticket
    back at zero, the node scratch back at 1e9; with ``report``, timed beside the
    three-launch mode, the plain version and ``library_mutual_nearest``
    (held within TOL_D2 on the active nodes)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models import warpfield

    args = (field.positions, field.active, cand, valid)
    (ck, nk), k1 = kernels_a_call("mutual_nearest", lambda: kernels.mutual_nearest(*args))
    cp, npl = warpfield.mutual_nearest(field, cand, valid, plain=True)
    (c3, n3), k3 = kernels_a_call("mutual_nearest", lambda: kernels.mutual_nearest(*args, three_launch=True))
    n, nc = field.positions.shape[0], cand.shape[0]
    same = (same_bits(torch, ck, cp) and same_bits(torch, nk, npl), same_bits(torch, ck, c3) and same_bits(torch, nk, n3))
    dev = cand.device
    rest = bool((kernels._node_bits(dev, n) == kernels._BIG_BITS).all())
    ticket = int(kernels._ticket(dev))
    check(name, all(same) and (k1, k3) == (1, 3 if nc else 2) and rest and ticket == 0,
          f"{what}{nc} candidates ({int(valid.sum())} valid) x {n} nodes ({int(field.active.sum())} active): "
          f"bit-equal to the plain version {same[0]} and to the three-launch mode {same[1]}; nodes at 1e9 (no "
          f"valid candidate, or inactive) {int((nk == 1e9).sum())}; device kernels a call {k1} (three-launch mode "
          f"{k3}); node scratch back at 1e9 {rest}, ticket back at {ticket}")
    if report is None:
        return
    lc, ln = library_mutual_nearest(torch, field, cand, valid)
    act = field.active
    lerr = max(abs_err(torch, lc, cp), abs_err(torch, ln[act], npl[act]))
    check(f"{name}_library", lerr <= TOL_D2, f"library route within {lerr:.2e} of plain (tol {TOL_D2})")
    report[name] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.mutual_nearest(*args)),
        plain_ms=cuda_ms(torch, lambda: warpfield.mutual_nearest(field, cand, valid, plain=True), reps=5),
        # nodes and flags, candidates and flags in; both distance lists out;
        # ~11 operations a (candidate, node) pair
        bound=bound_ms(n * 13 + nc * 13 + (nc + n) * 4, nc * n * 11.0),
        library_ms=cuda_ms(torch, lambda: library_mutual_nearest(torch, field, cand, valid)),
    )
    three = report[name]["reference_ms"] = cuda_ms(torch, lambda: kernels.mutual_nearest(*args, three_launch=True))
    print(f"[time] {name}: one launch {report[name]['ms']:.4f} ms, three-launch mode {three:.4f} ms, library "
          f"{report[name]['library_ms']:.4f} ms, plain {report[name]['plain_ms']:.4f} ms", flush=True)


def hold_mutual_cases(torch, dev, nc: int, n: int) -> None:
    """``hold_mutual`` on the adversarial ``MUTUAL_CASES`` at (nc, n)."""
    from dynamicfusion_tpu_torch.models import warpfield

    for name in MUTUAL_CASES:
        case = mutual_case(name, nc, n)
        act = torch.from_numpy(case["active"]).to(dev)
        field = warpfield.WarpField(
            torch.from_numpy(case["positions"]).to(dev), torch.zeros((n, 8), device=dev),
            torch.full((n,), 0.05, device=dev), act, act.sum(dtype=torch.int32),
            torch.zeros((n,), dtype=torch.int32, device=dev))
        hold_mutual(torch, None, f"mutual_nearest_{name}_{nc}", field, torch.from_numpy(case["cand"]).to(dev),
                    torch.from_numpy(case["valid"]).to(dev))


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
    hold_data_order(torch, "data_term_tangential_order", cfg, s, field.dq)
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
    hold_pcg(torch, report, "pcg_tangential", s, sysm, ip, b, cfg.solver_linear_iters, cfg.solver_linear_tol,
             f"up to {cfg.solver_linear_iters} iterations over 6N = {6 * n}, {npt} x 3 rows")


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
        npt = s.p_can.shape[0]
        lists_b = (npt * 8 + n + 1) * 4
        hold_data_order(torch, f"data_term_{tag}_order", mcfg, s, field.dq, row_stride=stride)
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
        hold_pcg(torch, report, f"pcg_{tag}", s, sysm, ip, b, mcfg.solver_linear_iters, mcfg.solver_linear_tol,
                 f"up to {mcfg.solver_linear_iters} iterations over 6N = {6 * n}, rows used {used or 3}, stride "
                 f"{stride}", timed=tag != "stride2")


def refine_work(cfg):
    """(corner gathers, operations) of kernel C's refine a hit under
    ``cfg``: secant two values and a fused fetch (24), newton8 one fused
    fetch (8), newton16 and hybrid16 two (16); the six-sample normal adds
    six trilinear values (48) and takes the secant's fused fetch away."""
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    refine = tsdf_ops._refine_mode(cfg)
    gathers, ops = {0: (24, 250.0), 1: (8, 120.0), 2: (16, 220.0), 3: (16, 260.0)}[refine]
    if cfg.raycast_smooth_normals:
        gathers, ops = gathers + 48 - (8 if refine == 0 else 0), ops + 6 * 40.0 - (100.0 if refine == 0 else 0.0)
    return gathers, ops


# the raycast variants held in phase 2 (R1, R2): (row suffix, refine,
# six-sample normal); each also runs on a path (phases 13-14)
RAYCAST_VARIANTS = (("newton16", "newton16", False), ("hybrid16", "hybrid16", False),
                    ("grad6_secant", "secant", True), ("grad6_newton8", "newton8", True),
                    ("grad6_newton16", "newton16", True), ("grad6_hybrid16", "hybrid16", True))


def hold_raycast(torch, report, name, cfg, tsdf, rays, exact_found=False, exact=False):
    """Kernel C against its plain version on the same rays (hit/miss, vertex
    and normal), timed, with its bound for this run's march: the samples
    the rays take plus the refine's corner loads a hit (``refine_work``),
    at the tsdf's width. ``exact_found``: the hit mask must equal the
    plain version's on every ray; ``exact``: the hits' vertices and normals
    too, bit for bit."""
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
    found_tol = 0.0 if exact_found or exact else TOL_RAYCAST_FOUND_FRAC
    tol_m, tol_n = (0.0, 0.0) if exact else (TOL_RAYCAST_M, TOL_RAYCAST_NORMAL)
    mode = f"{cfg.raycast_refine}{', six-sample normal' if cfg.raycast_smooth_normals else ''}"
    check(name, found_frac <= found_tol and err <= tol_m and nan_same and nerr <= tol_n and int(fk.sum()) > 0,
          f"{str(tsdf.dtype)[6:]} tsdf, {dirs.shape[1]}x{dirs.shape[0]} ({mode}): hit/miss differs on "
          f"{found_frac:.2e} of rays (tol {found_tol}), max vertex diff {err:.3e} m (tol {tol_m}), max normal diff "
          f"{nerr:.3e} (tol {tol_n}), NaN normals alike {nan_same}; {int(fk.sum())} of {fk.numel()} rays hit")
    hits = int(fk.sum())
    gathers, ops = refine_work(cfg)
    n_samples = march_samples(torch, cfg, tsdf, ray_org, dirs, tmin, tmax) + gathers * hits
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    refine = tsdf_ops._refine_mode(cfg)
    report[name] = dict(
        err=max(err, nerr),
        ms=cuda_ms(torch, lambda: kernels.march_and_refine(
            tsdf, ray_org, dirs, tmin, tmax, cfg.voxel_size, step, tsdf_ops.march_steps(cfg),
            cfg.raycast_adaptive_step, refine=refine, smooth=cfg.raycast_smooth_normals,
            delta=cfg.gradient_delta_factor)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.march_and_refine_plain(cfg, tsdf, ray_org, dirs, tmin, tmax), reps=3),
        # the samples (the march, the refine's corners) at the tsdf's width,
        # the rays in, found/vertex/normal out; ~12 operations a sample, the
        # refine's a hit
        bound=bound_ms(n_samples * tsdf.element_size() + fk.numel() * (12 + 8 + 1 + 24),
                       n_samples * 12.0 + hits * ops),
        library_ms=None,
    )
    return fk


def hold_raycast_variants(torch, report, prefix, cfg, tsdf, rays):
    """Kernel C's refine codes 2 and 3 and its six-sample normal mode on
    every refine (``RAYCAST_VARIANTS``), each against its plain version on
    the same rays, the hit mask exact."""
    import dataclasses

    for suffix, refine, smooth in RAYCAST_VARIANTS:
        hold_raycast(torch, report, f"{prefix}_{suffix}",
                     dataclasses.replace(cfg, raycast_refine=refine, raycast_smooth_normals=smooth), tsdf, rays,
                     exact_found=True)


def gate_inputs(torch, cfg, st, tr):
    """Kernel M's inputs as ``track`` builds them from the state before a
    step and its tracking: the filtered live points and normals at the ICP
    pose, the previous warped model map (world frame), the live depth."""
    from dynamicfusion_tpu_torch.core import se3

    s = cfg.raycast_shift
    pose = torch.where(tr.icp_res.ok, se3.compose(st.pose, tr.icp_res.transform), st.pose)
    return (se3.transform_points(pose, tr.points[s]).contiguous(), se3.rotate_dirs(pose, tr.normals[s]).contiguous(),
            se3.transform_points(st.pose, st.prev_points[0]).contiguous(), tr.points[s][..., 2].contiguous())


# kernel M's inputs made with numpy (``gate_case``): (rows, cols) of each;
# "qvga" and "vga" are the model maps of raycast_subsample 2 and 1 (the
# cluster design at 240 and 480 rows); "tall" has more rows than the
# cluster design takes (553: its reference mode runs)
GATE_CASES = {"random": (120, 160), "sphere": (120, 160), "bin_edges": (120, 160), "holes": (120, 160),
              "all_bins": (120, 160), "single_pixel_bin": (120, 160), "narrow": (60, 12), "wide": (48, 1000),
              "tall": (600, 16), "qvga": (240, 320), "vga": (480, 640)}


def gate_case(name: str, seed: int = 0):
    """Kernel M's inputs for a case of ``GATE_CASES`` as float32 numpy
    arrays (live points, live normals, previous model points, live depth),
    the camera frame as the world frame: "random" depths over every bin
    with holes; "sphere" a sphere translating over a plane (its windows
    open the gate part way); "bin_edges" 8x8 patches at depths on the bin
    edges and one ulp beside them; "holes" NaN depths and points, NaN and
    infinite normals, infinite motions; "all_bins" 16 bands of rows, one a
    bin; "single_pixel_bin" a plane in one bin with a pixel alone in
    another at the centre and one in a corner; "narrow" a map narrower than
    the window and "tall" 600 rows (depths in three bins); "wide" 1 000
    columns; "qvga" 320x240 and "vga" 640x480 as "random". But
    for the sphere, the points move by a common translation and noise."""
    rows, cols = GATE_CASES[name]
    rng = np.random.RandomState(seed)
    u, v = np.meshgrid(np.arange(cols) - cols / 2, np.arange(rows) - rows / 2)
    f = 570.342 / 4

    def unit(n):
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    nrm = unit(rng.randn(rows, cols, 3) * 0.3 + np.array([0.0, 0.0, -1.0]))
    if name == "sphere":
        r, z0 = 0.12, 0.9
        x, y = u * z0 / f, v * z0 / f
        on = x * x + y * y < (r * 0.95) ** 2
        zs = z0 - np.sqrt(np.maximum(r * r - x * x - y * y, 1e-9))
        prev = np.stack([x, y, np.where(on, zs, 1.3)], -1)
        nrm = np.where(on[..., None], np.stack([x / r, y / r, (zs - z0) / r], -1), np.array([0.0, 0.0, -1.0]))
        live = prev + np.where(on[..., None], np.array([0.005, 0.0, 0.0]), 0.0)
    else:
        if name in ("random", "wide", "holes", "qvga", "vga"):
            z = rng.uniform(0.1, 2.2, (rows, cols))
        elif name in ("narrow", "tall"):
            z = rng.uniform(0.7, 0.9, (rows, cols))
        elif name == "bin_edges":
            k = rng.randint(0, 17, (rows // 8 + 1, cols // 8 + 1)).astype(np.float32)
            edge = np.float32(0.3) + np.float32(0.1) * k
            z = np.kron(edge, np.ones((8, 8), np.float32))[:rows, :cols]
            step = rng.randint(-1, 2, (rows, cols))
            z = np.where(step < 0, np.nextafter(z, np.float32(0)), np.where(step > 0, np.nextafter(z, np.float32(9)), z))
        elif name == "all_bins":
            z = 0.3 + 0.1 * (np.arange(rows)[:, None] // 7 % 16) + 0.05 + rng.uniform(-0.01, 0.01, (rows, cols))
        else:  # single_pixel_bin
            z = np.full((rows, cols), 0.65) + rng.uniform(-0.01, 0.01, (rows, cols))
            z[rows // 2, cols // 2] = 1.25
            z[0, cols - 1] = 2.05
        z = z.astype(np.float32)
        prev = np.stack([u / f * z, v / f * z, z], -1)
        # a coherent motion with noise: the gate opens part way
        live = prev + np.array([0.004, -0.002, 0.003]) + rng.normal(0, 0.002, (rows, cols, 3))
    if name in ("random", "holes", "narrow", "wide", "tall", "qvga", "vga"):
        hole = rng.rand(rows, cols) < 0.05
        prev[hole] = np.nan
        live[hole] = np.nan
        nrm[rng.rand(rows, cols) < 0.03] = np.nan
    if name == "holes":
        nrm[rng.rand(rows, cols) < 0.03] = np.inf
        nrm[rng.rand(rows, cols) < 0.02, 1] = -np.inf
        live[rng.rand(rows, cols) < 0.02] = np.inf
    live = live.astype(np.float32)
    cam_z = live[..., 2].copy()
    if name == "bin_edges":
        cam_z = z  # the depth on the edges exactly, the points moved by the noise
    return (live, nrm.astype(np.float32), prev.astype(np.float32), cam_z)


class GateHold(NamedTuple):
    gate: object          # the kernel's gate
    bins: object          # its depth bins
    bins_same: bool       # bins equal the plain version's
    err: float            # max |gate - plain gate|
    n_diff: int           # pixels whose gate is not bit-equal to the plain version's
    n_part: int           # pixels with the gate strictly between 0 and 1
    ref_same: bool        # gate and bins bit-equal to the reference mode's
    n_dev: int            # device kernels of the call
    n_ref: int            # device kernels of the reference mode's call


def hold_gate(torch, cfg, gin) -> GateHold:
    """Kernel M against its plain version and its reference mode (the
    two-launch design before) on ``gin``."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    (gk, bins), n_dev = kernels_a_call("p2p_gate", lambda: kinfu.p2p_gate_kernel(cfg, *gin))
    (gr, br), n_ref = kernels_a_call("p2p_gate", lambda: kinfu.p2p_gate_kernel(cfg, *gin, reference=True))
    gp = kinfu.p2p_gate(cfg, *gin, plain=True)
    bins_same = torch.equal(bins.long(), kinfu.gate_bins(gin[3]))
    same = gk.view(torch.int32) == gp.view(torch.int32)
    err = torch.where(same, 0.0, torch.nan_to_num((gk - gp).abs(), nan=float("inf")))
    return GateHold(gk, bins, bins_same, float(err.max()), int((~same).sum()), int(((gk > 0) & (gk < 1)).sum()),
                    same_bits(torch, gk, gr) and torch.equal(bins, br), n_dev, n_ref)


def gate_held(h: GateHold) -> bool:
    """A hold that passed: bins equal, the gate bit-equal to the plain
    version's and to the reference mode's, two device kernels a call in
    either mode."""
    return h.bins_same and h.err <= TOL_GATE and h.n_diff == 0 and h.ref_same and (h.n_dev, h.n_ref) == (2, 2)


def library_p2p_gate(torch, cfg, live, nrm, prev, cam_z):
    """Kernel M in PyTorch calls, its yardstick (the port never calls it):
    the plain version's one-hot features (b as a ``sum``), the box sums as
    two ``F.avg_pool2d(..., divisor_override=1)`` calls over the 176
    channels, along W and then along H, the three-bin gather and the
    closed form (``kinfu._gate_closed_form``)."""
    import torch.nn.functional as F

    from dynamicfusion_tpu_torch.pipeline import kinfu

    w = cfg.solver_p2p_gate_window
    lo, hi = (w - 1) // 2, w - 1 - (w - 1) // 2
    rows, cols = cam_z.shape
    nb, nc = kinfu.GATE_BINS, kinfu.GATE_CHANNELS
    delta = live - prev
    valid = torch.isfinite(delta).all(-1) & torch.isfinite(nrm).all(-1)
    n = torch.where(valid[..., None], torch.nan_to_num(nrm), 0.0)
    b = torch.where(valid, (n * torch.nan_to_num(delta)).sum(-1), 0.0)
    nx, ny, nz = n.unbind(-1)
    feats = torch.stack([valid.to(torch.float32), nx * nx, ny * ny, nz * nz, nx * ny, nx * nz, ny * nz, nx * b,
                         ny * b, nz * b, b * b], -1)
    zb = kinfu.gate_bins(cam_z)
    oh = F.one_hot(zb, nb).to(torch.float32) * valid[..., None]
    x = (oh[..., :, None] * feats[..., None, :]).reshape(rows, cols, nb * nc).permute(2, 0, 1)[None]
    x = F.avg_pool2d(F.pad(x, (lo, hi, 0, 0)), (1, w), stride=1, divisor_override=1)
    x = F.avg_pool2d(F.pad(x, (0, 0, lo, hi)), (w, 1), stride=1, divisor_override=1)
    sb = x[0].permute(1, 2, 0).reshape(rows, cols, nb, nc)
    nbr = zb[..., None] + torch.arange(-1, 2, device=zb.device)
    got = torch.gather(sb, 2, nbr.clamp(0, nb - 1)[..., None].expand(rows, cols, 3, nc))
    s = (got * ((nbr >= 0) & (nbr < nb))[..., None]).sum(2)
    return kinfu._gate_closed_form(cfg, s)


def library_gate_err(torch, cfg, gin) -> float:
    """max |library gate - plain gate| on ``gin``."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    return float((library_p2p_gate(torch, cfg, *gin) - kinfu.p2p_gate(cfg, *gin, plain=True)).abs().max())


def gate_kernels(torch, report, dev, st, tr):
    """Phase 2 for kernel M under the adaptive-gate configuration
    (``quality_dynamicfusion()`` with ``solver_p2p_adaptive``) on the
    preset's phase-2 state: the gate of the next frame as ``track`` makes
    it (the filtered live surface at the ICP pose against the previous
    warped model map, 160x120), depth bins and gate held bit for bit to the
    plain version and to the reference mode (the design before), two
    device kernels a call in either mode. Some pixels must open the gate
    part way, so that the closed form is exercised, not only the empty
    windows' zeros (phase 6 holds M again on every state of the hinge and
    the bulge). Then the same on ``GATE_CASES`` (the reference mode alone
    on "tall", past the cluster's rows), and the library route within
    TOL_GATE_LIBRARY of the plain version; the cluster, the reference mode,
    the library route and the plain version timed."""
    import dataclasses

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = dataclasses.replace(DynamicFusionConfig.quality_dynamicfusion(), solver_p2p_adaptive=True)
    gin = gate_inputs(torch, cfg, st, tr)
    w = cfg.solver_p2p_gate_window
    h = hold_gate(torch, cfg, gin)
    rows, cols = h.gate.shape
    lib_err = library_gate_err(torch, cfg, gin)
    check("p2p_gate", gate_held(h) and h.n_part > 0 and kernels.p2p_gate_cluster(rows, w),
          f"{cols}x{rows}, {w}x{w} window, the cluster design: depth bins equal the plain version's "
          f"{h.bins_same}; max |gate diff| {h.err:.3e} (tol {TOL_GATE}), {h.n_diff} pixels not bit-equal; gate and "
          f"bins bit-equal to the reference mode's {h.ref_same}; device kernels {h.n_dev} (the reference mode's "
          f"{h.n_ref}); mean gate {float(h.gate.mean()):.4f}, {int((h.gate > 0).sum())} pixels open, {h.n_part} of "
          f"them part way (need > 0), {len(torch.unique(h.bins))} bins in use")
    check("p2p_gate_library", lib_err <= TOL_GATE_LIBRARY,
          f"the library route (avg_pool2d box sums) against the plain version: max |gate diff| {lib_err:.3e} "
          f"(tol {TOL_GATE_LIBRARY})")
    for name in GATE_CASES:
        cin = tuple(torch.from_numpy(a).to(dev) for a in gate_case(name))
        hc = hold_gate(torch, cfg, cin)
        cluster = kernels.p2p_gate_cluster(cin[3].shape[0], w)
        le = library_gate_err(torch, cfg, cin)
        check(f"p2p_gate_{name}", gate_held(hc) and cluster == (name != "tall")
              and le <= TOL_GATE_LIBRARY,
              f"{tuple(cin[3].shape)} ({'the cluster design' if cluster else 'the reference mode: past the rows'}): "
              f"bins equal {hc.bins_same}, {hc.n_diff} pixels not bit-equal to plain, bit-equal to the reference "
              f"mode {hc.ref_same}, device kernels {hc.n_dev} / {hc.n_ref}; {int((hc.gate > 0).sum())} open, "
              f"{hc.n_part} part way, {len(torch.unique(hc.bins))} bins; library {le:.3e}")
    npx = rows * cols
    report["p2p_gate"] = dict(
        err=h.err,
        ms=cuda_ms(torch, lambda: kinfu.p2p_gate_kernel(cfg, *gin)),
        reference_ms=cuda_ms(torch, lambda: kinfu.p2p_gate_kernel(cfg, *gin, reference=True)),
        plain_ms=cuda_ms(torch, lambda: kinfu.p2p_gate(cfg, *gin, plain=True), reps=3),
        # the function's least work: three point/normal maps and the depth
        # in, the gate and its bins out (48 bytes a pixel); box sums by
        # running sums, one add and one subtract a (bin, channel) along
        # each axis (2 x 2 x 16 x 11), the three bins' 11 sums added (66),
        # ~150 operations of features and closed form a pixel
        bound=bound_ms(npx * (3 * 12 + 4) + npx * (4 + 4),
                       npx * (2.0 * 2 * kinfu.GATE_BINS * kinfu.GATE_CHANNELS + 66 + 150)),
        library_ms=cuda_ms(torch, lambda: library_p2p_gate(torch, cfg, *gin)),
        library_err=lib_err,
    )
    r = report["p2p_gate"]
    print(f"[time] {smi()} | M {cols}x{rows}: the features and the clusters {r['ms']:.4f} ms "
          f"({-(-cols // kernels.p2p_gate_plan()[2])} clusters of 11 CTAs), "
          f"reference mode {r['reference_ms']:.4f} ms, library {r['library_ms']:.4f} ms (max |diff| from plain "
          f"{lib_err:.3e}), plain {r['plain_ms']:.4f} ms", flush=True)


def library_coarse_band(torch, pts_c, f, m):
    """Kernel J's coarse band in PyTorch calls, its yardstick: |p| of the
    coarse hits, their 3x3 window min and max (two max pools), widened by
    the margin, empty where none hit, each value repeated f x f."""
    import torch.nn.functional as F

    t = torch.linalg.vector_norm(pts_c, dim=-1)
    hit = ~torch.isnan(t)
    inf = float("inf")
    src = torch.stack([torch.where(hit, -t, -inf), torch.where(hit, t, -inf)])[None]
    pooled = F.max_pool2d(src, 3, 1, padding=1)
    lo, hi = -pooled[:, :1], pooled[:, 1:]
    band = torch.where(torch.isfinite(lo), torch.cat([torch.clamp(lo - m, min=0.0), hi + m], 1), 0.0)
    out = F.interpolate(band, scale_factor=f, mode="nearest")[0]
    return out[0], out[1]


def library_march_band(torch, dists, s, can, m):
    """Kernel J's temporal band in PyTorch calls, its yardstick: |p| of the
    previous model map united with the strided live dists, their 5x5
    window min and max (two max pools), widened by the margin, empty where
    none is valid."""
    import torch.nn.functional as F

    t = torch.linalg.vector_norm(can, dim=-1)
    live = dists[::s, ::s]
    miss = torch.isnan(t)
    inf = float("inf")
    lo_src = torch.minimum(torch.where(miss, inf, t), torch.where(live > 0, live, inf))
    hi_src = torch.maximum(torch.where(miss, -inf, t), torch.where(live > 0, live, -inf))
    pooled = F.max_pool2d(torch.stack([-lo_src, hi_src])[None], 5, 1, padding=2)[0]
    lo, hi = -pooled[0], pooled[1]
    hit = torch.isfinite(lo)
    return torch.where(hit, torch.clamp(lo - m, min=0.0), 0.0), torch.where(hit, hi + m, 0.0)


def full_res_kernels(torch, report, dev, st, depth_np):
    """Phase 2 for the reference resolution of ``reference_parity()`` (rigid,
    640x480 model maps) on the preset's phase-2 volume at its camera: kernel
    C's coarse march (160x120, no band), kernel J's coarse band (bit-equal
    to its plain version from the same coarse hits), C at 640x480 in that
    band and as the full march of ``render(pose)``, and kernel B at 640x480
    (the next frame's level-0 maps against the banded model maps)."""
    import dataclasses

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
                                                                          cols // f))
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
    err = max(abs_err(torch, x, y) for x, y in zip(library_coarse_band(torch, pts_c, f, m), bk))
    check("coarse_band_library", err <= TOL_BAND_LIBRARY_M,
          f"the yardstick (PyTorch calls) computes the same band: max |diff| {err:.2e} m (tol {TOL_BAND_LIBRARY_M})")
    report["coarse_band"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.coarse_band(pts_c, f, m)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.coarse_band_plain(pts_c, f, m)),
        # the coarse hits in, lo and hi at the fine resolution out; ~6
        # operations a coarse |p| and 9 taps of ~3 a fine pixel
        bound=bound_ms(n_c * 12 + rows * cols * 8, n_c * 6.0 + rows * cols * 30.0),
        library_ms=cuda_ms(torch, lambda: library_coarse_band(torch, pts_c, f, m)),
    )
    # C: 640x480 in the coarse band, and the render's full march
    rays_f = tsdf_ops.rays(cfg, cam2vol, intr, rows, cols, t_band=bk)
    hold_raycast(torch, report, "raycast_full_res", cfg, tsdf, rays_f)
    hold_raycast(torch, report, "raycast_render", cfg, tsdf, tsdf_ops.rays(cfg, cam2vol, intr, rows, cols))
    # C's new modes at 640x480 in the same band; the reference-shaped rigid
    # path (phase 13) runs the six-sample normal on the secant there and in
    # its 160x120 coarse march
    hold_raycast_variants(torch, report, "raycast_full_res", cfg, tsdf, rays_f)
    smooth = dataclasses.replace(cfg, raycast_smooth_normals=True)
    hold_raycast(torch, report, "raycast_grad6_coarse", smooth, tsdf,
                 tsdf_ops.rays(cfg, cam2vol, intr.level(2), rows // f, cols // f), exact_found=True)

    # B: the ICP system at 640x480
    model = tsdf_ops.raycast(cfg, st.vol, cam2vol, intr, rows, cols, t_band=bk)
    _, pts_pyr, nrm_pyr, _ = preprocess.build_frame_pyramid(cfg, torch.from_numpy(depth_np).to(dev))
    cp, cn, pp, pn = pts_pyr[0], nrm_pyr[0], model.points.contiguous(), model.normals.contiguous()
    dist2 = cfg.icp_dist_thres ** 2
    min_cos = math.cos(cfg.icp_angle_thres)
    t_cur = torch.eye(4, device=dev)
    npx = cp.shape[0] * cp.shape[1]
    hold_icp(torch, report, "icp_reduce_full_res", intr, t_cur, cp, cn, pp, pn, dist2, min_cos,
             (npx + pp.shape[0] * pp.shape[1]) * 24 + 64 + 42 * 4,
             what=f"{cols}x{rows}, {int(torch.isfinite(pp[..., 0]).sum())} model pixels: ")


def extract_kernels(torch, report, dev, nr_depths):
    """Phase 2 for kernel L on the preset's frame-0 volume of the deforming
    scene: the extraction (``hold_extract``) and the node sampling, each
    bit-equal to its plain version."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = DynamicFusionConfig.default_dynamicfusion()
    df = kinfu.DynamicFusion(cfg, device=dev)
    df(nr_depths[0])
    vol = df.state.vol
    maxp = max(cfg.max_nodes * cfg.node_sample_step, 1 << 20)
    cp = hold_extract(torch, report, "extract_cloud", cfg, vol, maxp)
    hold_extract_cases(torch, dev)
    fk = warpfield.init_from_cloud(cfg, cp.points, cp.valid)
    fp = warpfield.init_from_cloud(cfg, cp.points, cp.valid, plain=True)
    same_n = all(torch.equal(a, b) for a, b in zip(fk, fp))
    path_same = torch.equal(df.state.warp.positions, fp.positions) and torch.equal(df.state.warp.active, fp.active)
    mc = (maxp + cfg.node_sample_step - 1) // cfg.node_sample_step
    check("sample_nodes", same_n and path_same and int(fk.count) > 0,
          f"{mc} candidates -> {int(fk.count)} of {cfg.max_nodes} nodes: field equal the plain version's bit for bit "
          f"{same_n}; DynamicFusion's frame-0 field the same {path_same}")
    perm = warpfield._fair_perm_on(mc, dev)
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


def library_pyramid(torch, d0, levels, sig):
    """Kernel I's pyramid in PyTorch calls, its yardstick: each level's 5x5
    windows at the even pixels (``F.unfold``, stride 2, zero padding and
    an in-image mask), the threshold mask against the centre, sum / count,
    truncated to int and uint16."""
    import torch.nn.functional as F

    thresh = float(np.float32(sig * 1000.0 * 3.0))
    out = [d0]
    for _ in range(1, levels):
        x = out[-1].to(torch.float32)[None, None]
        h, w = x.shape[-2:]
        win = F.unfold(x, 5, padding=2, stride=2)[0]
        inb = F.unfold(torch.ones_like(x), 5, padding=2, stride=2)[0] > 0
        keep = inb & ((win - win[12:13]).abs() < thresh)
        s = torch.where(keep, win, 0.0).sum(0)
        cnt = keep.sum(0).to(torch.float32)
        mean = torch.where(cnt > 0, s / cnt.clamp(min=1.0), 0.0).reshape((h + 1) // 2, (w + 1) // 2)
        out.append(mean[: h // 2, : w // 2].to(torch.int32).to(torch.uint16))
    return out


def hold_pyramid(torch, name, d0, levels, sig, what=""):
    """Kernel I's pyramid entry (one device kernel) at every level bit for
    bit against the plain version, the one-level-a-launch reference mode
    and the library route; returns its levels."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.ops import preprocess

    got, n_dev = kernels_a_call("depth_pyramid", lambda: kernels.depth_pyramid(d0, levels, sig))
    plain = preprocess.depth_pyramid(d0, levels, sig, plain=True)
    ref = [d0]
    for _ in range(1, levels):
        ref.append(kernels.pyramid_down(ref[-1], sig))
    lib = library_pyramid(torch, d0, levels, sig)

    def i32(t):
        return t.to(torch.int32)

    same = [a.shape == b.shape == c.shape == e.shape and torch.equal(i32(a), i32(b)) and torch.equal(i32(a), i32(c))
            and torch.equal(i32(a), i32(e)) for a, b, c, e in zip(got, plain, ref, lib)]
    kept = [int(((i32(a) > 0) & (i32(a) >= 65000)).sum()) for a in got]
    check(name, all(same) and n_dev == 1,
          f"{what}{' -> '.join(f'{p.shape[1]}x{p.shape[0]}' for p in got)} in {n_dev} device kernel; each level equal "
          f"to the plain version's, the reference mode's and the library route's {same}; pixels >= 65000 mm a "
          f"level {kept}")
    return got


def hold_bands(torch, name, cfg, can, dists, what=""):
    """Kernel J's tiled band and seed bit for bit against the plain
    versions and the reference mode (``dists[::s, ::s]`` and ``can`` at
    the stride ``cfg.raycast_subsample``)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.pipeline import kinfu

    m, s_ = cfg.raycast_band_margin, cfg.raycast_subsample
    seed, (lo, hi) = kernels.march_bands(dists, s_, can, m, True)
    rseed, (rlo, rhi) = kernels.march_bands(dists, s_, can, m, True, reference=True)
    band_cfg = dataclasses.replace(cfg, raycast_temporal_band=True, raycast_seed_margin=0.1)
    pseed, (plo, phi) = kinfu._march_bands(band_cfg, can, dists, plain=True)
    alone, none = kernels.march_bands(dists, s_, None, m, True)

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    ok = [same(a, b) and same(a, c) for a, b, c in ((seed, rseed, pseed), (lo, rlo, plo), (hi, rhi, phi))]
    ok.append(none is None and same(alone, pseed))
    check(name, all(ok), f"{what}{lo.shape[1]}x{lo.shape[0]} (seed, lo, hi, seed alone) equal to the plain versions "
          f"and the reference mode {ok}; {int((hi > lo).sum())} rays banded, {int((pseed > 0).sum())} seeded")


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

    # I: the depth pyramid, every level in one launch (exact): bit-equal to
    # the plain version, to the one-level-a-launch reference mode and to the
    # library route at every level on the preset's filtered noisy frame, an
    # odd-sized frame (481x641: h // 2 floors) and the threshold-edge frames
    # (``pyramid_frame``: holes, 65 000-65 535, neighbours at and one mm
    # either side of 3 sigma, even- and odd-sized); the row times every
    # level in one launch against the three single-level launches
    sig, levels = cfg.bilateral_sigma_depth, cfg.pyramid_levels
    f0 = preprocess.bilateral_filter(d_t, cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial, sig)
    pyr = hold_pyramid(torch, "depth_pyramid", f0, levels, sig, "the preset's noisy frame, filtered: ")
    odd = torch.from_numpy(np.pad(d, ((0, 1), (0, 1)), "edge").astype(np.uint16)).to(dev)
    hold_pyramid(torch, "depth_pyramid_odd", preprocess.bilateral_filter(
        odd, cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial, sig), levels, sig, "the odd-sized frame: ")
    for k, (h_, w_) in enumerate(((rows, cols), (rows + 1, cols + 1), (97, 203))):
        edge = torch.from_numpy(pyramid_frame(h_, w_, k + 1, int(np.float32(sig * 1000.0 * 3.0)))).to(dev)
        hold_pyramid(torch, f"depth_pyramid_edges_{w_}x{h_}", edge, levels, sig, "the threshold-edge frame: ")

    def pyramid_before():
        # the parent's three single-level launches of a frame
        out = [f0]
        for _ in range(1, levels):
            out.append(kernels.pyramid_down(out[-1], sig))
        return out

    n_out = sum(p.numel() for p in pyr[1:])
    report["depth_pyramid"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.depth_pyramid(f0, levels, sig)),
        plain_ms=cuda_ms(torch, lambda: preprocess.depth_pyramid(f0, levels, sig, plain=True)),
        # level 0 read once, every coarser level written once; 25 taps of ~5
        # operations an output pixel
        bound=bound_ms(npx * 2 + n_out * 2, n_out * 25 * 5.0),
        library_ms=cuda_ms(torch, lambda: library_pyramid(torch, f0, levels, sig)),
        reference_ms=cuda_ms(torch, pyramid_before),
    )
    r = report["depth_pyramid"]
    print(f"[time] {smi()} | depth_pyramid: {' -> '.join(f'{p.shape[1]}x{p.shape[0]}' for p in pyr)} in one launch "
          f"{r['ms']:.4f} ms; the design before, {levels - 1} single-level launches {r['reference_ms']:.4f} ms; "
          f"library {r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)

    # I's single-map kernel (the multi-map entry's reference mode) against
    # plain at the shapes the frame's maps take: level 0 with the incidence
    # confidence, the tracking levels 2 and 3, the raw level-2 points of the
    # solve (stride 4)
    worst = [0.0, 0.0, 0.0]
    shapes = ((pyr[0], 1, 0, True), (pyr[2], 1, 2, False), (pyr[3], 1, 3, False), (d_t, 4, 2, False))
    for img, stride, lvl, conf in shapes:
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
        if conf:
            worst[2] = abs_err(torch, ck, preprocess.incidence_confidence(pp, npl))

    # I's multi-map entry: the step's frame maps (``kinfu.track_maps``: level
    # 0's confidence alone, levels 2 and 3, the raw stride-4 points) in one
    # launch, bit-equal to the single-map kernel; also every map of each
    # level and every output alone
    maps = kinfu.track_maps(cfg)
    tasks, _ = preprocess.pyramid_map_tasks(cfg, pyr, d_t, **maps)
    hold_maps(torch, "frame_maps", tasks, "the preset's frame: ")
    every = [preprocess.MapTask(img, intr.level(lvl), stride, conf=True) for img, stride, lvl, _ in shapes]
    hold_maps(torch, "frame_maps_every_map", every, "every map of the preset's shapes: ")
    for one in ("points", "normals", "conf"):
        alone = [t._replace(points=one == "points", normals=one == "normals", conf=one == "conf") for t in every]
        hold_maps(torch, f"frame_maps_{one}_only", alone, f"{one} alone: ")
    reference = [(img, intr.level(lvl), stride, conf) for img, stride, lvl, conf in shapes]

    def maps_before():
        # the parent's four single-map launches of a frame (normals and all)
        return [kernels.points_normals(img, k, stride, conf=conf) for img, k, stride, conf in reference]

    def maps_plain():
        return preprocess.frame_maps(tasks, plain=True)

    outs_k, outs_p = kernels.frame_maps(tasks), maps_plain()
    err = max(abs_err(torch, a, b) for ok, op in zip(outs_k, outs_p) for a, b in zip(ok, op) if a is not None)
    nb = sum(t.depth.shape[0] // t.stride * (t.depth.shape[1] // t.stride) for t in tasks)
    out_b = sum((t.depth.shape[0] // t.stride) * (t.depth.shape[1] // t.stride) * (12 * t.points + 12 * t.normals
                                                                                + 4 * t.conf) for t in tasks)
    report["frame_maps"] = dict(
        err=max(err, *worst),
        ms=cuda_ms(torch, lambda: kernels.frame_maps(tasks)),
        plain_ms=cuda_ms(torch, maps_plain),
        # each task's depth samples in (2 B each), the maps it asks for out;
        # ~90 operations a pixel
        bound=bound_ms(nb * 2 + out_b, nb * 90.0),
        library_ms=None,
        reference_ms=cuda_ms(torch, maps_before),
    )
    per_shape = [cuda_ms(torch, lambda a=a: kernels.points_normals(a[0], a[1], a[2], conf=a[3])) for a in reference]
    print(f"[time] frame_maps: the preset frame's {len(tasks)} maps in one launch {report['frame_maps']['ms']:.4f} ms; "
          f"the design before, four single-map launches {report['frame_maps']['reference_ms']:.4f} ms ("
          + ", ".join(f"{a[0].shape[1] // a[2]}x{a[0].shape[0] // a[2]} {t:.4f}" for a, t in zip(reference, per_shape))
          + ")", flush=True)

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

    # J: the temporal march band and seed, tiled (exact): bit-equal to the
    # plain version and to the thread-a-pixel reference mode on the preset's
    # state, a model map that misses everywhere, all-zero dists, and at
    # raycast strides 1, 2 and 4 (the state's map repeated to the grid)
    (_, bk), (_, bp) = kinfu._march_bands(cfg, st.can_points, dk), kinfu._march_bands(cfg, st.can_points, dk, plain=True)
    exact = torch.equal(bk[0], bp[0]) and torch.equal(bk[1], bp[1])
    check("march_bands", exact and bool((bk[1] > bk[0]).any()),
          f"{bk[0].shape[1]}x{bk[0].shape[0]} band equal the plain version's; {int((bk[1] > bk[0]).sum())} rays banded")
    can = st.can_points.contiguous()
    s_ = cfg.raycast_subsample
    hold_bands(torch, "march_bands_state", cfg, can, dk, "the preset's state: ")
    hold_bands(torch, "march_bands_all_miss", cfg, torch.full_like(can, float("nan")), dk, "a map that misses: ")
    hold_bands(torch, "march_bands_zero_dists", cfg, can, torch.zeros_like(dk), "all-zero dists: ")
    for stride in (1, 2, 4):
        rep_ = s_ // stride
        can_s = can.repeat_interleave(rep_, 0).repeat_interleave(rep_, 1).contiguous() if rep_ > 1 else can
        hold_bands(torch, f"march_bands_stride{stride}", dataclasses.replace(cfg, raycast_subsample=stride), can_s, dk,
                   f"raycast_subsample {stride}: ")
    nt = can.shape[0] * can.shape[1]
    err = max(abs_err(torch, x, y) for x, y in zip(library_march_band(torch, dk, s_, can, cfg.raycast_band_margin), bk))
    check("march_bands_library", err <= TOL_BAND_LIBRARY_M,
          f"the yardstick (PyTorch calls) computes the same band: max |diff| {err:.2e} m (tol {TOL_BAND_LIBRARY_M})")
    report["march_bands"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.march_bands(dk, s_, can, cfg.raycast_band_margin, False)),
        plain_ms=cuda_ms(torch, lambda: kinfu._march_bands(cfg, st.can_points, dk, plain=True)),
        # strided dists and the model map in, lo and hi out; the sources
        # (~10 operations) once a pixel, 2 x 25 window taps
        bound=bound_ms(nt * (4 + 12 + 8), nt * (2 * 25.0 + 10.0)),
        library_ms=cuda_ms(torch, lambda: library_march_band(torch, dk, s_, can, cfg.raycast_band_margin)),
        reference_ms=cuda_ms(torch, lambda: kernels.march_bands(dk, s_, can, cfg.raycast_band_margin, False,
                                                                reference=True)),
    )
    r = report["march_bands"]
    print(f"[time] {smi()} | march_bands {can.shape[1]}x{can.shape[0]}: tiled {r['ms']:.4f} ms, reference mode "
          f"{r['reference_ms']:.4f} ms, library {r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)

    # C: the newton8 branch, in the band, at the preset's model-map resolution
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), st.pose)
    rays_t = tsdf_ops.rays(cfg, cam2vol, intr.level(cfg.raycast_shift), rows_t, cols_t, t_band=bk)
    hold_raycast(torch, report, "raycast_newton8", cfg, st.vol.tsdf, rays_t)
    # C's refine codes 2 and 3 and the six-sample normal on the same rays
    hold_raycast_variants(torch, report, "raycast", cfg, st.vol.tsdf, rays_t)

    # K: the brick plan at the preset's non-rigid fusion grid (exact)
    g = cfg.knn_field_stride
    cf = fusion.coarse_field(cfg, st.warp)
    cam_grid = se3.transform_points(se3.inverse(st.pose), cf.warped).contiguous()
    pk_ = bricks.plan(cfg, dk, cam_grid, g, intr)
    pp_ = bricks.plan(cfg, dk, cam_grid, g, intr, plain=True)
    exact = same_plan(torch, pk_, pp_)
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
    # K's cluster against its one-block mode and the plain version, on this
    # grid and on the numpy-made cases (the capped lists, the phase split,
    # 32^3 bricks, small()), each gated too; then the gated frame's
    # integrate leaves the volume as it is
    _, one, gated = hold_plan(torch, "brick_plan_cluster", cfg, dk, cam_grid, g, what="the preset's grid: ")
    report["brick_plan"].update(reference_ms=one, gated_ms=gated)
    print(f"[time] brick_plan: {report['brick_plan']['ms']:.4f} ms (one-block mode {one:.4f}), gated {gated:.4f} ms",
          flush=True)
    for case in PLAN_CASES:
        ccfg, cd, cgrid, cg, cphase, csplit = plan_inputs(torch, dev, case)
        hold_plan(torch, f"brick_plan_{case}", ccfg, cd, cgrid, cg, cphase, csplit, what=f"{case}: ")
    off = torch.zeros((), dtype=torch.bool, device=dev)
    vol = volume_model.TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    counts = bricks.integrate_bricks(cfg, vol, dk, cam_grid, g, intr, ok=off, q_grid=cf.q,
                                     conf=torch.ones_like(dk))
    check("integrate_bricks_gated", same_volume(torch, vol, st.vol) and counts.tolist() == [0, 0, 0],
          f"ok false: counts {counts.tolist()}, the volume as it was")


def factored_csr(torch, ws, s, sysm, edges=True):
    """Kernel G's system as cuSPARSE takes it (PyTorch calls; the yardstick
    only, never called by the port): the expanded bf16 rows of the row mode
    as a float32 (P R, 6N) CSR matrix (the bf16 values exactly; rows out of
    the matrix not stored) and its transpose, and with ``edges`` the edge
    blocks and the damping assembled into one (6N, 6N) CSR matrix."""
    rows = sysm.rows
    npt, r = rows.shape[:2]
    n = sysm.damp.shape[0] // 6
    dev = rows.device
    vals = rows.float()
    if sysm.used is not None or sysm.stride > 1:
        vals = vals * ws._rows_in(sysm, npt)[:, :, None, None]
    a6 = torch.arange(6, device=dev)
    ri = (torch.arange(npt, device=dev)[:, None, None, None] * r
          + torch.arange(r, device=dev)[None, :, None, None]).expand(npt, r, 8, 6)
    ci = (6 * s.knn_idx[:, None, :, None] + a6).expand(npt, r, 8, 6)
    keep = vals != 0.0
    ri, ci, v = ri[keep], ci[keep], vals[keep]
    a = torch.sparse_coo_tensor(torch.stack([ri, ci]), v, (npt * r, 6 * n)).coalesce().to_sparse_csr()
    at = torch.sparse_coo_tensor(torch.stack([ci, ri]), v, (6 * n, npt * r)).coalesce().to_sparse_csr()
    if not edges:
        return a, at, None
    e = sysm.edge
    parts = ((s.e_src, s.e_src, e.h_ii), (s.e_dst, s.e_dst, e.h_jj), (s.e_src, s.e_dst, e.h_ij),
             (s.e_dst, s.e_src, e.h_ij.transpose(1, 2)))
    er = [(6 * i[:, None, None] + a6[:, None]).expand(-1, 6, 6).reshape(-1) for i, _, _ in parts]
    ec = [(6 * j[:, None, None] + a6[None, :]).expand(-1, 6, 6).reshape(-1) for _, j, _ in parts]
    dof = torch.arange(6 * n, device=dev)
    ed = torch.sparse_coo_tensor(torch.stack([torch.cat(er + [dof]), torch.cat(ec + [dof])]),
                                 torch.cat([h.reshape(-1) for _, _, h in parts] + [sysm.damp]),
                                 (6 * n, 6 * n)).coalesce().to_sparse_csr()
    return a, at, ed


def library_data_matvec(torch, csr, p):
    """The data product rowsᵀ bf16(rows bf16(p)) as two cuSPARSE CSR
    products (``torch.sparse.mm``), t rounded to bf16 between them."""
    a, at, _ = csr
    t = torch.sparse.mm(a, p.to(torch.bfloat16).float()[:, None]).to(torch.bfloat16).float()
    return torch.sparse.mm(at, t)[:, 0]


def library_pcg_factored(torch, csr, minv, b, iters, rtol, active):
    """Kernel G's PCG in PyTorch calls, its yardstick (the port never calls
    it): the same iterations, the factored matvec as the two CSR products
    of ``library_data_matvec`` plus one CSR product of the edge blocks and
    the damping (``factored_csr``), z = M r by ``torch.bmm``, the dot
    products by ``torch.dot``, the early exit as device flags."""
    return library_pcg_loop(torch, lambda p: library_data_matvec(torch, csr, p)
                            + torch.sparse.mm(csr[2], p[:, None])[:, 0], minv, b, iters, rtol, active)


def library_pcg_sharded(torch, mesh, csrs, edges_csr, minv, b, iters, rtol, active):
    """The distributed PCG in PyTorch calls, its yardstick: every matvec
    each shard's two CSR products (``library_data_matvec``), the mesh's
    psum, and one CSR product of the edge blocks and the damping."""
    return library_pcg_loop(torch, lambda p: mesh.psum([library_data_matvec(torch, c, p) for c in csrs])
                            + torch.sparse.mm(edges_csr, p[:, None])[:, 0], minv, b, iters, rtol, active)


def library_pcg_loop(torch, matvec, minv, b, iters, rtol, active):
    """Block-Jacobi PCG in PyTorch calls around ``matvec``."""
    n = minv.shape[0]
    x = torch.zeros_like(b)
    r = b
    z = torch.bmm(minv, r.view(n, 6, 1)).view(-1)
    p = z
    stop2 = (rtol * rtol) * torch.dot(b, b)
    rz = torch.dot(r, z)
    run = active
    for _ in range(iters):
        run = run & (torch.dot(r, r) > stop2)
        ap = matvec(p)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        z = torch.bmm(minv, r_n.view(n, 6, 1)).view(-1)
        rz_n = torch.dot(r_n, z)
        p_n = z + (rz_n / torch.clamp(rz, min=1e-30)) * p
        x, r, p, rz = (torch.where(run, u, o) for u, o in ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return torch.where(active, x, 0.0)


def pcg_bf16_control(torch, ws, s, sysm, minv, b, iters, rtol):
    """The plain PCG with its vectors (x, r, z, p) rounded to bf16 after
    every update: the fault of a kernel that kept them in bf16, which a PCG
    hold must tell apart from a sound float32 solve."""
    def bf(v):
        return v.to(torch.bfloat16).float()

    x = torch.zeros_like(b)
    r = bf(b)
    z = bf(ws._apply_m(minv, r))
    p = z
    rz = torch.dot(r, z)
    stop2 = rtol * rtol * float(torch.dot(b, b))
    for _ in range(iters):
        if not float(torch.dot(r, r)) > stop2:
            break
        ap = ws.matvec(s, sysm, p, plain=True)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x, r = bf(x + alpha * p), bf(r - alpha * ap)
        z = bf(ws._apply_m(minv, r))
        rz_n = torch.dot(r, z)
        p = bf(z + rz_n / torch.clamp(rz, min=1e-30) * p)
        rz = rz_n
    return x


def hold_pcg(torch, report, name, s, sysm, ip, b, iters, rtol, what, timed=True):
    """Kernel G's cluster PCG held on one system: against the plain PCG
    within max(TOL_PCG_REL, SPREAD_PCG x the plain PCG's own spread under a
    one-ulp move of b) (the tolerance follows the system's noise floor:
    12 float32 iterations on an ill-conditioned system part by ~1e-2
    under a one-ulp change, so a fixed 1e-2 could not tell two sound sum
    orders apart), finite, the same bits on a second launch, p in device
    memory bit-equal to p in shared memory (the same sums), inactive -> 0;
    then ``library_pcg_factored`` against the kernel within the same
    tolerance. Prints how far ``pcg_bf16_control`` lands from the plain
    PCG beside the tolerance. With ``timed``, ``report[name]``: the
    solve's time, its plain version's and the library route's (its CSR
    matrices built beforehand), one iteration's time (the solve's less a
    solve of no iteration, over the iterations this b runs) and the
    cluster."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    on = torch.ones((), dtype=torch.bool, device=b.device)
    n = b.shape[0] // 6
    xk = ws.pcg(s, sysm, ip, b, iters, rtol, on)
    with deterministic(torch):
        xp = ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True)
        spread = max(rel_err(torch, ws.pcg(s, sysm, ip, b1, iters, rtol, on, plain=True), xp)
                     for b1 in ulp_moves(torch, b))
        control = rel_err(torch, pcg_bf16_control(torch, ws, s, sysm, ip, b, iters, rtol), xp)
    tol = max(TOL_PCG_REL, SPREAD_PCG * spread)
    tol_s = f"max({TOL_PCG_REL}, {SPREAD_PCG} x the plain PCG's one-ulp spread {spread:.2e})"
    finite = bool(torch.isfinite(xk).all()) and bool(torch.isfinite(xp).all())
    err = rel_err(torch, xk, xp) if finite else float("inf")
    again = torch.equal(xk, ws.pcg(s, sysm, ip, b, iters, rtol, on))
    plan = kernels.cluster_plan(True, n, sysm.rows.shape[1], sysm.used, sysm.stride, device=b.device)
    in_dev = torch.equal(xk, kernels.pcg(ws._kernel_system(s, sysm), ip, b, iters, rtol, on, used=sysm.used,
                                         stride=sysm.stride, shared_p=False))
    off = not bool(ws.pcg(s, sysm, ip, b, iters, rtol, ~on).any())
    check(name, finite and err <= tol and again and in_dev and off,
          f"{what}: finite {finite}, max relative diff {err:.2e} (tol {tol_s}); the same bits on a second launch "
          f"{again}; p in device memory bit-equal {in_dev}; inactive -> 0 {off}; one cluster of {plan.cluster} CTAs, "
          f"p in {'shared' if plan.shared_p else 'device'} memory ({plan.smem} bytes of shared memory a CTA)")
    print(f"[info] {name}: the bf16-vector control lands {control:.2e} from the plain PCG (tol {tol:.2e}; told apart "
          f"{control > tol})", flush=True)
    csr = factored_csr(torch, ws, s, sysm)
    xl = library_pcg_factored(torch, csr, ip, b, iters, rtol, on)
    lerr = rel_err(torch, xl, xk) if bool(torch.isfinite(xl).all()) else float("inf")
    check(f"{name}_library", lerr <= tol,
          f"the yardstick (cuSPARSE CSR products via torch.sparse.mm, PyTorch calls) computes the same solve: max "
          f"relative diff {lerr:.2e} from the kernel (tol {tol_s})")
    if not timed:
        return
    ran = pcg_iterations(torch, ws, s, sysm, ip, b, iters, rtol)
    npt, nr = sysm.rows.shape[:2]
    ne = s.e_src.shape[0]
    # the (point, row) pairs in the matrix: every row, the plane rows only,
    # or the plane rows and the tangential rows of one point in ``stride``
    used = nr if sysm.used is None else sysm.used
    rows_in = npt * used if sysm.stride == 1 else npt + (nr - 1) * ((npt + sysm.stride - 1) // sysm.stride)
    per_iter = rows_in * 8 * 6 * 2 * 2 + ne * 2 * 72 * 2 + n * (72 + 60)
    ms = cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on))
    ms0 = cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, 0, rtol, on))
    report[name] = dict(
        err=abs_err(torch, xk, xp),
        ms=ms,
        plain_ms=cuda_ms(torch, lambda: ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True), reps=5),
        # the rows in the matrix, neighbour ids, node lists and the
        # heavy-first order, the edge blocks and lists, damping,
        # preconditioner and right-hand side read once, x written; the
        # iterations this right-hand side runs (``ran``)
        bound=bound_ms(rows_in * 96 + npt * 32 + (npt * 8 + n + 1) * 4 + n * 8 + ne * (3 * 144 + 4 + 4)
                       + (n + 1) * 4 + n * (24 + 144 + 24) + n * 24, ran * per_iter + n * 72.0),
        library_ms=cuda_ms(torch, lambda: library_pcg_factored(torch, csr, ip, b, iters, rtol, on), reps=5),
        iterations=ran,
        iteration_ms=(ms - ms0) / max(ran, 1),
        cluster=plan.cluster,
    )


def skewed_pcg_system(torch, dev, n, npt, nrows):
    """Kernel G's PCG on ``skewed_gram_inputs``' seeded system (``gram_2048``'s
    at n = 2048): the edge blocks made positive semi-definite (h = Jᵀ J of
    seeded 3 x 6 Jacobians at each edge's ends), the damping of the
    preset's first LM iteration, the float64 inverse of the damped
    diagonal blocks as the preconditioner and a seeded right-hand side.
    Returns (structure, system, preconditioner, b, the gram inputs)."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = DynamicFusionConfig.default_dynamicfusion()
    g = skewed_gram_inputs(torch, dev, n, npt, nrows, seed=12 + nrows)
    rng = np.random.default_rng(20 + nrows)
    ji, jj = (torch.from_numpy(rng.standard_normal((4 * n, 3, 6)).astype(np.float32)).to(dev) for _ in range(2))
    h_ii, h_jj, h_ij = ji.transpose(1, 2) @ ji, jj.transpose(1, 2) @ jj, ji.transpose(1, 2) @ jj
    rows = g.rows.float()
    data = torch.zeros((n, 6, 6), device=dev).index_add_(
        0, g.knn.reshape(-1), torch.einsum("prkd,prke->pkde", rows, rows).reshape(-1, 6, 6))
    diag = torch.zeros_like(data).index_add_(0, g.e_src, h_ii).index_add_(0, g.e_dst, h_jj)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    diag_eff, unit = ws.damping_terms(cfg, active, data + diag)
    damp = cfg.solver_lm_lambda_init * diag_eff + unit
    ip = torch.linalg.inv((data + diag + torch.diag_embed(damp.reshape(n, 6))).double()).float().contiguous()
    s = ws.SolveStructure(
        p_can=None, p_live=None, n_live=None, valid=None, knn_idx=g.knn, w_knn=None, e_src=g.e_src,
        e_dst=g.e_dst, e_valid=None, v_dst=None, alpha=None, pts_by_node=ws.node_lists(g.knn, n, heavy=True),
        edges_by_dst=g.e_lists, knn_idx32=g.knn.to(torch.int32), e_dst32=g.e_dst.to(torch.int32))
    sysm = ws.System(g.rows, ws.EdgeTerm(None, None, h_ii, h_jj, h_ij, diag), damp)
    b = torch.from_numpy(rng.standard_normal(6 * n).astype(np.float32)).to(dev)
    return s, sysm, ip, b, g


def pcg_2048(torch, dev, n=2048, npt=6400):
    """Phase 2 for kernel G's cluster PCG at 2048 nodes (12 288 dofs) on
    ``skewed_pcg_system`` (node 0 in 60% of 6 400 points), one row and
    three rows, held and timed as phase 2 holds G (``hold_pcg``, within the
    plain PCG's spread: the rows span six decades)."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig

    cfg = DynamicFusionConfig.default_dynamicfusion()
    for nrows in (1, 3):
        s, sysm, ip, b, g = skewed_pcg_system(torch, dev, n, npt, nrows)
        emax, emean, etop = entry_counts(torch, g.lists.off)
        rep = {}
        hold_pcg(torch, rep, f"pcg_2048_r{nrows}", s, sysm, ip, b, cfg.solver_linear_iters, cfg.solver_linear_tol,
                 f"{n} nodes, {npt} x {nrows} rows, entries a node max {emax}, mean {emean:.1f}, the top 5% hold "
                 f"{etop:.3f}; up to {cfg.solver_linear_iters} iterations")
        r = rep[f"pcg_2048_r{nrows}"]
        print(f"[time] {smi()} | G's PCG at {n} nodes, {npt} x {nrows} rows: {r['ms']:.4f} ms ({r['iterations']} "
              f"iterations, {r['iteration_ms']:.4f} ms each, a cluster of {r['cluster']}), plain {r['plain_ms']:.4f} "
              f"ms, library route {r['library_ms']:.4f} ms; bound {r['bound'][0]:.5f} ms ({r['bound'][1]})",
              flush=True)
        del g


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
    per_call = {k: (launches[k], kernels.device_kernels[k])
                for k in ("brick_plan", "fuse_bricks", "frame_maps", "depth_pyramid")}
    check("rigid_device_kernels", all(c * DEVICE_KERNELS_A_CALL[k] == d for k, (c, d) in per_call.items()),
          f"K two device kernels a call, D, I's frame maps and I's pyramid one (calls, device kernels): {per_call}")
    check_pyramid_launches("rigid", launches, len(frames) - 1)
    check("rigid_frame_maps", launches["frame_maps"] == len(frames) - 1 and launches["points_normals"] == 0,
          f"kernel I's maps in one launch a step: frame_maps {launches['frame_maps']} in {len(frames) - 1} steps, "
          f"the single-map kernel {launches['points_normals']}")
    hold_step_maps(torch, "rigid_maps", cfg, frames[-1])
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


def knn_counted(kernels):
    """The launch counters, with kernel E's split by what its calls ask for
    (``kernels.knn_kinds``) as "knn_blend[kind]", and the device kernels
    that G's edge term and E's mutual-nearest pass reported
    (``kernels.device_kernels``) as "name[device kernels]"."""
    return {**kernels.launches, **{f"knn_blend[{k}]": v for k, v in kernels.knn_kinds.items()},
            **{f"{k}[device kernels]": v for k, v in kernels.device_kernels.items()}}


# every ``kernels.insert_apply`` call of a run being recorded: (its
# arguments, the new field it returned)
INSERTIONS = []


@contextlib.contextmanager
def recorded_insertions():
    """``kernels.insert_apply`` recording its calls for ``hold_insertions``
    (it keeps references to the call's tensors, no device work)."""
    from dynamicfusion_tpu_torch import kernels

    INSERTIONS.clear()
    launch = kernels.insert_apply

    def recorded(*args, **kw):
        out = launch(*args, **kw)
        INSERTIONS.append((args, out))
        return out

    kernels.insert_apply = recorded
    try:
        yield
    finally:
        kernels.insert_apply = launch


def hold_insertions(torch, tag, calls_counted):
    """Every insertion of the recorded run (kernel H's one-launch apply)
    bit for bit against the plain delta scatter and against the reference
    mode on the same arguments; the recorded calls are the run's counted
    launches. The holds' launches are taken back out of the counters."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models import warpfield

    calls = list(INSERTIONS)
    INSERTIONS.clear()
    saved, saved_d = dict(kernels.launches), dict(kernels.device_kernels)
    same, grew = 0, []
    for args, out in calls:
        plain = warpfield._insert_apply_plain(warpfield.WarpField(*args[:6]), warpfield.InsertPlan(*args[6:8]),
                                              *args[8:11])
        ref = kernels.insert_apply(*args, reference=True)
        same += all(same_bits(torch, a, b) and same_bits(torch, a, c) for a, b, c in zip(out, ref, plain))
        grew.append(int(out[4]) - int(args[4]))
    kernels.launches.update(saved)
    kernels.device_kernels.update(saved_d)
    check(f"{tag}_insert_apply", same == len(calls) == calls_counted,
          f"kernel H's apply on every insertion of the run ({len(calls)} calls, {calls_counted} counted; nodes "
          f"inserted {grew}) bit-equal to the plain delta scatter and to the reference mode on {same}")


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
    with recorded_insertions():
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
    launches = knn_counted(kernels)
    hold_insertions(torch, f"{cfg.volume_dims}^3/{cfg.max_nodes} nodes", launches["insert_apply"])
    rows = [dict(ok=bool(o.icp_ok), c0=float(o.solver_cost0), c1=float(o.solver_cost1), nodes=int(o.node_count),
                 bricks=o.brick_counts.tolist()) for o in outs]
    return df, launches, rows, frame_ms, states


def check_nonrigid_run(tag, card, cfg, frames, launches, rows, frame_ms, poses_k, fused=None):
    """A non-rigid run's checks: every kernel of the path (A-L) launched,
    kernel L once (frame 0) and A once a frame after it, one device kernel
    a call of G's edge term, E's mutual-nearest pass, D, G's spd6_inv and
    I's frame maps and two of K and L, ICP healthy and the solve's cost not raised
    on every frame, fusion on the due frames (``fused``: the frames whose
    fusion changed the volume, else those with brick counts); kernel I's
    maps one launch a step, held bit for bit on the last frame
    (``hold_step_maps``)."""
    import torch

    from dynamicfusion_tpu_torch import kernels

    print(f"[{tag}] {len(frames)} frames at {cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3 / {cfg.max_nodes} nodes; "
          f"launches {launches}", flush=True)
    for i, r in enumerate(rows, start=1):
        print(f"[{tag}] frame {i:2d}: icp_ok {r['ok']}, solver_cost0 {r['c0']:.6e}, solver_cost1 {r['c1']:.6e}, "
              f"nodes {r['nodes']}, bricks (band, wide, dropped) {r['bricks']}")
    # the PCG launch does its own matvecs; the coarse band runs with model
    # maps at the frame size only; the aperture gate with solver_p2p_adaptive;
    # the direct solve runs N, O and the factor in place of the PCG's; kernel
    # J's march bands need the temporal band or a raycast seed; the export
    # path's normals (R) are no frame's
    off = {"matvec", "coarse_band", "extract_normals", "points_normals", "pyramid_down"} | (
        set() if cfg.solver_p2p_adaptive else {"p2p_gate"})
    off |= set(PCG_KERNELS if cfg.solver_linear == "direct" else DENSE_KERNELS)
    if cfg.solver_linear == "direct" and not cfg.solver_jtj_int8:
        off.add("gram_scales")
    # the options' kernels: the adaptive radius (E), the net rigid removal
    # (Q); the dense-matrix PCG (P) runs only in the dense variants
    off |= {"dense_pcg"} | (set() if cfg.node_radius_adaptive else {"node_radius"})
    off |= set() if cfg.solver_remove_net_rigid else {"net_rigid"}
    if not cfg.raycast_temporal_band and cfg.raycast_seed_margin <= 0.0:
        off.add("march_bands")
    # the dense fusion (F1 in frame 0, F2 a step) in place of the brick plan and fusion (K, D)
    off |= {"integrate_dense", "integrate_dense_nonrigid"} if cfg.integrate_mode == "brick" else {"brick_plan",
                                                                                                 "fuse_bricks"}
    # the distributed PCG runs in the sharded step only
    off |= set(SHARD_KERNELS) | set(SHARD_REFERENCE)
    path = [k for k in kernels.KERNELS if k not in off]
    check(f"{tag}_launches", all(launches[k] > 0 for k in path), f"every kernel of the path launched: {launches}")
    if cfg.solver_p2p_adaptive:
        check(f"{tag}_gate_launches", launches["p2p_gate"] == len(frames) - 1,
              f"kernel M once a step: {launches['p2p_gate']} launches in {len(frames) - 1} steps")
    one = {k: (launches[k], launches[f"{k}[device kernels]"]) for k in kernels.device_kernels}
    check(f"{tag}_one_launch", all(c * DEVICE_KERNELS_A_CALL[k] == d for k, (c, d) in one.items()),
          f"one device kernel a call of G's edge term, E's mutual-nearest pass, D, G's spd6_inv and I's frame "
          f"maps, two of K and of L (calls, device kernels): {one}")
    check(f"{tag}_frame_maps", launches["frame_maps"] == len(frames) - 1 and launches["points_normals"] == 0,
          f"kernel I's maps in one launch a step: frame_maps {launches['frame_maps']} in {len(frames) - 1} steps, "
          f"the single-map kernel {launches['points_normals']}")
    check_pyramid_launches(tag, launches, len(frames) - 1)
    hold_step_maps(torch, f"{tag}_maps", cfg, frames[-1])
    check(f"{tag}_frame0_kernels", launches["extract_cloud"] == 1 and launches["sample_nodes"] == 1,
          f"kernel L once in frame 0: extract_cloud {launches['extract_cloud']}, sample_nodes "
          f"{launches['sample_nodes']}")
    check(f"{tag}_bilateral", launches["bilateral"] == len(frames) - 1,
          f"kernel A once a frame after frame 0: {launches['bilateral']} launches in {len(frames)} frames")
    check(f"{tag}_icp_ok", all(r["ok"] for r in rows),
          f"ICP healthy on every tracked frame ({sum(r['ok'] for r in rows)}/{len(rows)})")
    check(f"{tag}_solver", all(r["c1"] <= r["c0"] and r["c0"] > 0 for r in rows),
          "solver_cost1 <= solver_cost0 on every frame")
    if fused is None:
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


def check_pyramid_launches(tag, launches, steps):
    """Kernel I's pyramid: one launch of every level a step, the
    one-level-a-launch reference mode on no step."""
    check(f"{tag}_pyramid", launches["depth_pyramid"] == steps and launches["pyramid_down"] == 0,
          f"the depth pyramid in one launch a step: depth_pyramid {launches['depth_pyramid']} in {steps} steps, "
          f"the one-level kernel {launches['pyramid_down']}")


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
    step's inputs (bins equal, the gate bit-equal to plain) and to its
    reference mode, and some pixels open part way over the run."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    out, held, err, n_diff, n_part = [], True, 0.0, 0, 0
    for f in range(1, len(frames)):
        tr = kinfu.track(cfg, states[f - 1], torch.from_numpy(frames[f]).to(dev))
        gin = gate_inputs(torch, cfg, states[f - 1], tr)
        h = hold_gate(torch, cfg, gin)
        held, err, n_diff, n_part = held and gate_held(h), max(err, h.err), n_diff + h.n_diff, n_part + h.n_part
        z = gin[3]
        mov = moving(z) & torch.isfinite(z)
        rest = torch.isfinite(z) & ~mov
        out.append((float(h.gate[mov].mean()), float(h.gate[rest].mean())))
    check(f"{tag}_p2p_gate", held and n_part > 0,
          f"kernel M on the {len(frames) - 1} steps' inputs: depth bins, gate bit-equal to the plain version's and "
          f"to the reference mode's, two device kernels a call in either mode: {held}; max |gate diff| {err:.3e} (tol "
          f"{TOL_GATE}), {n_diff} pixels not bit-equal; {n_part} pixel-steps open part way (need > 0)")
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


def parity_main(torch, args, dev, card, dense=False):
    """Phase 7: ``reference_parity()`` with ``rigid_only`` (the reference's
    KinectFusion at its own resolution: 640x480 model maps, ICP at 640x480
    down to 80x60, the coarse band every frame, fusion every frame) over the
    rigid orbit, kernel path and plain path; then the renders. With
    ``dense``, phase 13, the reference-shaped rigid cell: the same with
    ``integrate_mode="dense"`` (kernel F1 every frame in place of K + D)
    and ``raycast_smooth_normals`` (kernel C's six-sample normal in the
    coarse march and the banded march), and 3 more frames profiled.
    Returns (the path's launches, the render calls' launches)."""
    import dataclasses

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.pipeline import kinfu

    tag = "ref_rigid" if dense else "parity"
    cfg = dataclasses.replace(DynamicFusionConfig.reference_parity(), rigid_only=True)
    if dense:
        cfg = dataclasses.replace(cfg, integrate_mode="dense", raycast_smooth_normals=True)
    frame = rigid_frame_fn(cfg)
    frames = [frame(i) for i in range(args.p_frames)]
    prof_frames = [frame(i) for i in range(args.p_frames, args.p_frames + 3)] if args.profile or dense else []
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
    print(f"[{tag}] reference_parity() rigid{', dense fusion, six-sample normals' if dense else ''}: {n} frames at "
          f"{cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3, model maps "
          f"{cfg.cols // cfg.raycast_subsample}x{cfg.rows // cfg.raycast_subsample}, refine {df.cfg.raycast_refine}; "
          f"launches {launches}", flush=True)
    if dense:
        path = [k for k in RIGID_KERNELS + STENCIL_KERNELS if k not in ("march_bands", "fuse_bricks", "brick_plan")]
        check(f"{tag}_launches", all(launches[k] > 0 for k in path) and launches["integrate_dense"] == n
              and launches["fuse_bricks"] == 0 and launches["brick_plan"] == 0 and launches["coarse_band"] == n
              and launches["raycast"] == 2 * n,
              f"kernels A-C, I launched; F1 once a frame ({launches['integrate_dense']} in {n} frames), K and D "
              f"never; the coarse band once a frame ({launches['coarse_band']}) and C twice, its coarse march and "
              f"the banded march ({launches['raycast']})")
    else:
        check("parity_launches", all(launches[k] > 0 for k in RIGID_KERNELS + STENCIL_KERNELS if k != "march_bands")
              and launches["coarse_band"] == n and launches["raycast"] == 2 * n,
              f"kernels A-D, I, K launched; the coarse band once a frame ({launches['coarse_band']} in {n} frames) "
              f"and C twice, its coarse march and the banded march ({launches['raycast']})")
    check(f"{tag}_frame_maps", launches["frame_maps"] == n - 1 and launches["points_normals"] == 0,
          f"kernel I's maps (levels 0-3 at shift 0) in one launch a step: frame_maps {launches['frame_maps']} in "
          f"{n - 1} steps, the single-map kernel {launches['points_normals']}")
    check_pyramid_launches(tag, launches, n - 1)
    hold_step_maps(torch, f"{tag}_maps", cfg, frames[-1])
    check(f"{tag}_icp_ok", all(oks), f"ICP healthy on every tracked frame ({sum(oks)}/{len(oks)})")
    steady = sorted(frame_ms[2:])
    print(f"[time] {card} | {tag} frame ms median {steady[len(steady) // 2]:.3f} (frames 2..{n - 1}), "
          f"frame 0 {frame_ms[0]:.3f}, min {steady[0]:.3f}, max {steady[-1]:.3f}", flush=True)

    plain, plain_ms = run_plain_path(torch, cfg, dev, frames)
    poses_p = [p.cpu().numpy() for p in plain.poses]
    per_frame = [float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(poses_k, poses_p)]
    psteady = sorted(plain_ms[2:])
    print(f"[{tag}-plain] pose diff kernel vs plain path per frame (m): {' '.join(f'{v:.2e}' for v in per_frame)}")
    print(f"[time] {card} | {tag} plain-path frame ms median {psteady[len(psteady) // 2]:.3f}")
    check(f"{tag}_pose_vs_plain", max(per_frame) <= TOL_POSE_PLAIN_M,
          f"max |t_kernel - t_plain| {max(per_frame):.3e} m (tol {TOL_POSE_PLAIN_M})")
    err_truth = float(np.linalg.norm(poses_k[-1][:3, 3] - truth[-1][:3, 3]))
    err_plain = float(np.linalg.norm(poses_p[-1][:3, 3] - truth[-1][:3, 3]))
    check(f"{tag}_pose_vs_truth", err_truth <= TOL_POSE_TRUTH_M,
          f"final |t - t_orbit| {err_truth:.3e} m (tol {TOL_POSE_TRUTH_M}); the plain path's {err_plain:.3e} m")
    mp = df.last_outputs.model_points
    check(f"{tag}_model_maps", tuple(mp.shape) == (cfg.rows, cfg.cols, 3) and bool(torch.isfinite(mp).any()),
          f"model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    del plain
    if dense:
        # F1 on the run's last state and its next frame, against its reference mode
        from dynamicfusion_tpu_torch.core import se3
        from dynamicfusion_tpu_torch.ops import preprocess

        st = df.state
        nxt = prof_frames[0] if prof_frames else frames[-1]
        dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(nxt).to(dev))
        hold_dense_reference(torch, f"{tag}_integrate_dense_reference", cfg, st.vol, dists,
                             se3.compose(se3.inverse(st.pose), kinfu._vol_pose(cfg, dev)), poses=True,
                             what="the run's last state: ")
    if prof_frames:
        focus = ("fuse_dense", "raycast") if dense else ("coarse_band", "raycast")
        prof = profile_frames(torch, args, dev, card, df, prof_frames, tag=tag, focus=focus)
        print(f"[{tag}] {card} | frame ms median {steady[len(steady) // 2]:.3f}; device idle "
              f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.3f} of 3 profiled frames", flush=True)

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
    check(f"{tag}_render" if dense else "render", ok and far <= TOL_IMAGE_FRAC and render_launches["raycast"] == 1,
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


def library_gram(torch, rows, knn_idx, n, int8, scale=None, h_ij=None, diag=None, e_src=None, e_dst=None):
    """Kernel N's yardstick: the same function in PyTorch calls, as JAX's
    data_jtj and edge_jtj compute it. The rows expanded one-hot to (P R,
    6N); int8: quantized by the column scales, ``torch._int_mm`` (the rows
    padded with zeros to a multiple of 8), float(g) (c_i c_j); bf16:
    ``torch.mm`` with a float32 result; then the edge blocks placed (with
    ``h_ij``). Never called by the port."""
    p, r = rows.shape[:2]
    dt = torch.float32 if int8 else torch.bfloat16
    a = torch.zeros((p, r, n, 6), dtype=dt, device=rows.device)
    a[torch.arange(p, device=rows.device)[:, None, None], torch.arange(r, device=rows.device)[None, :, None],
      knn_idx[:, None, :]] = rows.to(dt)
    a = a.reshape(p * r, 6 * n)
    if int8:
        q = torch.clamp(torch.round(a / scale), -127.0, 127.0).to(torch.int8)
        if q.shape[0] % 8:
            q = torch.cat([q, q.new_zeros((8 - q.shape[0] % 8, 6 * n))])
        g = torch._int_mm(q.T.contiguous(), q).float() * (scale[:, None] * scale[None, :])
    else:
        g = torch.mm(a.T, a, out_dtype=torch.float32)
    if h_ij is not None:
        v = g.view(n, 6, n, 6)
        ar = torch.arange(n, device=rows.device)
        v[e_src, :, e_dst, :] += h_ij
        v[e_dst, :, e_src, :] += h_ij.transpose(1, 2)
        v[ar, :, ar, :] += diag
    return g


def entry_counts(torch, off):
    """(max, mean, share of the top 5% of nodes) of the entries a node."""
    cnt = (off[1:] - off[:-1]).double()
    top = torch.sort(cnt, descending=True).values[: max(1, cnt.shape[0] // 20)]
    return int(cnt.max()), float(cnt.mean()), float(top.sum() / cnt.sum().clamp(min=1.0))


class GramInputs(NamedTuple):
    rows: object
    knn: object
    lists: object
    h_ij: object
    diag: object
    e_src: object
    e_dst: object
    e_lists: object


def skewed_gram_inputs(torch, dev, n, npt, nrows, seed):
    """Seeded inputs of kernel N at ``n`` nodes: bf16 rows (npt, nrows, 8,
    6) over six decades; each point's 8 distinct neighbours drawn from
    nodes 1 .. n - n/32 - 1, with node 0 in place of one of them for 60% of
    the points (the skewed node) and the last n/32 nodes in none; 4
    out-edges a node to distinct other nodes, their 6x6 blocks and the
    diagonal blocks."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    rng = np.random.default_rng(seed)
    live = n - n // 32
    knn = 1 + rng.random((npt, live - 1)).argsort(1)[:, :8]
    knn[:, 0] = np.where(rng.random(npt) < 0.6, 0, knn[:, 0])
    knn = rng.permuted(knn, axis=1)
    rows = rng.standard_normal((npt, nrows, 8, 6)) * 10.0 ** rng.uniform(-3, 3, (npt, 1, 1, 1))
    other = rng.random((n, n - 1)).argsort(1)[:, :4]
    e_dst = (other + (other >= np.arange(n)[:, None])).reshape(-1)
    knn_t = torch.from_numpy(knn).to(dev)
    e_dst_t = torch.from_numpy(e_dst).to(dev)
    return GramInputs(
        torch.from_numpy(rows.astype(np.float32)).to(dev).to(torch.bfloat16), knn_t, ws.node_lists(knn_t, n),
        torch.from_numpy(rng.standard_normal((4 * n, 6, 6)).astype(np.float32)).to(dev),
        torch.from_numpy(rng.standard_normal((n, 6, 6)).astype(np.float32)).to(dev),
        torch.arange(n, device=dev).repeat_interleave(4), e_dst_t, ws.node_lists(e_dst_t, n),
    )


def gram_2048(torch, dev, n=2048, npt=6400):
    """Phase 2 for kernel N at 2048 nodes (12 288 dofs; the one-block-a-node
    design this kernel replaced refused more than 1 614): skewed seeded
    inputs (``skewed_gram_inputs``, 6 400 points) at R = 1 and 3; the int8
    Gram bit-equal to the plain version, the bf16 one within
    TOL_GRAM_BF16_REL and the same on a second call, the shard mode
    (given scales, no edges) bit-equal, the edge-only call exact; both
    modes and their PyTorch routes timed at R = 1."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    for nrows in (1, 3):
        g = skewed_gram_inputs(torch, dev, n, npt, nrows, seed=12 + nrows)
        knn32, dst32 = g.knn.to(torch.int32), g.e_dst.to(torch.int32)  # the ids as a prepared structure holds them
        args = (g.rows, knn32, g.lists.order, g.lists.off, g.h_ij, g.diag, dst32, g.e_lists.order, g.e_lists.off)
        eargs = (g.h_ij, g.diag, g.e_src, g.e_dst)
        same8 = torch.equal(kernels.dense_gram(*args, True), ws.dense_gram_plain(g.rows, g.knn, True, *eargs))
        bk = kernels.dense_gram(*args, False)
        err = rel_err(torch, bk, ws.dense_gram_plain(g.rows, g.knn, False, *eargs))
        again = torch.equal(bk, kernels.dense_gram(*args, False))
        del bk
        scale = kernels.gram_scales(g.rows, g.lists.order, g.lists.off)
        shard = torch.equal(
            kernels.dense_gram(g.rows, knn32, g.lists.order, g.lists.off, None, None, None, None, None, True,
                               scale=scale, edges=False),
            ws.dense_gram_plain(g.rows, g.knn, True, None, None, None, None, scale=scale, n=n))
        rows0 = torch.zeros((0, 1, 8, 6), dtype=torch.bfloat16, device=dev)
        knn0 = torch.zeros((0, 8), dtype=torch.int64, device=dev)
        off0 = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        edge = torch.equal(
            kernels.dense_gram(rows0, knn32[:0], off0[:0], off0, g.h_ij, g.diag, dst32, g.e_lists.order,
                               g.e_lists.off, False),
            ws.dense_gram_plain(rows0, knn0, False, *eargs))
        emax, emean, etop = entry_counts(torch, g.lists.off)
        check(f"dense_gram_2048_r{nrows}", same8 and err <= TOL_GRAM_BF16_REL and again and shard and edge,
              f"{n} nodes, {npt} x {nrows} rows, entries a node max {emax} (node 0), mean {emean:.1f}, the top 5% "
              f"hold {etop:.3f}, {int((g.lists.off[1:] == g.lists.off[:-1]).sum())} nodes none: int8 bit-equal "
              f"{same8}; bf16 max relative diff {err:.2e} (tol {TOL_GRAM_BF16_REL}), the same on a second call "
              f"{again}; shard mode bit-equal {shard}; the edge-only call exact {edge}")
        if nrows == 1:
            cp = ws.gram_scales_plain(ws.dense_rows(g.rows, g.knn, n))
            t8 = cuda_ms(torch, lambda: kernels.dense_gram(*args, True), reps=10)
            t16 = cuda_ms(torch, lambda: kernels.dense_gram(*args, False), reps=10)
            l8 = cuda_ms(torch, lambda: library_gram(torch, g.rows, g.knn, n, True, cp, *eargs), reps=5)
            l16 = cuda_ms(torch, lambda: library_gram(torch, g.rows, g.knn, n, False, None, *eargs), reps=5)
            bound = bound_ms((6 * n) ** 2 * 4 + npt * (96 + 64), 0.0)[0]
            print(f"[time] {smi()} | N at {n} nodes, {npt} x 1 rows: int8 {t8:.4f} ms (PyTorch route {l8:.4f}), "
                  f"bf16 {t16:.4f} ms (PyTorch route {l16:.4f}); the matrix's write {bound:.4f} ms",
                  flush=True)
        del g


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
    hold_edge_order(torch, "edge_term_order_base", cfg, s, field.dq, "the base config's frame-3 state: ")
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
    emax, emean, etop = entry_counts(torch, s.pts_by_node.off)
    blocks, threads, tile = kernels.gram_launch(n)
    print(f"[info] N at the base config: entries a node max {emax}, mean {emean:.1f}, the top 5% of the {n} nodes "
          f"hold {etop:.3f}; {blocks} blocks of {threads} threads ({-(-n // tile)} column tiles of {tile} nodes a "
          f"node)", flush=True)
    e_args = dict(h_ij=et.h_ij, diag=et.diag, e_src=s.e_src, e_dst=s.e_dst)
    lib8 = lambda: library_gram(torch, dt.rows, s.knn_idx, n, True, cp, **e_args)  # noqa: E731
    err = rel_err(torch, lib8(), gp)
    check("dense_gram_library", err <= TOL_GRAM_LIBRARY_REL,
          f"the int8 yardstick (expansion, quantization, torch._int_mm, the scale product, the edge blocks placed) "
          f"computes the same function: max relative diff {err:.2e} (tol {TOL_GRAM_LIBRARY_REL})")
    products = npt * 8 * 288 * dt.rows.shape[1]  # each entry's (k, a, b) products over its rows
    report["dense_gram"] = dict(
        err=abs_err(torch, gk, gp),
        ms=cuda_ms(torch, lambda: ws.dense_gram(cfg, s, dt, et), reps=10),
        plain_ms=cuda_ms(torch, lambda: ws.dense_gram(cfg, s, dt, et, plain=True), reps=3),
        bound=bound_ms(gram_in + mat_b, 2.0 * products, PEAK_INT8),
        library_ms=cuda_ms(torch, lib8, reps=10),
    )
    cfg16 = dataclasses.replace(cfg, solver_jtj_int8=False)
    bk = ws.dense_gram(cfg16, s, dt, et)
    bp = ws.dense_gram(cfg16, s, dt, et, plain=True)
    err = rel_err(torch, bk, bp)
    again = torch.equal(bk, ws.dense_gram(cfg16, s, dt, et))
    check("dense_gram_bf16", err <= TOL_GRAM_BF16_REL and again,
          f"({6 * n})^2 bf16 Gram plus the edge blocks: max relative diff {err:.2e} (tol {TOL_GRAM_BF16_REL}); "
          f"the same on a second call {again}")
    lib16 = lambda: library_gram(torch, dt.rows, s.knn_idx, n, False, **e_args)  # noqa: E731
    err = rel_err(torch, lib16(), bp)
    check("dense_gram_bf16_library", err <= TOL_GRAM_LIBRARY_REL,
          f"the bf16 yardstick (expansion, torch.mm with a float32 result, the edge blocks placed) computes the "
          f"same function: max relative diff {err:.2e} (tol {TOL_GRAM_LIBRARY_REL})")
    report["dense_gram_bf16"] = dict(
        err=abs_err(torch, bk, bp),
        ms=cuda_ms(torch, lambda: ws.dense_gram(cfg16, s, dt, et), reps=10),
        plain_ms=cuda_ms(torch, lambda: ws.dense_gram(cfg16, s, dt, et, plain=True), reps=3),
        bound=bound_ms(gram_in + mat_b, 2.0 * products, PEAK_BF16),
        library_ms=cuda_ms(torch, lib16, reps=10),
    )
    # the product alone, the single calls the library column timed before it was restated
    q = torch.clamp(torch.round(a / cp), -127.0, 127.0).to(torch.int8)
    qt = q.T.contiguous()
    ab = a.to(torch.bfloat16)
    one8 = cuda_ms(torch, lambda: torch._int_mm(qt, qt.T), reps=10)
    one16 = cuda_ms(torch, lambda: torch.mm(ab.T, ab, out_dtype=torch.float32), reps=10)
    print(f"[time] {smi()} | N at the base config: int8 kernel {report['dense_gram']['ms']:.4f} ms, "
          f"PyTorch route {report['dense_gram']['library_ms']:.4f} (torch._int_mm alone {one8:.4f}); bf16 kernel "
          f"{report['dense_gram_bf16']['ms']:.4f}, PyTorch route {report['dense_gram_bf16']['library_ms']:.4f} "
          f"(torch.mm alone {one16:.4f}); bound {report['dense_gram']['bound'][0]:.4f}", flush=True)
    del bk, bp, ab, a, q, qt

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
    hold_data_order(torch, "data_term_p2p_order", cfg_p, sp, field.dq)
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
        hold_spd6_undamped(torch, "spd6_inv_dense", ws.diag_blocks(a),
                           f"the base config's dense diagonal blocks at lambda {lam:.1e}: ")
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
        # the same work in PyTorch calls: ``ran`` iterations of torch.mv and
        # the vector update (the GEMV alone printed below)
        library_ms=cuda_ms(torch, lambda: library_pcg(torch, a, minv, b, ran), reps=5),
        iterations=ran,
        iteration_ms=None,
        gemv_ms=cuda_ms(torch, lambda: torch.mv(a, pv), reps=10),
        # the bytes bound with the matrix read once an iteration, as it
        # must be: 151 MB do not stay in the 50 MB L2 between iterations
        reread_bound_ms=ran * dof * dof * 4 / PEAK_BYTES * 1e3,
    )
    report["dense_pcg"]["iteration_ms"] = report["dense_pcg"]["ms"] / max(ran, 1)
    print(f"[info] kernel P: {report['dense_pcg']['ms']:.4f} ms a solve of {ran} iterations (the matrix read "
          f"once an iteration: {report['dense_pcg']['reread_bound_ms']:.4f} ms) "
          f"({report['dense_pcg']['iteration_ms']:.4f} ms an iteration, one torch.mv "
          f"{report['dense_pcg']['gemv_ms']:.4f} ms, {ran} iterations of torch.mv and the update "
          f"{report['dense_pcg']['library_ms']:.4f} ms, the matrix read {dof * dof * 4 / 3.35e9:.4f} ms at 3.35 TB/s)",
          flush=True)


def library_pcg(torch, a, minv, b, iters):
    """``iters`` iterations of block-Jacobi PCG over the dense matrix in
    PyTorch calls (``torch.mv``, ``torch.bmm``, ``torch.dot``): kernel P's
    yardstick for the same work."""
    n = minv.shape[0]
    x = torch.zeros_like(b)
    r = b.clone()
    z = torch.bmm(minv, r.view(n, 6, 1)).view(-1)
    p = z.clone()
    rz = torch.dot(r, z)
    for _ in range(iters):
        ap = torch.mv(a, p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = torch.bmm(minv, r.view(n, 6, 1)).view(-1)
        rz_n = torch.dot(r, z)
        p = z + (rz_n / rz) * p
        rz = rz_n
    return x


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
    H is held at this path's 19 200 insertion candidates (its hash table in
    shared memory, and in device memory), on adversarial cases at that size
    and at 65 536 candidates. Returns the path's launches."""
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
    check("parity_nr_frame_maps", launches["frame_maps"] == len(frames) - 1,
          f"kernel I's maps in one launch a step: {launches['frame_maps']} in {len(frames) - 1} steps")
    hold_step_maps(torch, "parity_nr_maps", cfg, frames[-1])

    # H: the first step's candidates into the frame-0 field
    tr = kinfu.track(cfg, states[0], torch.from_numpy(frames[1]).to(dev))
    cand = tr.inputs.p_can[:: cfg.node_insert_stride].contiguous()
    valid = ~torch.isnan(cand[:, 0])
    n = states[0].warp.positions.shape[0]
    nc = cand.shape[0]
    hfield, _, _ = hold_insert(torch, "insert_nodes_full_res", cfg, states[0].warp, cand, valid,
                                   states[0].frame_idx, min_candidates=16385)
    hold_mutual(torch, report, "mutual_nearest_full_res", hfield, cand, valid)
    hold_mutual_cases(torch, dev, nc, n)
    cd2, _ = warpfield.mutual_nearest(hfield, cand, valid)
    gate = hfield.count < n
    hold_select(torch, "insert_select_full_res", cfg, hfield, cand, valid, cd2, gate)
    hold_select(torch, "insert_select_full_res_device_table", cfg, hfield, cand, valid, cd2, gate, device_table=True)
    hold_select_cases(torch, dev, nc, n, names=("overflow", "hash_twins", "nonfinite"))
    hold_select_cases(torch, dev, 65536, n, names=("overflow",))
    report["insert_select_full_res"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.insert_select(cand, cd2, valid, hfield.active, hfield.count, gate,
                                                        cfg.node_coverage)),
        plain_ms=cuda_ms(torch, lambda: warpfield._insert_select_plain(cfg, hfield, cand, valid, cd2, gate), reps=5),
        bound=bound_ms(nc * 17 + n + 5 + n * 20, nc * 12.0),
        library_ms=cuda_ms(torch, lambda: library_insert_select(torch, cfg, hfield, cand, valid, cd2, gate), reps=5),
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


# the raycast variants run for three steps each from the dense non-rigid
# cell's state after frame 3 (phase 14): (tag, config changes)
DENSE_VARIANTS = (("hybrid16", dict(raycast_refine="hybrid16")),
                  ("newton8_grad6", dict(raycast_refine="newton8", raycast_smooth_normals=True)),
                  ("newton16_grad6", dict(raycast_smooth_normals=True)),
                  ("hybrid16_grad6", dict(raycast_refine="hybrid16", raycast_smooth_normals=True)))


def dense_nonrigid_main(torch, args, dev, card, nr_depths):
    """Phase 14: ``default_dynamicfusion()`` with ``integrate_mode="dense"``
    and ``raycast_refine="newton16"`` over N deforming-scene frames at full
    width (640x480, 256^3, 1024 nodes): kernel F1 in frame 0, F2 every step
    (gated on the device: the volume changes on the fusion frames only),
    C's code 2 every frame; the preset's checks, the plain step from each
    state, a profile of 3 more frames; then three steps each of the raycast
    variants (``DENSE_VARIANTS``) from its state after frame 3, each held
    against the plain step. Returns (the cell's launches, each variant's)."""
    import dataclasses

    from dynamicfusion_tpu_torch.config import DynamicFusionConfig

    cfg = dataclasses.replace(DynamicFusionConfig.default_dynamicfusion(), integrate_mode="dense",
                              raycast_refine="newton16")
    frames = nr_depths[: args.dn_frames]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    fused = [i for i in range(1, len(frames))
             if not torch.equal(states[i].vol.weight.view(torch.int16), states[i - 1].vol.weight.view(torch.int16))]
    check_nonrigid_run("dense_nr", card, cfg, frames, launches, rows, frame_ms, poses_k, fused=fused)
    steps = len(frames) - 1
    check("dense_nr_fusion_launches", launches["integrate_dense"] == 1 and launches["integrate_dense_nonrigid"] == steps
          and launches["fuse_bricks"] == 0 and launches["brick_plan"] == 0,
          f"F1 once in frame 0 ({launches['integrate_dense']}), F2 once a step ({launches['integrate_dense_nonrigid']} "
          f"in {steps} steps), K and D never; C {launches['raycast']} launches")
    check_steps_vs_plain(torch, "dense_nr", cfg, dev, frames, states, poses_k, rows)
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("dense_nr_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"warped model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    prof = profile_frames(torch, args, dev, card, df, nr_depths[args.dn_frames: args.dn_frames + 3], tag="dense_nr",
                          focus=("fuse_dense", "raycast"))
    steady = sorted(frame_ms[2:])
    print(f"[dense_nr] {card} | frame ms median {steady[len(steady) // 2]:.3f}; device idle "
          f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.3f} of 3 profiled frames", flush=True)
    del df
    out = {}
    for name, changes in DENSE_VARIANTS:
        out[name] = hold_variant(torch, f"dense_nr_{name}", dataclasses.replace(cfg, **changes), dev,
                                 nr_depths[4:7], states[3], ("raycast", "integrate_dense_nonrigid"))
    del states
    return launches, out


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


def depth_icp_main(torch, report, dev, card, cfg):
    """Phase 15: the depth-variant ICP (frame to frame, the reference's
    ``USE_DEPTH`` path) at ``cfg``'s resolution on two frames of the orbit
    scene, the second from the camera moved by ``T1_DELTA``: the kernel path
    (I's point maps, B's systems) against the plain path on the same
    pyramids and against the motion; I and B timed at its level-0 shapes."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.ops import preprocess
    from dynamicfusion_tpu_torch.solvers import icp

    delta = np.asarray(T1_DELTA)
    pose0 = synthetic.orbit_pose(0.0, target=TARGET)
    pose1 = pose0.copy()
    pose1[:3, 3] += pose0[:3, :3] @ delta
    pyr = [preprocess.build_frame_pyramid(cfg, torch.from_numpy(
        synthetic.scene_depth(cfg.intr, cfg.rows, cfg.cols, p, **SCENE)).to(dev)) for p in (pose1, pose0)]
    args = (pyr[0][0], pyr[0][2], pyr[1][0], pyr[1][2])
    torch.cuda.synchronize()
    kernels.reset_launches()
    rk = icp.estimate_transform_depth(cfg, *args)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    rp = icp.estimate_transform_depth(cfg, *args, plain=True)
    tk, tp = rk.transform.cpu().numpy(), rp.transform.cpu().numpy()
    dt = float(np.abs(tk[:3, 3] - tp[:3, 3]).max())
    dr = float(np.abs(tk[:3, :3] - tp[:3, :3]).max())
    print(f"[depth-icp] {cfg.cols}x{cfg.rows}, {cfg.pyramid_levels} levels, iterations {cfg.icp_iters}: "
          f"launches I {launches['frame_maps']}, B {launches['icp_reduce']}", flush=True)
    check("depth_icp_launches", launches["frame_maps"] == 1 and launches["points_normals"] == 0
          and launches["icp_reduce"] > 0,
          f"kernel I's maps of both pyramids in one launch, B launched: frame_maps {launches['frame_maps']}, "
          f"points_normals {launches['points_normals']}, icp_reduce {launches['icp_reduce']}")
    check("depth_icp_vs_plain", bool(rk.ok) and bool(rp.ok) and dt <= TOL_T1_M and dr <= TOL_T1_ROT,
          f"ok {bool(rk.ok)}/{bool(rp.ok)}; |t_kernel - t_plain| {dt:.3e} m (tol {TOL_T1_M}), rotation entry "
          f"{dr:.3e} (tol {TOL_T1_ROT})")
    et = float(np.abs(tk[:3, 3] - delta).max())
    check("depth_icp_vs_truth", et <= TOL_T1_TRUTH_M,
          f"translation {np.array2string(tk[:3, 3], precision=6)} against the motion {delta.tolist()}: max diff "
          f"{et:.3e} m (tol {TOL_T1_TRUTH_M}), rotation entry from identity {float(np.abs(tk[:3, :3] - np.eye(3)).max()):.3e}")

    # I: both pyramids' point maps, the multi-map entry's one launch
    # bit-equal to the single-map kernel and against plain at level 0
    intr = cfg.intr
    d0 = args[0][0]
    npx = d0.shape[0] * d0.shape[1]
    tasks = icp.depth_map_tasks(cfg, args[0], args[2])
    outs = hold_maps(torch, "frame_maps_depth", tasks, "the depth-variant ICP's pyramids: ")
    pk = outs[0]
    pp = preprocess.compute_points_normals(intr, d0, plain=True)
    same_nan = torch.equal(torch.isnan(pk[0]), torch.isnan(pp[0]))
    perr = abs_err(torch, pk[0], pp[0])
    check("points_normals_depth", same_nan and perr <= TOL_POINTS_M,
          f"level 0 ({d0.shape[1]}x{d0.shape[0]}): NaNs alike {same_nan}, max point diff {perr:.2e} m (tol {TOL_POINTS_M})")
    nt = sum(t.depth.shape[0] * t.depth.shape[1] for t in tasks)
    report["points_normals_depth"] = dict(
        err=perr,
        ms=cuda_ms(torch, lambda: kernels.frame_maps(tasks)),
        plain_ms=cuda_ms(torch, lambda: preprocess.frame_maps(tasks, plain=True)),
        # both pyramids' depths in, their points out; ~40 operations a pixel
        bound=bound_ms(nt * (2 + 12), nt * 40.0),
        library_ms=None,
        # the design before: a single-map launch a level and frame, normals and all
        reference_ms=cuda_ms(torch, lambda: [kernels.points_normals(t.depth, t.intr) for t in tasks]),
    )

    # B at level 0 with the final transform: current points against the
    # previous frame's back-projected points and normals
    cp, cn = pk[0], args[1][0]
    prev_p = outs[len(tasks) // 2][0]
    pn = args[3][0]
    t_cur = rk.transform
    dist2 = cfg.icp_dist_thres ** 2
    min_cos = math.cos(cfg.icp_angle_thres)
    hold_icp(torch, report, "icp_reduce_depth", intr, t_cur, cp, cn, prev_p, pn, dist2, min_cos,
             npx * 24 * 2 + 64 + 42 * 4, what="level 0: ")
    return launches


def _ply_counts(path: str):
    """(vertices, faces) of a PLY header."""
    counts = {"vertex": 0, "face": 0}
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element"):
                _, name, n = line.split()
                counts[name.decode()] = int(n)
            if line.startswith(b"end_header"):
                break
    return counts["vertex"], counts["face"]


def demo_main(torch, args, report, dev, card, path_kernels):
    """Phase 16: ``apps/demo_torch.py``'s ``main`` in this process on
    ``synthetic:N`` under ``default_dynamicfusion()``, writing into a
    temporary directory; every counter reset just before and read just
    after. Then kernel R on the final cloud's 1 << 20 rows against its plain
    version; the checkpoint into a fresh DynamicFusion, leaf for leaf, and
    one more step from it and from the live state; kernel E's
    ``warp_points`` at the canonical mesh's vertex count; the PLYs' counts."""
    import ctypes.util
    import importlib.util
    import pathlib
    import tempfile

    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import capture
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.utils import checkpoint

    root = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("demo_torch", root / "apps" / "demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    print("[demo] not run: the dataset path (DatasetSource through native/libdfio.so); the frames are "
          f"synthetic, and libpng16 for libdfio.so is {'here' if ctypes.util.find_library('png16') else 'missing'}",
          flush=True)
    if importlib.util.find_spec("PIL") is None:
        print("[demo] not run: the rendered PNG frames (PIL is missing on this machine); every kernel and hold "
              "below runs", flush=True)
        demo.save_png = lambda path, img: None
    cfg = DynamicFusionConfig.default_dynamicfusion()
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = demo.main(["--synthetic", str(args.demo_frames), "--out", out, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = knn_counted(kernels)
        df, timer, meshes = res["df"], res["timer"], res["meshes"]
        print(f"[demo] {args.demo_frames} frames of synthetic:{args.demo_frames} at {cfg.cols}x{cfg.rows} / "
              f"{cfg.volume_dims}^3 / {cfg.max_nodes} nodes in {wall:.1f} s; launches {launches}", flush=True)
        print(f"[time] {card} | demo host times (ms, mean per call):\n{timer.report()}", flush=True)
        missing = [k for k in path_kernels + ("extract_normals", "knn_blend") if launches[k] == 0]
        check("demo_launches", not missing and launches["extract_normals"] == 1 and launches["extract_cloud"] == 2,
              f"every kernel of the preset's path, R once and L twice (frame 0, the final cloud) launched; "
              f"missing {missing}")
        for name, (nv, nf) in meshes.items():
            got = _ply_counts(str(pathlib.Path(out) / name))
            check(f"demo_{name}", got == (nv, nf) and nv > 1000 and nf > 1000,
                  f"{name}: header {got[0]} vertices, {got[1]} faces; printed {nv}, {nf}")
        names = sorted(p.name for p in pathlib.Path(out).iterdir())
        print(f"[demo] artifacts: {names}", flush=True)
        check("demo_artifacts", {"canonical_cloud.ply", "final_state.npz"} <= set(names),
              f"cloud and checkpoint written ({len(names)} files)")

        # R on the final cloud's 1 << 20 rows
        vol = df.state.vol
        pts = tsdf_ops.extract_cloud(cfg, vol, max_points=1 << 20).points
        nk = tsdf_ops.extract_normals(cfg, vol, pts)
        npl = tsdf_ops.extract_normals(cfg, vol, pts, plain=True)
        valid = ~torch.isnan(nk[:, 0])
        same_nan = torch.equal(torch.isnan(nk), torch.isnan(npl))
        same = same_nan and torch.equal(torch.nan_to_num(nk), torch.nan_to_num(npl))
        nvalid = int(valid.sum())
        check("extract_normals", same and nvalid > 0,
              f"{pts.shape[0]} rows, {int((~torch.isnan(pts[:, 0])).sum())} points, {nvalid} normals: NaNs alike "
              f"{same_nan}, equal the plain version's bit for bit {same}")
        # the voxels the valid rows' six samples read (each once), the rows in and out
        nvox = normal_voxels(torch, cfg, pts, valid)
        org = tuple(float(v) for v in cfg.volume_origin)
        report["extract_normals"] = dict(
            err=abs_err(torch, nk, npl),
            ms=cuda_ms(torch, lambda: kernels.extract_normals(vol.tsdf, pts, cfg.voxel_size, org,
                                                              cfg.gradient_delta_factor)),
            plain_ms=cuda_ms(torch, lambda: tsdf_ops.extract_normals(cfg, vol, pts, plain=True), reps=5),
            # rows in and out, the int16 codes the samples read; ~400
            # operations a valid row (six trilinear samples, the norm)
            bound=bound_ms(pts.shape[0] * 24 + nvox * 2, nvalid * 400.0),
            library_ms=None,
        )
        print(f"[demo] R reads {nvox} distinct voxels for {nvalid} normals", flush=True)

        # E at the canonical mesh's vertex count
        t0 = time.perf_counter()
        mesh = df.extract_mesh()
        mesh_s = time.perf_counter() - t0
        print(f"[time] {card} | host mesh extraction ({cfg.volume_dims}^3 marching tetrahedra, numpy): {mesh_s:.3f} s, "
              f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces", flush=True)
        field = df.state.warp
        mv = torch.from_numpy(mesh.vertices).to(dev)
        mn = torch.from_numpy(mesh.normals).to(dev)
        knn_row(torch, report, "knn_blend_mesh", field, mv, cfg.knn_k, "mesh vertices", warp=True, normals=mn)

        # the checkpoint: into a fresh DynamicFusion, then one more step from both
        t0 = time.perf_counter()
        loaded = checkpoint.load(str(pathlib.Path(out) / "final_state.npz"), cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        df2 = kinfu.DynamicFusion(cfg, device=dev)
        df2.restore(loaded)
        flat_a, flat_b = checkpoint.leaves(df.state), checkpoint.leaves(df2.state)
        def bits(t):  # NaN map pixels compare by their bits
            return t.view({torch.float32: torch.int32, torch.uint16: torch.int16}.get(t.dtype, t.dtype))

        same_leaves = len(flat_a) == len(flat_b) and all(
            a.dtype == b.dtype and a.shape == b.shape and a.device == b.device and torch.equal(bits(a), bits(b))
            for a, b in zip(flat_a, flat_b))
        check("checkpoint_leaves", same_leaves and df2._started,
              f"{len(flat_b)} leaves loaded in {load_s:.3f} s, bit-equal to the saved state {same_leaves}")
        src = capture.SyntheticSource(cfg, args.demo_frames + 1)
        for _ in range(args.demo_frames):
            src.grab()
        nxt = src.grab()[0]
        df(nxt)
        df2(nxt)
        same_pose = torch.equal(df.get_pose(), df2.get_pose())
        same_vol = torch.equal(df.state.vol.tsdf, df2.state.vol.tsdf) and torch.equal(
            df.state.vol.weight.view(torch.int16), df2.state.vol.weight.view(torch.int16))
        check("checkpoint_next_step", same_pose and same_vol and bool(df2.last_outputs.icp_ok),
              f"frame {args.demo_frames} from the loaded and from the live state: poses equal {same_pose}, volumes "
              f"equal {same_vol}, ICP ok {bool(df2.last_outputs.icp_ok)}")
    return launches


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


# ---------------------------------------------------------------- the sharded step (phases 17-19)

# the sharded step against the single-device step from the same state
# (phases 17, 18), held three ways:
# (1) the single-device step with the fixed-step march: the pose and the
#     initial cost, as phase 4 holds the plain step. Its canonical maps,
#     volume and final cost are printed, not held: the distributed solve
#     sums its shards' products in another order than the single device's,
#     and from the second LM iteration on an accept, a reject or the stop
#     test can flip, after which the fields part (chaos, not a bias: (3)
#     reads the single device's own parting under a one-ulp change of its
#     inputs, and holds the median);
# (2) the same single-device step given the sharded step's solve (its
#     hooks, the same field): the slab raycast and the slab fusion against
#     the whole-volume ones, model-map hits differing on at most
#     TOL_SH_MAP_FRAC of the pixels, points within TOL_SH_MAP_M wherever
#     both hit, the codes within 1 LSB and the weights equal;
# (3) the distributed solve itself (the distributed PCG, or the base
#     config's summed assembly) against the single-device solve on the
#     step's field and inputs, iteration by iteration (``solve``'s trace):
#     each candidate's step within max(TOL_PCG_REL, SPREAD_PCG x what
#     moving every live point by one ulp moves the single device's), as
#     phase 2 holds a PCG, and its cost within max(TOL_STEP_COST0_REL,
#     that step tolerance x the single device's cost change, SPREAD_PCG x
#     what the one-ulp move does) of the initial cost, up to the first
#     iteration whose accept or stop test parts; that test must lie within
#     the same band of its bar on the single device (a knife edge). The
#     whole solve over 2, 4 and 8 shards, and the single device's on the
#     moved inputs: the final costs' ratios to the single device's
#     printed, and the median of the sharded ones within
#     TOL_SOLVE_MEDIAN_REL of 1 (a bias moves the median; a flipped test
#     moves one step)
TOL_SH_MAP_FRAC = 1e-3        # model-map pixels that hit in one step only
TOL_SH_MAP_M = 1e-4           # model-map points (m) where both hit
TOL_SOLVE_MEDIAN_REL = 1e-3
SOLVE_SHARDS = (2, 4, 8)
# the slab kernels against their plain versions: C's found and exit events
# equal, the refined t and the vertex within TOL_RAYCAST_M where found;
# K's classes and list equal; D's codes within 1 LSB on < TOL_FUSE_NR_FRAC,
# weights equal; the distributed PCG and P's init bit-equal to their plain
# versions in the kernels' order (``warp_solver.pcg_sharded_plain``), the
# distributed PCG against kernel G's whole PCG on the same system within
# max(TOL_PCG_REL, SPREAD_PCG x the plain PCG's one-ulp spread) as phase 2
# holds G; N's shard Gram bit-equal, the psum'd Gram within
# TOL_SHARD_GRAM_REL of the single-device N on the same rows (only the
# float sums of the shards' dequantized Grams differ)
TOL_SHARD_GRAM_REL = 1e-6
SHARDS = 4
MP_TIMEOUT_S = 600            # the two-process run's own limit
SHARD_ROWS = {
    "raycast_slab": ("raycast.cu", "dynamicfusion_tpu/parallel/sharded_raycast.py:176"),
    "brick_plan_slab": ("classify.cu", "dynamicfusion_tpu/parallel/sharded_fusion.py:133"),
    "fuse_bricks_slab": ("fuse_bricks.cu", "dynamicfusion_tpu/parallel/sharded_fusion.py:156"),
    # the whole distributed solve, one launch (the matvec under axis_name,
    # :1228-1240, inside :823 _pcg)
    "pcg_step": ("pcg.cu", "dynamicfusion_tpu/solvers/warp_solver.py:823"),
    "dense_gram_shard": ("dense_system.cu", "dynamicfusion_tpu/parallel/distributed_gn.py:96"),
}
ROWS.update(SHARD_ROWS)
COUNTER.update(raycast_slab="raycast", brick_plan_slab="brick_plan", fuse_bricks_slab="fuse_bricks",
               dense_gram_shard="dense_gram", pcg_step="pcg_sharded")
PATH.update(**dict.fromkeys(("raycast_slab", "brick_plan_slab", "fuse_bricks_slab", "pcg_step"), "sharded"),
            dense_gram_shard="sharded_base")


class ShardedRunner:
    """A sharded step with ``DynamicFusion``'s call (for ``profile_frames``)."""

    def __init__(self, torch, step, state, device):
        self.torch, self.step, self.state, self.device = torch, step, state, device
        self.last_outputs = None

    def __call__(self, depth, block: bool = False):
        self.state, self.last_outputs = self.step(self.state, self.torch.as_tensor(depth).to(self.device))
        return True


def _maps_apart(torch, a, b):
    """(share of pixels that hit in one map only, share of the common hits
    further apart than TOL_SH_MAP_M, the largest distance) of two maps."""
    ha, hb = ~torch.isnan(a[..., 0]), ~torch.isnan(b[..., 0])
    both = ha & hb
    dist = (a - b)[both].abs().amax(-1) if bool(both.any()) else torch.zeros(1, device=a.device)
    return float((ha != hb).float().mean()), float((dist > TOL_SH_MAP_M).float().mean()), float(dist.max())


def hold_sharded_step(torch, tag, cfg, mesh, state, out, ref, ro, ref2, i):
    """One sharded step against the single-device step from the same state
    (``ref``, ``ro``) and against it with the sharded step's solve
    (``ref2``); the module constants' bars."""
    from dynamicfusion_tpu_torch.parallel import sharded

    pose_err = float((out.pose - ro.pose).abs().max())
    c0 = float(ro.solver_cost0)
    c0_rel = abs(float(out.solver_cost0) - c0) / max(c0, 1e-30)
    hit, far, far_max = _maps_apart(torch, state.can_points, ref.can_points)
    vol = sharded.gather_state(mesh, state).vol
    # codes (ulps of a float storage) apart
    codes = (ordered(torch, vol.tsdf) - ordered(torch, ref.vol.tsdf)).abs()
    vol_frac = float((codes > 1).float().mean())
    del codes
    hit2, _, map2 = _maps_apart(torch, state.can_points, ref2.can_points)
    codes2 = apart(torch, vol.tsdf, ref2.vol.tsdf)
    w_same = apart(torch, vol.weight, ref2.vol.weight) == 0
    _, _, track = _maps_apart(torch, out.model_points, ro.model_points)
    ok = (bool(out.icp_ok) and bool(ro.icp_ok) and pose_err <= TOL_STEP_POSE and c0_rel <= TOL_STEP_COST0_REL
          and hit2 <= TOL_SH_MAP_FRAC and map2 <= TOL_SH_MAP_M and codes2 <= 1 and w_same)
    check(f"{tag}_step_{i}", ok,
          f"(1) single device: pose {pose_err:.2e} (tol {TOL_STEP_POSE}), cost0 {c0_rel:.2e} (tol "
          f"{TOL_STEP_COST0_REL}); printed: cost1 {float(out.solver_cost1):.6e} / {float(ro.solver_cost1):.6e}, "
          f"canonical map hits differ on {hit:.2e}, points > {TOL_SH_MAP_M} m apart on {far:.2e} of the hits "
          f"(max {far_max:.2e} m), codes > 1 LSB apart on {vol_frac:.2e}, warped tracking maps {track:.2e} m. (2) "
          f"with the sharded solve: map hits differ on {hit2:.2e} (tol {TOL_SH_MAP_FRAC}), points {map2:.2e} m "
          f"(tol {TOL_SH_MAP_M}); max code diff {codes2} (tol 1), weights equal {w_same}")
    return float(out.solver_cost1), float(ro.solver_cost1)


def traced_solve(torch, cfg, field, inputs, mesh=None):
    """A warp solve's LM iterations as host values: [(step size, candidate
    dq, candidate cost, tested against, accepted, running)], and its final
    cost; over ``mesh`` the sharded step's solve (the distributed PCG, else
    the summed assembly, as ``make_sharded_step`` dispatches)."""
    from dynamicfusion_tpu_torch.parallel import distributed_gn
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    trace = []
    if mesh is None:
        _, st = ws.solve(cfg, field, inputs, trace=trace)
    elif cfg.solver_linear == "pcg" and cfg.solver_lagged_jtj:
        parts, p = distributed_gn.shard_inputs(cfg, inputs, mesh)
        _, st = ws.solve(cfg, field, parts, mesh=mesh, global_points=p, trace=trace)
    else:
        _, st = ws.solve(cfg, field, inputs, system_fn=distributed_gn.make_system_fn(cfg, mesh),
                         eval_fn=distributed_gn.make_eval_fn(cfg, mesh) if cfg.solver_lagged_jtj else None,
                         trace=trace)
    its = [(float((cand - dq).abs().max()), cand, float(c), float(prev), bool(acc), bool(run))
           for dq, cand, c, prev, acc, run in trace]
    return its, float(st.final_cost), float(st.initial_cost)


def first_step_finite(torch, cfg, field, inputs):
    """(active nodes whose damped block's closed-form inverse is
    non-finite, the linear step finite) of the single device's first LM
    iteration under the factored PCG."""
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    s = ws.prepare(cfg, field, inputs)
    used, stride = ws.row_mode(cfg)
    dt = ws.data_term(cfg, s, field.dq, True, row_stride=stride)
    et = ws.edge_term(cfg, s, field.dq)
    blocks = dt.blocks + et.diag
    diag_eff, unit = ws.damping_terms(cfg, field.active, blocks)
    damp = cfg.solver_lm_lambda_init * diag_eff + unit
    minv = ws.spd6_inv(blocks + torch.diag_embed(damp.reshape(-1, 6)))
    bad = int((~torch.isfinite(minv).all(-1).all(-1) & field.active).sum())
    x = ws.pcg(s, ws.System(dt.rows, et, damp, used, stride), minv, dt.jtr + et.jtr, cfg.solver_linear_iters,
               cfg.solver_linear_tol, torch.ones((), dtype=torch.bool, device=minv.device))
    return bad, bool(torch.isfinite(x).all())


def hold_sharded_solve(torch, tag, cfg, mesh, whole, depth, i):
    """(3) above at one step: the LM iterations held up to the first whose
    accept or stop test parts; the final costs returned as {"single",
    "nudged", n: ...}."""
    from dynamicfusion_tpu_torch.parallel import sharded
    from dynamicfusion_tpu_torch.pipeline import kinfu

    inputs = kinfu.track(cfg, whole, depth).inputs
    field = whole.warp
    ki, k_final, c0 = traced_solve(torch, cfg, field, inputs)
    si, s_final, _ = traced_solve(torch, cfg, field, inputs, mesh)
    moves = [traced_solve(torch, cfg, field, inputs._replace(p_live=p))
             for p in ulp_moves(torch, inputs.p_live)]
    held, ok, parted = [], True, None
    for it, (k, s_) in enumerate(zip(ki, si)):
        step = max(k[0], 1e-30)
        dq_err = float((s_[1] - k[1]).abs().max()) / step
        c_err = abs(s_[2] - k[2]) / c0
        # the moved inputs' runs that took the single device's path so far
        same = [m[0][it] for m in moves if all(a[4:] == b[4:] for a, b in zip(m[0][:it], ki[:it]))]
        dq_tol = max([TOL_PCG_REL] + [SPREAD_PCG * float((m[1] - k[1]).abs().max()) / step for m in same])
        change = abs(k[2] - k[3]) / c0
        c_tol = max([TOL_STEP_COST0_REL, dq_tol * change] + [SPREAD_PCG * abs(m[2] - k[2]) / c0 for m in same])
        good = dq_err <= dq_tol and c_err <= c_tol
        held.append(f"{it}: step {k[0]:.2e} apart {dq_err:.2e} (tol {dq_tol:.2e}), cost change {change:.2e} apart "
                    f"{c_err:.2e} (tol {c_tol:.2e}), accepted {int(s_[4])}/{int(k[4])}")
        if s_[4:] != k[4:]:
            # a parted test needs the single device's own test within the
            # held band: the previous iteration's improvement against the
            # stop bar (``running`` parts), else this candidate's cost
            # against the cost it is tested on
            if s_[5] != k[5]:
                kp = ki[it - 1]
                test = "stop test"
                margin = abs((kp[3] - kp[2]) - cfg.solver_function_tolerance * max(kp[2], 1e-20)) / c0
            else:
                test = "accept"
                margin = abs(k[2] - k[3]) / c0
            good = good and margin <= c_tol
            parted = f"the {test} parted at iteration {it} (the single device's margin {margin:.2e} of the initial cost)"
        ok = ok and good
        if parted:
            break
    why = ""
    if cfg.solver_linear == "pcg" and cfg.solver_lagged_jtj:
        bad, fin = first_step_finite(torch, cfg, field, inputs)
        why = (f"; the single device's iteration 0: {bad} active nodes' damped blocks with a non-finite "
               f"closed-form inverse, its PCG step finite {fin}")
    check(f"{tag}_solve_{i}", ok,
          f"{mesh.n} shards against the single device, LM iterations {'; '.join(held)}; "
          + (parted or "no accept or stop test parted") + why)
    # the farther of the two one-ulp moves from the single device's cost
    out = dict(single=k_final, nudged=max((m[1] for m in moves), key=lambda c: abs(c - k_final)))
    for n in SOLVE_SHARDS:
        out[n] = s_final if n == mesh.n else traced_solve(
            torch, cfg, field, inputs, sharded.make_mesh(n, devices=[mesh.device] * n))[1]
    return out


def report_sharded_solves(tag, solves):
    """(3)'s whole solves over the held steps: each step's final-cost
    ratios printed; the median of the sharded ones held."""
    if not solves:
        return
    for i, c in solves:
        print(f"[{tag}] step {i} final solve cost {c['single']:.6e}; ratio to it: one-ulp moved inputs "
              f"{c['nudged'] / c['single']:.6f}, " + ", ".join(f"{n} shards {c[n] / c['single']:.6f}"
                                                                for n in SOLVE_SHARDS), flush=True)

    def apart(key):
        r = [c[key] / c["single"] for _, c in solves]
        return sum(x > 1.0 + 1e-3 for x in r), sum(x < 1.0 - 1e-3 for x in r)

    ratios = sorted(c[n] / c["single"] for _, c in solves for n in SOLVE_SHARDS)
    med = ratios[len(ratios) // 2]
    parted = ", ".join(f"{n} shards higher {apart(n)[0]} / lower {apart(n)[1]}" for n in SOLVE_SHARDS)
    check(f"{tag}_solve_median", abs(med - 1.0) <= TOL_SOLVE_MEDIAN_REL,
          f"{len(ratios)} sharded solves over {len(solves)} steps: median final-cost ratio to the single device "
          f"{med:.6f} (tol 1 +- {TOL_SOLVE_MEDIAN_REL}); more than 1e-3 apart: {parted}; the single device on "
          f"one-ulp moved inputs higher {apart('nudged')[0]} / lower {apart('nudged')[1]}")


def drive_sharded(torch, tag, cfg, mesh, dev, frames, hold_from=3):
    """The sharded step over ``frames`` (frame 0 replicated, then split),
    the launch counters reset just before and read just after; from step
    ``hold_from`` on, each step held against the single-device fixed-step
    step from the same state (its launches taken back out of the
    counters). Returns (launches, rows, frame ms, the runner)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.parallel import sharded
    from dynamicfusion_tpu_torch.pipeline import kinfu

    ref_cfg = dataclasses.replace(cfg, raycast_adaptive_step=False)
    first = sharded.make_sharded_first_frame(cfg, mesh)
    step = sharded.make_sharded_step(cfg, mesh)
    print(f"[{tag}] {mesh}: pieces {step.pieces}", flush=True)
    kernels.reset_launches()
    with recorded_insertions():
        frame_ms, rows, costs, solves = [], [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = first(kinfu.init_state(cfg, dev), torch.from_numpy(frames[0]).to(dev))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        for i, d in enumerate(frames[1:], start=1):
            depth = torch.from_numpy(d).to(dev)
            ref = None
            if i >= hold_from:
                saved, saved_d, kept = dict(kernels.launches), dict(kernels.device_kernels), len(INSERTIONS)
                whole = sharded.gather_state(mesh, state)

                def copy():
                    return whole._replace(vol=TsdfVolume(whole.vol.tsdf.clone(), whole.vol.weight.clone()))

                ref, ro = kinfu.step(ref_cfg, copy(), depth)
                ref2, _ = kinfu.step(ref_cfg, copy(), depth, **step.solver_hooks)
                if step.pieces["solve"] or step.pieces["system"]:
                    solves.append((i, hold_sharded_solve(torch, tag, cfg, mesh, whole, depth, i)))
                torch.cuda.synchronize()
                kernels.launches.update(saved)
                kernels.device_kernels.update(saved_d)
                del INSERTIONS[kept:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = step(state, depth)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(dict(ok=bool(out.icp_ok), c0=float(out.solver_cost0), c1=float(out.solver_cost1),
                             nodes=int(out.node_count), bricks=out.brick_counts.tolist()))
            if ref is not None:
                saved, saved_d, kept = dict(kernels.launches), dict(kernels.device_kernels), len(INSERTIONS)
                costs.append(hold_sharded_step(torch, tag, cfg, mesh, state, out, ref, ro, ref2, i))
                kernels.launches.update(saved)
                kernels.device_kernels.update(saved_d)
                del INSERTIONS[kept:]
        launches = knn_counted(kernels)
    hold_insertions(torch, tag, launches["insert_apply"])
    worse = sum(a > b * (1.0 + 1e-3) for a, b in costs)
    better = sum(a < b * (1.0 - 1e-3) for a, b in costs)
    print(f"[{tag}] final solve cost, sharded against single device over {len(costs)} steps: higher by > 1e-3 "
          f"relative on {worse}, lower on {better}; median ratio "
          f"{sorted(a / b for a, b in costs)[len(costs) // 2]:.6f}", flush=True)
    report_sharded_solves(tag, solves)
    return launches, rows, frame_ms, ShardedRunner(torch, step, state, dev)


def slab_samples(torch, cfg, ext, x_off, ray_org, dirs, lo, hi) -> float:
    """The nearest-voxel samples a shard's fixed-step march takes on this
    run's rays (its window, its slab's codes)."""
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    inv_vs, d = 1.0 / cfg.voxel_size, cfg.volume_dims
    t, done = lo.clone(), lo >= hi
    prev = tsdf_ops.fetch_nearest(ext, (ray_org + dirs * t[..., None]) * inv_vs, x_off, d)
    samples = torch.ones_like(t)
    for _ in range(tsdf_ops.march_steps(cfg)):
        tn = t + step
        act = ~done & (t < hi)
        nxt = tsdf_ops.fetch_nearest(ext, (ray_org + dirs * tn[..., None]) * inv_vs, x_off, d)
        samples = samples + act.float()
        done = done | (act & (((prev > 0) & (nxt < 0)) | ((prev < 0) & (nxt > 0)))) | (tn >= hi)
        t = torch.where(act, tn, t)
        prev = torch.where(act, nxt, prev)
    return float(samples.sum())


def sharded_kernels(torch, report, dev, cfg, mesh, state, depth_np):
    """Phase 17's kernel checks at full width on the sharded state: C's,
    K's and D's slab modes on every shard, G's data-only matvec and the
    distributed PCG, P's init, ``enabled=False`` as the identity."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.ops import bricks, fusion, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded, sharded_fusion, sharded_raycast
    from dynamicfusion_tpu_torch.parallel.mesh import SlabVolume
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    n, d = mesh.n, cfg.volume_dims
    depth = torch.from_numpy(depth_np).to(dev)
    whole = sharded.gather_state(mesh, state)
    tr = kinfu.track(cfg, whole, depth)

    # C's slab mode: the model raycast's rays of the next frame, in its band
    halo = sharded_raycast._halo_planes(cfg)
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), tr.pose)
    seed, band = tr.bands
    org, dirs, tmin, tmax = tsdf_ops.rays(cfg, cam2vol, cfg.intr.level(cfg.raycast_shift), rows_t, cols_t, seed, band)
    exts = mesh.halo(state.vol.tsdf, halo)
    wins = [sharded_raycast.slab_window(cfg, k, n, org, dirs, tmin, tmax) for k in range(n)]
    errs, found, samples = [], 0, 0.0
    exact = True
    for k in range(n):
        x_off = k * (d // n) - halo
        got = tsdf_ops.march_slab(cfg, exts[k], x_off, org, dirs, *wins[k])
        ref = tsdf_ops.march_slab(cfg, exts[k], x_off, org, dirs, *wins[k], plain=True)
        f = ref[0]
        exact = exact and torch.equal(got[0], f) and torch.equal(got[4], ref[4])
        if bool(f.any()):
            errs += [float((got[1] - ref[1])[f].abs().max()), float((got[2] - ref[2])[f].abs().max()),
                     float(torch.nan_to_num((got[3] - ref[3])[f].abs(), nan=0.0).max())]
        found += int(f.sum())
        samples += slab_samples(torch, cfg, exts[k], x_off, org, dirs, *wins[k])
    err = max(errs + [0.0])
    check("raycast_slab", exact and err <= TOL_RAYCAST_M,
          f"{n} slabs of {d // n} + 2 x {halo} planes, {cols_t}x{rows_t} rays ({cfg.raycast_refine}): found and exit "
          f"events equal {exact}, max t/vertex/normal diff {err:.2e} (tol {TOL_RAYCAST_M}); {found} slab hits")
    step_len = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    refine = tsdf_ops._refine_mode(cfg)

    def march_all(plain):
        for k in range(n):
            if plain:
                tsdf_ops.march_slab(cfg, exts[k], k * (d // n) - halo, org, dirs, *wins[k], plain=True)
            else:
                kernels.march_and_refine(exts[k], org, dirs, *wins[k], cfg.voxel_size, step_len,
                                         tsdf_ops.march_steps(cfg), False, refine=refine,
                                         smooth=cfg.raycast_smooth_normals, delta=cfg.gradient_delta_factor,
                                         x_off=k * (d // n) - halo, d=d)

    gathers, ops = refine_work(cfg)
    nr = dirs.numel() // 3
    report["raycast_slab"] = dict(
        err=err, ms=cuda_ms(torch, lambda: march_all(False)), plain_ms=cuda_ms(torch, lambda: march_all(True), reps=3),
        # every shard: its slab's int16 samples and refine corners, the rays
        # and windows in, found/t/t_behind/vertex/normal out
        bound=bound_ms((samples + gathers * found) * 2 + n * nr * (12 + 8 + 1 + 8 + 24),
                       samples * 12.0 + found * ops),
        library_ms=None,
    )
    # the whole raycast's ownership against the single-device fixed-step raycast
    rc = sharded_raycast.make_sharded_raycast(cfg, mesh)
    ref_cfg = dataclasses.replace(cfg, raycast_adaptive_step=False)
    got = rc(cfg, state.vol, cam2vol, cfg.intr.level(cfg.raycast_shift), rows_t, cols_t, t_seed=seed, t_band=band)
    ref = tsdf_ops.raycast(ref_cfg, whole.vol, cam2vol, cfg.intr.level(cfg.raycast_shift), rows_t, cols_t,
                           t_seed=seed, t_band=band)
    ha, hb = ~torch.isnan(got.points[..., 0]), ~torch.isnan(ref.points[..., 0])
    both = ha & hb
    perr = float((got.points - ref.points)[both].abs().max())
    check("sharded_raycast", torch.equal(ha, hb) and perr <= TOL_RAYCAST_M,
          f"{n}-slab raycast against the fixed-step whole raycast: hit sets equal {torch.equal(ha, hb)} "
          f"({int(ha.sum())} hits), max point diff {perr:.2e} m (tol {TOL_RAYCAST_M})")

    # K and D's slab modes: the next frame's fusion of every slab
    g, b = cfg.knn_field_stride, cfg.brick_size
    cf = fusion.coarse_field(cfg, whole.warp)
    grid = se3.transform_points(se3.inverse(tr.pose), cf.warped)
    lookup = bricks.pack_depth_conf(tr.dists, tr.conf)
    band_cap, wide_cap = sharded_fusion.caps(cfg, n)
    on = torch.ones((), dtype=torch.bool, device=dev)
    plans, exact, fuse_err, dw_max, n_work, n_front = [], True, 0.0, 0, 0, 0
    dl = d // n
    for k in range(n):
        gk, qk = bricks.corner_slab(grid, k, n, b, g), bricks.corner_slab(cf.q, k, n, b, g)
        pk = bricks.plan_slab(cfg, tr.dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap)
        pp = bricks.plan_slab(cfg, tr.dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap, plain=True)
        exact = exact and same_plan(torch, pk, pp)
        vk = TsdfVolume(state.vol.tsdf[k].clone(), state.vol.weight[k].clone())
        vp = TsdfVolume(state.vol.tsdf[k].clone(), state.vol.weight[k].clone())
        bricks.fuse(cfg, vk, lookup, gk, g, cfg.intr, pk, on, qk, True)
        bricks.fuse(cfg, vp, lookup, gk, g, cfg.intr, pp, on, qk, True, plain=True)
        dt_ = (vk.tsdf.to(torch.int32) - vp.tsdf.to(torch.int32)).abs()
        fuse_err = max(fuse_err, float((dt_ > 1).float().mean()))
        dw_max = max(dw_max, int((vk.weight.to(torch.int32) - vp.weight.to(torch.int32)).abs().max()))
        cnt = int(pk.work.count[0])
        n_work += cnt
        n_front += int((pk.work.kind[:cnt] == bricks.FRONT).sum())
        plans.append((gk, qk, pk))
    check("brick_plan_slab", exact, f"{n} slabs of {band_cap} bricks (wide cap {wide_cap}): classes and lists equal "
          f"the plain version's {exact}; {n_work} listed bricks")
    check("fuse_bricks_slab", fuse_err < TOL_FUSE_NR_FRAC and dw_max == 0,
          f"codes > 1 LSB apart on {fuse_err:.2e} (tol {TOL_FUSE_NR_FRAC}), max weight diff {dw_max} (tol 0)")
    rows, cols = tr.dists.shape
    levels = int(math.ceil(math.log2(max(rows, cols)))) + 1
    total = sum((((rows + (1 << l) - 1) >> l) * ((cols + (1 << l) - 1) >> l)) for l in range(levels))
    nbr_loc = band_cap
    report["brick_plan_slab"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: [bricks.plan_slab(cfg, tr.dists, gk, g, cfg.intr, k * dl // b, band_cap, wide_cap)
                                   for k, (gk, _, _) in enumerate(plans)]),
        plain_ms=cuda_ms(torch, lambda: [bricks.plan_slab(cfg, tr.dists, gk, g, cfg.intr, k * dl // b, band_cap,
                                                          wide_cap, plain=True) for k, (gk, _, _) in enumerate(plans)],
                         reps=3),
        # every shard: dists, its grid slab and permutation in; the mip,
        # classes, windows, flags and list out (brick_plan's reckoning)
        bound=bound_ms(n * (rows * cols * 4 + plans[0][0].numel() * 4 + nbr_loc * 8 + total * 12
                            + nbr_loc * (8 + 4 + 4 + 1 + 8) + 16),
                       n * (total * 3.0 + nbr_loc * (27 * 25.0 + 16 * 50.0))),
        library_ms=None,
    )
    scratch = [TsdfVolume(t.clone(), w.clone()) for t, w in zip(state.vol.tsdf, state.vol.weight)]
    bv = b ** 3

    def fuse_all(plain):
        for v, (gk, qk, pk) in zip(scratch, plans):
            bricks.fuse(cfg, v, lookup, gk, g, cfg.intr, pk, on, qk, True, plain=plain)

    report["fuse_bricks_slab"] = dict(
        err=float(fuse_err > 0),
        ms=cuda_ms(torch, lambda: fuse_all(False)),
        plain_ms=cuda_ms(torch, lambda: fuse_all(True), reps=3),
        bound=bound_ms(n_work * bv * 8 + n * (lookup.numel() * 4 + plans[0][0].numel() * 4 + plans[0][1].numel() * 4
                                              + nbr_loc * 16),
                       n_front * bv * 8.0 + (n_work - n_front) * bv * 100.0),
        library_ms=None,
    )
    del scratch
    # K's cluster and D's persistent grid against their reference modes on every slab
    k_ref = k_gated = d_ref = d_ref_gated = d_gated = 0.0
    for k, (gk, qk, _) in enumerate(plans):
        slab = TsdfVolume(state.vol.tsdf[k], state.vol.weight[k])
        pk, one, gated = hold_plan(torch, f"brick_plan_slab_{k}", cfg, tr.dists, gk, g,
                                   slab=(k * dl // b, band_cap, wide_cap), what=f"slab {k} of {n}: ")
        ref, ref_gated, gated_d = hold_fuse(torch, f"fuse_bricks_slab_{k}", cfg, slab, lookup, gk, g, pk, qk, True,
                                            what=f"slab {k} of {n}: ")
        k_ref, k_gated = k_ref + one, k_gated + gated
        d_ref, d_ref_gated, d_gated = d_ref + ref, d_ref_gated + ref_gated, d_gated + gated_d
    report["brick_plan_slab"].update(reference_ms=k_ref, gated_ms=k_gated)
    report["fuse_bricks_slab"].update(reference_ms=d_ref, gated_ms=d_gated, reference_gated_ms=d_ref_gated)
    print(f"[time] slab modes over {n} shards: K {report['brick_plan_slab']['ms']:.4f} ms (one-block mode "
          f"{k_ref:.4f}, gated {k_gated:.4f}), D {report['fuse_bricks_slab']['ms']:.4f} ms (reference mode "
          f"{d_ref:.4f}; gated {d_gated:.4f}, reference {d_ref_gated:.4f})", flush=True)
    # enabled=False: every slab bit-identical
    fn = sharded_fusion.make_sharded_integrate(cfg, mesh)
    copy = SlabVolume(tuple(t.clone() for t in state.vol.tsdf), tuple(w.clone() for w in state.vol.weight))
    _, cnt = fn(cfg, copy, cf, tr.dists, se3.inverse(tr.pose), cfg.intr, ~on, conf=tr.conf,
                phase=torch.zeros((), dtype=torch.int32, device=dev))
    same = all(torch.equal(a, c) for a, c in zip(copy.tsdf, state.vol.tsdf)) and all(
        torch.equal(a.view(torch.int16), c.view(torch.int16)) for a, c in zip(copy.weight, state.vol.weight))
    check("sharded_fusion_disabled", same and cnt.tolist() == [0, 0, 0],
          f"enabled=False leaves every slab bit-identical {same}, counts {cnt.tolist()}")

    # G's data-only matvec and the distributed PCG on the next frame's system
    parts, p_all = distributed_gn.shard_inputs(cfg, tr.inputs, mesh)
    field = whole.warp
    nn_ = field.positions.shape[0]
    s = None
    shards = []
    for inp in parts:
        sk = ws.prepare(cfg, field, inp, global_points=p_all, edges=s)
        s = sk if s is None else s
        shards.append(sk)
    dts = [ws.data_term(cfg, sk, field.dq, True) for sk in shards]
    et = ws.edge_term(cfg, s, field.dq)
    hold_edge_order(torch, "edge_term_order_sharded", cfg, s, field.dq, f"the sharded solve's edge term ({SHARDS} "
                    f"shards): ")
    with deterministic(torch):
        blocks = mesh.psum([dt.blocks for dt in dts]) + et.diag
    diag_eff, unit = ws.damping_terms(cfg, field.active, blocks)
    hold_spd6(torch, "spd6_inv_sharded", blocks, diag_eff, unit, cfg.solver_lm_lambda_init,
              f"the sharded solve's psum'd blocks ({SHARDS} shards): ")
    damp = cfg.solver_lm_lambda_init * diag_eff + unit
    sysm = ws.System(dts[0].rows, et, damp)
    # the preconditioner as phase 2 holds kernel G's PCG: the float64
    # inverse of the damped blocks (the closed form is non-finite on some
    # of the solver's nearly singular blocks, in the kernel and the plain
    # version alike)
    minv = torch.linalg.inv((blocks + torch.diag_embed(damp.reshape(nn_, 6))).double()).float().contiguous()
    b_vec = mesh.psum([dt.jtr for dt in dts]) + et.jtr
    pv = torch.from_numpy(np.random.RandomState(2).randn(6 * nn_).astype(np.float32)).to(dev)
    errs, bits = [], True
    for sk, dt in zip(shards, dts):
        mk = kernels.data_matvec(dt.rows, sk.knn_idx32, sk.pts_by_node.order, sk.pts_by_node.off,
                                 sk.pts_by_node.heavy, pv)
        with deterministic(torch):
            mp = ws.data_matvec_plain(sk, sysm._replace(rows=dt.rows), pv).reshape(-1)
        errs.append(rel_err(torch, mk, mp))
        bits = bits and torch.equal(mk, ws.data_matvec_ordered(sk, sysm._replace(rows=dt.rows), pv).reshape(-1))
    check("data_matvec", max(errs) <= TOL_MATVEC_REL and bits,
          f"the reference mode's shard matvec, {n} shards of {shards[0].p_can.shape[0]} points: max relative diff "
          f"{max(errs):.2e} (tol {TOL_MATVEC_REL}); bit-equal to the plain version in the kernel's order {bits}")
    npt = shards[0].p_can.shape[0]
    lists_b = (npt * 8 + nn_ + 1) * 4
    on = torch.ones((), dtype=torch.bool, device=dev)
    iters, rtol = cfg.solver_linear_iters, cfg.solver_linear_tol
    sh_parts = [ws.Shard(sk, dt.rows) for sk, dt in zip(shards, dts)]
    solve = lambda **kw: ws.pcg_sharded(mesh, sh_parts, s, sysm, minv, b_vec, iters, rtol, on, **kw)  # noqa: E731
    (xk, one_launch) = kernels_a_call("pcg_sharded", solve)
    with deterministic(torch):
        xp = solve(plain=True)
    counted = dict(kernels.launches)
    xr = solve(reference=True)
    # the reference mode's device kernels: two a shard matvec, P's init, two
    # a step, and the psum's PyTorch adds
    ref_kernels = (2 * (kernels.launches["data_matvec"] - counted["data_matvec"])
                   + kernels.launches["pcg_init"] - counted["pcg_init"]
                   + 2 * (kernels.launches["pcg_step"] - counted["pcg_step"]) + (n - 1) * iters)
    finite = bool(torch.isfinite(xk).all()) and bool(torch.isfinite(xp).all())
    bits = torch.equal(xk, xp) and torch.equal(xk, xr)
    off_ok = not bool(ws.pcg_sharded(mesh, sh_parts, s, sysm, minv, b_vec, iters, rtol, ~on).any())
    # the same system solved whole by kernel G's cluster PCG (the shards'
    # rows are the whole subsample's, cut in n): another sum order, held as
    # phase 2 holds G against its plain version
    s1 = ws.prepare(cfg, field, tr.inputs)
    d1 = ws.data_term(cfg, s1, field.dq, True)
    x1 = ws.pcg(s1, ws.System(d1.rows, et, damp), minv, b_vec, iters, rtol, on)
    err1 = rel_err(torch, xk, x1)
    with deterministic(torch):
        spread = max(rel_err(torch, ws.pcg_sharded(mesh, sh_parts, s, sysm, minv, b1, iters, rtol, on, plain=True),
                             xp) for b1 in ulp_moves(torch, b_vec))
    tol1 = max(TOL_PCG_REL, SPREAD_PCG * spread)
    check("pcg_sharded", finite and bits and off_ok and err1 <= tol1 and one_launch == 1,
          f"{n} shards, up to {iters} iterations over 6N = {6 * nn_}: finite {finite}, one device kernel a solve "
          f"{one_launch} (the reference mode's {ref_kernels}); bit-equal to the plain version in the kernels' order "
          f"and to the reference mode (the composition it replaced) {bits} (max relative diff "
          f"{rel_err(torch, xk, xp):.2e}); inactive -> 0 {off_ok}; against kernel G's whole PCG on the same system "
          f"{err1:.2e} (tol max({TOL_PCG_REL}, {SPREAD_PCG} x the plain PCG's one-ulp spread {spread:.2e}))")
    hold_sharded_pcg_modes(torch, dev, cfg, s1, d1.rows, et, damp, minv, b_vec, iters, rtol)
    # the iterations this right-hand side runs (the plain version's loop)
    ran, x, r = iters, torch.zeros_like(b_vec), b_vec
    z = ws.apply_m_ordered(minv, r)
    pdir, rz = z, ws.dot_ordered(r, z)
    stop2 = (rtol * rtol) * ws.dot_ordered(b_vec, b_vec)
    for it in range(iters):
        if not bool(ws.dot_ordered(r, r) > stop2):
            ran = it
            break
        apd = mesh.psum([ws.data_matvec_ordered(sk, sysm._replace(rows=dt.rows), pdir).reshape(-1)
                         for sk, dt in zip(shards, dts)])
        ap = ws.edge_apply_plain(s, et, pdir, apd, damp)
        alpha = rz / torch.clamp(ws.dot_ordered(pdir, ap), min=1e-30)
        x, r = x + alpha * pdir, r - alpha * ap
        z = ws.apply_m_ordered(minv, r)
        rz_n = ws.dot_ordered(r, z)
        pdir, rz = z + rz_n / torch.clamp(rz, min=1e-30) * pdir, rz_n
    # the yardstick: the same iterations in PyTorch calls (each shard's two
    # cuSPARSE CSR products, the psum's adds, one CSR product of the edge
    # blocks and the damping)
    csrs = [factored_csr(torch, ws, sk, sysm._replace(rows=dt.rows), edges=False) for sk, dt in zip(shards, dts)]
    edges_csr = factored_csr(torch, ws, s, sysm)[2]
    lib = lambda: library_pcg_sharded(torch, mesh, csrs, edges_csr, minv, b_vec, iters, rtol, on)  # noqa: E731
    lerr = rel_err(torch, lib(), xk)
    check("pcg_sharded_library", lerr <= tol1,
          f"the yardstick (PyTorch calls: cuSPARSE CSR products, the psum, torch.bmm and torch.dot) solves the same "
          f"system: max relative diff {lerr:.2e} from the kernel (tol {tol1:.2e}, as against G's whole PCG)")
    ne = s.e_src.shape[0]
    per_iter = n * npt * 8 * 6 * 2 * 2 + ne * 2 * 72 * 2 + nn_ * (72 + 60)
    report["pcg_step"] = dict(
        err=abs_err(torch, xk, xp),
        ms=cuda_ms(torch, solve),
        reference_ms=cuda_ms(torch, lambda: solve(reference=True)),
        plain_ms=cuda_ms(torch, lambda: solve(plain=True), reps=3),
        # the whole distributed solve: every shard's rows and lists, the
        # edge blocks, damping, preconditioner and b read once, x written
        bound=bound_ms(n * (npt * (96 + 32) + lists_b + nn_ * 8) + ne * (3 * 144 + 4 + 4) + (nn_ + 1) * 4
                       + nn_ * (24 + 144 + 24) + nn_ * 24, ran * per_iter + nn_ * 72.0),
        library_ms=cuda_ms(torch, lib, reps=5),
        iterations=ran,
    )
    rep = report["pcg_step"]
    print(f"[time] the distributed PCG, {n} shards, {ran} of {iters} iterations: {rep['ms']:.4f} ms in "
          f"{one_launch} device kernel; the reference mode (the composition) {rep['reference_ms']:.4f} ms in "
          f"{ref_kernels} device kernels; plain {rep['plain_ms']:.4f} ms; library {rep['library_ms']:.4f} ms",
          flush=True)
    # the reference mode's pieces: P's init and one shard's data matvec
    xi, work = kernels.pcg_sharded_init(minv, b_vec, iters, rtol, on)
    zp = ws.apply_m_ordered(minv, b_vec)
    init_ok = (torch.equal(xi, torch.zeros_like(xi)) and torch.equal(work[:6 * nn_], b_vec)
               and torch.equal(work[6 * nn_: 12 * nn_], zp) and torch.equal(work[12 * nn_: 18 * nn_], zp)
               and float(work[4 * 6 * nn_]) == float(ws.dot_ordered(b_vec, zp)))
    check("pcg_init", init_ok, f"the reference mode's init: x = 0, r = b, p = z, z = M b and rᵀz bit-equal to the "
          f"plain version in kernel P's order {init_ok} (max |z - z_plain| "
          f"{abs_err(torch, work[6 * nn_: 12 * nn_], zp):.2e})")
    sh0, dt0 = shards[0], dts[0]
    init_ms = cuda_ms(torch, lambda: kernels.pcg_sharded_init(minv, b_vec, iters, rtol, on))
    mv_ms = cuda_ms(torch, lambda: kernels.data_matvec(dt0.rows, sh0.knn_idx32, sh0.pts_by_node.order,
                                                       sh0.pts_by_node.off, sh0.pts_by_node.heavy, pv))
    print(f"[time] the reference mode's pieces: P's init {init_ms:.4f} ms, one shard's data matvec {mv_ms:.4f} ms",
          flush=True)


def hold_sharded_pcg_modes(torch, dev, cfg, s1, rows1, et, damp, minv, b, iters, rtol):
    """The distributed PCG's one launch bit-equal to ``pcg_sharded_plain``
    and to the reference mode at 1, 2 and 4 shards cut from one system
    (``distributed_gn.shard_structure``), for R = 1 and for R = 3 (seeded
    bf16 tangential rows beside the system's plane rows) in each row mode,
    p in shared and in device memory and the two-launch mode of a process
    group (the identity as the ranks' sum); inactive gives 0. At 9 and 16
    shards on the card, past ``kernels.MAX_SHARDS``, ``pcg_sharded`` takes
    the composition (no cluster launch), solves without raising and is
    bit-equal to the plain version."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    on = torch.ones((), dtype=torch.bool, device=dev)
    rng = np.random.RandomState(3)
    scale = 0.3 * float(rows1.float().abs().mean())
    tang = torch.from_numpy((scale * rng.randn(rows1.shape[0], 2, 8, 6)).astype(np.float32)).to(dev, torch.bfloat16)
    rows3 = torch.cat([rows1, tang], 1).contiguous()
    results = []
    for shards_n in (1, 2, 4, 9, 16):
        mesh = sharded.make_mesh(shards_n, devices=[dev] * shards_n)
        parts = distributed_gn.shard_structure(s1, mesh)
        chunk = parts[0].p_can.shape[0]
        for rows, modes in ((rows1, ((None, 1),)), (rows3, ((None, 1), (1, 1), (None, 4)))):
            pad = torch.zeros((chunk * shards_n - rows.shape[0], *rows.shape[1:]), dtype=rows.dtype, device=dev)
            cut = torch.cat([rows, pad]).split(chunk)
            sh = [ws.Shard(sk, r.contiguous()) for sk, r in zip(parts, cut)]
            for used, stride in modes:
                sysm = ws.System(cut[0].contiguous(), et, damp, used, stride)
                solve = lambda **kw: ws.pcg_sharded(mesh, sh, s1, sysm, minv, b, iters, rtol, on, **kw)  # noqa: E731
                one_before = kernels.device_kernels["pcg_sharded"]
                xk = solve()
                one = kernels.device_kernels["pcg_sharded"] - one_before
                with deterministic(torch):
                    xp = solve(plain=True)
                if shards_n > kernels.MAX_SHARDS:
                    ok = (one == 0 and bool(torch.isfinite(xk).all()) and torch.equal(xk, xp)
                          and not bool(ws.pcg_sharded(mesh, sh, s1, sysm, minv, b, iters, rtol, ~on).any()))
                    results.append((shards_n, rows.shape[1], used, stride, ok))
                    continue
                ks = ws._kernel_system(s1, sysm)
                data = [kernels.ShardData(q.rows, q.s.knn_idx32, q.s.pts_by_node.order, q.s.pts_by_node.off,
                                          ws.heavy_order(q.s.pts_by_node)) for q in sh]
                xd = kernels.pcg_sharded(ks, data, minv, b, iters, rtol, on, used=used, stride=stride,
                                         shared_p=False)
                xg = kernels.pcg_sharded(ks, data, minv, b, iters, rtol, on, used=used, stride=stride,
                                         reduce=lambda v: v.clone())
                ok = (one == 1 and bool(torch.isfinite(xk).all()) and torch.equal(xk, xp)
                      and torch.equal(xk, solve(reference=True))
                      and torch.equal(xk, xd) and torch.equal(xk, xg)
                      and not bool(ws.pcg_sharded(mesh, sh, s1, sysm, minv, b, iters, rtol, ~on).any()))
                results.append((shards_n, rows.shape[1], used, stride, ok))
    check("pcg_sharded_modes", all(r[-1] for r in results),
          f"one launch (to {kernels.MAX_SHARDS} shards; the composition past them) bit-equal to the plain version and "
          f"the reference mode, p in device memory and the two-launch mode alike, inactive -> 0, at (shards, R, rows "
          f"used, stride) {[r[:4] for r in results if r[-1]]}; failed at {[r[:4] for r in results if not r[-1]]}")


def check_sharded_one_launch(tag, cfg, launches, steps):
    """The distributed PCG of a one-process mesh on one card: one device
    kernel a solve, a solve an LM iteration of every step, the reference
    mode's kernels never."""
    solves = steps * cfg.solver_nonlinear_iters
    got = (launches["pcg_sharded"], launches["pcg_sharded[device kernels]"])
    check(f"{tag}_pcg_one_launch", got == (solves, solves) and not any(launches[k] for k in SHARD_REFERENCE),
          f"(calls, device kernels) of the distributed PCG {got}, one each for the {solves} solves of {steps} steps; "
          f"the reference mode's launches {[launches[k] for k in SHARD_REFERENCE]}")


def sharded_main(torch, args, dev, card, nr_depths, report, cfg=None):
    """Phase 17: ``default_dynamicfusion()`` (or ``cfg``) over
    ``make_mesh(4)`` on the card (64-plane slabs): the sharded step's
    checks, the kernel checks of the slab and shard modes, the profile
    beside the single-device preset's."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.parallel import sharded
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = cfg or DynamicFusionConfig.default_dynamicfusion()
    mesh = sharded.make_mesh(SHARDS, devices=[dev] * SHARDS)
    frames = nr_depths[: args.s_frames]
    launches, rows, frame_ms, runner = drive_sharded(torch, "sharded", cfg, mesh, dev, frames)
    shard_kernels = ("raycast", "brick_plan", "fuse_bricks", "pcg_sharded", "data_term",
                     "edge_term", "spd6_inv", "frame_maps", "knn_blend", "insert_select", "insert_apply", "extract_cloud",
                     "sample_nodes", "march_bands", "icp_reduce", "bilateral")
    check("sharded_launches", all(launches[k] > 0 for k in shard_kernels) and launches["pcg"] == 0
          and not any(launches[k] for k in SHARD_REFERENCE),
          f"every kernel of the sharded path launched, kernel G's single-device PCG and the distributed PCG's "
          f"reference mode none: {launches}")
    check_sharded_one_launch("sharded", cfg, launches, len(frames) - 1)
    check("sharded_icp_ok", all(r["ok"] for r in rows), f"ICP healthy on every step ({len(rows)})")
    due = [i for i in range(1, len(frames)) if i % cfg.fusion_interval == 0]
    fused = [i for i, r in enumerate(rows, start=1) if r["bricks"][0] + r["bricks"][1] > 0]
    check("sharded_fusion", fused == due, f"fusion on frames {fused} (due {due})")
    steps = len(frames) - 1
    steady = sorted(frame_ms[2:])
    print(f"[time] {card} | sharded ({SHARDS} shards on one card) frame ms median {steady[len(steady) // 2]:.3f} "
          f"(frames 2..{steps}), frame 0 {frame_ms[0]:.3f}; the port's kernels launched "
          f"{sum(launches.values()) / steps:.1f} times a step", flush=True)
    sharded_kernels(torch, report, dev, cfg, mesh, runner.state, nr_depths[args.s_frames])
    prof = profile_frames(torch, args, dev, card, runner, nr_depths[args.s_frames + 1: args.s_frames + 4],
                          tag="sharded", focus=("raycast_kernel", "sharded_pcg_kernel", "insert_write",
                                                "update_kernel", "fuse_bricks"))
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in nr_depths[: args.s_frames]:
        df(d, block=False)
    one = profile_frames(torch, args, dev, card, df, nr_depths[args.s_frames + 1: args.s_frames + 4], tag="single")
    print(f"[sharded] {card} | {SHARDS} shards on one H100 (the cost of sharding, not a multi-card rate): 3 frames "
          f"{prof['wall_ms'] / 3:.3f} ms a frame, idle {1.0 - prof['busy_ms'] / prof['wall_ms']:.3f}, "
          f"{prof['launches'] / 3:.0f} launches a frame; single device {one['wall_ms'] / 3:.3f} ms, idle "
          f"{1.0 - one['busy_ms'] / one['wall_ms']:.3f}, {one['launches'] / 3:.0f} launches a frame", flush=True)
    return launches


def sharded_base_main(torch, args, dev, card, nr_depths, report, cfg=None):
    """Phase 18: three steps of the base ``DynamicFusionConfig()`` over
    ``make_mesh(4)`` (the summed Schur assembly: N's shard mode with the
    pmax'd scales), each held against the single-device step; N's shard
    mode against its plain version and the psum'd Gram against the
    single-device N."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    cfg = cfg or DynamicFusionConfig()
    mesh = sharded.make_mesh(SHARDS, devices=[dev] * SHARDS)
    launches, rows, frame_ms, runner = drive_sharded(torch, "sharded_base", cfg, mesh, dev, nr_depths[:4],
                                                     hold_from=1)
    check("sharded_base_launches", all(launches[k] > 0 for k in ("gram_scales", "dense_gram", "dense_damp",
                                                                 "cholesky", "raycast", "brick_plan", "fuse_bricks")),
          f"N (shard mode), O, the factor, the slab raycast and fusion launched: {launches}")
    # N's shard mode at the next frame's system
    whole = sharded.gather_state(mesh, runner.state)
    tr = kinfu.track(cfg, whole, torch.from_numpy(nr_depths[4]).to(dev))
    s = ws.prepare(cfg, whole.warp, tr.inputs)
    shards = distributed_gn.shard_structure(s, mesh)
    dq = whole.warp.dq
    dts = [ws.data_term(cfg, sk, dq, True) for sk in shards]
    scale = mesh.pmax([ws.gram_scales(sk, dt) for sk, dt in zip(shards, dts)])
    grams, same = [], True
    for sk, dt in zip(shards, dts):
        gk = ws.data_gram(cfg, sk, dt, scale)
        same = same and torch.equal(gk, ws.data_gram(cfg, sk, dt, scale, plain=True))
        grams.append(gk)
    et = ws.edge_term(cfg, s, dq)
    hold_edge_order(torch, "edge_term_order_sharded_base", cfg, s, dq, "the sharded base config's edge term: ")
    dt1 = ws.data_term(cfg, s, dq, True)
    one = ws.dense_gram(cfg, s, dt1, et)
    summed = mesh.psum(grams) + ws.edge_jtj(s, et)
    err = rel_err(torch, summed, one)
    scale1 = ws.gram_scales(s, dt1)
    check("dense_gram_shard", same and err <= TOL_SHARD_GRAM_REL and torch.equal(scale, scale1),
          f"{SHARDS} shards' int8 Grams with the pmax'd scales (equal to the whole rows' {torch.equal(scale, scale1)}) "
          f"bit-equal to the plain version {same}; psum + edge blocks against the single-device N: max relative "
          f"diff {err:.2e} (tol {TOL_SHARD_GRAM_REL})")
    n = dq.shape[0]
    npt = shards[0].p_can.shape[0]
    sk0, dt0 = shards[0], dts[0]
    products = npt * 8 * 288 * dt0.rows.shape[1]
    lib_shard = lambda: library_gram(torch, dt0.rows, sk0.knn_idx, n, True, scale)  # noqa: E731
    err = rel_err(torch, lib_shard(), ws.dense_gram_plain(dt0.rows, sk0.knn_idx, True, None, None, None, None,
                                                          scale=scale, n=n))
    check("dense_gram_shard_library", err <= TOL_GRAM_LIBRARY_REL,
          f"the shard mode's yardstick (expansion, quantization by the given scales, torch._int_mm, the scale "
          f"product) computes the same function: max relative diff {err:.2e} (tol {TOL_GRAM_LIBRARY_REL})")
    report["dense_gram_shard"] = dict(
        err=0.0 if same else float("inf"),
        ms=cuda_ms(torch, lambda: ws.data_gram(cfg, sk0, dt0, scale), reps=10),
        plain_ms=cuda_ms(torch, lambda: ws.data_gram(cfg, sk0, dt0, scale, plain=True), reps=3),
        # one shard: its rows, ids, lists and the scales in, the (6N)^2 matrix out
        bound=bound_ms(npt * (96 + 64) + (npt * 8 + n + 1) * 4 + 6 * n * 4 + (6 * n) ** 2 * 4, 2.0 * products,
                       PEAK_INT8),
        # the shard's rows expanded, quantized by the given scales, torch._int_mm and the scale product
        library_ms=cuda_ms(torch, lib_shard, reps=10),
    )
    steady = sorted(frame_ms[1:])
    print(f"[time] {card} | sharded base config ({SHARDS} shards on one card) frame ms median "
          f"{steady[len(steady) // 2]:.3f} over {len(steady)} steps", flush=True)
    return launches


def multiprocess_main(torch, args, dev, card, config="preset"):
    """Phase 19: ``parallel.multihost``'s worker as two processes on the
    card over gloo, two local shards each, for 3 preset frames at full
    width: the ranks' results equal, and every frame's pose and costs
    bit-equal to the one-process ``make_mesh(4)`` run (the same reduction
    tree); NCCL on distinct cards where there are two."""
    import os
    import socket
    import tempfile

    from dynamicfusion_tpu_torch.parallel import multihost, sharded

    root = os.path.dirname(os.path.abspath(__file__))

    def launch(world, device, frames, backend=None):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        tmp = tempfile.mkdtemp(prefix="df_mp_")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dynamicfusion_tpu_torch.parallel.multihost", "--init-method",
             f"tcp://localhost:{port}", "--world-size", str(world), "--rank", str(r), "--local-shards", "2",
             "--device", device, "--config", config, "--frames", str(frames), "--out", outs[r]]
            + (["--backend", backend] if backend else []),
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(log[-4000:])
            check(f"multihost_rank{r}", p.returncode == 0, f"rank {r} exited {p.returncode}")
        return [json.loads(open(o).read()) for o in outs]

    t0 = time.perf_counter()
    res = launch(2, dev.type, 3, backend="gloo")
    wall = time.perf_counter() - t0
    one = multihost.run_frames(multihost.worker_config(config), sharded.make_mesh(4, devices=[dev] * 4), 3)
    ranks_equal = res[0]["frames"] == res[1]["frames"]
    bit_equal = res[0]["frames"] == one
    print(f"[multihost] {card} | 2 ranks x 2 shards over {res[0]['backend']} on {res[0]['device']}: {wall:.1f} s "
          f"wall (each rank {res[0]['seconds']:.1f} s for frame 0 and 3 steps)", flush=True)
    for i, (a, b) in enumerate(zip(res[0]["frames"], one), start=1):
        print(f"[multihost] step {i}: pose max |diff| {max(abs(x - y) for x, y in zip(a['pose'], b['pose'])):.3e}, "
              f"cost0 {a['cost0']!r} / {b['cost0']!r}, cost1 {a['cost1']!r} / {b['cost1']!r}")
    if not bit_equal:
        # the fallback the design allows: the first step within the step tolerances
        a, b = res[0]["frames"][0], one[0]
        pose = max(abs(x - y) for x, y in zip(a["pose"], b["pose"]))
        c0 = abs(a["cost0"] - b["cost0"]) / max(abs(b["cost0"]), 1e-30)
        print("[multihost] NOT bit-equal to the one-process mesh: holding the first step instead", flush=True)
        check("multihost_first_step", pose <= TOL_STEP_POSE and c0 <= TOL_STEP_COST0_REL,
              f"pose {pose:.2e} (tol {TOL_STEP_POSE}), cost0 {c0:.2e} (tol {TOL_STEP_COST0_REL})")
    check("multihost", ranks_equal and all(f["icp_ok"] for f in one),
          f"ranks' poses and costs equal {ranks_equal}; bit-equal to make_mesh(4) in one process on every step "
          f"{bit_equal}")
    # under the process group the distributed PCG is two launches an
    # iteration around the ranks' all-reduce
    cfg = multihost.worker_config(config)
    iterations = 3 * cfg.solver_nonlinear_iters * max(cfg.solver_linear_iters, 1)
    got = [(r["launches"]["pcg_sharded"], r["device_kernels"]["pcg_sharded"]) for r in res]
    check("multihost_two_launches", all(g == (2 * iterations, 2 * iterations) for g in got)
          and not any(r["launches"][k] for r in res for k in SHARD_REFERENCE),
          f"each rank's (calls, device kernels) of the distributed PCG {got}: two an iteration for the "
          f"{iterations} iterations of its solves; the reference mode's launches none")
    if torch.cuda.device_count() >= 2:
        res = launch(2, "cuda", 3, backend="nccl")
        check("multihost_nccl", res[0]["backend"] == "nccl" and res[0]["frames"] == res[1]["frames"],
              f"NCCL on two cards: backend {res[0]['backend']}, ranks equal")
    else:
        print(f"[multihost] NCCL did not run: {torch.cuda.device_count()} card (NCCL needs one card a rank)",
              flush=True)


# ---------------------------------------------------------------- the float storages, default_kinfu() (phases 20-23)

# the (tsdf, weight) storages of the JAX config (config.py:484-499) beside the
# default (i16, u16); kernels C and R read the tsdf only, held at its two
# float storages
STORAGES = (("i16", "f32"), ("f32", "u16"), ("f32", "f32"), ("bf16", "u16"), ("bf16", "f32"))
TSDF_STORAGES = ("f32", "bf16")
# kernel C's modes held at each float tsdf: every refine, with the in-cell
# and with the six-sample normal
STORAGE_RAYCASTS = tuple((r, s) for s in (False, True) for r in ("secant", "newton8", "newton16", "hybrid16"))
# the preset's frames under the storages other than f32/f32 (frame 6 fuses)
STORAGE_FRAMES = 7
# every kernel at every float storage is held bit-equal to its plain
# version on the same inputs: the codes, weights and counts of D, F1, F2
# and L, the hits, vertices, normals (and the slab mode's t and exit
# events) of C, the normals of R; the float storages decode by 1 and the
# float32 arithmetic is the plain version's operation for operation

def _storage_row(name, src, rep, counter, path):
    ROWS[name] = (src, rep)
    COUNTER[name] = counter
    PATH[name] = path


# the JSON rows of the storages and of the 512^3 volume: (source, the TPU
# kernel-role function, the launch counter, the run whose counters they are)
for _t in TSDF_STORAGES:
    _storage_row(f"raycast_newton8_{_t}", "raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:529", "raycast",
                 f"preset_{_t}_f32")
    _storage_row(f"raycast_newton16_{_t}", "raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:529", "raycast",
                 f"dense_{_t}_f32")
    _storage_row(f"extract_normals_{_t}", "normals.cu", "dynamicfusion_tpu/ops/tsdf.py:724", "extract_normals",
                 f"export_{_t}_f32")
for _t, _w in STORAGES:
    _tag = f"{_t}_{_w}"
    _storage_row(f"fuse_bricks_nonrigid_{_tag}", "fuse_bricks.cu", "dynamicfusion_tpu/ops/bricks.py:552",
                 "fuse_bricks", f"preset_{_tag}")
    _storage_row(f"integrate_dense_{_tag}", "fuse_dense.cu", "dynamicfusion_tpu/ops/tsdf.py:169", "integrate_dense",
                 f"dense_{_tag}")
    _storage_row(f"integrate_dense_nonrigid_{_tag}", "fuse_dense.cu", "dynamicfusion_tpu/ops/fusion.py:174",
                 "integrate_dense_nonrigid", f"dense_{_tag}")
    _storage_row(f"extract_cloud_{_tag}", "extract.cu", "dynamicfusion_tpu/ops/tsdf.py:669", "extract_cloud",
                 f"preset_{_tag}")
_storage_row("raycast_grad6_secant_f32", "raycast.cu", "dynamicfusion_tpu/ops/tsdf.py:610", "raycast",
             "ref_rigid_f32_f32")
_storage_row("raycast_slab_f32", "raycast.cu", "dynamicfusion_tpu/parallel/sharded_raycast.py:176", "raycast",
             "sharded_f32_f32")
_storage_row("fuse_bricks_slab_f32_f32", "fuse_bricks.cu", "dynamicfusion_tpu/parallel/sharded_fusion.py:156",
             "fuse_bricks", "sharded_f32_f32")
# default_kinfu()'s 512^3 volume: K at its 32^3 brick grid, L at 4 096 blocks of 64 rows
_storage_row("brick_plan_512", "classify.cu", "dynamicfusion_tpu/ops/bricks.py:213", "brick_plan", "kinfu")
_storage_row("extract_cloud_512", "extract.cu", "dynamicfusion_tpu/ops/tsdf.py:669", "extract_cloud", "kinfu")


def stored(cfg, vol, tsdf_dtype, weight_dtype="f32"):
    """(``cfg`` with that storage, ``vol`` re-encoded into it)."""
    from dynamicfusion_tpu_torch.models import volume as volume_model

    c = dataclasses.replace(cfg, tsdf_dtype=tsdf_dtype, weight_dtype=weight_dtype)
    return c, volume_model.convert(vol, c)


def ordered(torch, t):
    """A volume tensor's values as integers in value order, so that the
    difference of two is their distance in codes (i16, u16) or ulps (f32,
    bf16)."""
    if t.dtype == torch.int16:
        return t.to(torch.int64)
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    width = 16 if t.element_size() == 2 else 32
    b = t.view(torch.int16 if width == 16 else torch.int32).to(torch.int64) & ((1 << width) - 1)
    sign = 1 << (width - 1)
    return torch.where(b & sign != 0, -(b & (sign - 1)), b)


def apart(torch, a, b):
    """The largest distance of two volume tensors in codes or ulps."""
    return int((ordered(torch, a) - ordered(torch, b)).abs().max())


def same_map(torch, a, b) -> bool:
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def vox_bytes(vol) -> int:
    """A voxel's stored bytes, tsdf and weight."""
    return vol.tsdf.element_size() + vol.weight.element_size()


def normal_voxels(torch, cfg, pts, valid) -> int:
    """The distinct voxels that kernel R's six samples read at the valid
    rows (each once, for its bound)."""
    p_vox = (pts[valid] - torch.tensor(cfg.volume_origin, device=pts.device)) / cfg.voxel_size
    d = cfg.volume_dims
    cells = []
    for axis in range(3):
        for sgn in (1.0, -1.0):
            q = p_vox.clone()
            q[:, axis] += sgn * cfg.gradient_delta_factor
            base = torch.floor(q).long().clamp(0, d - 2)
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        cells.append(((base[:, 0] + dx) * d + base[:, 1] + dy) * d + base[:, 2] + dz)
    return int(torch.unique(torch.cat(cells)).numel())


def library_extract(torch, cfg, vol, maxp, mw):
    """Kernel L's extraction in PyTorch calls (its library column; the
    port never calls it): the crossing flags as the plain version forms
    them, ``torch.nonzero`` of the concatenated flags, the gather and the
    point arithmetic of the plain version, the NaN fill."""
    from dynamicfusion_tpu_torch.models import volume as volume_model

    d = cfg.volume_dims
    tsdf = volume_model.decode_tsdf(vol.tsdf)
    w = volume_model.decode_weight(vol.weight)
    flags = torch.cat([((w.narrow(a, 0, d - 1) >= mw) & (w.narrow(a, 1, d - 1) >= mw)
                        & (tsdf.narrow(a, 0, d - 1) * tsdf.narrow(a, 1, d - 1) < 0)).reshape(-1) for a in range(3)])
    sel = torch.nonzero(flags).squeeze(1)[:maxp]
    n = sel.numel()
    per_axis = (d - 1) * d * d
    axis = sel // per_axis
    rem = sel % per_axis
    nk = torch.where(axis == 2, d - 1, d)
    nj = torch.where(axis == 1, d - 1, d)
    k = rem % nk
    j = (rem // nk) % nj
    i = rem // (nk * nj)
    step = torch.stack([axis == 0, axis == 1, axis == 2], dim=-1).to(torch.int64)
    t0 = tsdf.reshape(-1)[(i * d + j) * d + k]
    t1 = tsdf.reshape(-1)[((i + step[:, 0]) * d + j + step[:, 1]) * d + k + step[:, 2]]
    den = t0 - t1
    alpha = t0 / torch.where(torch.abs(den) > 1e-12, den, 1e-12)
    idx = torch.stack([i, j, k], dim=-1).to(torch.float32) + step.to(torch.float32) * alpha[:, None]
    points = torch.full((maxp, 3), float("nan"), device=tsdf.device)
    points[:n] = idx * cfg.voxel_size + volume_model.origin(cfg, tsdf.device)
    valid = torch.arange(maxp, device=tsdf.device) < n
    return points, valid, flags.sum(dtype=torch.int32)


def extract_block_cut(torch, cfg, vol, mw=1.0):
    """A row cap inside one block's run of the row listing's axis 1
    (``kernels.EXTRACT_ROWS`` rows a block): the first block with at least
    four +y crossings, cut after half of them; from the plain flags."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.models import volume as volume_model

    d = cfg.volume_dims
    tsdf = volume_model.decode_tsdf(vol.tsdf)
    w = volume_model.decode_weight(vol.weight)
    n = [int((((w.narrow(a, 0, d - 1) >= mw) & (w.narrow(a, 1, d - 1) >= mw)
               & (tsdf.narrow(a, 0, d - 1) * tsdf.narrow(a, 1, d - 1) < 0))).sum()) for a in range(2)]
    fy = (w[:, :-1] >= mw) & (w[:, 1:] >= mw) & (tsdf[:, :-1] * tsdf[:, 1:] < 0)
    # axis 1's rows (i, j < d - 1) of the volume's rows (i, j), by block
    per_row = torch.zeros((d, d), dtype=torch.int64, device=tsdf.device)
    per_row[:, :-1] = fy.sum(-1)
    per_block = per_row.reshape(-1, kernels.EXTRACT_ROWS).sum(-1)
    b = int(torch.nonzero(per_block >= 4)[0])
    return n[0] + int(per_block[:b].sum()) + int(per_block[b]) // 2


# kernel L's adversarial volumes (numpy, seeded): (side, tsdf storage,
# weight storage); the tsdf codes or values at the edges of the crossing
# test (0 and -0.0, the i16 extremes, float32 values whose products
# underflow to 0), the weights at both sides of the threshold of
# min_weight 1.0 (u16 codes 511, 512, 513; float32 1 -+ an ulp)
EXTRACT_CASES = {"i16_u16_32": (32, "i16", "u16"), "i16_u16_64": (64, "i16", "u16"),
                 "i16_u16_256": (256, "i16", "u16"), "f32_f32_64": (64, "f32", "f32"),
                 "bf16_u16_128": (128, "bf16", "u16"), "i16_f32_64": (64, "i16", "f32")}


def extract_case(torch, dev, name, seed=0):
    """(config, volume) of ``EXTRACT_CASES[name]``: a seeded mix of a
    smooth field's signs and the edge values above, on ``dev``."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume

    d, ts, ws = EXTRACT_CASES[name]
    rng = np.random.RandomState(seed)
    g = np.arange(d, dtype=np.float64) / d
    field = (np.sin(7.0 * g)[:, None, None] + np.cos(5.0 * g)[None, :, None] + np.sin(3.0 * g + 1.0)[None, None, :]
             - 0.4 + 0.3 * rng.randn(d, d, d))
    pick = rng.rand(d, d, d)
    if ts == "i16":
        t = np.clip(np.round(field * 20000.0), -32767, 32767)
        edge = rng.choice([-32768, -32767, -1, 0, 1, 32767], size=(d, d, d))
        tsdf = torch.from_numpy(np.where(pick < 0.3, edge, t).astype(np.int16))
    else:
        edge = rng.choice(np.array([0.0, -0.0, 1e-30, -1e-30, 1e-44, -1e-44, 1.0, -1.0], dtype=np.float32),
                          size=(d, d, d))
        t = torch.from_numpy(np.where(pick < 0.3, edge, field.astype(np.float32)).astype(np.float32))
        tsdf = t if ts == "f32" else t.to(torch.bfloat16)
    if ws == "u16":
        weight = torch.from_numpy(rng.choice([0, 511, 512, 513, 2048, 65535], size=(d, d, d)).astype(np.uint16))
    else:
        weight = torch.from_numpy(rng.choice(np.array([0.0, np.nextafter(np.float32(1), np.float32(0)), 1.0,
                                                        np.nextafter(np.float32(1), np.float32(2)), 4.0],
                                                       dtype=np.float32), size=(d, d, d)))
    cfg = dataclasses.replace(DynamicFusionConfig.small(dims=d), tsdf_dtype=ts, weight_dtype=ws)
    return cfg, TsdfVolume(tsdf.to(dev), weight.to(dev))


def hold_extract_cases(torch, dev, name="extract_cases"):
    """Kernel L on ``EXTRACT_CASES``: the row listing bit-equal to its plain
    version and its reference mode, uncapped and capped at half the
    count."""
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    parts = {}
    for case in EXTRACT_CASES:
        cfg, vol = extract_case(torch, dev, case)
        n = int(tsdf_ops.extract_cloud(cfg, vol, 1, min_weight=1.0, plain=True).count)
        ok = n > 0
        for m in (n + 100, n // 2 + 1):
            ck = tsdf_ops.extract_cloud(cfg, vol, m, min_weight=1.0)
            for other in (tsdf_ops.extract_cloud(cfg, vol, m, min_weight=1.0, plain=True),
                          tsdf_ops.extract_cloud(cfg, vol, m, min_weight=1.0, reference=True)):
                ok = ok and torch.equal(ck.valid, other.valid) and torch.equal(ck.count, other.count) and same_map(
                    torch, ck.points, other.points)
        parts[case] = (n, ok)
    check(name, all(ok for _, ok in parts.values()),
          f"the row listing against plain and the reference mode, uncapped and at half, on the adversarial volumes "
          f"(crossings, equal bit for bit): {parts}")


def hold_extract(torch, report, name, cfg, vol, maxp):
    """Kernel L's extraction (the row listing) against its plain version
    and its reference mode, points, flags and the uncapped count bit for
    bit, two device kernels a call against the reference mode's four
    (``kernels_a_call``), also capped at a cut inside one block's run
    (``extract_block_cut``) and at 700 rows; the library route
    (``library_extract``) bit for bit too; each timed. Returns the plain
    cloud."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    def same(a, b):
        return torch.equal(a.valid, b.valid) and torch.equal(a.count, b.count) and same_map(torch, a.points, b.points)

    rows_mode = kernels.extract_rows_mode(vol.tsdf, vol.weight)
    cut = extract_block_cut(torch, cfg, vol)
    parts, calls = {}, {}
    for m in (maxp, cut, 700):
        ck, calls[m] = kernels_a_call("extract_cloud", lambda m=m: tsdf_ops.extract_cloud(cfg, vol, m, min_weight=1.0))
        cr, ref_calls = kernels_a_call("extract_cloud", lambda m=m: tsdf_ops.extract_cloud(
            cfg, vol, m, min_weight=1.0, reference=True))
        cp = tsdf_ops.extract_cloud(cfg, vol, m, min_weight=1.0, plain=True)
        lib = library_extract(torch, cfg, vol, m, 1.0)
        parts[m] = (same(ck, cp), same(ck, cr), same(ck, type(ck)(*lib)), ref_calls)
        if m == maxp:
            cloud = cp
    count = int(cloud.count)
    d = cfg.volume_dims
    ok = rows_mode and count > cut > 700 and all(all(v[:3]) and v[3] == 4 for v in parts.values()) and set(
        calls.values()) == {2}
    check(name, ok,
          f"{d}^3 ({str(vol.tsdf.dtype)[6:]} tsdf, {str(vol.weight.dtype)[6:]} weight; {d * d // kernels.EXTRACT_ROWS} "
          f"blocks of {kernels.EXTRACT_ROWS} rows, rows mode {rows_mode}): {count} crossings into {maxp}, {cut} (a cut "
          f"inside a block) and 700 rows; points, flags and count equal (plain, reference mode, library route) bit for "
          f"bit, reference device kernels: {parts}; device kernels a call {sorted(set(calls.values()))}")
    org = tuple(float(v) for v in cfg.volume_origin)
    report[name] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: kernels.extract_cloud(vol.tsdf, vol.weight, 1.0, maxp, cfg.voxel_size, org)),
        reference_ms=cuda_ms(torch, lambda: kernels.extract_cloud(vol.tsdf, vol.weight, 1.0, maxp, cfg.voxel_size,
                                                                   org, reference=True)),
        plain_ms=cuda_ms(torch, lambda: tsdf_ops.extract_cloud_plain(cfg, vol, maxp, 1.0), reps=3),
        # tsdf and weight read once, points and flags written, the count;
        # ~8 operations a crossing test, ~10 a crossing
        bound=bound_ms(d ** 3 * vox_bytes(vol) + maxp * 13 + 4, 3.0 * (d - 1) * d * d * 8.0 + count * 10.0),
        library_ms=cuda_ms(torch, lambda: library_extract(torch, cfg, vol, maxp, 1.0), reps=5),
    )
    r = report[name]
    print(f"[time] {smi()} | L {name}: {r['ms']:.4f} ms, reference mode {r['reference_ms']:.4f} ms, library "
          f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; bound {r['bound'][0]:.5f} ms ({r['bound'][1]})",
          flush=True)
    return cloud


def storage_kernels(torch, report, dev, nr_depths):
    """Phase 20: kernels C, D, F1, F2, L and R at the float storages, at
    full width on the preset's state after three frames of the deforming
    scene (re-encoded into each storage) and its next frame tracked, L and
    R on its frame-0 volume: C's every refine and normal mode and its slab
    mode (4 shards) and R at the two float tsdfs; D rigid, non-rigid and
    on 4 slabs, F1, F2 (the phase split, the incidence confidence) and L at
    the five storage pairs; each bit-equal to its plain version, timed; D
    also bit-equal to its reference mode (``hold_fuse``)."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.ops import bricks, fusion, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.parallel import sharded, sharded_fusion, sharded_raycast
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = DynamicFusionConfig.default_dynamicfusion()
    df = kinfu.DynamicFusion(cfg, device=dev)
    df(nr_depths[0])
    vol0 = clone_state(df.state).vol
    for d in nr_depths[1:3]:
        df(d)
    st = df.state
    del df
    tr = kinfu.track(cfg, st, torch.from_numpy(nr_depths[3]).to(dev))
    intr, d, n = cfg.intr, cfg.volume_dims, SHARDS
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    cam2vol = se3.compose(se3.inverse(kinfu._vol_pose(cfg, dev)), st.pose)
    seed, band = tr.bands
    rays = tsdf_ops.rays(cfg, cam2vol, intr.level(cfg.raycast_shift), rows_t, cols_t, seed, band)
    mesh = sharded.make_mesh(n, devices=[dev] * n)
    halo = sharded_raycast._halo_planes(cfg)
    slab_cfg = dataclasses.replace(cfg, raycast_adaptive_step=False)
    maxp = max(cfg.max_nodes * cfg.node_sample_step, 1 << 20)
    org = tuple(float(v) for v in cfg.volume_origin)
    on = torch.ones((), dtype=torch.bool, device=dev)

    for t in TSDF_STORAGES:
        # C: every refine and normal mode on the preset's rays, its band
        _, vt = stored(cfg, st.vol, t)
        for refine, smooth in STORAGE_RAYCASTS:
            name = f"raycast_{'grad6_' if smooth else ''}{refine}_{t}"
            hold_raycast(torch, report, name,
                         dataclasses.replace(cfg, raycast_refine=refine, raycast_smooth_normals=smooth), vt.tsdf,
                         rays, exact=True)
        # C's slab mode on the 4 shards' extended slabs
        exts = mesh.halo(mesh.split(vt.tsdf), halo)
        wins = [sharded_raycast.slab_window(slab_cfg, k, n, *rays) for k in range(n)]
        same, found, samples = True, 0, 0.0
        for k in range(n):
            x_off = k * (d // n) - halo
            got = tsdf_ops.march_slab(slab_cfg, exts[k], x_off, rays[0], rays[1], *wins[k])
            ref = tsdf_ops.march_slab(slab_cfg, exts[k], x_off, rays[0], rays[1], *wins[k], plain=True)
            f = ref[0]
            same = same and torch.equal(got[0], f) and torch.equal(got[4], ref[4]) and all(
                same_map(torch, a[f], b[f]) for a, b in zip(got[1:4], ref[1:4]))
            found += int(f.sum())
            samples += slab_samples(torch, slab_cfg, exts[k], x_off, rays[0], rays[1], *wins[k])
        check(f"raycast_slab_{t}", same and found > 0,
              f"{t} tsdf, {n} slabs of {d // n} + 2 x {halo} planes: found, t, vertex, normal and exit events equal "
              f"the plain version's bit for bit {same}; {found} slab hits")
        step_len = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor

        def march_all(plain, exts=exts, wins=wins):
            for k in range(n):
                if plain:
                    tsdf_ops.march_slab(slab_cfg, exts[k], k * (d // n) - halo, rays[0], rays[1], *wins[k],
                                        plain=True)
                else:
                    kernels.march_and_refine(exts[k], rays[0], rays[1], *wins[k], cfg.voxel_size, step_len,
                                             tsdf_ops.march_steps(cfg), False, refine=tsdf_ops._refine_mode(cfg),
                                             smooth=False, delta=cfg.gradient_delta_factor,
                                             x_off=k * (d // n) - halo, d=d)

        gathers, ops = refine_work(cfg)
        report[f"raycast_slab_{t}"] = dict(
            err=0.0, ms=cuda_ms(torch, lambda: march_all(False)),
            plain_ms=cuda_ms(torch, lambda: march_all(True), reps=3),
            bound=bound_ms((samples + gathers * found) * vt.tsdf.element_size() + n * rays[1].numel() // 3 * 53,
                           samples * 12.0 + found * ops),
            library_ms=None,
        )
        del exts
        # R on L's frame-0 cloud (1 << 20 rows, the NaN tail included)
        c0, v0 = stored(cfg, vol0, t)
        pts = tsdf_ops.extract_cloud(c0, v0, max_points=1 << 20, plain=True).points
        nk = tsdf_ops.extract_normals(c0, v0, pts)
        npl = tsdf_ops.extract_normals(c0, v0, pts, plain=True)
        valid = ~torch.isnan(nk[:, 0])
        nvalid = int(valid.sum())
        same = same_map(torch, nk, npl)
        check(f"extract_normals_{t}", same and nvalid > 0,
              f"{t} tsdf, {pts.shape[0]} rows, {nvalid} normals: equal the plain version's bit for bit {same}")
        nvox = normal_voxels(torch, cfg, pts, valid)
        report[f"extract_normals_{t}"] = dict(
            err=0.0,
            ms=cuda_ms(torch, lambda: kernels.extract_normals(v0.tsdf, pts, cfg.voxel_size, org,
                                                              cfg.gradient_delta_factor)),
            plain_ms=cuda_ms(torch, lambda: tsdf_ops.extract_normals(c0, v0, pts, plain=True), reps=5),
            bound=bound_ms(pts.shape[0] * 24 + nvox * v0.tsdf.element_size(), nvalid * 400.0),
            library_ms=None,
        )
        del v0, vt

    # D, F1, F2 and L at the five pairs
    g, b = cfg.knn_field_stride, cfg.brick_size
    w2c = se3.inverse(tr.pose)
    vol2cam = se3.compose(w2c, kinfu._vol_pose(cfg, dev))
    cf = fusion.coarse_field(cfg, st.warp)
    cam_grid = se3.transform_points(w2c, cf.warped)
    bp = bricks.plan(cfg, tr.dists, cam_grid, g, intr)
    lookup = bricks.pack_depth_conf(tr.dists, tr.conf)
    phase = torch.ones((), dtype=torch.int32, device=dev)
    band_cap, wide_cap = sharded_fusion.caps(cfg, n)
    dl = d // n
    n_work = int(bp.work.count[0])
    n_front = int((bp.work.kind[:n_work] == bricks.FRONT).sum())
    bv, nbr = b ** 3, (d // b) ** 3
    rows, cols = tr.dists.shape
    for t, w in STORAGES:
        tag = f"{t}_{w}"
        cp_, vp_ = stored(cfg, st.vol, t, w)
        vb = vox_bytes(vp_)

        def pair(v):
            return TsdfVolume(v.tsdf.clone(), v.weight.clone())

        # D non-rigid (the warped grid, the blend quality, the packed confidence), then rigid
        vk, vp = pair(vp_), pair(vp_)
        ck = fusion.integrate_nonrigid(cp_, vk, cf, tr.dists, w2c, intr, on, conf=tr.conf)
        cq = fusion.integrate_nonrigid(cp_, vp, cf, tr.dists, w2c, intr, on, conf=tr.conf, plain=True)
        err = max(apart(torch, vk.tsdf, vp.tsdf), apart(torch, vk.weight, vp.weight))
        changed = apart(torch, vk.tsdf, vp_.tsdf) > 0
        check(f"fuse_bricks_nonrigid_{tag}", torch.equal(ck, cq) and err == 0 and changed,
              f"{t}/{w}: counts {ck.tolist()} / {cq.tolist()}, tsdf and weight equal the plain version's bit for bit "
              f"(max distance {err} codes or ulps)")
        scratch = pair(vp_)
        report[f"fuse_bricks_nonrigid_{tag}"] = dict(
            err=float(err),
            ms=cuda_ms(torch, lambda: bricks.fuse(cp_, scratch, lookup, cam_grid, g, intr, bp, on, q_grid=cf.q,
                                                   packed=True)),
            plain_ms=cuda_ms(torch, lambda: bricks.fuse(cp_, scratch, lookup, cam_grid, g, intr, bp, on, q_grid=cf.q,
                                                         packed=True, plain=True), reps=3),
            bound=bound_ms(n_work * bv * 2 * vb + lookup.numel() * 4 + cam_grid.numel() * 4 + cf.q.numel() * 4
                           + nbr * 16, n_front * bv * 8.0 + (n_work - n_front) * bv * 100.0),
            library_ms=None,
        )
        ref, ref_gated, gated = hold_fuse(torch, f"fuse_bricks_nonrigid_reference_{tag}", cp_, vp_, lookup, cam_grid,
                                          g, bp, cf.q, True, what="non-rigid, ")
        report[f"fuse_bricks_nonrigid_{tag}"].update(reference_ms=ref, gated_ms=gated, reference_gated_ms=ref_gated)
        vk, vp = pair(vp_), pair(vp_)
        rigid = dataclasses.replace(cp_, integrate_mode="brick")
        tsdf_ops.integrate(rigid, vk, tr.dists, vol2cam, intr, ok=on)
        tsdf_ops.integrate(rigid, vp, tr.dists, vol2cam, intr, ok=on, plain=True)
        err = max(apart(torch, vk.tsdf, vp.tsdf), apart(torch, vk.weight, vp.weight))
        check(f"fuse_bricks_rigid_{tag}", err == 0, f"{t}/{w}: the rigid brick fusion equal the plain version's "
              f"bit for bit (max distance {err})")
        rgrid = tsdf_ops.brick_grid(rigid, vol2cam)
        hold_fuse(torch, f"fuse_bricks_rigid_reference_{tag}", rigid, vp_, tr.dists, rgrid, b,
                  bricks.plan(rigid, tr.dists, rgrid, b, intr), what="rigid, ")
        # D's slab mode on the 4 shards
        err, listed, plans = 0, 0, []
        for k in range(n):
            gk, qk = bricks.corner_slab(cam_grid, k, n, b, g), bricks.corner_slab(cf.q, k, n, b, g)
            pk = bricks.plan_slab(cp_, tr.dists, gk, g, intr, k * dl // b, band_cap, wide_cap)
            slab = TsdfVolume(vp_.tsdf[k * dl:(k + 1) * dl], vp_.weight[k * dl:(k + 1) * dl])
            sk, sp = pair(slab), pair(slab)
            bricks.fuse(cp_, sk, lookup, gk, g, intr, pk, on, qk, True)
            bricks.fuse(cp_, sp, lookup, gk, g, intr, pk, on, qk, True, plain=True)
            err = max(err, apart(torch, sk.tsdf, sp.tsdf), apart(torch, sk.weight, sp.weight))
            listed += int(pk.work.count[0])
            plans.append((gk, qk, pk, slab))
            hold_fuse(torch, f"fuse_bricks_slab_reference_{tag}_{k}", cp_, slab, lookup, gk, g, pk, qk, True,
                      what=f"slab {k} of {n}, ")
        check(f"fuse_bricks_slab_{tag}", err == 0 and listed > 0,
              f"{t}/{w}, {n} slabs, {listed} listed bricks: equal the plain version's bit for bit (max distance {err})")
        if tag == "f32_f32":
            scratch = [pair(s) for _, _, _, s in plans]

            def fuse_all(plain):
                for v, (gk, qk, pk, _) in zip(scratch, plans):
                    bricks.fuse(cp_, v, lookup, gk, g, intr, pk, on, qk, True, plain=plain)

            n_front_s = sum(int((pk.work.kind[:int(pk.work.count[0])] == bricks.FRONT).sum()) for _, _, pk, _ in plans)
            report["fuse_bricks_slab_f32_f32"] = dict(
                err=0.0, ms=cuda_ms(torch, lambda: fuse_all(False)),
                plain_ms=cuda_ms(torch, lambda: fuse_all(True), reps=3),
                bound=bound_ms(listed * bv * 2 * vb + n * (lookup.numel() * 4 + plans[0][0].numel() * 4
                                                           + plans[0][1].numel() * 4 + band_cap * 16),
                               n_front_s * bv * 8.0 + (listed - n_front_s) * bv * 100.0),
                library_ms=None,
            )
        del plans
        # F1 at the tracked pose, F2 with the confidence and the phase split
        dense = dataclasses.replace(cp_, integrate_mode="dense")
        split2 = dataclasses.replace(dense, fusion_phase_split=2)

        def f1(v, plain):
            if plain:
                return tsdf_ops.integrate_dense_plain(dense, v, tr.dists, vol2cam, intr, on)
            tsdf_ops.integrate(dense, v, tr.dists, vol2cam, intr, ok=on)

        def f2(v, plain):
            if plain:
                return fusion.integrate_dense_nonrigid_plain(split2, v, cf, lookup, w2c, intr, on, True, phase)
            fusion.integrate_nonrigid(split2, v, cf, tr.dists, w2c, intr, on, conf=tr.conf, phase=phase)

        for name, fuse, prolong in (("integrate_dense", f1, False), ("integrate_dense_nonrigid", f2, True)):
            vk, vp = pair(vp_), pair(vp_)
            before = kernels.launches[name]
            fuse(vk, False)
            upd = fuse(vp, True)
            err = max(apart(torch, vk.tsdf, vp.tsdf), apart(torch, vk.weight, vp.weight))
            n_upd = int(upd.sum())
            check(f"{name}_{tag}", err == 0 and n_upd > 0 and kernels.launches[name] == before + 1,
                  f"{t}/{w}: equal the plain version's bit for bit (max distance {err}); {n_upd} voxels updated")
            scratch = pair(vp_)
            nbytes = n_upd * 2 * vb + rows * cols * 4 + 48 + (cf.warped.numel() * 4 + cf.q.numel() * 4 if prolong else 0)
            vox = d ** 3 // 2 if prolong else d ** 3
            report[f"{name}_{tag}"] = dict(
                err=0.0, ms=cuda_ms(torch, lambda: fuse(scratch, False)),
                plain_ms=cuda_ms(torch, lambda: fuse(scratch, True), reps=3),
                bound=bound_ms(nbytes, vox * (30.0 + (28.0 if prolong else 0.0)) + n_upd * 20.0),
                library_ms=None,
            )
            if name == "integrate_dense":
                hold_dense_reference(torch, f"integrate_dense_reference_{tag}", dense, vp_, tr.dists, vol2cam,
                                     what=f"{t}/{w}: ")
                report[f"{name}_{tag}"]["reference_ms"] = cuda_ms(
                    torch, lambda: tsdf_ops.integrate_dense(dense, scratch, tr.dists, vol2cam, intr, on,
                                                            reference=True))
        del scratch, vk, vp
        # L on the frame-0 volume
        c0, v0 = stored(cfg, vol0, t, w)
        hold_extract(torch, report, f"extract_cloud_{tag}", c0, v0, maxp)
        del v0, vp_


def rigid_steps_vs_plain(torch, tag, cfg, dev, frames, states, poses_k, rows):
    """A rigid path's plain step from each of its states: the pose within
    TOL_STEP_POSE, ICP health equal."""
    from dynamicfusion_tpu_torch.pipeline import kinfu

    errs, same = [], True
    for f in range(1, len(frames)):
        _, o = kinfu.step(cfg, states[f - 1], torch.from_numpy(frames[f]).to(dev), plain=True)
        errs.append(float(np.abs(poses_k[f] - o.pose.cpu().numpy()).max()))
        same = same and bool(o.icp_ok) == rows[f - 1]["ok"] and rows[f - 1]["ok"]
    check(f"{tag}_step_vs_plain", same and max(errs) <= TOL_STEP_POSE,
          f"ICP healthy and equal {same}; plain step pose diff {' '.join(f'{v:.2e}' for v in errs)} "
          f"(tol {TOL_STEP_POSE})")


def storage_paths_main(torch, args, dev, card, nr_depths):
    """Phase 21: the preset at each float storage pair, through
    ``DynamicFusion``: f32/f32 for F frames (``--f-frames``) with the
    preset's checks, the other pairs for 7 (frame 6 fuses), the plain step
    from each state; at its final state the demo's export (L's cloud, R's
    normals); then 3 steps each of the dense non-rigid cell (F1 in frame
    0, F2, C's newton16) at every pair and of the reference-shaped rigid
    cell (F1 every frame, C's six-sample normal) under f32/f32, each step
    against the plain step. Returns the runs' launches."""
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.models import volume as volume_model
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops

    runs = {}
    for t, w in STORAGES:
        tag = f"{t}_{w}"
        cfg = dataclasses.replace(DynamicFusionConfig.default_dynamicfusion(), tsdf_dtype=t, weight_dtype=w)
        frames = nr_depths[: args.f_frames if tag == "f32_f32" else STORAGE_FRAMES]
        df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
        poses_k = [p.cpu().numpy() for p in df.poses]
        kept = (df.state.vol.tsdf.dtype == volume_model._TSDF_DTYPES[t]
                and df.state.vol.weight.dtype == volume_model._WEIGHT_DTYPES[w])
        check(f"preset_{tag}_storage", kept, f"the volume stays {df.state.vol.tsdf.dtype} / {df.state.vol.weight.dtype}")
        check_nonrigid_run(f"preset_{tag}", card, cfg, frames, launches, rows, frame_ms, poses_k)
        check_steps_vs_plain(torch, f"preset_{tag}", cfg, dev, frames, states, poses_k, rows)
        runs[f"preset_{tag}"] = launches
        # the export of the demo from the final state: L's cloud, R's normals
        kernels.reset_launches()
        cloud = tsdf_ops.extract_cloud(cfg, df.state.vol, max_points=1 << 20)
        normals = tsdf_ops.extract_normals(cfg, df.state.vol, cloud.points)
        torch.cuda.synchronize()
        runs[f"export_{tag}"] = dict(kernels.launches)
        nn_ = int((~torch.isnan(normals[:, 0])).sum())
        check(f"export_{tag}", runs[f"export_{tag}"]["extract_normals"] == 1 and nn_ > 0,
              f"the final cloud's {int(cloud.count)} crossings, {nn_} normals (kernel R once)")
        del df, states
    for t, w in STORAGES:
        tag = f"{t}_{w}"
        cfg = dataclasses.replace(DynamicFusionConfig.default_dynamicfusion(), integrate_mode="dense",
                                  raycast_refine="newton16", tsdf_dtype=t, weight_dtype=w)
        frames = nr_depths[:4]
        df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
        poses_k = [p.cpu().numpy() for p in df.poses]
        check(f"dense_{tag}_launches", launches["integrate_dense"] == 1 and launches["integrate_dense_nonrigid"] == 3
              and launches["raycast"] > 0 and launches["fuse_bricks"] == 0 and all(r["ok"] for r in rows),
              f"{t}/{w}: F1 once in frame 0, F2 once a step ({launches['integrate_dense_nonrigid']} in 3), C "
              f"{launches['raycast']}, D never; ICP healthy; frame ms {' '.join(f'{v:.3f}' for v in frame_ms)}")
        check_steps_vs_plain(torch, f"dense_{tag}", cfg, dev, frames, states, poses_k, rows)
        runs[f"dense_{tag}"] = launches
        del df, states
    cfg = dataclasses.replace(DynamicFusionConfig.reference_parity(), rigid_only=True, integrate_mode="dense",
                              raycast_smooth_normals=True, tsdf_dtype="f32", weight_dtype="f32")
    frame = rigid_frame_fn(cfg)
    frames = [frame(i) for i in range(4)]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    check("ref_rigid_f32_f32_launches", launches["integrate_dense"] == 4 and launches["raycast"] > 0,
          f"F1 every frame ({launches['integrate_dense']}), C {launches['raycast']}; frame ms "
          f"{' '.join(f'{v:.3f}' for v in frame_ms)}")
    rigid_steps_vs_plain(torch, "ref_rigid_f32_f32", cfg, dev, frames, states, [p.cpu().numpy() for p in df.poses],
                         rows)
    runs["ref_rigid_f32_f32"] = launches
    return runs


def sharded_storage_main(torch, args, dev, card, nr_depths):
    """Phase 22: the preset under f32/f32 over ``make_mesh(4)`` on the card
    for 7 frames (frame 6 fuses: C's, K's and D's slab modes at the float
    storage), the last 3 steps held as phase 17 holds its steps. Returns
    the run's launches."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.parallel import sharded

    cfg = dataclasses.replace(DynamicFusionConfig.default_dynamicfusion(), tsdf_dtype="f32", weight_dtype="f32")
    mesh = sharded.make_mesh(SHARDS, devices=[dev] * SHARDS)
    frames = nr_depths[:STORAGE_FRAMES]
    launches, rows, frame_ms, runner = drive_sharded(torch, "sharded_f32_f32", cfg, mesh, dev, frames,
                                                     hold_from=STORAGE_FRAMES - 3)
    kept = all(t.dtype == torch.float32 for t in runner.state.vol.tsdf + runner.state.vol.weight)
    due = [i for i in range(1, len(frames)) if i % cfg.fusion_interval == 0]
    fused = [i for i, r in enumerate(rows, start=1) if r["bricks"][0] + r["bricks"][1] > 0]
    check("sharded_f32_f32", kept and all(r["ok"] for r in rows) and fused == due and all(
        launches[k] > 0 for k in ("raycast", "brick_plan", "fuse_bricks", "pcg_sharded")),
          f"f32 slabs kept {kept}, ICP healthy on every step, fusion on {fused} (due {due}), the slab and shard "
          f"kernels launched: {launches}; frame ms {' '.join(f'{v:.3f}' for v in frame_ms)}")
    check_sharded_one_launch("sharded_f32_f32", cfg, launches, len(frames) - 1)
    return launches


def kinfu_main(torch, args, dev, card, report):
    """Phase 23: ``default_kinfu()`` (512^3 over 3 m, non-rigid, the direct
    solve) over K frames (``--k-frames``) of the deforming scene rendered
    with its intrinsics: the base cell's checks (phase 9), the plain step
    from each state, a profile of 3 more frames; K at its 32^3 brick grid
    and L at 512^3 against their plain versions, timed, K also against its
    one-block mode and D at 512^3 against its reference mode. Returns the
    run's launches."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.ops import bricks, fusion
    from dynamicfusion_tpu_torch.pipeline import kinfu

    cfg = DynamicFusionConfig.default_kinfu()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, args.k_frames + 3)
    frames = depths[: args.k_frames]
    df, launches, rows, frame_ms, states = drive_kernel_path(torch, cfg, dev, frames)
    poses_k = [p.cpu().numpy() for p in df.poses]
    check_nonrigid_run("kinfu", card, cfg, frames, launches, rows, frame_ms, poses_k)
    steps = len(frames) - 1
    check("kinfu_dense_launches", launches["cholesky"] == steps * cfg.solver_nonlinear_iters
          and launches["dense_gram"] == steps and launches["dense_damp"] == launches["cholesky"],
          f"one Gram a step ({launches['dense_gram']}), a damping and a factor every LM iteration "
          f"({launches['dense_damp']}, {launches['cholesky']}) in {steps} steps")
    check_steps_vs_plain(torch, "kinfu", cfg, dev, frames, states, poses_k, rows)
    rows_t, cols_t = cfg.rows // cfg.raycast_subsample, cfg.cols // cfg.raycast_subsample
    mp = df.last_outputs.model_points
    check("kinfu_model_maps", tuple(mp.shape) == (rows_t, cols_t, 3) and bool(torch.isfinite(mp).any()),
          f"warped model map {tuple(mp.shape)} with {int(torch.isfinite(mp[..., 0]).sum())} valid pixels")
    prof = profile_frames(torch, args, dev, card, df, depths[args.k_frames: args.k_frames + 3], tag="kinfu",
                          focus=("classify_plan", "count_kernel", "write_kernel", "fuse_bricks", "raycast", "potrf"))
    del df
    # K at the 32^3 brick grid: the plan of the next frame from the state after frame 3
    st = states[3]
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[4]).to(dev))
    g = cfg.knn_field_stride
    cf = fusion.coarse_field(cfg, st.warp)
    cam_grid = se3.transform_points(se3.inverse(tr.pose), cf.warped).contiguous()
    pk = bricks.plan(cfg, tr.dists, cam_grid, g, cfg.intr)
    pp = bricks.plan(cfg, tr.dists, cam_grid, g, cfg.intr, plain=True)
    exact = same_plan(torch, pk, pp)
    nbr = pk.classes.cls.shape[0]
    hist = torch.bincount(pk.classes.cls, minlength=4).tolist()
    rows_i, cols_i = tr.dists.shape
    levels = int(math.ceil(math.log2(max(rows_i, cols_i)))) + 1
    check("brick_plan_512", exact and nbr == 32 ** 3,
          f"{nbr} bricks (skip, front, band, wide) {hist}, work list of {int(pk.work.count[0])}, counts "
          f"{pk.work.counts.tolist()}: classes and list equal the plain version's bit for bit {exact}")
    total = sum((((rows_i + (1 << l) - 1) >> l) * ((cols_i + (1 << l) - 1) >> l)) for l in range(levels))
    gp = cam_grid.shape[0]
    report["brick_plan_512"] = dict(
        err=0.0,
        ms=cuda_ms(torch, lambda: bricks.plan(cfg, tr.dists, cam_grid, g, cfg.intr)),
        plain_ms=cuda_ms(torch, lambda: bricks.plan(cfg, tr.dists, cam_grid, g, cfg.intr, plain=True), reps=3),
        # dists, the grid and the permutation in; the mip, classes, windows,
        # flags and the list out (brick_plan's reckoning at 32 768 bricks)
        bound=bound_ms(rows_i * cols_i * 4 + gp ** 3 * 12 + nbr * 8 + total * 12 + nbr * (8 + 4 + 4 + 1 + 8) + 16,
                       total * 3.0 + nbr * (27 * 25.0 + 16 * 50.0)),
        library_ms=None,
    )
    _, one, gated = hold_plan(torch, "brick_plan_512_cluster", cfg, tr.dists, cam_grid, g, what="512^3: ")
    report["brick_plan_512"].update(reference_ms=one, gated_ms=gated)
    # D at 512^3 against its reference mode, once
    q = cf.q if cfg.fusion_quality_weight else None
    lookup = tr.dists if not cfg.fusion_incidence_weight else bricks.pack_depth_conf(tr.dists, tr.conf)
    ref, ref_gated, gated_d = hold_fuse(torch, "fuse_bricks_512_reference", cfg, st.vol, lookup, cam_grid, g, pk, q,
                                        cfg.fusion_incidence_weight, what="512^3, ")
    print(f"[time] 512^3: K {report['brick_plan_512']['ms']:.4f} ms (one-block mode {one:.4f}, gated {gated:.4f}); "
          f"D's reference mode {ref:.4f} ms (gated {ref_gated:.4f}, the persistent grid gated {gated_d:.4f})",
          flush=True)
    # L on the frame-0 volume
    maxp = max(cfg.max_nodes * cfg.node_sample_step, 1 << 20)
    hold_extract(torch, report, "extract_cloud_512", cfg, states[0].vol, maxp)
    del states
    steady = sorted(frame_ms[2:])
    print(f"[kinfu] {card} | default_kinfu() {cfg.cols}x{cfg.rows} / {cfg.volume_dims}^3 over {cfg.volume_size} m / "
          f"{cfg.max_nodes} nodes: frame ms median {steady[len(steady) // 2]:.3f} (frames 2..{steps}); "
          f"{prof['launches'] / 3:.0f} kernel launches a frame, device idle "
          f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.3f} of 3 profiled frames; K at {nbr} bricks "
          f"{report['brick_plan_512']['ms']:.4f} ms ({launches['brick_plan']} launches), L at 512^3 "
          f"{report['extract_cloud_512']['ms']:.4f} ms ({launches['extract_cloud']} launch)", flush=True)
    return launches


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
    ap.add_argument("--dn-frames", type=int, default=20,
                    help="deforming-scene frames of the dense non-rigid cell (newton16)")
    ap.add_argument("--demo-frames", type=int, default=10,
                    help="synthetic frames of apps/demo_torch.py under default_dynamicfusion()")
    ap.add_argument("--s-frames", type=int, default=20,
                    help="deforming-scene frames of default_dynamicfusion() over make_mesh(4) on the card")
    ap.add_argument("--f-frames", type=int, default=20,
                    help="deforming-scene frames of default_dynamicfusion() under the f32 tsdf and weight")
    ap.add_argument("--k-frames", type=int, default=20, help="deforming-scene frames of default_kinfu() (512^3)")
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
    n_depths = max(args.nr_frames, args.d_frames, args.r_frames, args.dn_frames, args.s_frames + 1, args.f_frames,
                   STORAGE_FRAMES) + 3
    nr_depths = synthetic.deforming_frames(nr.intr, nr.rows, nr.cols, n_depths)
    report = {}
    rigid_kernels(torch, args, report, dev, card)
    nonrigid_kernels(torch, args, report, dev, nr_depths)
    extract_kernels(torch, report, dev, nr_depths)
    dense_kernels(torch, report, dev, nr_depths)
    gram_2048(torch, dev)
    pcg_2048(torch, dev)
    data_2048(torch, dev)
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

    # ---------------- 13. reference-shaped rigid: dense fusion, six-sample normals ----------------
    rr_launches, _ = parity_main(torch, args, dev, card, dense=True)
    print(f"[phase] reference-shaped rigid path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 14. dense non-rigid with newton16, the raycast variants ----------------
    dn_launches, dv_launches = dense_nonrigid_main(torch, args, dev, card, nr_depths)
    print(f"[phase] dense non-rigid path done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 15. the depth-variant ICP ----------------
    t1_launches = depth_icp_main(torch, report, dev, card, DynamicFusionConfig.rigid_slice())
    print(f"[phase] depth-variant ICP done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 16. the demo: export, checkpoint, the live mesh ----------------
    demo_launches = demo_main(torch, args, report, dev, card, tuple(k for k in kernels.KERNELS if nr_launches[k]))
    print(f"[phase] demo done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 17. the sharded preset over make_mesh(4) on the card ----------------
    s_launches = sharded_main(torch, args, dev, card, nr_depths, report)
    print(f"[phase] sharded preset done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 18. the base config sharded ----------------
    sb_launches = sharded_base_main(torch, args, dev, card, nr_depths, report)
    print(f"[phase] sharded base config done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 19. two processes on the card ----------------
    multiprocess_main(torch, args, dev, card)
    print(f"[phase] two-process run done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 20. the kernels at the float storages ----------------
    storage_kernels(torch, report, dev, nr_depths)
    print(f"[phase] float-storage kernels checked at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 21. the preset and the dense cells at the float storages ----------------
    storage_runs = storage_paths_main(torch, args, dev, card, nr_depths)
    print(f"[phase] float-storage paths done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 22. the sharded preset under f32/f32 ----------------
    sf_launches = sharded_storage_main(torch, args, dev, card, nr_depths)
    print(f"[phase] sharded f32 preset done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 23. default_kinfu(): the 512^3 volume ----------------
    k_launches = kinfu_main(torch, args, dev, card, report)
    print(f"[phase] default_kinfu() done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---------------- 24. report ----------------
    runs = {**storage_runs, "sharded_f32_f32": sf_launches, "kinfu": k_launches,"rigid": rigid_launches, "nonrigid": nr_launches, "frame0": nr_launches, "quality": q_launches,
            "sharded": s_launches, "sharded_base": sb_launches,
            "adaptive": a_launches, "parity_rigid": p_launches, "render": r_launches, "base": base_launches,
            "base_bf16": v_launches["bf16"], "base_p2p": v_launches["p2p"], "parity_nr": pnr_launches,
            "options": o_launches, "options_lag": lag_launches, "base_pcg": v_launches["pcg_unlagged"],
            "ref_rigid": rr_launches, "dense_nr": dn_launches, "depth_icp": t1_launches, "demo": demo_launches,
            **{f"dense_nr_{k}": v for k, v in dv_launches.items()}}
    rows_out = []
    for name, (src, rep) in ROWS.items():
        r = report[name]
        path = PATH.get(name, "nonrigid")
        n_launch = runs[path][COUNTER.get(name, name)]
        rows_out.append(dict(
            name=name, route="cuda", source=src if "/" in src else f"dynamicfusion_tpu_torch/csrc/{src}", replaces=rep,
            launches=n_launch, max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"], path=path,
            **{k: r[k] for k in ("iterations", "iteration_ms", "cluster", "serial_ms", "reference_ms", "gated_ms",
                                 "reference_gated_ms", "kept_ms", "reread_bound_ms") if k in r},
        ))
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[kernel] {card} | {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}), library {lib}, launches {n_launch} ({path} path)"
              + (f", {r['iterations']} iterations" if "iterations" in r else "")
              + (f" ({r['iteration_ms']:.4f} ms each, a cluster of {r['cluster']})" if "cluster" in r else ""))
    print(f"[phase] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"{card}")
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
