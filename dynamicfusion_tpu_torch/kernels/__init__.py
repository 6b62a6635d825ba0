"""The port's hand-written CUDA kernels: build, load and launch.

The sources live in ``dynamicfusion_tpu_torch/csrc/`` and expose a plain C
interface. At first use ``load()`` compiles each source with ``nvcc`` for
``sm_90a`` (all sources at once, in parallel), links them into one shared
library under ``build/kernels/`` named by a hash of the sources and flags,
and binds it with ``ctypes``. Nothing is built or imported at module
import: the CPU tests import this module on machines without ``nvcc``.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else; it launches on ``torch.cuda.current_stream()``, allocates
outputs with ``torch.empty``, raises if the launch reports an error, and
adds one to its entry of ``launches``. There is no fallback: CPU tensors
never reach a wrapper (the ops modules send them to the plain versions).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dynamicfusion_tpu_torch.models import volume as volume_model

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = (
    "bilateral.cu", "icp_reduce.cu", "raycast.cu", "fuse_bricks.cu",
    "knn_blend.cu", "data_term.cu", "pcg.cu", "insert_nodes.cu",
    "preprocess.cu", "bands.cu", "classify.cu", "extract.cu", "p2p_gate.cu", "dense_system.cu",
    "net_rigid.cu", "dense_pcg.cu", "fuse_dense.cu", "normals.cu",
)
HEADERS = ("common.cuh", "dq.cuh", "reduce.cuh", "volume.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels repeat the plain versions' arithmetic
    # operation for operation, so that each rounds the same way
    "-fmad=false",
    "-Xcompiler", "-fPIC",
)

# one launch counter per wrapper; a wrapper's kernel is the letter in its
# docstring (A-D the rigid slice, E-H the non-rigid one, I-K the per-frame
# stencils and the brick plan, L frame 0's extraction and node sampling, M
# the aperture gate, N and O the dense normal equations and their damping
# of the direct solve, P the dense-matrix PCG, Q the net rigid removal,
# F1 and F2 the dense rigid and non-rigid fusion, R the extracted point
# list's normals; the sharded step's distributed PCG: G's cluster launch
# of the whole solve with P's init and update (``pcg_sharded``), and the
# design before it, kept as its reference: G's data-only matvec of a shard
# and its per-iteration step, with P's init and update);
# ``cholesky`` counts the direct solve's factor, a cuSOLVER call, as the
# JAX package's is its library's; ``spd6_inv`` counts both of G's inverse
# entries (``spd6_inv``, ``spd6_inv_damped``), ``points_normals`` I's
# single-map entry (on no frame path) and ``frame_maps`` its multi-map one,
# ``pyramid_down`` I's one-level pyramid entry (on no frame path) and
# ``depth_pyramid`` its every-level one
KERNELS = (
    "bilateral", "icp_reduce", "raycast", "fuse_bricks",
    "knn_blend", "mutual_nearest", "warp_trilinear", "data_term",
    "edge_term", "spd6_inv", "matvec", "pcg", "insert_select", "insert_apply",
    "depth_dists", "pyramid_down", "depth_pyramid", "points_normals", "frame_maps", "resize_maps", "march_bands",
    "coarse_band", "brick_plan",
    "extract_cloud", "sample_nodes", "p2p_gate", "gram_scales", "dense_gram", "dense_damp", "cholesky",
    "node_radius", "dense_pcg", "net_rigid", "integrate_dense", "integrate_dense_nonrigid", "extract_normals",
    "data_matvec", "pcg_init", "pcg_step", "pcg_sharded",
)
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# kernel E's launches split by what the call asks for ("k8", "k5",
# "k8 blend warp", "k8 warp normals", ...): the same launches as
# ``launches["knn_blend"]``, for the per-shape rows of a report
knn_kinds: Dict[str, int] = {}
# the device kernels that the C entries of the wrappers with a reference
# mode report launching: G's edge term and E's mutual-nearest pass one a
# call, three in the mode kept as the reference; K's plan two in either
# mode (the mip tiles, then the cluster or the one block); D's fuse one;
# L's extraction two (the count with its scan, the write), four in its
# reference mode; G's spd6_inv (either entry) and I's frame maps one; G's
# distributed PCG one a launch (one a solve in one process, two an
# iteration under a process group); H's apply one, seven in its reference
# mode (six copies and the one-block kernel); I's pyramid one a call; M's
# gate two (the features and the clusters; the reference mode's rows and
# pixels)
device_kernels: Dict[str, int] = {"edge_term": 0, "mutual_nearest": 0, "brick_plan": 0, "fuse_bricks": 0,
                                  "extract_cloud": 0, "spd6_inv": 0, "frame_maps": 0, "pcg_sharded": 0,
                                  "insert_apply": 0, "depth_pyramid": 0, "p2p_gate": 0}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "df_bilateral": (_P, _P, _I, _I, _I, _D, _F, _P, _I, _P),
    "df_icp_reduce": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P),
    "df_raycast": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _F, _F, _I, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P),
    "df_fuse_bricks": (
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _F, _F, _F, _P, _F, _I, _F, _I, _I, _I, _P, _P,
    ),
    "df_knn_blend": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    "df_mutual_nearest": (_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P),
    "df_warp_trilinear": (_P, _I, _P, _P, _I, _F, _F, _F, _F, _P, _P, _P),
    "df_data_term_lanes": (_P,),
    "df_data_term": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _F, _F, _I, _F, _P, _P, _P, _P, _P, _P, _P,
        _P,
    ),
    "df_edge_term": (
        _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
    ),
    "df_spd6_inv": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P),
    "df_pcg_plan": (_I, _I, _I, _I, _I, _I, _P),
    "df_matvec": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "df_pcg": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _F, _P, _P, _P, _P,
    ),
    "df_insert_plan": (_I, _I, _I, _P),
    "df_insert_select": (_P, _P, _P, _I, _P, _P, _P, _I, _F, _F, _P, _P, _P, _P, _P, _P),
    "df_insert_apply": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "df_depth_dists": (_P, _I, _I, _F, _F, _F, _F, _P, _F, _P, _P, _P),
    "df_pyramid_down": (_P, _I, _I, _F, _P, _P),
    "df_depth_pyramid": (_P, _I, _I, _I, _F, _P, _I, _P, _P, _P, _P),
    "df_points_normals": (_P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P),
    "df_frame_maps": (_P, _I, _P, _P),
    "df_resize_maps": (_P, _P, _I, _I, _P, _P, _P),
    "df_march_bands": (_P, _I, _I, _I, _I, _P, _F, _P, _P, _P, _I, _P),
    "df_coarse_band": (_P, _I, _I, _I, _F, _P, _P, _P),
    "df_brick_plan": (
        _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F,
        _I, _F, _F, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
    ),
    "df_extract_cloud": (_P, _P, _I, _I, _F, _F, _I, _I, _F, _F, _F, _F, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P),
    "df_sample_nodes": (_P, _P, _I, _P, _I, _I, _P, _P, _P, _P),
    "df_p2p_gate_plan": (_P, _P, _P),
    "df_p2p_gate": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P, _P, _I, _P, _P),
    "df_gram_scales": (_P, _I, _P, _P, _I, _P, _P),
    "df_gram_launch": (_I, _P),
    "df_dense_gram": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "df_data_matvec": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "df_edge_apply": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    "df_pcg_init": (_P, _P, _I, _I, _F, _P, _P, _P, _P),
    "df_pcg_update": (_P, _I, _P, _P, _P),
    "df_sharded_pcg_plan": (_I, _I, _I, _I, _I, _I, _P, _P),
    "df_sharded_pcg": (
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _F, _P, _I, _P, _P, _P, _P, _P,
    ),
    "df_dense_damp": (_P, _P, _P, _I, _F, _P, _P, _P),
    "df_node_radius": (_P, _P, _I, _P, _I, _I, _F, _F, _F, _P, _P),
    "df_dense_pcg": (_P, _P, _P, _I, _I, _F, _P, _P, _P, _P),
    "df_net_rigid": (_P, _P, _P, _P, _P, _I, _F, _F, _P, _P, _P),
    "df_fuse_dense_sides": (_P, _I, _P),
    "df_fuse_dense": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P),
    "df_fuse_dense_nonrigid": (
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _I, _F, _I, _P,
    ),
    "df_extract_normals": (_P, _I, _I, _F, _P, _I, _F, _F, _F, _F, _F, _P, _P),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    knn_kinds.clear()
    for k in device_kernels:
        device_kernels[k] = 0


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(str(Path(cuda_home) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link one shared library;
    reuses a library already built from identical sources and flags."""
    so = BUILD_DIR / f"libdf_kernels_{_digest()}.so"
    if so.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("library", str(so))
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / (Path(name).stem + f"_{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    logs = []
    for name, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    build_info.update(seconds=time.perf_counter() - t0, library=str(so), ptxas="\n".join(logs))
    return so


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# --------------------------------------------------------------------------
# argument checks
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Optional[Tuple] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _same_device(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on(dev: torch.device):
    """``dev`` as the current CUDA device around a library call whose state
    belongs to the current device (kernel G's cluster attributes and
    occupancy)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _done(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    launches[name] += 1


def _f32(x: float) -> float:
    """x as the float32 that a PyTorch op on float32 tensors would use."""
    return float(np.float32(x))


# the volume's storages (csrc/common.cuh): a kernel that reads or writes the
# volume takes one storage code, tsdf code | weight code << 2
_TSDF_CODES = {torch.int16: 0, torch.float32: 1, torch.bfloat16: 2}
_WEIGHT_CODES = {torch.uint16: 0, torch.float32: 1}


def storage_code(tsdf_dtype: torch.dtype, weight_dtype: Optional[torch.dtype] = None) -> int:
    """The kernels' code of a volume storage: the tsdf as i16 codes,
    float32 or bfloat16, the weight as u16 codes or float32 (the six pairs
    of the JAX config; the weight's code 0 where it is not given)."""
    if tsdf_dtype not in _TSDF_CODES:
        raise TypeError(f"tsdf: expected int16, float32 or bfloat16, got {tsdf_dtype}")
    if weight_dtype is not None and weight_dtype not in _WEIGHT_CODES:
        raise TypeError(f"weight: expected uint16 or float32, got {weight_dtype}")
    return _TSDF_CODES[tsdf_dtype] | (0 if weight_dtype is None else _WEIGHT_CODES[weight_dtype]) << 2


def _check_volume(tsdf: torch.Tensor, weight: Optional[torch.Tensor] = None) -> int:
    """The storage code of a volume (or slab) on a card, contiguous, its
    weight (if given) of the tsdf's shape on the same card."""
    code = storage_code(tsdf.dtype, None if weight is None else weight.dtype)
    _check(tsdf, "tsdf", tsdf.dtype)
    if weight is not None:
        _check(weight, "weight", weight.dtype, tsdf.shape)
        _same_device(tsdf, weight)
    return code


def _decode_scale(tsdf: torch.Tensor) -> float:
    """The tsdf's decode factor as float32: 1/32767 for the i16 codes, 1 for
    the float storages."""
    return _f32(volume_model.tsdf_decode_scale(tsdf.dtype))


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


# the half windows csrc/bilateral.cu's tiled kernel is compiled for
BILATERAL_HALVES = (1, 2, 3, 4, 5)


def bilateral_space_table(kernel_size: int, sigma_spatial: float) -> np.ndarray:
    """Kernel A's spatial terms, (2 half + 1)^2 float32 row-major in (dy,
    dx): float32(float64(dy^2 + dx^2) * inv_sp), the rounding of the plain
    version's Python float (JAX's weak-typed constant) and of the
    reference mode's double product."""
    half = kernel_size // 2
    inv_sp = 0.5 / (sigma_spatial * sigma_spatial)
    r = np.arange(-half, half + 1, dtype=np.float64)
    return ((r[:, None] ** 2 + r[None, :] ** 2) * inv_sp).astype(np.float32).reshape(-1)


def bilateral_filter(
    depth_mm: torch.Tensor, kernel_size: int, sigma_spatial: float, sigma_depth_m: float, reference: bool = False
) -> torch.Tensor:
    """Kernel A (csrc/bilateral.cu): (H, W) uint16 mm -> (H, W) uint16 mm,
    a block's tile and halo in shared memory, the spatial term from
    ``bilateral_space_table``. ``reference`` launches the design before (a
    thread a pixel, the spatial term formed in the tap loop), which is
    also the path of a half window outside ``BILATERAL_HALVES``; the two
    are bit-equal."""
    _check(depth_mm, "depth_mm", torch.uint16)
    if depth_mm.dim() != 2:
        raise ValueError(f"depth_mm: expected (H, W), got {tuple(depth_mm.shape)}")
    lib = load()
    rows, cols = depth_mm.shape
    out = torch.empty_like(depth_mm)
    sigma_depth_mm = sigma_depth_m * 1000.0
    half = kernel_size // 2
    tiled = not reference and half in BILATERAL_HALVES
    space = None
    if tiled:
        space = (ctypes.c_float * ((2 * half + 1) ** 2))(*bilateral_space_table(kernel_size, sigma_spatial))
    rc = lib.df_bilateral(
        depth_mm.data_ptr(), out.data_ptr(), rows, cols, half,
        0.5 / (sigma_spatial * sigma_spatial), _f32(0.5 / (sigma_depth_mm * sigma_depth_mm)), space, int(not tiled),
        _stream(depth_mm.device),
    )
    _done("bilateral", rc)
    return out


# the ticket of kernels B, G's edge term and E's mutual-nearest pass, one a
# device: the blocks of a launch count themselves out on it and the last
# one puts it back to zero. Every kernel of the port is issued on the
# current stream (``_stream``), so no two launches on a device hold it at
# once.
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _ticket(dev: torch.device) -> torch.Tensor:
    t = _TICKETS.get(dev)
    if t is None:
        t = _TICKETS[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return t


def icp_build_system(
    intr, t_cur, curr_pts, curr_nrm, prev_pts, prev_nrm, dist2_thres, min_cosine, active=None, two_pass=False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B (csrc/icp_reduce.cu, one launch): the 6x6 ICP normal
    equations (A, b), views of one (42,) output. ``active`` (() bool on the
    device) False makes the launch skip its work and return zeros.
    ``two_pass`` launches the design before (the partials, then one block
    that sums them), which sums in the same order: the reference the
    one-launch kernel is held against bit for bit; no path of the port
    asks for it."""
    _check(t_cur, "t_cur", torch.float32, (4, 4))
    _check(curr_pts, "curr_pts", torch.float32)
    _check(curr_nrm, "curr_nrm", torch.float32, curr_pts.shape)
    _check(prev_pts, "prev_pts", torch.float32)
    _check(prev_nrm, "prev_nrm", torch.float32, prev_pts.shape)
    if curr_pts.dim() != 3 or curr_pts.shape[-1] != 3 or prev_pts.dim() != 3 or prev_pts.shape[-1] != 3:
        raise ValueError("point/normal maps must be (H, W, 3)")
    dev = t_cur.device
    if active is None:
        active = torch.ones((), dtype=torch.bool, device=dev)
    _check(active, "active", torch.bool, ())
    _same_device(t_cur, curr_pts, curr_nrm, prev_pts, prev_nrm, active)
    lib = load()
    n = curr_pts.shape[0] * curr_pts.shape[1]
    rows, cols = prev_pts.shape[:2]
    threads = 256
    nblocks = max((n + threads - 1) // threads, 1)
    partial = torch.empty((nblocks, 27), dtype=torch.float32, device=dev)
    out = torch.empty((42,), dtype=torch.float32, device=dev)
    rc = lib.df_icp_reduce(
        t_cur.data_ptr(), curr_pts.data_ptr(), curr_nrm.data_ptr(), prev_pts.data_ptr(),
        prev_nrm.data_ptr(), active.data_ptr(), partial.data_ptr(), None if two_pass else _ticket(dev).data_ptr(),
        out.data_ptr(), n, rows, cols, nblocks,
        _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy),
        _f32(dist2_thres), _f32(min_cosine), int(two_pass), _stream(dev),
    )
    _done("icp_reduce", rc)
    return out[:36].view(6, 6), out[36:]


def march_and_refine(
    tsdf: torch.Tensor,
    ray_org: torch.Tensor,
    dirs: torch.Tensor,
    tmin: torch.Tensor,
    tmax: torch.Tensor,
    voxel_size: float,
    step: float,
    max_steps: int,
    adaptive: bool,
    refine: int = 0,
    smooth: bool = False,
    *,
    delta: float,
    x_off: Optional[int] = None,
    d: Optional[int] = None,
):
    """Kernel C (csrc/raycast.cu): per-ray march + refine on the tsdf
    stored as i16 codes, float32 or bfloat16, ``refine`` 0 = secant + Newton polish, 1 = newton8, 2 =
    newton16, 3 = hybrid16; ``smooth`` takes the normal as the six-sample
    central difference at +-``delta`` voxels. Returns (found, vertex_vol,
    normal_vol); rays that found nothing carry NaN vertex and normal.

    Slab mode (``x_off`` and ``d`` given): ``tsdf`` is a (dx, d, d) x-slab
    of the (d, d, d) volume whose first plane is the global plane ``x_off``;
    returns (found, ts, vertex_vol, normal_vol, t_behind), ts NaN where
    nothing was found, t_behind +inf where no exit event was met."""
    if refine not in (0, 1, 2, 3):
        raise ValueError(f"refine: expected 0 (secant), 1 (newton8), 2 (newton16) or 3 (hybrid16), got {refine}")
    slab = x_off is not None
    if slab != (d is not None):
        raise ValueError("slab mode needs both x_off and d")
    if slab:
        if tsdf.dim() != 3 or tsdf.shape[1:] != (d, d) or tsdf.shape[0] < 1:
            raise ValueError(f"tsdf: expected a (dx, {d}, {d}) slab, got {tuple(tsdf.shape)}")
    elif tsdf.dim() != 3 or len(set(tsdf.shape)) != 1:
        raise ValueError(f"tsdf: expected a (D, D, D) volume, got {tuple(tsdf.shape)}")
    storage = _check_volume(tsdf)
    _check(ray_org, "ray_org", torch.float32, (3,))
    _check(dirs, "dirs", torch.float32)
    if dirs.shape[-1] != 3:
        raise ValueError(f"dirs: expected (..., 3), got {tuple(dirs.shape)}")
    _check(tmin, "tmin", torch.float32, dirs.shape[:-1])
    _check(tmax, "tmax", torch.float32, dirs.shape[:-1])
    _same_device(tsdf, ray_org, dirs, tmin, tmax)
    lib = load()
    dev = tsdf.device
    found = torch.empty(dirs.shape[:-1], dtype=torch.bool, device=dev)
    vertex = torch.empty(dirs.shape, dtype=torch.float32, device=dev)
    normal = torch.empty(dirs.shape, dtype=torch.float32, device=dev)
    ts = torch.empty(dirs.shape[:-1], dtype=torch.float32, device=dev) if slab else None
    t_behind = torch.empty_like(ts) if slab else None
    rc = lib.df_raycast(
        tsdf.data_ptr(), storage, tsdf.shape[1], x_off or 0, tsdf.shape[0], ray_org.data_ptr(), dirs.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), tmin.numel(),
        _f32(1.0 / voxel_size), _f32(step), max_steps, int(adaptive), refine, int(smooth), _f32(delta),
        _decode_scale(tsdf), found.data_ptr(), vertex.data_ptr(), normal.data_ptr(),
        ts.data_ptr() if slab else None, t_behind.data_ptr() if slab else None, _stream(dev),
    )
    _done("raycast", rc)
    if slab:
        return found, ts, vertex, normal, t_behind
    return found, vertex, normal


def _check_cube(tsdf: torch.Tensor, weight: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """(D, storage code) of a whole (D, D, D) volume (``_check_volume``)."""
    if tsdf.dim() != 3 or len(set(tsdf.shape)) != 1:
        raise ValueError(f"tsdf: expected a (D, D, D) volume, got {tuple(tsdf.shape)}")
    return tsdf.shape[0], _check_volume(tsdf, weight)


def _check_image(img: torch.Tensor, name: str) -> Tuple[int, int]:
    _check(img, name, torch.float32)
    if img.dim() != 2:
        raise ValueError(f"{name}: expected (H, W), got {tuple(img.shape)}")
    return img.shape[0], img.shape[1]


def integrate_dense(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    dists: torch.Tensor,
    rt: torch.Tensor,
    ok: torch.Tensor,
    intr,
    trunc: float,
    max_weight: float,
    reference: bool = False,
) -> None:
    """Kernel F1 (csrc/fuse_dense.cu): the dense rigid update of every voxel
    IN PLACE on the tsdf (i16 codes, float32 or bfloat16) and weight (u16
    codes or float32) volumes. ``rt`` (12,) holds
    the volume-to-camera rotation times the voxel size (row-major) and the
    translation; ``ok`` False skips the whole update. A block four warp
    tiles of voxels, a lane a run of 8 along k; ``reference``
    launches the design before (a thread a voxel), which is also the path
    of a side outside ``dense_sides()`` and of a volume not 16-byte
    aligned (``integrate_dense_tiled``); the two are bit-equal."""
    d, storage = _check_cube(tsdf, weight)
    rows, cols = _check_image(dists, "dists")
    _check(rt, "rt", torch.float32, (12,))
    _check(ok, "ok", torch.bool, ())
    _same_device(tsdf, weight, dists, rt, ok)
    lib = load()
    rc = lib.df_fuse_dense(
        tsdf.data_ptr(), weight.data_ptr(), storage, dists.data_ptr(), rt.data_ptr(), ok.data_ptr(), d, rows, cols,
        _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy), _f32(trunc), _f32(max_weight),
        _decode_scale(tsdf), int(not integrate_dense_tiled(tsdf, weight, reference)), _stream(tsdf.device),
    )
    _done("integrate_dense", rc)


_DENSE_SIDES: list = []


def dense_sides() -> Tuple[int, ...]:
    """The volume sides kernel F1's tiled design is compiled for, from the
    library (csrc/fuse_dense.cu)."""
    if not _DENSE_SIDES:
        buf, n = (ctypes.c_int * 16)(), ctypes.c_int(0)
        rc = load().df_fuse_dense_sides(buf, 16, ctypes.byref(n))
        if rc != 0 or not 0 < n.value <= 16:
            raise RuntimeError(f"df_fuse_dense_sides failed: error {rc}, {n.value} sides")
        _DENSE_SIDES.extend(buf[:n.value])
    return tuple(_DENSE_SIDES)


def integrate_dense_tiled(tsdf: torch.Tensor, weight: torch.Tensor, reference: bool = False) -> bool:
    """Whether ``integrate_dense`` launches its tiled design on these
    volumes (else its reference mode): a side in ``dense_sides()`` and
    both volumes 16-byte aligned."""
    return (not reference and tsdf.shape[0] in dense_sides() and tsdf.data_ptr() % 16 == 0
            and weight.data_ptr() % 16 == 0)


def integrate_dense_nonrigid(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    lookup: torch.Tensor,
    warped: torch.Tensor,
    q_grid: Optional[torch.Tensor],
    rt: torch.Tensor,
    ok: torch.Tensor,
    phase: Optional[torch.Tensor],
    stride: int,
    brick: int,
    split: int,
    intr,
    trunc: float,
    max_weight: float,
    q_min: float = 0.0,
    packed: bool = False,
    incidence_floor: float = 0.0,
    sdf_scale: bool = False,
) -> None:
    """Kernel F2 (csrc/fuse_dense.cu): the dense non-rigid update of every
    voxel IN PLACE (the volume in any storage F1 takes): its warped world position (and, given ``q_grid``, its
    observation weight, gating at > ``q_min``) prolonged from the (G, G, G)
    coarse corners ``warped`` (G = D / stride + 1), put into the camera
    frame by ``rt`` (12,: world-to-camera rotation row-major, translation)
    and fused from ``lookup`` (the dists image, or with ``packed`` the
    packed depth+confidence image). With ``split`` > 1 only the voxels of
    the brick x-planes whose index is ``phase`` (a () int32 device tensor)
    modulo ``split`` take part; ``ok`` False skips the whole update."""
    d, storage = _check_cube(tsdf, weight)
    if d % stride or d % brick:
        raise ValueError(f"volume side {d} must be a multiple of stride {stride} and brick {brick}")
    gp = d // stride + 1
    rows, cols = _check_image(lookup, "lookup")
    _check(warped, "warped", torch.float32, (gp, gp, gp, 3))
    _check(rt, "rt", torch.float32, (12,))
    _check(ok, "ok", torch.bool, ())
    _same_device(tsdf, weight, lookup, warped, rt, ok)
    if q_grid is not None:
        _check(q_grid, "q_grid", torch.float32, (gp, gp, gp))
        _same_device(tsdf, q_grid)
    if split > 1:
        _check(phase, "phase", torch.int32, ())
        _same_device(tsdf, phase)
    lib = load()
    rc = lib.df_fuse_dense_nonrigid(
        tsdf.data_ptr(), weight.data_ptr(), storage, lookup.data_ptr(), warped.data_ptr(),
        None if q_grid is None else q_grid.data_ptr(), rt.data_ptr(), ok.data_ptr(),
        None if split == 1 else phase.data_ptr(), d, stride, brick, split, rows, cols,
        _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy), _f32(trunc), _f32(max_weight),
        _decode_scale(tsdf), _f32(q_min), int(packed), _f32(incidence_floor), int(sdf_scale),
        _stream(tsdf.device),
    )
    _done("integrate_dense_nonrigid", rc)


def fuse_bricks(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    dists: torch.Tensor,
    cam_grid: torch.Tensor,
    ids: torch.Tensor,
    kind: torch.Tensor,
    count: torch.Tensor,
    ok: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    brick: int,
    stride: int,
    intr,
    rect: int,
    trunc: float,
    max_weight: float,
    q_grid: Optional[torch.Tensor] = None,
    q_min: float = 0.0,
    packed: bool = False,
    incidence_floor: float = 0.0,
    sdf_scale: bool = False,
    reference: bool = False,
) -> None:
    """Kernel D (csrc/fuse_bricks.cu): front/band/wide brick updates IN
    PLACE on the tsdf (i16 codes, float32 or bfloat16) and weight (u16
    codes or float32) volumes, a persistent grid walking the work slots up
    to ``count[0]`` (every block returns at once when ``ok`` is False).
    ``dists`` is the depth image, or with ``packed`` the packed
    depth+confidence image; ``q_grid`` the optional (G, G, G) observation
    weight prolonged with the grid. Slab mode: ``tsdf`` and ``weight`` a
    (dx, D, D) x-slab, ``cam_grid`` and ``q_grid`` its (dx / stride + 1, G,
    G) corner slab, the list's ids local to the slab. ``reference``
    launches the design before (a block a slot), which is also the path of
    a (brick, stride) outside ``FUSE_SHAPES`` and of a volume not 16-byte
    aligned (``fuse_bricks_persistent``); the two are bit-equal."""
    dx, d = tsdf.shape[0], tsdf.shape[-1]
    if tsdf.dim() != 3 or tsdf.shape[1] != d or d % brick or dx % brick or brick % stride:
        raise ValueError(f"tsdf: bad volume {tuple(tsdf.shape)} for brick {brick}, stride {stride}")
    nbr = (dx // brick) * (d // brick) ** 2
    gp = d // stride + 1
    gx = dx // stride + 1
    storage = _check_volume(tsdf, weight)
    _check(dists, "dists", torch.float32)
    if dists.dim() != 2:
        raise ValueError(f"dists: expected (H, W), got {tuple(dists.shape)}")
    _check(cam_grid, "cam_grid", torch.float32, (gx, gp, gp, 3))
    _check(ids, "ids", torch.int32, (nbr,))
    _check(kind, "kind", torch.int32, (nbr,))
    _check(count, "count", torch.int32, (1,))
    _check(ok, "ok", torch.bool, ())
    _check(u0, "u0", torch.int32, (nbr,))
    _check(v0, "v0", torch.int32, (nbr,))
    _same_device(tsdf, weight, dists, cam_grid, ids, kind, count, ok, u0, v0)
    if q_grid is not None:
        _check(q_grid, "q_grid", torch.float32, (gx, gp, gp))
        _same_device(tsdf, q_grid)
    lib = load()
    rows, cols = dists.shape
    ran = ctypes.c_int(0)
    rc = lib.df_fuse_bricks(
        tsdf.data_ptr(), weight.data_ptr(), storage, dists.data_ptr(), cam_grid.data_ptr(),
        ids.data_ptr(), kind.data_ptr(), count.data_ptr(), ok.data_ptr(),
        u0.data_ptr(), v0.data_ptr(),
        dx, d, brick, stride, rows, cols, nbr,
        _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy), rect,
        _f32(trunc), _f32(max_weight), _decode_scale(tsdf),
        None if q_grid is None else q_grid.data_ptr(), _f32(q_min), int(packed), _f32(incidence_floor),
        int(sdf_scale), _sm_count(tsdf.device), int(not fuse_bricks_persistent(tsdf, weight, brick, stride, reference)),
        ctypes.byref(ran), _stream(tsdf.device),
    )
    _done("fuse_bricks", rc)
    device_kernels["fuse_bricks"] += ran.value


# the (brick, stride) pairs kernel D's persistent kernel is compiled for
# (csrc/fuse_bricks.cu): the non-rigid fusion's b 16 / g 8, the rigid
# b = g = 16, small()'s non-rigid b 16 / g 2
FUSE_SHAPES = ((16, 8), (16, 16), (16, 2))


def fuse_bricks_persistent(tsdf: torch.Tensor, weight: torch.Tensor, brick: int, stride: int,
                           reference: bool = False) -> bool:
    """Whether ``fuse_bricks`` launches its persistent kernel on these
    volumes (else the reference mode): a compiled (brick, stride) and both
    volumes 16-byte aligned."""
    return (not reference and (brick, stride) in FUSE_SHAPES and tsdf.data_ptr() % 16 == 0
            and weight.data_ptr() % 16 == 0)


_SMS: Dict[torch.device, int] = {}


def _sm_count(dev: torch.device) -> int:
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


# --------------------------------------------------------------------------
# kernel E: KNN, DQB blend, warps
# --------------------------------------------------------------------------


def _check_field(positions, active, radius, dq) -> int:
    _check(positions, "positions", torch.float32)
    n = positions.shape[0]
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions: expected (N, 3), got {tuple(positions.shape)}")
    _check(active, "active", torch.bool, (n,))
    if radius is not None:
        _check(radius, "radius", torch.float32, (n,))
    if dq is not None:
        _check(dq, "dq", torch.float32, (n, 8))
    return n


def _check_points(t: torch.Tensor, name: str) -> int:
    _check(t, name, torch.float32)
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"{name}: expected (Q, 3), got {tuple(t.shape)}")
    return t.shape[0]


# kernel E (csrc/knn_blend.cu) splits a query's scan over more lanes the
# fewer the queries: enough lanes in all to fill the card, at most 16
KNN_THREADS = 1 << 16


def knn_lanes(nq: int) -> int:
    """Kernel E's lanes a query for ``nq`` queries: the least power of two
    (1 to 16) that gives KNN_THREADS lanes in all."""
    lanes = 1
    while lanes < 16 and nq * lanes < KNN_THREADS:
        lanes *= 2
    return lanes


def knn_blend(positions, active, radius, dq, queries, k: int, blend: bool = False, warp: bool = False, normals=None,
              lanes: Optional[int] = None):
    """Kernel E (csrc/knn_blend.cu): (d2 (Q, k), idx (Q, k) int64, w (Q, k),
    blend (Q, 8) | None, quality (Q,) | None, warped points (Q, 3) | None,
    rotated normals (Q, 3) | None). ``blend`` asks for the blend and its
    quality, ``warp`` for the warped queries (and ``normals``). ``lanes``:
    the lanes of a query's scan (1, 2, 4, 8 or 16; ``knn_lanes`` by
    default), or 0 for the one-thread-a-query kernel (the same bits; for
    holds and timing)."""
    n = _check_field(positions, active, radius, dq)
    nq = _check_points(queries, "queries")
    if k not in (5, 8) or n < k:
        raise ValueError(f"knn: k must be 5 or 8 and at most the node count {n}, got {k}")
    lanes = knn_lanes(nq) if lanes is None else lanes
    if lanes not in (0, 1, 2, 4, 8, 16):
        raise ValueError(f"knn: lanes must be 0, 1, 2, 4, 8 or 16, got {lanes}")
    if normals is not None:
        _check(normals, "normals", torch.float32, queries.shape)
        if not warp:
            raise ValueError("normals are only warped with warp=True")
    _same_device(positions, active, radius, dq, queries, *([normals] if normals is not None else []))
    lib = load()
    dev = queries.device
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int64, device=dev)
    w = torch.empty((nq, k), dtype=torch.float32, device=dev)
    b = torch.empty((nq, 8), dtype=torch.float32, device=dev) if blend else None
    q = torch.empty((nq,), dtype=torch.float32, device=dev) if blend else None
    wp = torch.empty((nq, 3), dtype=torch.float32, device=dev) if warp else None
    wn = torch.empty((nq, 3), dtype=torch.float32, device=dev) if normals is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.df_knn_blend(
        positions.data_ptr(), active.data_ptr(), radius.data_ptr(), dq.data_ptr(), n,
        queries.data_ptr(), ptr(normals), nq, k, lanes, d2.data_ptr(), idx.data_ptr(), w.data_ptr(),
        ptr(b), ptr(q), ptr(wp), ptr(wn), _stream(dev),
    )
    _done("knn_blend", rc)
    kind = f"k{k}" + " blend" * blend + " warp" * warp + " normals" * (normals is not None)
    knn_kinds[kind] = knn_kinds.get(kind, 0) + 1
    return d2, idx, w, b, q, wp, wn


# the one-launch mutual-nearest pass's per-node scratch, one a device: the
# bits of 1e9 at every entry between launches (the last block of a launch
# puts them back), grown to the largest node count asked for
_BIG_BITS = int(np.float32(1e9).view(np.int32))
_NODE_BITS: Dict[torch.device, torch.Tensor] = {}


def _node_bits(dev: torch.device, n: int) -> torch.Tensor:
    t = _NODE_BITS.get(dev)
    if t is None or t.shape[0] < n:
        t = _NODE_BITS[dev] = torch.full((max(n, 1),), _BIG_BITS, dtype=torch.int32, device=dev)
    return t


def mutual_nearest(positions, active, candidates, valid, three_launch: bool = False):
    """Kernel E (one launch): (per-candidate squared distance to the
    nearest active node (C,), per-node squared distance to the nearest
    valid candidate (N,)), both clamped at 0; nodes with no valid candidate
    read 1e9. ``three_launch`` launches the design before (a fill, the
    one-thread-a-candidate scan, a conversion), the same bits: the
    reference of the holds; no path of the port asks for it."""
    n = _check_field(positions, active, None, None)
    nc = _check_points(candidates, "candidates")
    _check(valid, "valid", torch.bool, (nc,))
    _same_device(positions, active, candidates, valid)
    lib = load()
    dev = candidates.device
    cand_d2 = torch.empty((nc,), dtype=torch.float32, device=dev)
    node_d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    bits = torch.empty((n,), dtype=torch.int32, device=dev) if three_launch else _node_bits(dev, n)
    ran = ctypes.c_int(0)
    rc = lib.df_mutual_nearest(
        positions.data_ptr(), active.data_ptr(), n, candidates.data_ptr(), valid.data_ptr(), nc,
        cand_d2.data_ptr(), bits.data_ptr(), node_d2.data_ptr(), None if three_launch else _ticket(dev).data_ptr(),
        int(three_launch), ctypes.byref(ran), _stream(dev),
    )
    _done("mutual_nearest", rc)
    device_kernels["mutual_nearest"] += ran.value
    return cand_d2, node_d2


def warp_trilinear(dq_grid, points, normals, origin, cell: float):
    """Kernel E: points (and normals) warped by the trilinear DQB blend of
    the (Dc, Dc, Dc, 8) coarse grid; NaN inputs pass through."""
    if dq_grid.dim() != 4 or dq_grid.shape[-1] != 8 or len(set(dq_grid.shape[:3])) != 1:
        raise ValueError(f"dq_grid: expected (Dc, Dc, Dc, 8), got {tuple(dq_grid.shape)}")
    _check(dq_grid, "dq_grid", torch.float32)
    nq = _check_points(points, "points")
    _check(normals, "normals", torch.float32, points.shape)
    _same_device(dq_grid, points, normals)
    lib = load()
    wp = torch.empty_like(points)
    wn = torch.empty_like(normals)
    rc = lib.df_warp_trilinear(
        dq_grid.data_ptr(), dq_grid.shape[0], points.data_ptr(), normals.data_ptr(), nq,
        _f32(origin[0]), _f32(origin[1]), _f32(origin[2]), _f32(cell), wp.data_ptr(), wn.data_ptr(),
        _stream(points.device),
    )
    _done("warp_trilinear", rc)
    return wp, wn


def node_radius(ref_pos, ref_ok, queries, k: int, scale: float, rmin: float, rmax: float) -> torch.Tensor:
    """Kernel E's radius entry: (Q,) clip(scale sqrt(max(d2_k, 0)), rmin,
    rmax), d2_k the k-th smallest squared distance (the expansion, +1e9
    for references not ``ref_ok``) of each finite query to the (N, 3)
    reference nodes, 1 <= k <= min(16, N)."""
    n = _check_field(ref_pos, ref_ok, None, None)
    nq = _check_points(queries, "queries")
    if not 1 <= k <= min(16, n):
        raise ValueError(f"node_radius: k must be in [1, min(16, {n})], got {k}")
    _same_device(ref_pos, ref_ok, queries)
    lib = load()
    out = torch.empty((nq,), dtype=torch.float32, device=queries.device)
    rc = lib.df_node_radius(ref_pos.data_ptr(), ref_ok.data_ptr(), n, queries.data_ptr(), nq, k, _f32(scale),
                            _f32(rmin), _f32(rmax), out.data_ptr(), _stream(queries.device))
    _done("node_radius", rc)
    return out


# --------------------------------------------------------------------------
# kernel F: data term
# --------------------------------------------------------------------------


def _check_lists(order, off, m: int, n: int) -> None:
    _check(order, "order", torch.int32, (m,))
    _check(off, "off", torch.int32, (n + 1,))


def data_term(p_can, p_live, n_live, valid, knn_idx, w_knn, dqs, order, off, tukey_c: float, system: bool,
              t1=None, t2=None, sw=None, point: bool = False, row_stride: int = 1, internals: bool = False):
    """Kernel F (csrc/data_term.cu): (Jᵀr (6N,), cost (), bf16 rows
    (P, R, 8, 6) | None, diagonal blocks (N, 6, 6) | None) of the Tukey-
    weighted data term at eps = 0; the rows and blocks only with
    ``system``. R = 1, point-to-plane; with the tangent basis ``t1``, ``t2``
    (P, 3) and the per-point weight ``sw`` (P,), R = 3: [n·d, sw t1·d,
    sw t2·d]; with ``point``, R = 3: d = warp(p_can) - p_live itself.
    ``row_stride`` s > 1 (tangential rows only) writes the bf16 tangential
    rows of the points p % s == 0 as bf16(sqrt(s) jac). ``internals``
    also returns the kernel's own float32 Jacobian (P, R, 8, 6), weighted
    residuals (P, R) and per-point costs (P,), which its sums add up
    (``warp_solver.data_sums_ordered``)."""
    np_ = _check_points(p_can, "p_can")
    for t, nm in ((p_live, "p_live"), (n_live, "n_live")):
        _check(t, nm, torch.float32, (np_, 3))
    tangential = t1 is not None
    if tangential != (t2 is not None) or tangential != (sw is not None):
        raise ValueError("the tangential rows need t1, t2 and sw together")
    if tangential and point:
        raise ValueError("the point-to-point rows take no tangent basis")
    if row_stride < 1 or (row_stride > 1 and not tangential):
        raise ValueError(f"row_stride {row_stride}: a stride > 1 needs the tangential rows")
    if tangential:
        _check(t1, "t1", torch.float32, (np_, 3))
        _check(t2, "t2", torch.float32, (np_, 3))
        _check(sw, "sw", torch.float32, (np_,))
    _check(valid, "valid", torch.bool, (np_,))
    _check(knn_idx, "knn_idx", torch.int64, (np_, 8))
    _check(w_knn, "w_knn", torch.float32, (np_, 8))
    _check(dqs, "dqs", torch.float32)
    n = dqs.shape[0]
    if dqs.shape != (n, 8):
        raise ValueError(f"dqs: expected (N, 8), got {tuple(dqs.shape)}")
    _check_lists(order, off, np_ * 8, n)
    _same_device(p_can, p_live, n_live, valid, knn_idx, w_knn, dqs, order, off, *((t1, t2, sw) if tangential else ()))
    lib = load()
    dev = dqs.device
    nr = 3 if tangential or point else 1
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    jac = torch.empty((np_, nr, 8, 6), dtype=torch.float32, device=dev)
    rows = torch.empty((np_, nr, 8, 6), dtype=torch.bfloat16, device=dev) if system else None
    rw = torch.empty((np_, nr), dtype=torch.float32, device=dev)
    rho = torch.empty((np_,), dtype=torch.float32, device=dev)
    jtr = torch.empty((6 * n,), dtype=torch.float32, device=dev)
    blocks = torch.empty((n, 6, 6), dtype=torch.float32, device=dev) if system else None
    cost = torch.empty((), dtype=torch.float32, device=dev)
    rc = lib.df_data_term(
        p_can.data_ptr(), p_live.data_ptr(), n_live.data_ptr(), ptr(t1), ptr(t2), ptr(sw), valid.data_ptr(),
        knn_idx.data_ptr(), w_knn.data_ptr(), dqs.data_ptr(), np_, n, nr, int(point), order.data_ptr(), off.data_ptr(),
        _f32(tukey_c), _f32(tukey_c * tukey_c / 6.0), row_stride, _f32(np.sqrt(row_stride)), jac.data_ptr(),
        ptr(rows), rw.data_ptr(), rho.data_ptr(),
        jtr.data_ptr(), ptr(blocks), cost.data_ptr(), _stream(dev),
    )
    _done("data_term", rc)
    if internals:
        return jtr, cost, rows, blocks, jac, rw, rho
    return jtr, cost, rows, blocks


def data_term_lanes() -> Tuple[int, int]:
    """Kernel F's lanes a point (pass 1) and a node (pass 2) in the loaded
    library: ``warp_solver.data_sums_ordered`` takes the second."""
    out = (ctypes.c_int * 2)()
    load().df_data_term_lanes(ctypes.addressof(out))
    return out[0], out[1]


# --------------------------------------------------------------------------
# kernel G: edge term, spd6_inv, matvec, PCG
# --------------------------------------------------------------------------


def edge_term(dqs, e_src, e_dst, e_valid, v_dst, alpha, e_order, e_off, lam: float, delta: float,
              three_launch: bool = False):
    """Kernel G's edge entry (csrc/pcg.cu, one launch): (Jᵀr (6N,), cost (),
    h_ii, h_jj, h_ij (E, 6, 6), diagonal share (N, 6, 6)) of the Huber-
    weighted ARAP term at eps = 0. Edge e's source node must be e // (E /
    N). ``three_launch`` launches the design before (a thread an edge, a
    thread a node, one block for the cost), which sums in the same order:
    the reference the one launch is held against bit for bit; no path of
    the port asks for it."""
    _check(dqs, "dqs", torch.float32)
    n = dqs.shape[0]
    ne = e_src.shape[0]
    if n == 0 or ne % n:
        raise ValueError(f"edges: {ne} is not a multiple of the node count {n}")
    _check(e_src, "e_src", torch.int64, (ne,))
    _check(e_dst, "e_dst", torch.int64, (ne,))
    _check(e_valid, "e_valid", torch.bool, (ne,))
    _check(v_dst, "v_dst", torch.float32, (ne, 3))
    _check(alpha, "alpha", torch.float32, (ne,))
    _check_lists(e_order, e_off, ne, n)
    _same_device(dqs, e_src, e_dst, e_valid, v_dst, alpha, e_order, e_off)
    lib = load()
    dev = dqs.device
    h = torch.empty((3, ne, 6, 6), dtype=torch.float32, device=dev)
    g = torch.empty((2, ne, 6), dtype=torch.float32, device=dev)
    cost_e = torch.empty((ne,), dtype=torch.float32, device=dev)
    jtr = torch.empty((6 * n,), dtype=torch.float32, device=dev)
    diag = torch.empty((n, 6, 6), dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    ran = ctypes.c_int(0)
    rc = lib.df_edge_term(
        dqs.data_ptr(), e_src.data_ptr(), e_dst.data_ptr(), e_valid.data_ptr(), v_dst.data_ptr(),
        alpha.data_ptr(), ne, n, e_order.data_ptr(), e_off.data_ptr(), _f32(lam), _f32(delta),
        h[0].data_ptr(), h[1].data_ptr(), h[2].data_ptr(), g[0].data_ptr(), g[1].data_ptr(),
        cost_e.data_ptr(), jtr.data_ptr(), diag.data_ptr(), cost.data_ptr(),
        None if three_launch else _ticket(dev).data_ptr(), int(three_launch), ctypes.byref(ran), _stream(dev),
    )
    _done("edge_term", rc)
    device_kernels["edge_term"] += ran.value
    return jtr, cost, h[0], h[1], h[2], diag


def _check_blocks(m: torch.Tensor, name: str) -> int:
    _check(m, name, torch.float32)
    if m.dim() != 3 or m.shape[1:] != (6, 6):
        raise ValueError(f"{name}: expected (N, 6, 6), got {tuple(m.shape)}")
    return m.shape[0]


def spd6_inv(m: torch.Tensor, reference: bool = False) -> torch.Tensor:
    """Kernel G (csrc/pcg.cu, one launch): closed-form inverses of (N, 6, 6)
    SPD blocks, a thread a node in blocks of 16. ``reference`` launches the
    design before (blocks of 128 nodes), which the kernel is held against
    bit for bit; no path of the port asks for it."""
    n = _check_blocks(m, "m")
    lib = load()
    out = torch.empty_like(m)
    ran = ctypes.c_int(0)
    rc = lib.df_spd6_inv(m.data_ptr(), None, None, None, None, n, out.data_ptr(), None, int(reference),
                         ctypes.byref(ran), _stream(m.device))
    _done("spd6_inv", rc)
    device_kernels["spd6_inv"] += ran.value
    return out


def spd6_inv_damped(blocks: torch.Tensor, diag_eff: torch.Tensor, unit: torch.Tensor, lm_lambda: torch.Tensor,
                    rebuild: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    """Kernel G's damped entry (csrc/pcg.cu, one launch): an LM
    iteration's block-Jacobi preconditioner. Returns damp = lm_lambda *
    diag_eff + unit (6N,) and, where the device flag ``rebuild`` is true,
    writes the inverses of ``blocks`` + diag(damp) into ``minv`` (N, 6, 6)
    in place; where it is false ``minv`` keeps its last result. The host
    reads neither ``lm_lambda`` nor ``rebuild``. The same bits as
    ``spd6_inv(blocks + diag_embed(damp))`` kept by ``torch.where(rebuild,
    ., minv)``."""
    n = _check_blocks(blocks, "blocks")
    _check(minv, "minv", torch.float32, blocks.shape)
    _check(diag_eff, "diag_eff", torch.float32, (6 * n,))
    _check(unit, "unit", torch.float32, (6 * n,))
    _check(lm_lambda, "lm_lambda", torch.float32, ())
    _check(rebuild, "rebuild", torch.bool, ())
    _same_device(blocks, diag_eff, unit, lm_lambda, rebuild, minv)
    lib = load()
    damp = torch.empty_like(diag_eff)
    ran = ctypes.c_int(0)
    rc = lib.df_spd6_inv(blocks.data_ptr(), diag_eff.data_ptr(), unit.data_ptr(), lm_lambda.data_ptr(),
                         rebuild.data_ptr(), n, minv.data_ptr(), damp.data_ptr(), 0, ctypes.byref(ran),
                         _stream(blocks.device))
    _done("spd6_inv", rc)
    device_kernels["spd6_inv"] += ran.value
    return damp


class FactoredSystem(NamedTuple):
    """The factored normal equations as kernel G takes them (the int32
    copies and the heavy-first order are built once a solve structure, by
    ``warp_solver.prepare``)."""

    rows: torch.Tensor      # (P, R, 8, 6) bf16, R = 1 or 3 residual rows a point
    knn_idx: torch.Tensor   # (P, 8) int32
    pt_order: torch.Tensor  # (8P,) int32
    pt_off: torch.Tensor    # (N + 1,) int32
    heavy: torch.Tensor     # (N,) int64: nodes by descending entry count, ties by index
    h_ii: torch.Tensor      # (E, 6, 6)
    h_jj: torch.Tensor
    h_ij: torch.Tensor
    e_dst: torch.Tensor     # (E,) int32; edge e's source node is e // (E / N)
    e_order: torch.Tensor   # (E,) int32
    e_off: torch.Tensor     # (N + 1,) int32
    damp: torch.Tensor      # (6N,)


def _row_mode(nr: int, used: Optional[int], stride: int) -> Tuple[int, int]:
    """(rows used, tangential stride) of the matvec's row mode: all R rows
    of every point by default; 1 the plane row only; with R = 3, ``stride``
    s > 1 the tangential rows of the points p % s == 0 only."""
    used = nr if used is None else used
    if used not in (1, nr) or stride < 1 or (stride > 1 and (nr != 3 or used != 3)):
        raise ValueError(f"row mode: {used} of {nr} rows, stride {stride}")
    return used, stride


def _system_args(s: FactoredSystem):
    _check(s.rows, "rows", torch.bfloat16)
    if s.rows.dim() != 4 or s.rows.shape[1] not in (1, 3) or s.rows.shape[2:] != (8, 6):
        raise ValueError(f"rows: expected (P, 1 or 3, 8, 6), got {tuple(s.rows.shape)}")
    np_, nr = s.rows.shape[:2]
    n = s.damp.shape[0] // 6
    ne = s.e_dst.shape[0]
    _check(s.knn_idx, "knn_idx", torch.int32, (np_, 8))
    _check_lists(s.pt_order, s.pt_off, np_ * 8, n)
    _check(s.heavy, "heavy", torch.int64, (n,))
    for t, nm in ((s.h_ii, "h_ii"), (s.h_jj, "h_jj"), (s.h_ij, "h_ij")):
        _check(t, nm, torch.float32, (ne, 6, 6))
    _check(s.e_dst, "e_dst", torch.int32, (ne,))
    _check_lists(s.e_order, s.e_off, ne, n)
    _check(s.damp, "damp", torch.float32, (6 * n,))
    if ne % n:
        raise ValueError(f"edges: {ne} is not a multiple of the node count {n}")
    _same_device(*s)
    return tuple(t.data_ptr() for t in s) + (np_, n, ne // n, nr), np_ * nr, n


class ClusterPlan(NamedTuple):
    """A launch of kernel G's cluster (``df_pcg_plan``) on one device."""

    cluster: int   # CTAs in the cluster
    smem: int      # dynamic shared memory a CTA, bytes
    shared_p: bool  # p's copies in shared memory (else p in device memory)
    clusters: int  # such clusters the card can hold at once (the launch needs 1)


_PLANS: Dict[Tuple, ClusterPlan] = {}


def cluster_plan(pcg: bool, n: int, nrows: int, used: Optional[int] = None, stride: int = 1,
                 shared_p: Optional[bool] = None, device: Optional[torch.device] = None) -> ClusterPlan:
    """Kernel G's cluster launch at ``n`` nodes for the PCG (``pcg``) or the
    single matvec on ``device`` (None: the current CUDA device): p in
    shared memory where it fits (``shared_p`` None) or as asked. Raises
    where the card cannot schedule the cluster: there is no other route."""
    mode = _row_mode(nrows, used, stride)
    want = -1 if shared_p is None else int(shared_p)
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    key = (dev, bool(pcg), n, nrows, *mode, want)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_int * 4)()
        with _on(dev):
            rc = load().df_pcg_plan(int(pcg), n, nrows, *mode, want, out)
        if rc != 0:
            raise ValueError(f"kernel G's cluster at {n} nodes, p in "
                             f"{'shared memory' if shared_p else 'any memory'}: refused (error {rc})")
        plan = ClusterPlan(out[0], out[1], bool(out[2]), out[3])
        if plan.clusters < 1:
            raise RuntimeError(f"kernel G: a cluster of {plan.cluster} CTAs with {plan.smem} bytes of shared memory "
                               f"each cannot be scheduled on this card")
        _PLANS[key] = plan
    return plan


def matvec(s: FactoredSystem, p: torch.Tensor, used: Optional[int] = None, stride: int = 1) -> torch.Tensor:
    """Kernel G: (rows_bf16ᵀ bf16(rows_bf16 bf16(p))) + edge blocks p +
    damp p, one cluster launch (``cluster_plan``); t = bf16(row · bf16(p))
    per (point, row), over the rows of the row mode (``used``, ``stride``:
    ``_row_mode``)."""
    ptrs, n_rows, n = _system_args(s)
    mode = _row_mode(s.rows.shape[1], used, stride)
    _check(p, "p", torch.float32, (6 * n,))
    _same_device(p, s.damp)
    plan = cluster_plan(False, n, s.rows.shape[1], used, stride, device=p.device)
    lib = load()
    ap = torch.empty_like(p)
    t = torch.empty((max(n_rows, 1),), dtype=torch.float32, device=p.device)
    with _on(p.device):
        rc = lib.df_matvec(*ptrs, *mode, int(plan.shared_p), p.data_ptr(), ap.data_ptr(), t.data_ptr(),
                           _stream(p.device))
    _done("matvec", rc)
    return ap


def pcg(s: FactoredSystem, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float, active: torch.Tensor,
        used: Optional[int] = None, stride: int = 1, shared_p: Optional[bool] = None):
    """Kernel G: the whole block-Jacobi PCG solve from x = 0 in one cluster
    launch (``cluster_plan``; ``shared_p`` False keeps p in device memory,
    the path of systems too large for shared memory); at most ``iters``
    iterations while rᵀr > rtol² bᵀb; ``active`` (a () bool device tensor)
    False returns zeros; the matvec's row mode as in ``matvec``."""
    ptrs, n_rows, n = _system_args(s)
    mode = _row_mode(s.rows.shape[1], used, stride)
    _check(minv, "minv", torch.float32, (n, 6, 6))
    _check(b, "b", torch.float32, (6 * n,))
    _check(active, "active", torch.bool, ())
    _same_device(b, minv, active, s.damp)
    plan = cluster_plan(True, n, s.rows.shape[1], used, stride, shared_p, device=b.device)
    lib = load()
    x = torch.empty_like(b)
    # r, z, p, Ap and x (6N each), then t
    work = torch.empty((5 * 6 * n + max(n_rows, 1),), dtype=torch.float32, device=b.device)
    with _on(b.device):
        rc = lib.df_pcg(
            *ptrs, *mode, int(plan.shared_p), minv.data_ptr(), b.data_ptr(), iters, _f32(rtol * rtol),
            active.data_ptr(), x.data_ptr(), work.data_ptr(), _stream(b.device),
        )
    _done("pcg", rc)
    return x


def data_matvec(rows: torch.Tensor, knn_idx: torch.Tensor, order: torch.Tensor, off: torch.Tensor,
                heavy: torch.Tensor, p: torch.Tensor, used: Optional[int] = None, stride: int = 1,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel G's shard entry (csrc/pcg.cu, two launches: a thread per
    (point, row), then a warp per node, heaviest first by ``heavy``): one
    shard's data product rowsᵀ bf16(rows bf16(p)) in the PCG's rounding
    and per-lane sum order, no edge blocks, no damping; ``knn_idx`` int32;
    the row mode as ``matvec``'s. ``state`` (the loop state of
    ``pcg_sharded_init``'s work) makes a finished loop's launches return at
    once (the output then keeps what it held)."""
    _check(rows, "rows", torch.bfloat16)
    if rows.dim() != 4 or rows.shape[1] not in (1, 3) or rows.shape[2:] != (8, 6):
        raise ValueError(f"rows: expected (P, 1 or 3, 8, 6), got {tuple(rows.shape)}")
    np_, nr = rows.shape[:2]
    n = off.shape[0] - 1
    _check(knn_idx, "knn_idx", torch.int32, (np_, 8))
    _check_lists(order, off, np_ * 8, n)
    _check(heavy, "heavy", torch.int64, (n,))
    _check(p, "p", torch.float32, (6 * n,))
    mode = _row_mode(nr, used, stride)
    _same_device(rows, knn_idx, order, off, heavy, p)
    if state is not None:
        _check(state, "state", torch.float32, (3,))
        _same_device(p, state)
    lib = load()
    ap = torch.empty_like(p)
    t = torch.empty((max(np_ * nr, 1),), dtype=torch.float32, device=p.device)
    rc = lib.df_data_matvec(
        rows.data_ptr(), knn_idx.data_ptr(), order.data_ptr(), off.data_ptr(), heavy.data_ptr(), np_, n, nr, *mode,
        p.data_ptr(), ap.data_ptr(), t.data_ptr(), None if state is None else state.data_ptr(), _stream(p.device),
    )
    _done("data_matvec", rc)
    return ap


def pcg_sharded_init(minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float, active: torch.Tensor):
    """The distributed PCG's start (kernel P's init, csrc/dense_pcg.cu): x
    = 0, r = b, z = p = M b and the loop state. Returns (x, work): work
    holds r, z, p, Ap (6N each) and the state (rz, rtol² bᵀb, done) as its
    last three words; ``work[2 * 6N: 3 * 6N]`` is the direction p."""
    _check(b, "b", torch.float32)
    dof = b.shape[0]
    if b.dim() != 1 or dof % 6:
        raise ValueError(f"b: expected (6N,), got {tuple(b.shape)}")
    _check(minv, "minv", torch.float32, (dof // 6, 6, 6))
    _check(active, "active", torch.bool, ())
    _same_device(minv, b, active)
    lib = load()
    x = torch.empty_like(b)
    work = torch.empty((4 * dof + 3,), dtype=torch.float32, device=b.device)
    rc = lib.df_pcg_init(minv.data_ptr(), b.data_ptr(), dof // 6, iters, _f32(rtol * rtol), active.data_ptr(),
                         x.data_ptr(), work.data_ptr(), _stream(b.device))
    _done("pcg_init", rc)
    return x, work


def pcg_sharded_step(s: FactoredSystem, minv: torch.Tensor, apd: torch.Tensor, x: torch.Tensor,
                     work: torch.Tensor) -> None:
    """One iteration of the distributed PCG, in place on ``x`` and ``work``
    (two launches): kernel G's ``Ap = (apd + edge blocks p) + damp p``
    from the psum'd data product ``apd`` (csrc/pcg.cu, a thread per node),
    then kernel P's one-block update of x, r, z, p and the loop state;
    both return at once when the loop is done. ``s``'s data fields are not
    read."""
    n = s.damp.shape[0] // 6
    dof = 6 * n
    ne = s.e_dst.shape[0]
    for t, nm in ((s.h_ii, "h_ii"), (s.h_jj, "h_jj"), (s.h_ij, "h_ij")):
        _check(t, nm, torch.float32, (ne, 6, 6))
    _check(s.e_dst, "e_dst", torch.int32, (ne,))
    _check_lists(s.e_order, s.e_off, ne, n)
    _check(s.damp, "damp", torch.float32, (dof,))
    if ne % n:
        raise ValueError(f"edges: {ne} is not a multiple of the node count {n}")
    _check(minv, "minv", torch.float32, (n, 6, 6))
    _check(apd, "apd", torch.float32, (dof,))
    _check(x, "x", torch.float32, (dof,))
    _check(work, "work", torch.float32, (4 * dof + 3,))
    _same_device(s.h_ii, s.h_jj, s.h_ij, s.e_dst, s.e_order, s.e_off, s.damp, minv, apd, x, work)
    lib = load()
    st = work[4 * dof:]
    rc = lib.df_edge_apply(
        s.h_ii.data_ptr(), s.h_jj.data_ptr(), s.h_ij.data_ptr(), s.e_dst.data_ptr(), s.e_order.data_ptr(),
        s.e_off.data_ptr(), s.damp.data_ptr(), n, ne // n, work[2 * dof:].data_ptr(), apd.data_ptr(),
        work[3 * dof:].data_ptr(), st.data_ptr(), _stream(x.device),
    )
    if rc == 0:
        rc = lib.df_pcg_update(minv.data_ptr(), n, x.data_ptr(), work.data_ptr(), _stream(x.device))
    _done("pcg_step", rc)


class ShardData(NamedTuple):
    """One local shard's data fields for the distributed PCG: kernel G's
    ``FactoredSystem`` data fields of the shard's points."""

    rows: torch.Tensor      # (P_k, R, 8, 6) bf16
    knn_idx: torch.Tensor   # (P_k, 8) int32
    pt_order: torch.Tensor  # (8 P_k,) int32
    pt_off: torch.Tensor    # (N + 1,) int32
    heavy: torch.Tensor     # (N,) int64: the shard's nodes by descending entry count


MAX_SHARDS = 8  # local shards a launch (csrc/pcg.cu kMaxShards)
_SHARDED_PLANS: Dict[Tuple, Tuple[ClusterPlan, int]] = {}


def sharded_pcg_plan(n: int, nrows: int, nps: Tuple[int, ...], used: Optional[int] = None, stride: int = 1,
                     shared_p: Optional[bool] = None,
                     device: Optional[torch.device] = None) -> Tuple[ClusterPlan, int]:
    """(the cluster launch, the work's floats) of the distributed PCG at
    ``n`` nodes for shards of ``nps`` points on ``device`` (the library's
    ``df_sharded_pcg_plan``): p in shared memory where it fits
    (``shared_p`` None) or as asked. Raises where the card cannot schedule
    the cluster: there is no other route."""
    mode = _row_mode(nrows, used, stride)
    if not 1 <= len(nps) <= MAX_SHARDS:
        raise ValueError(f"the distributed PCG takes 1 to {MAX_SHARDS} local shards, got {len(nps)}")
    want = -1 if shared_p is None else int(shared_p)
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    key = (dev, n, nrows, *mode, want, tuple(nps))
    got = _SHARDED_PLANS.get(key)
    if got is None:
        out = (ctypes.c_int * 5)()
        counts = (ctypes.c_int * len(nps))(*nps)
        with _on(dev):
            rc = load().df_sharded_pcg_plan(n, nrows, *mode, want, len(nps), counts, out)
        if rc != 0:
            raise ValueError(f"the distributed PCG's cluster at {n} nodes, p in "
                             f"{'shared memory' if shared_p else 'any memory'}: refused (error {rc})")
        plan = ClusterPlan(out[0], out[1], bool(out[2]), out[3])
        if plan.clusters < 1:
            raise RuntimeError(f"the distributed PCG: a cluster of {plan.cluster} CTAs with {plan.smem} bytes of "
                               f"shared memory each cannot be scheduled on this card")
        got = _SHARDED_PLANS[key] = (plan, out[4])
    return got


def pcg_sharded(s: FactoredSystem, shards, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float,
                active: torch.Tensor, used: Optional[int] = None, stride: int = 1, shared_p: Optional[bool] = None,
                reduce=None) -> torch.Tensor:
    """Kernel G's distributed PCG (csrc/pcg.cu ``sharded_pcg_kernel``, with
    kernel P's init and update): x solving (the local ``shards``' data
    products psum'd + the edge blocks + damp) x = b from x = 0, at most
    ``iters`` iterations while rᵀr > rtol² bᵀb, zeros where ``active`` (a
    () bool device tensor) is False; the same bits as the composition of
    ``data_matvec``, the psum and ``pcg_sharded_step``. ``shards``: the
    ``ShardData`` of this process's shards, all on ``b``'s card (1 to
    ``MAX_SHARDS``); ``s``: the edge system and the damping (its data
    fields are not read); the row mode as ``matvec``'s. Without ``reduce``
    (a one-process mesh) the whole solve is ONE cluster launch. Under a
    process group ``reduce`` is the all-reduce across the ranks of a value
    already summed over this rank's shards (``Mesh.psum_ranks``): a host
    collective, so each iteration is two launches around it, the loop's
    state in device memory between them. A one-process mesh over several
    cards is not this kernel's: ``warp_solver.pcg_sharded`` runs the
    composition there."""
    n = s.damp.shape[0] // 6
    dof = 6 * n
    ne = s.e_dst.shape[0]
    for t, nm in ((s.h_ii, "h_ii"), (s.h_jj, "h_jj"), (s.h_ij, "h_ij")):
        _check(t, nm, torch.float32, (ne, 6, 6))
    _check(s.e_dst, "e_dst", torch.int32, (ne,))
    _check_lists(s.e_order, s.e_off, ne, n)
    _check(s.damp, "damp", torch.float32, (dof,))
    if ne % n:
        raise ValueError(f"edges: {ne} is not a multiple of the node count {n}")
    _check(minv, "minv", torch.float32, (n, 6, 6))
    _check(b, "b", torch.float32, (dof,))
    _check(active, "active", torch.bool, ())
    shards = list(shards)
    if not 1 <= len(shards) <= MAX_SHARDS:
        raise ValueError(f"the distributed PCG takes 1 to {MAX_SHARDS} local shards, got {len(shards)}")
    nr = shards[0].rows.shape[1] if shards[0].rows.dim() == 4 else 0
    for k, sh in enumerate(shards):
        _check(sh.rows, f"shard {k} rows", torch.bfloat16)
        if sh.rows.dim() != 4 or sh.rows.shape[1] != nr or nr not in (1, 3) or sh.rows.shape[2:] != (8, 6):
            raise ValueError(f"shard {k} rows: expected (P, {nr or '1 or 3'}, 8, 6), got {tuple(sh.rows.shape)}")
        np_ = sh.rows.shape[0]
        _check(sh.knn_idx, f"shard {k} knn_idx", torch.int32, (np_, 8))
        _check_lists(sh.pt_order, sh.pt_off, np_ * 8, n)
        _check(sh.heavy, f"shard {k} heavy", torch.int64, (n,))
        _same_device(b, *sh)
    _same_device(b, minv, active, s.h_ii, s.h_jj, s.h_ij, s.e_dst, s.e_order, s.e_off, s.damp)
    mode = _row_mode(nr, used, stride)
    dev = b.device
    plan, words = sharded_pcg_plan(n, nr, tuple(sh.rows.shape[0] for sh in shards), used, stride, shared_p, dev)
    lib = load()
    x = torch.empty_like(b)
    work = torch.empty((words,), dtype=torch.float32, device=dev)
    fields = (ctypes.c_void_p * (5 * len(shards)))(*[t.data_ptr() for sh in shards for t in sh])
    nps = (ctypes.c_int * len(shards))(*[sh.rows.shape[0] for sh in shards])
    head = (fields, nps, len(shards), s.h_ii.data_ptr(), s.h_jj.data_ptr(), s.h_ij.data_ptr(), s.e_dst.data_ptr(),
            s.e_order.data_ptr(), s.e_off.data_ptr(), s.damp.data_ptr(), n, ne // n, nr, *mode, int(plan.shared_p),
            minv.data_ptr(), b.data_ptr(), iters, _f32(rtol * rtol), active.data_ptr())

    def launch(phase: int, apd_in: Optional[torch.Tensor] = None) -> None:
        ran = ctypes.c_int(0)
        with _on(dev):
            rc = lib.df_sharded_pcg(*head, phase, None if apd_in is None else apd_in.data_ptr(), x.data_ptr(),
                                    work.data_ptr(), ctypes.byref(ran), _stream(dev))
        _done("pcg_sharded", rc)
        device_kernels["pcg_sharded"] += ran.value

    if reduce is None:
        launch(0)
        return x
    # this rank's tree of its shards' products, written by each local launch
    apd = work[len(shards) * dof: (len(shards) + 1) * dof]
    for it in range(max(iters, 1)):
        launch(1 if it == 0 else 2)
        total = reduce(apd)
        _check(total, "the all-reduced data product", torch.float32, (dof,))
        _same_device(b, total)
        launch(3, total)
    return x


# --------------------------------------------------------------------------
# kernels N and O: the dense normal equations and their damping; the factor
# --------------------------------------------------------------------------


def gram_scales(rows: torch.Tensor, order: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Kernel N's scale entry (csrc/dense_system.cu): the (6N,) int8 column
    scales max(max |row|, 1e-12) / 127 of the bf16 (P, R, 8, 6) rows, over
    each node's (point, neighbour) entries (``order``, ``off``)."""
    _check(rows, "rows", torch.bfloat16)
    if rows.dim() != 4 or rows.shape[1] not in (1, 3) or rows.shape[2:] != (8, 6):
        raise ValueError(f"rows: expected (P, 1 or 3, 8, 6), got {tuple(rows.shape)}")
    n = off.shape[0] - 1
    _check_lists(order, off, rows.shape[0] * 8, n)
    _same_device(rows, order, off)
    lib = load()
    scale = torch.empty((6 * n,), dtype=torch.float32, device=rows.device)
    rc = lib.df_gram_scales(rows.data_ptr(), rows.shape[1], order.data_ptr(), off.data_ptr(), n, scale.data_ptr(),
                            _stream(rows.device))
    _done("gram_scales", rc)
    return scale


def gram_launch(n: int) -> Tuple[int, int, int]:
    """(blocks, threads a block, column nodes a block) of kernel N at ``n``
    nodes, as the library (csrc/dense_system.cu) launches it: a block a
    (node, column tile), shared memory fixed whatever n. Its one limit of
    its own is the grid, n x ceil(n / tile) blocks below 2^31; the (6n)^2
    float32 matrix must also fit in device memory (~23 500 nodes on 80 GB)."""
    geom = (ctypes.c_int * 3)()
    if load().df_gram_launch(n, geom):
        raise ValueError(f"dense_gram: {n} nodes: kernel N takes at least one node and a grid of n x ceil(n / "
                         f"{geom[2]}) blocks below 2^31")
    return geom[0], geom[1], geom[2]


def dense_gram(rows, knn_idx, order, off, h_ij, diag, e_dst, e_order, e_off, int8: bool,
               scale: Optional[torch.Tensor] = None, edges: bool = True) -> torch.Tensor:
    """Kernel N (csrc/dense_system.cu): the dense (6N, 6N) float32 normal
    equations, the data Gram of the bf16 rows (int8 with ``gram_scales``'
    column scales, each row value quantized once, and exact int32 sums,
    or the bf16 products summed in float64 in each node's entry order and
    rounded once) plus the ARAP blocks ``h_ij`` (E, 6, 6) placed at (src,
    dst) and transposed at (dst, src) and the diagonal blocks ``diag`` (N,
    6, 6). Edge e's source node must be e // (E / N). ``knn_idx`` and
    ``e_dst`` int32 (built once a solve structure, by
    ``warp_solver.prepare``). Three launches in int8 mode (the codes, the
    nodes' order, the Gram), two in bf16 mode; any N that ``gram_launch``
    takes.

    Shard mode: ``scale`` the (6N,) column scales to quantize with (the
    pmax of the shards' ``gram_scales``) and ``edges=False`` the data Gram
    alone (the edge arguments may be None then)."""
    _check(rows, "rows", torch.bfloat16)
    if rows.dim() != 4 or rows.shape[1] not in (1, 3) or rows.shape[2:] != (8, 6):
        raise ValueError(f"rows: expected (P, 1 or 3, 8, 6), got {tuple(rows.shape)}")
    np_ = rows.shape[0]
    n = off.shape[0] - 1
    _check(knn_idx, "knn_idx", torch.int32, (np_, 8))
    _check_lists(order, off, np_ * 8, n)
    _same_device(rows, knn_idx, order, off)
    if n < 1:
        raise ValueError(f"dense_gram: needs at least one node, got {n}")
    if edges:
        _check(diag, "diag", torch.float32, (n, 6, 6))
        ne = e_dst.shape[0]
        if ne % n:
            raise ValueError(f"edges: {ne} is not a multiple of the node count {n}")
        _check(h_ij, "h_ij", torch.float32, (ne, 6, 6))
        _check(e_dst, "e_dst", torch.int32, (ne,))
        _check_lists(e_order, e_off, ne, n)
        _same_device(rows, h_ij, diag, e_dst, e_order, e_off)
    if scale is not None:
        if not int8:
            raise ValueError("dense_gram: column scales are for the int8 Gram")
        _check(scale, "scale", torch.float32, (6 * n,))
        _same_device(rows, scale)
    elif int8:
        scale = gram_scales(rows, order, off)
    else:
        scale = torch.empty((1,), dtype=torch.float32, device=rows.device)
    gram_launch(n)
    lib = load()
    if rows.data_ptr() % 16:  # the kernel copies a point's rows in 16-byte pieces
        rows = rows.clone()
    codes = torch.empty((np_ * rows.shape[1] * 48,) if int8 else (0,), dtype=torch.int8, device=rows.device)
    perm = torch.empty((n,), dtype=torch.int32, device=rows.device)
    out = torch.empty((6 * n, 6 * n), dtype=torch.float32, device=rows.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.df_dense_gram(
        rows.data_ptr(), rows.shape[1], np_, knn_idx.data_ptr(), order.data_ptr(), off.data_ptr(), scale.data_ptr(),
        ptr(h_ij) if edges else None, ptr(diag) if edges else None, ptr(e_dst) if edges else None,
        ptr(e_order) if edges else None,
        ptr(e_off) if edges else None, e_dst.shape[0] // n if edges else 1, n, int(int8), int(edges),
        codes.data_ptr(), perm.data_ptr(), out.data_ptr(), _stream(rows.device),
    )
    _done("dense_gram", rc)
    return out


def dense_damp(jtj: torch.Tensor, lm_lambda: torch.Tensor, active: torch.Tensor, floor: float) -> torch.Tensor:
    """Kernel O (csrc/dense_system.cu): jtj with (d + lambda d_eff) + unit
    on its diagonal, d_eff = max(d, floor x the mean of d over the active
    dofs), unit 1e-8 where the dof is active and d > 1e-12, else 1;
    ``lm_lambda`` a () float32 device tensor."""
    _check(jtj, "jtj", torch.float32)
    dof = jtj.shape[0]
    if jtj.dim() != 2 or jtj.shape[1] != dof or dof % 6:
        raise ValueError(f"jtj: expected (6N, 6N), got {tuple(jtj.shape)}")
    n = dof // 6
    _check(lm_lambda, "lm_lambda", torch.float32, ())
    _check(active, "active", torch.bool, (n,))
    _same_device(jtj, lm_lambda, active)
    lib = load()
    thresh = torch.empty((1,), dtype=torch.float32, device=jtj.device)
    out = torch.empty_like(jtj)
    rc = lib.df_dense_damp(jtj.data_ptr(), active.data_ptr(), lm_lambda.data_ptr(), n, _f32(floor),
                           thresh.data_ptr(), out.data_ptr(), _stream(jtj.device))
    _done("dense_damp", rc)
    return out


def dense_pcg(a: torch.Tensor, minv: torch.Tensor, b: torch.Tensor, iters: int, rtol: float,
              active: torch.Tensor) -> torch.Tensor:
    """Kernel P (csrc/dense_pcg.cu, 1 + 2 ``iters`` launches): block-Jacobi
    PCG from x = 0 over the dense (6N, 6N) float32 matrix ``a`` with the
    (N, 6, 6) preconditioner ``minv``, at most ``iters`` iterations while
    rᵀr > rtol² bᵀb (a device flag, no host sync); ``active`` (a () bool
    device tensor) False returns zeros."""
    _check(a, "a", torch.float32)
    dof = a.shape[0]
    if a.dim() != 2 or a.shape[1] != dof or dof % 6:
        raise ValueError(f"a: expected (6N, 6N), got {tuple(a.shape)}")
    n = dof // 6
    _check(minv, "minv", torch.float32, (n, 6, 6))
    _check(b, "b", torch.float32, (dof,))
    _check(active, "active", torch.bool, ())
    _same_device(a, minv, b, active)
    lib = load()
    x = torch.empty_like(b)
    work = torch.empty((4 * dof + 3,), dtype=torch.float32, device=b.device)
    rc = lib.df_dense_pcg(a.data_ptr(), minv.data_ptr(), b.data_ptr(), n, iters, _f32(rtol * rtol), active.data_ptr(),
                          x.data_ptr(), work.data_ptr(), _stream(b.device))
    _done("dense_pcg", rc)
    return x


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """The direct solve's factor: cuSOLVER's lower Cholesky factor through
    ``torch.linalg.cholesky_ex`` (no host sync), NaN where ``a`` is not
    positive definite, as the JAX package's ``cho_factor`` gives."""
    _check(a, "a", torch.float32)
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a: expected a square matrix, got {tuple(a.shape)}")
    chol, info = torch.linalg.cholesky_ex(a, check_errors=False)
    launches["cholesky"] += 1
    return chol.masked_fill_(info != 0, float("nan"))


# --------------------------------------------------------------------------
# kernel H: node insertion
# --------------------------------------------------------------------------


_INSERT_PLANS: Dict[Tuple[torch.device, int, int, bool], Tuple[int, bool, int]] = {}


def insert_plan(nc: int, cap: int, device_table: bool, dev: torch.device) -> Tuple[int, bool, int]:
    """Kernel H's select table for ``nc`` candidates and ``cap`` slots on
    the card ``dev`` (the library's ``df_insert_plan``): (words, in device
    memory, dynamic shared bytes). The table sits in shared memory while it
    fits, else in a device-memory scratch; ``device_table`` forces the
    scratch."""
    key = (dev, nc, cap, device_table)
    plan = _INSERT_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_int * 3)()
        with _on(dev):
            rc = load().df_insert_plan(nc, cap, int(device_table), ctypes.addressof(out))
        if rc != 0:
            raise ValueError(f"insert_select: no plan for {nc} candidates and {cap} slots (error {rc})")
        plan = _INSERT_PLANS[key] = (out[0], bool(out[1]), out[2])
    return plan


def insert_select(candidates, cand_d2, valid, active, count, gate, coverage: float, device_table: bool = False,
                  kept: Optional[torch.Tensor] = None):
    """Kernel H's select pass (csrc/insert_nodes.cu, one launch): (slots
    (N,) int64, the slot of the r-th new node or N for none; new positions
    (N, 3)). 1 to 65 536 candidates; the decimation's hash table in shared
    memory while it fits, else (or with ``device_table``) in a device
    scratch. ``kept`` (() int32 on the device) receives the number of kept
    candidates (valid, uncovered, first of their cell)."""
    nc = _check_points(candidates, "candidates")
    if not 1 <= nc <= 65536:
        raise ValueError(f"insert_select takes 1 to 65536 candidates, got {nc}")
    _check(cand_d2, "cand_d2", torch.float32, (nc,))
    _check(valid, "valid", torch.bool, (nc,))
    _check(active, "active", torch.bool)
    cap = active.shape[0]
    _check(count, "count", torch.int32, ())
    _check(gate, "gate", torch.bool, ())
    _same_device(candidates, cand_d2, valid, active, count, gate)
    if kept is not None:
        _check(kept, "kept", torch.int32, ())
        _same_device(candidates, kept)
    lib = load()
    dev = candidates.device
    words, in_device, smem = insert_plan(nc, cap, device_table, dev)
    plan = (ctypes.c_int * 3)(words, int(in_device), smem)
    slots = torch.empty((cap,), dtype=torch.int64, device=dev)
    new_pos = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    table = torch.empty((words,), dtype=torch.int64, device=dev) if in_device else None
    with _on(dev):
        rc = lib.df_insert_select(
            candidates.data_ptr(), cand_d2.data_ptr(), valid.data_ptr(), nc, active.data_ptr(), count.data_ptr(),
            gate.data_ptr(), cap, _f32(coverage), _f32(coverage * coverage), ctypes.addressof(plan),
            slots.data_ptr(), new_pos.data_ptr(), None if table is None else table.data_ptr(),
            None if kept is None else kept.data_ptr(), _stream(dev),
        )
    _done("insert_select", rc)
    return slots, new_pos


def insert_apply(positions, dq, radius, active, count, last_support, slots, new_pos, seed_dq, frame_idx, new_radius,
                 reference: bool = False):
    """Kernel H's apply pass: a NEW field with the selected nodes written
    into their slots (old + (new - old)), the r-th new node with the radius
    ``new_radius[r]``, and the count raised; one launch, a thread a slot.
    ``reference`` launches the design before (six copies of the field,
    then one block writing the new nodes in place; no path asks for it)."""
    n = _check_field(positions, active, radius, dq)
    _check(count, "count", torch.int32, ())
    _check(last_support, "last_support", torch.int32, (n,))
    _check(slots, "slots", torch.int64, (n,))
    _check(new_pos, "new_pos", torch.float32, (n, 3))
    _check(seed_dq, "seed_dq", torch.float32, (n, 8))
    _check(frame_idx, "frame_idx", torch.int32, ())
    _check(new_radius, "new_radius", torch.float32, (n,))
    _same_device(positions, dq, radius, active, count, last_support, slots, new_pos, seed_dq, frame_idx, new_radius)
    lib = load()
    old = (positions, dq, radius, active, count, last_support)
    out = [t.clone() if reference else torch.empty_like(t) for t in old]
    ran = ctypes.c_int(0)
    rc = lib.df_insert_apply(
        *(t.data_ptr() for t in old), *(t.data_ptr() for t in out), slots.data_ptr(), new_pos.data_ptr(),
        seed_dq.data_ptr(), frame_idx.data_ptr(), new_radius.data_ptr(), n, int(reference), ctypes.byref(ran),
        _stream(positions.device),
    )
    _done("insert_apply", rc)
    device_kernels["insert_apply"] += ran.value + (len(out) if reference else 0)
    return tuple(out)


# --------------------------------------------------------------------------
# kernel I: the preprocessing stencils
# --------------------------------------------------------------------------


def _check_depth(depth: torch.Tensor, name: str = "depth_mm") -> None:
    _check(depth, name, torch.uint16)
    if depth.dim() != 2:
        raise ValueError(f"{name}: expected (H, W), got {tuple(depth.shape)}")


def depth_dists(depth_mm: torch.Tensor, intr, filtered: Optional[torch.Tensor] = None, max_dist_m: float = 0.0):
    """Kernel I's first entry (csrc/preprocess.cu): (dists (H, W) float32
    ray distance in metres of the raw uint16 mm depth, and, given
    ``filtered``, that image with depth beyond ``max_dist_m`` zeroed, else
    None), one launch."""
    _check_depth(depth_mm)
    if filtered is not None:
        _check(filtered, "filtered", torch.uint16, depth_mm.shape)
        _same_device(depth_mm, filtered)
    lib = load()
    rows, cols = depth_mm.shape
    dists = torch.empty(depth_mm.shape, dtype=torch.float32, device=depth_mm.device)
    trunc = torch.empty_like(filtered) if filtered is not None else None
    rc = lib.df_depth_dists(
        depth_mm.data_ptr(), rows, cols, _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy),
        None if filtered is None else filtered.data_ptr(), _f32(max_dist_m * 1000.0), dists.data_ptr(),
        None if trunc is None else trunc.data_ptr(), _stream(depth_mm.device),
    )
    _done("depth_dists", rc)
    return dists, trunc


def pyramid_down(depth_mm: torch.Tensor, sigma_depth_m: float) -> torch.Tensor:
    """Kernel I's one-level entry: the depth-aware 2x downsample, (H, W) ->
    (H // 2, W // 2) uint16 mm, one launch a level (the design before
    ``depth_pyramid``, which is held bit for bit against it)."""
    _check_depth(depth_mm)
    lib = load()
    h, w = depth_mm.shape
    out = torch.empty((h // 2, w // 2), dtype=torch.uint16, device=depth_mm.device)
    rc = lib.df_pyramid_down(depth_mm.data_ptr(), h, w, _f32(sigma_depth_m * 1000.0 * 3.0), out.data_ptr(),
                             _stream(depth_mm.device))
    _done("pyramid_down", rc)
    return out


PYRAMID_MAX_DOWN = 5  # downsamples a launch of depth_pyramid (csrc/preprocess.cu kPyrMaxDown)


def depth_pyramid(depth_mm: torch.Tensor, levels: int, sigma_depth_m: float) -> list:
    """Kernel I's pyramid entry (csrc/preprocess.cu, one launch): the
    ``levels`` images [depth_mm, down(depth_mm), down(down(depth_mm)), ...]
    of ``pyramid_down``'s depth-aware 2x downsample, each (H_k // 2, W_k //
    2) uint16 mm of the one before, every coarser level written by the
    same launch, bit for bit ``pyramid_down``'s."""
    _check_depth(depth_mm)
    down = levels - 1
    if not 0 <= down <= PYRAMID_MAX_DOWN:
        raise ValueError(f"depth_pyramid takes 1 to {PYRAMID_MAX_DOWN + 1} levels, got {levels}")
    out = [depth_mm]
    for _ in range(down):
        h, w = out[-1].shape
        out.append(torch.empty((h // 2, w // 2), dtype=torch.uint16, device=depth_mm.device))
    if down == 0:
        return out
    lib = load()
    dev = depth_mm.device
    h, w = depth_mm.shape
    ptrs = (ctypes.c_void_p * down)(*(t.data_ptr() for t in out[1:]))
    tile, threads, ran = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)  # the plan's tile and threads
    rc = lib.df_depth_pyramid(depth_mm.data_ptr(), h, w, down, _f32(sigma_depth_m * 1000.0 * 3.0), ptrs,
                              _sm_count(dev), ctypes.byref(tile), ctypes.byref(threads), ctypes.byref(ran),
                              _stream(dev))
    _done("depth_pyramid", rc)
    device_kernels["depth_pyramid"] += ran.value
    return out


def points_normals(depth_mm: torch.Tensor, intr, stride: int = 1, normals: bool = True, conf: bool = False):
    """Kernel I's single-map entry: (points, normals | None, incidence
    confidence | None) of ``depth_mm[::stride, ::stride]``, each (H', W', 3)
    / (H', W') float32, read in place from the full image; a thread a
    pixel, one map a launch (the design before ``frame_maps``, which is
    held bit for bit against it; ``compute_points_normals``' kernel)."""
    _check_depth(depth_mm)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    lib = load()
    rows, cols = depth_mm.shape
    h, w = (rows + stride - 1) // stride, (cols + stride - 1) // stride
    dev = depth_mm.device
    pts = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty((h, w, 3), dtype=torch.float32, device=dev) if normals else None
    cf = torch.empty((h, w), dtype=torch.float32, device=dev) if conf else None
    rc = lib.df_points_normals(
        depth_mm.data_ptr(), h, w, stride, cols, _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy),
        pts.data_ptr(), None if nrm is None else nrm.data_ptr(), None if cf is None else cf.data_ptr(),
        _stream(dev),
    )
    _done("points_normals", rc)
    return pts, nrm, cf


class MapTask(NamedTuple):
    """One map of ``frame_maps``: ``depth[::stride, ::stride]`` (uint16 mm)
    at the intrinsics ``intr``, and which outputs to write."""

    depth: torch.Tensor
    intr: object
    stride: int = 1
    points: bool = True
    normals: bool = True
    conf: bool = False


class _MapTaskArgs(ctypes.Structure):
    """csrc/preprocess.cu's MapTaskArgs."""

    _fields_ = [("depth", _P), ("points", _P), ("normals", _P), ("conf", _P), ("fx", _F), ("fy", _F), ("cx", _F),
                ("cy", _F), ("h", _I), ("w", _I), ("stride", _I), ("src_cols", _I)]


MAP_TASKS = 8  # tasks a launch (csrc/preprocess.cu kMapTasks)


def frame_maps(tasks) -> list:
    """Kernel I's multi-map entry (csrc/preprocess.cu, one launch for up
    to ``MAP_TASKS`` tasks, another for each ``MAP_TASKS`` more): for each
    ``MapTask`` (points | None, normals | None, confidence | None) as
    ``points_normals`` gives them, bit for bit; an output the task does
    not ask for is neither computed into memory nor returned."""
    tasks = list(tasks)
    if not tasks:
        raise ValueError("frame_maps: no task")
    outs, args = [], []
    for j, t in enumerate(tasks):
        _check_depth(t.depth, f"tasks[{j}].depth")
        if t.stride < 1:
            raise ValueError(f"tasks[{j}]: stride must be >= 1, got {t.stride}")
        if not (t.points or t.normals or t.conf):
            raise ValueError(f"tasks[{j}]: asks for no map")
        rows, cols = t.depth.shape
        h, w = (rows + t.stride - 1) // t.stride, (cols + t.stride - 1) // t.stride
        dev = t.depth.device
        pts = torch.empty((h, w, 3), dtype=torch.float32, device=dev) if t.points else None
        nrm = torch.empty((h, w, 3), dtype=torch.float32, device=dev) if t.normals else None
        cf = torch.empty((h, w), dtype=torch.float32, device=dev) if t.conf else None
        outs.append((pts, nrm, cf))
        args.append(_MapTaskArgs(
            t.depth.data_ptr(), *(None if o is None else o.data_ptr() for o in (pts, nrm, cf)),
            _f32(t.intr.fx), _f32(t.intr.fy), _f32(t.intr.cx), _f32(t.intr.cy), h, w, t.stride, cols,
        ))
    _same_device(*(t.depth for t in tasks))
    lib = load()
    dev = tasks[0].depth.device
    for j in range(0, len(args), MAP_TASKS):
        chunk = args[j:j + MAP_TASKS]
        ran = ctypes.c_int(0)
        rc = lib.df_frame_maps((_MapTaskArgs * len(chunk))(*chunk), len(chunk), ctypes.byref(ran), _stream(dev))
        _done("frame_maps", rc)
        device_kernels["frame_maps"] += ran.value
    return outs


def resize_maps(points: torch.Tensor, normals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel I: the 2x2 mean of (H, W, 3) point and normal maps, valid only
    where all four points are."""
    _check(points, "points", torch.float32)
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: expected (H, W, 3), got {tuple(points.shape)}")
    _check(normals, "normals", torch.float32, points.shape)
    _same_device(points, normals)
    lib = load()
    h, w = points.shape[:2]
    op = torch.empty((h // 2, w // 2, 3), dtype=torch.float32, device=points.device)
    on = torch.empty_like(op)
    rc = lib.df_resize_maps(points.data_ptr(), normals.data_ptr(), h, w, op.data_ptr(), on.data_ptr(),
                            _stream(points.device))
    _done("resize_maps", rc)
    return op, on


# --------------------------------------------------------------------------
# kernel J: march band and seed
# --------------------------------------------------------------------------


def march_bands(dists: torch.Tensor, stride: int, prev_points: Optional[torch.Tensor], margin: float, seed: bool,
                reference: bool = False):
    """Kernel J (csrc/bands.cu): from ``dists[::stride, ::stride]`` and the
    previous (H', W', 3) model map, the raycast seed (None without
    ``seed``) and the temporal band (lo, hi) (None without
    ``prev_points``), one launch: 16x8 tiles with their sources staged in
    shared memory, or with ``reference`` the thread-a-pixel kernel before
    it (bit for bit the same)."""
    _check(dists, "dists", torch.float32)
    if dists.dim() != 2:
        raise ValueError(f"dists: expected (H, W), got {tuple(dists.shape)}")
    rows, cols = (dists.shape[0] + stride - 1) // stride, (dists.shape[1] + stride - 1) // stride
    if prev_points is not None:
        _check(prev_points, "prev_points", torch.float32, (rows, cols, 3))
        _same_device(dists, prev_points)
    if prev_points is None and not seed:
        raise ValueError("march_bands: nothing to compute")
    lib = load()
    dev = dists.device
    lo = torch.empty((rows, cols), dtype=torch.float32, device=dev) if prev_points is not None else None
    hi = torch.empty_like(lo) if lo is not None else None
    sd = torch.empty((rows, cols), dtype=torch.float32, device=dev) if seed else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.df_march_bands(dists.data_ptr(), dists.shape[1], stride, rows, cols, ptr(prev_points), _f32(margin),
                            ptr(lo), ptr(hi), ptr(sd), int(reference), _stream(dev))
    _done("march_bands", rc)
    return sd, (None if lo is None else (lo, hi))


def coarse_band(points_c: torch.Tensor, factor: int, margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel J's coarse-band entry (csrc/bands.cu): from the (Hc, Wc, 3)
    camera-frame hits of the coarse march, the fine (Hc f, Wc f) march band
    (lo, hi): [min - m, max + m] of |p| over each coarse cell's 3x3 window,
    (0, 0) where none of it hit, one launch."""
    _check(points_c, "points_c", torch.float32)
    if points_c.dim() != 3 or points_c.shape[-1] != 3:
        raise ValueError(f"points_c: expected (Hc, Wc, 3), got {tuple(points_c.shape)}")
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    lib = load()
    rows_c, cols_c = points_c.shape[:2]
    dev = points_c.device
    lo = torch.empty((rows_c * factor, cols_c * factor), dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    rc = lib.df_coarse_band(points_c.data_ptr(), rows_c, cols_c, factor, _f32(margin), lo.data_ptr(), hi.data_ptr(),
                            _stream(dev))
    _done("coarse_band", rc)
    return lo, hi


# --------------------------------------------------------------------------
# kernel K: brick classification and work list
# --------------------------------------------------------------------------


def brick_plan(
    dists: torch.Tensor,
    cam_grid: torch.Tensor,
    brick: int,
    stride: int,
    intr,
    rect: int,
    trunc: float,
    zeps: float,
    levels: int,
    perm: torch.Tensor,
    band_cap: int,
    wide_cap: int,
    phase: Optional[torch.Tensor] = None,
    split: int = 1,
    x_brick0: int = 0,
    ok: Optional[torch.Tensor] = None,
    one_block: bool = False,
):
    """Kernel K (csrc/classify.cu, two launches: the mip tiles, then one
    thread-block cluster): the min/max/all-valid mip of ``dists``
    (``levels`` levels, concatenated), every brick's class, window origin
    and surface flag (bricks outside the x-plane ``phase`` mod ``split``
    skipped) and the work list. Returns ((dmin, dmax, allvalid), (cls
    (NBR,) int64, u0, v0 (NBR,) int32, surf (NBR,) bool), (ids, kind
    (NBR,) int32, count (1,) int32, counts (3,) int32)). Slab mode:
    ``cam_grid`` a (nbx w + 1, G, G, 3) x-slab of corner points whose first
    brick x-plane is the global plane ``x_brick0`` (the phase test's), NBR
    = nbx (G - 1)² / w² local bricks. ``ok`` (a () bool on the card) gates
    the plan: where it is False both launches return at once and only
    ``count`` (0) and ``counts`` (0, 0, 0) are written. ``one_block``
    launches the design before (one block after the tiles), the reference
    the cluster is held against bit for bit."""
    _check(dists, "dists", torch.float32)
    if dists.dim() != 2:
        raise ValueError(f"dists: expected (H, W), got {tuple(dists.shape)}")
    _check(cam_grid, "cam_grid", torch.float32)
    gx, gp = cam_grid.shape[0], cam_grid.shape[1]
    w = brick // stride if stride and brick % stride == 0 else 0
    if (cam_grid.dim() != 4 or cam_grid.shape != (gx, gp, gp, 3) or not w or (gp - 1) % w or (gx - 1) % w
            or gx < w + 1):
        raise ValueError(f"cam_grid: bad grid {tuple(cam_grid.shape)} for brick {brick}, stride {stride}")
    nb = (gp - 1) // w
    nbx = (gx - 1) // w
    nbr = nbx * nb * nb
    _check(perm, "perm", torch.int64, (nbr,))
    if phase is not None:
        _check(phase, "phase", torch.int32, ())
    elif split > 1:
        raise ValueError("a phase split needs the phase")
    if ok is not None:
        _check(ok, "ok", torch.bool, ())
    _same_device(dists, cam_grid, perm, *(t for t in (phase, ok) if t is not None))
    lib = load()
    dev = dists.device
    rows, cols = dists.shape
    total, h, wd = 0, rows, cols
    for _ in range(levels):
        total += h * wd
        h, wd = (h + 1) // 2, (wd + 1) // 2
    pyr = torch.empty((3, total), dtype=torch.float32, device=dev)
    cls = torch.empty((nbr,), dtype=torch.int64, device=dev)
    uv = torch.empty((2, nbr), dtype=torch.int32, device=dev)
    surf = torch.empty((nbr,), dtype=torch.bool, device=dev)
    work = torch.empty((2 * nbr + 4,), dtype=torch.int32, device=dev)
    ids, kind, count, counts = work[:nbr], work[nbr : 2 * nbr], work[2 * nbr : 2 * nbr + 1], work[2 * nbr + 1 :]
    ran = ctypes.c_int(0)
    rc = lib.df_brick_plan(
        dists.data_ptr(), rows, cols, levels, pyr[0].data_ptr(), pyr[1].data_ptr(), pyr[2].data_ptr(),
        cam_grid.data_ptr(), gp, w, nb, nbx, x_brick0, _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy),
        rect, _f32(trunc), _f32(zeps), None if phase is None else phase.data_ptr(), split, perm.data_ptr(),
        band_cap, wide_cap, cls.data_ptr(), uv[0].data_ptr(), uv[1].data_ptr(), surf.data_ptr(),
        ids.data_ptr(), kind.data_ptr(), count.data_ptr(), counts.data_ptr(),
        None if ok is None else ok.data_ptr(), int(one_block), ctypes.byref(ran), _stream(dev),
    )
    _done("brick_plan", rc)
    device_kernels["brick_plan"] += ran.value
    return (pyr[0], pyr[1], pyr[2]), (cls, uv[0], uv[1], surf), (ids, kind, count, counts)


# --------------------------------------------------------------------------
# kernel L: frame 0's surface extraction and node sampling
# --------------------------------------------------------------------------

_TILE = 16 * 256  # crossing tests per tile of csrc/extract.cu's reference mode
# csrc/extract.cu's row listing: (i, j) rows a block, and the volume sides
# it is compiled for (32 lanes of d / 32 voxels a row)
EXTRACT_ROWS = 64
EXTRACT_SIDES = (32, 64, 128, 256, 512)


def weight_code_min(min_weight: float) -> int:
    """The least u16 weight code whose decoded weight (code / 512, exact)
    is at least ``min_weight`` as float32; 65536 where none is (or NaN)."""
    scaled = _f32(min_weight) * volume_model.WEIGHT_SCALE  # exact in float64
    if not scaled <= 65535.0:
        return 65536
    return math.ceil(max(scaled, 0.0))


def extract_rows_mode(tsdf: torch.Tensor, weight: torch.Tensor, reference: bool = False) -> bool:
    """Whether ``extract_cloud`` launches the row listing on this volume
    (else its reference mode): a side in ``EXTRACT_SIDES`` and both
    volumes 16-byte aligned."""
    return (not reference and tsdf.shape[0] in EXTRACT_SIDES and tsdf.data_ptr() % 16 == 0
            and weight.data_ptr() % 16 == 0)


def extract_cloud(tsdf: torch.Tensor, weight: torch.Tensor, min_weight: float, max_points: int, voxel_size: float,
                  origin, reference: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel L (csrc/extract.cu, two launches): the +x/+y/+z zero
    crossings of a (D, D, D) volume (the tsdf as i16 codes, float32 or
    bfloat16, the weight as u16 codes or float32) where both voxels weigh
    at least ``min_weight``, in the JAX order (axis-major, raster order
    within an axis), a warp a voxel row. Returns (points (max_points, 3)
    world frame, NaN past the count; valid (max_points,) bool; count ()
    int32, uncapped). The side is a multiple of 32, as the config makes
    every volume's (no caller in the port passes another). ``reference``
    launches the design before (four launches over tiles of the
    concatenated tests), which is also the path of a side outside
    ``EXTRACT_SIDES`` (the presets' 64, 256 and 512 are in it) and of a
    volume not 16-byte aligned (``extract_rows_mode``); the two are
    bit-equal."""
    d, storage = _check_cube(tsdf, weight)
    if d == 0 or d % 32:
        raise ValueError(f"tsdf: a side of {d}: the row listing takes a multiple of 32")
    if 3 * (d - 1) * d * d >= 2 ** 31:
        raise ValueError(f"tsdf: {d}^3 is past the kernel's int32 crossing count")
    if not 1 <= max_points < 2 ** 31 // 3:
        raise ValueError(f"max_points must be in [1, 2^31 / 3), got {max_points}")
    lib = load()
    dev = tsdf.device
    rows = extract_rows_mode(tsdf, weight, reference)
    masks = None
    if rows:
        nblocks = d * d // EXTRACT_ROWS
        scratch = torch.empty((6 * nblocks,), dtype=torch.int32, device=dev)
        counts, offsets = scratch[: 3 * nblocks], scratch[3 * nblocks :]
        # each row's crossing bits: a byte a lane and axis, two at 512
        masks = torch.empty((3 * d * d * 32 * (1 if d <= 256 else 2),), dtype=torch.uint8, device=dev)
    else:
        nblocks = (3 * (d - 1) * d * d + _TILE - 1) // _TILE
        scratch = torch.empty((2 * nblocks,), dtype=torch.int32, device=dev)
        counts, offsets = scratch[:nblocks], scratch[nblocks:]
    points = torch.empty((max_points, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((max_points,), dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    ran = ctypes.c_int(0)
    rc = lib.df_extract_cloud(
        tsdf.data_ptr(), weight.data_ptr(), storage, d, _decode_scale(tsdf), _f32(min_weight),
        weight_code_min(min_weight), max_points, _f32(voxel_size), *(_f32(v) for v in origin), counts.data_ptr(),
        offsets.data_ptr(), nblocks, None if masks is None else masks.data_ptr(),
        _ticket(dev).data_ptr() if rows else None, int(not rows), points.data_ptr(), valid.data_ptr(),
        count.data_ptr(), ctypes.byref(ran), _stream(dev),
    )
    _done("extract_cloud", rc)
    device_kernels["extract_cloud"] += ran.value
    return points, valid, count


def extract_normals(tsdf: torch.Tensor, points: torch.Tensor, voxel_size: float, origin, delta: float) -> torch.Tensor:
    """Kernel R (csrc/normals.cu): at each world-frame row of ``points``
    (N, 3), the six-sample central difference of the (D, D, D) volume's
    trilinear TSDF (stored as i16 codes, float32 or bfloat16) at +-``delta`` voxels, divided by max(|g|,
    1e-12); NaN rows (and rows whose samples leave the volume) give NaN.
    Returns (N, 3) float32."""
    d, storage = _check_cube(tsdf)
    if d < 2:
        raise ValueError(f"tsdf: expected a (D, D, D) volume, got {tuple(tsdf.shape)}")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points: expected (N, 3), got {tuple(points.shape)}")
    _check(points, "points", torch.float32)
    _same_device(tsdf, points)
    n = points.shape[0]
    if n >= 2 ** 31 // 3:
        raise ValueError(f"points: {n} rows is past the kernel's int32 index")
    lib = load()
    dev = tsdf.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rc = lib.df_extract_normals(
        tsdf.data_ptr(), storage, d, _decode_scale(tsdf), points.data_ptr(), n, *(_f32(v) for v in origin),
        _f32(voxel_size), _f32(delta), out.data_ptr(), _stream(dev),
    )
    _done("extract_normals", rc)
    return out


def sample_nodes(points: torch.Tensor, valid: torch.Tensor, step: int, perm: torch.Tensor, max_nodes: int):
    """Kernel L's node sampling, one block: of the candidates
    ``points[::step]`` in the order ``perm``, the first ``max_nodes``
    valid ones. Returns (positions (max_nodes, 3), 0 past the count;
    active (max_nodes,) bool; count () int32)."""
    m = _check_points(points, "points")
    _check(valid, "valid", torch.bool, (m,))
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    mc = (m + step - 1) // step
    _check(perm, "perm", torch.int64, (mc,))
    _same_device(points, valid, perm)
    lib = load()
    dev = points.device
    pos = torch.empty((max_nodes, 3), dtype=torch.float32, device=dev)
    active = torch.empty((max_nodes,), dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    rc = lib.df_sample_nodes(
        points.data_ptr(), valid.data_ptr(), step, perm.data_ptr(), mc, max_nodes, pos.data_ptr(),
        active.data_ptr(), count.data_ptr(), _stream(dev),
    )
    _done("sample_nodes", rc)
    return pos, active, count


# --------------------------------------------------------------------------
# kernel M: the aperture gate of the tangential data term
# --------------------------------------------------------------------------

_GATE_PLAN: list = []


def p2p_gate_plan() -> Tuple[int, int, int]:
    """(the most rows, the widest window, the strip of columns) of kernel
    M's cluster design, from the library (csrc/p2p_gate.cu)."""
    if not _GATE_PLAN:
        vals = [ctypes.c_int(0) for _ in range(3)]
        rc = load().df_p2p_gate_plan(*(ctypes.byref(v) for v in vals))
        if rc != 0:
            raise RuntimeError(f"df_p2p_gate_plan failed: error {rc}")
        _GATE_PLAN.extend(v.value for v in vals)
    return tuple(_GATE_PLAN)


def p2p_gate_cluster(rows: int, window: int, reference: bool = False) -> bool:
    """Whether ``p2p_gate`` launches its cluster design on (rows, window)
    (else its reference mode): at most ``p2p_gate_plan()``'s rows (its
    shared memory grows with them) and window."""
    max_rows, max_window, _ = p2p_gate_plan()
    return not reference and rows <= max_rows and window <= max_window


def p2p_gate(live_pts_w, live_nrm_w, prev_model_w, cam_z, window: int, cond0: float, fit0: float, gain: float,
             z_lo: float, bin_width: float, n_bins: int, n_channels: int, reg: float, min_count: float,
             reference: bool = False):
    """Kernel M (csrc/p2p_gate.cu, two launches): the adaptive aperture
    gate of (H, W, 3) live points, live normals and previous model points
    (world frame) and the (H, W) live depth, over a ``window`` x ``window``
    box restricted to the depth bin and its neighbours: ``n_bins`` bins of
    ``bin_width`` from ``z_lo``, ``n_channels`` features a pixel (the
    kernel's own layout, checked), the second moment's ridge ``reg`` per
    sample, no gate below ``min_count`` samples. The caller owns these
    constants (``pipeline/kinfu``). Returns (gate (H, W) float32, depth
    bins (H, W) int32). The features, then clusters of 11 CTAs (one a
    channel) a strip of columns; ``reference`` launches the design before
    (a block a row writing a 16 x 11-channel buffer of horizontal sums,
    then a thread a pixel), which is also the path of more rows or a wider
    window than the cluster takes (``p2p_gate_cluster``); the two are
    bit-equal."""
    _check(cam_z, "cam_z", torch.float32)
    if cam_z.dim() != 2:
        raise ValueError(f"cam_z: expected (H, W), got {tuple(cam_z.shape)}")
    rows, cols = cam_z.shape
    for t, nm in ((live_pts_w, "live_pts_w"), (live_nrm_w, "live_nrm_w"), (prev_model_w, "prev_model_w")):
        _check(t, nm, torch.float32, (rows, cols, 3))
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _same_device(live_pts_w, live_nrm_w, prev_model_w, cam_z)
    lib = load()
    cluster = p2p_gate_cluster(rows, window, reference)
    if not cluster and cols * (n_channels + 1) * 4 > 227 * 1024:
        raise ValueError(f"cam_z: {cols} columns are past the reference mode's shared-memory row")
    dev = cam_z.device
    gate = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    bins = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    # the cluster design's features and bin codes, or the reference mode's
    # horizontal sums
    words = n_channels * rows * cols + (rows * cols + 3) // 4 if cluster else n_bins * n_channels * rows * cols
    scratch = torch.empty((words,), dtype=torch.float32, device=dev)
    lo = (window - 1) // 2
    ran = ctypes.c_int(0)
    rc = lib.df_p2p_gate(
        live_pts_w.data_ptr(), live_nrm_w.data_ptr(), prev_model_w.data_ptr(), cam_z.data_ptr(), rows, cols,
        lo, window - 1 - lo, n_bins, n_channels, _f32(z_lo), _f32(bin_width), _f32(reg), _f32(cond0), _f32(fit0),
        _f32(max(1.0 - fit0, 1e-6)), _f32(gain), _f32(min_count), bins.data_ptr(), scratch.data_ptr(),
        gate.data_ptr(), int(not cluster), ctypes.byref(ran), _stream(dev),
    )
    _done("p2p_gate", rc)
    device_kernels["p2p_gate"] += ran.value
    return gate, bins


# --------------------------------------------------------------------------
# kernel Q: the net rigid removal
# --------------------------------------------------------------------------


def net_rigid(positions, prev_dq, prev_active, new_dq, new_active, alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel Q (csrc/net_rigid.cu, one launch): (the new transforms (N, 8)
    with the net rigid motion between the pre-solve (``prev_dq``) and the
    post-solve (``new_dq``) live node positions removed from every node
    active in ``new_active``, the removed G⁻¹ blended toward the identity
    by ``alpha`` (8,)); the weights are ``prev_active``; nothing changes
    unless at least three nodes weigh and all is finite."""
    n = _check_field(positions, prev_active, None, prev_dq)
    _check(new_dq, "new_dq", torch.float32, (n, 8))
    _check(new_active, "new_active", torch.bool, (n,))
    _same_device(positions, prev_dq, prev_active, new_dq, new_active)
    lib = load()
    out = torch.empty_like(new_dq)
    g = torch.empty((8,), dtype=torch.float32, device=new_dq.device)
    rc = lib.df_net_rigid(positions.data_ptr(), prev_dq.data_ptr(), prev_active.data_ptr(), new_dq.data_ptr(),
                          new_active.data_ptr(), n, _f32(alpha), _f32(1.0 - alpha), out.data_ptr(), g.data_ptr(),
                          _stream(new_dq.device))
    _done("net_rigid", rc)
    return out, g
