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

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("bilateral.cu", "icp_reduce.cu", "raycast.cu", "fuse_bricks.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels repeat the plain versions' arithmetic
    # operation for operation, so that each rounds the same way
    "-fmad=false",
    "-Xcompiler", "-fPIC",
)

KERNELS = ("bilateral", "icp_reduce", "raycast", "fuse_bricks")
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "df_bilateral": (_P, _P, _I, _I, _I, _D, _F, _P),
    "df_icp_reduce": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P),
    "df_raycast": (_P, _I, _P, _P, _P, _P, _I, _F, _F, _I, _I, _F, _P, _P, _P, _P),
    "df_fuse_bricks": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _F, _F, _F, _P,
    ),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def _done(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    launches[name] += 1


def _f32(x: float) -> float:
    """x as the float32 that a PyTorch op on float32 tensors would use."""
    return float(np.float32(x))


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def bilateral_filter(
    depth_mm: torch.Tensor, kernel_size: int, sigma_spatial: float, sigma_depth_m: float
) -> torch.Tensor:
    """Kernel A (csrc/bilateral.cu): (H, W) uint16 mm -> (H, W) uint16 mm."""
    _check(depth_mm, "depth_mm", torch.uint16)
    if depth_mm.dim() != 2:
        raise ValueError(f"depth_mm: expected (H, W), got {tuple(depth_mm.shape)}")
    lib = load()
    rows, cols = depth_mm.shape
    out = torch.empty_like(depth_mm)
    sigma_depth_mm = sigma_depth_m * 1000.0
    rc = lib.df_bilateral(
        depth_mm.data_ptr(), out.data_ptr(), rows, cols, kernel_size // 2,
        0.5 / (sigma_spatial * sigma_spatial), _f32(0.5 / (sigma_depth_mm * sigma_depth_mm)),
        _stream(depth_mm.device),
    )
    _done("bilateral", rc)
    return out


_SYM = None


def _sym_index(dev: torch.device) -> torch.Tensor:
    """(36,) index from a full 6x6 into the 21 packed upper-triangle sums."""
    global _SYM
    if _SYM is None or _SYM.device != dev:
        k = np.zeros((6, 6), np.int64)
        n = 0
        for i in range(6):
            for j in range(i, 6):
                k[i, j] = k[j, i] = n
                n += 1
        _SYM = torch.from_numpy(k.reshape(-1)).to(dev)
    return _SYM


def icp_build_system(
    intr, t_cur, curr_pts, curr_nrm, prev_pts, prev_nrm, dist2_thres, min_cosine, active=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B (csrc/icp_reduce.cu): the 6x6 ICP normal equations (A, b).
    ``active`` (() bool on the device) False makes both passes skip their
    work and return zeros."""
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
    out = torch.empty((27,), dtype=torch.float32, device=dev)
    rc = lib.df_icp_reduce(
        t_cur.data_ptr(), curr_pts.data_ptr(), curr_nrm.data_ptr(), prev_pts.data_ptr(),
        prev_nrm.data_ptr(), active.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, rows, cols, nblocks,
        _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy),
        _f32(dist2_thres), _f32(min_cosine), _stream(dev),
    )
    _done("icp_reduce", rc)
    return out[_sym_index(dev)].reshape(6, 6), out[21:]


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C (csrc/raycast.cu): per-ray march + secant/Newton refine on
    an int16 volume. Returns (found, vertex_vol, normal_vol); rays that
    found nothing carry NaN vertex and normal."""
    if tsdf.dim() != 3 or len(set(tsdf.shape)) != 1:
        raise ValueError(f"tsdf: expected a (D, D, D) volume, got {tuple(tsdf.shape)}")
    _check(tsdf, "tsdf", torch.int16)
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
    rc = lib.df_raycast(
        tsdf.data_ptr(), tsdf.shape[0], ray_org.data_ptr(), dirs.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), tmin.numel(),
        _f32(1.0 / voxel_size), _f32(step), max_steps, int(adaptive),
        _f32(1.0 / 32767.0), found.data_ptr(), vertex.data_ptr(), normal.data_ptr(),
        _stream(dev),
    )
    _done("raycast", rc)
    return found, vertex, normal


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
) -> None:
    """Kernel D (csrc/fuse_bricks.cu): front/band/wide brick updates IN
    PLACE on the int16 tsdf and uint16 weight volumes, one block per work
    slot; slots at or past ``count[0]`` and every slot when ``ok`` is False
    do nothing."""
    d = tsdf.shape[0]
    if tsdf.dim() != 3 or len(set(tsdf.shape)) != 1 or d % brick or brick % stride:
        raise ValueError(f"tsdf: bad volume {tuple(tsdf.shape)} for brick {brick}, stride {stride}")
    nbr = (d // brick) ** 3
    gp = d // stride + 1
    _check(tsdf, "tsdf", torch.int16)
    _check(weight, "weight", torch.uint16, tsdf.shape)
    _check(dists, "dists", torch.float32)
    if dists.dim() != 2:
        raise ValueError(f"dists: expected (H, W), got {tuple(dists.shape)}")
    _check(cam_grid, "cam_grid", torch.float32, (gp, gp, gp, 3))
    _check(ids, "ids", torch.int32, (nbr,))
    _check(kind, "kind", torch.int32, (nbr,))
    _check(count, "count", torch.int32, (1,))
    _check(ok, "ok", torch.bool, ())
    _check(u0, "u0", torch.int32, (nbr,))
    _check(v0, "v0", torch.int32, (nbr,))
    _same_device(tsdf, weight, dists, cam_grid, ids, kind, count, ok, u0, v0)
    lib = load()
    rows, cols = dists.shape
    rc = lib.df_fuse_bricks(
        tsdf.data_ptr(), weight.data_ptr(), dists.data_ptr(), cam_grid.data_ptr(),
        ids.data_ptr(), kind.data_ptr(), count.data_ptr(), ok.data_ptr(),
        u0.data_ptr(), v0.data_ptr(),
        d, brick, stride, rows, cols, nbr,
        _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy), rect,
        _f32(trunc), _f32(max_weight), _f32(1.0 / 32767.0), _stream(tsdf.device),
    )
    _done("fuse_bricks", rc)
