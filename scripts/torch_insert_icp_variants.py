"""Kernels H and B's design choices timed on the card.

Kernel H's select (``csrc/insert_nodes.cu``, entry ``df_insert_select``):
the kernel (its hash table in shared memory where it fits), the same with
the table in device memory (``device_table``), a 512-thread block
(``block512``), and with ``--parent DIR`` that tree's kernel; beside the
library route (``chip_smoke.library_insert_select``: a stable sort,
``topk``, ``nonzero``) and the plain select. Shapes: the preset's
insertion (``default_dynamicfusion()`` after three frames of the deforming
scene, the next frame's 4 800 candidates shifted by 3 cm into the field
with half its slots free, as ``chip_smoke.py`` phase 2) and
``reference_parity()``'s (its frame-0 field with half its slots free,
frame 1's 19 200 candidates). Each launch is held bit for bit against the
plain select; k (the kept candidates) is printed.

Kernel B (``csrc/icp_reduce.cu``, entry ``df_icp_reduce``): the one launch
(the last block to finish sums the partials), its two-pass mode, one
thread-block cluster of 8 or 16 blocks that sums every group of 256 pixels
and whose first block then finishes (``cluster8``, ``cluster16``; built
from the kernel's source with that kernel added), and the finishing
block's stage of 32 or 128 groups (the kernel: 256); beside
``chip_smoke.library_icp`` (the plain rows and one ``torch.mm``) and the
plain system. Shapes: the preset's tracking level (160x120 against the
preset's model maps) and 640x480 (a frame's level 0 against the previous
frame's, the depth ICP's). Each variant is held bit for bit against the
kernel.

    python3 scripts/torch_insert_icp_variants.py [--rounds 3] [--parent DIR]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the sources: edit both
together). Times by ``chip_smoke.cuda_ms`` (CUDA events, 20 calls); the
variants take turns, ``--rounds`` times. Prints the card, each round's
times and a JSON line of the medians.
"""

import argparse
import ctypes
import json
import math
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

_ENTRY = 'extern "C" int df_icp_reduce('
# a cluster of C blocks walks the groups, then its first block finishes
CLUSTER = r'''
#include <cooperative_groups.h>

template <int C>
__global__ void __launch_bounds__(kThreads)
icp_cluster_kernel(Args a, const bool* __restrict__ active, float* __restrict__ partial, float* __restrict__ out,
                   int nblocks) {
  if (!*active) {
    if (blockIdx.x == 0) {
      for (int e = threadIdx.x; e < kOut; e += blockDim.x) out[e] = 0.0f;
    }
    return;
  }
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  for (int g = static_cast<int>(cl.block_rank()); g < nblocks; g += C)
    group_sums(a, g, partial + static_cast<size_t>(g) * kSums);
  __threadfence();
  cl.sync();
  if (cl.block_rank() == 0) ordered_finish(partial, nblocks, out);
}

extern "C" int df_icp_reduce_cluster(const void* T, const void* cp, const void* cn, const void* pp,
                                     const void* pn, const void* active, void* partial, void* ticket, void* out,
                                     int n, int rows, int cols, int nblocks, float fx, float fy, float cx,
                                     float cy, float dist2_thres, float min_cos, int csize, void* stream) {
  const Args a{static_cast<const float*>(T), static_cast<const float*>(cp), static_cast<const float*>(cn),
               static_cast<const float*>(pp), static_cast<const float*>(pn), n, rows, cols,
               fx, fy, cx, cy, dist2_thres, min_cos};
  auto fn = csize == 16 ? icp_cluster_kernel<16> : icp_cluster_kernel<8>;
  if (csize == 16) {
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fn, a, static_cast<const bool*>(active),
                                             static_cast<float*>(partial), static_cast<float*>(out), nblocks));
}

'''
_STAGE = "constexpr int kStage = 256;"
# (file, anchor, replacement): each anchor must occur once in its source
H_VARIANTS = {
    "kernel": [],
    "block512": [("insert_nodes.cu", "constexpr int kBlock = 1024;", "constexpr int kBlock = 512;")],
}
B_VARIANTS = {
    "kernel": [],
    "cluster": [("icp_reduce.cu", _ENTRY, CLUSTER + _ENTRY)],
    "stage32": [("icp_reduce.cu", _STAGE, "constexpr int kStage = 32;")],
    "stage128": [("icp_reduce.cu", _STAGE, "constexpr int kStage = 128;")],
}
# the parent's select: (cand, d2, valid, nc, np2, active, count, gate, cap, cov, cov2, slots, new_pos, gkeys, stream)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SELECT = (_P, _P, _P, _I, _I, _P, _P, _P, _I, _F, _F, _P, _P, _P, _P)
CLUSTER_ENTRY = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P)


def half_free(torch, field):
    """The field with every odd slot freed (``chip_smoke.hold_insert``'s)."""
    act = field.active & (torch.arange(field.active.shape[0], device=field.active.device) % 2 == 0)
    return field._replace(active=act, count=act.sum(dtype=torch.int32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant")
    ap.add_argument("--parent", default=None, help="a tree whose kernel H to time beside the variants")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_insert_icp_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE / "scripts"))
    import chip_smoke as cs
    from torch_data_term_variants import build, median, turns
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import preprocess
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import icp

    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="insert_icp_variants_"))
    procs = {f"H {name}": build(kernels, name, "insert_nodes.cu", subs, tmp) for name, subs in H_VARIANTS.items()}
    procs.update({f"B {name}": build(kernels, name, "icp_reduce.cu", subs, tmp) for name, subs in B_VARIANTS.items()})
    if args.parent:
        procs["H parent"] = build(kernels, "parent", "insert_nodes.cu", [], tmp,
                                  csrc=Path(args.parent).resolve() / "dynamicfusion_tpu_torch" / "csrc")
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[ptxas] {name}: " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(str(so))
        for entry, sig in (("df_insert_select", PARENT_SELECT if name == "H parent" else None),
                           ("df_insert_plan", None), ("df_icp_reduce", None), ("df_icp_reduce_cluster", CLUSTER_ENTRY)):
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.argtypes = list(sig or kernels._SIGNATURES[entry])
                fn.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = {}

    def rc_ok(name, rc):
        if rc:
            raise RuntimeError(f"{name} failed to launch: error {rc}")

    # ------------------------------------------------------------------ H
    cfg = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 5)
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[3]).to(dev))
    cand = (tr.inputs.p_can[:: cfg.node_insert_stride] + 0.03).contiguous()
    shapes = {"preset": (cfg, half_free(torch, st.warp), cand)}
    pcfg = DynamicFusionConfig.reference_parity()
    pdf = kinfu.DynamicFusion(pcfg, device=dev)
    pdf(depths[0])
    ptr_ = kinfu.track(pcfg, pdf.state, torch.from_numpy(depths[1]).to(dev))
    shapes["parity"] = (pcfg, half_free(torch, pdf.state.warp), ptr_.inputs.p_can[:: pcfg.node_insert_stride].contiguous())
    for sname, (c, field, q) in shapes.items():
        valid = ~torch.isnan(q[:, 0])
        d2, _ = warpfield.mutual_nearest(field, q, valid)
        cap, nc = field.active.shape[0], q.shape[0]
        gate = field.count < cap
        ref = warpfield._insert_select_plain(c, field, q, valid, d2, gate)
        kept = torch.zeros((), dtype=torch.int32, device=dev)
        cov, cov2 = kernels._f32(c.node_coverage), kernels._f32(c.node_coverage ** 2)
        calls = {}
        for name, lib in libs.items():
            if not name.startswith("H "):
                continue
            short = name[2:]
            slots = torch.empty((cap,), dtype=torch.int64, device=dev)
            new_pos = torch.empty((cap, 3), device=dev)
            if short == "parent":
                np2 = max(1024, 1 << (nc - 1).bit_length())
                gk = torch.empty((np2,), dtype=torch.int64, device=dev) if np2 > 16384 else None
                def call(lib=lib, slots=slots, new_pos=new_pos, np2=np2, gk=gk):
                    rc_ok("parent select", lib.df_insert_select(
                        q.data_ptr(), d2.data_ptr(), valid.data_ptr(), nc, np2, field.active.data_ptr(),
                        field.count.data_ptr(), gate.data_ptr(), cap, cov, cov2, slots.data_ptr(), new_pos.data_ptr(),
                        None if gk is None else gk.data_ptr(), stream))
                variants = {short: call}
            else:
                variants = {}
                for dt in (False, True):
                    plan = (ctypes.c_int * 3)()
                    rc_ok("plan", lib.df_insert_plan(nc, cap, int(dt), ctypes.addressof(plan)))
                    table = torch.empty((plan[0],), dtype=torch.int64, device=dev) if plan[1] else None
                    def call(lib=lib, slots=slots, new_pos=new_pos, plan=plan, table=table):
                        rc_ok("select", lib.df_insert_select(
                            q.data_ptr(), d2.data_ptr(), valid.data_ptr(), nc, field.active.data_ptr(),
                            field.count.data_ptr(), gate.data_ptr(), cap, cov, cov2, ctypes.addressof(plan),
                            slots.data_ptr(), new_pos.data_ptr(), None if table is None else table.data_ptr(),
                            kept.data_ptr(), stream))
                    variants[f"{short} {'device' if plan[1] else 'shared'} table"] = call
            for vname, call in variants.items():
                call()
                if not (torch.equal(slots, ref.slots) and cs.same_bits(torch, new_pos, ref.new_pos)):
                    print(f"H {sname}: {vname} differs from the plain select", file=sys.stderr)
                    return 1
                calls[vname] = call
        calls["library"] = lambda: cs.library_insert_select(torch, c, field, q, valid, d2, gate)
        calls["plain"] = lambda: warpfield._insert_select_plain(c, field, q, valid, d2, gate)
        rounds = turns(cs, torch, calls, args.rounds)
        times[f"H {sname}"] = {name: median(v) for name, v in rounds.items()}
        print(f"[time] {card} | H {sname} ({nc} candidates, k = {int(kept)} kept, {cap} slots, "
              f"{cap - int(field.count)} free): " + ", ".join(
                  f"{name} {median(v):.4f} ms ({' '.join(f'{t:.4f}' for t in v)})" for name, v in rounds.items()),
              flush=True)

    # ------------------------------------------------------------------ B
    _, pts, nrm, _ = preprocess.build_frame_pyramid(cfg, torch.from_numpy(depths[3]).to(dev),
                                                    first_point_level=cfg.raycast_shift)
    lvl = cfg.raycast_shift
    p3, n3 = preprocess.compute_points_normals(cfg.intr, torch.from_numpy(depths[3]).to(dev))
    p4, n4 = preprocess.compute_points_normals(cfg.intr, torch.from_numpy(depths[4]).to(dev))
    dist2, min_cos = cfg.icp_dist_thres ** 2, math.cos(cfg.icp_angle_thres)
    systems = {
        "preset": (cfg.intr.level(lvl), pts[lvl], nrm[lvl], st.prev_points[0], st.prev_normals[0]),
        "640x480": (cfg.intr, p4, n4, p3, n3),
    }
    t_cur = torch.eye(4, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    for sname, (intr, cp, cn, pp, pn) in systems.items():
        a_args = (intr, t_cur, cp, cn, pp, pn, dist2, min_cos)
        ak, bk = kernels.icp_build_system(*a_args)
        n = cp.shape[0] * cp.shape[1]
        nblocks = (n + 255) // 256
        partial = torch.empty((nblocks, 27), device=dev)
        ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
        out = torch.empty((42,), device=dev)
        common = lambda: (t_cur.data_ptr(), cp.data_ptr(), cn.data_ptr(), pp.data_ptr(), pn.data_ptr(),  # noqa: E731
                          on.data_ptr(), partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), n, pp.shape[0],
                          pp.shape[1], nblocks, kernels._f32(intr.fx), kernels._f32(intr.fy), kernels._f32(intr.cx),
                          kernels._f32(intr.cy), kernels._f32(dist2), kernels._f32(min_cos))
        calls = {}
        for name, lib in libs.items():
            if not name.startswith("B "):
                continue
            short = name[2:]
            variants = {short: lambda lib=lib: rc_ok("icp", lib.df_icp_reduce(*common(), 0, stream))}
            if short == "kernel":
                variants["two-pass"] = lambda lib=lib: rc_ok("icp", lib.df_icp_reduce(*common(), 1, stream))
            if short == "cluster":
                variants = {f"cluster{c}": lambda lib=lib, c=c: rc_ok("cluster", lib.df_icp_reduce_cluster(
                    *common(), c, stream)) for c in (8, 16)}
            for vname, call in variants.items():
                out.zero_()
                call()
                if not (cs.same_bits(torch, out[:36].view(6, 6), ak) and cs.same_bits(torch, out[36:], bk)):
                    print(f"B {sname}: {vname} differs from the kernel", file=sys.stderr)
                    return 1
                calls[vname] = call
        calls["library"] = lambda: cs.library_icp(torch, *a_args)
        calls["plain"] = lambda: icp._build_system_plain(*a_args)
        rounds = turns(cs, torch, calls, args.rounds)
        times[f"B {sname}"] = {name: median(v) for name, v in rounds.items()}
        print(f"[time] {card} | B {sname} ({cp.shape[1]}x{cp.shape[0]} against {pp.shape[1]}x{pp.shape[0]}, "
              f"{nblocks} groups): " + ", ".join(
                  f"{name} {median(v):.4f} ms ({' '.join(f'{t:.4f}' for t in v)})" for name, v in rounds.items()),
              flush=True)
    print(json.dumps({"card": card, "median_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
