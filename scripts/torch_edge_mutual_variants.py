"""Kernel G's edge term and kernel E's mutual-nearest pass, their design
choices timed on the card.

Kernel G's edge term (``csrc/pcg.cu``, entry ``df_edge_term``): the one
launch (a block of 512 threads owns 8 nodes, 85 edge jobs a round), its
three-launch mode (the design before: a thread an edge, a thread a node,
one block for the cost), blocks of 2, 4 and 16 nodes (128, 256 and
1024 threads; 21, 40 and 170 jobs a round), and the last block's cost
sum staged through shared memory, four values of each of
``ordered_sum``'s threads at a time with all of a thread's loads in
flight together (``staged_sum``; the kernel calls ``ordered_sum``, the
same order); beside the plain version (no PyTorch call computes the
Huber-weighted DQB blocks). Shape: the preset's
solve (``default_dynamicfusion()`` after three frames of the deforming
scene, the next frame tracked, as ``chip_smoke.py`` phase 2: 1 024 nodes,
4 096 edges). Each variant is held bit for bit against the kernel in all
six outputs.

Kernel E's mutual-nearest pass (``csrc/knn_blend.cu``, entry
``df_mutual_nearest``): the one launch at each lane count (1, 2, 4, 8, 16
lanes a candidate: ``lanes1`` ... ``lanes16``; the kernel's ``kMnLanes``
is 32), blocks of 128
and 256 threads (the kernel: 512), one and eight steps of a lane's walk
at a time (``unroll1``, ``unroll8``; the kernel: 4), a block's minimum
sent to the device only where it is below the value there
(``readfirst``), and the three-launch mode (the design before: a fill,
a thread a candidate, a conversion); beside
``chip_smoke.library_mutual_nearest`` (``torch.addmm`` and two masked
``amin``s) and the plain version. Shapes: the preset's insertion (the
same state's 4 800 candidates) and ``reference_parity()``'s (frame 1's
19 200 candidates against its frame-0 field). Each variant is held bit
for bit against the plain version.

    python3 scripts/torch_edge_mutual_variants.py [--rounds 3]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the sources: edit both
together). Times by ``chip_smoke.cuda_ms`` (CUDA events, 20 calls); the
variants take turns, ``--rounds`` times. Prints the card, each variant's
registers and spills, each round's times and a JSON line of the medians.
"""

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

_NODES = "constexpr int kEdgeThreads = 512;\nconstexpr int kEdgeNodes = 8;\nconstexpr int kEdgeSlots = 85;"
_MN = "constexpr int kMnThreads = 512;"
_UNROLL = "constexpr int kMnUnroll = 4;"
_LANES = "constexpr int kMnLanes = 32;"
_SUM = "  const float total = ordered_sum(cost_e, n * kc);"
# ordered_sum's order by a 512-thread block, 4 096 values a stage: thread t
# keeps the sums of ordered_sum's threads t and t + 512
_STAGED_SUM = """  float total = 0.0f;
  {
    static_assert(kEdgeThreads == 512, "the staged sum stands for two of ordered_sum's threads a thread");
    __shared__ float stage[4 * kReduceThreads];
    __shared__ float sm2[kReduceThreads / 32];
    const int nn = n * kc, t = threadIdx.x;
    float s0 = 0.0f, s1 = 0.0f;
    for (int c0 = 0; c0 < nn; c0 += 4 * kReduceThreads) {
      const int m = min(4 * kReduceThreads, nn - c0);
      float r[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) r[q] = q * 512 + t < m ? __ldcg(cost_e + c0 + q * 512 + t) : 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) stage[q * 512 + t] = r[q];
      __syncthreads();
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (d * kReduceThreads + t < m) s0 += stage[d * kReduceThreads + t];
        if (d * kReduceThreads + 512 + t < m) s1 += stage[d * kReduceThreads + 512 + t];
      }
      __syncthreads();
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, o);
      s1 += __shfl_down_sync(0xffffffffu, s1, o);
    }
    if ((t & 31) == 0) {
      sm2[t >> 5] = s0;
      sm2[(t + 512) >> 5] = s1;
    }
    __syncthreads();
    if (t < 32) {
      total = sm2[t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) total += __shfl_down_sync(0xffffffffu, total, o);
    }
  }"""
_FLUSH = "        if (smin[j] != kBigBits) atomicMin(&node_bits[base + j], smin[j]);"


def _nodes(threads, nodes, slots):
    return [("pcg.cu", _NODES, f"constexpr int kEdgeThreads = {threads};\nconstexpr int kEdgeNodes = {nodes};\n"
                               f"constexpr int kEdgeSlots = {slots};")]


# (file, anchor, replacement): each anchor must occur once in its source
G_VARIANTS = {"kernel": [], "nodes2": _nodes(128, 2, 21), "nodes4": _nodes(256, 4, 40),
              "nodes16": _nodes(1024, 16, 170), "staged_sum": [("pcg.cu", _SUM, _STAGED_SUM)]}
E_VARIANTS = {
    "kernel": [],
    **{f"lanes{k}": [("knn_blend.cu", _LANES, f"constexpr int kMnLanes = {k};")] for k in (1, 2, 4, 8, 16)},
    "threads128": [("knn_blend.cu", _MN, "constexpr int kMnThreads = 128;")],
    "threads256": [("knn_blend.cu", _MN, "constexpr int kMnThreads = 256;")],
    "unroll1": [("knn_blend.cu", _UNROLL, "constexpr int kMnUnroll = 1;")],
    "unroll8": [("knn_blend.cu", _UNROLL, "constexpr int kMnUnroll = 8;")],
    # a block's minimum goes to node_bits only where it is below the value there
    "readfirst": [("knn_blend.cu", _FLUSH, "        if (smin[j] != kBigBits && smin[j] < __ldcg(node_bits + base + j)) "
                                           "atomicMin(&node_bits[base + j], smin[j]);")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_edge_mutual_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE / "scripts"))
    import chip_smoke as cs
    from torch_data_term_variants import bind, build, median, turns
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="edge_mutual_variants_"))
    procs = {f"G {name}": build(kernels, name, "pcg.cu", subs, tmp) for name, subs in G_VARIANTS.items()}
    procs.update({f"E {name}": build(kernels, name, "knn_blend.cu", subs, tmp) for name, subs in E_VARIANTS.items()})
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("edge_term_kernel" in ln or "edge_kernel" in ln
                                                      or "edge_nodes_kernel" in ln or "mutual_nearest" in ln):
                props = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                         if "registers" in x or "spill" in x]
                fn = ln.split("'")[1] if "'" in ln else ln
                print(f"[ptxas] {name}: {fn}: " + " | ".join(props), flush=True)
        libs[name] = bind(kernels, so, ["df_edge_term"] if name.startswith("G ") else ["df_mutual_nearest"])

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = {}

    def rc_ok(name, rc):
        if rc:
            raise RuntimeError(f"{name} failed to launch: error {rc}")

    cfg = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 5)
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[3]).to(dev))

    # ------------------------------------------------------------------ G
    s = ws.prepare(cfg, st.warp, tr.inputs)
    dq = st.warp.dq
    n, ne = dq.shape[0], s.e_src.shape[0]
    ref = kernels.edge_term(*cs.edge_args(cfg, s, dq))
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    ran = ctypes.c_int(0)
    calls = {}
    for name, lib in libs.items():
        if not name.startswith("G "):
            continue
        h = torch.empty((3, ne, 6, 6), device=dev)
        g = torch.empty((2, ne, 6), device=dev)
        cost_e = torch.empty((ne,), device=dev)
        jtr = torch.empty((6 * n,), device=dev)
        diag = torch.empty((n, 6, 6), device=dev)
        cost = torch.empty((), device=dev)
        outs = (jtr, cost, h[0], h[1], h[2], diag)

        def call(three, lib=lib, h=h, g=g, cost_e=cost_e, jtr=jtr, diag=diag, cost=cost):
            rc_ok("edge term", lib.df_edge_term(
                dq.data_ptr(), s.e_src.data_ptr(), s.e_dst.data_ptr(), s.e_valid.data_ptr(), s.v_dst.data_ptr(),
                s.alpha.data_ptr(), ne, n, s.edges_by_dst.order.data_ptr(), s.edges_by_dst.off.data_ptr(),
                kernels._f32(cfg.solver_arap_weight), kernels._f32(cfg.solver_huber_delta), h[0].data_ptr(),
                h[1].data_ptr(), h[2].data_ptr(), g[0].data_ptr(), g[1].data_ptr(), cost_e.data_ptr(),
                jtr.data_ptr(), diag.data_ptr(), cost.data_ptr(), None if three else ticket.data_ptr(), int(three),
                ctypes.byref(ran), stream))

        variants = {name[2:]: lambda call=call: call(False)}
        if name == "G kernel":
            variants["three-launch"] = lambda call=call: call(True)
        for vname, c in variants.items():
            c()
            if not all(cs.same_bits(torch, a, b) for a, b in zip(outs, ref)) or int(ticket) != 0:
                print(f"G: {vname} differs from the kernel", file=sys.stderr)
                return 1
            calls[vname] = c
    calls["plain"] = lambda: ws.edge_term(cfg, s, dq, plain=True)
    rounds = turns(cs, torch, calls, args.rounds)
    times["G preset"] = {name: median(v) for name, v in rounds.items()}
    print(f"[time] {card} | G preset ({n} nodes, {ne} edges): " + ", ".join(
        f"{name} {median(v):.4f} ms ({' '.join(f'{t:.4f}' for t in v)})" for name, v in rounds.items()), flush=True)

    # ------------------------------------------------------------------ E
    shapes = {"preset": (st.warp, tr.inputs.p_can[:: cfg.node_insert_stride].contiguous())}
    pcfg = DynamicFusionConfig.reference_parity()
    pdf = kinfu.DynamicFusion(pcfg, device=dev)
    pdf(depths[0])
    ptr_ = kinfu.track(pcfg, pdf.state, torch.from_numpy(depths[1]).to(dev))
    shapes["parity"] = (pdf.state.warp, ptr_.inputs.p_can[:: pcfg.node_insert_stride].contiguous())
    for sname, (field, q) in shapes.items():
        valid = ~torch.isnan(q[:, 0])
        n, nc = field.positions.shape[0], q.shape[0]
        cp, npl = warpfield.mutual_nearest(field, q, valid, plain=True)
        bits = torch.full((n,), kernels._BIG_BITS, dtype=torch.int32, device=dev)
        calls = {}
        for name, lib in libs.items():
            if not name.startswith("E "):
                continue
            cd = torch.empty((nc,), device=dev)
            nd = torch.empty((n,), device=dev)

            def call(three, lib=lib, cd=cd, nd=nd):
                rc_ok("mutual nearest", lib.df_mutual_nearest(
                    field.positions.data_ptr(), field.active.data_ptr(), n, q.data_ptr(), valid.data_ptr(), nc,
                    cd.data_ptr(), bits.data_ptr(), nd.data_ptr(), ticket.data_ptr(), int(three), ctypes.byref(ran),
                    stream))

            short = name[2:]
            variants = {short: lambda call=call: call(False)}
            if short == "kernel":
                variants["three-launch"] = lambda call=call: call(True)
            for vname, c in variants.items():
                c()
                if vname == "three-launch":
                    bits.fill_(kernels._BIG_BITS)
                if not (cs.same_bits(torch, cd, cp) and cs.same_bits(torch, nd, npl)) or int(ticket) != 0:
                    print(f"E {sname}: {vname} differs from the plain version", file=sys.stderr)
                    return 1
                calls[vname] = c
        calls.pop("three-launch")
        calls["three-launch"] = lambda: kernels.mutual_nearest(field.positions, field.active, q, valid,
                                                                three_launch=True)
        calls["library"] = lambda: cs.library_mutual_nearest(torch, field, q, valid)
        calls["plain"] = lambda: warpfield.mutual_nearest(field, q, valid, plain=True)
        rounds = turns(cs, torch, calls, args.rounds)
        times[f"E {sname}"] = {name: median(v) for name, v in rounds.items()}
        print(f"[time] {card} | E {sname} ({nc} candidates, {n} nodes): "
              + ", ".join(f"{name} {median(v):.4f} ms ({' '.join(f'{t:.4f}' for t in v)})"
                          for name, v in rounds.items()), flush=True)
    print(json.dumps({"card": card, "median_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
