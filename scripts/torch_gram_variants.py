"""Kernel N's design choices timed on the card: the dense Gram
(``csrc/dense_system.cu``, entry ``df_dense_gram``) as it is, beside
variants of the same source with one choice changed, on the base
``DynamicFusionConfig()``'s system (three frames of ``bench.py``'s deforming
scene, the next frame tracked: 1 024 nodes, 3 200 solve points), on the
shard mode's share of it (the sharded base's first shard: the first
quarter of the points, the whole's column scales, no edges) and on
``chip_smoke.py``'s skewed 2048-node inputs (node 0 in 60% of 6 400
points). Variants:

- ``self_shared``: the node's own 6x6 block, which takes a term from every
  one of the node's entries, summed by all eight thread groups of its tile
  (entry e of a chunk to group e mod 8, in registers, the eight sums added
  in group order) instead of by the one group that owns its slot;
  ``shared_from_M``: the same for the nodes of at least M entries only;
- ``float2_stores``: the epilogue writes with 8-byte stores in int8 too
  (the kernel uses 16-byte ones in int8 where 6N and the tile width are
  even, 8-byte ones otherwise); ``float4_stores``: 16-byte ones in bf16
  too.

    python3 scripts/torch_gram_variants.py [--rounds 3]

Each variant is built with the kernels' nvcc flags into a library of its
own, checked against the plain version (int8 bit-equal, bf16 within 1e-6
of the largest entry) and timed with ``chip_smoke.cuda_ms`` (CUDA events,
20 calls); the variants take turns, ``--rounds`` times. Prints the card,
each variant's registers and shared memory (ptxas), each round's times and
a JSON line of the medians.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (anchor in the source, replacement): each anchor must occur once; the
# shared diagonal block's code, beside the threshold that self_shared adds
_SELF_SHARED_BODY = [
    ("""  __shared__ __align__(16) Acc acc[6 * kAccStride];
""", """  static_assert(kChunk * kPer * sizeof(Val) >= kGramThreads * sizeof(Acc), "the staged rows hold the self sums");
  __shared__ __align__(16) Acc acc[6 * kAccStride];
"""),
    ("""  __shared__ unsigned s_hits[kGroups][kWarps];    // a group's entries of the chunk, a bit each
""", """  __shared__ unsigned s_hits[kGroups][kWarps];    // a group's entries of the chunk, a bit each
  __shared__ unsigned s_valid[kWarps];            // the chunk's entries, a bit each
"""),
    ("        if (gm) {", "        if (gm || self_in) {"),
    ("""        if ((tid & 31) == 0) s_hits[h][tid >> 5] = bits;
      }
""", """        if ((tid & 31) == 0) s_hits[h][tid >> 5] = bits;
      }
      const unsigned valid = __ballot_sync(0xffffffffu, ent >= 0);
      if ((tid & 31) == 0) s_valid[tid >> 5] = valid;
"""),
    ("""        } while (m);
      }
    }
    __syncthreads();
  }
""", """        } while (m);
      }
      if (self_in) {
        for (unsigned hit = s_valid[w] & (0x01010101u << g); hit; hit &= hit - 1) {
          const Val* v = staged + (32 * w + __ffs(hit) - 1) * kPer;
          const int ke = s_kn[32 * w + __ffs(hit) - 1];
          Acc sum = Acc(0);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const Left x = value_of(v[(r * kK + ke) * 6 + a]);
            sum = sum + static_cast<Acc>(x * value_of(v[(r * kK + ke) * 6 + b]));
          }
          self_sum += sum;
        }
      }
    }
    __syncthreads();
  }
  if (self_in) {
    Acc* part = reinterpret_cast<Acc*>(staged);  // free after the walk: 288 sums
    part[tid] = self_sum;
    __syncthreads();
    if (tid < 36) {
      Acc t = part[tid];
#pragma unroll
      for (int h = 1; h < kGroups; ++h) t = t + part[h * 36 + tid];
      acc[a * kAccStride + 6 * s_self + b] = t;
    }
    __syncthreads();
  }
"""),
]
def self_shared(min_entries: int):
    """The node's own block shared by the eight groups when the node has at
    least ``min_entries`` entries (its self tile's walk then splits eight
    ways; below, the group of its slot sums it as any other)."""
    return [
        ("""  if (q0 == q1) __syncthreads();  // else the first chunk's barriers order the above
""", f"""  if (q0 == q1) __syncthreads();  // else the first chunk's barriers order the above
  const int s_self = node - t0;
  const bool self_in = static_cast<unsigned>(s_self) < static_cast<unsigned>(tw) && q1 - q0 >= {min_entries};
  const int s_skip = self_in ? s_self : -1;
  Acc self_sum = Acc(0);
"""),
        ("if (static_cast<unsigned>(s) < static_cast<unsigned>(tw)) {",
         "if (static_cast<unsigned>(s) < static_cast<unsigned>(tw) && s != s_skip) {"),
    ] + _SELF_SHARED_BODY


FLOAT2_STORES = [  # 8-byte stores in int8 too
    ("if (kInt8 && (n & 1) == 0 && (tw & 1) == 0) {", "if (false) {"),
]
FLOAT4_STORES = [  # 16-byte stores in bf16 too, where 6N and the tile allow
    ("if (kInt8 && (n & 1) == 0 && (tw & 1) == 0) {", "if ((n & 1) == 0 && (tw & 1) == 0) {"),
]
VARIANTS = {"kernel": [], "self_shared": self_shared(0), "shared_from_1024": self_shared(1024),
            "float2_stores": FLOAT2_STORES, "float4_stores": FLOAT4_STORES}


def build(kernels, name, subs, out_dir):
    src = (kernels.CSRC / "dense_system.cu").read_text()
    for a, b in subs:
        if src.count(a) != 1:
            raise RuntimeError(f"{name}: anchor not found once in dense_system.cu: {a[:60]!r}")
        src = src.replace(a, b)
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    so = out_dir / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(kernels.CSRC), "-o", str(so),
           str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_gram_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    card = cs.smi()
    print(card, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="gram_variants_"))
    procs = {name: build(kernels, name, subs, tmp) for name, subs in VARIANTS.items()}
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[ptxas] {name}: " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.df_dense_gram.argtypes = list(kernels._SIGNATURES["df_dense_gram"])
        lib.df_dense_gram.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    cfg = DynamicFusionConfig()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 4)
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[3]).to(dev))
    s = ws.prepare(cfg, st.warp, tr.inputs)
    dt = ws.data_term(cfg, s, st.warp.dq, True)
    et = ws.edge_term(cfg, s, st.warp.dq)
    n = st.warp.positions.shape[0]
    g = cs.skewed_gram_inputs(torch, dev, 2048, 6400, 1, 13)
    q = s.knn_idx.shape[0] // 4  # the sharded base's first shard: a quarter of the points, the pmax'd scales
    whole = ws.gram_scales_plain(ws.dense_rows(dt.rows, s.knn_idx, n))
    edges = (et.h_ij, et.diag, s.e_src, s.e_dst, s.edges_by_dst)
    cases = {  # rows, ids, node lists, nodes, edges (None: the shard mode), given scales, modes
        "base": (dt.rows, s.knn_idx, s.pts_by_node, n, edges, None, (True, False)),
        "shard": (dt.rows[:q], s.knn_idx[:q], ws.node_lists(s.knn_idx[:q], n), n, None, whole, (True,)),
        "2048": (g.rows, g.knn, g.lists, 2048, (g.h_ij, g.diag, g.e_src, g.e_dst, g.e_lists), None, (True, False)),
    }
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for cname, (rows, knn, lists, nn, edges, given, modes) in cases.items():
        emax, emean, etop = cs.entry_counts(torch, lists.off)
        print(f"[info] {cname}: {nn} nodes, {rows.shape[0]} x {rows.shape[1]} rows, entries a node max {emax}, "
              f"mean {emean:.1f}, the top 5% hold {etop:.3f}", flush=True)
        knn32 = knn.to(torch.int32)
        perm = torch.empty((nn,), dtype=torch.int32, device=dev)
        h_ij, diag, e_src, e_dst, e_lists = edges if edges is not None else (None,) * 5
        dst32 = e_dst.to(torch.int32) if edges is not None else None
        for int8 in modes:
            mode = f"{cname} {'int8' if int8 else 'bf16'}"
            if given is not None:
                scale = given
            else:
                scale = ws.gram_scales_plain(ws.dense_rows(rows, knn, nn)) if int8 else torch.empty(1, device=dev)
            codes = torch.empty((rows.shape[0] * rows.shape[1] * 48,), dtype=torch.int8, device=dev)
            ref = ws.dense_gram_plain(rows, knn, int8, h_ij, diag, e_src, e_dst, scale=given, n=nn)
            out = torch.empty_like(ref)
            ptrs = ((h_ij.data_ptr(), diag.data_ptr(), dst32.data_ptr(), e_lists.order.data_ptr(),
                     e_lists.off.data_ptr(), e_dst.shape[0] // nn, 1) if edges is not None
                    else (None, None, None, None, None, 1, 0))
            calls = {}
            for name, lib in libs.items():
                def call(lib=lib):
                    h, dg, ed, eo, ef, ce, with_edges = ptrs
                    rc = lib.df_dense_gram(
                        rows.data_ptr(), rows.shape[1], rows.shape[0], knn32.data_ptr(), lists.order.data_ptr(),
                        lists.off.data_ptr(), scale.data_ptr(), h, dg, ed, eo, ef, ce, nn, int(int8), with_edges,
                        codes.data_ptr(), perm.data_ptr(), out.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"df_dense_gram failed: error {rc}")
                call()
                ok = torch.equal(out, ref) if int8 else cs.rel_err(torch, out, ref) <= cs.TOL_GRAM_BF16_REL
                if not ok:
                    print(f"{mode}: variant {name} disagrees with the plain version", file=sys.stderr)
                    return 1
                calls[name] = call
            names = list(calls)
            rounds = {name: [] for name in names}
            for k in range(args.rounds):
                for name in names[k % len(names):] + names[: k % len(names)]:
                    rounds[name].append(cs.cuda_ms(torch, calls[name], reps=20))
            times[mode] = {name: sorted(v)[len(v) // 2] for name, v in rounds.items()}
            print(f"[time] {card} | {mode}: " + ", ".join(
                f"{name} {times[mode][name]:.4f} ms ({' '.join(f'{t:.4f}' for t in rounds[name])})"
                for name in names), flush=True)
            del ref, out
    print(json.dumps({"card": card, "median_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
