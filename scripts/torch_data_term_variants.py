"""Kernels F and E's design choices timed on the card.

Kernel F (``csrc/data_term.cu``, entry ``df_data_term``) as it is beside
variants of the same source with one choice changed: a point's lanes in
pass 1 (``points1``: a thread a point; the kernel: 8 lanes, one a
neighbour) and a node's lanes in pass 2 (``nodes64``, ``nodes128``: two
warps, a block of 128 threads a node; the kernel: 32, a warp a node), and
with ``--parent DIR`` that tree's kernel (a thread a node, the cost in a
launch of its own). Systems: the preset's (``default_dynamicfusion()``
after three frames of ``bench.py``'s deforming scene, the next frame
tracked: 1 024 nodes, 3 200 solve points, one row), the quality cell's
(``quality_dynamicfusion()`` on the same state: three rows), the options
cell's strided rows (``row_stride`` 4), the point-to-point rows, and
``chip_smoke.py``'s skewed 2048-node systems (node 0 in 60% of 6 400
points; one row and three).

Kernel E (``csrc/knn_blend.cu``, entry ``df_knn_blend``): a query's scan
over 1, 2, 4, 8 and 16 lanes and the one-thread-a-query kernel (lanes 0,
the design before the split), in the kernel's library (a lane tests 4
nodes between two looks at its warp's buffers of 8 candidates) and in
``unroll1`` (1 node), ``unroll8`` (8 nodes, buffers of 16) and ``buffer4``
(4 candidates), at the preset's coarse corners (k = 8,
blend and warp), its solve points (k = 8), its nodes (k = 5) and the
canonical mesh's vertices after the three frames (k = 8, warp and
normals); ``kernels.knn_lanes`` gives the port's choice.

    python3 scripts/torch_data_term_variants.py [--rounds 3] [--parent DIR]

Each variant is built with the kernels' nvcc flags into a library of its
own (its anchors must match the source: edit both together). Each F
launch is held bit for bit against ``warp_solver.data_sums_ordered`` in
the variant's node lanes and ``sum_ordered`` (the parent's within
``chip_smoke.TOL_DATA_REL`` of the plain version: it sums in list order);
each E launch bit for bit against the one-thread-a-query kernel. Times by
``chip_smoke.cuda_ms`` (CUDA events, 20 calls); the variants take turns,
``--rounds`` times. Prints the card, each variant's registers (ptxas),
each round's times and a JSON line of the medians.
"""

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (source, anchor, replacement): each anchor must occur once in its source
F_VARIANTS = {
    "kernel": [],
    "points1": [("data_term.cu", "constexpr int kPointLanes = 8;", "constexpr int kPointLanes = 1;")],
    "nodes64": [("data_term.cu", "constexpr int kNodeLanes = 32;", "constexpr int kNodeLanes = 64;")],
    "nodes128": [("data_term.cu", "constexpr int kNodeLanes = 32;", "constexpr int kNodeLanes = 128;")],
}
_UNROLL = "constexpr int kUnroll = 4;"
_BUFFER = "constexpr int kBuffer = 8;"
E_VARIANTS = {
    "kernel": [],
    "unroll1": [("knn_blend.cu", _UNROLL, "constexpr int kUnroll = 1;")],
    "unroll8": [("knn_blend.cu", _UNROLL, "constexpr int kUnroll = 8;"),
                ("knn_blend.cu", _BUFFER, "constexpr int kBuffer = 16;")],
    "buffer4": [("knn_blend.cu", _BUFFER, "constexpr int kBuffer = 4;")],
}
E_LANES = (0, 1, 2, 4, 8, 16)


def build(kernels, name, src_file, subs, out_dir, csrc=None):
    csrc = kernels.CSRC if csrc is None else csrc
    src = (csrc / src_file).read_text()
    for f, a, b in subs:
        if f != src_file:
            continue
        if src.count(a) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {src_file}: {a[:60]!r}")
        src = src.replace(a, b)
    cu = out_dir / f"{name}_{src_file}"
    cu.write_text(src)
    so = out_dir / f"lib{name}_{Path(src_file).stem}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(csrc), "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(kernels, so, entries):
    lib = ctypes.CDLL(str(so))
    for e in entries:
        fn = getattr(lib, e)
        fn.argtypes = list(kernels._SIGNATURES[e])
        fn.restype = ctypes.c_int
    return lib


def median(v):
    return sorted(v)[len(v) // 2]


def turns(cs, torch, calls, rounds):
    """Each call's times over ``rounds`` turns (the order rotates)."""
    names = list(calls)
    out = {name: [] for name in names}
    for k in range(rounds):
        for name in names[k % len(names):] + names[: k % len(names)]:
            out[name].append(cs.cuda_ms(torch, calls[name], reps=20))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant")
    ap.add_argument("--parent", default=None, help="a tree whose kernel F to time beside the variants")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_data_term_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.ops import fusion
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    card = cs.smi()
    print(card, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="data_term_variants_"))
    procs = {f"F {name}": build(kernels, name, "data_term.cu", subs, tmp) for name, subs in F_VARIANTS.items()}
    procs.update({f"E {name}": build(kernels, name, "knn_blend.cu", subs, tmp) for name, subs in E_VARIANTS.items()})
    if args.parent:
        procs["F parent"] = build(kernels, "parent", "data_term.cu", [], tmp,
                                  csrc=Path(args.parent).resolve() / "dynamicfusion_tpu_torch" / "csrc")
    f_libs, e_libs = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[ptxas] {name}: " + " | ".join(regs), flush=True)
        kind, short = name.split(" ", 1)
        if kind == "F":
            f_libs[short] = bind(kernels, so, ["df_data_term"] + (["df_data_term_lanes"] if short != "parent" else []))
        else:
            e_libs[short] = bind(kernels, so, ["df_knn_blend"])

    dev = torch.device("cuda")
    cfg = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 4)
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    field = st.warp
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[3]).to(dev))
    qcfg = DynamicFusionConfig.quality_dynamicfusion()
    systems = {  # config, structure, node transforms, row stride
        "preset": (cfg, ws.prepare(cfg, field, tr.inputs), field.dq, 1),
        "quality": (qcfg, ws.prepare(qcfg, field, tr.inputs), field.dq, 1),
    }
    ocfg = dataclasses.replace(qcfg, solver_p2p_hessian_stride=4)
    systems["strided"] = (ocfg, ws.prepare(ocfg, field, tr.inputs), field.dq, 4)
    pcfg = dataclasses.replace(cfg, point_to_plane=False)
    systems["point"] = (pcfg, ws.prepare(pcfg, field, tr.inputs), field.dq, 1)
    for nrows in (1, 3):
        c, s, dq = cs.skewed_data_structure(torch, dev, 2048, 6400, nrows, seed=30 + nrows)
        systems[f"2048_r{nrows}"] = (c, s, dq, 1)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for sname, (c, s, dq, stride) in systems.items():
        emax, emean, etop = cs.entry_counts(torch, s.pts_by_node.off)
        npt, n = s.p_can.shape[0], dq.shape[0]
        tangential = s.t1 is not None
        nr = 3 if tangential or not c.point_to_plane else 1
        print(f"[info] F {sname}: {n} nodes, {npt} x {nr} rows, entries a node max {emax}, mean {emean:.1f}, the top "
              f"5% hold {etop:.3f}", flush=True)
        ref = ws.data_term_plain(c, s, dq, True, row_stride=stride)
        out = dict(jac=torch.empty((npt, nr, 8, 6), device=dev), rows=torch.empty((npt, nr, 8, 6), dtype=torch.bfloat16,
                                                                              device=dev),
                   rw=torch.empty((npt, nr), device=dev), rho=torch.empty((npt,), device=dev),
                   jtr=torch.empty((6 * n,), device=dev), blocks=torch.empty((n, 6, 6), device=dev),
                   cost=torch.empty((), device=dev))
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        calls = {}
        for name, lib in f_libs.items():
            def call(lib=lib):
                rc = lib.df_data_term(
                    s.p_can.data_ptr(), s.p_live.data_ptr(), s.n_live.data_ptr(), ptr(s.t1), ptr(s.t2), ptr(s.p2p_sw),
                    s.valid.data_ptr(), s.knn_idx.data_ptr(), s.w_knn.data_ptr(), dq.data_ptr(), npt, n, nr,
                    int(not c.point_to_plane), s.pts_by_node.order.data_ptr(), s.pts_by_node.off.data_ptr(),
                    kernels._f32(c.solver_tukey_c), kernels._f32(c.solver_tukey_c * c.solver_tukey_c / 6.0), stride,
                    kernels._f32(stride ** 0.5), out["jac"].data_ptr(), out["rows"].data_ptr(), out["rw"].data_ptr(),
                    out["rho"].data_ptr(), out["jtr"].data_ptr(), out["blocks"].data_ptr(), out["cost"].data_ptr(),
                    stream)
                if rc:
                    raise RuntimeError(f"df_data_term failed: error {rc}")
            call()
            if name == "parent":
                ok = max(cs.rel_err(torch, out["jtr"], ref.jtr), cs.rel_err(torch, out["blocks"], ref.blocks),
                         cs.rel_err(torch, out["cost"], ref.cost)) <= cs.TOL_DATA_REL
            else:
                lanes = (ctypes.c_int * 2)()
                lib.df_data_term_lanes(ctypes.addressof(lanes))
                ojtr, oblocks = ws.data_sums_ordered(out["jac"], out["rw"], s.pts_by_node, lanes[1])
                ok = (cs.same_bits(torch, out["jtr"], ojtr) and cs.same_bits(torch, out["blocks"], oblocks)
                      and cs.same_bits(torch, out["cost"], ws.sum_ordered(out["rho"])))
            if not ok:
                print(f"F {sname}: variant {name} disagrees with its hold", file=sys.stderr)
                return 1
            calls[name] = call
        rounds = turns(cs, torch, calls, args.rounds)
        times[f"F {sname}"] = {name: median(v) for name, v in rounds.items()}
        print(f"[time] {card} | F {sname}: " + ", ".join(
            f"{name} {median(v):.4f} ms ({' '.join(f'{t:.4f}' for t in v)})" for name, v in rounds.items()),
            flush=True)

    mesh = df.extract_mesh()
    queries = {  # queries, k, blend, warp, normals
        "corners": (fusion.coarse_corner_points(cfg, dev), 8, True, True, None),
        "points": (systems["preset"][1].p_can, 8, False, False, None),
        "nodes": (field.positions, 5, False, False, None),
        "mesh": (torch.from_numpy(mesh.vertices).to(dev), 8, False, True, torch.from_numpy(mesh.normals).to(dev)),
    }
    for qname, (q, k, blend, warp, normals) in queries.items():
        nq = q.shape[0]
        d2, idx, w = (torch.empty((nq, k), dtype=t, device=dev) for t in (torch.float32, torch.int64, torch.float32))
        b = torch.empty((nq, 8), device=dev) if blend else None
        qual = torch.empty((nq,), device=dev) if blend else None
        wp = torch.empty((nq, 3), device=dev) if warp else None
        wn = torch.empty((nq, 3), device=dev) if normals is not None else None
        outs = (d2, idx, w, b, qual, wp, wn)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        calls, ref = {}, None
        for lname, lib in e_libs.items():
            for lanes in E_LANES:
                def call(lib=lib, lanes=lanes):
                    rc = lib.df_knn_blend(
                        field.positions.data_ptr(), field.active.data_ptr(), field.radius.data_ptr(),
                        field.dq.data_ptr(), field.positions.shape[0], q.data_ptr(), ptr(normals), nq, k, lanes,
                        *(ptr(t) for t in outs), stream)
                    if rc:
                        raise RuntimeError(f"df_knn_blend failed: error {rc}")
                call()
                got = tuple(None if t is None else t.clone() for t in outs)
                if ref is None:
                    ref = got  # the kernel's library, lanes 0: one thread a query
                elif not all(cs.same_bits(torch, a, r) for a, r in zip(got, ref)):
                    print(f"E {qname}: {lname} with {lanes} lanes differs from one thread a query", file=sys.stderr)
                    return 1
                calls[f"{lname} lanes{lanes}"] = call
        rounds = turns(cs, torch, calls, args.rounds)
        times[f"E {qname}"] = {name: median(v) for name, v in rounds.items()}
        print(f"[time] {card} | E {qname} ({nq} queries, k = {k}; the port takes {kernels.knn_lanes(nq)} lanes): "
              + ", ".join(
            f"{name} {median(v):.4f} ms ({' '.join(f'{t:.4f}' for t in v)})" for name, v in rounds.items()),
            flush=True)
    print(json.dumps({"card": card, "median_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
