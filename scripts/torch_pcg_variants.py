"""Kernel G's PCG launch timed on the card: the kernel (``csrc/pcg.cu``,
entry ``df_pcg``: a cluster of 16 CTAs of 512 threads) beside variants of
the same source with one choice changed, on three systems: the preset's
(``default_dynamicfusion()`` after three frames of ``bench.py``'s deforming
scene, the next frame tracked: 1 024 nodes, 3 200 solve points, one row a
point), the quality cell's (``quality_dynamicfusion()`` on the same state:
three rows a point) and ``chip_smoke.py``'s skewed 2048-node system (node 0
in 60% of 6 400 points, one row). Variants:

- ``cluster4``, ``cluster8``: clusters of 4 and 8 CTAs;
- ``gridS``: a cooperative grid over every SM (S CTAs, ``grid.sync()`` in
  place of the cluster barrier, p and the dot products' partials in
  device memory);
- ``prefetch``: a lane's list walk computes the entry sums of four steps
  (two with three rows) from valid addresses before it adds them (the
  same sums in the same order), so their loads can be in flight
  together;
- ``threads1024``: CTAs of 1024 threads (up to 64 registers a thread);
- ``serial``: a node's data entries added one by one in list order (the
  lanes compute a step's 32 entries, every lane adds them in turn), as
  the plain version's scatter sums them;
- ``probe``: the kernel with CTA 0's thread 0 reading the global timer
  after each barrier of an iteration: the time from the iteration's start
  to the end of the row phase's barrier (t), of the node phase's and
  pᵀAp's (Ap), of the update, z and rᵀr, rᵀz's (z), and of p's update and
  copies (p), summed over the solve and printed per iteration.

    python3 scripts/torch_pcg_variants.py [--rounds 3] [--parent DIR]

Each variant is built with the kernels' nvcc flags into a library of its
own (its anchors must match the source: edit both together). Each launch
is held against the plain PCG (max |diff| over max |x| printed, and
whether it is within ``chip_smoke.hold_pcg``'s tolerance, max(TOL_PCG_REL,
SPREAD_PCG x the plain PCG's one-ulp spread)) and timed with
``chip_smoke.cuda_ms`` (CUDA events, 20 solves); the variants take turns,
``--rounds`` times. Each system also prints the plain PCG's own spread,
how far ``chip_smoke.pcg_bf16_control`` (bf16 vectors) lands, and every
solve's distance from the same PCG in float64 with the bf16 rounding
points kept (``pcg64``), with the non-finite entries of each. Prints the
card, each round's times and a JSON line of the medians.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (anchor in csrc/pcg.cu, replacement, occurrences)
_CLUSTER = "constexpr int kPcgCluster = 16;"


def cluster(c):
    return [(_CLUSTER, f"constexpr int kPcgCluster = {c};", 1)]


def grid(sms):
    return cluster(sms) + [
        ("""struct Cluster {
  cg::cluster_group g;
  float* slots;  // (kSlots, kPcgCluster) of this CTA
  __device__ int rank() const { return static_cast<int>(g.block_rank()); }
  __device__ void sync() { g.sync(); }
  // this CTA's partial into its slot of use s in every CTA
  __device__ void put(int s, float v) {
    for (int c = 0; c < kPcgCluster; ++c) g.map_shared_rank(slots, c)[s * kPcgCluster + rank()] = v;
  }
  // the partials of use s added in rank order (after a barrier)
  __device__ float total(int s) const {
    float t = 0.0f;
    for (int c = 0; c < kPcgCluster; ++c) t += slots[s * kPcgCluster + c];
    return t;
  }
  // p[i] = v in every CTA's copy
  __device__ void put_p(float* p, int i, float v) {
    for (int c = 0; c < kPcgCluster; ++c) g.map_shared_rank(p, c)[i] = v;
  }
};""", """__device__ float g_slots[kSlots * kPcgCluster];
struct Cluster {
  cg::grid_group g;
  float* slots;  // unused: the partials live in device memory
  __device__ int rank() const { return static_cast<int>(blockIdx.x); }
  __device__ void sync() { g.sync(); }
  __device__ void put(int s, float v) { g_slots[s * kPcgCluster + rank()] = v; }
  __device__ float total(int s) const {
    float t = 0.0f;
    for (int c = 0; c < kPcgCluster; ++c) t += __ldcg(g_slots + s * kPcgCluster + c);
    return t;
  }
  __device__ void put_p(float* p, int i, float v) { p[i] = v; }
};""", 1),
        ("Cluster grp{cg::this_cluster(), slots};", "Cluster grp{cg::this_grid(), slots};", 2),
        ("""  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;""", """  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;""", 1),
        ("if (cluster > 8 && !done[k].wide) {", "if (false) {", 1),
    ]


PREFETCH = [
    ("""#pragma unroll 2
  for (int q = S.pt_off[nd] + lane; q < q1; q += 32) {
    float s[6];
    entry_sum<R, M>(S, t, S.pt_order[q], s);
#pragma unroll
    for (int d = 0; d < 6; ++d) dat[d] += s[d];
  }""", """  constexpr int kB = R == 1 ? 4 : 2;
  for (int qb = S.pt_off[nd] + lane; qb < q1; qb += kB * 32) {
    float s[kB][6];
#pragma unroll
    for (int u = 0; u < kB; ++u) entry_sum<R, M>(S, t, S.pt_order[min(qb + 32 * u, q1 - 1)], s[u]);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (qb + 32 * u < q1) {
#pragma unroll
        for (int d = 0; d < 6; ++d) dat[d] += s[u][d];
      }
    }
  }""", 1),
]
THREADS1024 = [("constexpr int kPcgThreads = 512;", "constexpr int kPcgThreads = 1024;", 1)]
SERIAL = [
    ("""__device__ __forceinline__ float floor30(float v)""", """// node nd's data product by one warp in list order: the lanes compute
// the entries of a step of 32, then every lane adds them one by one
template <int R, int M>
__device__ __forceinline__ void warp_data_serial(const Sys& S, const float* __restrict__ t, int nd, int lane,
                                                 float dat[6]) {
#pragma unroll
  for (int d = 0; d < 6; ++d) dat[d] = 0.0f;
  const int q1 = S.pt_off[nd + 1];
  for (int qb = S.pt_off[nd]; qb < q1; qb += 32) {
    float s[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) s[d] = 0.0f;
    if (qb + lane < q1) entry_sum<R, M>(S, t, S.pt_order[qb + lane], s);
    const int cnt = min(32, q1 - qb);
    for (int j = 0; j < cnt; ++j) {
#pragma unroll
      for (int d = 0; d < 6; ++d) dat[d] += __shfl_sync(0xffffffffu, s[d], j);
    }
  }
}

__device__ __forceinline__ float floor30(float v)""", 1),
    ("""  lane_data<R, M>(S, t, nd, lane, dat);
  lane_edge<kSharedP>(S, p, nd, pn, lane, edg);
  warp_sum6(dat);
  warp_sum6(edg);""", """  warp_data_serial<R, M>(S, t, nd, lane, dat);
  lane_edge<kSharedP>(S, p, nd, pn, lane, edg);
  warp_sum6(edg);""", 1),
]
_MARK = "if (grp.rank() == 0 && threadIdx.x == 0) probe_mark({});"
PROBE = [
    (_CLUSTER, _CLUSTER + """
__device__ unsigned long long g_probe[5];  // the four phases' ns, then the last mark
__device__ __forceinline__ void probe_mark(int k) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (k >= 0) g_probe[k] += now - g_probe[4];
  g_probe[4] = now;
}""", 1),
    ("""    row_t<R, M, kSharedP>(S, p, t, M == kPlaneRows ? i * R : i);
  grp.sync();
""", """    row_t<R, M, kSharedP>(S, p, t, M == kPlaneRows ? i * R : i);
  grp.sync();
  """ + _MARK.format(0) + "\n", 1),
    ("""  float rz = grp.total(kSlotBZ);
""", """  float rz = grp.total(kSlotBZ);
  """ + _MARK.format(-1) + "\n", 1),
    ("""    grp.sync();
    const float alpha""", """    grp.sync();
    """ + _MARK.format(1) + """
    const float alpha""", 1),
    ("""    grp.sync();
    rr = grp.total(kSlotRR);""", """    grp.sync();
    """ + _MARK.format(2) + """
    rr = grp.total(kSlotRR);""", 1),
    ("""    rz = rz_new;
    grp.sync();
""", """    rz = rz_new;
    grp.sync();
    """ + _MARK.format(3) + "\n", 1),
    ("""extern "C" int df_edge_term(""", """extern "C" int df_probe(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}

extern "C" int df_edge_term(""", 1),
]


def source_variants(sms):
    """{name: substitutions} of the variants built from csrc/pcg.cu."""
    return {"cluster4": cluster(4), "cluster8": cluster(8), f"grid{sms}": grid(sms), "prefetch": PREFETCH,
            "threads1024": THREADS1024, "serial": SERIAL, "probe": PROBE}


def build(kernels, name, subs, out_dir):
    src = (kernels.CSRC / "pcg.cu").read_text()
    for a, b, count in subs:
        if src.count(a) != count:
            raise RuntimeError(f"{name}: anchor found {src.count(a)} times, not {count}: {a[:60]!r}")
        src = src.replace(a, b)
    cu = out_dir / f"pcg_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"libpcg_{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(kernels.CSRC), "-o", str(so),
           str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(kernels, name, so, proc):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{out}")
    regs = sorted({ln.split(":", 1)[1].strip() for ln in out.splitlines() if "registers" in ln})
    print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.df_pcg.argtypes = list(kernels._SIGNATURES["df_pcg"])
    lib.df_pcg.restype = ctypes.c_int
    lib.df_pcg_plan.argtypes = list(kernels._SIGNATURES["df_pcg_plan"])
    lib.df_pcg_plan.restype = ctypes.c_int
    return lib


def systems(torch, cs, dev):
    """{name: (structure, system, preconditioner, b, iters, rtol)}."""
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    nr = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(nr.intr, nr.rows, nr.cols, 4)
    df = kinfu.DynamicFusion(nr, device=dev)
    for d in depths[:3]:
        df(d)
    field = df.state.warp
    inputs = kinfu.track(nr, df.state, torch.from_numpy(depths[3]).to(dev)).inputs
    n = field.positions.shape[0]
    out = {}
    for name, cfg in (("preset", nr), ("quality", DynamicFusionConfig.quality_dynamicfusion())):
        s = ws.prepare(cfg, field, inputs)
        with cs.deterministic(torch):
            dp = ws.data_term(cfg, s, field.dq, True, plain=True)
            ep = ws.edge_term(cfg, s, field.dq, plain=True)
        blocks = dp.blocks + ep.diag
        diag_eff, unit = ws.damping_terms(cfg, field.active, blocks)
        damp = cfg.solver_lm_lambda_init * diag_eff + unit
        ip = torch.linalg.inv((blocks + torch.diag_embed(damp.reshape(n, 6))).double()).float().contiguous()
        out[name] = (s, ws.System(dp.rows, ep, damp), ip, dp.jtr + ep.jtr, cfg.solver_linear_iters,
                     cfg.solver_linear_tol)
        if name == "preset":
            # the solver's own preconditioner (kernel G's closed-form
            # spd6_inv of the damped blocks), on which the float32 PCG of
            # the first LM iteration overflows (the JAX package's too)
            cf = ws.spd6_inv(blocks + torch.diag_embed(damp.reshape(n, 6)))
            out["preset_closed_form"] = out[name][:2] + (cf,) + out[name][3:]
    # the 2048-node system of chip_smoke.pcg_2048, one row
    s, sysm, ip, b, _ = cs.skewed_pcg_system(torch, dev, 2048, 6400, 1)
    out["skewed_2048"] = (s, sysm, ip, b, nr.solver_linear_iters, nr.solver_linear_tol)
    return out


def pcg64(torch, ws, s, sysm, minv, b, iters, rtol):
    """The PCG of ``warp_solver.pcg_plain`` in float64 with the bf16
    rounding points kept (bf16(p), t = bf16(float32(row · bf16(p)))): the
    reference both float32 orders are measured from."""
    n = b.shape[0] // 6
    rows = sysm.rows.double()
    if sysm.used is not None or sysm.stride > 1:
        rows = rows * ws._rows_in(sysm, rows.shape[0]).double()[:, :, None, None]
    e = sysm.edge
    h_ii, h_jj, h_ij = (h.double() for h in (e.h_ii, e.h_jj, e.h_ij))
    damp = sysm.damp.double()
    m = minv.double()

    def bf(v):
        return v.float().to(torch.bfloat16).double()

    def mv(p):
        pm = bf(p).reshape(n, 6)
        t = bf((rows * pm[s.knn_idx][:, None]).sum((2, 3)))
        data = torch.zeros((n, 6), dtype=torch.float64, device=p.device).index_add_(
            0, s.knn_idx.reshape(-1), (rows * t[:, :, None, None]).sum(1).reshape(-1, 6))
        pv = p.reshape(n, 6)
        p_i, p_j = pv[s.e_src], pv[s.e_dst]
        q_i = (h_ii @ p_i[:, :, None] + h_ij @ p_j[:, :, None])[..., 0]
        q_j = (h_ij.transpose(1, 2) @ p_i[:, :, None] + h_jj @ p_j[:, :, None])[..., 0]
        edg = torch.zeros_like(data).index_add_(0, s.e_src, q_i).index_add_(0, s.e_dst, q_j)
        return (data + edg).reshape(-1) + damp * p

    b = b.double()
    x = torch.zeros_like(b)
    r = b
    z = (m @ r.reshape(n, 6, 1)).reshape(-1)
    p = z
    stop2 = rtol * rtol * torch.dot(b, b)
    rz = torch.dot(r, z)
    for _ in range(iters):
        if not bool(torch.dot(r, r) > stop2):
            break
        ap = mv(p)
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x, r = x + alpha * p, r - alpha * ap
        z = (m @ r.reshape(n, 6, 1)).reshape(-1)
        rz_n = torch.dot(r, z)
        p = z + rz_n / torch.clamp(rz, min=1e-30) * p
        rz = rz_n
    return x


def one_block_pcg(torch, kernels, ws, parent, out_dir, on):
    """The one-block PCG of ``parent``'s csrc/pcg.cu (its entry's
    signature: int32 ids converted here, no order, no cluster), built
    with the kernels' nvcc flags."""
    csrc = parent / "dynamicfusion_tpu_torch" / "csrc"
    so = out_dir / "libpcg_one_block.so"
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(so),
                          str(csrc / "pcg.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"one_block: nvcc failed\n{out.stdout}")
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.df_pcg.argtypes = [P] * 11 + [I] * 6 + [P, P, I, F, P, P, P, P]
    lib.df_pcg.restype = ctypes.c_int

    def run(s, sysm, ip, b, iters, rtol):
        e = sysm.edge
        n = b.shape[0] // 6
        np_, nr = sysm.rows.shape[:2]
        mode = kernels._row_mode(nr, sysm.used, sysm.stride)
        x = torch.empty_like(b)
        work = torch.empty((4 * 6 * n + max(np_ * nr, 1),), dtype=torch.float32, device=b.device)
        ts = (sysm.rows, s.knn_idx32, s.pts_by_node.order, s.pts_by_node.off, e.h_ii, e.h_jj, e.h_ij, s.e_dst32,
              s.edges_by_dst.order, s.edges_by_dst.off, sysm.damp)
        rc = lib.df_pcg(*(t.data_ptr() for t in ts), np_, n, s.e_dst.shape[0] // n, nr, *mode, ip.data_ptr(),
                        b.data_ptr(), iters, kernels._f32(rtol * rtol), on.data_ptr(), x.data_ptr(), work.data_ptr(),
                        kernels._stream(b.device))
        if rc != 0:
            raise RuntimeError(f"one_block: launch error {rc}")
        return x
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose csrc/pcg.cu holds the one-block PCG this kernel replaced (an unpacked "
                         "git archive of the parent commit): timed and held beside the variants")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_pcg_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    kernels.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory(dir=str(HERE / "build")) as tmp:
        builds = {name: build(kernels, name, subs, Path(tmp)) for name, subs in source_variants(sms).items()}
        libs = {name: bind(kernels, name, *b) for name, b in builds.items()}
        on = torch.ones((), dtype=torch.bool, device=dev)

        def lib_pcg(lib, shared):
            """``lib``'s PCG entry; p in shared memory (``shared``) where
            its own plan says it fits."""
            def run(s, sysm, ip, b, iters, rtol):
                ks = ws._kernel_system(s, sysm)
                ptrs, n_rows, n = kernels._system_args(ks)
                mode = kernels._row_mode(sysm.rows.shape[1], sysm.used, sysm.stride)
                plan = (ctypes.c_int * 4)()
                if shared and lib.df_pcg_plan(1, n, sysm.rows.shape[1], *mode, -1, plan) != 0:
                    raise RuntimeError("variant plan refused")
                x = torch.empty_like(b)
                work = torch.empty((5 * 6 * n + max(n_rows, 1),), dtype=torch.float32, device=dev)
                rc = lib.df_pcg(*ptrs, *mode, plan[2] if shared else 0, ip.data_ptr(), b.data_ptr(), iters,
                                kernels._f32(rtol * rtol), on.data_ptr(), x.data_ptr(), work.data_ptr(),
                                kernels._stream(dev))
                if rc != 0:
                    raise RuntimeError(f"variant launch error {rc}")
                return x
            return run

        variants = {"kernel": lib_pcg(kernels.load(), True)}
        for name, lib in libs.items():
            variants[name] = lib_pcg(lib, not name.startswith("grid"))
        if args.parent:
            variants["one_block"] = one_block_pcg(torch, kernels, ws, Path(args.parent), Path(tmp), on)
        times = {}
        for name, (s, sysm, ip, b, iters, rtol) in systems(torch, cs, dev).items():
            with cs.deterministic(torch):
                xp = ws.pcg(s, sysm, ip, b, iters, rtol, on, plain=True)
            probe = (ctypes.c_ulonglong * 5)()
            libs["probe"].df_probe(probe, 1)
            variants["probe"](s, sysm, ip, b, iters, rtol)
            torch.cuda.synchronize()
            libs["probe"].df_probe(probe, 1)
            ran = cs.pcg_iterations(torch, ws, s, sysm, ip, b, iters, rtol)
            print(f"[probe] {card} | {name}, {ran} iterations, us an iteration: "
                  + ", ".join(f"{k} {probe[i] / 1e3 / max(ran, 1):.2f}" for i, k in enumerate(("t", "Ap", "z", "p"))),
                  flush=True)
            x64 = pcg64(torch, ws, s, sysm, ip, b, iters, rtol)

            def rel(a, ref):
                return float((a.double() - ref.double()).abs().max()) / max(float(ref.double().abs().max()), 1e-30)

            with cs.deterministic(torch):
                spread = max(rel(ws.pcg(s, sysm, ip, b1, iters, rtol, on, plain=True), xp)
                             for b1 in cs.ulp_moves(torch, b))
                control = rel(cs.pcg_bf16_control(torch, ws, s, sysm, ip, b, iters, rtol), xp)
            tol = max(cs.TOL_PCG_REL, cs.SPREAD_PCG * spread)
            print(f"[hold] {name}: the plain PCG's one-ulp spread {spread:.2e} (the hold's tolerance {tol:.2e}), its "
                  f"distance from the float64 PCG {rel(xp, x64):.2e}; the bf16-vector control {control:.2e}",
                  flush=True)
            for v, fn in variants.items():
                x = fn(s, sysm, ip, b, iters, rtol)
                print(f"[hold] {name} {v}: max |diff| over max |x| {rel(x, xp):.2e} against the plain PCG (within the "
                      f"hold's tolerance {rel(x, xp) <= tol}), {rel(x, x64):.2e} against the float64 PCG; non-finite "
                      f"entries {int((~torch.isfinite(x)).sum())} (plain {int((~torch.isfinite(xp)).sum())}, float64 "
                      f"{int((~torch.isfinite(x64)).sum())})", flush=True)
            for rnd in range(args.rounds):
                line = []
                for v, fn in variants.items():
                    ms = cs.cuda_ms(torch, lambda: fn(s, sysm, ip, b, iters, rtol))
                    times.setdefault(f"{name}/{v}", []).append(ms)
                    line.append(f"{v} {ms:.4f}")
                print(f"[time] {card} | {name} round {rnd}: " + ", ".join(line) + " ms", flush=True)
    print(json.dumps({"card": card, "median_ms": {k: statistics.median(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
