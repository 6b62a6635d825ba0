"""The distributed PCG's design choices timed on the card.

Kernel G's distributed PCG (``csrc/pcg.cu`` ``sharded_pcg_kernel``, entry
``df_sharded_pcg``): the whole solve as one launch of a cluster of 16 CTAs
with p in every CTA's shared memory, beside the same source built with 4
and 8 CTAs a cluster (``cluster4``, ``cluster8``: each CTA then holds 8 or
4 of kernel P's 32 warps and owns 256 or 128 of every 1 024 nodes), p in
device memory (``device_p``, the wrapper's ``shared_p=False``), the
two-launch mode of a process group with the identity as the ranks' sum
(``two_launch``: the launches alone, no collective), the composition it
replaced (``composition``, the reference mode: G's data-only matvec a
shard, the psum's adds, G's edge step and P's one-block update, ~157
device kernels), the plain version and the same iterations in PyTorch
calls (``library``: cuSPARSE CSR products, the psum, ``torch.bmm``,
``torch.dot``). Shape: the sharded preset's solve (``default_dynamicfusion()``
after three frames of the deforming scene, the next frame's 3 200 points
cut into 4 shards of 800 over 1 024 nodes, 12 iterations), and the same
system cut into 2 and 8 shards.

    python3 scripts/torch_sharded_pcg_variants.py [--rounds 3] [--runs 2]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the source: edit both
together; check them on the CPU with ``check_anchors()``) and launched
through the port's wrapper with the variant's library in place. Each
variant is held bit for bit against the kernel; one that differs is
reported and not timed, and the script then exits 1. Times by
``chip_smoke.cuda_ms`` (CUDA events, 20 calls); the variants take turns,
``--rounds`` times, in each of ``--runs`` runs, the order reversed from one
run to the next. Prints the card (name and power limit), each variant's
registers and spills, each run's median with the spread between the runs'
medians, and a JSON line of every run's medians.
"""

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

_CLUSTER = "constexpr int kSpCluster = 16;    // CTAs a cluster (non-portable above 8)"
VARIANTS = {f"cluster{c}": [("pcg.cu", _CLUSTER, f"constexpr int kSpCluster = {c};")] for c in (4, 8)}


def check_anchors(csrc=HERE / "dynamicfusion_tpu_torch" / "csrc"):
    """Every variant's anchors occur once in their sources (no card needed)."""
    for name, subs in VARIANTS.items():
        for f, a, _ in subs:
            if (csrc / f).read_text().count(a) != 1:
                raise RuntimeError(f"{name}: anchor not found once in {f}: {a!r}")


@contextlib.contextmanager
def library(kernels, lib, plans):
    """The port's wrappers launch from ``lib``, with its own cluster plans,
    inside the block."""
    prev, prev_plans = kernels._lib, kernels._SHARDED_PLANS
    kernels._lib, kernels._SHARDED_PLANS = lib, plans
    try:
        yield
    finally:
        kernels._lib, kernels._SHARDED_PLANS = prev, prev_plans


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant in a run")
    ap.add_argument("--runs", type=int, default=2, help="runs, the variants' order reversed from one to the next")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_sharded_pcg_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE / "scripts"))
    import chip_smoke as cs
    from torch_data_term_variants import bind, build, median, turns
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import warp_solver as ws

    check_anchors()
    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="sharded_pcg_variants_"))
    procs = {name: build(kernels, name, "pcg.cu", subs, tmp) for name, subs in VARIANTS.items()}
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and "sharded_pcg" in ln:
                props = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                         if "registers" in x or "spill" in x]
                print(f"[ptxas] {name}: {ln.split(chr(39))[1] if chr(39) in ln else ln}: " + " | ".join(props),
                      flush=True)
        libs[name] = bind(kernels, so, ["df_sharded_pcg_plan", "df_sharded_pcg"])

    dev = torch.device("cuda")
    cfg = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 5)
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[3]).to(dev))
    s = ws.prepare(cfg, st.warp, tr.inputs)
    dt = ws.data_term(cfg, s, st.warp.dq, True)
    et = ws.edge_term(cfg, s, st.warp.dq)
    blocks = dt.blocks + et.diag
    diag_eff, unit = ws.damping_terms(cfg, st.warp.active, blocks)
    damp = cfg.solver_lm_lambda_init * diag_eff + unit
    # the float64 inverse of the damped blocks, as chip_smoke.py's hold takes
    # it (the closed form is not finite on some nearly singular blocks)
    minv = torch.linalg.inv((blocks + torch.diag_embed(damp.reshape(-1, 6))).double()).float().contiguous()
    b = dt.jtr + et.jtr
    iters, rtol = cfg.solver_linear_iters, cfg.solver_linear_tol
    on = torch.ones((), dtype=torch.bool, device=dev)
    times, bad = {}, []

    def timed(tag, calls):
        """Every call's median in each run, printed with their spread."""
        names = list(calls)
        runs = []
        for k in range(args.runs):
            order = names if k % 2 == 0 else names[::-1]
            runs.append(turns(cs, torch, {name: calls[name] for name in order}, args.rounds))
        times[tag] = {name: [median(r[name]) for r in runs] for name in names}
        for k, r in enumerate(runs):
            print(f"[round] {card} | {tag}, run {k}: " + ", ".join(
                f"{name} {' '.join(f'{t:.4f}' for t in r[name])}" for name in names), flush=True)
        print(f"[time] {card} | {tag}, medians of the runs (spread): " + ", ".join(
            f"{name} {' / '.join(f'{m:.4f}' for m in times[tag][name])} ms "
            f"({(max(times[tag][name]) - min(times[tag][name])) / min(times[tag][name]):.1%})" for name in names),
            flush=True)

    for n_shards in (4, 2, 8):
        mesh = sharded.make_mesh(n_shards, devices=[dev] * n_shards)
        parts = distributed_gn.shard_structure(s, mesh)
        chunk = parts[0].p_can.shape[0]
        pad = torch.zeros((chunk * n_shards - dt.rows.shape[0], *dt.rows.shape[1:]), dtype=dt.rows.dtype,
                          device=dev)
        cut = [r.contiguous() for r in torch.cat([dt.rows, pad]).split(chunk)]
        shards = [ws.Shard(sk, r) for sk, r in zip(parts, cut)]
        sysm = ws.System(cut[0], et, damp)
        ks = ws._kernel_system(s, sysm)
        data = [kernels.ShardData(q.rows, q.s.knn_idx32, q.s.pts_by_node.order, q.s.pts_by_node.off,
                                  ws.heavy_order(q.s.pts_by_node)) for q in shards]

        def solve(**kw):
            return kernels.pcg_sharded(ks, data, minv, b, iters, rtol, on, **kw)

        ref = solve()
        calls = {"kernel": solve}
        for name, lib in libs.items():
            plans = {}

            def call(lib=lib, plans=plans):
                with library(kernels, lib, plans):
                    return solve()

            if not cs.same_bits(torch, call(), ref):
                print(f"{n_shards} shards: {name} differs from the kernel: not timed", file=sys.stderr)
                bad.append(f"{name} ({n_shards} shards)")
                continue
            calls[name] = call
        checks = {"device_p": lambda: solve(shared_p=False), "two_launch": lambda: solve(reduce=lambda v: v),
                  "composition": lambda: ws.pcg_sharded(mesh, shards, s, sysm, minv, b, iters, rtol, on,
                                                        reference=True)}
        for name, fn in checks.items():
            if not cs.same_bits(torch, fn(), ref):
                print(f"{n_shards} shards: {name} differs from the kernel: not timed", file=sys.stderr)
                bad.append(f"{name} ({n_shards} shards)")
                continue
            calls[name] = fn
        calls["plain"] = lambda: ws.pcg_sharded(mesh, shards, s, sysm, minv, b, iters, rtol, on, plain=True)
        csrs = [cs.factored_csr(torch, ws, q.s, sysm._replace(rows=q.rows), edges=False) for q in shards]
        edges_csr = cs.factored_csr(torch, ws, shards[0].s, sysm)[2]
        calls["library"] = lambda: cs.library_pcg_sharded(torch, mesh, csrs, edges_csr, minv, b, iters, rtol, on)
        timed(f"{n_shards} shards of {chunk} points, {minv.shape[0]} nodes, {iters} iterations", calls)
    print(json.dumps({"card": card, "median_ms_by_run": times, "differ": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
