"""Several processes over one mesh (port of
``dynamicfusion_tpu.parallel.multihost``; the worker ``main`` stands where
the JAX package has ``scripts/multihost_worker.py``).

Each process is a ``torch.distributed`` rank holding ``local_shards``
consecutive shards of the mesh, ordered by (rank, local shard), so that
neighbouring slabs stay in one process and the volume's halo exchange
crosses a process boundary at most (ranks - 1) times. Reductions run over
the local shards first and across the ranks second (``Mesh``), the
2-level order of a (host, chip) mesh.

Backends: gloo on the CPU; NCCL on cards, one card a rank, the card of
the rank's place on its host (``LOCAL_RANK``); gloo where the caller asks
for it, and only then may ranks share a card (NCCL refuses two ranks on
one device), every collective staged through host memory.

Run two ranks of two shards each on the CPU::

    python -m dynamicfusion_tpu_torch.parallel.multihost --init-method tcp://localhost:29511 \\
        --world-size 2 --rank 0 --local-shards 2 --device cpu &
    python -m dynamicfusion_tpu_torch.parallel.multihost --init-method tcp://localhost:29511 \\
        --world-size 2 --rank 1 --local-shards 2 --device cpu

or under ``torchrun --nproc-per-node 2 -m dynamicfusion_tpu_torch.parallel.multihost --init-method env://``
(with ``--backend gloo`` where the host has fewer cards than ranks).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional, Tuple

import torch

from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.parallel import sharded
from dynamicfusion_tpu_torch.parallel.mesh import Mesh

_LAYOUT = {}


def choose_backend(device_type: str, backend: Optional[str], local_rank: int, local_world: int,
                   n_cards: int) -> Tuple[str, Optional[int]]:
    """(backend, card index or None) of a rank: ``local_rank`` is its place
    among the ``local_world`` ranks on its host, ``n_cards`` the host's
    cards. NCCL (the default on cards) needs a card a rank on the host;
    ranks share cards under gloo only when the caller asks for gloo."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: expected gloo or nccl")
    if device_type != "cuda":
        if backend == "nccl":
            raise ValueError("NCCL runs on cards only")
        return "gloo", None
    if n_cards < 1:
        raise RuntimeError("initialize: no CUDA card; pass device='cpu' for the CPU")
    if not 0 <= local_rank < local_world:
        raise ValueError(f"local rank {local_rank} of {local_world} ranks on this host")
    if backend == "gloo":
        return "gloo", local_rank % n_cards
    if n_cards < local_world:
        raise ValueError(f"{local_world} ranks on this host share {n_cards} card(s): NCCL needs a card a rank; "
                         "pass backend='gloo' to share them")
    return "nccl", local_rank


def initialize(init_method: str, world_size: int, rank: int, local_shards: Optional[int] = None,
               device="cuda", backend: Optional[str] = None, local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None) -> None:
    """``torch.distributed.init_process_group`` for the pipeline's ranks
    (``choose_backend``). ``local_rank`` and ``local_world_size`` place the
    rank on its host: torchrun's ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    by default, else every rank on this host (``rank`` of
    ``world_size``). ``local_shards`` (default 1) is how many shards each
    rank holds; ``device`` the ranks' kind (the CPU only where asked)."""
    import torch.distributed as dist

    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = torch.device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" and torch.cuda.is_available() else 0
    backend, card = choose_backend(dev.type, backend, local_rank, local_world_size, n_cards)
    if card is not None:
        dev = torch.device("cuda", card)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    _LAYOUT.update(local=local_shards or 1, device=dev, backend=backend)


def make_global_mesh() -> Mesh:
    """One mesh over every rank's shards, ordered by (rank, local shard),
    each rank's shards on the device it chose (gathered from the ranks)."""
    import torch.distributed as dist

    if not _LAYOUT:
        raise RuntimeError("make_global_mesh: call initialize first")
    world, rank, per = dist.get_world_size(), dist.get_rank(), _LAYOUT["local"]
    where = [None] * world
    dist.all_gather_object(where, str(_LAYOUT["device"]))
    devices = [torch.device(d) for d in where for _ in range(per)]
    return Mesh(devices, group=dist.group.WORLD, local=range(rank * per, (rank + 1) * per))


def make_host_chip_mesh() -> Mesh:
    """The JAX package's name for the (host, chip) mesh, kept for a reader
    who looks for it: ``make_global_mesh``'s mesh, whose reductions already
    run over a rank's local shards first and across the ranks second."""
    return make_global_mesh()


def shard_state(cfg: DynamicFusionConfig, mesh: Mesh, state):
    """The JAX package's name, kept for a reader who looks for it:
    ``sharded.shard_state`` of a replicated state (every rank holds the
    same) over the global mesh, each rank keeping its own slabs."""
    return sharded.shard_state(cfg, mesh, state)


def worker_config(name: str) -> DynamicFusionConfig:
    """The worker's configurations: "small", the JAX package's multi-process
    worker's (``small(64, 96, 128)`` with the preset's PCG, one LM
    iteration, short ICP); "preset", ``default_dynamicfusion()`` at full
    width."""
    if name == "preset":
        return DynamicFusionConfig.default_dynamicfusion()
    if name == "small":
        return dataclasses.replace(
            DynamicFusionConfig.small(dims=64, rows=96, cols=128), max_nodes=128, node_sample_step=5,
            solver_nonlinear_iters=1, icp_iters=(2, 1, 1, 0), solver_linear="pcg",
        )
    raise ValueError(f"unknown worker config {name!r}")


def run_frames(cfg: DynamicFusionConfig, mesh: Mesh, frames: int, plain: bool = False):
    """Frame 0 replicated, then ``frames`` sharded steps of bench.py's
    deforming scene: per step (pose (16,), initial cost, final cost), as
    Python floats (exact float32 values)."""
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.pipeline import kinfu

    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, frames + 1)
    dev = mesh.device
    first = sharded.make_sharded_first_frame(cfg, mesh, plain)
    step = sharded.make_sharded_step(cfg, mesh, plain=plain)
    state = first(kinfu.init_state(cfg, dev), torch.from_numpy(depths[0]).to(dev))
    out = []
    for d in depths[1:]:
        state, o = step(state, torch.from_numpy(d).to(dev))
        out.append(dict(pose=[float(v) for v in o.pose.reshape(-1).tolist()], cost0=float(o.solver_cost0),
                        cost1=float(o.solver_cost1), icp_ok=bool(o.icp_ok)))
    return out


def shutdown() -> None:
    """Leave the process group: every rank waits at a barrier (none tears
    its end down while a peer is still in a collective), then the group is
    destroyed. Drop every ``Mesh`` over the group first: a group that a
    live object still holds is only freed when the interpreter exits, and
    gloo's threads torn down there abort the process ("terminate called
    without an active exception") after its work is done."""
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _run_rank(args, rank: int, world: int) -> dict:
    """This rank's frames over the global mesh; the mesh is freed on
    return."""
    mesh = make_global_mesh()
    t0 = time.perf_counter()
    frames = run_frames(worker_config(args.config), mesh, args.frames)
    return dict(rank=rank, world=world, shards=mesh.n, backend=_LAYOUT["backend"], device=str(mesh.device),
                seconds=time.perf_counter() - t0, frames=frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--init-method", default="env://", help="tcp://HOST:PORT, file:///PATH, or env:// (torchrun)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: gloo on the CPU, NCCL on cards (a card a rank); gloo lets ranks share a card")
    ap.add_argument("--config", default="small", choices=("small", "preset"))
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out", default=None, help="write this rank's JSON result here")
    args = ap.parse_args(argv)
    world = args.world_size if args.world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    rank = args.rank if args.rank is not None else int(os.environ.get("RANK", "0"))
    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize(args.init_method, world, rank, args.local_shards, device=args.device, backend=args.backend)
    import torch.distributed as dist

    try:
        line = json.dumps(_run_rank(args, rank, world))
    except BaseException:
        dist.destroy_process_group()
        raise
    shutdown()
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print("MULTIHOST_OK " + line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
