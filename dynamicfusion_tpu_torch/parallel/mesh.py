"""The port's device mesh: shards, their devices and the collectives that
join them (the stand-in for ``jax.sharding.Mesh`` with ``shard_map``'s
``psum``, ``pmin``, ``pmax`` and ``ppermute``; the JAX package has no
module of its own for it).

A ``Mesh`` has n shards, each on a ``torch.device``; a device may repeat
(n shards on one card, or on the CPU). ``mesh.local`` lists the shard
indices this process holds: all n in one process, or under a
``torch.distributed`` group the shards of this rank (several a rank, as
JAX's processes hold several devices). A sharded value is a tuple with one
tensor per local shard, in ``mesh.local`` order; a replicated value is one
tensor on ``mesh.device`` (the first local shard's), computed once a
process and copied to another device only where a shard there reads it
(``replicate``). On one card the copy is the tensor itself.

Reductions run in a fixed order, so a run repeats bit for bit: in one
process a pairwise tree over the shard index, ((s0 + s1) + (s2 + s3)); under
a group the local shards' tree first, then ``torch.distributed.all_reduce``
across the ranks. With two ranks of two shards each that is the same tree
(a + b is the same float in either order), so a two-process run equals the
one-process mesh bit for bit. Gloo takes CUDA tensors only for
``broadcast`` and ``all_reduce``, and two ranks on one card must use gloo
(NCCL refuses them): under gloo every collective stages its tensor
through host memory, explicitly. Across ranks the halo exchange sends
each neighbour its planes (``batch_isend_irecv``, two messages a rank
whatever the shard count), and a gather is one ``all_gather`` of the
ranks' slabs as bytes.

No fallback hides a device: a mesh on CUDA devices without a card raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from dynamicfusion_tpu_torch.models.volume import TsdfVolume


class SlabVolume(NamedTuple):
    """The volume split on x into n slabs of D/n planes: the local shards'
    (D/n, D, D) tsdf and weight slabs, in ``mesh.local`` order."""

    tsdf: Tuple[torch.Tensor, ...]
    weight: Tuple[torch.Tensor, ...]


def _tree(xs: Sequence[torch.Tensor], op: Callable) -> torch.Tensor:
    """Reduce pairwise in index order: ((x0 op x1) op (x2 op x3)) ..."""
    xs = list(xs)
    while len(xs) > 1:
        xs = [op(xs[i], xs[i + 1]) if i + 1 < len(xs) else xs[i] for i in range(0, len(xs), 2)]
    return xs[0]


class Mesh:
    """``n`` shards on ``devices``; ``group`` a ``torch.distributed`` process
    group (or ``torch.distributed.group.WORLD``) whose rank holds the shards
    ``local`` (consecutive, in rank order); None for one process holding
    every shard."""

    def __init__(self, devices: Sequence, group=None, local: Optional[Sequence[int]] = None):
        devices = [torch.device(d) for d in devices]
        if len(devices) < 1:
            raise ValueError("a mesh needs at least one shard")
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("a mesh on CUDA devices needs a CUDA card; ask for the CPU explicitly")
        # "cuda" is the current card, by index (tensors report theirs)
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in devices
        )
        self.n = len(self.devices)
        self.group = group
        if group is None:
            if local is not None and tuple(local) != tuple(range(self.n)):
                raise ValueError("one process holds every shard of a mesh without a group")
            self.local = tuple(range(self.n))
            self._comm = None
        else:
            import torch.distributed as dist

            if local is None:
                raise ValueError("a mesh over a process group needs this rank's shards")
            self.local = tuple(local)
            per = len(self.local)
            world = dist.get_world_size(group)
            if per * world != self.n or self.local != tuple(range(dist.get_rank(group) * per, (dist.get_rank(group) + 1) * per)):
                raise ValueError(f"rank {dist.get_rank(group)} of {world}: shards {self.local} do not tile {self.n}")
            # gloo: collectives through host memory; NCCL: on the card
            self._comm = torch.device("cpu") if dist.get_backend(group) == "gloo" else self.devices[self.local[0]]
        self.device = self.devices[self.local[0]]

    def __repr__(self) -> str:
        where = "one process" if self.group is None else f"shards {self.local} of this rank"
        return f"Mesh(n={self.n}, devices={[str(d) for d in self.devices]}, {where})"

    # ------------------------------------------------------------ placement

    def replicate(self, t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """A replicated value on each local shard's device: one copy per
        distinct device (the tensor itself on its own device)."""
        copies: Dict[torch.device, torch.Tensor] = {}
        out = []
        for k in self.local:
            dev = self.devices[k]
            if dev not in copies:
                copies[dev] = t if t.device == dev else t.to(dev)
            out.append(copies[dev])
        return tuple(out)

    # ------------------------------------------------------------ collectives

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        dtype = t.dtype
        buf = t.to(self._comm, dtype=torch.int32 if dtype == torch.bool else dtype, copy=True)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(self.device, dtype=dtype)

    def _reduce(self, xs: Sequence[torch.Tensor], op: Callable, dist_op: str) -> torch.Tensor:
        if len(xs) != len(self.local):
            raise ValueError(f"expected {len(self.local)} local shards' values, got {len(xs)}")
        out = _tree([x.to(self.device) for x in xs], op)
        if self.group is not None:
            import torch.distributed as dist

            out = self._all_reduce(out, getattr(dist.ReduceOp, dist_op))
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard, replicated (a fixed tree)."""
        return self._reduce(xs, torch.add, "SUM")

    def psum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """The sum across the ranks of one value a rank, already summed over
        its local shards (``psum``'s second step; the value itself without
        a group)."""
        if self.group is None:
            return t
        import torch.distributed as dist

        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmin(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self._reduce(xs, torch.minimum, "MIN")

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self._reduce(xs, torch.maximum, "MAX")

    def _gather_ranks(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's ``parts`` entry (same shape and dtype on each), on
        this process's device: the local ones as they are, the other ranks'
        through one ``all_gather`` of each rank's stacked parts as bytes
        (exact for any dtype)."""
        if self.group is None:
            return [p.to(self.device) for p in parts]
        import torch.distributed as dist

        dtype = parts[0].dtype
        mine = torch.stack([p.to(self._comm) for p in parts]).contiguous().view(torch.uint8)
        bufs = [torch.empty_like(mine) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(bufs, mine, group=self.group)
        every = torch.cat(bufs).view(dtype)
        return [every[k].to(self.device) for k in range(self.n)]

    def _peer(self, r: int) -> int:
        import torch.distributed as dist

        return r if self.group is dist.group.WORLD else dist.get_global_rank(self.group, r)

    def halo(self, slabs: Sequence[torch.Tensor], h: int) -> Tuple[torch.Tensor, ...]:
        """Each local shard's slab extended by ``h`` planes of its
        neighbours on either side (the two ``ppermute``s of JAX
        ``parallel/sharded_raycast.py:176-186``): the previous shard's last
        planes, the slab, the next shard's first planes. Edge shards receive
        the wrapped planes, which a global clip never reads. Across ranks
        each rank sends its last planes to the next rank and its first
        planes to the previous one."""
        by = dict(zip(self.local, slabs))
        firsts = {k: by[k][:h] for k in self.local}
        lasts = {k: by[k][-h:] for k in self.local}
        lo, hi = self.local[0], self.local[-1]
        if len(self.local) < self.n:
            import torch.distributed as dist

            rank, world = dist.get_rank(self.group), dist.get_world_size(self.group)
            prv, nxt = self._peer((rank - 1) % world), self._peer((rank + 1) % world)
            send_last, send_first = lasts[hi].to(self._comm).contiguous(), firsts[lo].to(self._comm).contiguous()
            from_prev, from_next = torch.empty_like(send_last), torch.empty_like(send_first)
            # a rank's two messages to one peer (two ranks) match in this order
            for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send_last, nxt, self.group, tag=0),
                dist.P2POp(dist.isend, send_first, prv, self.group, tag=1),
                dist.P2POp(dist.irecv, from_prev, prv, self.group, tag=0),
                dist.P2POp(dist.irecv, from_next, nxt, self.group, tag=1),
            ]):
                req.wait()
            lasts[(lo - 1) % self.n] = from_prev
            firsts[(hi + 1) % self.n] = from_next
        out = []
        for k, s in zip(self.local, slabs):
            prv_planes = lasts[(k - 1) % self.n].to(s.device)
            nxt_planes = firsts[(k + 1) % self.n].to(s.device)
            out.append(torch.cat([prv_planes, s, nxt_planes], dim=0))
        return tuple(out)

    # ------------------------------------------------------------ the volume

    def split(self, whole: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The local shards' x-slabs of a replicated (D, ...) tensor: views
        where the shard's device is the tensor's."""
        d = whole.shape[0]
        if d % self.n:
            raise ValueError(f"{d} planes do not split into {self.n} slabs")
        dl = d // self.n
        return tuple(whole[k * dl:(k + 1) * dl].to(self.devices[k]) for k in self.local)

    def gather(self, slabs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole (D, ...) tensor from every shard's slab, on
        ``mesh.device``."""
        return torch.cat(self._gather_ranks(list(slabs)))

    def slabs(self, vol) -> SlabVolume:
        """The volume as slabs (a ``TsdfVolume`` is split, views on its own
        device)."""
        if isinstance(vol, SlabVolume):
            return vol
        return SlabVolume(self.split(vol.tsdf), self.split(vol.weight))

    def whole(self, vol) -> TsdfVolume:
        """The volume gathered (a ``TsdfVolume`` as it is)."""
        if isinstance(vol, SlabVolume):
            return TsdfVolume(self.gather(vol.tsdf), self.gather(vol.weight))
        return vol
