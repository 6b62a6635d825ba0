"""The port's sharded frame step (parallel.sharded) on the CPU: the
dispatch of ``make_sharded_step`` over the JAX package's conditions, the
multi-process layout and collectives; and the configs, tolerances and
volume oracle of its holds (tests/test_torch_sharded_step_holds.py, a file
of their own so that ``--dist loadfile`` spreads them over the workers):
against the JAX package's single-device step at tests/test_sharding.py's
config (8 shards), against the port's own single-device step under the
dynamicfusion preset's settings at ``small()`` (4 shards: the slab
raycast, the slab brick fusion and the distributed PCG all in the path),
and two processes of two shards each over gloo against the one-process
mesh.

No JAX sharded program is compiled; the JAX pipeline step is compiled
once. The volume is held by the behavioural oracle of
tests/test_sharding.py:66-94: the warp solve's accept/reject compares
psum'd float32 costs whose shard summation order differs from the single
device's, so a thin band of voxels may fuse through a slightly different
field."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.models import volume as jvolume
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.config import Intrinsics as TIntr
from dynamicfusion_tpu_torch.parallel import multihost, sharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_POSE = 1e-4          # the step's pose against the single-device step's
TOL_VOL_OFF = 1e-3       # tsdf values (not codes) further apart than this ...
TOL_VOL_FRAC = 0.01      # ... on under this fraction of voxels
TOL_VOL_MEDIAN = 1e-5    # and the median difference
TOL_COST0_REL = 1e-4     # the solve's initial cost (the psum'd sums' order)
TOL_MAP_M = 1e-4         # the slab raycast's canonical maps against the whole one's on one field
TIMEOUT_S = 300          # the two-process run's own limit

# tests/test_sharding.py's config
SH = dataclasses.replace(
    JCfg(rows=32, cols=64, volume_dims=32, max_nodes=32, node_sample_step=5, solver_nonlinear_iters=2),
    intr=dataclasses.replace(JCfg().intr, fx=57.0, fy=57.0, cx=32.0, cy=16.0),
)
# the dynamicfusion preset's settings at small() (tests/torch_nonrigid_cases.py's slice)
SLICE = dict(solver_linear="pcg", solver_linear_iters=12, fusion_incidence_weight=True, fusion_incidence_floor=0.35,
             fusion_sdf_incidence_scale=True, raycast_temporal_band=True, raycast_refine="newton8")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tcfg(jc):
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    kw["intr"] = TIntr(*dataclasses.astuple(jc.intr))
    return TCfg(**kw)


def cpu_mesh(n):
    return sharded.make_mesh(n, devices=["cpu"] * n)


def hold_volume(got, ref):
    diff = np.abs(got.astype(np.float32) - ref.astype(np.float32)) / 32767.0
    assert float(np.mean(diff > TOL_VOL_OFF)) < TOL_VOL_FRAC
    assert float(np.median(diff)) < TOL_VOL_MEDIAN


def _jax_state(d):
    """The port's state as numpy -> the JAX package's PipelineState."""
    return jkinfu.PipelineState(
        vol=jvolume.TsdfVolume(**{k: jnp.asarray(v) for k, v in d["vol"].items()}),
        warp=jw.WarpField(**{k: jnp.asarray(v) for k, v in d["warp"].items()}),
        pose=jnp.asarray(d["pose"]),
        prev_points=tuple(map(jnp.asarray, d["prev_points"])),
        prev_normals=tuple(map(jnp.asarray, d["prev_normals"])),
        can_points=jnp.asarray(d["can_points"]), can_normals=jnp.asarray(d["can_normals"]),
        frame_idx=jnp.asarray(d["frame_idx"]),
    )


@pytest.mark.parametrize("name,kw,n,want", [
    ("preset", dict(), 4, dict(solve=True, system=False, eval=False, integrate=True, raycast=True, whole=False)),
    ("base", None, 4, dict(solve=False, system=True, eval=True, integrate=True, raycast=True, whole=False)),
    ("unlagged", dict(solver_lagged_jtj=False), 4,
     dict(solve=False, system=True, eval=False, integrate=True, raycast=True, whole=False)),
    ("rigid", dict(rigid_only=True), 4,
     dict(solve=False, system=False, eval=False, integrate=False, raycast=True, whole=True)),
    ("dense", dict(integrate_mode="dense"), 4,
     dict(solve=True, system=False, eval=False, integrate=False, raycast=True, whole=True)),
    ("thin", dict(), 32, dict(solve=True, system=False, eval=False, integrate=False, raycast=False, whole=True)),
    ("parity", "parity", 4, dict(solve=False, system=True, eval=True, integrate=True, raycast=True, whole=True)),
])
def test_dispatch_follows_the_jax_conditions(name, kw, n, want):
    """make_sharded_step picks its pieces by JAX ``sharded.py:77-133``'s
    static conditions (256^3: 64-plane slabs at 4 shards; 8 at 32, under
    the 18-plane halo and half a brick), and runs the volume whole where a
    piece has no sharded form (the rigid fusion, dense fusion, thin slabs,
    the coarse band of reference_parity())."""
    if kw is None:
        cfg = TCfg()
    elif kw == "parity":
        cfg = TCfg.reference_parity()
    else:
        cfg = dataclasses.replace(TCfg.default_dynamicfusion(), **kw)
    assert sharded.make_sharded_step(cfg, cpu_mesh(n)).pieces == want
    assert sharded.make_sharded_step(cfg, cpu_mesh(n), explicit_gn=False).pieces == dict(
        solve=False, system=False, eval=False, integrate=False, raycast=False, whole=True)


@pytest.mark.parametrize("kind, backend, local_rank, local_world, cards, want", [
    ("cpu", None, 1, 2, 0, ("gloo", None)),
    ("cuda", None, 3, 8, 8, ("nccl", 3)),         # torchrun's LOCAL_RANK picks the card, not the global rank
    ("cuda", "nccl", 0, 2, 2, ("nccl", 0)),
    ("cuda", "gloo", 1, 2, 1, ("gloo", 0)),       # ranks share the one card only when gloo is asked for
    ("cuda", "gloo", 5, 8, 4, ("gloo", 1)),
    ("cuda", None, 1, 2, 1, ValueError),          # two ranks, one card: refused, not gloo behind the caller's back
    ("cuda", "nccl", 0, 2, 1, ValueError),
    ("cpu", "nccl", 0, 1, 0, ValueError),
    ("cuda", None, 0, 1, 0, RuntimeError),        # no card: no fallback to the CPU
])
def test_choose_backend(kind, backend, local_rank, local_world, cards, want):
    """A rank's backend and card from its place on its host."""
    if isinstance(want, type):
        with pytest.raises(want):
            multihost.choose_backend(kind, backend, local_rank, local_world, cards)
    else:
        assert multihost.choose_backend(kind, backend, local_rank, local_world, cards) == want


def test_initialize_reads_the_host_layout(monkeypatch):
    """``initialize`` under torchrun on the second host of two, 8 cards
    each: global rank 11 is LOCAL_RANK 3 and runs NCCL on cuda:3; the same
    rank as the second of two ranks sharing one card is refused without
    ``backend='gloo'`` and takes cuda:0 with it."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("card", str(d))))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["world_size"], kw["rank"])))
    monkeypatch.setattr(multihost, "_LAYOUT", {})
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    multihost.initialize("env://", 16, 11, 2)
    assert calls == [("card", "cuda:3"), ("nccl", 16, 11)]
    assert multihost._LAYOUT == dict(local=2, device=torch.device("cuda", 3), backend="nccl")
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls.clear()
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize("tcp://localhost:1", 2, 1, 2)
    multihost.initialize("tcp://localhost:1", 2, 1, 2, backend="gloo")
    assert calls == [("card", "cuda:0"), ("gloo", 2, 1)]


# a rank of the test below; the mesh (which holds the process group) goes
# before multihost.shutdown, so that the group is freed there and not at
# the interpreter's exit
_RANKS_SCRIPT = """
import json, sys
import torch
import torch.distributed as dist
from dynamicfusion_tpu_torch.parallel import multihost
from dynamicfusion_tpu_torch.parallel.mesh import Mesh
store, world, rank, per, out = sys.argv[1:]
world, rank, per = int(world), int(rank), int(per)
dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
n = world * per
mesh = Mesh(["cpu"] * n, group=dist.group.WORLD, local=range(rank * per, (rank + 1) * per))
whole = torch.arange(n * 2 * 3, dtype=torch.int16).reshape(n * 2, 3) * 7 - 50
slabs = mesh.split(whole)
res = dict(halo=[t.tolist() for t in mesh.halo(slabs, 2)], whole=mesh.gather(slabs).tolist(),
           weight=mesh.gather(mesh.split(whole.view(torch.uint16))).view(torch.int16).tolist(),
           psum=float(mesh.psum([torch.tensor(float(k + 1)) for k in mesh.local])))
del mesh, slabs
multihost.shutdown()
json.dump(res, open(out, "w"))
"""


def test_mesh_collectives_across_ranks(tmp_path):
    """Three gloo ranks of two CPU shards each: the halo exchange (each
    rank's planes to its neighbours, wrapped at the ends) equals the
    one-process mesh's; the gather of int16 and uint16 slabs gives the
    whole; the psum sums every shard."""
    store, world, per = tmp_path / "store", 3, 2
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"r{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", _RANKS_SCRIPT, str(store), str(world), str(r), str(per), outs[r]],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = [json.loads(open(o).read()) for o in outs]
    n = world * per
    one = cpu_mesh(n)
    whole = torch.arange(n * 2 * 3, dtype=torch.int16).reshape(n * 2, 3) * 7 - 50
    halo = [t.tolist() for t in one.halo(one.split(whole), 2)]
    for r, got in enumerate(res):
        assert got["halo"] == halo[r * per: (r + 1) * per]
        assert got["whole"] == whole.tolist() and got["weight"] == whole.tolist()
        assert got["psum"] == n * (n + 1) / 2     # whole numbers: exact in any order
