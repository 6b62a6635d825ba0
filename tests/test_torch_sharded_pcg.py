"""The distributed PCG's plain route and kernel H's apply pass against the
JAX package on the CPU (the card's kernels are held bit for bit against
these plain versions in tests/test_torch_cuda.py and chip_smoke.py).

- ``warp_solver.pcg_sharded`` over a CPU mesh of 1, 2 and 4 shards whose
  rows are cut from one system, against the JAX package's ``_pcg`` with
  its factored matvec (``warp_solver.py:1228-1240``: the two bf16 products
  of the D-major row matrix, ``edge_matvec``, the damping) on that whole
  system, and against the port's single-device ``pcg``.
- ``warpfield._insert_apply_plain`` against the JAX package's delta
  scatter (``models/warpfield.py:433-445``) with no new node, some, and
  every slot filled.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.config import Intrinsics as TIntr
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded
from dynamicfusion_tpu_torch.parallel.mesh import Mesh
from dynamicfusion_tpu_torch.solvers import warp_solver as ts
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ITERS, RTOL = 12, 1e-3
# the distributed PCG against the port's single-device PCG: float32 sums
# of the same terms in another order (the shards' psum, the kernels' dot
# order), relative to the largest entry of x (as tests/test_torch_parallel.py
# holds one shard)
TOL_PORT = 1e-6
# against JAX's PCG: besides the sum orders, XLA's dot sums each t's 48
# products in its own order before the bf16 rounding, relative to the
# largest entry of x
TOL_JAX = 1e-5

# tests/test_torch_parallel.py's Gauss-Newton problem: the 8 corners of a
# cube as nodes, 48 seeded points shifted off them, point-to-point rows
CUBE = np.array([[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
                 [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1]], np.float32)
JC = JCfg(volume_dims=64, max_nodes=16, node_sample_step=1, node_radius=3.0, knn_k=8, solver_nonlinear_iters=6,
          solver_linear_iters=ITERS, solver_linear_tol=RTOL, solver_tukey_c=10.0, solver_huber_delta=10.0,
          solver_arap_weight=1e-4, point_to_plane=False, knn_method="exact", solver_linear="pcg")


def _tcfg(jc):
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    kw["intr"] = TIntr(*dataclasses.astuple(jc.intr))
    return TCfg(**kw)


TC = _tcfg(JC)


@pytest.fixture(scope="module")
def system():
    """The port's factored system of one LM iteration: (structure, System,
    minv, b)."""
    rng = np.random.default_rng(0)
    can = rng.uniform(-0.8, 0.8, (48, 3)).astype(np.float32)
    live = can + np.asarray((0.03, -0.02, 0.04), np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (48, 1))
    field = jw.init_from_cloud(JC, jnp.asarray(CUBE), jnp.ones(8, bool))
    tfield = tw.WarpField(*(torch.from_numpy(np.array(a)) for a in field))
    ti = ts.WarpSolveInputs(*(torch.from_numpy(a.copy()) for a in (can, nrm, live, nrm)))
    s = ts.prepare(TC, tfield, ti)
    dt = ts.data_term(TC, s, tfield.dq, True)
    et = ts.edge_term(TC, s, tfield.dq)
    blocks = dt.blocks + et.diag
    diag_eff, unit = ts.damping_terms(TC, tfield.active, blocks)
    damp = 1e-3 * diag_eff + unit
    minv = ts.spd6_inv(blocks + torch.diag_embed(damp.reshape(-1, 6)))
    return s, ts.System(dt.rows, et, damp), minv, dt.jtr + et.jtr


def _shards(s, rows, n):
    """The mesh of n CPU shards and each shard's structure with its rows
    cut from the whole system's (the padded points' rows zero)."""
    mesh = sharded.make_mesh(n, devices=["cpu"] * n)
    parts = distributed_gn.shard_structure(s, mesh)
    chunk = parts[0].p_can.shape[0]
    pad = torch.zeros((chunk * n - rows.shape[0], *rows.shape[1:]), dtype=rows.dtype)
    return mesh, [ts.Shard(sk, r) for sk, r in zip(parts, torch.cat([rows, pad]).split(chunk))]


def _jax_pcg(s, sysm, minv, b):
    """JAX's ``_pcg`` over its factored matvec, on the port's system."""
    n = minv.shape[0]
    dense = ts.dense_rows(sysm.rows, s.knn_idx, n).numpy()
    # D-major columns: node-major column 6 node + d is d N + node
    rows = jnp.asarray(dense.reshape(-1, n, 6).transpose(0, 2, 1).reshape(-1, 6 * n)).astype(jnp.bfloat16)
    e = sysm.edge
    structure = types.SimpleNamespace(e_src=jnp.asarray(s.e_src.numpy()), e_dst=jnp.asarray(s.e_dst.numpy()))
    eb = dict(h_ii=jnp.asarray(e.h_ii.numpy()), h_jj=jnp.asarray(e.h_jj.numpy()), h_ij=jnp.asarray(e.h_ij.numpy()),
              oh_d=jax.nn.one_hot(structure.e_dst, n, dtype=jnp.float32))
    damp = jnp.asarray(sysm.damp.numpy())

    def mv(p):
        pd = p.reshape(n, 6).T.reshape(-1)
        t = jnp.dot(rows, pd.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        apd = jnp.dot(t.astype(jnp.bfloat16), rows, preferred_element_type=jnp.float32)
        return apd.reshape(6, n).T.reshape(-1) + js.edge_matvec(structure, eb, p, n) + damp * p

    return np.asarray(jax.jit(lambda m, v: js._pcg(mv, m, v, n, ITERS, RTOL))(jnp.asarray(minv.numpy()),
                                                                              jnp.asarray(b.numpy())))


@pytest.mark.parametrize("n_shards", [1, 2, 4, 9, 16])
def test_sharded_pcg_plain_matches_jax_and_the_single_device_pcg(system, n_shards):
    """The distributed PCG's plain route (the kernels' sum orders) over 1,
    2, 4, 9 and 16 CPU shards against JAX's PCG on the whole system and
    against the port's single-device PCG; an inactive solve gives zeros."""
    s, sysm, minv, b = system
    mesh, shards = _shards(s, sysm.rows, n_shards)
    on = torch.tensor(True)
    got = ts.pcg_sharded(mesh, shards, s, sysm, minv, b, ITERS, RTOL, on)
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.0
    scale = float(got.abs().max())
    one = ts.pcg(s, sysm, minv, b, ITERS, RTOL, on)
    assert float((got - one).abs().max()) <= TOL_PORT * scale
    ref = _jax_pcg(s, sysm, minv, b)
    assert float(np.abs(got.numpy() - ref).max()) <= TOL_JAX * scale
    assert not bool(ts.pcg_sharded(mesh, shards, s, sysm, minv, b, ITERS, RTOL, ~on).any())


@pytest.mark.parametrize("n", [1, 2, 4, 8, 9, 16])
def test_sharded_pcg_one_launch_only_up_to_max_shards(n):
    """``pcg_sharded`` takes kernel G's one launch for a one-process mesh
    only at n <= MAX_SHARDS local shards on the solve's device (the
    launch's parameter block holds that many, csrc/pcg.cu kMaxShards); the
    composition above it, and wherever a local shard sits elsewhere."""
    cpu = torch.device("cpu")
    assert kernels.MAX_SHARDS == 8
    assert ts.sharded_one_launch(sharded.make_mesh(n, devices=["cpu"] * n), cpu) == (n <= kernels.MAX_SHARDS)
    if n > 1:
        assert not ts.sharded_one_launch(Mesh(["cpu"] * (n - 1) + ["meta"]), cpu)


def _jax_delta_scatter(field, slots, new_pos, seed_dq, new_radius, fi):
    """The JAX package's delta scatter of ``_insert_nodes_impl``
    (models/warpfield.py:433-445), with its ok flags folded into the
    sentinel slots (slots[r] = cap where rank r inserts nothing)."""
    cap = field.positions.shape[0]
    idx_safe = slots.clip(0, cap - 1)
    upd_mask = slots < cap
    positions = field.positions.at[idx_safe].add(
        jnp.where(upd_mask[:, None], new_pos - field.positions[idx_safe], 0.0))
    dq = field.dq.at[idx_safe].add(jnp.where(upd_mask[:, None], seed_dq - field.dq[idx_safe], 0.0))
    radius = field.radius.at[idx_safe].add(jnp.where(upd_mask, new_radius - field.radius[idx_safe], 0.0))
    active = field.active.at[idx_safe].max(upd_mask)
    count = field.count + jnp.sum(upd_mask.astype(jnp.int32))
    last_support = field.last_support.at[idx_safe].add(jnp.where(upd_mask, fi - field.last_support[idx_safe], 0))
    return jw.WarpField(positions, dq, radius, active, count, last_support)


@pytest.mark.parametrize("case", ["none", "partial", "full"])
def test_insert_apply_plain_matches_jax_delta_scatter(case):
    """No new node (every slot the sentinel), some new nodes into the free
    slots of a half-full field (the other ranks the sentinel), and every
    slot of an empty field filled: the plain apply equals JAX's delta
    scatter in every field, the sentinels writing nothing."""
    cap = 96
    rng = np.random.RandomState(11)
    active = {"none": rng.rand(cap) < 0.5, "partial": rng.rand(cap) < 0.5, "full": np.zeros(cap, bool)}[case]
    free = np.flatnonzero(~active)
    k = {"none": 0, "partial": len(free) // 2, "full": cap}[case]
    slots = np.full(cap, cap, np.int64)
    ranks = np.sort(rng.choice(cap, k, replace=False)) if case == "partial" else np.arange(k)
    slots[ranks] = free[:k]
    arrays = dict(
        positions=rng.randn(cap, 3).astype(np.float32), dq=rng.randn(cap, 8).astype(np.float32),
        radius=rng.rand(cap).astype(np.float32), active=active, count=np.int32(active.sum()),
        last_support=rng.randint(0, 40, cap).astype(np.int32),
    )
    new_pos, seed_dq = rng.randn(cap, 3).astype(np.float32), rng.randn(cap, 8).astype(np.float32)
    new_radius, fi = rng.rand(cap).astype(np.float32), np.int32(57)
    jf = jw.WarpField(**{k_: jnp.asarray(v) for k_, v in arrays.items()})
    ref = _jax_delta_scatter(jf, jnp.asarray(slots), jnp.asarray(new_pos), jnp.asarray(seed_dq),
                             jnp.asarray(new_radius), jnp.asarray(fi))
    tf = tw.WarpField(**{k_: torch.from_numpy(np.array(v)) for k_, v in arrays.items()})
    got = tw._insert_apply_plain(tf, tw.InsertPlan(torch.from_numpy(slots), torch.from_numpy(new_pos)),
                                 torch.from_numpy(seed_dq), torch.tensor(fi), torch.from_numpy(new_radius))
    for name, a, b in zip(tw.WarpField._fields, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got.count) == int(active.sum()) + k
    untouched = np.ones(cap, bool)
    untouched[slots[slots < cap]] = False
    np.testing.assert_array_equal(got.positions.numpy()[untouched], arrays["positions"][untouched])
