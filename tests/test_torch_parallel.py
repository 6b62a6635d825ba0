"""The port's parallel/ modules against the JAX package, on the CPU: the
mesh's collectives, the slab raycast (kernel C's slab mode, plain), the
slab brick fusion (K and D's slab modes, plain), the sharded assembly and
the distributed PCG solve, and checkpoints restored onto a mesh.

No JAX sharded program is compiled here: each port function over a mesh of
CPU shards is held against the JAX package's single-device function under
the equivalence that the JAX package's own sharded tests prove
(tests/test_sharded_raycast.py, test_sharded_fusion.py,
test_distributed_gn.py), at their tolerances. Inputs are made with numpy
from seeds."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import dualquat as jdq
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.io import synthetic as jsyn
from dynamicfusion_tpu.models import volume as jvolume
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.ops import fusion as jfusion
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu.ops import tsdf as jtsdf
from dynamicfusion_tpu.parallel import sharded_raycast as jsr
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu.utils import checkpoint as jckpt
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.config import Intrinsics as TIntr
from dynamicfusion_tpu_torch.models import volume as tvolume
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.models.warpfield import WarpField
from dynamicfusion_tpu_torch.ops import fusion as tfusion
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf
from dynamicfusion_tpu_torch.parallel import distributed_gn, sharded, sharded_fusion, sharded_raycast
from dynamicfusion_tpu_torch.parallel.mesh import Mesh, SlabVolume
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from dynamicfusion_tpu_torch.solvers import warp_solver as ts
from dynamicfusion_tpu_torch.utils import checkpoint as tckpt

# the JAX package's sharded tests' bars
TOL_RC_M = 1e-4          # raycast points (m) where both hit; the hit sets equal
TOL_RC_NRM_Q999 = 1e-3   # the 0.999 quantile of the normals' difference
TOL_FUSE_LSB = 1         # tsdf codes; band and wide counts equal; weights equal, but within
TOL_FUSE_W_LSB = 1       # 1 LSB with the incidence weight (a fractional observation weight
                         # makes a weight a sum of rounded codes: the single-device port's own
                         # bar against JAX, tests/torch_nonrigid_cases.py check_volume)
TOL_SYS_RTOL, TOL_SYS_ATOL = 1e-3, 1e-5   # the sharded system against JAX's
TOL_SYS_PORT = 1e-6      # ... against the port's single-device assembly, relative to the largest entry
TOL_DQ = 5e-4            # the solved dual quaternions
TOL_COST_RTOL, TOL_COST_ATOL = 1e-3, 1e-7  # the solve's final cost
# the distributed PCG's kernel-ordered sums against torch's, relative to
# the largest entry (float32 rounding; 9.2e-8 read on the one-shard solve)
TOL_PCG_ORDER = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tcfg(jc):
    """The port's copy of a JAX config."""
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    kw["intr"] = TIntr(*dataclasses.astuple(jc.intr))
    return TCfg(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def cpu_mesh(n):
    return sharded.make_mesh(n, devices=["cpu"] * n)


# ------------------------------------------------------------------ the mesh


def test_mesh_collectives_are_a_fixed_tree():
    """psum is ((s0 + s1) + (s2 + s3)) over the shard index, bit for bit and
    the same on every call; pmin and pmax elementwise."""
    mesh = cpu_mesh(4)
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy((rng.randn(1000) * 10.0 ** rng.randint(-6, 6, 1000)).astype(np.float32)) for _ in range(4)]
    got = mesh.psum(xs)
    assert torch.equal(got, (xs[0] + xs[1]) + (xs[2] + xs[3]))
    assert torch.equal(got, mesh.psum(xs))
    assert not torch.equal(got, ((xs[0] + xs[1]) + xs[2]) + xs[3])  # the order is the tree's
    assert torch.equal(mesh.pmin(xs), torch.minimum(torch.minimum(xs[0], xs[1]), torch.minimum(xs[2], xs[3])))
    assert torch.equal(mesh.pmax(xs), torch.maximum(torch.maximum(xs[0], xs[1]), torch.maximum(xs[2], xs[3])))
    three = Mesh(["cpu"] * 3)
    assert torch.equal(three.psum(xs[:3]), (xs[0] + xs[1]) + xs[2])


def test_mesh_split_gather_and_halo():
    """Slabs are views of the whole on its device; the halo holds the
    neighbours' planes, wrapped at the edges."""
    mesh = cpu_mesh(4)
    whole = torch.arange(16 * 3 * 3, dtype=torch.int16).reshape(16, 3, 3)
    slabs = mesh.split(whole)
    assert all(s.data_ptr() == whole[4 * k].data_ptr() for k, s in enumerate(slabs))
    assert torch.equal(mesh.gather(slabs), whole)
    ext = mesh.halo(slabs, 2)
    for k, e in enumerate(ext):
        want = torch.cat([whole.roll(2 - 4 * k, 0)[:2], whole[4 * k: 4 * k + 4], whole.roll(-4 * k - 4, 0)[:2]])
        assert torch.equal(e, want)
    vol = TsdfVolume(whole, whole.to(torch.uint16))
    sv = mesh.slabs(vol)
    assert isinstance(sv, SlabVolume) and torch.equal(mesh.whole(sv).weight.to(torch.int32), whole.to(torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            Mesh(["cuda"] * 2)
        else:
            raise RuntimeError("CUDA present")


# ------------------------------------------------------------------ the slab raycast

RC = JCfg.small(dims=128, rows=96, cols=128)


@pytest.fixture(scope="module")
def rc_volume():
    """The JAX sharded raycast test's scene, fused by the port (any volume
    serves: both packages march the same codes)."""
    tc = tcfg(RC)
    depth = jsyn.scene_depth(
        RC.intr, RC.rows, RC.cols,
        spheres=[dict(center=(0.0, 0.0, 0.9), radius=0.25), dict(center=(0.2, 0.1, 0.8), radius=0.1)], plane_z=1.2,
    )
    vol_pose = jse3.identity().at[:3, 3].set(jnp.asarray(RC.volume_origin))
    tvol = tvolume.create(tc, "cpu")
    dists = tpre.compute_dists(tc.intr, torch.from_numpy(depth))
    ttsdf.integrate(tc, tvol, dists, _t(vol_pose), tc.intr)
    return jvolume.TsdfVolume(jnp.asarray(tvol.tsdf.numpy()), jnp.asarray(tvol.weight.numpy())), vol_pose


def _cam2vol(vol_pose, pose):
    return jse3.compose(jse3.inverse(vol_pose), pose)


def _hold_maps(ref, got, min_hits=2000):
    rp, gp = np.asarray(ref.points), got.points.numpy()
    rn, gn = np.asarray(ref.normals), got.normals.numpy()
    hit_r, hit_g = ~np.isnan(rp[..., 0]), ~np.isnan(gp[..., 0])
    assert hit_r.sum() > min_hits
    assert (hit_r != hit_g).sum() == 0
    both = hit_r & hit_g
    assert np.linalg.norm(rp[both] - gp[both], axis=-1).max() < TOL_RC_M
    assert np.quantile(np.linalg.norm(rn[both] - gn[both], axis=-1), 0.999) < TOL_RC_NRM_Q999


@pytest.mark.parametrize("refine", ["secant", "newton8"])
def test_slab_raycast_matches_fixed_step_raycast(rc_volume, refine):
    """8 slabs at an oblique pose (rays cross the slab boundaries both ways)
    against JAX's single-device fixed-step raycast."""
    vol, vol_pose = rc_volume
    jc = dataclasses.replace(RC, raycast_refine=refine, raycast_adaptive_step=False)
    tc = tcfg(jc)
    cam2vol = _cam2vol(vol_pose, jse3.exp_twist(jnp.asarray([0.0, 0.25, 0.0, 0.12, 0.0, -0.05])))
    ref = jtsdf.raycast(jc, vol, cam2vol, jc.intr, jc.rows, jc.cols)
    rc = sharded_raycast.make_sharded_raycast(tc, cpu_mesh(8))
    got = rc(tc, TsdfVolume(_t(vol.tsdf), _t(vol.weight)), _t(cam2vol), tc.intr, tc.rows, tc.cols)
    _hold_maps(ref, got)


def test_slab_raycast_in_a_band(rc_volume):
    vol, vol_pose = rc_volume
    jc = dataclasses.replace(RC, raycast_adaptive_step=False, raycast_refine="newton8")
    tc = tcfg(jc)
    cam2vol = _cam2vol(vol_pose, jse3.identity())
    rng = np.random.RandomState(3)
    lo = (0.4 + 0.2 * rng.rand(RC.rows, RC.cols)).astype(np.float32)
    hi = (lo + 0.6 + 0.3 * rng.rand(RC.rows, RC.cols)).astype(np.float32)
    ref = jtsdf.raycast(jc, vol, cam2vol, jc.intr, jc.rows, jc.cols, t_band=(jnp.asarray(lo), jnp.asarray(hi)))
    mesh = cpu_mesh(8)
    rc = sharded_raycast.make_sharded_raycast(tc, mesh)
    got = rc(tc, mesh.slabs(TsdfVolume(_t(vol.tsdf), _t(vol.weight))), _t(cam2vol), tc.intr, tc.rows, tc.cols,
             t_band=(_t(lo), _t(hi)))
    _hold_maps(ref, got)


def test_slab_march_matches_jax_slab_samplers(rc_volume):
    """The plain version of kernel C's slab mode on one shard's extended
    slab against JAX's march core over JAX's slab samplers (found, the
    refined t and the first exit event's t, bit for bit in the march)."""
    vol, vol_pose = rc_volume
    jc = dataclasses.replace(RC, raycast_adaptive_step=False, raycast_refine="newton8")
    tc = tcfg(jc)
    d, n, k = jc.volume_dims, 8, 3
    halo = jsr._halo_planes(jc)
    assert halo == sharded_raycast._halo_planes(tc)
    x_off = k * (d // n) - halo
    ext = np.asarray(vol.tsdf)[x_off: x_off + d // n + 2 * halo]
    cam2vol = _cam2vol(vol_pose, jse3.exp_twist(jnp.asarray([0.0, 0.25, 0.0, 0.12, 0.0, -0.05])))
    org, dirs, tmin, tmax = ttsdf.rays(tc, _t(cam2vol), tc.intr, tc.rows, tc.cols)
    lo, hi = sharded_raycast.slab_window(tc, k, n, org, dirs, tmin, tmax)
    found, t_s, vert, nrm, t_b = ttsdf.march_slab_plain(tc, _t(ext), x_off, org, dirs, lo, hi)
    jf, jt, jv, jn, jb = jtsdf.march_and_refine(
        jc, jsr._slab_samplers(jnp.asarray(ext), x_off, d), jnp.asarray(org.numpy()), jnp.asarray(dirs.numpy()),
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()), jc.voxel_size * d, adaptive_double=False,
    )
    assert int(found.sum()) > 100
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(t_b.numpy(), np.asarray(jb))
    f = found.numpy()
    assert np.abs(t_s.numpy()[f] - np.asarray(jt)[f]).max() < TOL_RC_M
    assert np.abs(vert.numpy()[f] - np.asarray(jv)[f]).max() < TOL_RC_M


# ------------------------------------------------------------------ the slab fusion

FU = dataclasses.replace(JCfg.small(dims=64, rows=120, cols=160), max_nodes=64, node_radius=0.3, knn_field_stride=2)


@pytest.mark.parametrize("incidence,storage", [pytest.param(False, "i16", id="False"),
                                               pytest.param(True, "i16", id="True"),
                                               pytest.param(True, "f32", id="True-f32")])
def test_slab_fusion_matches_single_device(incidence, storage):
    """64^3 over 4 slabs (whole brick planes) against JAX's
    ``integrate_nonrigid``: codes within 1 LSB, weights equal (within 1 LSB
    with the incidence weight), the same band and wide counts; against the
    port's single-device fusion bit for bit; ``enabled=False`` leaves every
    slab as it was. Under the f32 tsdf and weight the LSBs are the i16 and
    u16 codes' (1 / 32767, 1 / 512)."""
    jc = dataclasses.replace(FU, fusion_incidence_weight=incidence, fusion_sdf_incidence_scale=incidence,
                             fusion_incidence_floor=0.35 if incidence else 0.0,
                             tsdf_dtype=storage, weight_dtype="f32" if storage == "f32" else "u16")
    tc = tcfg(jc)
    rng = np.random.default_rng(0)
    g = np.linspace(-0.35, 0.35, 4)
    pts = np.stack(np.meshgrid(g, g, g + 0.95, indexing="ij"), -1).reshape(-1, 3)
    field = jw.init_from_cloud(jc, jnp.asarray(pts, np.float32), jnp.ones(len(pts), bool))
    trans = jnp.asarray(rng.uniform(-0.01, 0.01, (jc.max_nodes, 3)), jnp.float32)
    dq = jax.vmap(jdq.from_rot_trans, in_axes=(None, 0))(jnp.asarray([1.0, 0, 0, 0]), trans)
    field = field._replace(dq=jnp.where(field.active[:, None], dq, field.dq))
    depth = jsyn.scene_depth(jc.intr, jc.rows, jc.cols, spheres=[dict(center=(0.0, 0.0, 0.9), radius=0.25)],
                             plane_z=1.2)
    dists = jpre.compute_dists(jc.intr, jnp.asarray(depth))
    conf = jnp.asarray(rng.uniform(0.0, 1.0, dists.shape), jnp.float32) if incidence else None
    # the first frame fused by the port (any volume serves)
    first = TsdfVolume(_t(jvolume.create(jc).tsdf), _t(jvolume.create(jc).weight))
    cf = tfusion.coarse_field(tc, WarpField(*(_t(a) for a in field)))
    tfusion.integrate_nonrigid(tc, first, cf, _t(dists), torch.eye(4), tc.intr, torch.tensor(True),
                               conf=None if conf is None else _t(conf))
    vol = jvolume.TsdfVolume(jnp.asarray(first.tsdf.numpy()), jnp.asarray(first.weight.numpy()))
    # the second frame from a moved camera, so that the update changes codes
    w2c = jse3.exp_twist(jnp.asarray([0.01, -0.02, 0.0, 0.01, 0.0, 0.02]))
    ref, cref = jax.jit(lambda v: jfusion.integrate_nonrigid(jc, v, field, dists, w2c, jc.intr, with_counts=True,
                                                             conf=conf))(vol)
    assert int((np.asarray(ref.tsdf) != np.asarray(vol.tsdf)).sum()) > 1000
    mesh = cpu_mesh(4)
    fn = sharded_fusion.make_sharded_integrate(tc, mesh)
    args = (cf, _t(dists), _t(w2c), tc.intr)
    tconf = None if conf is None else _t(conf)
    sv = mesh.slabs(TsdfVolume(_t(vol.tsdf), _t(vol.weight)))
    out, counts = fn(tc, sv, *args, torch.tensor(True), tconf, None)
    w = mesh.whole(out)
    assert w.tsdf.dtype == tvolume._TSDF_DTYPES[storage]
    # distances in the i16 and u16 codes' units (exact integers for the codes)
    lsb_t, lsb_w = (32767.0, 512.0) if storage == "f32" else (1.0, 1.0)
    dt = np.abs(w.tsdf.numpy().astype(np.float64) - np.asarray(ref.tsdf).astype(np.float64)) * lsb_t
    assert dt.max() <= TOL_FUSE_LSB
    dw = np.abs(w.weight.numpy().astype(np.float64) - np.asarray(ref.weight).astype(np.float64)).max() * lsb_w
    assert dw <= (TOL_FUSE_W_LSB if incidence else 0)
    assert counts.tolist()[:2] == np.asarray(cref).tolist()[:2]
    one = TsdfVolume(_t(vol.tsdf), _t(vol.weight))
    c1 = tfusion.integrate_nonrigid(tc, one, *args, torch.tensor(True), conf=tconf)
    assert torch.equal(w.tsdf, one.tsdf) and torch.equal(w.weight.view(torch.int16), one.weight.view(torch.int16))
    assert counts.tolist() == c1.tolist()
    sv = mesh.slabs(TsdfVolume(_t(vol.tsdf), _t(vol.weight)))
    out, counts = fn(tc, sv, *args, torch.tensor(False), tconf, None)
    np.testing.assert_array_equal(mesh.whole(out).tsdf.numpy(), np.asarray(vol.tsdf))
    np.testing.assert_array_equal(mesh.whole(out).weight.numpy(), np.asarray(vol.weight))
    assert counts.tolist() == [0, 0, 0]


def test_slab_fusion_phase_and_caps():
    """The phase split tests the GLOBAL brick x-plane: fusing phase 1 of 2
    over 4 slabs (one brick plane each at 64^3 / 16) equals the whole
    volume's phase 1 (planes 1 and 3); the caps are every local brick and
    max(local bricks // 8, 16) wide ones."""
    jc = dataclasses.replace(FU, fusion_phase_split=2, fusion_interval=2)
    tc = tcfg(jc)
    assert sharded_fusion.caps(tc, 4) == (16, 16)
    assert sharded_fusion.caps(tcfg(JCfg.default_dynamicfusion()), 4) == (1024, 128)
    field = jw.init_from_cloud(jc, jnp.asarray([[0.0, 0.0, 0.9]], np.float32), jnp.ones(1, bool))
    depth = jsyn.scene_depth(jc.intr, jc.rows, jc.cols, spheres=[dict(center=(0.0, 0.0, 0.9), radius=0.25)],
                             plane_z=1.2)
    dists = _t(jpre.compute_dists(jc.intr, jnp.asarray(depth)))
    cf = tfusion.coarse_field(tc, WarpField(*(_t(a) for a in field)))
    base = TsdfVolume(_t(jvolume.create(jc).tsdf), _t(jvolume.create(jc).weight))
    whole = TsdfVolume(base.tsdf.clone(), base.weight.clone())
    phase = torch.tensor(1, dtype=torch.int32)
    tfusion.integrate_nonrigid(tc, whole, cf, dists, torch.eye(4), tc.intr, torch.tensor(True), phase=phase)
    mesh = cpu_mesh(4)
    out, _ = sharded_fusion.make_sharded_integrate(tc, mesh)(
        tc, mesh.slabs(TsdfVolume(base.tsdf.clone(), base.weight.clone())), cf, dists, torch.eye(4), tc.intr,
        torch.tensor(True), None, phase,
    )
    got = mesh.whole(out)
    assert torch.equal(got.tsdf, whole.tsdf) and torch.equal(got.weight.to(torch.int32), whole.weight.to(torch.int32))
    assert (whole.tsdf[:16] != base.tsdf[:16]).sum() == 0 and (whole.tsdf[16:32] != base.tsdf[16:32]).sum() > 0


# ------------------------------------------------------------------ the sharded solve

CUBE = np.array([[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
                 [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1]], np.float32)
GN = JCfg(volume_dims=64, max_nodes=16, node_sample_step=1, node_radius=3.0, knn_k=8, solver_nonlinear_iters=6,
          solver_linear_iters=60, solver_tukey_c=10.0, solver_huber_delta=10.0, solver_arap_weight=1e-4,
          point_to_plane=False, knn_method="exact", solver_linear="direct")


def _gn_problem(n, shift=(0.05, 0.05, 0.05)):
    rng = np.random.default_rng(0)
    can = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    live = can + np.asarray(shift, np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    arrs = [can, nrm, live, nrm]
    field = jw.init_from_cloud(GN, jnp.asarray(CUBE), jnp.ones(8, bool))
    return (field, WarpField(*(_t(a) for a in field)), js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs)),
            ts.WarpSolveInputs(*(torch.from_numpy(a.copy()) for a in arrs)))


@pytest.mark.parametrize("n_points", [40, 37])
def test_sharded_system_matches_single_device(n_points):
    """8 shards (37 points pad to 40 with invalid rows) against JAX's
    ``gn_system_dense`` and the port's single-device assembly; the int8
    Gram quantizes with the pmax'd column scales."""
    jc = GN
    tc = tcfg(jc)
    jfield, tfield, ji, ti = _gn_problem(n_points)
    jtj_r, jtr_r, cost_r = jax.jit(
        lambda f, i: js.gn_system_dense(jc, js.prepare(jc, f, i, False), f.dq, 16, False)
    )(jfield, ji)
    t = ts.prepare(tc, tfield, ti)
    jtj, jtr, cost = distributed_gn.make_system_fn(tc, cpu_mesh(8))(t, tfield.dq)
    # the cost sums Tukey's rho at |r| << c, 1 - (1 - x^2)^3 in float32: XLA's
    # fused graph rounds it ~5e-5 apart from the op-by-op sum the port follows
    np.testing.assert_allclose(float(cost), float(cost_r), rtol=TOL_SYS_RTOL, atol=TOL_SYS_ATOL)
    np.testing.assert_allclose(jtj.numpy(), np.asarray(jtj_r), rtol=TOL_SYS_RTOL, atol=TOL_SYS_ATOL)
    np.testing.assert_allclose(jtr.numpy(), np.asarray(jtr_r), rtol=TOL_SYS_RTOL, atol=TOL_SYS_ATOL)
    dt, et = ts.data_term(tc, t, tfield.dq, True), ts.edge_term(tc, t, tfield.dq)
    one = ts.dense_gram(tc, t, dt, et)
    assert float((jtj - one).abs().max() / one.abs().max()) <= TOL_SYS_PORT
    assert abs(float(cost) - float(dt.cost + et.cost)) <= TOL_SYS_PORT * float(dt.cost + et.cost)


def test_sharded_bf16_system_matches_single_device():
    """The bf16 Gram (no scales) over 8 shards against the port's
    single-device assembly."""
    tc = tcfg(dataclasses.replace(GN, solver_jtj_int8=False))
    _, tfield, _, ti = _gn_problem(37)
    t = ts.prepare(tc, tfield, ti)
    jtj, _, _ = distributed_gn.make_system_fn(tc, cpu_mesh(8))(t, tfield.dq)
    one = ts.dense_gram(tc, t, ts.data_term(tc, t, tfield.dq, True), ts.edge_term(tc, t, tfield.dq))
    assert float((jtj - one).abs().max() / one.abs().max()) <= TOL_SYS_PORT


@functools.lru_cache(maxsize=2)
def _jax_solve(linear):
    """JAX's single-device solve of the 48-point problem, compiled once."""
    jc = dataclasses.replace(GN, solver_linear=linear)
    jfield, _, ji, _ = _gn_problem(48, (0.03, -0.02, 0.04))
    f, st = jax.jit(lambda f, i: js.solve(jc, f, i))(jfield, ji)
    return np.asarray(f.dq), float(st.final_cost)


@pytest.mark.parametrize("linear", ["direct", "pcg"])
def test_solve_distributed_matches_single_device(linear):
    jc = dataclasses.replace(GN, solver_linear=linear)
    tc = tcfg(jc)
    _, tfield, _, ti = _gn_problem(48, (0.03, -0.02, 0.04))
    dq_ref, cost_ref = _jax_solve(linear)
    f, st = distributed_gn.solve_distributed(tc, cpu_mesh(8), tfield, ti)
    np.testing.assert_allclose(f.dq.numpy(), dq_ref, atol=TOL_DQ)
    np.testing.assert_allclose(float(st.final_cost), cost_ref, rtol=TOL_COST_RTOL, atol=TOL_COST_ATOL)


def test_sharded_pcg_solve_matches_single_device():
    """The distributed PCG (each shard's rows unsummed, every matvec a
    psum) against JAX's single-device factored PCG solve."""
    tc = tcfg(dataclasses.replace(GN, solver_linear="pcg"))
    _, tfield, _, ti = _gn_problem(48, (0.03, -0.02, 0.04))
    dq_ref, cost_ref = _jax_solve("pcg")
    f, st = distributed_gn.make_sharded_solve(tc, cpu_mesh(8))(tfield, ti)
    np.testing.assert_allclose(f.dq.numpy(), dq_ref, atol=TOL_DQ)
    np.testing.assert_allclose(float(st.final_cost), cost_ref, rtol=TOL_COST_RTOL, atol=TOL_COST_ATOL)
    assert float(st.final_cost) < float(st.initial_cost)


def test_solve_trace_records_without_changing_the_solve():
    """``solve(trace=...)`` over a mesh records one entry an LM iteration
    (the point, the candidate, its cost, the cost it is tested on, the
    accept, the running flag) and leaves the result bit for bit."""
    tc = tcfg(dataclasses.replace(GN, solver_linear="pcg"))
    _, tfield, _, ti = _gn_problem(48, (0.03, -0.02, 0.04))
    parts, p = distributed_gn.shard_inputs(tc, ti, cpu_mesh(4))
    f0, st0 = ts.solve(tc, tfield, parts, mesh=cpu_mesh(4), global_points=p)
    trace = []
    f1, st1 = ts.solve(tc, tfield, parts, mesh=cpu_mesh(4), global_points=p, trace=trace)
    assert torch.equal(f0.dq, f1.dq) and torch.equal(st0.final_cost, st1.final_cost)
    assert len(trace) == tc.solver_nonlinear_iters
    assert int(sum(int(t[4]) for t in trace)) == int(st1.accepted_steps) > 0
    assert torch.equal(trace[0][0], tfield.dq) and float(trace[0][3]) == float(st1.initial_cost)
    # an accepted candidate is the next iteration's point
    for a, b in zip(trace, trace[1:]):
        assert torch.equal(b[0], a[1] if bool(a[4]) else a[0])


def test_sharded_pcg_plain_equals_single_pcg_on_one_shard():
    """One shard: the distributed PCG's matvec is the single matvec, so the
    two plain PCGs agree to float32 rounding (the mesh adds nothing to the
    sums; the distributed one takes the kernels' order of the dot
    products, the preconditioner and the edge sums, ``pcg_plain``
    torch's)."""
    tc = tcfg(dataclasses.replace(GN, solver_linear="pcg"))
    _, tfield, _, ti = _gn_problem(48, (0.03, -0.02, 0.04))
    s = ts.prepare(tc, tfield, ti)
    dt = ts.data_term(tc, s, tfield.dq, True)
    et = ts.edge_term(tc, s, tfield.dq)
    blocks = dt.blocks + et.diag
    diag_eff, unit = ts.damping_terms(tc, tfield.active, blocks)
    damp = 1e-3 * diag_eff + unit
    sys = ts.System(dt.rows, et, damp)
    minv = ts.spd6_inv(blocks + torch.diag_embed(damp.reshape(-1, 6)))
    on = torch.tensor(True)
    one = ts.pcg(s, sys, minv, dt.jtr + et.jtr, 12, 1e-3, on)
    got = ts.pcg_sharded(cpu_mesh(1), [ts.Shard(s, dt.rows)], s, sys, minv, dt.jtr + et.jtr, 12, 1e-3, on)
    assert float((got - one).abs().max()) <= TOL_PCG_ORDER * float(one.abs().max())
    # the ordered pieces against torch's, on one direction
    p = torch.from_numpy(np.random.RandomState(3).randn(one.shape[0]).astype(np.float32))
    assert torch.equal(ts.apply_m_ordered(minv, p), ts._apply_m(minv, p))
    ap = ts.edge_apply_plain(s, et, p, ts.data_matvec_ordered(s, sys, p).reshape(-1), damp)
    ref = ts.matvec_plain(s, sys, p)
    assert float((ap - ref).abs().max()) <= TOL_PCG_ORDER * float(ref.abs().max())


def test_ordered_dot_follows_the_block_sum():
    """``dot_ordered`` against a transcription of kernel P's ``node_dot``
    and ``block_sum`` (float32 throughout): 1 500 nodes, so that the first
    476 of the 1 024 threads sum two nodes each."""
    rng = np.random.RandomState(4)
    a, b = (rng.randn(6 * 1500).astype(np.float32) for _ in range(2))
    part = np.zeros(1024, np.float32)
    for t in range(1024):
        for nd in range(t, 1500, 1024):
            for d in range(6):
                part[t] = np.float32(part[t] + np.float32(a[6 * nd + d] * b[6 * nd + d]))

    def shuffle_tree(v):
        v = v.copy()
        for o in (16, 8, 4, 2, 1):
            v[:o] = v[:o] + v[o:2 * o]
        return v[0]

    warps = np.array([shuffle_tree(part[32 * w: 32 * w + 32]) for w in range(32)], np.float32)
    want = shuffle_tree(warps)
    got = ts.dot_ordered(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and float(got) == float(want)


# ------------------------------------------------------------------ checkpoints


def test_checkpoint_onto_a_mesh_round_trips(tmp_path):
    """A JAX-written checkpoint restores onto 4 CPU shards (the same file
    whatever the shard count), and the sharded state written back loads in
    JAX leaf for leaf."""
    jc = dataclasses.replace(JCfg.small(dims=32, rows=60, cols=80), max_nodes=64)
    tc = tcfg(jc)
    rng = np.random.RandomState(1)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return rng.rand(*a.shape) < 0.5
        if a.dtype.kind in "iu":
            info = np.iinfo(a.dtype)
            return rng.randint(max(info.min, -30000), min(info.max, 60000), a.shape).astype(a.dtype)
        return rng.randn(*a.shape).astype(a.dtype)

    state = jax.tree_util.tree_map(leaf, jkinfu.init_state(jc))
    path = str(tmp_path / "j.npz")
    jckpt.save(path, state)
    mesh = cpu_mesh(4)
    st = tckpt.load(path, tc, mesh=mesh)
    assert isinstance(st.vol, SlabVolume) and len(st.vol.tsdf) == 4 and st.vol.tsdf[0].shape == (8, 32, 32)
    back = interop.state_to_numpy(st, mesh=mesh)
    np.testing.assert_array_equal(back["vol"]["tsdf"], np.asarray(state.vol.tsdf))
    np.testing.assert_array_equal(back["vol"]["weight"], np.asarray(state.vol.weight))
    path2 = str(tmp_path / "t.npz")
    tckpt.save(path2, st, mesh=mesh)
    again = jckpt.load(path2, jc)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="mesh"):
        tckpt.save(path2, st)
    # interop's sharded way in
    st2 = interop.state_from_numpy(jax.tree_util.tree_map(np.asarray, state), mesh=mesh, cfg=tc)
    assert all(torch.equal(a, b) for a, b in zip(st2.vol.tsdf, st.vol.tsdf))
    assert torch.equal(st2.pose, st.pose)
    assert tkinfu.PipelineState._fields == st2._fields
