"""Shared set-up of the non-rigid slice tests (tests/test_torch_nonrigid_*.py):
bench.py's deforming scene, the JAX package's run over it (jitted), the
port's run, and the checks both files make frame by frame."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import dualquat as jdq
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.io import synthetic
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

# the dynamicfusion preset's settings that small() leaves at the base
# defaults, its newton8 refine included (fusion stays on every frame, so
# every step fuses)
SLICE = dict(
    solver_linear="pcg", solver_linear_iters=12, fusion_incidence_weight=True, fusion_incidence_floor=0.35,
    fusion_sdf_incidence_scale=True, raycast_temporal_band=True, raycast_refine="newton8",
)

# tolerances
# The port carrying its own state: its pose (m, and rotation entries) within
# TOL_POSE_FREE of JAX's or within SPREAD times JAX's own spread, whichever
# is larger. A last-bit difference moves the solve's LM step (the bf16
# rows, see test_torch_warp_solver.py) and through the warped tracking maps
# ICP's next pose: JAX run again with its frame-0 node positions moved by
# 1e-7 relative moves its own third-step pose by ~1.4e-3 m at small().
TOL_POSE_FREE = 1e-3
SPREAD = 2.0
PERTURB_SEEDS = (0, 1)
TOL_POSE = 1e-4        # the port's step from JAX's state (ICP, pre-alignment)
TOL_COST0 = 1e-5       # the solve's initial cost from JAX's state, relative
TOL_LSB_FRAC = 1e-4    # fraction of voxels whose tsdf codes differ by more than 1 LSB
TOL_PIXEL_FRAC = 1e-3  # pixels whose incidence confidence differs (bilateral ties)
TOL_MAP_VALID_FRAC = 1e-3  # model-map pixels valid in one package only
TOL_MAP_M = 1e-4       # tracking-map points (m) where both are valid, ...
TOL_MAP_FRAC = 1e-2    # ... except on this fraction of pixels (a one-LSB code
TOL_MAP_MAX_M = 2e-3   # difference moves a crossing), where they stay below this
TOL_NRM = 1e-4         # normals (unit vectors) on the same terms: the normalized
TOL_NRM_MAX = 3e-2     # gradient of 8 corners, one of which may differ by 1 LSB


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's plain path at test sizes is thousands of small ops: one
    intra-op thread runs it as fast as eight alone, and keeps the test
    workers that share the machine from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**small):
    """(JAX config, port config): ``small(**small)`` with the slice's settings."""
    return (dataclasses.replace(JCfg.small(**small), **SLICE),
            dataclasses.replace(TCfg.small(**small), **SLICE))


def bench_depths(cfg, n):
    """bench.py's frames(), rendered once and handed to both packages."""
    return synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@functools.lru_cache(maxsize=8)
def _jitted(jc):
    return (jax.jit(lambda s, d: jkinfu.first_frame(jc, s, d)),
            jax.jit(lambda s, d: jkinfu.step(jc, s, d)))


def jax_run(jc, depths, perturb_seed=None):
    """JAX over the frames: per frame (state, outputs) as numpy. With
    ``perturb_seed`` the frame-0 node positions are moved by 1e-7 relative
    (seeded) before the first step."""
    first, step = _jitted(jc)
    js = first(jkinfu.init_state(jc), jnp.asarray(depths[0]))
    if perturb_seed is not None:
        pos = np.asarray(js.warp.positions)
        noise = 1.0 + 1e-7 * np.random.RandomState(perturb_seed).randn(*pos.shape)
        js = js._replace(warp=js.warp._replace(positions=jnp.asarray((pos * noise).astype(np.float32))))
    out = [(np_tree(js), None)]
    for d in depths[1:]:
        js, jo = step(js, jnp.asarray(d))
        out.append((np_tree(js), np_tree(jo)))
    return out


def port_run(tc, depths):
    ts = tkinfu.first_frame(tc, tkinfu.init_state(tc, "cpu"), torch.from_numpy(depths[0]))
    out = [(interop.state_to_numpy(ts), None)]
    for d in depths[1:]:
        ts, to = tkinfu.step(tc, ts, torch.from_numpy(d))
        out.append((interop.state_to_numpy(ts), to))
    return out


def _bf16_ulps(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) as integers in value order, so that the
    difference of two is their distance in ulps."""
    b = bits.astype(np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def check_volume(jv, tv):
    """Codes differing by more than 1 LSB on < TOL_LSB_FRAC of voxels,
    weights within 1 LSB (fractional observation weights make a weight a
    sum of rounded codes). Float storages are held to the same: the tsdf
    within one i16 LSB (1 / 32767) and the weight within one u16 LSB
    (1 / 512); a bf16 tsdf within one bf16 ulp on all but TOL_LSB_FRAC of
    voxels (JAX's bf16 arrays come as numpy dtype kind "V")."""
    jt, tt = np.asarray(jv.tsdf), tv.tsdf.float().numpy()
    if jt.dtype == np.int16:
        assert (np.abs(jt.astype(np.int64) - tt.astype(np.int64)) > 1).mean() < TOL_LSB_FRAC
    elif jt.dtype.kind == "V" and jt.dtype.itemsize == 2:
        assert tv.tsdf.dtype == torch.bfloat16
        ulps = np.abs(_bf16_ulps(jt.view(np.uint16)) - _bf16_ulps(tv.tsdf.view(torch.int16).numpy().view(np.uint16)))
        assert (ulps > 1).mean() < TOL_LSB_FRAC
    else:
        assert (np.abs(jt.astype(np.float32) - tt) > 1.0 / 32767.0).mean() < TOL_LSB_FRAC
    jw_, tw_ = np.asarray(jv.weight), tv.weight
    if jw_.dtype == np.uint16:
        assert np.abs(jw_.astype(np.int64) - tw_.numpy().astype(np.int64)).max() <= 1
    else:
        assert np.abs(jw_ - tw_.numpy()).max() <= 1.0 / 512.0


def check_maps(j_maps, t_maps, normals=False):
    tol, tol_max = (TOL_NRM, TOL_NRM_MAX) if normals else (TOL_MAP_M, TOL_MAP_MAX_M)
    for jm, tm in zip(j_maps, t_maps):
        tm = np.asarray(tm)
        vj, vt = ~np.isnan(jm[..., 0]), ~np.isnan(tm[..., 0])
        assert (vj != vt).mean() <= TOL_MAP_VALID_FRAC
        both = vj & vt
        assert both.mean() > 0.3
        err = np.abs(jm[both] - tm[both]).max(axis=-1)
        assert (err > tol).mean() <= TOL_MAP_FRAC and err.max() <= tol_max


def _pose_diff(a, b):
    """(max translation difference (m), max rotation-entry difference)."""
    return float(np.abs(a[:3, 3] - b[:3, 3]).max()), float(np.abs(a[:3, :3] - b[:3, :3]).max())


def jax_spread(jc, depths, jax_frames):
    """Per frame, JAX's own (translation, rotation, relative initial solve
    cost) spread: the largest difference of its runs from perturbed
    frame-0 node positions."""
    runs = [jax_run(jc, depths, seed) for seed in PERTURB_SEEDS]

    def diff(a, b):
        c0 = float(b.solver_cost0)
        return (*_pose_diff(a.pose, b.pose), abs(float(a.solver_cost0) - c0) / c0)

    return [None] + [
        tuple(max(v) for v in zip(*(diff(r[f][1], jax_frames[f][1]) for r in runs)))
        for f in range(1, len(depths))
    ]


def check_free_running(jax_frames, port_frames, frame, spread):
    jo, to = jax_frames[frame][1], port_frames[frame][1]
    assert bool(jo.icp_ok) and bool(to.icp_ok)
    dt, dr = _pose_diff(to.pose.numpy(), jo.pose)
    assert dt <= max(TOL_POSE_FREE, SPREAD * spread[frame][0]), (dt, spread[frame])
    assert dr <= max(TOL_POSE_FREE, SPREAD * spread[frame][1]), (dr, spread[frame])
    assert int(jo.node_count) == int(to.node_count)
    assert float(to.solver_cost1) <= float(to.solver_cost0)


@functools.lru_cache(maxsize=8)
def _jitted_fusion_inputs(jc):
    from dynamicfusion_tpu.ops import preprocess as jpre

    def f(depth):
        _, p, n, d = jpre.build_frame_pyramid(jc, depth)
        pn = p[0] / jnp.maximum(jnp.linalg.norm(p[0], axis=-1, keepdims=True), 1e-9)
        return d, jnp.nan_to_num(jnp.abs(jnp.sum(n[0] * pn, axis=-1)))

    return jax.jit(f)


def jax_fusion_inputs(jc, depth):
    """JAX's (dists, incidence confidence) of a depth frame, as numpy."""
    return tuple(np.asarray(a) for a in _jitted_fusion_inputs(jc)(jnp.asarray(depth)))


def check_step_from_jax_state(jc, tc, jax_frames, depths, frame, tol_cost0=TOL_COST0):
    """The port's step from JAX's previous state: ICP and pre-alignment
    give JAX's pose and the solve starts from JAX's cost (within
    ``tol_cost0``, relative); the fusion, the node insertion and the model
    maps, run on JAX's solved field at JAX's pose, give JAX's volume, nodes
    and maps. Returns the initial cost's relative difference."""
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import fusion, preprocess

    (j_prev, _), (j, jo) = jax_frames[frame - 1], jax_frames[frame]
    depth = torch.from_numpy(depths[frame])
    _, to = tkinfu.step(tc, interop.state_from_numpy(j_prev, "cpu"), depth)
    assert bool(to.icp_ok) == bool(jo.icp_ok)
    assert np.abs(jo.pose - to.pose.numpy()).max() <= TOL_POSE
    c0 = float(jo.solver_cost0)
    cost0_rel = abs(float(to.solver_cost0) - c0) / c0
    assert cost0_rel <= tol_cost0, (cost0_rel, tol_cost0)
    assert float(to.solver_cost1) <= float(to.solver_cost0)

    st = interop.state_from_numpy(j_prev, "cpu")
    nxt = interop.state_from_numpy(j, "cpu")
    pose = torch.from_numpy(jo.pose)
    # JAX's solved field is its next state's field before insertion: the
    # insertion only writes free slots and last_support, so take the
    # transforms of the nodes that were active before it
    solved = st.warp._replace(dq=torch.where(st.warp.active[:, None], nxt.warp.dq, st.warp.dq))
    # the fusion's per-pixel inputs: the port's agree with JAX's but on the
    # few pixels where a round-half-even tie of the bilateral filter turns a
    # normal (test_torch_preprocess_icp.py); the fusion takes JAX's
    _, pts, nrm, dists = preprocess.build_frame_pyramid(tc, depth)
    jd, jconf = jax_fusion_inputs(jc, depths[frame])
    conf = preprocess.incidence_confidence(pts[0], nrm[0])
    np.testing.assert_allclose(dists.numpy(), jd, atol=1e-6, rtol=0)
    assert (np.abs(conf.numpy() - jconf) > 1e-5).mean() <= TOL_PIXEL_FRAC
    dists, conf = torch.from_numpy(jd.copy()), torch.from_numpy(jconf.copy())
    cf = fusion.coarse_field(tc, solved)
    ok = torch.tensor(bool(jo.icp_ok))
    fuse = ok & (st.frame_idx % max(tc.fusion_interval // tc.fusion_phase_split, 1) == 0)
    counts = fusion.integrate_nonrigid(tc, st.vol, cf, dists, se3.inverse(pose), tc.intr, fuse,
                                       conf=conf if tc.fusion_incidence_weight else None)
    np.testing.assert_array_equal(jo.brick_counts, counts.numpy())
    check_volume(j.vol, st.vol)

    full_scale = (tc.rows // tc.raycast_subsample) * (tc.cols // tc.raycast_subsample) > 8192
    can = se3.transform_points(st.pose, st.can_points).reshape(-1, 3)
    ins = tc.node_insert_stride if full_scale else 1
    cand = can[::ins]
    field = warpfield.insert_nodes(tc, solved, cand, ok & ~torch.isnan(cand[:, 0]), st.frame_idx)
    for name in ("positions", "radius", "active", "count", "last_support"):
        np.testing.assert_array_equal(getattr(field, name).numpy(), np.asarray(getattr(j.warp, name)), err_msg=name)

    band = tkinfu._temporal_band(tc, st.can_points, dists) if tc.raycast_temporal_band else None
    (tp, tn), can_p, can_n = tkinfu._model_maps(
        tc, st.vol, pose, nxt.warp, t_band=band, dq_grid=cf.dq if full_scale else None,
    )
    check_maps((j.can_points, *j.prev_points), (can_p, *tp))
    check_maps((j.can_normals, *j.prev_normals), (can_n, *tn), normals=True)
    return cost0_rel


def sphere_problem(seed, n_nodes, n_points, active_frac=0.95):
    """(JAX field, port field, JAX inputs, port inputs) of a warp solve on a
    sphere surface seen by the solver: canonical points on a sphere of
    radius 0.2 m at z = 1 m with radial normals, ``n_nodes`` nodes sampled
    from the surface with small random transforms (each active with
    probability ``active_frac``), live points displaced along the normal by
    a smooth bump plus noise, some points NaN; all from ``seed`` with
    numpy."""
    rng = np.random.RandomState(seed)
    c = np.array([0.0, 0.0, 1.0], np.float32)

    def sphere(m):
        v = rng.randn(m, 3)
        v[:, 2] = -np.abs(v[:, 2])  # the camera-facing half
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    nrm_n = sphere(n_nodes)
    pos = c + 0.2 * nrm_n
    act = rng.rand(n_nodes) < active_frac
    dq = np.asarray(jdq.from_twist(jnp.asarray(rng.randn(n_nodes, 3).astype(np.float32) * 0.01),
                                   jnp.asarray(rng.randn(n_nodes, 3).astype(np.float32) * 0.002)))
    jfield = jw.WarpField(jnp.asarray(pos), jnp.asarray(dq), jnp.full((n_nodes,), 0.05, jnp.float32),
                          jnp.asarray(act), jnp.int32(act.sum()), jnp.zeros((n_nodes,), jnp.int32))
    n = sphere(n_points)
    p_can = c + 0.2 * n
    bump = 0.004 * np.exp(-np.sum((n - [0.3, 0.0, -0.95]) ** 2, axis=1) / 0.1)
    p_live = p_can + n * bump[:, None] + rng.randn(n_points, 3).astype(np.float32) * 5e-4
    n_live = n.copy()
    p_can[::37] = np.nan
    p_live[::41] = np.nan
    arrs = [p_can.astype(np.float32), n.astype(np.float32), p_live.astype(np.float32), n_live.astype(np.float32)]
    ji = js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs))
    ti = ts.WarpSolveInputs(*(torch.from_numpy(np.array(a)) for a in arrs))
    return jfield, tw.WarpField(*(torch.from_numpy(np.array(a)) for a in jfield)), ji, ti
