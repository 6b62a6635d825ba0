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
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.io import synthetic
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

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


def check_volume(jv, tv):
    """Codes differing by more than 1 LSB on < TOL_LSB_FRAC of voxels,
    weights within 1 LSB (fractional observation weights make a weight a
    sum of rounded codes)."""
    jt, tt = np.asarray(jv.tsdf).astype(np.int64), tv.tsdf.numpy().astype(np.int64)
    assert (np.abs(jt - tt) > 1).mean() < TOL_LSB_FRAC
    jw_, tw_ = np.asarray(jv.weight).astype(np.int64), tv.weight.numpy().astype(np.int64)
    assert np.abs(jw_ - tw_).max() <= 1


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
    """Per frame, JAX's own (translation, rotation) spread: the largest pose
    difference of its runs from perturbed frame-0 node positions."""
    runs = [jax_run(jc, depths, seed) for seed in PERTURB_SEEDS]
    return [None] + [
        tuple(max(v) for v in zip(*(_pose_diff(r[f][1].pose, jax_frames[f][1].pose) for r in runs)))
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
    and maps."""
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.models import warpfield
    from dynamicfusion_tpu_torch.ops import fusion, preprocess

    (j_prev, _), (j, jo) = jax_frames[frame - 1], jax_frames[frame]
    depth = torch.from_numpy(depths[frame])
    _, to = tkinfu.step(tc, interop.state_from_numpy(j_prev, "cpu"), depth)
    assert bool(to.icp_ok) == bool(jo.icp_ok)
    assert np.abs(jo.pose - to.pose.numpy()).max() <= TOL_POSE
    c0 = float(jo.solver_cost0)
    assert abs(float(to.solver_cost0) - c0) <= tol_cost0 * c0
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
    counts = fusion.integrate_nonrigid(tc, st.vol, cf, dists, se3.inverse(pose), tc.intr, ok, conf=conf)
    np.testing.assert_array_equal(jo.brick_counts, counts.numpy())
    check_volume(j.vol, st.vol)

    full_scale = (tc.rows // tc.raycast_subsample) * (tc.cols // tc.raycast_subsample) > 8192
    can = se3.transform_points(st.pose, st.can_points).reshape(-1, 3)
    ins = tc.node_insert_stride if full_scale else 1
    cand = can[::ins]
    field = warpfield.insert_nodes(tc, solved, cand, ok & ~torch.isnan(cand[:, 0]), st.frame_idx)
    for name in ("positions", "radius", "active", "count", "last_support"):
        np.testing.assert_array_equal(getattr(field, name).numpy(), np.asarray(getattr(j.warp, name)), err_msg=name)

    band = tkinfu._temporal_band(tc, st.can_points, dists)
    (tp, tn), can_p, can_n = tkinfu._model_maps(
        tc, st.vol, pose, nxt.warp, t_band=band, dq_grid=cf.dq if full_scale else None,
    )
    check_maps((j.can_points, *j.prev_points), (can_p, *tp))
    check_maps((j.can_normals, *j.prev_normals), (can_n, *tn), normals=True)
