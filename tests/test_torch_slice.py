"""The port's rigid KinectFusion slice against the JAX package, frame by
frame: a 4-frame orbit at ``DynamicFusionConfig.small()`` with
``rigid_only=True`` (the set-up of tests/test_rigid_mode.py), both run on
the CPU from the same numpy depth frames, the port through its plain
PyTorch path. The JAX pipeline runs op by op (``first_frame``/``step``
called directly).

ICP associates pixels by the floor of their projection, so a last-bit
difference in a transformed point (XLA and PyTorch round a 3-term dot
product differently) can move one pixel's association and the pose by
1e-5 m; fusion and the raycast then see that pose. So each frame is held
twice: the free-running pose against JAX's within 1e-4, and the fusion,
the brick counts and the model maps of the port run from JAX's previous
state at JAX's pose against JAX's own, to the last LSB.

The scene has four spheres over a plane, not test_rigid_mode.py's single
sphere: one sphere centred over a plane is symmetric about the plane's
normal through its centre, which leaves a rotation unobservable to
point-to-plane ICP, so the 6x6 system is near singular (eigenvalues 0.47
against 2.9e3) and a 2e-5 m difference in the model maps moves even the JAX
package's own pose by ~1 cm.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

KW = dict(max_nodes=64, node_sample_step=17, rigid_only=True)
JC = dataclasses.replace(JCfg.small(dims=64, rows=120, cols=160), **KW)
TC = dataclasses.replace(TCfg.small(dims=64, rows=120, cols=160), **KW)
TARGET = (0.0, 0.0, 0.9)
SCENE = dict(
    spheres=[
        dict(center=(0.0, 0.0, 0.9), radius=0.2),
        dict(center=(0.25, 0.15, 1.0), radius=0.12),
        dict(center=(-0.22, 0.12, 0.85), radius=0.1),
        dict(center=(0.1, -0.2, 0.95), radius=0.1),
    ],
    plane_z=1.2,
)
ANGLES = (0.0, 0.02, 0.04, 0.06)

# tolerances, per frame
TOL_POSE = 1e-4            # every entry of the (4, 4) pose: translation m, rotation
TOL_LSB_FRAC = 1e-4        # fraction of voxels whose tsdf codes differ by more than 1 LSB
TOL_MAP_VALID_FRAC = 1e-3  # fraction of model-map pixels valid in one package only
TOL_MAP_M = 1e-5           # model-map point error where both are valid, ...
TOL_MAP_FRAC = 1e-2        # ... except on this fraction of pixels (a one-LSB code
TOL_MAP_MAX_M = 1e-3       # difference moves a crossing), where it stays below this
TOL_NRM = 1e-4             # model-map normals (unit vectors), on the same terms:
TOL_NRM_MAX = 1e-2         # the normalized gradient of the 8 corners
TOL_TRUTH_M = 5e-3         # port pose vs the analytic orbit


@functools.lru_cache(maxsize=1)
def _depths():
    """The orbit's depth frames, made once: both packages must see the same
    arrays (the plane's depths sit on whole millimetres, where the last bit
    of the float64 render decides the uint16 truncation)."""
    return [
        synthetic.scene_depth(JC.intr, JC.rows, JC.cols, synthetic.orbit_pose(a, target=TARGET), **SCENE)
        for a in ANGLES
    ]


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def jax_run():
    """JAX over the orbit: per frame (state, outputs) as numpy."""
    depths = _depths()
    js = jkinfu.first_frame(JC, jkinfu.init_state(JC), jnp.asarray(depths[0]))
    frames = [(_np(js), None)]
    for d in depths[1:]:
        js, jo = jkinfu.step(JC, js, jnp.asarray(d))
        frames.append((_np(js), _np(jo)))
    return frames


@pytest.fixture(scope="module")
def port_run():
    """The port over the orbit, carrying its own state: per frame (state
    as numpy, outputs)."""
    depths = _depths()
    ts = tkinfu.first_frame(TC, tkinfu.init_state(TC, "cpu"), torch.from_numpy(depths[0]))
    frames = [(interop.state_to_numpy(ts), None)]
    for d in depths[1:]:
        ts, to = tkinfu.step(TC, ts, torch.from_numpy(d))
        frames.append((interop.state_to_numpy(ts), to))
    return frames


def _check_volume(jv, tv):
    jt, tt = jv.tsdf.astype(np.int64), tv.tsdf.numpy().astype(np.int64)
    assert tv.tsdf.dtype == torch.int16 and tv.weight.dtype == torch.uint16
    assert (np.abs(jt - tt) > 1).mean() < TOL_LSB_FRAC
    np.testing.assert_array_equal(jv.weight, tv.weight.numpy())


def _check_maps(j_pts, t_pts, j_nrm, t_nrm):
    """Model maps: base level and tracking pyramid, points and normals."""
    for jm, tm, tol, tol_max in [(a, b, TOL_MAP_M, TOL_MAP_MAX_M) for a, b in zip(j_pts, t_pts)] + [
        (a, b, TOL_NRM, TOL_NRM_MAX) for a, b in zip(j_nrm, t_nrm)
    ]:
        tm = np.asarray(tm)
        vj, vt = ~np.isnan(jm[..., 0]), ~np.isnan(tm[..., 0])
        assert (vj != vt).mean() <= TOL_MAP_VALID_FRAC
        both = vj & vt
        assert both.mean() > 0.3
        err = np.abs(jm[both] - tm[both]).max(axis=-1)
        assert (err > tol).mean() <= TOL_MAP_FRAC and err.max() <= tol_max


def test_first_frame_matches_jax(jax_run, port_run):
    j, t = jax_run[0][0], port_run[0][0]
    _check_volume(j.vol, interop.state_from_numpy(t, "cpu").vol)
    _check_maps(
        (j.can_points, *j.prev_points), (t["can_points"], *t["prev_points"]),
        (j.can_normals, *j.prev_normals), (t["can_normals"], *t["prev_normals"]),
    )
    assert int(j.frame_idx) == int(t["frame_idx"]) == 1
    assert int(j.warp.count) == int(t["warp"]["count"]) == TC.max_nodes
    np.testing.assert_array_equal(j.warp.active, t["warp"]["active"])
    # node positions: extracted crossings, one float32 division each
    np.testing.assert_allclose(j.warp.positions, t["warp"]["positions"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("frame", range(1, len(ANGLES)))
def test_free_running_pose_matches_jax(jax_run, port_run, frame):
    jo, to = jax_run[frame][1], port_run[frame][1]
    assert bool(jo.icp_ok) and bool(to.icp_ok)
    assert np.abs(jo.pose - to.pose.numpy()).max() <= TOL_POSE
    assert int(jo.node_count) == int(to.node_count) == TC.max_nodes
    assert int(port_run[frame][0]["frame_idx"]) == frame + 1
    truth = synthetic.orbit_pose(ANGLES[frame], target=TARGET)
    assert np.linalg.norm(to.pose.numpy()[:3, 3] - truth[:3, 3]) < TOL_TRUTH_M


@pytest.mark.parametrize("frame", range(1, len(ANGLES)))
def test_step_from_jax_state_matches(jax_run, frame):
    """The port's step from JAX's previous state: its pose, and its fusion,
    brick counts and model maps at JAX's pose, against JAX's step."""
    (j_prev, _), (j, jo) = jax_run[frame - 1], jax_run[frame]
    depth = torch.from_numpy(_depths()[frame])
    _, to = tkinfu.step(TC, interop.state_from_numpy(j_prev, "cpu"), depth)
    assert bool(to.icp_ok) == bool(jo.icp_ok)
    assert np.abs(jo.pose - to.pose.numpy()).max() <= TOL_POSE

    st = interop.state_from_numpy(j_prev, "cpu")
    pose = torch.from_numpy(jo.pose)
    dists = tpre.compute_dists(TC.intr, depth)
    vol2cam = tkinfu.se3.compose(tkinfu.se3.inverse(pose), tkinfu._vol_pose(TC, "cpu"))
    counts = ttsdf.integrate(TC, st.vol, dists, vol2cam, TC.intr, ok=torch.tensor(bool(jo.icp_ok)))
    np.testing.assert_array_equal(jo.brick_counts, counts.numpy())
    _check_volume(j.vol, st.vol)
    (pts, nrm), can_pts, can_nrm = tkinfu._model_maps(TC, st.vol, pose)
    _check_maps((j.can_points, *j.prev_points), (can_pts, *pts), (j.can_normals, *j.prev_normals), (can_nrm, *nrm))


def test_driver_runs_the_same_frames(port_run):
    """The host driver (first frame, steps, trajectory, reset) on the CPU
    gives the functional pipeline's poses."""
    df = tkinfu.DynamicFusion(TC, device="cpu")
    depths = _depths()
    assert df(depths[0]) is False
    for d in depths[1:]:
        assert df(d) is True
    for i in range(1, len(ANGLES)):
        np.testing.assert_array_equal(df.get_pose(i).numpy(), port_run[i][1].pose.numpy())
    assert torch.equal(df.get_pose(), df.get_pose(len(ANGLES) - 1))
    assert torch.equal(df.get_pose(99), df.get_pose(-1))
    assert int(df.state.frame_idx) == len(ANGLES)
    df.reset()
    assert not df._started and len(df.poses) == 1 and int(df.state.frame_idx) == 0


def test_driver_restores_a_jax_state(jax_run):
    """A JAX state carried across with interop resumes mid-sequence: the
    next call is a full step, and it matches the JAX step from that state."""
    df = tkinfu.DynamicFusion(TC, device="cpu")
    df.restore(interop.state_from_numpy(jax_run[2][0], "cpu"))
    assert df(_depths()[3]) is True
    np.testing.assert_allclose(df.last_outputs.pose.numpy(), jax_run[3][1].pose, atol=TOL_POSE, rtol=0)


def test_rigid_driver_pins_secant():
    cfg = dataclasses.replace(TC, raycast_refine="newton8")
    assert tkinfu.DynamicFusion(cfg, device="cpu").cfg.raycast_refine == "secant"
