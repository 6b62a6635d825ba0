"""The slice as a whole against the JAX package, on the CPU: the
reference-shaped rigid KinectFusion (``integrate_mode="dense"``: every
voxel fused, kernel F1's plain version; ``raycast_smooth_normals``: the
six-sample normal in kernel C's plain version) and one dense non-rigid
step with the newton16 refine (kernel F2's plain version and kernel C's
refine 2).

- Rigid, four orbit frames at ``small(dims=64, rows=120, cols=160)``:
  frame 0's volume and maps, then each step of the port from JAX's
  previous state (pose TOL_POSE, and at JAX's pose the dense fusion and the
  model maps), as tests/test_torch_full_res.py holds the brick slice.
- Non-rigid, the set-up of tests/torch_nonrigid_cases.py (``small()`` with
  the dynamicfusion preset's settings) with dense fusion and newton16
  (``NONRIGID``): tests/test_torch_dense_slice_nonrigid.py, a file of its
  own so that ``--dist loadfile`` spreads the JAX compiles over the
  workers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

RIGID = dict(max_nodes=64, node_sample_step=17, rigid_only=True, integrate_mode="dense",
             raycast_smooth_normals=True)
# A process's first torch.sqrt runs on one thread: MKL's vectorized sqrt,
# which CPU torch calls, has returned one thread's chunk at ~12 bits when
# that first call ran on several threads at once
torch.sqrt(torch.ones(1))

JC = dataclasses.replace(JCfg.small(dims=64, rows=120, cols=160), **RIGID)
TC = dataclasses.replace(TCfg.small(dims=64, rows=120, cols=160), **RIGID)
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
NONRIGID = dict(integrate_mode="dense", raycast_refine="newton16")

TOL_POSE = 1e-4  # every entry of the pose, the port's step from JAX's state


@functools.lru_cache(maxsize=1)
def _depths():
    return [
        synthetic.scene_depth(JC.intr, JC.rows, JC.cols, synthetic.orbit_pose(a, target=TARGET), **SCENE)
        for a in ANGLES
    ]


@pytest.fixture(scope="module")
def rigid_run():
    """JAX over the orbit, jitted: per frame (state, outputs) as numpy."""
    return cases.jax_run(JC, _depths())


def _check_volume(jv, tv):
    """Codes within 1 LSB but on TOL_LSB_FRAC of voxels, weights equal."""
    jt, tt = np.asarray(jv.tsdf).astype(np.int64), tv.tsdf.numpy().astype(np.int64)
    assert (np.abs(jt - tt) > 1).mean() < cases.TOL_LSB_FRAC
    np.testing.assert_array_equal(np.asarray(jv.weight), tv.weight.numpy())


def test_rigid_first_frame_matches_jax(rigid_run):
    j = rigid_run[0][0]
    ts = tkinfu.first_frame(TC, tkinfu.init_state(TC, "cpu"), torch.from_numpy(_depths()[0]))
    _check_volume(j.vol, ts.vol)
    cases.check_maps(j.prev_points, ts.prev_points)
    cases.check_maps(j.prev_normals, ts.prev_normals, normals=True)


@pytest.mark.parametrize("frame", [1, 2, 3])
def test_rigid_step_from_jax_state(rigid_run, frame):
    """The port's rigid step from JAX's state: JAX's pose; then at JAX's
    pose the dense fusion gives JAX's volume and the six-sample-normal
    raycast JAX's maps."""
    (j_prev, _), (j, jo) = rigid_run[frame - 1], rigid_run[frame]
    depth = torch.from_numpy(_depths()[frame])
    _, to = tkinfu.step(TC, interop.state_from_numpy(j_prev, "cpu"), depth)
    assert bool(to.icp_ok) and bool(jo.icp_ok)
    assert np.abs(to.pose.numpy() - jo.pose).max() <= TOL_POSE
    assert to.brick_counts.tolist() == np.asarray(jo.brick_counts).tolist() == [0, 0, 0]

    st = interop.state_from_numpy(j_prev, "cpu")
    pose = torch.from_numpy(jo.pose)
    _, _, _, dists = tpre.build_frame_pyramid(TC, depth, first_point_level=TC.raycast_shift)
    vol2cam = se3.compose(se3.inverse(pose), tkinfu._vol_pose(TC, pose.device))
    ttsdf.integrate(TC, st.vol, dists, vol2cam, TC.intr)
    _check_volume(j.vol, st.vol)
    seed, band = tkinfu._march_bands(TC, st.can_points, dists, False)
    (tp, tn), _, _ = tkinfu._model_maps(TC, st.vol, pose, t_seed=seed, t_band=band)
    cases.check_maps(j.prev_points, tp)
    cases.check_maps(j.prev_normals, tn, normals=True)
