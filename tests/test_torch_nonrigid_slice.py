"""The port's non-rigid DynamicFusion step against the JAX package, frame
by frame, on the CPU: bench.py's deforming scene (two spheres over a
plane, the small one oscillating) at ``small()`` with the slice's solver,
fusion and raycast settings, three steps after frame 0. ``small()`` has
4 800 solve points, below the 8 192 where the full-scale branches start:
tests/test_torch_nonrigid_full_scale.py covers those.

As in tests/test_torch_slice.py each frame is held twice: the port
carrying its own state (pose within 1e-3 or twice JAX's own spread under a
1e-7 perturbation, equal node counts: torch_nonrigid_cases), and the
port's step from JAX's previous state, whose ICP, pre-alignment, initial
solve cost, fusion, node lifecycle and model maps are held against JAX's
own. The solve's final cost is held only to fall (see
test_torch_warp_solver.py: the bf16 rows make the LM step sensitive to
last bits in both packages).
"""

import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

JC, TC = cases.configs()
STEPS = 3


@pytest.fixture(scope="module")
def depths():
    return cases.bench_depths(JC, STEPS + 1)


@pytest.fixture(scope="module")
def jax_frames(depths):
    return cases.jax_run(JC, depths)


@pytest.fixture(scope="module")
def port_frames(depths):
    return cases.port_run(TC, depths)


@pytest.fixture(scope="module")
def spread(depths, jax_frames):
    return cases.jax_spread(JC, depths, jax_frames)


def test_first_frame_matches_jax(jax_frames, port_frames):
    j, t = jax_frames[0][0], port_frames[0][0]
    cases.check_volume(j.vol, interop.state_from_numpy(t, "cpu").vol)
    assert int(j.warp.count) == int(t["warp"]["count"]) == TC.max_nodes
    np.testing.assert_allclose(t["warp"]["positions"], j.warp.positions, atol=1e-6, rtol=0)
    cases.check_maps((j.can_points, *j.prev_points), (t["can_points"], *t["prev_points"]))


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_free_running_matches_jax(jax_frames, port_frames, spread, frame):
    cases.check_free_running(jax_frames, port_frames, frame, spread)
    assert int(port_frames[frame][0]["frame_idx"]) == frame + 1


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_step_from_jax_state_matches(jax_frames, depths, frame):
    cases.check_step_from_jax_state(JC, TC, jax_frames, depths, frame)


def test_driver_runs_the_nonrigid_frames(port_frames, depths):
    df = tkinfu.DynamicFusion(TC, device="cpu")
    assert df(depths[0]) is False
    for d in depths[1:]:
        assert df(d) is True
    for i in range(1, STEPS + 1):
        np.testing.assert_array_equal(df.get_pose(i).numpy(), port_frames[i][1].pose.numpy())
    out = df.last_outputs
    assert float(out.solver_cost0) > 0.0 and float(out.solver_cost1) <= float(out.solver_cost0)
    assert out.model_points.shape == (TC.rows // TC.raycast_subsample, TC.cols // TC.raycast_subsample, 3)


def test_nonrigid_slice_preset_is_the_preset_with_secant():
    from dynamicfusion_tpu.config import DynamicFusionConfig as J
    import dataclasses

    t = tkinfu.DynamicFusionConfig.nonrigid_slice()
    assert dataclasses.astuple(t) == dataclasses.astuple(dataclasses.replace(J.default_dynamicfusion(), raycast_refine="secant"))
    assert not t.rigid_only and t.solver_linear == "pcg" and t.max_nodes == 1024


def test_failed_tracking_leaves_the_model_untouched(jax_frames, depths):
    """A depth frame ICP cannot track (blank) fuses nothing, keeps the
    pose and the warp field, as JAX's step does."""
    st = interop.state_from_numpy(jax_frames[2][0], "cpu")
    tsdf0, field0 = st.vol.tsdf.clone(), [a.clone() for a in st.warp]
    new, out = tkinfu.step(TC, st, torch.zeros_like(torch.from_numpy(depths[0])))
    assert not bool(out.icp_ok)
    assert torch.equal(new.vol.tsdf, tsdf0) and torch.equal(out.pose, st.pose)
    for a, b in zip(new.warp, field0):
        assert torch.equal(a, b)
