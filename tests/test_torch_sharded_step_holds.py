"""The port's sharded frame step (parallel.sharded) held on the CPU:
against the JAX package's single-device step at tests/test_sharding.py's
config (8 shards), against the port's own single-device step under the
dynamicfusion preset's settings at ``small()`` (4 shards: the slab
raycast, the slab brick fusion and the distributed PCG all in the path),
and two processes of two shards each over gloo against the one-process
mesh. tests/test_torch_sharded_step.py's holds (its configs, tolerances
and volume oracle), in a file of its own so that ``--dist loadfile``
spreads the JAX compile and the processes over the workers.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamicfusion_tpu.io import synthetic as jsyn
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.io import synthetic
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.parallel import multihost, sharded
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from test_torch_sharded_step import (ROOT, SH, SLICE, TIMEOUT_S, TOL_COST0_REL, TOL_MAP_M, TOL_POSE, _jax_state,
                                     cpu_mesh, hold_volume, one_torch_thread, tcfg)  # noqa: F401  (autouse)


def test_sharded_step_matches_jax_single_device():
    """8 shards at test_sharding's 32^3 config (the summed Schur assembly
    and its evaluation; slabs thinner than the raycast's halo and than a
    brick plane, so the raycast and the fusion run whole) against JAX's
    single-device step from the same frame-0 state; then one more step
    against the port's single-device step from the same state (the
    config's own run leaves the scene on its third step, sharded or not)."""
    tc = tcfg(SH)
    depth = jsyn.scene_depth(SH.intr, SH.rows, SH.cols, spheres=[dict(center=(0.0, 0.0, 0.8), radius=0.2)],
                             plane_z=1.1)
    mesh = cpu_mesh(8)
    state = sharded.make_sharded_first_frame(tc, mesh)(tkinfu.init_state(tc, "cpu"), torch.from_numpy(depth))
    step = sharded.make_sharded_step(tc, mesh)
    assert step.pieces == dict(solve=False, system=True, eval=True, integrate=False, raycast=False, whole=True)
    j_state, jo = jax.jit(lambda s, d: jkinfu.step(SH, s, d))(
        _jax_state(interop.state_to_numpy(state, mesh=mesh)), jnp.asarray(depth)
    )
    state, out = step(state, torch.from_numpy(depth))
    assert bool(out.icp_ok) == bool(jo.icp_ok)
    assert np.abs(out.pose.numpy() - np.asarray(jo.pose)).max() <= TOL_POSE
    c0 = float(jo.solver_cost0)
    assert abs(float(out.solver_cost0) - c0) <= TOL_COST0_REL * c0
    hold_volume(sharded.gather_state(mesh, state).vol.tsdf.numpy(), np.asarray(j_state.vol.tsdf))
    whole = sharded.gather_state(mesh, state)
    ref, ro = tkinfu.step(tc, whole._replace(vol=TsdfVolume(whole.vol.tsdf.clone(), whole.vol.weight.clone())),
                          torch.from_numpy(depth))
    state, out = step(state, torch.from_numpy(depth))
    assert bool(out.icp_ok) and bool(ro.icp_ok)
    assert np.abs(out.pose.numpy() - ro.pose.numpy()).max() <= TOL_POSE
    hold_volume(sharded.gather_state(mesh, state).vol.tsdf.numpy(), ref.vol.tsdf.numpy())
    assert int(state.frame_idx) == 3


def test_sharded_preset_matches_single_device_step():
    """The preset's settings at small() over 4 shards (16-plane slabs: the
    slab raycast, the slab brick fusion, the distributed PCG) against the
    port's single-device step with the fixed-step march, from the same
    state at every step; and against that step given the sharded step's
    solve (the same field), whose fusion the slab fusion equals bit for
    bit and whose canonical maps the slab raycast's within TOL_MAP_M."""
    tc = dataclasses.replace(TCfg.small(), **SLICE)
    ref_cfg = dataclasses.replace(tc, raycast_adaptive_step=False)
    depths = synthetic.deforming_frames(tc.intr, tc.rows, tc.cols, 4)
    mesh = cpu_mesh(4)
    step = sharded.make_sharded_step(tc, mesh)
    assert step.pieces == dict(solve=True, system=False, eval=False, integrate=True, raycast=True, whole=False)
    state = sharded.make_sharded_first_frame(tc, mesh)(tkinfu.init_state(tc, "cpu"), torch.from_numpy(depths[0]))
    for d in depths[1:]:
        whole = sharded.gather_state(mesh, state)
        ref_state = whole._replace(vol=TsdfVolume(whole.vol.tsdf.clone(), whole.vol.weight.clone()))
        ref, ro = tkinfu.step(ref_cfg, ref_state, torch.from_numpy(d))
        state, out = step(state, torch.from_numpy(d))
        assert bool(out.icp_ok) and bool(ro.icp_ok)
        assert np.abs(out.pose.numpy() - ro.pose.numpy()).max() <= TOL_POSE
        c0 = float(ro.solver_cost0)
        assert abs(float(out.solver_cost0) - c0) <= TOL_COST0_REL * c0
        assert out.brick_counts.tolist() == ro.brick_counts.tolist()
        hold_volume(sharded.gather_state(mesh, state).vol.tsdf.numpy(), ref.vol.tsdf.numpy())
        same, _ = tkinfu.step(ref_cfg, whole._replace(vol=TsdfVolume(whole.vol.tsdf.clone(),
                                                                     whole.vol.weight.clone())),
                              torch.from_numpy(d), **step.solver_hooks)
        vol = sharded.gather_state(mesh, state).vol
        assert torch.equal(vol.tsdf, same.vol.tsdf)
        assert torch.equal(vol.weight.to(torch.int32), same.vol.weight.to(torch.int32))
        a, b = state.can_points, same.can_points
        assert torch.equal(torch.isnan(a[..., 0]), torch.isnan(b[..., 0]))
        assert float(torch.nan_to_num((a - b).abs()).max()) <= TOL_MAP_M


def test_two_processes_match_one_process_mesh(tmp_path):
    """Two gloo ranks of two CPU shards each (4 shards), one step of the
    JAX package's multi-process worker config: the ranks' poses and costs
    equal, and bit-equal to make_mesh(4) in one process (the same
    reduction tree)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "dynamicfusion_tpu_torch.parallel.multihost", "--init-method",
             f"file://{tmp_path / 'store'}", "--world-size", "2", "--rank", str(r), "--local-shards", "2",
             "--device", "cpu", "--config", "small", "--frames", "1", "--out", outs[r]],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
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
    assert res[0]["shards"] == 4 and res[0]["backend"] == "gloo"
    assert res[0]["frames"] == res[1]["frames"]
    one = multihost.run_frames(multihost.worker_config("small"), cpu_mesh(4), 1)
    assert res[0]["frames"] == one
    assert one[0]["icp_ok"] and np.isfinite(one[0]["pose"]).all()
