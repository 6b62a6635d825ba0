"""The pipeline options that once refused, run on the CPU: the coarse-band
prepass and the fresh canonical raycast at ``small()``, and the net rigid
removal of the warp field held against the JAX package (the port's step
from JAX's state, tests/torch_nonrigid_cases.py). A file of its own, so
that ``--dist loadfile`` spreads the JAX compiles over the workers.
"""

import dataclasses

import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu


@pytest.mark.parametrize("option,against_jax", [
    ("coarse_band", False), ("reuse_model_raycast", False), ("solver_remove_net_rigid", True),
])
def test_pipeline_options_refuse_as_ported(option, against_jax):
    """None of these pipeline options refuses any more: the coarse-band
    prepass and the fresh canonical raycast run, and the net rigid removal
    of the warp field (once refused) runs too, held against the JAX
    package: the port's step from JAX's state with the removal gives
    JAX's pose, initial solve cost, fusion, node insertion and maps
    (tests/torch_nonrigid_cases.py; the removal itself is held in
    tests/test_torch_warp_options.py)."""
    jbase, base = cases.configs(dims=32, rows=60, cols=80)
    cfg = {
        "coarse_band": dataclasses.replace(base, raycast_subsample=1, rows=240, cols=320, rigid_only=True,
                                           intr=TCfg.small(rows=240, cols=320).intr),
        "reuse_model_raycast": dataclasses.replace(base, reuse_model_raycast=False),
        "solver_remove_net_rigid": dataclasses.replace(base, solver_remove_net_rigid=True, solver_net_rigid_alpha=0.5),
    }[option]
    if against_jax:
        jc = dataclasses.replace(jbase, solver_remove_net_rigid=True, solver_net_rigid_alpha=0.5)
        # the step of frame 2, from JAX's state after its first removal (at
        # this size frame 1's ICP from frame 0's state is sensitive with the
        # option off too: 3 mm)
        depths = cases.bench_depths(cfg, 3)
        cases.check_step_from_jax_state(jc, cfg, cases.jax_run(jc, depths), depths, 2)
        return
    depth = torch.from_numpy(cases.bench_depths(cfg, 1)[0])
    state = tkinfu.first_frame(cfg, tkinfu.init_state(cfg, "cpu"), depth)
    _, out = tkinfu.step(cfg, state, depth)
    assert bool(out.icp_ok)
