"""The base ``DynamicFusionConfig()``'s steps (the direct solve, int8
Gram, lagged JᵀJ, one factor reused; its fusion every second frame) on
bench.py's deforming scene at ``small()`` against the JAX package, on the
CPU: each step from JAX's state and the free-running frames
(tests/torch_nonrigid_cases.py). A file of its own, so that ``--dist
loadfile`` spreads the dense solve's JAX compiles over the workers.
"""

import dataclasses

import pytest
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg


STEPS = 3
# the base config at small(): its fusion every second frame (small() fuses
# every frame)
BASE = dict(fusion_interval=2)


@pytest.fixture(scope="module")
def base_case():
    jc, tc = (dataclasses.replace(c.small(), **BASE) for c in (JCfg, TCfg))
    depths = cases.bench_depths(jc, STEPS + 1)
    jax_frames = cases.jax_run(jc, depths)
    return jc, tc, depths, jax_frames


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_base_config_step_from_jax_state_matches(base_case, frame):
    jc, tc, depths, jax_frames = base_case
    assert tc.solver_linear == "direct" and tc.solver_lagged_jtj and tc.solver_jtj_int8 and tc.solver_chol_reuse
    cases.check_step_from_jax_state(jc, tc, jax_frames, depths, frame)


def test_base_config_free_running_matches_jax(base_case):
    jc, tc, depths, jax_frames = base_case
    port_frames = cases.port_run(tc, depths)
    spread = cases.jax_spread(jc, depths, jax_frames)
    for frame in range(1, STEPS + 1):
        cases.check_free_running(jax_frames, port_frames, frame, spread)
    fused = [int(port_frames[f][1].brick_counts[:2].sum()) > 0 for f in range(1, STEPS + 1)]
    assert fused == [f % 2 == 0 for f in range(1, STEPS + 1)]
