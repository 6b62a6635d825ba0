"""The non-rigid ``reference_parity()``'s step (its solver and fusion
options on the direct solve) from the JAX package's state on bench.py's
deforming scene at ``small()``, on the CPU (tests/torch_nonrigid_cases.py).
A file of its own, so that ``--dist loadfile`` spreads the dense solve's
JAX compiles over the workers.
"""

import dataclasses

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg

# reference_parity()'s solver and fusion options
PARITY = dict(node_radius=3.0, solver_tukey_c=0.01, solver_huber_delta=1e-4, solver_arap_weight=200.0,
              fusion_interval=1)


def test_reference_parity_step_from_jax_state_matches():
    jc, tc = (dataclasses.replace(c.small(), **PARITY) for c in (JCfg, TCfg))
    depths = cases.bench_depths(jc, 2)
    cases.check_step_from_jax_state(jc, tc, cases.jax_run(jc, depths), depths, 1)
