"""Kernel M's library route on the CPU: ``chip_smoke.library_p2p_gate``
(the one-hot features, two ``F.avg_pool2d(..., divisor_override=1)`` box
sums along W and then along H, the three-bin gather, the closed form in
torch ops) held against the plain version ``kinfu._p2p_gate_plain`` on
every case of ``chip_smoke.GATE_CASES`` but "vga" (held on the card by
``chip_smoke.gate_kernels``; on one CPU thread its plain version alone
takes ~11 s): the depth bins equal, the gate
within ``chip_smoke.TOL_GATE_LIBRARY`` (the pooling may sum in another
order than the taps'; on these cases it is bit-equal on the CPU).

No JAX: numpy-made inputs, a second or two on one process.
"""

import dataclasses

import pytest
import torch

from chip_smoke import GATE_CASES, TOL_GATE_LIBRARY, gate_case, library_p2p_gate
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.pipeline import kinfu
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = dataclasses.replace(DynamicFusionConfig.quality_dynamicfusion(), solver_p2p_adaptive=True)


@pytest.mark.parametrize("name", [n for n in GATE_CASES if n != "vga"])
def test_library_gate_is_the_plain_gate(name):
    gin = tuple(torch.from_numpy(a) for a in gate_case(name))
    plain = kinfu.p2p_gate(CFG, *gin, plain=True)
    lib = library_p2p_gate(torch, CFG, *gin)
    assert lib.shape == plain.shape and lib.dtype == torch.float32
    assert float((lib - plain).abs().max()) <= TOL_GATE_LIBRARY
    if name != "sphere":  # the sphere's windows open the gate fully or not at all
        assert bool(((plain > 0) & (plain < 1)).any())  # the closed form is exercised


def test_library_gate_with_an_even_window():
    """An even window sums from lo = (w - 1) // 2 before to w - 1 - lo
    after, as the plain version pads."""
    cfg = dataclasses.replace(CFG, solver_p2p_gate_window=16)
    gin = tuple(torch.from_numpy(a) for a in gate_case("random"))
    plain = kinfu.p2p_gate(cfg, *gin, plain=True)
    assert float((library_p2p_gate(torch, cfg, *gin) - plain).abs().max()) <= TOL_GATE_LIBRARY
    assert bool((plain > 0).any())
