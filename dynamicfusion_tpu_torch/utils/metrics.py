"""Per-phase timing and trace capture.

``PhaseTimer`` accumulates host wall-clock per named phase; given the
phase's output tensors (``sync``) it waits for their device first, so the
time covers the device work and not only the enqueue. ``trace`` records a
``torch.profiler`` trace (CPU and, where a card exists, CUDA activity) as
a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import torch


def _devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in a nested tuple/list/dict."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _devices(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _devices(v, out)
    return out


def wait_for(obj) -> None:
    """Wait for the devices of the CUDA tensors in ``obj``; CPU tensors
    need no wait."""
    for dev in _devices(obj, set()):
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates wall-clock per named phase. ``sync`` (the phase's output
    tensors) makes the phase wait for their device before it stops the
    clock. Keep it out of windows that must not wait for the device, or
    give it ``sync=None`` there."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            wait_for(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return 1000.0 * self.totals[name] / c if c else 0.0

    def report(self) -> str:
        lines = [
            f"  {k:24s} {self.mean_ms(k):9.2f} ms/frame  (x{self.counts[k]})"
            for k in sorted(self.totals, key=lambda k: -self.totals[k])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler over the block, written to ``log_dir/trace.json``
    (default: ``df_trace`` in the temporary directory); view it in a Chrome
    trace viewer or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "df_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
