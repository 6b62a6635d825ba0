"""Device selection for the port's entry points, and cached device constants."""

from __future__ import annotations

import functools

import torch


def resolve(device="cuda") -> torch.device:
    """The torch device an entry point runs on. CUDA is the default; the CPU
    runs the plain PyTorch path and only when asked for. Raises when CUDA
    is asked for and absent: nothing falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False "
                "(pass device='cpu' to run the plain PyTorch path)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=64)
def const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The tuple ``values`` as a tensor on ``device``, copied there once and
    reused: a copy from pageable host memory waits for the device, so the
    frame loop makes none. Callers must not write into the result."""
    return torch.tensor(values, dtype=dtype).to(device)
