"""Static-size stream compaction: the port's ``jnp.nonzero(size=, fill_value=)``.

``torch.nonzero`` returns a data-dependent shape and so waits for the
device; this runs as a cumulative sum and a scatter into a fixed-size
output, with no host sync.
"""

from __future__ import annotations

import torch


def first_true(mask: torch.Tensor, size: int, fill: int = -1) -> torch.Tensor:
    """(size,) int64 indices of the first ``size`` True entries of the 1-D
    ``mask`` in order; slots past the number of True entries hold ``fill``."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (rank < size)
    # entries not kept land in a spare slot past the end, dropped below
    pos = torch.where(keep, rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, pos, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]
