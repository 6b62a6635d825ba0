"""Dataset reading: VolumeDeform-layout depth/color PNG sequences (a copy
of ``dynamicfusion_tpu.io.dataset``): ``<dir>/depth`` and ``<dir>/color``
PNGs in filename order, decoded through the native prefetching loader
(``io.native_loader``).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dynamicfusion_tpu_torch.io import native_loader


def _sorted_pngs(d: str) -> List[str]:
    if not os.path.isdir(d):
        return []
    return [
        os.path.join(d, f)
        for f in sorted(os.listdir(d))
        if f.lower().endswith(".png")
    ]


class DepthSequence:
    """Depth (uint16 mm) + optional color frames from a dataset directory."""

    def __init__(self, root: str, threads: int = 4, prefetch: int = 8):
        self.depth_paths = _sorted_pngs(os.path.join(root, "depth"))
        self.color_paths = _sorted_pngs(os.path.join(root, "color"))
        if not self.depth_paths:
            raise FileNotFoundError(f"no depth PNGs under {root}/depth")
        self._depth = native_loader.PrefetchingSequence(
            self.depth_paths, threads=threads, depth=prefetch
        )

    def __len__(self) -> int:
        return len(self.depth_paths)

    def depth(self, idx: int) -> np.ndarray:
        d = self._depth[idx]
        if d.dtype != np.uint16:
            d = d.astype(np.uint16)
        return d

    def color(self, idx: int) -> Optional[np.ndarray]:
        if idx < len(self.color_paths):
            return native_loader.read_png(self.color_paths[idx])
        return None

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self.depth(i)

    def close(self):
        self._depth.close()
