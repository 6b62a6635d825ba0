"""dynamicfusion_tpu_torch: the PyTorch/CUDA port of dynamicfusion_tpu.

The JAX package ``dynamicfusion_tpu`` is the reference; this package runs
the same per-frame pipeline over the same state with PyTorch on an NVIDIA
GPU, its hot kernels hand-written in CUDA (``csrc/``, loaded by
``kernels``). It imports nothing of the JAX package.

Layout mirrors the JAX package: ``core`` (SE(3), camera), ``models``
(volume, warp field), ``ops`` (preprocess, TSDF, bricks), ``solvers``
(ICP), ``pipeline`` (the frame loop), ``io`` (synthetic scenes), plus
``interop`` (state conversion from/to numpy) and ``kernels``.

Entry points take a ``device`` that defaults to ``"cuda"``; the plain
PyTorch path runs only where the caller asks for the CPU.
"""

from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics

__all__ = ["DynamicFusionConfig", "Intrinsics"]
