"""Image and volume ops: depth preprocessing, TSDF raycast and extraction,
brick-sparse integration. Functions that own a CUDA kernel dispatch on the
device of their input: CPU tensors take the plain PyTorch version, CUDA
tensors the kernel (``dynamicfusion_tpu_torch.kernels``)."""
