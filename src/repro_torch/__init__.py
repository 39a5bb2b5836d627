"""PyTorch/CUDA port of the SiLQ serving stack, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing
of it and no ``jax``. Kernels under ``csrc/`` are CUDA C++ built with
``nvcc`` at first use (see ``repro_torch.kernels.build``); every kernel
has a plain PyTorch version beside it, which runs for CPU tensors.
"""
