"""PyTorch/CUDA port of the funcJAX model and serving stack.

Mirrors the layout of ``repro`` (the JAX reference package) module for module.
The port imports ``torch`` and never ``jax`` or anything of ``repro``; the
attention kernels are CUDA C++ for Hopper (``kernels/flash_attention/csrc``),
built with ``nvcc`` at first use.
"""
