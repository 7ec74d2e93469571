"""tpullama_torch — the PyTorch/CUDA port of tpullama for NVIDIA Hopper.

The JAX package `tpullama` is the reference; this package imports nothing
of it (nor of JAX). Entry points run on the CUDA card unless the caller
passes device="cpu"; the hand-written kernels live in ops/cuda (wrappers)
and csrc (CUDA C++ sources, built with nvcc on first use).
"""
