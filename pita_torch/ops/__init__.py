"""Kernels (CUDA C++ under ``pita_torch/csrc/``) with their plain versions,
and the plain tensor ops of the sampler (resampling, divergence)."""
