"""PyTorch/CUDA port of PITA for NVIDIA Hopper (H100).

Counterpart of ``pita_tpu``: the same module layout and names, written in
PyTorch. Kernels that ``pita_tpu`` wrote in Pallas for the TPU are CUDA C++
kernels for ``sm_90a`` under ``pita_torch/csrc/``, built with ``nvcc`` at
first use (``pita_torch/ops/_build.py``). Each kernel wrapper launches its
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU tensor.

The package imports torch, numpy and scipy only — never jax, flax, msgpack
or ``pita_tpu``.
"""

__version__ = "0.1.0"
