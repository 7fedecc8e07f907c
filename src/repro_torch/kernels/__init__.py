"""The port's kernels: hand-written CUDA C++ for Hopper (``sm_90a``).

- divergence.py : per-row Σ(a−b)² (Eq. 3), ``csrc/divergence.cu``.
- aggregate.py  : ``acc + w[:, None]·x`` (Eq. 5), ``csrc/aggregate.cu``.
- ref.py        : plain PyTorch versions (ground truth + CPU path).
- ops.py        : dispatch on the tensor's device, launch counts.
- _build.py     : ``nvcc`` at first use, ``ctypes`` binding.
"""
from repro_torch.kernels import aggregate, divergence, ops, ref

__all__ = ["aggregate", "divergence", "ops", "ref"]
