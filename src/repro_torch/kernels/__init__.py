"""The port's kernels: hand-written CUDA C++ for Hopper (``sm_90a``).

- divergence.py : per-row Σ(a−b)² (Eq. 3), ``csrc/divergence.cu``.
- aggregate.py  : ``acc + w[:, None]·x`` (Eq. 5), ``csrc/aggregate.cu``.
- uplink.py     : packed-uplink dequantization + Eq. 5 numerator (+ error
                  feedback), ``csrc/uplink.cu``.
- flash_attention.py : GQA attention, causal / window / pad masks,
                  ``csrc/flash_attention.cu``.
- ref.py        : plain PyTorch versions (ground truth + CPU path).
- ops.py        : dispatch on the tensor's device, launch counts.
- _build.py     : ``nvcc`` at first use, ``ctypes`` binding.
"""
from repro_torch.kernels import (aggregate, divergence, flash_attention, ops,
                                 ref, uplink)

__all__ = ["aggregate", "divergence", "flash_attention", "ops", "ref",
           "uplink"]
