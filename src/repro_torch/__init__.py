"""FedLDF in PyTorch for one NVIDIA H100: the port of the JAX package
``repro``, module for module, with the Pallas TPU kernels rewritten as
CUDA C++ for Hopper (``repro_torch.kernels``).

Parameters are nested ``dict``s of tensors with the reference's key paths
and layouts; :mod:`repro_torch.bridge` carries them across as numpy arrays.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
