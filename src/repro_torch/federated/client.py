"""ClientUpdate (paper Algorithm 1, lines 11-15), port of
``repro.federated.client``.

A client receives the global model, runs ``local_steps`` optimizer steps on
its local batch (the paper uses exactly one SGD step) and returns its local
model. The update is a pure deterministic function of (global params,
client batch), built on ``torch.func.grad_and_value``, so K clients train
stacked under ``torch.func.vmap(local_update, in_dims=(None, 0))`` as under
``jax.vmap`` in the reference, and the scan round can recompute a client's
local model exactly. ``remat`` and trainable partitions wait for their
slices (ROADMAP Queue 1, items 7 and 10).

Local training runs its convolutions through PyTorch's own CUDA
convolution (im2col + cuBLAS GEMM), not cuDNN. cuDNN picks its algorithms
by shape, so K clients stacked under vmap (one batch of K·B images) and one
client alone (B images) are rounded differently, and at full width some
ReLU and max-pool inputs lie within that rounding of a kink: the weight
gradients then differ by up to a few percent. On an H100 a client's local
VGG-9 from the two paths differed by 2.0e-4 with cuDNN and by 8.9e-9
without it (``chip_smoke.py`` prints both; see PERF.md). The scan round's
two-phase recompute also needs the same bits twice, which cuDNN's default
algorithms do not promise. The native path computes every image the same
way whatever the batch.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
from torch.func import grad_and_value

from repro_torch.optim.opt import Optimizer, sgd

Pytree = Any
LossFn = Callable[[Pytree, dict], torch.Tensor]


def make_local_update(loss_fn: LossFn, opt: Optimizer, local_steps: int = 1):
    """Returns local_update(global_params, batch) -> (local_params, mean_loss).

    ``batch`` leaves are (b, ...); the same batch is used for every local
    step, as in the reference.
    """
    value_and_grad = grad_and_value(loss_fn)

    def local_update(global_params: Pytree, batch: dict):
        params, ostate = global_params, opt.init(global_params)
        losses = []
        with _without_cudnn():
            for _ in range(local_steps):
                grads, loss = value_and_grad(params, batch)
                params, ostate = opt.update(grads, ostate, params)
                losses.append(loss)
        return params, torch.stack(losses).mean()

    return local_update


@contextlib.contextmanager
def _without_cudnn():
    """cuDNN off for the block, restored after (see module doc)."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def plain_sgd_client(loss_fn: LossFn, lr: float, local_steps: int = 1):
    """The paper's exact ClientUpdate: Θ_k ← Θ − η∇F_k(Θ)."""
    return make_local_update(loss_fn, sgd(lr), local_steps)
