"""ClientUpdate (paper Algorithm 1, lines 11-15), port of
``repro.federated.client``.

A client receives the global model, runs ``local_steps`` optimizer steps on
its local batch (the paper uses exactly one SGD step) and returns its local
model. The update is a pure deterministic function of (global params,
client batch), built on ``torch.func.grad_and_value``, so K clients train
stacked under ``torch.func.vmap(local_update, in_dims=(None, 0))`` as under
``jax.vmap`` in the reference, and the scan round can recompute a client's
local model exactly. With a trainable partition
(:class:`~repro_torch.core.partition.ParamPartition`) only the trainable
sub-tree is differentiated, updated and returned; the frozen base is a
constant of the round.

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
from typing import Any, Callable, Optional

import torch
from torch.func import grad_and_value

from repro_torch.core.partition import ParamPartition
from repro_torch.optim.opt import Optimizer, sgd
from repro_torch.telemetry.profiling import span

Pytree = Any
LossFn = Callable[[Pytree, dict], torch.Tensor]


def make_local_update(loss_fn: LossFn, opt: Optimizer, local_steps: int = 1,
                      remat: bool = False,
                      partition: Optional[ParamPartition] = None):
    """Returns local_update(global_params, batch) -> (local_params, mean_loss).

    ``batch`` leaves are (b, ...); the same batch is used for every local
    step, as in the reference.

    With a ``partition`` the function is ``local_update(trainable, batch,
    frozen) -> (local_trainable, mean_loss)``: the loss sees
    ``partition.merge(trainable, frozen)``, while gradients, optimizer
    state and the result cover the trainable sub-tree only.

    ``remat`` is accepted for the reference's signature and changes
    nothing. The reference wraps each local step in ``jax.checkpoint``,
    which nothing differentiates through, so it moves neither a value nor
    the gradient's memory there either; the activation-memory lever is
    ``ModelConfig.remat_blocks`` (a recompute around each block,
    ``models/transformer.py``).

    Spans (``telemetry.profiling.span``): ``local_update`` a call, inside
    it ``forward`` (the loss) and ``sgd`` (``opt.update``) a step; the
    backward is what ``local_update`` enqueues outside both.
    """
    del remat

    def run(vg, start, batch):
        with span("local_update"):
            params, ostate = start, opt.init(start)
            losses = []
            with _without_cudnn():
                for _ in range(local_steps):
                    grads, loss = vg(params, batch)
                    with span("sgd"):
                        params, ostate = opt.update(grads, ostate, params)
                    losses.append(loss)
            return params, torch.stack(losses).mean()

    def forward(params: Pytree, batch: dict):
        with span("forward"):
            return loss_fn(params, batch)

    if partition is not None:
        def local_update_part(trainable: Pytree, batch: dict,
                              frozen: Pytree):
            return run(grad_and_value(
                lambda tr, b: forward(partition.merge(tr, frozen), b)),
                trainable, batch)

        return local_update_part

    vg = grad_and_value(forward)

    def local_update(global_params: Pytree, batch: dict):
        return run(vg, global_params, batch)

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
