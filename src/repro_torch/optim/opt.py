"""SGD(+momentum) and AdamW as (init, update) pairs over parameter trees,
port of ``repro.optim.opt``.

The paper's ClientUpdate (Algorithm 1 line 14) is one plain SGD step;
momentum and AdamW serve the beyond-paper experiments. Both are functional
(no in-place updates), so they run under ``torch.func.vmap`` and ``grad``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.units import tree_map

Pytree = Any


class Optimizer(NamedTuple):
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], tuple[Pytree, Pytree]]
    # update(grads, state, params) -> (new_params, new_state)


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32),
                        params)

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                params, grads)
            return new_params, ()
        new_state = tree_map(lambda m, g: momentum * m + g.float(),
                             state, grads)
        new_params = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                              params, new_state)
        return new_params, new_state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros():
            return tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32),
                            params)
        return {"m": zeros(), "v": zeros(), "t": 0}

    def update(grads, state, params):
        t = state["t"] + 1     # a host int: the step count is not traced
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t

        def step(p, m_, v_):
            upd = (m_ / bc1.to(m_.device)) / (
                torch.sqrt(v_ / bc2.to(v_.device)) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        return tree_map(step, params, m, v), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
