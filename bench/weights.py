"""Random weights from the seed, in the tree layout the program and the
reference both take (nested dicts of f32 tensors, the program's key paths).

A configuration's reference gives the layout as a spec, a list of ``(path,
shape, init)`` with ``init`` either ``("normal", std)`` or ``("const",
value)``. Every normal leaf is a view into ONE buffer drawn by one
``torch.randn`` call on the device's generator and scaled in place, so a
model of billions of parameters is made in a few large calls, and the same
seed gives the same weights bit for bit (the check makes them again after
the window instead of holding a copy).
"""
from __future__ import annotations

import math

import torch

from bench import data


def make(spec: list, seed: int, device) -> dict:
    normals = [(path, shape, init[1]) for path, shape, init in spec
               if init[0] == "normal"]
    total = sum(math.prod(shape) for _, shape, _ in normals)
    flat = torch.randn(total, generator=data.generator(seed, device,
                                                       data.WEIGHTS),
                       device=device)
    leaves, off = {}, 0
    for path, shape, std in normals:
        n = math.prod(shape)
        leaves[path] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for path, shape, init in spec:
        if init[0] == "const":
            leaves[path] = torch.full(shape, float(init[1]), device=device)
        elif init[0] != "normal":
            raise ValueError(f"unknown init {init!r} of {path}")
    tree: dict = {}
    for path, _, _ in spec:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaves[path]
    return tree
