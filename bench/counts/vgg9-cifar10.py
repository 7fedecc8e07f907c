"""VGG-9's counts, from its configuration's shapes alone: parameters, the
FedLDF layer units, and one image's forward FLOPs.

The model (``bench/reference/vgg9-cifar10.py``): 3×3 convolutions, each
with a bias and a scale and shift of its normalisation, max-pooling after
those ``pool_after`` lists, one fully connected layer. A unit is a
convolution or the fc. Imports nothing.
"""
from __future__ import annotations


def _layers(model: dict) -> list[tuple[int, int, int]]:
    """(spatial side, c_in, c_out) of each convolution."""
    side, cin, out = model["image_size"], model["in_channels"], []
    for i, cout in enumerate(model["channels"]):
        out.append((side, cin, cout))
        if i in model["pool_after"]:
            side //= 2
        cin = cout
    return out


def _fc_in(model: dict) -> int:
    side = model["image_size"] // 2 ** len(model["pool_after"])
    return side * side * model["channels"][-1]


def param_count(model: dict) -> int:
    convs = sum(9 * cin * cout + 3 * cout for _, cin, cout in _layers(model))
    return convs + _fc_in(model) * model["num_classes"] + model["num_classes"]


def num_units(model: dict) -> int:
    return len(model["channels"]) + 1


def forward_flops(model: dict, data: dict) -> int:
    """One image's forward multiply-adds × 2: convolutions and the fc."""
    convs = sum(2 * side * side * 9 * cin * cout
                for side, cin, cout in _layers(model))
    return convs + 2 * _fc_in(model) * model["num_classes"]
