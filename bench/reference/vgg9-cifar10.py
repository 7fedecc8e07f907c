"""Plain VGG-9 (the paper's section III-A model) in f32, for the check.

8 3x3 convolutions (stride 1, padding 1), each followed by a bias,
normalisation with the batch's own mean and population variance (eps
1e-5) and a learned scale and shift, and ReLU; 2x2 max-pooling after the
convolutions the config names; a fully connected layer on the NHWC
flattening; the mean negative log-likelihood. Images are NHWC and
convolution weights HWIO, as the program keeps them.

The normalisation is written as the program's plain model writes it
(statistics over the NHWC batch, ``var(correction=0)``, ``rsqrt``): its
backward at these random weights amplifies a change in summation order
about ten-thousandfold in the first layers' gradients (the same model with
the statistics taken over NCHW moved the first update of ``conv0`` by
6e-4 of its norm, against 7e-6 written so), which would hide the f32
rounding the check has to see past. Imports torch and ``bench.reference``
only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference import plain


def param_spec(model: dict) -> list:
    """The weights' layout and random init (He-normal convolutions,
    1/fan_in fc)."""
    spec, cin = [], model["in_channels"]
    for i, cout in enumerate(model["channels"]):
        key = f"conv{i}"
        spec += [((key, "w"), (3, 3, cin, cout),
                  ("normal", math.sqrt(2.0 / (9 * cin)))),
                 ((key, "b"), (cout,), ("const", 0.0)),
                 ((key, "scale"), (cout,), ("const", 1.0)),
                 ((key, "bias"), (cout,), ("const", 0.0))]
        cin = cout
    fc_in = _fc_in(model)
    spec += [(("fc", "w"), (fc_in, model["num_classes"]),
              ("normal", math.sqrt(1.0 / fc_in))),
             (("fc", "b"), (model["num_classes"],), ("const", 0.0))]
    return spec


def _fc_in(model: dict) -> int:
    side = model["image_size"] // 2 ** len(model["pool_after"])
    return side * side * model["channels"][-1]


def logits(params: dict, model: dict, images: torch.Tensor,
           prec: str = "f32") -> torch.Tensor:
    x = images                                               # NHWC
    for i in range(len(model["channels"])):
        p = params[f"conv{i}"]
        x = plain.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                         prec, padding=1).permute(0, 2, 3, 1)
        x = x + p["b"]
        mean = x.mean(dim=(0, 1, 2), keepdim=True)
        var = x.var(dim=(0, 1, 2), keepdim=True, correction=0)
        x = torch.relu((x - mean) * torch.rsqrt(var + 1e-5) * p["scale"]
                       + p["bias"])
        if i in model["pool_after"]:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    x = x.reshape(x.shape[0], -1)                            # NHWC flatten
    return plain.mm(x, params["fc"]["w"], prec) + params["fc"]["b"]


def loss(params: dict, model: dict, batch: dict,
         prec: str = "f32") -> torch.Tensor:
    logp = torch.log_softmax(logits(params, model, batch["images"], prec), -1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()
