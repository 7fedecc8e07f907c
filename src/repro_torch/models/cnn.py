"""VGG-9 CNN — the paper's experimental model (§III-A), port of
``repro.models.cnn``.

8 conv layers + 1 FC, normalisation + max-pooling following conv pairs
(32×32 → 2×2 spatial). Params are one top-level key per layer, so the
FedLDF :class:`~repro_torch.core.units.UnitMap` yields the paper's L = 9
layer units. The layout is the reference's: images and activations are NHWC,
conv ``w`` is HWIO ``(3, 3, cin, cout)`` and fc ``w`` is ``(fc_in,
classes)``, so reference params convert with ``np.asarray`` alone. The
forward pass permutes to NCHW only around ``F.conv2d`` and
``F.max_pool2d``.

Normalisation uses the batch statistics with learned scale/bias in both
train and eval, with the *population* variance, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

Pytree = Any


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    name: str = "vgg9-cifar10"
    channels: tuple[int, ...] = (64, 64, 128, 128, 256, 256, 512, 512)
    pool_after: tuple[int, ...] = (1, 3, 5, 7)   # conv indices
    num_classes: int = 10
    image_size: int = 32
    in_channels: int = 3
    source: str = "paper §III-A (VGG-9: 8 conv + 1 FC)"

    @property
    def num_layers(self) -> int:  # L in the paper
        return len(self.channels) + 1

    def reduced(self) -> "VGGConfig":
        return dataclasses.replace(
            self, name=self.name + "-reduced",
            channels=(8, 8, 16, 16), pool_after=(1, 3))

    def fc_in(self) -> int:
        spatial = self.image_size // (2 ** len(self.pool_after))
        return spatial * spatial * self.channels[-1]


def init_params(cfg: VGGConfig, generator: torch.Generator,
                device="cuda") -> Pytree:
    """He-normal conv weights and 1/fan_in fc weights, drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device) and
    moved to ``device``. The numbers differ from the reference's
    ``jax.random`` draws; parity tests carry weights across instead. On the
    ``meta`` device nothing is drawn (``generator`` may be None)."""
    def normal(shape, std):
        if torch.device(device).type == "meta":
            return torch.empty(shape, device="meta")
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * std).to(device)

    params: Pytree = {}
    cin = cfg.in_channels
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i}"] = {
            "w": normal((3, 3, cin, cout), math.sqrt(2.0 / (9 * cin))),
            "b": torch.zeros(cout, device=device),
            "scale": torch.ones(cout, device=device),
            "bias": torch.zeros(cout, device=device),
        }
        cin = cout
    params["fc"] = {
        "w": normal((cfg.fc_in(), cfg.num_classes),
                    math.sqrt(1.0 / cfg.fc_in())),
        "b": torch.zeros(cfg.num_classes, device=device),
    }
    return params


def _batch_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def forward(params: Pytree, cfg: VGGConfig, images: torch.Tensor):
    """images: (B, H, W, C) float32 -> logits (B, num_classes)."""
    x = images
    for i in range(len(cfg.channels)):
        p = params[f"conv{i}"]
        # NHWC/HWIO -> NCHW/OIHW for conv2d; padding=1 is SAME for 3x3/s1
        x = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1)
        x = torch.relu(_batch_norm(x + p["b"], p["scale"], p["bias"]))
        if i in cfg.pool_after:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    x = x.reshape(x.shape[0], -1)        # NHWC flatten order, as reference
    return x @ params["fc"]["w"] + params["fc"]["b"]


def classify_loss(params: Pytree, cfg: VGGConfig, batch: dict):
    """batch: {images: (B,H,W,C), labels: (B,)} -> mean NLL."""
    logits = forward(params, cfg, batch["images"])
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[:, None])
    return nll.mean()


def accuracy(params: Pytree, cfg: VGGConfig, batch: dict):
    logits = forward(params, cfg, batch["images"])
    return (torch.argmax(logits, -1) == batch["labels"].long()).float().mean()
