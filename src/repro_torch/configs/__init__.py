"""Architecture registry, port of ``repro.configs``: the ten assigned LLM
configs, granite-4.0-h-small (the port's own: no counterpart in
``repro.configs``) and the paper's own VGG-9 (``vgg9_cifar10``).

The arch modules are data only. ``get_config(arch_id)`` returns the exact
full-scale :class:`~repro_torch.models.config.ModelConfig`;
``get_config(arch_id).reduced()`` is the small variant the CPU tests use.
``vgg9()`` and ``vgg9_fl(algo)`` give the paper's own model and FL setup.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id -> module name
ARCHS: dict[str, str] = {
    "qwen3-1.7b": "qwen3_1_7b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "mamba2-780m": "mamba2_780m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen2-7b": "qwen2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-4.0-h-small": "granite_4_0_h_small",
}

ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")
    return mod.config()


def vgg9():
    mod = importlib.import_module("repro_torch.configs.vgg9_cifar10")
    return mod.config()


def vgg9_fl(algo: str = "fedldf"):
    mod = importlib.import_module("repro_torch.configs.vgg9_cifar10")
    return mod.fl_config(algo)
