"""Assigned input shapes → programs over ``meta`` tensors, port of
``repro.launch.shapes``.

Four shapes (assignment):
    train_4k     seq=4 096   global_batch=256   -> fl_round (FedLDF training)
    prefill_32k  seq=32 768  global_batch=32    -> prefill
    decode_32k   seq=32 768  global_batch=128   -> serve_step (1 new token)
    long_500k    seq=524 288 global_batch=1     -> serve_step, sub-quadratic

``long_500k`` policy: SSM runs natively (recurrent state); hybrid and all
attention archs use the sliding-window variant (window 8 192; for hymba
this mirrors the real model's SW layers). No arch is skipped.

FL round geometry for train_4k: K=8 sequential clients × 32 local batch
(cross-silo; global_batch = 256), FedLDF top-n=2.

Audio (enc-dec) sequence placement: ``seq`` is the *audio frame* length;
the decoder side uses min(seq, 1024) text tokens (train/prefill) and a
4 096-frame cross-attention cache at decode.

Every argument of a :class:`Program` is a tensor on the ``meta`` device
(shape and dtype, no storage): :func:`params_struct` of a 400B-parameter
model allocates and draws nothing. Where the reference's arguments are
``jax.ShapeDtypeStruct`` s, the port's are these tensors, and its
programs are the port's own functions, run on ``meta``
(:mod:`repro_torch.launch.opcount` counts them):

- train: the port's ``build_round_scan`` round with ``lm_loss``. Its
  ``round_fn(params, batch, data_sizes, state, uniform, frozen)`` takes no
  ``(2,) uint32`` key: the program's fourth argument is the port's own
  ``uniform(shape)`` (the round's algorithm stream, the key's
  counterpart), drawing on ``meta``, and ``state`` / ``frozen`` are None;
- prefill: ``decode.prefill``;
- decode: ``decode.decode_step`` against a cache from ``init_cache(...,
  device="meta")`` whose ``pos`` (a Python int in the port) is
  ``seq - 1``: the step that writes the context's last position, with
  every slot of the window filled.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.core.units import UnitMap
from repro_torch.federated.server import FLConfig, build_round_scan
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, dtype_of

Pytree = Any

SLIDING_WINDOW_LONG = 8192
AUDIO_DEC_LEN = 1024
AUDIO_DEC_CROSS = 4096
VLM_PATCHES = 256
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

FL_TRAIN = FLConfig(algo="fedldf", num_clients=64, clients_per_round=8,
                    top_n=2, local_steps=1, lr=0.02, mode="scan",
                    batch_per_client=32)


def adapt_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Variant selection per shape (sliding window for long-context)."""
    if (shape.name == "long_500k" and cfg.family != "ssm"
            and not cfg.sliding_window):
        cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


def params_struct(cfg: ModelConfig) -> Pytree:
    """The model's parameter tree on ``meta`` (no allocation, no draw)."""
    return tf.init_params(cfg, None, device=META)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def meta_uniform(shape) -> torch.Tensor:
    """The round's algorithm stream on ``meta``: f32 of ``shape``."""
    return torch.empty(shape, dtype=torch.float32, device=META)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class Program:
    """A countable (fn, example-args) bundle."""
    fn: Callable
    args: tuple            # meta tensors (pytrees) and the port's extras
    arg_kinds: tuple       # 'params' | 'batch' | 'cache' | 'scalar' per arg
    flcfg: Optional[FLConfig] = None


def build_program(cfg: ModelConfig, shape: ShapeSpec,
                  flcfg: FLConfig = FL_TRAIN) -> Program:
    cfg = adapt_config(cfg, shape)
    pstruct = params_struct(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    i32 = torch.int32

    if shape.kind == "train":
        k = flcfg.clients_per_round
        b = shape.global_batch // k
        seq = shape.seq
        if cfg.is_encdec:
            dlen = min(seq, AUDIO_DEC_LEN)
            batch = {
                "tokens": _sds((k, b, dlen), i32),
                "labels": _sds((k, b, dlen), i32),
                "enc_inputs": _sds((k, b, seq, cfg.frontend_dim), cdt),
            }
        elif cfg.family == "vlm":
            batch = {
                "tokens": _sds((k, b, seq), i32),
                "labels": _sds((k, b, seq), i32),
                "embeddings": _sds((k, b, VLM_PATCHES, cfg.frontend_dim),
                                   cdt),
            }
        else:
            batch = {
                "tokens": _sds((k, b, seq), i32),
                "labels": _sds((k, b, seq), i32),
            }
        umap = UnitMap.build(pstruct)
        loss_fn = functools.partial(_lm_loss, cfg)
        round_fn = build_round_scan(loss_fn, umap, flcfg)

        def fn(params, batch, data_sizes, uniform):
            return round_fn(params, batch, data_sizes, None, uniform)

        args = (pstruct, batch, _sds((k,), torch.float32), meta_uniform)
        return Program(fn, args, ("params", "batch", "scalar", "scalar"),
                       flcfg)

    if shape.kind == "prefill":
        b, seq = shape.global_batch, shape.seq
        if cfg.is_encdec:
            tokens = _sds((b, min(seq, AUDIO_DEC_LEN)), i32)

            def fn(params, tokens, enc_inputs):
                return dec.prefill(params, cfg, tokens, enc_inputs=enc_inputs)
            args = (pstruct, tokens, _sds((b, seq, cfg.frontend_dim), cdt))
            kinds = ("params", "batch", "batch")
        elif cfg.family == "vlm":
            def fn(params, tokens, embeddings):
                return dec.prefill(params, cfg, tokens, embeddings=embeddings)
            args = (pstruct, _sds((b, seq), i32),
                    _sds((b, VLM_PATCHES, cfg.frontend_dim), cdt))
            kinds = ("params", "batch", "batch")
        else:
            def fn(params, tokens):
                return dec.prefill(params, cfg, tokens)
            args = (pstruct, _sds((b, seq), i32))
            kinds = ("params", "batch")
        return Program(fn, args, kinds)

    # decode
    b, seq = shape.global_batch, shape.seq
    enc_len = AUDIO_DEC_CROSS if cfg.is_encdec else 0
    cache = dec.init_cache(cfg, b, seq, enc_len=enc_len, device=META)
    cache["pos"] = seq - 1

    def fn(params, tokens, cache):
        return dec.decode_step(params, cfg, tokens, cache)

    return Program(fn, (pstruct, _sds((b, 1), i32), cache),
                   ("params", "batch", "cache"))


def _lm_loss(cfg: ModelConfig, params, batch):
    return tf.lm_loss(params, cfg, batch)
