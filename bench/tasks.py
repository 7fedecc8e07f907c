"""A cell's task: the benchmark's inputs made from the seed, and the
program's objects built over them the way a user of ``repro_torch`` builds
them (the model's loss, the FL config, the dataset on the device as
``ClientShards``, the evaluation).

Two kinds of configuration, named by the config file's ``kind``:

- ``image_classifier``: ``repro_torch.models.cnn`` (VGG), images split IID,
  evaluation = test error over the held-out images in one batch;
- ``lm``: ``repro_torch.models.transformer`` (any family its
  ``ModelConfig`` takes), token sequences split by domain, evaluation =
  the mean next-token loss over the held-out sequences in one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from bench import data, spec, weights
from repro_torch.core.wire import CompressionConfig
from repro_torch.data.device import ClientShards
from repro_torch.federated.server import FLConfig
from repro_torch.models import cnn, transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Task:
    cfg: dict                  # the config file
    traffic: dict              # the traffic file
    seed: int
    device: torch.device
    dataset: data.Dataset
    draws: data.Draws
    reference: Any             # bench/reference/<config>.py
    param_spec: list
    flcfg: FLConfig            # the program's
    loss_fn: Callable          # the program's
    eval_fn: Callable          # the program's, -> float
    shards: ClientShards       # the program's view of ``dataset``

    def weights(self) -> dict:
        """The round-0 model, made anew from the seed (bit for bit)."""
        return weights.make(self.param_spec, self.seed, self.device)

    def ref_loss(self, prec: str) -> Callable:
        model = self.cfg["model"]
        return lambda p, b: self.reference.loss(p, model, b, prec)


def fl_config(fl: dict) -> FLConfig:
    comp = fl.get("compression")
    return FLConfig(
        algo=fl["algo"], num_clients=fl["num_clients"],
        clients_per_round=fl["clients_per_round"], top_n=fl["top_n"],
        local_steps=fl["local_steps"], lr=fl["lr"], mode=fl["mode"],
        batch_per_client=fl["batch_per_client"],
        compression=(None if comp is None else CompressionConfig(
            bits=comp["bits"], error_feedback=comp["error_feedback"])))


def _image_program(cfg: dict, ds: data.Dataset):
    m = cfg["model"]
    vcfg = cnn.VGGConfig(channels=tuple(m["channels"]),
                         pool_after=tuple(m["pool_after"]),
                         num_classes=m["num_classes"],
                         image_size=m["image_size"],
                         in_channels=m["in_channels"])
    test = {"images": ds.eval_xs, "labels": ds.eval_ys}

    def loss_fn(p, b):
        return cnn.classify_loss(p, vcfg, b)

    def eval_fn(p) -> float:
        with torch.no_grad():
            return 1.0 - float(cnn.accuracy(p, vcfg, test))

    return loss_fn, eval_fn


def model_config(cfg: dict, traffic: dict) -> ModelConfig:
    fields = {**cfg["model"], **traffic.get("model", {})}
    return ModelConfig(name=cfg["name"], **fields)


def _lm_program(cfg: dict, traffic: dict, ds: data.Dataset):
    mcfg = model_config(cfg, traffic)
    held = {"tokens": ds.eval_xs, "labels": ds.eval_ys}
    loss_fn = transformer.make_lm_loss(mcfg)

    def eval_fn(p) -> float:
        with torch.no_grad():
            return float(transformer.lm_loss(p, mcfg, held))

    return loss_fn, eval_fn


def make(cfg: dict, traffic: dict, seed: int, device) -> Task:
    device = torch.device(device)
    fl = traffic["fl"]
    n = fl["num_clients"]
    if cfg["kind"] == "image_classifier":
        ds = data.images(traffic["data"], cfg["model"], n, seed, device)
        loss_fn, eval_fn = _image_program(cfg, ds)
    elif cfg["kind"] == "lm":
        ds = data.tokens(traffic["data"], cfg["model"]["vocab_size"], n,
                         seed, device)
        loss_fn, eval_fn = _lm_program(cfg, traffic, ds)
    else:
        raise spec.SpecError(f"config kind {cfg['kind']!r}")
    ref = spec.reference(cfg["name"])
    return Task(
        cfg=cfg, traffic=traffic, seed=seed, device=device, dataset=ds,
        draws=data.Draws(seed, ds.part_sizes.tolist(), n,
                         fl["clients_per_round"], fl["batch_per_client"]),
        reference=ref, param_spec=ref.param_spec(cfg["model"]),
        flcfg=fl_config(fl), loss_fn=loss_fn, eval_fn=eval_fn,
        shards=ClientShards(xs=ds.xs, ys=ds.ys, part_idx=ds.part_idx,
                            part_sizes=ds.part_sizes, x_key=ds.x_key,
                            y_key=ds.y_key))
