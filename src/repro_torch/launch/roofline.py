"""Roofline terms of a counted program, port of ``repro.launch.roofline``,
with one NVIDIA H100 SXM's rates in place of a TPU v5e's:

    compute    = FLOPs / (chips × 989e12)          [dense bf16 tensor cores]
    memory     = bytes / (chips × 3.35e12)         [HBM3]
    collective = collective_bytes / (chips × 450e9)  [NVLink 4, one way]

The numerators are per device (:mod:`repro_torch.launch.opcount` counts one
card's program, so ``chips`` is 1 and ``collective`` 0 in the dry-run).
``F32_FLOPS`` is the f32 rate outside the tensor cores, the rate of the
f32 local training of the FL rounds.

MODEL_FLOPS (6·N·tokens dense / 6·N_active·tokens MoE; 2·N for inference)
gives the useful-compute ratio: for FedLDF's two-phase recompute mode it
reports about 0.5, the protocol's own rematerialization.

The terms are those of the program the counter ran, which on ``meta`` is
the plain program, not the card's kernel path: attention is the masked
block or the chunked ``_attend_flash``, whose S × S f32 scores are written
and read for every pair, masked or not, where the flash kernels keep them
on chip and skip masked tiles; the FL kernels are their plain versions.
So ``t_memory`` and ``dominant`` overstate the card's traffic, and a
measured time over ``max(t_compute, t_memory)`` is no share of the card's
roofline. ``to_dict`` says so under ``counted_program``.

The reference's ``collective_bytes(hlo_text)`` reads HLO text and has no
counterpart: the counter's collective records
(``OpTotals.collective_by_type``) replace it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

PEAK_FLOPS = 989e12       # dense bf16, tensor cores / card
F32_FLOPS = 67e12         # f32 outside the tensor cores / card
HBM_BW = 3.35e12          # bytes/s / card
LINK_BW = 450e9           # bytes/s / card, NVLink 4, one direction
COUNTED_PROGRAM = ("plain: the meta program's non-CUDA routes (attention "
                   "as the masked block or the chunked _attend_flash, every "
                   "pair's f32 scores in HBM; the kernels' plain versions), "
                   "not the card's kernel path; t_memory_s and dominant are "
                   "that program's")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_per_device: float
    collective_by_type: dict
    model_flops: float            # global useful FLOPs
    memory_per_device: Optional[dict] = None
    xla_cost_raw: Optional[dict] = None   # no XLA here: always None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_per_device": self.collective_per_device,
            "collective_by_type": self.collective_by_type,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_ratio,
            "memory_per_device": self.memory_per_device,
            "xla_cost_raw": self.xla_cost_raw,
            "counted_program": COUNTED_PROGRAM,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def model_flops_for(cfg, shape_spec, flcfg=None) -> float:
    """Useful-FLOPs reference (excludes recompute/remat overheads)."""
    n_active = cfg.active_param_count()
    if shape_spec.kind == "train":
        toks = shape_spec.global_batch * shape_spec.seq * (
            flcfg.local_steps if flcfg else 1)
        return 6.0 * n_active * toks
    if shape_spec.kind == "prefill":
        return 2.0 * n_active * shape_spec.global_batch * shape_spec.seq
    # decode: one token per sequence
    return 2.0 * n_active * shape_spec.global_batch
