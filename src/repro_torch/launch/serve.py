"""Serving launcher, port of ``repro.launch.serve``: batched prefill +
decode of a (FedLDF-trained) global model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        [--reduced] [--batch 4] [--prompt-len 32] [--steps 16] \\
        [--temperature 1.0] [--ckpt out/global.npz] [--seed 0] [--device cuda]

Prompts are drawn from a numpy generator seeded with ``--seed``; weights
are random from the same seed unless ``--ckpt`` names an npz written by
either package's ``save_pytree``. ``--temperature 0`` decodes greedily
(the parity tests use it: JAX's categorical draws cannot be reproduced);
above 0, tokens are drawn with ``torch.multinomial`` from a
``torch.Generator``. The first token is the argmax of the prefill logits,
as in the reference. An enc-dec model (``--arch seamless-m4t-large-v2``)
gets (B, S, frontend_dim) f32 frames drawn from the same numpy generator
after the prompts, the reference's shape (its draws cannot be
reproduced); the encoder casts them to the compute dtype. Every family is
ported: dense, vlm, moe (``--arch deepseek-moe-16b``: 33.8 GB of bf16
weights, which one 80 GB card holds; llama4-maverick's 1.57 TB fits no
single card), ssm (``--arch mamba2-780m``, whose cache holds no K/V, only
the SSD's conv tail and state), hybrid (``--arch hymba-1.5b``) and audio
(the enc-dec seamless-m4t-large-v2, whose cache adds the cross K/V).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor            # (B, steps)
    logits: list                    # per step (B, V), when kept
    prefill_s: float
    decode_s_per_token: float


@torch.inference_mode()
def generate(params, cfg, prompts: torch.Tensor, steps: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             keep_logits: bool = False,
             enc_inputs: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``prompts`` (B, S) (and an enc-dec model's ``enc_inputs``
    frames) into a cache of ``S + steps`` slots, take the argmax as the
    first token, then ``steps - 1`` decode steps.

    Times are host clock around work that ends in a device synchronise.
    """
    b, s = prompts.shape
    cuda = prompts.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(prompts.device)

    sync()
    t0 = time.perf_counter()
    logits, cache = dec.prefill(params, cfg, prompts, enc_inputs=enc_inputs,
                                max_len=s + steps)
    sync()
    t1 = time.perf_counter()
    toks = logits.argmax(dim=-1)[:, None]
    out, kept = [toks], [logits] if keep_logits else []
    for _ in range(steps - 1):
        logits, cache = dec.decode_step(params, cfg, toks, cache)
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            toks = torch.multinomial(probs, 1, generator=generator)
        else:
            toks = logits.argmax(dim=-1)[:, None]
        out.append(toks)
        if keep_logits:
            kept.append(logits)
    sync()
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), kept, t1 - t0,
                      (t2 - t1) / max(1, steps - 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b",
                    help="ported: qwen3-1.7b, qwen2-7b, qwen2.5-14b, "
                    "deepseek-coder-33b (dense), qwen2-vl-2b (vlm), "
                    "deepseek-moe-16b, llama4-maverick-400b-a17b (moe), "
                    "mamba2-780m (ssm), hymba-1.5b (hybrid), "
                    "seamless-m4t-large-v2 (audio, enc-dec)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32",
                                  compute_dtype="float32")
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = (load_pytree(args.ckpt, dev) if args.ckpt
              else tf.init_params(cfg, gen, dev))

    b, s = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(b, s))
    frames = (torch.from_numpy(rng.standard_normal(
        (b, s, cfg.frontend_dim), dtype=np.float32)).to(dev)
        if cfg.is_encdec else None)
    res = generate(params, cfg, torch.from_numpy(prompts).to(dev),
                   args.steps, temperature=args.temperature, generator=gen,
                   enc_inputs=frames)

    gen_toks = res.tokens.cpu().numpy()
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} batch={b} prompt={s} steps={args.steps} "
          f"device={where}")
    print(f"prefill: {res.prefill_s:.3f}s  "
          f"decode: {res.decode_s_per_token * 1e3:.1f}ms/tok")
    for i in range(min(b, 2)):
        print(f"  seq{i}: {gen_toks[i][:16].tolist()}...")


if __name__ == "__main__":
    main()
