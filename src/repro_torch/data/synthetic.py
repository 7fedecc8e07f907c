"""Synthetic datasets (no CIFAR-10 download), a verbatim numpy copy of
``repro.data.synthetic``: one seed gives the same arrays in both packages.

- ``make_image_dataset``: class-conditional structured images matching
  CIFAR-10's shape/stats (32×32×3, 10 classes). Each class has a smooth
  random prototype (low-frequency mixture) plus per-sample noise and a random
  shift, so a small CNN must actually learn class structure — accuracy-vs-
  communication orderings transfer qualitatively.
- ``make_lm_dataset``: per-domain Markov-chain token streams for LM-style FL
  (domains create natural non-IID client splits).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    xs: np.ndarray
    ys: np.ndarray

    def __len__(self) -> int:
        return len(self.xs)


def _class_prototypes(rng: np.random.Generator, num_classes: int,
                      size: int, channels: int) -> np.ndarray:
    """Smooth low-frequency prototypes, unit variance."""
    freqs = rng.normal(size=(num_classes, 4, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(num_classes, 4, channels))
    amps = rng.normal(size=(num_classes, 4, channels))
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, size),
                         np.linspace(0, 2 * np.pi, size), indexing="ij")
    protos = np.zeros((num_classes, size, size, channels), np.float32)
    for c in range(num_classes):
        for k in range(4):
            arg = freqs[c, k, 0] * yy + freqs[c, k, 1] * xx
            for ch in range(channels):
                protos[c, :, :, ch] += (amps[c, k, ch]
                                        * np.sin(arg + phases[c, k, ch]))
    protos /= protos.std(axis=(1, 2, 3), keepdims=True) + 1e-8
    return protos


def make_image_dataset(num_train: int = 50_000, num_test: int = 10_000,
                       num_classes: int = 10, size: int = 32,
                       channels: int = 3, noise: float = 0.8,
                       seed: int = 0) -> tuple[ArrayDataset, ArrayDataset]:
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, num_classes, size, channels)

    def gen(n):
        ys = rng.integers(0, num_classes, size=n)
        xs = protos[ys].copy()
        # random cyclic shift (weak augmentation-like variability)
        shifts = rng.integers(-4, 5, size=(n, 2))
        for i in range(n):
            xs[i] = np.roll(xs[i], shifts[i], axis=(0, 1))
        xs += noise * rng.normal(size=xs.shape).astype(np.float32)
        return ArrayDataset(xs.astype(np.float32), ys.astype(np.int32))

    return gen(num_train), gen(num_test)


def make_lm_dataset(num_sequences: int = 2048, seq_len: int = 128,
                    vocab: int = 512, num_domains: int = 8,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Markov-chain tokens. Returns (tokens (N, S), domain_ids (N,))."""
    rng = np.random.default_rng(seed)
    seqs = np.zeros((num_sequences, seq_len), np.int32)
    domains = rng.integers(0, num_domains, size=num_sequences)
    # sparse per-domain transition tables
    nexts = rng.integers(0, vocab, size=(num_domains, vocab, 4))
    for i in range(num_sequences):
        d = domains[i]
        tok = rng.integers(0, vocab)
        for t in range(seq_len):
            seqs[i, t] = tok
            if rng.random() < 0.1:            # occasional resample
                tok = rng.integers(0, vocab)
            else:
                tok = nexts[d, tok, rng.integers(0, 4)]
    return seqs, domains.astype(np.int32)
