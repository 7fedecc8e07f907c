"""The benchmark's inputs, made from ``--seed``: datasets, the client
partition and the per-round draws. The program and the reference are handed
the same.

The generators are the benchmark's own copies of the program's synthetic
data (``repro_torch/data/synthetic.py``): the same class-prototype images
and per-domain Markov-chain tokens, made on the device in a few bulk calls
instead of per-sample host loops, so a run's set-up does not pay seconds of
numpy. Every seed gives the same sizes; only the values differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# stream ids of the seed mix
DATA, PART, WEIGHTS, CLIENTS, ORDER, ALGO = range(6)


def mix(seed: int, *keys: int) -> int:
    """A 63-bit generator seed from ``seed`` (any whole number) and keys."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *keys])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, device, *keys: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(mix(seed, *keys))
    return g


@dataclasses.dataclass
class Dataset:
    """The whole dataset on the device: ``xs``/``ys`` rows, each client's
    rows as a padded ``(N, S)`` index matrix (row c repeats client c's rows
    cyclically) with the true sizes, and the held-out rows the evaluation
    reads."""
    xs: torch.Tensor
    ys: torch.Tensor
    part_idx: torch.Tensor        # (N, S) int32 rows of xs
    part_sizes: torch.Tensor      # (N,) int32
    eval_xs: torch.Tensor
    eval_ys: torch.Tensor
    x_key: str
    y_key: str

    def batch(self, client: int, j: torch.Tensor) -> dict:
        """Client ``client``'s rows ``j`` (its local indices) as a batch."""
        rows = self.part_idx[client].to(torch.int64)[j.to(self.xs.device)]
        return {self.x_key: self.xs[rows], self.y_key: self.ys[rows]}


def _partitioned(xs, ys, eval_xs, eval_ys, x_key: str, y_key: str,
                 parts: list[np.ndarray]) -> Dataset:
    sizes = np.array([len(p) for p in parts], dtype=np.int64)
    cols = np.arange(int(sizes.max()), dtype=np.int64)
    idx = np.stack([p[cols % len(p)] for p in parts]).astype(np.int32)
    device = xs.device
    return Dataset(xs=xs, ys=ys,
                   part_idx=torch.from_numpy(idx).to(device),
                   part_sizes=torch.from_numpy(sizes.astype(np.int32))
                   .to(device),
                   eval_xs=eval_xs, eval_ys=eval_ys, x_key=x_key,
                   y_key=y_key)


# ----------------------------------------------------------------------
# images: the class-prototype generator
# ----------------------------------------------------------------------
def class_prototypes(rng: np.random.Generator, num_classes: int,
                     size: int, channels: int) -> np.ndarray:
    """Smooth low-frequency prototypes of unit variance, (C, S, S, ch)."""
    freqs = rng.normal(size=(num_classes, 4, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(num_classes, 4, channels))
    amps = rng.normal(size=(num_classes, 4, channels))
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, size),
                         np.linspace(0, 2 * np.pi, size), indexing="ij")
    arg = freqs[:, :, 0, None, None] * yy + freqs[:, :, 1, None, None] * xx
    protos = np.zeros((num_classes, size, size, channels), np.float32)
    for k in range(4):
        protos += (amps[:, k, None, None, :] * np.sin(
            arg[:, k, :, :, None] + phases[:, k, None, None, :])
                   ).astype(np.float32)
    protos /= protos.std(axis=(1, 2, 3), keepdims=True) + 1e-8
    return protos


def images(data: dict, model: dict, num_clients: int, seed: int,
           device) -> Dataset:
    """CIFAR-shaped NHWC f32 images with int32 labels: ``num_train`` split
    IID over the clients in equal shards, ``num_test`` held out."""
    size, ch, ncls = (model["image_size"], model["in_channels"],
                      model["num_classes"])
    n_train, n_test = data["num_train"], data["num_test"]
    n = n_train + n_test
    protos = torch.from_numpy(class_prototypes(
        np.random.default_rng(mix(seed, DATA)), ncls, size, ch)).to(device)
    g = generator(seed, device, DATA)
    labels = torch.randint(0, ncls, (n,), generator=g, device=device)
    shifts = torch.randint(-4, 5, (n, 2), generator=g, device=device)
    ar = torch.arange(size, device=device)
    # a cyclic shift by (sy, sx): out[h, w] = in[(h - sy) % S, (w - sx) % S]
    hidx = (ar[None, :] - shifts[:, :1]) % size
    widx = (ar[None, :] - shifts[:, 1:]) % size
    xs = protos[labels[:, None, None], hidx[:, :, None], widx[:, None, :]]
    xs.add_(torch.randn(xs.shape, generator=g, device=device),
            alpha=data["noise"])
    ys = labels.to(torch.int32)
    if data["partition"] != "iid":
        raise ValueError(f"image partition {data['partition']!r}")
    perm = np.random.default_rng(mix(seed, PART)).permutation(n_train)
    parts = [np.sort(p) for p in np.array_split(perm, num_clients)]
    return _partitioned(xs[:n_train], ys[:n_train], xs[n_train:],
                        ys[n_train:], "images", "labels", parts)


# ----------------------------------------------------------------------
# tokens: per-domain Markov chains
# ----------------------------------------------------------------------
def tokens(data: dict, vocab: int, num_clients: int, seed: int,
           device) -> Dataset:
    """``num_sequences`` training and ``eval_sequences`` held-out token
    sequences of ``seq_len + 1`` tokens (inputs, then labels shifted by
    one), each from its domain's sparse transition table (4 successors a
    token, a uniform resample with probability 0.1); the training
    sequences are split by domain, as the program's ``lm_federated``."""
    n_train, n_eval = data["num_sequences"], data["eval_sequences"]
    n, length, n_dom = n_train + n_eval, data["seq_len"] + 1, \
        data["num_domains"]
    g = generator(seed, device, DATA)
    domains = torch.randint(0, n_dom, (n,), generator=g, device=device)
    nexts = torch.randint(0, vocab, (n_dom, vocab, 4), generator=g,
                          device=device)
    tok = torch.randint(0, vocab, (n,), generator=g, device=device)
    resample = torch.rand((length, n), generator=g, device=device) < 0.1
    fresh = torch.randint(0, vocab, (length, n), generator=g, device=device)
    pick = torch.randint(0, 4, (length, n), generator=g, device=device)
    seqs = torch.empty((n, length), dtype=torch.int64, device=device)
    for t in range(length):
        seqs[:, t] = tok
        tok = torch.where(resample[t], fresh[t], nexts[domains, tok, pick[t]])
    if data["partition"] != "domain":
        raise ValueError(f"token partition {data['partition']!r}")
    order = np.argsort(domains[:n_train].cpu().numpy(), kind="stable")
    parts = [np.sort(p) for p in np.array_split(order, num_clients)]
    inputs, labels = seqs[:, :-1].contiguous(), seqs[:, 1:].contiguous()
    return _partitioned(inputs[:n_train], labels[:n_train], inputs[n_train:],
                        labels[n_train:], "tokens", "labels", parts)


# ----------------------------------------------------------------------
# per-round draws
# ----------------------------------------------------------------------
class Draws:
    """The rounds' draws, a pure function of ``(seed, t)``: round ``t``'s
    K participants are ``randperm(N)[:K]``, and a client's batch in round
    ``t`` is its rows ``order_c[(t·B + i) mod |D_c|]`` for ``i < B``, with
    ``order_c`` a permutation of the client's rows fixed by the seed. So a
    client sees distinct rows until it has used them all, as an epoch does,
    and the rounds the check follows train on rows that all differ.

    ``draws(t)`` has the three methods the program's engine takes through
    its ``draws=`` keyword; ``batches(t)`` gives the reference the same
    participants and rows."""

    def __init__(self, seed: int, sizes: list[int], num_clients: int,
                 k: int, batch: int):
        self.seed, self.num_clients, self.k, self.batch = (seed, num_clients,
                                                           k, batch)
        self.order = [torch.randperm(s, generator=generator(seed, "cpu",
                                                            ORDER, c))
                      for c, s in enumerate(sizes)]

    def clients(self, t: int) -> torch.Tensor:
        g = generator(self.seed, "cpu", CLIENTS, t)
        return torch.randperm(self.num_clients, generator=g)[:self.k]

    def rows(self, t: int, client: int) -> torch.Tensor:
        order = self.order[client]
        return order[(t * self.batch + torch.arange(self.batch))
                     % order.shape[0]]

    def __call__(self, t: int) -> "RoundDraws":
        return RoundDraws(self, t)


class RoundDraws:
    def __init__(self, draws: Draws, t: int):
        self._draws, self._t = draws, t
        self._clients = None
        self._algo = generator(draws.seed, "cpu", ALGO, t)

    def clients(self, num_clients: int, k: int,
                num_groups: int = 1) -> torch.Tensor:
        d = self._draws
        if (num_clients, k, num_groups) != (d.num_clients, d.k, 1):
            raise ValueError(f"draws were made for N={d.num_clients}, "
                             f"K={d.k}, one group")
        self._clients = d.clients(self._t)
        return self._clients

    def indices(self, sizes: torch.Tensor, batch: int) -> torch.Tensor:
        if batch != self._draws.batch or self._clients is None:
            raise ValueError("indices() needs clients() first and the "
                             "batch the draws were made for")
        return torch.stack([self._draws.rows(self._t, int(c))
                            for c in self._clients])

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._algo)
