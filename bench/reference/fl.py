"""Plain FedLDF rounds (the paper's Algorithm 1), written from the paper and
the packed uplink's format, for the check.

A round from the global model P and the K participants' batches:

1. local training (Eq. 2): each client takes ``local_steps`` SGD steps,
   P_k = P − lr·∇F_k(P), its loss the mean over its batch;
2. divergence (Eq. 3): per layer unit u, ‖P_k,u − P_u‖₂ (f64 sums);
3. selection (Eq. 4): per unit, the n clients of largest divergence (ties:
   the lower index);
4. aggregation (Eq. 5): per unit, Σ_k s_ku·|D_k|·P_k,u / Σ_k s_ku·|D_k|
   (f64 sums);
5. uplink bytes: the selected units' bytes plus K·U f32 divergence scalars.

A layer unit is a top-level key of the parameter tree, or one layer of a
key whose leaves stack the layers (``STACKED``). With an int-b uplink and
error feedback each client sends v = P_k − P + e_k quantized per unit
(scale max|v|/(2^(b−1)−1), levels round(clamp(v·(1/scale))) half to even),
the server adds Σ_k s·|D_k|·levels·scale / Σ_k s·|D_k| to P, a unit costs
⌈params·b/8⌉ + 5 bytes (the levels, an f32 scale, a width byte), and e_k
becomes v − levels·scale where the unit shipped, else stays.

Imports torch only.
"""
from __future__ import annotations

import torch

STACKED = ("blocks",)


def leaves(tree: dict, prefix: tuple = ()) -> list:
    """``(path, tensor)`` pairs in sorted-key order."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out += leaves(v, prefix + (key,))
        else:
            out.append((prefix + (key,), v))
    return out


def tree_of(pairs) -> dict:
    tree: dict = {}
    for path, v in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return tree


def unit_layout(params: dict) -> tuple[list, int, list[int]]:
    """``(per-leaf (path, unit offset, rows), number of units, params a
    unit)``: a stacked key's leaves have one row a unit."""
    offsets, layout = {}, []
    count = 0
    for key in sorted(params):
        pairs = leaves(params[key], (key,))
        n = pairs[0][1].shape[0] if key in STACKED else 1
        offsets[key] = (count, n)
        count += n
    sizes = [0] * count
    for path, leaf in leaves(params):
        off, n = offsets[path[0]]
        layout.append((path, off, n))
        for r in range(n):
            sizes[off + r] += leaf.numel() // n
    return layout, count, sizes


def local_train(loss_fn, params: dict, batch: dict, lr: float,
                steps: int) -> tuple[dict, torch.Tensor]:
    paths = [p for p, _ in leaves(params)]
    cur = [v for _, v in leaves(params)]
    losses = []
    for _ in range(steps):
        xs = [v.detach().requires_grad_() for v in cur]
        loss = loss_fn(tree_of(zip(paths, xs)), batch)
        grads = torch.autograd.grad(loss, xs)
        cur = [(x - lr * g).detach() for x, g in zip(xs, grads)]
        losses.append(loss.detach())
    return tree_of(zip(paths, cur)), torch.stack(losses).mean()


def divergence(local: dict, params: dict, layout, units: int):
    out = torch.zeros(units, dtype=torch.float64,
                      device=leaves(params)[0][1].device)
    for path, off, n in layout:
        a, b = _get(local, path), _get(params, path)
        sq = (a.double() - b.double()).pow(2).reshape(n, -1).sum(1)
        out[off:off + n] += sq
    return out.sqrt()


def top_n(divs: torch.Tensor, n: int) -> torch.Tensor:
    """(K, U) bool: per column the n largest, ties to the lower row."""
    k, u = divs.shape
    sel = torch.zeros((k, u), dtype=torch.bool, device=divs.device)
    for col in range(u):
        order = sorted(range(k), key=lambda r: (-float(divs[r, col]), r))
        sel[order[:n], col] = True
    return sel


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(n, -1)


def fl_round(loss_fn, params: dict, batches: list[dict], sizes: list[float],
             fl: dict, ef_rows: list | None = None,
             half_batch: bool = False) -> dict:
    """One round. ``ef_rows`` (error feedback) is the K participants'
    residual trees; ``half_batch`` trains each client on the first half of
    its batch only (a fault for the check's own test). Returns the new
    model, the round's loss, divergences (K, U), selection, exact uplink
    bytes (payload and feedback) and the new residual rows."""
    layout, units, unit_params = unit_layout(params)
    k, n_top, lr = len(batches), fl["top_n"], fl["lr"]
    locals_, losses = [], []
    for b in batches:
        if half_batch:
            b = {key: v[:v.shape[0] // 2] for key, v in b.items()}
        local, loss = local_train(loss_fn, params, b, lr, fl["local_steps"])
        locals_.append(local)
        losses.append(loss)
    divs = torch.stack([divergence(loc, params, layout, units)
                        for loc in locals_])
    sel = top_n(divs, n_top)
    dev = divs.device
    w = sel.double() * torch.tensor(sizes, dtype=torch.float64,
                                    device=dev)[:, None]          # (K, U)
    denom = w.sum(0)
    comp = fl.get("compression")
    new_rows = None
    if comp is None:
        unit_bytes = [4 * p for p in unit_params]
        out = []
        for path, off, n in layout:
            acc = torch.zeros_like(_rows(_get(params, path), n),
                                   dtype=torch.float64)
            for kk in range(k):
                acc += w[kk, off:off + n, None] * _rows(
                    _get(locals_[kk], path), n).double()
            out.append((path, (acc / denom[off:off + n, None]).float()
                        .reshape(_get(params, path).shape)))
    else:
        bits = int(comp["bits"])
        qmax = float(2 ** (bits - 1) - 1)
        unit_bytes = [-(-p * bits // 8) + 5 for p in unit_params]
        v = [{path: (_get(locals_[kk], path) - _get(params, path)
                     + _get(ef_rows[kk], path)).float()
              for path, _, _ in layout} for kk in range(k)]
        maxabs = torch.zeros((k, units), dtype=torch.float32, device=dev)
        for kk in range(k):
            for path, off, n in layout:
                maxabs[kk, off:off + n] = torch.maximum(
                    maxabs[kk, off:off + n],
                    _rows(v[kk][path], n).abs().amax(1))
        scale = torch.clamp(maxabs, min=1e-12) / qmax
        inv = 1.0 / scale
        out, res = [], [[] for _ in range(k)]
        for path, off, n in layout:
            p = _get(params, path)
            acc = torch.zeros_like(_rows(p, n), dtype=torch.float64)
            for kk in range(k):
                vk = _rows(v[kk][path], n)
                lv = torch.round(torch.clamp(vk * inv[kk, off:off + n, None],
                                             -qmax, qmax))
                recon = lv * scale[kk, off:off + n, None]
                acc += w[kk, off:off + n, None] * recon.double()
                g = sel[kk, off:off + n, None]
                e_old = _rows(_get(ef_rows[kk], path), n).float()
                res[kk].append((path, torch.where(g, vk - recon, e_old)
                                .reshape(p.shape)))
            out.append((path, (p.double() + (acc / denom[off:off + n, None])
                               .reshape(p.shape)).float()))
        new_rows = [tree_of(r) for r in res]
    payload = sum(int(sel[:, u].sum()) * unit_bytes[u] for u in range(units))
    return {"params": tree_of(out), "loss": torch.stack(losses).mean(),
            "divergence": divs, "selection": sel,
            "uplink_payload": payload, "uplink_feedback": 4 * k * units,
            "ef_rows": new_rows}
