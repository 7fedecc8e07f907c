"""A per-expert loop version of the MoE layer, written from the reference's
semantics (``src/repro/models/moe.py``) and independent of both packages'
code: top-k by repeated ``argmax`` (ties to the lower index), each
expert's choices in (token, choice) order with the first ``capacity``
kept, each expert's SwiGLU on its own gathered rows, the outputs added
back with the renormalised gates. Data-dependent shapes and host syncs are
fine here: it is a plain reference, not a path.

No JAX: ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` use it on a
machine that has only PyTorch."""
import torch
import torch.nn.functional as F


def _swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    return (F.silu(g.float()).to(x.dtype) * (x @ w_up)) @ w_down


def moe_loop(p, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), aux, dropped choices)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t, e, k = b * s, cfg.num_experts, cfg.moe_top_k
    cap = max(int(t * k * cfg.capacity_factor / e), k)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # (T, E)
    left, chosen = probs.clone(), []
    rows = torch.arange(t, device=x.device)
    for _ in range(k):
        j = left.argmax(dim=-1)              # the first of equal maxima
        chosen.append(j)
        left[rows, j] = -torch.inf
    eidx = torch.stack(chosen, dim=1)                            # (T, k)
    gates = probs.gather(1, eidx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    counts, dropped = [], 0
    for j in range(e):
        tok, choice = (eidx == j).nonzero(as_tuple=True)   # (t, k) order
        counts.append(tok.numel())
        dropped += max(tok.numel() - cap, 0)
        tok, choice = tok[:cap], choice[:cap]
        y = _swiglu(xt[tok], p["w_gate"][j], p["w_up"][j], p["w_down"][j])
        out[tok] += y * gates[tok, choice][:, None].to(x.dtype)
    if cfg.num_shared_experts > 0:
        sh = p["shared"]
        out = out + _swiglu(xt, sh["w_gate"], sh["w_up"], sh["w_down"])
    ce = torch.tensor(counts, dtype=torch.float32, device=x.device) / (t * k)
    aux = e * torch.sum(probs.mean(dim=0) * ce)
    return out.reshape(b, s, d), aux, dropped
