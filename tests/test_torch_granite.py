"""granite-4.0-h-small on the port, on the CPU at small sizes with seeded
random weights, against the benchmark's plain reference
(``bench/reference/granite-4.0-h-small.py``, loaded by path): the
patterned stack's loss and every gradient (with and without
``remat_blocks``), a round of ``run_training_scan``, the share of a
72-expert layer that a chip holds (the 8 shares add up to the whole layer),
dropless routing under a routing forced onto one expert, the unit map over
the two stacked keys, the published preset, and the other models' outputs
under the new defaults."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from bench import check, spec, tasks, weights  # noqa: E402
from bench.reference import fl as ref_fl  # noqa: E402
from bench.reference import plain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.units import UnitMap  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

REF = spec.reference("granite-4.0-h-small")
# f32 on the CPU: the two sides order their sums differently
TOL = {"rtol": 1e-4, "atol": 1e-6}


def small(**kw) -> ModelConfig:
    """A small granite-4.0-h: 4 layers (attention, Mamba, attention,
    Mamba), 9 of 72 experts held, top-10, NoPE, the μP multipliers."""
    base = dict(name="t-granite", family="hybrid_moe", num_layers=4,
                d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=0, vocab_size=97, nope=True, attention_multiplier=1 / 16,
                num_experts=9, router_experts=72, moe_top_k=10, moe_d_ff=32,
                num_shared_experts=1, shared_d_ff=48, moe_dropless=True,
                ssm_state=16, ssm_head_dim=16, ssm_chunk=8, attn_period=2,
                attn_offset=0, tie_embeddings=True, norm_eps=1e-5,
                embedding_multiplier=12.0, residual_multiplier=0.22,
                logits_scaling=16.0)
    base.update(kw)
    return ModelConfig(**base)


def model(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def batch(cfg: ModelConfig, b=2, s=20, seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    labels = tokens[:, 1:].clone()
    labels[0, :3] = -1
    return {"tokens": tokens[:, :-1], "labels": labels}


def _grads(loss_fn, params):
    paths = [p for p, _ in ref_fl.leaves(params)]
    xs = [v.detach().clone().requires_grad_() for _, v in
          ref_fl.leaves(params)]
    loss = loss_fn(ref_fl.tree_of(zip(paths, xs)))
    return loss, dict(zip(paths, torch.autograd.grad(loss, xs)))


def test_program_tree_is_the_reference_layout():
    cfg = small()
    prog = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = {p: tuple(shape) for p, shape, _ in REF.param_spec(model(cfg))}
    assert {p: tuple(v.shape) for p, v in ref_fl.leaves(prog)} == want


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_the_reference(remat):
    cfg = small(remat_blocks=remat)
    params = weights.make(REF.param_spec(model(cfg)), 3, "cpu")
    b = batch(cfg)
    loss, grads = _grads(lambda p: ttf.lm_loss(p, cfg, b), params)
    want_loss, want = _grads(lambda p: REF.loss(p, model(cfg), b), params)
    torch.testing.assert_close(loss, want_loss, **TOL)
    for path, g in want.items():
        torch.testing.assert_close(
            grads[path], g, rtol=1e-4,
            atol=1e-5 * max(float(g.abs().max()), 1e-3), msg=str(path))


def test_a_scan_round_matches_the_reference_round():
    """One FedLDF round of ``run_training_scan`` (K = 2 of N = 4, scan,
    remat) against the plain round from the same weights, data and
    draws."""
    cfg = small(num_layers=2)
    cfg_file = {"name": "granite-4.0-h-small", "kind": "lm",
                "model": {k: v for k, v in model(cfg).items()
                          if k not in ("name", "source")}}
    traffic = {"task": "lm",
               "data": {"seq_len": 24, "num_sequences": 32,
                        "num_domains": 4, "eval_sequences": 4,
                        "partition": "domain"},
               "fl": {"algo": "fedldf", "num_clients": 4,
                      "clients_per_round": 2, "top_n": 1, "local_steps": 1,
                      "lr": 0.05, "mode": "scan", "batch_per_client": 2,
                      "compression": None},
               "model": {"remat_blocks": True}, "eval_every": 1,
               "check_rounds": 2}
    plain.full_f32()
    task = tasks.make(cfg_file, traffic, 5, "cpu")
    from repro_torch.federated.server import run_training_scan

    def run_scan(params, rounds, start, state):
        return run_training_scan(params, task.loss_fn, task.shards,
                                 task.flcfg, rounds=rounds, start_round=start,
                                 server_state=state, device="cpu",
                                 draws=task.draws)

    prog, *_ = check.observe_program(task, run_scan)
    nums = check.numbers(task, prog)
    assert nums["uplink_bytes_gap"] == 0
    assert nums["loss_gap"] < 1e-6 and nums["update_gap"] < 1e-5
    assert nums["update_diff"] < 1e-4


def _whole_layer(d=64, f=32, seed=0):
    cfg = small(d_model=d, moe_d_ff=f, num_experts=72)
    p = tmoe.init_moe(torch.Generator().manual_seed(seed), cfg, "cpu")
    return cfg, p


def _share(cfg, p, i, held=9, shared=True):
    """Chip ``i``'s share of a layer: experts ``held·i`` on, the router
    whole; the shared expert where ``shared``."""
    cfg_i = dataclasses.replace(cfg, num_experts=held,
                                expert_offset=held * i,
                                shared_d_ff=cfg.shared_d_ff if shared else 0,
                                num_shared_experts=int(shared))
    sl = slice(held * i, held * (i + 1))
    p_i = {"router": p["router"], "w_gate": p["w_gate"][sl],
           "w_up": p["w_up"][sl], "w_down": p["w_down"][sl]}
    if shared:
        p_i["shared"] = p["shared"]
    return cfg_i, p_i


def _ref_layer(p, x, cfg, offset=0):
    """The reference's layer: its held experts' loop plus the shared
    expert, and the balance loss."""
    z = REF._dims(model(cfg))
    out, aux = REF.experts(p, x, z, offset, "f32")
    sh = p["shared"]
    return out + REF._swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"],
                             "f32"), aux


def test_the_eight_shares_add_up_to_the_whole_layer():
    """72 experts over 8 chips, 9 a chip: the shares' outputs, the shared
    expert counted once, add up to the reference's whole layer; each share
    reads the same balance loss, the whole router's."""
    cfg, p = _whole_layer()
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want, want_aux = _ref_layer(p, x, cfg)
    total = torch.zeros_like(x)
    for i in range(8):
        cfg_i, p_i = _share(cfg, p, i, shared=i == 0)
        out, aux = tmoe.moe_fwd(p_i, x, cfg_i)
        total = total + out
        torch.testing.assert_close(aux, want_aux, **TOL)
        # and each share against the reference given the same share
        z = REF._dims(model(cfg_i))
        part, _ = REF.experts(p_i, x, z, cfg_i.expert_offset, "f32")
        if i == 0:
            part = part + REF._swiglu(x, *(p["shared"][k] for k in (
                "w_gate", "w_up", "w_down")), "f32")
        torch.testing.assert_close(out, part, **TOL)
    torch.testing.assert_close(total, want, **TOL)
    whole, whole_aux = tmoe.moe_fwd(p, x, cfg)
    torch.testing.assert_close(whole, want, **TOL)
    torch.testing.assert_close(whole_aux, want_aux, **TOL)


def test_routing_forced_onto_one_held_expert_drops_nothing():
    """Every token's first choice is held expert 3: its T rows all run
    (a capacity of int(T·k·1.25/E) would drop most), and the layer equals
    the per-expert loop."""
    cfg, p = _whole_layer()
    cfg, p = _share(cfg, p, 0)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    x[..., 0] = 1.0
    p["router"] = p["router"].clone()
    p["router"][0] = 0.0
    p["router"][0, 3] = 1e3
    t = x.shape[0] * x.shape[1]
    weight, _ = tmoe.share_weights(p, x.reshape(t, -1), cfg)
    routed = (weight > 0).sum(0)
    assert int(routed[3]) == t
    assert t > int(t * cfg.moe_top_k * cfg.capacity_factor
                   / cfg.router_width)
    out, _ = tmoe.moe_fwd(p, x, cfg)
    want, _ = _ref_layer(p, x, cfg)
    torch.testing.assert_close(out, want, **TOL)


def test_unit_map_gives_one_unit_a_layer_over_both_stacks():
    cfg = small()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    umap = UnitMap.build(params)
    assert umap.names == ("attn_blocks/0", "attn_blocks/1", "blocks/0",
                          "blocks/1", "embed", "final")
    # the cut's shape (one attention layer, first): the reference's
    # unit_layout stacks only "blocks", and gives the same units
    cut = small(num_layers=3, attn_period=10)
    params = ttf.init_params(cut, torch.Generator().manual_seed(0), "cpu")
    umap = UnitMap.build(params)
    _, units, sizes = ref_fl.unit_layout(params)
    assert umap.names == ("attn_blocks/0", "blocks/0", "blocks/1", "embed",
                          "final")
    assert units == umap.num_units == cut.num_layers + 2
    assert list(umap.unit_params) == sizes


def test_published_preset():
    cfg = get_config("granite-4.0-h-small")
    assert [i for i in range(cfg.num_layers)
            if cfg.is_attention_layer(i)] == [5, 15, 25, 35]
    assert cfg.param_count() == 32_205_176_832
    assert (cfg.router_width, cfg.shared_width, cfg.ssm_heads) == \
        (72, 1536, 128)
    red = cfg.reduced()
    assert ttf.layer_kinds(red) == ["ssm_moe", "moe"]
    params = ttf.init_params(red, torch.Generator().manual_seed(0), "cpu")
    logits, aux = ttf.forward(params, red, torch.zeros((1, 5), dtype=torch.long))
    assert logits.shape == (1, 5, red.vocab_size) and torch.isfinite(aux)
    with pytest.raises(NotImplementedError, match="patterned stack"):
        tdec.prefill(params, red, torch.zeros((1, 5), dtype=torch.long))


OTHERS = ("qwen3-1.7b", "hymba-1.5b", "deepseek-moe-16b")


@pytest.mark.parametrize("arch", OTHERS)
def test_other_models_unchanged_by_the_new_defaults(arch):
    """The new fields at their defaults add no operation: the forward
    equals the JAX reference's (as tests/test_torch_serve.py holds it) and
    the explicitly neutral settings give the same bits."""
    jax = pytest.importorskip("jax")
    import numpy as np

    from repro.configs import get_config as jget
    from repro.models import transformer as jtf
    from repro_torch.bridge import params_from_numpy

    def f32(c):
        return dataclasses.replace(c.reduced(), param_dtype="float32",
                                   compute_dtype="float32")

    jcfg, cfg = f32(jget(arch)), f32(get_config(arch))
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.arange(14, dtype=np.int32).reshape(2, 7) % cfg.vocab_size
    jl, _ = jax.jit(lambda p, t: jtf.forward(p, jcfg, t))(jparams, toks)
    logits, _ = ttf.forward(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    neutral = dataclasses.replace(
        cfg, norm_eps=1e-6, residual_multiplier=1.0,
        embedding_multiplier=1.0, logits_scaling=1.0,
        attention_multiplier=0.0, nope=False, attn_period=0)
    again, _ = ttf.forward(params, neutral, torch.from_numpy(toks).long())
    assert torch.equal(again, logits)
    assert set(params) == set(ttf.init_params(cfg, None, "meta"))
