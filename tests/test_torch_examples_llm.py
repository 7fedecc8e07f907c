"""``examples/serve_llm_torch.py`` against the reference example's steps on
the CPU: the reduced f32 mamba2-780m, the reference's ``PRNGKey(0)``
params through the bridge, federated fine-tuning of every parameter in
scan mode (6 clients, K=3, top-n 1, B=4, 48-token sequences) for 2 rounds
on the same numpy sampling stream, then greedy decoding of 4 prompts of
16 tokens for 12 steps: the trained params within 2e-5, the bytes exact,
the generated tokens equal and every step's logits within 1e-4.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import LOSS_TOL, PARAM_TOL, max_diff, to_torch  # noqa: E402
from test_torch_examples import load_example  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.federated as jfed  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402

ARCH, ROUNDS, STEPS = "mamba2-780m", 2, 12
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def serve_llm():
    sl = load_example("serve_llm_torch")
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               param_dtype="float32",
                               compute_dtype="float32")
    tcfg = sl.reduced_f32(ARCH)
    assert (tcfg.num_layers, tcfg.d_model) == (jcfg.num_layers,
                                               jcfg.d_model)
    # the reference example's fine-tuning and decoding loop
    toks, domains = jdata.make_lm_dataset(num_sequences=sl.NUM_SEQ,
                                          seq_len=sl.SEQ_LEN,
                                          vocab=jcfg.vocab_size, seed=0)
    jd = jdata.lm_federated(toks, domains, num_clients=sl.N_CLIENTS)
    jfl = jfed.FLConfig(algo="fedldf", num_clients=6, clients_per_round=3,
                        top_n=1, lr=0.05, mode="scan", batch_per_client=4)
    jp0 = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    jparams, jlog = jfed.run_training(
        jp0, functools.partial(lambda c, p, b: jtfm.lm_loss(p, c, b), jcfg),
        jd, jfl, rounds=ROUNDS, seed=0)
    prompts = jnp.asarray(toks[:4, :16].astype(np.int32))
    logits, cache = jax.jit(functools.partial(
        jdec.prefill, cfg=jcfg, max_len=16 + STEPS))(jparams,
                                                      tokens=prompts)
    step = jax.jit(functools.partial(jdec.decode_step, cfg=jcfg))
    jlogits, out = [logits], [jnp.argmax(logits, -1)[:, None]]
    for _ in range(STEPS - 1):
        logits, cache = step(jparams, tokens=out[-1], cache=cache)
        jlogits.append(logits)
        out.append(jnp.argmax(logits, -1)[:, None])
    ref = {"params": jparams, "log": jlog,
           "tokens": np.asarray(jnp.concatenate(out, axis=1)),
           "logits": np.stack([np.asarray(l) for l in jlogits], axis=1)}
    # the port example's functions on the same params
    ttoks, tdata, tfl = sl.fl_task(tcfg)
    np.testing.assert_array_equal(ttoks, toks)
    tparams, tlog = sl.finetune(tcfg, to_torch(jp0), tdata, tfl, ROUNDS,
                                "cpu", verbose=False)
    _, run = sl.generate(tparams, tcfg, ttoks, STEPS, "cpu")
    return sl, ref, {"params": tparams, "log": tlog, "run": run}


def test_serve_llm_finetune_matches_reference(serve_llm):
    _, ref, got = serve_llm
    assert max_diff(got["params"], jax.tree.map(np.asarray,
                                                ref["params"])) <= PARAM_TOL
    np.testing.assert_allclose(got["log"].losses, ref["log"].losses,
                               atol=LOSS_TOL, rtol=0)
    assert got["log"].meter.uplink_bytes == \
        float(ref["log"].meter.uplink_bytes)


def test_serve_llm_generation_matches_reference(serve_llm):
    _, ref, got = serve_llm
    run = got["run"]
    np.testing.assert_array_equal(run.tokens.numpy(), ref["tokens"])
    logits = torch.stack(run.logits, dim=1).numpy()
    assert logits.shape == ref["logits"].shape
    np.testing.assert_allclose(logits, ref["logits"], atol=LOGIT_TOL,
                               rtol=0)


def test_serve_llm_main_on_the_cpu(serve_llm, capsys):
    params, log, run = serve_llm[0].main(["--device", "cpu", "--rounds",
                                          "1", "--steps", "4"])
    assert tuple(run.tokens.shape) == (4, 4)
    assert all(np.isfinite(log.losses))
    assert "uplink saved vs FedAvg: 66.7%" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_round_comm_of_the_full_width_fine_tune_is_the_nearest_f32(arch):
    """The comm record of a full-width f32 round of serve_llm's setup
    (top-n 1 of K = 3; the params on ``meta``): the uplink is the f32
    nearest ``model + K·U·4`` bytes. A unit of over 2**24 B (a layer of
    these models) must not round before the sum."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import round_comm
    from repro_torch.core.units import UnitMap
    from repro_torch.models import transformer as ttfm
    cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    umap = UnitMap.build(ttfm.init_params(cfg, None, device="meta"))
    assert max(umap.unit_bytes) > 2 ** 24
    k, u = 3, umap.num_units
    sel = torch.zeros((k, u))
    sel[torch.arange(u) % k, torch.arange(u)] = 1.0
    comm = round_comm(sel, umap)
    assert float(comm["uplink_total"]) == \
        float(np.float32(umap.total_bytes + k * u * 4))
    assert float(comm["uplink_payload"]) == \
        float(np.float32(umap.total_bytes))
