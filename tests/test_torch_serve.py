"""The port's serving path against the JAX package on the CPU, in f32:
``forward`` (logits and aux), ``prefill`` and ``decode_step`` on the
dense, vlm, moe, ssm, hybrid and audio (enc-dec) configs of
tests/test_decode_consistency.py plus reduced qwen3-1.7b,
deepseek-moe-16b, llama4-maverick-400b-a17b, mamba2-780m, hymba-1.5b and
seamless-m4t-large-v2, with the reference's weights carried across
through the bridge; every configured arch's reduced parameter tree;
checkpoints written by one package and read by the other (bf16 bit for
bit); and the serve launcher."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_pytree as jload  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"rtol": 1e-4, "atol": 1e-4}          # test_decode_consistency.py:47


def mk(family, **kw):
    """tests/test_decode_consistency.py:mk, for both packages."""
    base = dict(name="t-" + family, family=family, num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=97)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def reduced_f32(arch):
    def f32(c):
        return dataclasses.replace(c.reduced(), param_dtype="float32",
                                   compute_dtype="float32")
    return f32(jget_config(arch)), f32(get_config(arch))


CASES = {
    "dense": mk("dense"),
    "dense-w8": mk("dense", sliding_window=8),
    "dense-qknorm-bias": mk("dense", qk_norm=True, qkv_bias=True),
    "vlm-mrope": mk("vlm", mrope=True, mrope_sections=(4, 2, 2)),
    "qwen3-1.7b-reduced": reduced_f32("qwen3-1.7b"),
    # tests/test_decode_consistency.py:26-27: a capacity no call can fill
    "moe": mk("moe", num_experts=4, moe_top_k=2, moe_d_ff=32,
              num_shared_experts=1, d_ff=0, capacity_factor=8.0),
    "deepseek-moe-16b-reduced": reduced_f32("deepseek-moe-16b"),
    "llama4-maverick-400b-a17b-reduced": reduced_f32(
        "llama4-maverick-400b-a17b"),
    "ssm": mk("ssm", ssm_state=8, ssm_head_dim=16, ssm_chunk=8),
    "hybrid": mk("hybrid", ssm_state=8, ssm_head_dim=16, ssm_chunk=8),
    "mamba2-780m-reduced": reduced_f32("mamba2-780m"),
    "hymba-1.5b-reduced": reduced_f32("hymba-1.5b"),
    # tests/test_decode_consistency.py:31,41: (2, 13, 24) frames
    "audio": mk("audio", encoder_layers=2, frontend_dim=24),
    "seamless-m4t-large-v2-reduced": reduced_f32("seamless-m4t-large-v2"),
}
CACHE_KEYS = ("k", "v", "ssm_conv", "ssm_state", "cross_k", "cross_v")
AUX_TOL = 1e-5


def never_drops(cfg):
    """No call can drop an expert choice: the capacity covers every token
    of any call (``k · capacity_factor >= E``), or the model has no
    experts. Only then does a decode step (capacity over B tokens) compute
    what ``forward`` (over B·S) computes at the same position."""
    return cfg.family != "moe" or \
        cfg.moe_top_k * cfg.capacity_factor >= cfg.num_experts


# the reference's entry points, compiled once per config (it is hashable)
jforward = jax.jit(jtf.forward, static_argnums=1)
jprefill = jax.jit(jdec.prefill, static_argnums=1,
                   static_argnames=("max_len",))
jdecode = jax.jit(jdec.decode_step, static_argnums=1)


def _carry(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _frames(cfg, b, seed=0):
    """An enc-dec model's (B, 13, frontend_dim) f32 frames, else None."""
    if not cfg.is_encdec:
        return None, None
    fr = np.random.default_rng(seed + 100).normal(
        size=(b, 13, cfg.frontend_dim)).astype(np.float32)
    return jnp.asarray(fr), torch.from_numpy(fr)


def _assert_caches(tcache, jcache):
    """Every cache leaf the reference has (K/V, the SSD's conv tail and
    state, the cross K/V), with its dtype, and no other."""
    keys = [key for key in CACHE_KEYS if key in jcache]
    assert keys and set(tcache) == set(keys) | {"pos"}
    for key in keys:
        assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype))
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL,
                                   err_msg=key)


def _serving_matches(jcfg, tcfg, toks, s, steps, max_len, seed=0):
    """forward (and its aux), prefill and ``steps`` decode steps of both
    packages on the same weights and tokens; prefill against forward over
    the prompt alone (the same tokens, so the same expert choices); and
    decode against forward at the same position where no call can drop an
    expert choice."""
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = _carry(jparams)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    jfr, tfr = _frames(tcfg, toks.shape[0], seed)
    jfull, jaux = jforward(jparams, jcfg, jt, jfr)
    tfull, aux = ttf.forward(tparams, tcfg, tt, tfr)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **TOL)

    jlg, jcache = jprefill(jparams, jcfg, jt[:, :s], jfr, max_len=max_len)
    tlg, tcache = tdec.prefill(tparams, tcfg, tt[:, :s], tfr,
                               max_len=max_len)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_allclose(
        tlg.numpy(),
        ttf.forward(tparams, tcfg, tt[:, :s], tfr)[0][:, -1].numpy(), **TOL)
    _assert_caches(tcache, jcache)
    assert tcache["pos"] == int(jcache["pos"]) == s
    for t in range(steps):
        jlg, jcache = jdecode(jparams, jcfg, jt[:, s + t:s + t + 1], jcache)
        tlg, tcache = tdec.decode_step(tparams, tcfg, tt[:, s + t:s + t + 1],
                                       tcache)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        if never_drops(tcfg):
            np.testing.assert_allclose(tlg.numpy(), tfull[:, s + t].numpy(),
                                       **TOL)
    _assert_caches(tcache, jcache)


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_prefill_decode_match_reference(name):
    jcfg, tcfg = CASES[name]
    s, steps = 13, 4                       # deliberately not a chunk multiple
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(2, s + steps)).astype(np.int32)
    _serving_matches(jcfg, tcfg, toks, s, steps, max_len=s + steps)


def test_long_prompt_takes_the_reference_flash_branch():
    """A prompt past the reference's flash_threshold (2048): its prefill
    and decode attention run the chunked ``_attend_flash`` branch, on both
    sides."""
    jcfg, tcfg = mk("dense")
    s, steps = 2060, 2
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(1, s + steps)).astype(np.int32)
    _serving_matches(jcfg, tcfg, toks, s, steps, max_len=s + steps)


def test_ring_buffer_eviction_matches_reference_and_window():
    """tests/test_decode_consistency.py:56: a prompt-sized ring buffer under
    a sliding window, rolled by every decode step."""
    jcfg, tcfg = mk("dense", sliding_window=6)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = _carry(jparams)
    toks = np.random.default_rng(2).integers(0, 97, size=(1, 20)) \
        .astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    tfull, _ = ttf.forward(tparams, tcfg, tt)
    jlg, jcache = jprefill(jparams, jcfg, jt[:, :10])
    tlg, tcache = tdec.prefill(tparams, tcfg, tt[:, :10])
    assert tcache["k"].shape[2] == 6
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    for t in range(10, 20):
        jlg, jcache = jdecode(jparams, jcfg, jt[:, t:t + 1], jcache)
        tlg, tcache = tdec.decode_step(tparams, tcfg, tt[:, t:t + 1], tcache)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tlg.numpy(), tfull[:, t].numpy(), **TOL)


def test_vlm_embeddings_match_reference():
    """qwen2-vl's early-fusion stub: projected patch embeddings added to
    the first token slots, through forward and prefill."""
    jcfg, tcfg = reduced_f32("qwen2-vl-2b")
    jparams = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = _carry(jparams)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, size=(2, 12)).astype(np.int32)
    emb = rng.normal(size=(2, 4, tcfg.frontend_dim)).astype(np.float32)
    jfull, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks),
                           embeddings=jnp.asarray(emb))
    tfull, _ = ttf.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                           embeddings=torch.from_numpy(emb))
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **TOL)
    jlg, _ = jdec.prefill(jparams, jcfg, jnp.asarray(toks),
                          embeddings=jnp.asarray(emb))
    tlg, _ = tdec.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                          embeddings=torch.from_numpy(emb))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)


def test_greedy_generate_matches_reference_greedy_loop():
    """serve.generate at temperature 0 against the reference's prefill +
    decode loop with argmax, on the same weights and prompts."""
    _greedy_matches("qwen3-1.7b")


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_greedy_generate_with_ssm_cache_matches_reference(arch):
    """The same for the ssm kind (a cache with no K/V) and the hybrid."""
    _greedy_matches(arch)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b"])
def test_greedy_generate_moe_matches_reference(arch):
    """The same for the moe kind, top-2 with a shared expert and top-1, at
    the configs' capacity factor 1.25."""
    _greedy_matches(arch)


def test_greedy_generate_encdec_matches_reference():
    """The same for the enc-dec kind, with (2, 13, 128) frames: the
    encoder runs once, each step reads the cross K/V."""
    _greedy_matches("seamless-m4t-large-v2")


def _greedy_matches(arch):
    jcfg, tcfg = reduced_f32(arch)
    jparams = jtf.init_params(jax.random.PRNGKey(4), jcfg)
    tparams = _carry(jparams)
    prompts = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, size=(2, 8)).astype(np.int32)
    jfr, tfr = _frames(tcfg, 2, 4)
    steps = 6
    lg, cache = jprefill(jparams, jcfg, jnp.asarray(prompts), jfr,
                         max_len=8 + steps)
    toks = jnp.argmax(lg, -1)[:, None]
    want = [toks]
    for _ in range(steps - 1):
        lg, cache = jdecode(jparams, jcfg, toks, cache)
        toks = jnp.argmax(lg, -1)[:, None]
        want.append(toks)
    got = serve.generate(tparams, tcfg, torch.from_numpy(prompts).long(),
                         steps, temperature=0.0, keep_logits=True,
                         enc_inputs=tfr)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))
    assert len(got.logits) == steps


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_reduced_config_has_the_reference_tree(arch):
    """Every configured arch builds in the port (no block kind is
    refused): its reduced config's tree, in the config's own dtypes,
    against the reference's ``jax.eval_shape(init_params)``: paths, shapes
    and dtypes."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    shapes = jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
             for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
    tflat = {jax.tree_util.keystr(p): (tuple(x.shape),
                                       str(x.dtype).replace("torch.", ""))
             for p, x in jax.tree_util.tree_leaves_with_path(tparams)}
    assert tflat == jflat


def test_init_params_has_the_reference_tree():
    jcfg, tcfg = CASES["dense-qknorm-bias"]
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat = {jax.tree_util.keystr(p): (x.shape, x.dtype) for p, x in
             jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype)) for p, x
             in jax.tree_util.tree_leaves_with_path(tparams)}
    assert set(jflat) == set(tflat)
    for key, (shape, dtype) in jflat.items():
        assert tflat[key] == (tuple(shape), "torch." + str(dtype)), key


def _bf16_tree(seed=0):
    cfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                              num_layers=1)
    return jtf.init_params(jax.random.PRNGKey(seed), cfg)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_bridge_carries_bf16_bit_for_bit():
    jparams = _bf16_tree()
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(jparams))
    tparams = _carry(jparams)
    for j, t in zip(jax.tree.leaves(jparams), jax.tree.leaves(tparams)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_bits(t), _bits(j))
    for j, n in zip(jax.tree.leaves(jparams),
                    jax.tree.leaves(params_to_numpy(tparams))):
        assert n.dtype.kind == "V" and n.dtype.itemsize == 2
        np.testing.assert_array_equal(n.view(np.int16), _bits(j))


def test_checkpoint_written_by_one_package_loads_in_the_other(tmp_path):
    jparams = _bf16_tree(1)
    jparams["extra"] = {"f32": jnp.arange(5, dtype=jnp.float32),
                        "pair": (jnp.ones(2), jnp.zeros(3, jnp.int32))}
    # reference -> port
    jsave(str(tmp_path / "ref.npz"), jparams)
    tparams = tckpt.load_pytree(str(tmp_path / "ref.npz"), "cpu")
    assert isinstance(tparams["extra"]["pair"], tuple)
    for j, t in zip(jax.tree.leaves(jparams), jax.tree.leaves(tparams)):
        assert str(t.dtype) == "torch." + str(j.dtype)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(t), _bits(j))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # port -> reference: the same arrays as the reference's own file
    tckpt.save_pytree(str(tmp_path / "port.npz"), tparams)
    own, back = jload(str(tmp_path / "ref.npz")), jload(str(tmp_path /
                                                            "port.npz"))
    assert jax.tree.structure(own) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # server state round trip in the port
    tckpt.save_server_state(str(tmp_path / "state.npz"), tparams,
                            {"client": {"residual": tparams["final"]}})
    p2, st = tckpt.load_server_state(str(tmp_path / "state.npz"), "cpu")
    assert torch.equal(st["client"]["residual"]["norm"].view(torch.int16),
                       tparams["final"]["norm"].view(torch.int16))
    assert set(p2) == set(tparams)


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--temperature", "0", "--batch", "2",
         "--prompt-len", "8", "--steps", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=qwen3-1.7b-reduced batch=2 prompt=8 "
                               "steps=4 device=cpu")
    assert lines[1].startswith("prefill: ") and "ms/tok" in lines[1]
    assert lines[2].startswith("  seq0: [") and len(lines) == 4


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_serve_main_runs_ssm_and_hybrid_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--temperature", "0", "--batch", "2", "--prompt-len", "20",
                "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch}-reduced batch=2 prompt=20 "
                               "steps=3 device=cpu")
    assert lines[1].startswith("prefill: ") and len(lines) == 4


def test_serve_main_runs_encdec_on_cpu(capsys):
    """``--arch seamless-m4t-large-v2``, reduced, through the launcher:
    (B, S, frontend_dim) frames drawn after the prompts."""
    serve.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--device",
                "cpu", "--temperature", "0", "--batch", "2", "--prompt-len",
                "20", "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=seamless-m4t-large-v2-reduced batch=2 "
                               "prompt=20 steps=3 device=cpu")
    assert lines[1].startswith("prefill: ") and len(lines) == 4


def test_serve_main_runs_moe_on_cpu(capsys):
    """``--arch deepseek-moe-16b``, reduced, through the launcher."""
    serve.main(["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
                "--temperature", "0", "--batch", "2", "--prompt-len", "20",
                "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=deepseek-moe-16b-reduced batch=2 "
                               "prompt=20 steps=3 device=cpu")
    assert lines[1].startswith("prefill: ") and len(lines) == 4
