"""The dry-run tooling against the reference: the op counter
(``repro_torch.launch.opcount``, the counterpart of ``hloparse``) on known
programs and against ``hloparse.analyze`` of the reference's compiled
reduced programs, and ``repro_torch.launch.dryrun`` / ``inspect`` /
``roofline`` end to end."""
import dataclasses
import io
import json
import math
import os

import jax
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget
from repro.launch import hloparse
from repro.launch import shapes as jshapes
from repro_torch.configs import get_config as tget
from repro_torch.launch import dryrun, opcount
from repro_torch.launch import inspect as tinspect
from repro_torch.launch import roofline as troof
from repro_torch.launch import shapes as tshapes

META = torch.device("meta")


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


# ----------------------------------------------------------------------
# FLOPs of single ops and their gradients
# ----------------------------------------------------------------------
M, K, N, B = 64, 128, 96, 5


@pytest.mark.parametrize("op", ["mm", "bmm", "addmm", "matmul3d"])
def test_matmul_flops_and_gradients(op):
    lead = (B,) if op in ("bmm", "matmul3d") else ()
    a, w = _meta(*lead, M, K, grad=True), _meta(K, N, grad=True)
    if op == "bmm":
        w = _meta(B, K, N, grad=True)
    bias = _meta(N, grad=True)

    def fwd(a, w, bias):
        if op == "mm":
            return a @ w
        if op == "bmm":
            return torch.bmm(a, w)
        if op == "addmm":
            return torch.addmm(bias, a, w)
        return a @ w                     # (B, M, K) @ (K, N)

    one = 2 * math.prod(lead) * M * K * N
    assert opcount.analyze(fwd, a, w, bias).flops == one
    # a gradient of both operands costs two more products
    t = opcount.analyze(
        lambda a, w, b: torch.autograd.grad(fwd(a, w, b).sum(), (a, w)),
        a, w, bias)
    assert t.flops == 3 * one


def test_conv2d_flops_and_gradients():
    x = _meta(B, 3, 16, 16, grad=True)
    w = _meta(8, 3, 3, 3, grad=True)
    one = 2 * B * 8 * 16 * 16 * 3 * 3 * 3
    assert opcount.analyze(lambda x, w: F.conv2d(x, w, padding=1),
                           x, w).flops == one
    t = opcount.analyze(lambda x, w: torch.autograd.grad(
        F.conv2d(x, w, padding=1).sum(), (x, w)), x, w)
    assert t.flops == 3 * one
    # the weight's gradient alone (an input that needs none)
    x0 = _meta(B, 3, 16, 16)
    t = opcount.analyze(lambda x, w: torch.autograd.grad(
        F.conv2d(x, w, padding=1).sum(), w), x0, w)
    assert t.flops == 2 * one
    # grouped: C_in / groups inputs an output, forward and backward
    xg, wg = _meta(B, 6, 16, 16, grad=True), _meta(8, 3, 3, 3, grad=True)
    t = opcount.analyze(lambda x, w: torch.autograd.grad(
        F.conv2d(x, w, padding=1, groups=2).sum(), (x, w)), xg, wg)
    assert t.flops == 3 * one


@pytest.mark.parametrize("kind", ["mm", "conv2d"])
def test_vmap_over_k_counts_k_times_one(kind):
    """K clients under vmap (each with its own weights, as the FL round)
    count K times one client, gradients included."""
    k = 4
    if kind == "mm":
        x, w = _meta(M, K), _meta(K, N)

        def loss(w, x):
            return torch.tanh(x @ w).sum()
    else:
        x, w = _meta(B, 3, 16, 16), _meta(8, 3, 3, 3)

        def loss(w, x):
            return torch.tanh(F.conv2d(x, w, padding=1)).sum()
    grad = torch.func.grad(loss)
    one = opcount.analyze(grad, w, x).flops
    ws = torch.empty((k, *w.shape), device=META)
    xs = torch.empty((k, *x.shape), device=META)
    many = opcount.analyze(torch.func.vmap(grad), ws, xs).flops
    assert one > 0 and many == k * one


# ----------------------------------------------------------------------
# bytes and memory
# ----------------------------------------------------------------------
def test_view_ops_count_no_bytes_and_peak_of_a_known_sequence():
    def f(x):
        a = x * 2                     # 4096 B read, 4096 B written
        v = a.view(32, 32).t()[::2].unsqueeze(0).expand(3, 16, 32)
        del v
        c = a + 1                     # peak: x, a, c live
        del a
        return c.sum()                # 4096 B read, 4 B written
    x = _meta(1024)
    t = opcount.analyze(f, x)
    views = [r for r in t.records if r.bytes == 0]
    assert {r.op.split(".")[1] for r in views} == {"view", "t", "slice",
                                                   "unsqueeze", "expand"}
    assert t.hbm_bytes == 8192 + 8192 + 4100
    assert t.argument_bytes == 4096 and t.output_bytes == 4
    assert t.peak_bytes == 3 * 4096
    assert t.alias_bytes == 0
    # an in-place write: the destination is written, not read
    y, z = _meta(256), _meta(256)
    t = opcount.analyze(lambda y, z: y.copy_(z), y, z)
    assert t.hbm_bytes == 2048 and t.alias_bytes == 1024


def test_records_name_the_op_and_the_source_frame():
    cfg = dataclasses.replace(tget("qwen3-1.7b").reduced(),
                              param_dtype="float32", compute_dtype="float32")
    prog = tshapes.build_program(cfg, SMALL["prefill"])
    t = opcount.analyze(prog.fn, *prog.args)
    rows = tinspect.top_flops(t, 3)
    assert rows and all("repro_torch/models/" in src for *_, src in rows)
    assert all(f == n * raw for f, n, raw, _ in rows)
    assert tinspect.top_hbm(t, 3)[0][0] > 0
    assert tinspect.top_collectives(t) == []
    assert t.collective_by_type == {c: 0.0 for c in hloparse.COLLECTIVES}


def test_a_functional_collective_counts_under_the_reference_name(tmp_path):
    """A program that issues a collective (here torch's functional
    all-reduce in a world of one gloo rank, on the CPU) counts its result
    bytes under hloparse's key, and inspect ranks it."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fcol
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        t = opcount.analyze(
            lambda x: fcol.all_reduce(x, "sum", dist.group.WORLD) * 2,
            torch.ones(256))
    finally:
        dist.destroy_process_group()
    assert t.collective_by_type == {**{c: 0.0 for c in hloparse.COLLECTIVES},
                                    "all-reduce": 1024.0}
    assert t.collective_bytes == 1024
    (b, op, n, raw, src), = tinspect.top_collectives(t)
    assert (b, op, n, raw) == (1024, "all-reduce", 1, 1024)


def test_a_data_dependent_op_raises_naming_the_op():
    with pytest.raises(opcount.OpCountError, match="_local_scalar_dense"):
        opcount.analyze(lambda x: x.sum().item(), _meta(8))


# ----------------------------------------------------------------------
# against hloparse.analyze of the reference's compiled reduced programs
# (built as tests/test_dryrun_host.py builds them)
# ----------------------------------------------------------------------
SMALL = {
    "train": tshapes.ShapeSpec("train_small", "train", 32, 8),
    "prefill": tshapes.ShapeSpec("prefill_small", "prefill", 64, 2),
    "decode": tshapes.ShapeSpec("decode_small", "decode", 64, 2),
}
REL = {"train": 0.02, "prefill": 0.01, "decode": 0.01}
ARCHS = ["qwen3-1.7b", "mamba2-780m", "deepseek-moe-16b",
         "seamless-m4t-large-v2"]


def _reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), param_dtype="float32",
                               compute_dtype="float32")


def _reference_hlo(arch, kind):
    shape = jshapes.ShapeSpec(*dataclasses.astuple(SMALL[kind]))
    flcfg = dataclasses.replace(jshapes.FL_TRAIN, clients_per_round=2,
                                top_n=1)
    prog = jshapes.build_program(_reduced(jget, arch), shape, flcfg)
    return jax.jit(prog.fn).lower(*prog.args).compile().as_text()


def _hlo_conv_flops(hlo):
    """The loop-weighted FLOPs ``hloparse.analyze`` gives the
    ``convolution`` instructions of ``hlo``."""
    comps = hloparse.parse_module(hlo)
    weights = hloparse.computation_weights(comps)
    total = 0.0
    for name, comp in comps.items():
        if isinstance(comp, str):       # the entry's sentinel
            continue
        symtab = {i.name: i for i in comp.instrs}
        total += weights.get(name, 0.0) * sum(
            hloparse._conv_flops(i, symtab) for i in comp.instrs
            if i.op == "convolution")
    return total


def _mamba_train_flops(cfg, shape, flcfg):
    """The port's matmul FLOPs of a fedldf scan round of an ssm model:
    2K local updates (phase 1, then the phase-2 recompute), each a
    forward and a backward of twice its products (both operands of every
    product need a gradient)."""
    b, s = shape.global_batch // flcfg.clients_per_round, shape.seq
    d, di, n, h, p, q = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                         cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk)
    t, nc = b * s, -(-s // q)
    layer = (2 * t * d * (2 * di + 2 * n + h)       # in_proj
             + 2 * b * nc * q * q * n               # C·B
             + 2 * b * nc * h * q * q * p           # intra-chunk
             + 2 * b * nc * h * n * q * p           # chunk states
             + 2 * b * nc * h * q * n * p           # inter-chunk
             + 2 * t * di * d)                      # out_proj
    fwd = cfg.num_layers * layer + 2 * t * d * cfg.vocab_size
    return 2 * flcfg.clients_per_round * 3 * fwd


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counted_flops_match_hloparse(arch, kind):
    """``dryrun.count`` of the port's reduced program against
    ``hloparse.analyze`` of the reference's: within 1 % (prefill, decode)
    and 2 % (train). mamba2's train round is held to its analytic count,
    and to hloparse's total without the convolutions: hloparse's
    ``_conv_flops`` ignores ``feature_group_count`` and counts the
    depthwise conv's backward 288x (ROADMAP Queue 3), and the port's
    depthwise conv is elementwise, which neither counter counts."""
    cfg = _reduced(tget, arch)
    flcfg = dataclasses.replace(tshapes.FL_TRAIN, clients_per_round=2,
                                top_n=1)
    roof, totals = dryrun.count(cfg, SMALL[kind], arch=arch, flcfg=flcfg)
    assert roof.mesh == "1xH100" and roof.chips == 1
    assert roof.t_collective == 0 and roof.flops_per_device > 0
    mem = roof.memory_per_device
    assert mem["argument_size_in_bytes"] > 0 and mem["fits_one_card"]
    assert mem["temp_size_in_bytes"] >= 0
    hlo = _reference_hlo(arch, kind)
    ref = hloparse.analyze(hlo).flops
    if (arch, kind) == ("mamba2-780m", "train"):
        assert totals.flops == _mamba_train_flops(cfg, SMALL[kind], flcfg)
        ref -= _hlo_conv_flops(hlo)
    assert totals.flops == pytest.approx(ref, rel=REL[kind])


# ----------------------------------------------------------------------
# dryrun end to end
# ----------------------------------------------------------------------
def test_roofline_json_reads_in_the_reference_table(tmp_path):
    from benchmarks import roofline_table
    cfg = _reduced(tget, "qwen3-1.7b")
    roof, _ = dryrun.count(cfg, SMALL["prefill"], arch="qwen3-1.7b")
    roof.save(str(tmp_path / "qwen3-1.7b_prefill_small_1xH100.json"))
    out = io.StringIO()
    rows = roofline_table.run(str(tmp_path), out=out)
    assert len(rows) == 1 and rows[0]["mesh"] == "1xH100"
    line = out.getvalue().splitlines()[1]
    assert line.startswith("qwen3-1.7b,prefill_small,1xH100,")
    d = json.loads((tmp_path / "qwen3-1.7b_prefill_small_1xH100.json")
                   .read_text())
    assert d["t_compute_s"] == d["flops_per_device"] / troof.PEAK_FLOPS
    assert d["t_memory_s"] == d["bytes_per_device"] / troof.HBM_BW
    assert set(d["collective_by_type"]) == set(hloparse.COLLECTIVES)
    assert d["counted_program"] == troof.COUNTED_PROGRAM
    assert d["counted_program"].startswith("plain")


def test_full_width_prefill_argument_bytes_equal_reference():
    """qwen3-1.7b × prefill_32k at full width on meta: the argument bytes
    are the reference's ``eval_shape`` bytes (params + tokens)."""
    roof, totals = dryrun.lower_one("qwen3-1.7b", "prefill_32k",
                                    verbose=False)
    jp = jshapes.build_program(jget("qwen3-1.7b"),
                               jshapes.SHAPES["prefill_32k"])
    want = sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(jp.args))
    assert roof.memory_per_device["argument_size_in_bytes"] == want
    assert totals.argument_bytes == want
    shards = roof.memory_per_device["argument_size_in_bytes_sharded"]
    assert 0 < shards < want / 100
    assert roof.model_flops == troof.model_flops_for(
        tget("qwen3-1.7b"), tshapes.SHAPES["prefill_32k"])


def test_main_skips_existing_artifacts_and_lists_failures(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    out = str(tmp_path)
    tag = "qwen3-1.7b_train_4k_1xH100"
    open(os.path.join(out, tag + ".json"), "w").close()
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                        "--out", out]) == 0
    assert f"skip {tag}" in capsys.readouterr().out

    def boom(arch, shape, **kw):
        raise opcount.OpCountError("aten._local_scalar_dense.default at "
                                   "somewhere")
    monkeypatch.setattr(dryrun, "lower_one", boom)
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                        "--out", out]) == 1
    text = capsys.readouterr().out
    assert "FAILURES" in text and "_local_scalar_dense" in text
