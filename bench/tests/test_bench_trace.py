"""The trace's arithmetic and the per-layer readers, on a made-up trace."""
import re

import pytest

from bench import harness, spec, yardstick
from bench.trace import Trace

BENCH = spec.load_benchmark()
MS = 1_000_000


def _trace(kernels, copies=(), spans=(), end=100 * MS):
    return Trace(list(kernels), list(copies), list(spans), 0, end)


def test_union_of_intervals_and_idle_gaps():
    tr = _trace([("a", 10 * MS, 30 * MS), ("b", 20 * MS, 45 * MS),
                 ("c", 70 * MS, 80 * MS)], [("Memcpy HtoD", 85 * MS, 90 * MS)],
                [("run_training_scan", 0, 60 * MS),
                 ("evaluation", 60 * MS, 100 * MS)])
    assert tr.busy_intervals() == [(10 * MS, 45 * MS), (70 * MS, 80 * MS),
                                   (85 * MS, 90 * MS)]
    assert tr.busy_s() == pytest.approx(0.05)
    gaps = tr.idle_gaps(2)
    assert gaps[0] == ["run_training_scan, before c", pytest.approx(0.025)]
    assert gaps[1][1] == pytest.approx(0.01)
    assert tr.top_kernels(1) == [["b", pytest.approx(0.025)]]


def _info(cell, rounds=10, window_s=1.0):
    entry = spec.cell(BENCH, cell)
    return harness.RunInfo(spec.config(BENCH, entry),
                           spec.traffic(entry["traffic"]), rounds, window_s)


def _read(name, tr, info):
    return spec.metric_reader(name).read(tr, info)


def test_fl_roofline_at_its_bound_reads_100():
    info = _info("vgg9-k20-int8ef")
    bytes_ = yardstick.fl_kernel_bytes_per_round(info.cfg, info.traffic)
    ns = {k: v / yardstick.HBM_BYTES_PER_S * 1e9 for k, v in bytes_.items()}
    kernels, t = [], 0
    for _ in range(info.rounds):
        for name, label in (("sqdiff", "sqdiff_partials(Table)"),
                            ("fused_uplink_ef", "fused_uplink_ef_leaves(T)")):
            kernels.append((label, t, t + int(ns[name])))
            t += int(ns[name]) + 1000
    tr = _trace(kernels, end=t)
    assert _read("fl_kernels_roofline", tr, info) == pytest.approx(100, 1e-3)
    assert _read("fl_kernels_ms", tr, info) == pytest.approx(
        sum(ns.values()) / 1e6, 1e-3)


def test_fl_roofline_needs_every_kernel_of_the_round():
    info = _info("vgg9-k20-int8ef")
    tr = _trace([("sqdiff_partials(Table)", 0, MS)])
    assert _read("fl_kernels_roofline", tr, info) is None


def test_readers_return_nothing_without_their_kernels():
    info = _info("hymba-ft-seq512")
    tr = _trace([("void elementwise_kernel<4>()", 0, MS)])
    for name in ("fl_kernels_ms", "fl_kernels_roofline", "attention_ms",
                 "attention_roofline"):
        assert _read(name, tr, info) is None, name
    assert _read("kernels_per_round", tr, info) == pytest.approx(0.1)
    assert _read("device_idle_share", tr, info) == pytest.approx(99.0)


def test_attention_roofline_and_mfu():
    info = _info("hymba-ft-seq512", rounds=4, window_s=20.0)
    flops = yardstick.attention_flops_per_round(info.cfg, info.traffic)
    ns = int(flops * 4 / yardstick.F32_FLOPS * 1e9 * 2)   # half the peak
    tr = _trace([("void flash_fwd<64>(Args)", 0, ns)], end=ns)
    assert _read("attention_roofline", tr, info) == pytest.approx(50, 1e-3)
    assert not re.search(spec.kernel_group("attention")["flash_fwd"][0].pattern,
                         "void flash_fwd_tc(CUtensorMap)")
    mfu = _read("mfu", tr, info)
    assert mfu == pytest.approx(
        100 * yardstick.round_model_flops(info.cfg, info.traffic) * 4
        / (20.0 * yardstick.F32_FLOPS))
    assert 0 < mfu < 100
