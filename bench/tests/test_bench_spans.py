"""The card's work given to the program's spans (``bench/spans.py``): the
innermost rule over threads on a made-up trace, the program's layers as
sums over the table, nothing without spans or launch times, idle gaps
named by a program span and idle time summed by span, the readers of
the span metrics over a trace's one attribution and against
``tools/span_table.py``'s report, that tool at a small size on the CPU; on the card, a kernel
launched inside a span lands in it, stamped inside it (the spans and the
profiler share one clock)."""
import pytest

from bench import spans

MAIN, AUTOGRAD = 1, 2

HARNESS = [("run_training_scan", 0, 1000), ("evaluation", 1100, 1300)]
PROGRAM = [  # (path, start, end, thread), as the recorder lists them
    ("engine.enter", 10, 50, MAIN),
    ("engine.draws", 60, 80, MAIN),
    ("engine.round/round.local_training/local_update/forward", 130, 300,
     MAIN),
    ("attention.bwd", 350, 450, AUTOGRAD),
    ("engine.round/round.local_training/local_update/sgd", 500, 580, MAIN),
    ("engine.round/round.local_training/local_update", 120, 590, MAIN),
    ("engine.round/round.local_training", 110, 600, MAIN),
    ("engine.round/round.divergence", 610, 650, MAIN),
    ("engine.round/round.aggregate", 700, 800, MAIN),
    ("engine.round", 100, 900, MAIN),
    ("engine.pull", 910, 990, MAIN),
    ("ssd.fwd", 1150, 1200, MAIN),
]
# (name, start, end, launch): device ns are the duration's own digits
KERNELS = [
    ("fwd_gemm", 210, 211, 200),          # forward
    ("bwd_gemm", 320, 322, 310),          # local_update itself: backward
    ("attn_bwd", 460, 464, 400),          # attention.bwd, autograd thread
    ("sgd_add", 590, 598, 550),           # sgd
    ("sqdiff_rowsum", 660, 676, 620),     # divergence
    ("macc", 800, 832, 750),              # aggregate
    ("fill", 95, 159, 92),                # run_training_scan, no program span
    ("eval_ssd", 1170, 1298, 1160),       # evaluation/ssd.fwd
    ("eval_gemm", 1300, 1556, 1250),      # evaluation
    ("stray", 1060, 1572, 1050),          # between calls
    ("lost", 2000, 3024, None),           # no launch record
]
COPIES = [
    ("Memcpy HtoD (Pinned -> Device)", 85, 89, 70),   # draws
    ("Memcpy DtoH (Device -> Pinned)", 990, 998, 950),  # pull
]
LU = "run_training_scan/engine.round/round.local_training/local_update"


def _attributed():
    launches = spans.Launches(KERNELS, COPIES)
    return spans.attribute(launches, HARNESS, PROGRAM), launches


def test_each_launch_goes_to_the_innermost_span_over_threads():
    (by, _), _ = _attributed()
    device = {p: round(r[0] * 1e9) for p, r in by.items() if r[0]}
    assert device == {
        f"{LU}/forward": 1, LU: 2, f"{LU}/attention.bwd": 4,
        f"{LU}/sgd": 8, "run_training_scan/engine.round/round.divergence": 16,
        "run_training_scan/engine.round/round.aggregate": 32,
        "run_training_scan": 64, "evaluation/ssd.fwd": 128,
        "evaluation": 256, spans.BETWEEN: 512, spans.UNLAUNCHED: 1024,
        "run_training_scan/engine.draws": 4,
        "run_training_scan/engine.pull": 8}
    # every span's host time and calls, under its full path
    assert by[f"{LU}/attention.bwd"][1:] == [pytest.approx(100e-9), 1]
    assert by["run_training_scan/engine.round"][1:] == [
        pytest.approx(800e-9), 1]
    assert by["run_training_scan/engine.enter"] == [
        0.0, pytest.approx(40e-9), 1]


def test_the_program_layers_are_sums_over_the_table():
    (by, timeline), _ = _attributed()
    rounds = 1
    assert spans.local_training_ms(by, rounds) == pytest.approx(15e-6)
    # divergence, aggregate, draws, pull
    assert spans.server_ms(by, rounds) == pytest.approx(60e-6)
    assert spans.host_enqueue_ms(by, rounds) == pytest.approx(800e-6)
    assert spans.attention_bwd_ms(by, rounds) == pytest.approx(4e-6)
    assert spans.evaluation_ms(by, rounds) == pytest.approx(384e-6)
    # run_training_scan's own, between calls and unlaunched: 64+512+1024
    total = sum(r[0] for r in by.values())
    assert spans.unclaimed_share(by, timeline) == pytest.approx(
        1600e-9 / total)
    assert "sgd" in spans.table(by, rounds)


def test_attention_bwd_reads_nothing_where_no_such_span_opened():
    program = [p for p in PROGRAM if p[0] != "attention.bwd"]
    by, _ = spans.attribute(spans.Launches(KERNELS, COPIES), HARNESS,
                            program)
    assert spans.attention_bwd_ms(by, 1) is None


def test_nothing_without_program_spans_or_launch_times():
    launches = spans.Launches(KERNELS, COPIES)
    assert spans.attribute(launches, HARNESS, []) is None
    unstamped = spans.Launches([k[:3] + (None,) for k in KERNELS],
                               [c[:3] + (None,) for c in COPIES])
    assert spans.attribute(unstamped, HARNESS, PROGRAM) is None


def test_idle_gaps_are_named_by_the_innermost_program_span():
    (_, timeline), launches = _attributed()
    busy = [(210, 211), (320, 322), (460, 464), (590, 598)]
    gaps = spans.idle_gaps(busy, launches, timeline, 130, 598, n=3)
    assert gaps == [[f"{LU}, before attn_bwd", pytest.approx(138e-9)],
                    [f"{LU}, before sgd_add", pytest.approx(126e-9)],
                    [f"{LU}/forward, before bwd_gemm",
                     pytest.approx(109e-9)]]


def test_idle_time_is_summed_by_the_span_open_at_each_gap():
    (_, timeline), _ = _attributed()
    busy = [(210, 211), (320, 322), (460, 464), (590, 598)]
    idle = spans.idle_by_span(busy, timeline, 130, 598)
    assert idle == {f"{LU}/forward": pytest.approx(189e-9),
                    LU: pytest.approx(264e-9)}


def test_span_table_drives_a_small_cell_on_the_cpu():
    """``tools/span_table.py``'s warm-up and window at a small size: the
    program's spans of one block, and nothing to attribute without a
    card's records."""
    import collections
    import importlib.util
    from pathlib import Path

    from small_cells import cell

    path = Path(__file__).resolve().parents[2] / "tools" / "span_table.py"
    spec = importlib.util.spec_from_file_location("span_table", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    _, _, cfg, traffic = cell("vgg9-k20-int8ef")
    w = tool.window(*tool.warm("vgg9-k20-int8ef", 2147483659, "cpu", cfg,
                               traffic), 0.0)
    assert w["rounds"] == traffic["eval_every"] == 2
    assert [name for name, _, _ in w["harness"]] == [
        "run_training_scan", "evaluation"]
    paths = collections.Counter(p for p, *_ in w["program"])
    for name in ("engine.enter", "engine.draws", "engine.pull",
                 "engine.exit"):
        assert paths[name] == 1
    for name in ("engine.round", "engine.round/round.state_view",
                 "engine.round/round.uplink",
                 "engine.round/round.local_training/local_update/sgd"):
        assert paths[name] == 2
    out = tool.report(w)
    assert out["by_span"] is None and out["kernels"] == 0


def test_by_span_matches_a_search_of_every_open_span():
    """The table's device column on random nested spans on two threads,
    with launches before, between and after them and some without a
    launch record, against a search of all spans for the innermost one
    open at each launch: the latest to open, the shortest of those that
    open together; a span is open from its start up to, not at, its
    end."""
    import random
    rng = random.Random(2 ** 31 + 7)
    program = []
    for _ in range(40):
        a = rng.randrange(0, 10_000)
        for depth in range(rng.randrange(1, 4)):
            b = a + rng.randrange(1, 500)
            program.append(("/".join(f"s{rng.randrange(5)}"
                                     for _ in range(depth + 1)), a, b,
                            rng.choice([MAIN, AUTOGRAD])))
            a += rng.randrange(0, 10)
    kernels = []
    for i in range(3000):
        start = rng.randrange(0, 11_000)
        launch = None if i % 97 == 0 else start - rng.randrange(-20, 200)
        kernels.append((f"k{i % 7}", start, start + rng.randrange(0, 50),
                        launch))
    by, timeline = spans.attribute(spans.Launches(kernels, []), HARNESS,
                                   program)
    every = [(s, e) for _, s, e in HARNESS] + [(s, e) for _, s, e, _
                                               in program]
    found: dict = {}
    for _, s, e, launch in kernels:
        if launch is None:
            path = spans.UNLAUNCHED
        else:
            open_ = [(a, -b, i) for i, (a, b) in enumerate(every)
                     if a <= launch < b]
            path = (timeline.paths[max(open_)[2]] if open_
                    else spans.BETWEEN)
        found[path] = found.get(path, 0) + (e - s)
    assert {p: round(r[0] * 1e9) for p, r in by.items() if p in found} == \
        found
    assert all(r[0] == 0.0 for p, r in by.items() if p not in found)


def test_subtree_device_ms():
    (by, _), _ = _attributed()
    assert spans.subtree_device_ms(by, 1, "local_update") == \
        pytest.approx(15e-6)
    assert spans.subtree_device_ms(by, 2, "ssd.fwd") == pytest.approx(64e-6)
    assert spans.subtree_device_ms(by, 1, "evaluation") == \
        pytest.approx(384e-6)
    assert spans.subtree_device_ms(by, 1, "no.such.span") is None


def _traced(program=PROGRAM):
    from bench.trace import Trace
    return Trace(list(KERNELS), list(COPIES), list(HARNESS), 0, 3024,
                 program=list(program))


SPAN_METRICS = {"local_training_ms": 15e-6, "server_ms": 60e-6,
                "host_enqueue_ms": 800e-6, "attention_bwd_ms": 4e-6}


def _info(rounds):
    from bench import harness, spec
    bench = spec.load_benchmark()
    entry = spec.cell(bench, "hymba-ft-seq512")
    return harness.RunInfo(spec.config(bench, entry),
                           spec.traffic(entry["traffic"]), rounds, 1.0)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_readers_on_a_trace_with_program_spans(name):
    """Each reader of ``bench/metrics/`` over the trace's one attribution,
    at two rounds: half the sums the table gives."""
    from bench import spec
    info, tr = _info(2), _traced()
    assert spec.metric_reader(name).read(tr, info) == pytest.approx(
        SPAN_METRICS[name] / 2)
    assert tr.attribution is tr.attribution       # worked out once
    # nothing to read without the program's spans
    assert spec.metric_reader(name).read(_traced([]), info) is None


def test_attention_bwd_reader_reads_nothing_where_no_such_span_opened():
    from bench import spec
    tr = _traced([p for p in PROGRAM if p[0] != "attention.bwd"])
    assert spec.metric_reader("attention_bwd_ms").read(tr, _info(1)) is None


def test_trace_gaps_are_named_by_the_innermost_program_span():
    """The trace's own gaps (its breakdown) name the innermost program
    span open at each gap's start, with its parent."""
    assert _traced().idle_gaps(3) == [
        [f"{spans.BETWEEN}, before lost", pytest.approx(428e-9)],
        ["run_training_scan/engine.round, before Memcpy DtoH (Device -> "
         "Pinned)", pytest.approx(158e-9)],
        ["round.local_training/local_update, before attn_bwd",
         pytest.approx(138e-9)]]
    # the harness's span where the trace has no program spans
    assert _traced([]).idle_gaps(2)[1][0] == \
        "run_training_scan, before Memcpy DtoH (Device -> Pinned)"
    # the same names as the span table's, cut to the last two
    (_, timeline), launches = _attributed()
    tr = _traced()
    full = spans.idle_gaps(tr.busy_intervals(), launches, timeline, 0, 3024,
                           n=3)
    assert [[g[0].split(", before")[0].split("/")[-2:], g[1]]
            for g in full] == [[g[0].split(", before")[0].split("/"), g[1]]
                               for g in tr.idle_gaps(3)]


def test_the_readers_equal_the_span_table_on_one_window():
    """``tools/span_table.py``'s report and the benchmark's readers on the
    same window's records give the same number for each span metric."""
    import importlib.util
    from pathlib import Path

    from bench import spec
    path = Path(__file__).resolve().parents[2] / "tools" / "span_table.py"
    module = importlib.util.spec_from_file_location("span_table", path)
    tool = importlib.util.module_from_spec(module)
    module.loader.exec_module(tool)
    w = dict(launches=spans.Launches(KERNELS, COPIES), rounds=2,
             window_s=1.0, read_s=0.0, harness=HARNESS, program=PROGRAM,
             start_ns=0, end_ns=3024)
    out = tool.report(w)
    for name in SPAN_METRICS:
        assert spec.metric_reader(name).read(_traced(), _info(2)) == \
            out[name], name


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_kernel_lands_in_the_span_that_launched_it(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry import profiling

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as program:
            with profiling.span("probe"):
                y = x * 3.0
            torch.cuda.synchronize()
    launches = spans.read_launches(prof)
    assert launches.kernels and all(k[3] is not None
                                    for k in launches.kernels)
    # no record of the span itself reaches the device trace
    assert not any("probe" in r[0] for r in launches.all())
    (path, start, end, _), = program
    by, _ = spans.attribute(launches, [], program)
    assert by["probe"][0] > 0 and by["probe"][2] == 1
    launched = [k[3] for k in launches.kernels]
    assert any(start <= t <= end for t in launched)
    assert float(y[0]) == 3.0
