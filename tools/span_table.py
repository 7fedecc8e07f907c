"""Where a benchmark cell's round goes, by the program's spans, on the card.

    python3 tools/span_table.py --workload <cell> --seed <n> --seconds <s>
        [--json PATH]

Builds the cell's task as ``bench/run.py`` does (its config, traffic and
weights from the seed) and warms up as its set-up does: the check's rounds,
one ``run_training_scan`` call a round, then one evaluation. Then it runs
the benchmark's window (blocks of ``eval_every`` rounds, each followed by
the evaluation, until ``--seconds`` have passed, at least one block) under
``torch.profiler`` (the card's activity only) with the program's spans
recorded
(``repro_torch.telemetry.profiling.recording()``), and gives each kernel
and copy to the span that launched it (:mod:`bench.spans`).

Prints each span path's calls, host ms a round and device ms a round; the
per-layer numbers the spans give (``local_training_ms``, ``server_ms``,
``host_enqueue_ms``, ``attention_bwd_ms``, and the evaluation's device ms
a round); the share of the card's work that no program span and not the
evaluation claims; the longest idle gaps, named by the innermost open
span, and the idle ms a round each span holds; the card's name and
power limit. ``--json`` writes every number.
Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm(workload: str, seed: int, device="cuda", cfg=None, traffic=None):
    """``(task, run_scan, params, state, next round)`` after the set-up the
    harness makes before its window; ``cfg`` and ``traffic`` default to
    the cell's files (a CPU rehearsal passes small ones)."""
    from bench import spec, tasks
    from bench.reference import plain
    from repro_torch.federated.server import run_training_scan

    bench = spec.load_benchmark()
    entry = spec.cell(bench, workload)
    traffic = traffic or spec.traffic(entry["traffic"])
    plain.full_f32()
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    task = tasks.make(cfg or spec.config(bench, entry), traffic, seed,
                      device)

    def run_scan(params, rounds, start, state):
        return run_training_scan(params, task.loss_fn, task.shards,
                                 task.flcfg, rounds=rounds,
                                 start_round=start, server_state=state,
                                 device=task.device, draws=task.draws)

    params, state = task.weights(), None
    for t in range(traffic["check_rounds"]):
        params, log = run_scan(params, 1, t, state)
        state = log.final_state
    task.eval_fn(params)
    _sync(device)
    return task, run_scan, params, state, traffic["check_rounds"]


def window(task, run_scan, params, state, t: int, seconds: float) -> dict:
    """The harness's window under the profiler, spans recorded; returns
    the model, the state, the next round and what the trace holds."""
    from torch.profiler import ProfilerActivity, profile

    from bench import spans as spans_mod
    from bench import trace as trace_mod
    from repro_torch.telemetry import profiling

    every = task.traffic["eval_every"]
    rec, rounds = trace_mod.Recorder(), 0
    cuda = task.device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        with profiling.recording() as program:
            _sync(task.device)
            start = time.time_ns()
            t0 = time.perf_counter()
            while True:
                with rec.span("run_training_scan"):
                    params, log = run_scan(params, every, t, state)
                state = log.final_state
                with rec.span("evaluation"):
                    task.eval_fn(params)
                t += every
                rounds += every
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
            _sync(task.device)
            end = time.time_ns()
    read = time.perf_counter()
    launches = spans_mod.read_launches(prof)
    read_s = time.perf_counter() - read
    return dict(params=params, state=state, t=t, rounds=rounds,
                window_s=window_s, start_ns=start, end_ns=end,
                launches=launches, harness=rec.spans, program=list(program),
                read_s=read_s)


def report(w: dict) -> dict:
    """Every number of a window's trace (see the module doc)."""
    from bench import spans as spans_mod
    from bench import trace as trace_mod

    launches, rounds = w["launches"], w["rounds"]
    trace = trace_mod.Trace([r[:3] for r in launches.kernels],
                            [r[:3] for r in launches.copies], w["harness"],
                            w["start_ns"], w["end_ns"])
    out = {"rounds": rounds, "window_s": w["window_s"],
           "round_ms": w["window_s"] / rounds * 1e3, "read_s": w["read_s"],
           "kernels": len(launches.kernels), "copies": len(launches.copies),
           "busy_s": trace.busy_s(), "program_spans": len(w["program"]),
           "unlaunched": sum(r[3] is None for r in launches.all())}
    got = spans_mod.attribute(launches, w["harness"], w["program"])
    if got is None:
        out["by_span"] = None
        return out
    by, timeline = got
    out.update(
        local_training_ms=spans_mod.local_training_ms(by, rounds),
        server_ms=spans_mod.server_ms(by, rounds),
        host_enqueue_ms=spans_mod.host_enqueue_ms(by, rounds),
        attention_bwd_ms=spans_mod.attention_bwd_ms(by, rounds),
        evaluation_ms=spans_mod.evaluation_ms(by, rounds),
        busy_ms=trace.busy_s() / rounds * 1e3,
        unclaimed_share=spans_mod.unclaimed_share(by, timeline),
        idle_gaps=spans_mod.idle_gaps(trace.busy_intervals(), launches,
                                      timeline, w["start_ns"], w["end_ns"]),
        idle_by_span=spans_mod.idle_by_span(trace.busy_intervals(),
                                            timeline, w["start_ns"],
                                            w["end_ns"]),
        by_span=by, table=spans_mod.table(by, rounds))
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tools/span_table.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("span_table: needs a CUDA card", file=sys.stderr)
        return 3
    out = report(window(*warm(args.workload, args.seed), args.seconds))
    out.update(workload=args.workload, seed=args.seed, card=card(),
               torch=torch.__version__)
    print(f"{args.workload} on {out['card']} (torch {out['torch']}): "
          f"{out['rounds']} rounds in {out['window_s']:.3f} s, "
          f"{out['round_ms']:.2f} ms a round; {out['kernels']} kernels, "
          f"{out['copies']} copies ({out['unlaunched']} without a launch "
          f"record), read in {out['read_s']:.1f} s; "
          f"{out['program_spans']} program spans")
    if out["by_span"] is None:
        print("no program spans or no launch times in the trace")
    else:
        print(out["table"])
        for key in ("local_training_ms", "server_ms", "host_enqueue_ms",
                    "attention_bwd_ms", "evaluation_ms", "busy_ms",
                    "unclaimed_share"):
            print(f"{key}: {out[key]!r}")
        for name, s in out["idle_gaps"]:
            print(f"gap {s * 1e3:9.3f} ms  {name}")
        for path, s in sorted(out["idle_by_span"].items(),
                              key=lambda kv: -kv[1]):
            print(f"idle {s / out['rounds'] * 1e3:9.3f} ms a round  {path}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({k: v for k, v in out.items() if k != "table"}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    # the checkout's root (for ``bench``) and ``src`` (for the program), in
    # place of this script's own directory
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main(sys.argv[1:]))
