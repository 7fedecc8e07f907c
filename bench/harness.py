"""One run of one cell: set-up, the timed window, the check, the result.

1. Set-up (``setup_s``, from the process's start): the program's kernels
   from its compile cache (``build/repro_torch_kernels`` in the checkout;
   built on a checkout's first run), the weights on the device from the
   seed, the data, and the check's first rounds through the window's own
   call (:func:`bench.check.observe_program`); then one block of
   ``eval_every`` rounds and its evaluation, as the window runs them, so
   that every shape the window uses is warm and the caching allocator has
   made its first retry (hymba's first block of a process frees the
   cache's ~1,700 segments once, a stall of 0.6-1.9 s) before the clock
   starts. The check's own copies are not counted.
2. The window: ``run_training_scan`` in blocks of ``eval_every`` rounds,
   each block resumed with ``start_round`` and ``server_state`` and followed
   by the evaluation a user's run makes there, until ``--seconds`` have
   passed; every block ends in the engine's one pull and the evaluation's
   read-back. ``round_ms`` is the window's wall time over its rounds.
   With ``--trace 1`` the window runs under the profiler (the card's
   activity only) with the program's spans recorded, and the per-layer
   metrics are read from its trace and spans.
3. The check: the program's state is freed, then the reference follows the
   check's rounds, step by step from the program's own state, and the
   numbers are held to the cell's limits (:mod:`bench.check`).
4. The result: one JSON line on standard output, the compared numbers with
   their limits as the last lines of standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time

from bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RunInfo:
    """What a per-layer reader may read besides the trace."""
    cfg: dict
    traffic: dict
    rounds: int          # rounds in the traced window
    window_s: float      # the traced window's wall time


def forbidden_modules() -> list[str]:
    """The JAX modules (or the JAX package) this process has loaded,
    compared by whole top-level names (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, entry: dict, seed: int, seconds: float,
             traced: bool, device, started: float, *, cfg=None,
             traffic=None, limits=None, scan=None) -> dict:
    """One run; ``cfg``, ``traffic``, ``limits`` default to the cell's files.
    ``scan`` replaces ``run_training_scan`` (the check's own tests break the
    timed path through it)."""
    import torch

    from bench import check, spans, tasks
    from bench import trace as trace_mod
    from bench.reference import plain
    from repro_torch.federated.server import run_training_scan

    cfg = cfg or spec.config(bench, entry)
    traffic = traffic or spec.traffic(entry["traffic"])
    limits = limits or spec.limits(entry["name"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    plain.full_f32()
    if cuda:
        from repro_torch.kernels import _build
        _build.build()
    task = tasks.make(cfg, traffic, seed, device)
    scan = scan or run_training_scan

    def run_scan(params, rounds, start, state):
        return scan(params, task.loss_fn, task.shards, task.flcfg,
                    rounds=rounds, start_round=start, server_state=state,
                    device=device, draws=task.draws)

    observed, params, state, t = check.observe_program(task, run_scan)
    every = traffic["eval_every"]
    params, log = run_scan(params, every, t, state)
    state, t = log.final_state, t + every
    task.eval_fn(params)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    setup_s = time.perf_counter() - started - observed.check_s

    rec, traces = trace_mod.Recorder(), []
    losses, evals, rounds, blocks = [], [], 0, []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with trace_mod.device_trace(traced and cuda, rec, traces):
        t0 = time.perf_counter()
        while True:
            with rec.span("run_training_scan"):
                params, log = run_scan(params, every, t, state)
            state = log.final_state
            with rec.span("evaluation"):
                evals.append(task.eval_fn(params))
            losses += log.losses
            t += every
            rounds += every
            blocks.append(time.perf_counter() - t0)
            if blocks[-1] >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del params, state, log
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    check_start = time.perf_counter()
    correct, table = check.judge(check.numbers(task, observed), limits)
    print(f"bench: set-up {setup_s:.3f} s (the check's copies, "
          f"{observed.check_s:.3f} s, not counted), window {window_s:.3f} s "
          f"of {rounds} rounds, reference {time.perf_counter() - check_start:.3f}"
          f" s; losses {[round(x, 4) for x in observed.losses]} then "
          f"{[round(x, 4) for x in losses]}; evaluations "
          f"{[round(x, 4) for x in evals]}; blocks end at "
          f"{[round(x, 3) for x in blocks]} s", file=sys.stderr)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": rounds,
              "failed": sum(not math.isfinite(x) for x in losses)}
    if traced and traces:
        tr = traces[0]
        attributed = time.perf_counter()
        unclaimed = (spans.unclaimed_share(*tr.attribution)
                     if tr.attribution else None)
        print(f"bench: traced {len(tr.kernels)} kernels, {len(tr.copies)} "
              f"copies and {len(tr.program)} program spans "
              f"({len(tr.program) / rounds:.1f} a round) in "
              f"{tr.window_s:.3f} s, read in {tr.read_s:.3f} s, given to "
              f"the spans in {time.perf_counter() - attributed:.3f} s; "
              f"unclaimed share {unclaimed!r}", file=sys.stderr)
        info = RunInfo(cfg, traffic, rounds, tr.window_s)
        metrics = {}
        for m in spec.metrics_of(bench, entry["name"], "per_layer"):
            value = spec.metric_reader(m["name"]).read(tr, info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result.update(metrics=metrics, device=dev,
                      breakdown={"device_ops": tr.top_kernels(10),
                                 "idle_gaps": tr.idle_gaps(10)})
    else:
        values = {"round_ms": window_s / rounds * 1e3,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        result.update(metrics={
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.metrics_of(bench, entry["name"], "end_to_end")},
            device=dev)
    result["checks"] = table
    return result


def main(argv: list[str], started: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    entry = spec.cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"bench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(bench, entry, args.seed, args.seconds,
                      bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"bench: the process loaded {found}, which the benchmark of "
              "the port must not", file=sys.stderr)
        return 4
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
