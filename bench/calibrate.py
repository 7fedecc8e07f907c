"""The readings the check's limits are set from, for one cell, in one
process (no timed window: the check reads only the first rounds):

- ``sound``: the program against the reference, one line a seed;
- ``control``: the reference in TF32 (:mod:`bench.reference.plain`) put in
  the program's place, against the reference in f32;
- ``half_batch``: the reference training each client on half its batch (the
  mean over the rest) in the program's place, against the reference.

(A round that returns its model unchanged reads 1 in ``update_gap`` by
construction and needs no run.)

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--out readings-<cell>.jsonl]
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import check, spec, tasks  # noqa: E402


def _free(device):
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(cell: str, seeds: list[int], control_seeds: list[int],
             device="cuda", cfg=None, traffic=None):
    """Yield one dict a reading (see the module doc)."""
    import torch

    from bench.reference import plain
    from repro_torch.federated.server import run_training_scan

    bench = spec.load_benchmark()
    entry = spec.cell(bench, cell)
    cfg = cfg or spec.config(bench, entry)
    traffic = traffic or spec.traffic(entry["traffic"])
    device = torch.device(device)
    plain.full_f32()
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    for seed in seeds:
        start = time.perf_counter()
        task = tasks.make(cfg, traffic, seed, device)

        def run_scan(params, rounds, t0, state, task=task):
            return run_training_scan(
                params, task.loss_fn, task.shards, task.flcfg,
                rounds=rounds, start_round=t0, server_state=state,
                device=device, draws=task.draws)

        prog, params, state, _ = check.observe_program(task, run_scan)
        del params, state
        _free(device)
        yield {"kind": "sound", "seed": seed, "losses": prog.losses,
               **check.numbers(task, prog),
               "seconds": time.perf_counter() - start}
        del task, prog
        _free(device)
    for seed in control_seeds:
        task = tasks.make(cfg, traffic, seed, device)
        for kind, kw in (("control", {"prec": "tf32"}),
                         ("half_batch", {"half_batch": True})):
            start = time.perf_counter()
            other = check.observe_reference(task, **kw)
            _free(device)
            yield {"kind": kind, "seed": seed, "losses": other.losses,
                   **check.numbers(task, other),
                   "seconds": time.perf_counter() - start}
            del other
            _free(device)
        del task
        _free(device)


def main(argv):
    ap = argparse.ArgumentParser(prog="bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = open(args.out, "a") if args.out else None
    try:
        for row in readings(args.workload, ints(args.seeds),
                            ints(args.control_seeds)):
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
