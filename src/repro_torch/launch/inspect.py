"""Dry-run profiler, port of ``repro.launch.inspect``: rank the heaviest
FLOP, collective and memory-traffic ops of a counted (arch × shape)
program (:func:`repro_torch.launch.dryrun.lower_one`), each attributed to
its source frame. The reference reads loop-weighted HLO instructions and
their ``op_name`` metadata; here the rows are
:class:`~repro_torch.launch.opcount.OpRecord` s, one an op as it ran (a
loop's ops once a trip), grouped by (op, frame) and summed, so a row's
``w`` is how many times that op ran there.

    PYTHONPATH=src python -m repro_torch.launch.inspect --arch mamba2-780m \\
        --shape prefill_32k [--variant X] [--top 15]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.opcount import OpTotals


def _grouped(totals: OpTotals, value, keep=lambda r: True) -> dict:
    """{(op, frame): [Σ value, count, one op's value]} over the records."""
    rows: dict = {}
    for r in totals.records:
        if not keep(r):
            continue
        v = value(r)
        row = rows.setdefault((r.op, r.frame), [0.0, 0, v])
        row[0] += v
        row[1] += 1
    return rows


def top_flops(totals: OpTotals, top: int = 15):
    """(FLOPs, times run, FLOPs of one run, source) rows, largest first."""
    rows = _grouped(totals, lambda r: r.flops, lambda r: r.flops > 0)
    out = [(f, n, raw, f"{op} {frame}"[:110])
           for (op, frame), (f, n, raw) in rows.items()]
    out.sort(reverse=True)
    return out[:top]


def top_collectives(totals: OpTotals, top: int = 15):
    """(result bytes, collective, times run, bytes of one run, source)
    rows."""
    rows = _grouped(totals, lambda r: r.collective_bytes,
                    lambda r: r.collective is not None)
    coll = {(r.op, r.frame): r.collective for r in totals.records
            if r.collective is not None}
    out = [(b, coll[key], n, raw, key[1][:110])
           for key, (b, n, raw) in rows.items()]
    out.sort(reverse=True)
    return out[:top]


def top_hbm(totals: OpTotals, top: int = 15):
    """(operand + result bytes, op, times run, source) rows."""
    rows = _grouped(totals, lambda r: r.bytes, lambda r: r.bytes > 0)
    out = [(b, op, n, frame[:110]) for (op, frame), (b, n, _) in rows.items()]
    out.sort(reverse=True)
    return out[:top]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import lower_one
    _, totals = lower_one(args.arch, args.shape, multi_pod=args.multi_pod,
                          variant=args.variant, verbose=True)
    print("\n=== top FLOP contributors (every run, one device) ===")
    for f, w, raw, src in top_flops(totals, args.top):
        print(f"{f/1e12:10.2f}TF  w={w:8.0f} raw={raw/1e9:10.2f}GF  {src}")
    print("\n=== top collectives (bytes/device) ===")
    for b, op, w, raw, src in top_collectives(totals, args.top):
        print(f"{b/1e9:10.2f}GB  {op:20s} w={w:8.0f} raw={raw/1e6:8.1f}MB  "
              f"{src}")
    print("\n=== top HBM consumers (operand+result bytes) ===")
    for b, op, w, src in top_hbm(totals, args.top):
        print(f"{b/1e9:10.2f}GB  {op:20s} w={w:8.0f}  {src}")


if __name__ == "__main__":
    main()
