"""Telemetry ledger monitor: render FL round ledgers in the terminal, port
of ``repro.launch.monitor`` (the same text, byte for byte, on the same
ledger file).

    PYTHONPATH=src python -m repro_torch.launch.monitor runs/ledger.jsonl
    PYTHONPATH=src python -m repro_torch.launch.monitor ledger.jsonl --run 2
    PYTHONPATH=src python -m repro_torch.launch.monitor ledger.jsonl --bins 40

Reads the JSONL event ledger written by ``run_training`` /
``run_training_scan`` under ``FLConfig(telemetry=TelemetryConfig(
ledger_path=...))`` of either package (see
:mod:`repro_torch.telemetry.ledger`) and renders, per run segment:

- the run header (algo, driver, rounds, mesh, seed);
- a **per-layer divergence heat table** — one row per layer unit, the
  tapped ``div_mean`` trajectory binned over rounds and drawn as a
  sparkline, plus min/max of the layer's mean divergence (which layers
  FedLDF's Eq. 4 feedback considers hot, and when);
- a **per-layer selection heat table** — ``sel_count`` (how many of the
  K participants uploaded each layer, per round, binned the same way)
  with each layer's aggregate upload share;
- strategy-state trajectories for any tapped ``state_*`` vectors
  (FedLAMA's interval/ttl, EF residual norms, ...);
- a **bytes-per-round summary**: uplink payload/feedback/total and
  savings vs FedAvg, from the per-round comm profiles — plus, for a
  reference ledger of a mesh run, the aggregation-tier traffic split —
  plus loss start→end, wall-clock and peak-memory stats when sampled, and
  eval points.

Reads the ledger on the host only; it needs no card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.telemetry import read_ledger, split_runs

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, lo=None, hi=None) -> str:
    """Unicode sparkline of a 1-D series (empty-safe, NaN-safe)."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return ""
    finite = np.isfinite(v)
    if not finite.any():
        return " " * v.size
    lo = np.nanmin(v[finite]) if lo is None else lo
    hi = np.nanmax(v[finite]) if hi is None else hi
    span = (hi - lo) or 1.0
    out = []
    for x in v:
        if not np.isfinite(x):
            out.append(" ")
            continue
        idx = int((x - lo) / span * (len(_SPARK) - 1) + 0.5)
        out.append(_SPARK[max(0, min(len(_SPARK) - 1, idx))])
    return "".join(out)


def bin_series(values, bins: int):
    """Mean-pool a 1-D series into at most ``bins`` buckets (for heat
    tables over long runs); shorter series pass through unchanged."""
    v = np.asarray(values, dtype=np.float64)
    if v.size <= bins:
        return v
    edges = np.linspace(0, v.size, bins + 1).astype(int)
    return np.array([v[a:b].mean() if b > a else np.nan
                     for a, b in zip(edges[:-1], edges[1:])])


def _tap_matrix(rounds_rec, name):
    """Stack tap ``name`` over rounds -> (T, ...) array, or None if the
    tap is absent (taps disabled, or strategy without it)."""
    rows = [r.get("taps") or {} for r in rounds_rec]
    if not rows or name not in rows[0]:
        return None
    return np.asarray([row[name] for row in rows])


def _unit_names(meta, width):
    units = (meta or {}).get("units")
    if not units or len(units) != width:
        units = [f"unit{i}" for i in range(width)]
    return [str(u) for u in units]


def _heat_table(mat, units, bins, value_fmt, out, right_label):
    """One row per layer unit: sparkline of its (T,) series + extremes."""
    w = max(len(u) for u in units)
    for u, series in zip(units, mat.T):
        binned = bin_series(series, bins)
        print(f"    {u:<{w}}  {sparkline(binned)}  "
              f"min {value_fmt.format(np.nanmin(series))}  "
              f"max {value_fmt.format(np.nanmax(series))}"
              f"{right_label(series)}", file=out)


def render_run(seg, out=sys.stdout, bins: int = 60) -> None:
    """Render one run segment (a ``split_runs`` entry)."""
    meta, rounds_rec, evals = seg["meta"], seg["rounds"], seg["evals"]
    if meta:
        mesh = meta.get("mesh")
        mesh_s = ("x".join(str(v) for v in mesh.values())
                  if mesh else "single-device")
        agg = meta.get("agg")
        if agg and agg.get("tiers", 1) > 1:
            mesh_s += (f" (2-tier agg: {agg['num_groups']} groups of "
                       f"{agg['group_size']})")
        if meta.get("shard_samples"):
            mesh_s += " sample-sharded"
        print(f"== run {meta.get('run_id') or meta.get('algo', '?')} — "
              f"algo={meta.get('algo', '?')} driver={meta.get('driver', '?')}"
              f" mode={meta.get('mode', '?')} mesh={mesh_s} "
              f"seed={meta.get('seed', '?')} "
              f"K={meta.get('clients_per_round', '?')}/"
              f"N={meta.get('num_clients', '?')} "
              f"n={meta.get('top_n', '?')}", file=out)
    else:
        print("== run (no header)", file=out)
    if not rounds_rec:
        print("    (no round records)", file=out)
        return
    t0, t1 = rounds_rec[0]["round"], rounds_rec[-1]["round"]
    print(f"   rounds {t0}..{t1} ({len(rounds_rec)} records)", file=out)

    # ---- per-layer divergence heat table (Eq. 3/4 inputs) ----
    div = _tap_matrix(rounds_rec, "div_mean")
    if div is not None:
        units = _unit_names(meta, div.shape[1])
        print("   per-layer mean divergence (rows=layers, cols=rounds):",
              file=out)
        _heat_table(div, units, bins, "{:9.3e}", out, lambda s: "")

    # ---- per-layer selection heat table ----
    sel = _tap_matrix(rounds_rec, "sel_count")
    if sel is not None:
        units = _unit_names(meta, sel.shape[1])
        total = sel.sum()
        print("   per-layer uploads (sel_count; share = fraction of all "
              "layer-uploads):", file=out)
        _heat_table(sel, units, bins, "{:5.1f}", out,
                    lambda s: f"  share {s.sum() / max(total, 1): .3f}")

    # ---- strategy-state trajectories (FedLAMA intervals, EF norms, ...)
    first_taps = rounds_rec[0].get("taps") or {}
    for name in sorted(first_taps):
        if not name.startswith("state_"):
            continue
        mat = _tap_matrix(rounds_rec, name)
        if mat is None:
            continue
        if mat.ndim == 1:
            print(f"   {name}: {sparkline(bin_series(mat, bins))}  "
                  f"start {mat[0]:.3e} end {mat[-1]:.3e}", file=out)
        else:
            units = _unit_names(meta, mat.shape[1])
            print(f"   {name} per layer:", file=out)
            _heat_table(mat, units, bins, "{:8.2f}", out, lambda s: "")

    # ---- bytes-per-round + loss/system summary ----
    comm = [r["comm"] for r in rounds_rec]
    up_total = np.array([c["uplink_total"] for c in comm])
    up_pay = np.array([c.get("uplink_payload", np.nan) for c in comm])
    up_fb = np.array([c.get("uplink_feedback", np.nan) for c in comm])
    base = np.array([c["fedavg_uplink"] for c in comm])
    print(f"   bytes/round: uplink {up_total.mean() / 1e6:.3f}MB avg "
          f"(payload {np.nanmean(up_pay) / 1e6:.3f} + feedback "
          f"{np.nanmean(up_fb) / 1e6:.3f}), "
          f"cumulative {rounds_rec[-1]['uplink_cum_bytes'] / 1e6:.1f}MB, "
          f"savings vs fedavg {1 - up_total.sum() / base.sum():.3f}",
          file=out)
    print(f"   uplink/round: {sparkline(bin_series(up_total, bins))}",
          file=out)
    # aggregation-tier traffic split (mesh rounds; static per config)
    if comm and "agg_cross_bytes" in comm[-1]:
        c = comm[-1]
        tiers = int(c.get("agg_tiers", 1))
        print(f"   agg traffic/round ({tiers}-tier reduce): intra-group "
              f"{c.get('agg_intra_bytes', 0.0) / 1e6:.3f}MB, cross-group "
              f"{c['agg_cross_bytes'] / 1e6:.3f}MB, busiest host "
              f"{c.get('agg_cross_bytes_per_host', 0.0) / 1e6:.3f}MB",
              file=out)
    loss = np.array([r["loss"] for r in rounds_rec])
    print(f"   loss: {sparkline(bin_series(loss, bins))}  "
          f"{loss[0]:.4f} -> {loss[-1]:.4f}", file=out)
    wall = np.array([r["wall_s"] or np.nan for r in rounds_rec],
                    dtype=np.float64)
    if np.isfinite(wall).any():
        print(f"   wall/round: median {np.nanmedian(wall) * 1e3:.1f}ms "
              f"(p90 {np.nanpercentile(wall, 90) * 1e3:.1f}ms)", file=out)
    mem = [r.get("mem_peak_bytes") for r in rounds_rec]
    mem = [m for m in mem if m]
    if mem:
        print(f"   peak device memory: {max(mem) / 1e6:.1f}MB", file=out)
    for ev in evals:
        print(f"   eval @ round {ev['round']:4d}: test_err "
              f"{ev['test_error']:.4f} "
              f"(uplink {ev['uplink_cum_bytes'] / 1e6:.1f}MB)", file=out)


def render(path: str, out=sys.stdout, bins: int = 60,
           run: int | None = None) -> int:
    """Render every run segment in a ledger file (or just segment ``run``,
    0-based). Returns the number of segments rendered."""
    segs = split_runs(read_ledger(path))
    if not segs:
        print(f"{path}: no ledger records", file=out)
        return 0
    if run is not None:
        segs = [segs[run]]
    for seg in segs:
        render_run(seg, out=out, bins=bins)
    return len(segs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="render an FL telemetry JSONL ledger "
                    "(repro_torch.telemetry) as terminal heat tables")
    ap.add_argument("ledger", help="path to a telemetry JSONL ledger")
    ap.add_argument("--run", type=int, default=None,
                    help="render only this run segment (0-based; "
                         "default: all segments in the file)")
    ap.add_argument("--bins", type=int, default=60,
                    help="max sparkline width in round-buckets")
    args = ap.parse_args(argv)
    render(args.ledger, bins=args.bins, run=args.run)


if __name__ == "__main__":
    main()
