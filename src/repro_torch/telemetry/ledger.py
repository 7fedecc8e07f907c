"""Schema-versioned JSONL event ledger for FL training runs, port of
``repro.telemetry.ledger``: the same schema, record kinds and key sets, so
a ledger written by either package reads the same in both (and renders
the same in either's monitor).

One line an event, three kinds:

- ``run``   — a run-segment header: schema version, free-form ``run_id``,
  algorithm/driver/config metadata, the layer-unit names (so consumers can
  label per-layer vectors without rebuilding the model), and the absolute
  ``start_round``. Written once a driver call.
- ``round`` — one record a training round: absolute round index, loss,
  the round's communication profile (uplink/downlink bytes), cumulative
  uplink, the telemetry taps (per-layer divergence vectors, selection
  counts, strategy-state summaries), the optional full per-client
  selection mask, and host-side samples (wall-clock seconds, peak device
  memory).
- ``eval``  — one record an evaluation: round, test error, cumulative
  uplink bytes at that point.

The file is opened in **append** mode and flushed once an event, so a
crashed run keeps everything written so far and a run resumed with
``start_round``/``server_state`` (see :mod:`repro_torch.checkpoint`)
continues the same file with contiguous round indices. Several runs may
share one file; consumers group records by the preceding ``run`` header
with :func:`split_runs`.

Values may be torch tensors on any device and of any dtype (bf16 is
widened to f32 first, since numpy has no bf16), numpy arrays or plain
Python types. Integer tensors stay integers, as the reference's arrays do.
A CUDA tensor is copied to the host here, so the drivers hand the ledger
tensors they have already pulled.

Readers (:func:`read_ledger`, :func:`split_runs`) use the standard library
only. Schema changes bump :data:`LEDGER_SCHEMA`; readers skip records of a
newer schema with a warning instead of failing.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

LEDGER_SCHEMA = 1


def _numpy(v: Any) -> np.ndarray:
    """A tensor (any device; bf16 widened to f32) or array-like as numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _jsonable(v: Any) -> Any:
    """Tensors / numpy scalars and arrays -> plain JSON types."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    arr = _numpy(v)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist()


class RoundLedger:
    """Incremental JSONL writer (append mode, one flush an event)."""

    def __init__(self, path: str, meta: Optional[dict] = None):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        if meta is not None:
            self._write({"kind": "run", "time_unix": time.time(),
                         **_jsonable(meta)})

    # ------------------------------------------------------------------
    def _write(self, record: dict) -> None:
        record = {"schema": LEDGER_SCHEMA, **record}
        self._f.write(json.dumps(record, allow_nan=True) + "\n")
        self._f.flush()

    def round(self, t: int, loss, comm: dict, uplink_cum_bytes,
              taps: Optional[dict] = None, selection=None,
              wall_s=None, mem_peak_bytes=None) -> None:
        """One training-round record. The key set is the same for both
        drivers and both packages."""
        rec = {"kind": "round", "round": int(t),
               "loss": float(_numpy(loss)),
               "comm": _jsonable(comm),
               "uplink_cum_bytes": float(_numpy(uplink_cum_bytes)),
               "taps": _jsonable(taps) if taps is not None else None,
               "wall_s": (float(wall_s) if wall_s is not None else None),
               "mem_peak_bytes": (int(mem_peak_bytes)
                                  if mem_peak_bytes is not None else None)}
        if selection is not None:
            rec["selection"] = _numpy(selection).astype(int).tolist()
        self._write(rec)

    def eval(self, t: int, test_error, uplink_cum_bytes) -> None:
        self._write({"kind": "eval", "round": int(t),
                     "test_error": float(_numpy(test_error)),
                     "uplink_cum_bytes": float(_numpy(uplink_cum_bytes))})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------------
# Readers (standard library only)
# ----------------------------------------------------------------------
def read_ledger(path: str) -> list[dict]:
    """Parse a JSONL ledger into a record list, skipping blank/corrupt
    lines (a crashed writer may leave a torn final line) and records from
    a newer schema (with one warning each)."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                print(f"ledger: skipping corrupt line {i + 1} of {path}",
                      file=sys.stderr)
                continue
            if rec.get("schema", 0) > LEDGER_SCHEMA:
                print(f"ledger: skipping line {i + 1} of {path} "
                      f"(schema {rec.get('schema')} > {LEDGER_SCHEMA}; "
                      "upgrade the reader)", file=sys.stderr)
                continue
            records.append(rec)
    return records


def split_runs(records: list[dict]) -> list[dict]:
    """Group a record list into run segments: each ``run`` header starts a
    segment that collects the following ``round``/``eval`` records.
    Headerless records (hand-rolled files) land in a segment with
    ``meta=None``."""
    runs: list[dict] = []

    def _fresh(meta):
        return {"meta": meta, "rounds": [], "evals": []}

    cur = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "run":
            cur = _fresh(rec)
            runs.append(cur)
        elif kind in ("round", "eval"):
            if cur is None:
                cur = _fresh(None)
                runs.append(cur)
            cur["rounds" if kind == "round" else "evals"].append(rec)
    return runs
