"""The benchmark's declarations: ``BENCHMARK.json`` at the root of the
checkout and the files under ``bench/`` that it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the harness finds everything else by those names:

- ``bench/configs/<config>.json`` (the path is the config entry's ``file``):
  the model as it is run;
- ``bench/reference/<config>.py``: its plain reference;
- ``bench/counts/<config>.py``: its parameters, layer units and FLOPs,
  counted from its shapes (:mod:`bench.yardstick` reads them);
- ``bench/traffic/<traffic>.json``: the traffic mix (data sizes, the FL
  setup, the evaluation cadence, the rounds the check follows);
- ``bench/limits/<cell>.json``: the limit of each number the check compares;
- ``bench/metrics/<metric>.py``: a per-layer metric's reader;
- ``bench/kernel_groups/<group>.json``: kernel name patterns of a layer.

Nothing here imports torch or the program.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """A name that BENCHMARK.json or a file under bench/ does not hold."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config_entry(bench: dict, name: str) -> dict:
    return _by_name(bench["configs"], name, "config")


def config(bench: dict, cell_entry: dict, root: Path = ROOT) -> dict:
    return load_json(root / config_entry(bench, cell_entry["config"])["file"])


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell_name}.json")


def kernel_group(name: str) -> dict[str, list[re.Pattern]]:
    """``bench/kernel_groups/<name>.json``: a layer's kernels, as groups of
    name patterns (searched in the names the profiler gives)."""
    groups = load_json(BENCH / "kernel_groups" / f"{name}.json")["groups"]
    return {g: [re.compile(p) for p in ps] for g, ps in groups.items()}


def reports(metric: dict, cell_name: str) -> bool:
    """Whether a cell reports ``metric``: every cell, or those its
    ``workloads`` key lists."""
    return cell_name in metric.get("workloads", [cell_name])


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics."""
    return [m for m in bench[kind] if reports(m, cell_name)]


def _load_module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module_label(prefix: str, name: str) -> str:
    return f"bench_{prefix}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)


def metric_reader(name: str):
    """``bench/metrics/<name>.py``: a module with ``read(trace, run)``."""
    return _load_module(BENCH / "metrics" / f"{name}.py",
                        _module_label("metric", name))


def reference(config_name: str):
    """``bench/reference/<config>.py``: the configuration's plain
    reference."""
    return _load_module(BENCH / "reference" / f"{config_name}.py",
                        _module_label("reference", config_name))


def counts(config_name: str):
    """``bench/counts/<config>.py``: a module with ``param_count(model)``,
    ``num_units(model)``, ``forward_flops(model, data)`` (one sample's
    forward) and, for a model with attention, ``attention_flops(model,
    seq)`` (one sequence's causal products)."""
    return _load_module(BENCH / "counts" / f"{config_name}.py",
                        _module_label("counts", config_name))


def _declared_counts(entry: dict, cfg: dict) -> list[str]:
    """Where the config file's declared ``param_count`` or ``units``
    differs from what its counts module gives."""
    got = counts(entry["name"])
    faults = []
    for key, count in (("param_count", got.param_count),
                       ("units", got.num_units)):
        counted = count(cfg["model"])
        if cfg.get(key) != counted:
            faults.append(f"config file {entry['file']} declares {key} "
                          f"{cfg.get(key)!r}; its counts give {counted!r}")
    return faults


def check_names(bench: dict) -> list[str]:
    """Every name, unit and file rule of BENCHMARK.json that a file under
    bench/ can break, and each config file's declared ``param_count`` and
    ``units`` against its counts; returns the faults found (none when
    sound)."""
    faults = []

    def name_ok(value, what):
        if not isinstance(value, str) or not NAME.match(value):
            faults.append(f"{what} {value!r} is not a valid name")

    for c in bench["configs"]:
        name_ok(c["name"], "config")
        for key in c["reduced"]:
            name_ok(key, f"reduced key of {c['name']}")
        file = ROOT / c["file"]
        if not file.is_file():
            faults.append(f"config file {c['file']} is missing")
        if not (BENCH / "reference" / f"{c['name']}.py").is_file():
            faults.append(f"config {c['name']} has no reference")
        if not (BENCH / "counts" / f"{c['name']}.py").is_file():
            faults.append(f"config {c['name']} has no counts")
        elif file.is_file():
            faults += _declared_counts(c, load_json(file))
    for w in bench["workloads"]:
        name_ok(w["name"], "workload")
        name_ok(w["traffic"], "traffic")
        if not (BENCH / "traffic" / f"{w['traffic']}.json").is_file():
            faults.append(f"traffic {w['traffic']} has no file")
        if not (BENCH / "limits" / f"{w['name']}.json").is_file():
            faults.append(f"workload {w['name']} has no limits file")
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            name_ok(m["name"], kind)
            if not UNIT.match(m["unit"]):
                faults.append(f"unit {m['unit']!r} of {m['name']}")
            if m["better"] not in ("lower", "higher"):
                faults.append(f"better of {m['name']}")
    for m in bench["per_layer"]:
        if not (BENCH / "metrics" / f"{m['name']}.py").is_file():
            faults.append(f"per-layer metric {m['name']} has no reader")
    return faults
