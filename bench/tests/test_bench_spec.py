"""BENCHMARK.json and the files under bench/ it names: every name found,
every name and unit within the contract's characters and lengths."""
import json
import math
import re

import pytest

from bench import spec, yardstick

BENCH = spec.load_benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_found_and_sound():
    assert spec.check_names(BENCH) == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, entry)
    traffic = spec.traffic(entry["traffic"])
    limits = spec.limits(cell)
    assert cfg["name"] == entry["config"]
    assert traffic["task"] == cfg["kind"]
    assert entry["chips"] == 1
    assert limits and all(v >= 0 for v in limits.values())
    ref = spec.reference(entry["config"])
    assert callable(ref.loss) and callable(ref.param_spec)
    reported = spec.metrics_of(BENCH, cell, "end_to_end")
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert spec.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_found(metric):
    assert callable(spec.metric_reader(metric).read)


@pytest.mark.parametrize("group", ["fl_kernels", "attention"])
def test_kernel_groups_compile(group):
    groups = spec.kernel_group(group)
    assert groups and all(isinstance(p, re.Pattern)
                          for ps in groups.values() for p in ps)


def test_names_units_and_text_within_limits():
    for entry in BENCH["configs"] + BENCH["workloads"] + \
            BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.NAME.match(entry["name"]), entry["name"]
    for entry in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    texts = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
        [c["source"] for c in BENCH["configs"]] + \
        [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            spec.cell(BENCH, cell)


def test_run_seconds_fits_a_full_check_of_24_cells():
    """2 + 14 runs a cell of run_seconds + 60 s, 2 × 90 s a cell to
    compile and 1,200 s spare fit in 43,200 s with 24 cells."""
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_hold_what_is_run(config):
    entry = spec.config_entry(BENCH, config)
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert entry["file"].startswith("bench/")
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert yardstick.param_count(cfg) == cfg["param_count"]
    ref = spec.reference(config)
    assert sum(math.prod(shape) for _, shape, _ in
               ref.param_spec(cfg["model"])) == cfg["param_count"]
    assert yardstick.num_units(cfg) == cfg["units"]


def _with_config(**changes):
    """BENCHMARK.json with its first config entry changed."""
    bench = json.loads(json.dumps(BENCH))
    bench["configs"][0].update(changes)
    return bench


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_counts_found_by_name(config):
    counts = spec.counts(config)
    cfg = spec.load_json(spec.ROOT / spec.config_entry(BENCH, config)["file"])
    assert counts.param_count(cfg["model"]) == cfg["param_count"]
    assert counts.num_units(cfg["model"]) == cfg["units"]
    assert callable(counts.forward_flops)


def test_a_config_without_counts_is_a_fault():
    faults = spec.check_names(_with_config(name="no-such-model"))
    assert "config no-such-model has no counts" in faults


@pytest.mark.parametrize("key", ["param_count", "units"])
def test_declared_counts_that_differ_are_a_fault(tmp_path, key):
    entry = BENCH["configs"][0]
    cfg = spec.load_json(spec.ROOT / entry["file"])
    cfg[key] += 1
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    # an absolute ``file`` is read where it lies
    faults = spec.check_names(_with_config(file=str(path)))
    assert len(faults) == 1 and f"declares {key} {cfg[key]}" in faults[0]
    path.write_text(json.dumps({**cfg, key: cfg[key] - 1}))
    assert spec.check_names(_with_config(file=str(path))) == []
