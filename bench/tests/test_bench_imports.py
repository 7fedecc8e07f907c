"""The import guard: every module of the benchmark, imported in a fresh
process, loads neither JAX nor the JAX package ``repro`` (compared by whole
top-level names: ``repro_torch`` is the port), the references load
nothing of the port either, and a configuration's counts load nothing at
all."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

MODULES = sorted(
    "bench." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
    for p in BENCH.rglob("*.py")
    if "tests" not in p.parts and "-" not in p.stem
    and p.parent.name not in ("metrics",) and p.stem != "__init__")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'src'}"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_every_module_is_listed():
    assert "bench.harness" in MODULES and "bench.reference.fl" in MODULES
    assert len(MODULES) >= 10


def test_benchmark_loads_no_jax():
    code = "\n".join(f"import {m}" for m in MODULES) + """
from bench import spec
bench = spec.load_benchmark()
for c in bench["configs"]:
    spec.reference(c["name"])
    spec.counts(c["name"])
for m in bench["per_layer"]:
    spec.metric_reader(m["name"])
"""
    loaded = _loaded(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "repro_torch" in loaded and "torch" in loaded


def test_references_load_nothing_of_the_program():
    refs = [p.stem for p in (BENCH / "reference").glob("*.py")
            if p.stem != "__init__"]
    code = "\n".join(
        ["import importlib.util, sys",
         "import bench.reference.fl, bench.reference.plain"] +
        [f"s = importlib.util.spec_from_file_location('r{i}', "
         f"{str(BENCH / 'reference' / (r + '.py'))!r})\n"
         f"importlib.util.module_from_spec(s).__class__\n"
         f"s.loader.exec_module(importlib.util.module_from_spec(s))"
         for i, r in enumerate(refs)])
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded
    assert "torch" in loaded


def test_counts_load_nothing():
    code = "\n".join(
        ["import importlib.util, sys"] +
        [f"s = importlib.util.spec_from_file_location('c{i}', "
         f"{str(p)!r})\n"
         f"s.loader.exec_module(importlib.util.module_from_spec(s))"
         for i, p in enumerate(sorted((BENCH / "counts").glob("*.py")))])
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"repro_torch", "torch", "bench"})
