"""The benchmark's own tests (``python -m pytest -q bench/tests`` from the
root of the checkout): names, arithmetic, the reference against the program
at small sizes on the CPU, the check's control and faults, the import
guard. Tests marked ``gpu`` need a card and skip without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
