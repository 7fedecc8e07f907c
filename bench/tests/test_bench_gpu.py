"""On the card: a short run of each cell through the command, the window,
the trace and the check."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from small_cells import cells

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cells())
def test_cell_runs_and_is_correct(card, name, trace):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cells()[0], "--seed",
         "1", "--seconds", "1"], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
