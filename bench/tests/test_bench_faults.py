"""A whole run of each cell on the CPU at a small size, the card's check
skipped, with the timed path broken underneath: ``correct`` comes out
false for every fault a training cell can have on one chip (the exchange
between chips has none), and true unbroken."""
import time

import pytest

from bench import harness
from repro_torch.core import selection
from repro_torch.federated import server
from small_cells import cell, cells


def _run(name, scan=None):
    bench, entry, cfg, traffic = cell(name)
    return harness.run_cell(bench, entry, 2**31 + 9, 0.0, False, "cpu",
                            time.perf_counter(), cfg=cfg, traffic=traffic,
                            scan=scan)


def unchanged(params, *args, **kw):
    """A round that returns the model (and the state) it was given."""
    _, log = server.run_training_scan(params, *args, **kw)
    log.final_state = kw.get("server_state")
    return params, log


def half_batch(params, loss_fn, *args, **kw):
    """Each client's loss over the first half of its batch only."""
    def half(p, batch):
        return loss_fn(p, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    return server.run_training_scan(params, half, *args, **kw)


def loss_altered(params, *args, **kw):
    """The round's loss altered where it is produced (by 1 %)."""
    out, log = server.run_training_scan(params, *args, **kw)
    log.losses = [x * 1.01 for x in log.losses]
    return out, log


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "loss_altered": loss_altered}


@pytest.mark.parametrize("name", cells())
def test_unbroken_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"round_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", cells())
def test_broken_run_is_not_correct(name, fault):
    result = _run(name, scan=FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", cells())
def test_wrong_selection_is_not_correct(name, monkeypatch):
    """Eq. 4 taking the n clients of least divergence."""
    real = selection.topn_divergence
    monkeypatch.setattr(selection, "topn_divergence",
                        lambda divs, n: real(-divs, n))
    result = _run(name)
    assert not result["correct"], result["checks"]
