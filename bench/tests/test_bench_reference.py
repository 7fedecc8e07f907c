"""The plain reference against the program (``repro_torch``) at small sizes
on the CPU, for the check's rounds of each cell, and the check's control:
the reference in TF32 in the program's place, which the cell's limits must
refuse."""
import pytest

from bench import calibrate, check, spec
from small_cells import cell, cells


def _readings(name, seeds, control_seeds):
    _, _, cfg, traffic = cell(name)
    return list(calibrate.readings(name, seeds, control_seeds, device="cpu",
                                   cfg=cfg, traffic=traffic))


@pytest.mark.parametrize("name", cells())
def test_reference_follows_the_program(name):
    (row,) = _readings(name, [11], [])
    limits = spec.limits(name)
    correct, table = check.judge(row, limits)
    assert correct, table
    assert row["uplink_bytes_gap"] == 0
    for key in ("loss_gap", "update_gap"):
        assert row[key] < 1e-4, (key, row[key])


@pytest.mark.parametrize("name", cells())
def test_control_and_half_batch_fail_the_limits(name):
    rows = _readings(name, [], [12])
    limits = spec.limits(name)
    kinds = {r["kind"]: r for r in rows}
    assert set(kinds) == {"control", "half_batch"}
    for kind, row in kinds.items():
        correct, table = check.judge(row, limits)
        assert not correct, (kind, table)
