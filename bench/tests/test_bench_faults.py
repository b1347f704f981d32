"""A run whose timed path is broken underneath comes out not correct: the
chip check skipped, the rest of a run driven on the CPU at a small size,
once for each fault a served cell can have (a step that keeps its state,
half the batch left out, a token altered where it is produced)."""
import pytest

from bench import faults

from . import cells


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", sorted(cells.CELLS))
def test_fault_is_not_correct(tmp_path, name, fault):
    with faults.FAULTS[fault]():
        out = cells.run(tmp_path, name, seed=31)
    assert not out["correct"], out["checks"]
