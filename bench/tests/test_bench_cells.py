"""A cell defined only by files in a temporary checkout is found by name,
served through the port on the CPU at a small size, and judged correct
against the plain reference; the control (the reference in float8) fails
the same comparison."""
import time

import pytest

from bench import harness

from . import cells

SMALL_LIMIT = cells.SMALL_CORRECT["max_mean_logit_gap"]


@pytest.mark.parametrize("name", sorted(cells.CELLS))
def test_cell_from_files_is_correct(tmp_path, name):
    out = cells.run(tmp_path, name, seed=123456789012)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    m = out["metrics"]
    assert {"out_tok_s", "tpot_p95_ms", "setup_s"} <= set(m)
    assert all(v["value"] > 0 for v in m.values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", sorted(cells.CELLS))
def test_control_fails_where_the_program_passes(tmp_path, name):
    cell = harness.find_cell(name, cells.write(tmp_path, name))
    with cells.virtual_clock():
        run, *_ = harness.serve(cell, 7, 2.0, False, "cpu",
                                time.perf_counter())
    judged, error = harness.judge(cell, 7, run, "cpu", control=True)
    assert error is None
    assert judged.tokens >= 20
    assert (judged.stat("mean") <= SMALL_LIMIT
            < judged.stat("mean", control=True))
    # the control in the program's place, through the run's own comparison
    assert harness.is_correct(harness.checks(cell, judged, error))
    assert not harness.is_correct(harness.checks(cell, judged.as_control(),
                                                 error))


def test_traced_run_reports_per_layer_metrics(tmp_path):
    out = cells.run(tmp_path, "granite8b.small", trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert {"queue_wait_ms", "decode_step_ms", "mfu.serve"} <= set(m)
    assert "k1_roofline" not in m          # no device time on the CPU
    assert m["queue_wait_ms"]["value"] > 0   # more clients than slots
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    assert out["breakdown"]["idle_gaps"]


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    """A small cell on the card: the device path runs, its roofline share
    and busy time read."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.find_cell("granite8b.small",
                             cells.write(tmp_path, "granite8b.small"))
    out = harness.run_cell(cell, 9, 2.0, True, "cuda", time.perf_counter(),
                           torch.cuda.synchronize)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["k1_roofline"]["value"] <= 105
