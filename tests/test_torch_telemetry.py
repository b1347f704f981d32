"""Port parity for the telemetry layer, mirroring tests/test_telemetry.py:
the metrics registry's units (held to the reference's classes on the same
observations), per-request spans through the engine's lifecycle hooks on
the llama1_7b smoke config (vocab 128, 2 layers, 2 slots, StepClock) —
the event stream equal to the JAX engine's event for event — telemetry
as observation only, preempt/resume and speculation events, the
Chrome/Perfetto export's structure, and ``metrics()``."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as J  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve.telemetry import Timeline as JaxTimeline  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.serve import (Histogram, MetricsRegistry,  # noqa: E402
                               ServingEngine, SpecConfig, StepClock,
                               Telemetry, perfetto_trace,
                               registry_from_stats)
from repro_torch.serve.telemetry import Timeline  # noqa: E402
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 10, 11, 12, 13]]


@pytest.fixture(scope="module")
def fp_model():
    jcfg, tcfg = smoke_cfgs()
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tm


def _engine(fp_model, telemetry=None, **kw):
    _, tcfg, _, tm = fp_model
    for k, v in dict(n_slots=2, max_len=32, min_bucket=8).items():
        kw.setdefault(k, v)
    kw.setdefault("clock", StepClock(10.0))
    return ServingEngine(tm, tcfg, telemetry=telemetry, device="cpu", **kw)


def _jax_engine(fp_model, telemetry=None, **kw):
    jcfg, _, jp, _ = fp_model
    for k, v in dict(n_slots=2, max_len=32, min_bucket=8,
                     prepare=False).items():
        kw.setdefault(k, v)
    kw.setdefault("clock", J.StepClock(10.0))
    return J.ServingEngine(jp, jcfg, telemetry=telemetry, **kw)


def _run(eng, prompts=PROMPTS, max_new=4):
    """Submit through the queue and step with the StepClock advancing."""
    uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    while eng.active or len(eng.queue):
        eng.step()
        eng.clock.advance()
    fin = eng.take_finished()
    return {u: list(fin[u].tokens) for u in uids}


def _pressure_run(eng):
    uids = eng.add_requests(PROMPTS[:2], max_new_tokens=6)
    eng.step()
    eng.set_cache_pressure(3)
    eng.step()
    eng.set_cache_pressure(None)
    eng.run_to_completion()
    fin = eng.take_finished()
    return {u: fin[u] for u in uids}


# ------------------------------------------------------------------- units

@pytest.mark.parametrize("values", [
    [float(v) for v in range(1, 101)], [0.0, 0.0, 3.5, 1e9],
    [0.25 * v for v in range(40)], [7.0]])
def test_histogram_summary_equals_reference(values):
    h, jh = Histogram(lo=1e-3, hi=1e5, per_decade=8), J.Histogram(
        lo=1e-3, hi=1e5, per_decade=8)
    for v in values:
        h.observe(v)
        jh.observe(v)
    s = h.summary()
    assert s == jh.summary() and h.counts == jh.counts
    assert s["p50"] <= s["p90"] <= s["p99"]
    assert s["min"] <= s["p50"] <= s["max"]


def test_histogram_percentiles_within_bucket_resolution():
    h = Histogram(lo=1e-3, hi=1e5, per_decade=8)
    for v in range(1, 101):
        h.observe(float(v))
    s = h.summary()
    for q, exact in (("p50", 50.0), ("p90", 90.0), ("p99", 99.0)):
        assert s[q] == pytest.approx(exact, rel=0.2), (q, s)


@pytest.mark.parametrize("bad", [dict(lo=0.0), dict(lo=1.0, hi=0.5),
                                 dict(per_decade=0)])
def test_histogram_rejects_bad_bounds(bad):
    with pytest.raises(ValueError, match="histogram"):
        Histogram(**bad)


def test_registry_type_conflict_render_and_stats_projection():
    outs = []
    for reg_cls, proj in ((MetricsRegistry, registry_from_stats),
                          (J.MetricsRegistry, J.registry_from_stats)):
        reg = reg_cls()
        reg.counter("a").inc(3)
        reg.gauge("b").set(1.5)
        reg.histogram("lat_ms").observe(2.0)
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("a")
        proj({"steps": 7, "paged": {"pages_in_use": 3, "ladder": [1, 2]},
              "guards": True, "name": "x"}, reg)
        assert reg.get("serve.guards").value == 1
        assert reg.get("serve.paged.ladder") is None
        outs.append((reg.names(), reg.render(title="t"),
                     json.dumps(reg.snapshot(), sort_keys=True)))
    assert outs[0] == outs[1]


def test_timeline_same_step_overwrites():
    snaps = []
    for tl in (Timeline(), JaxTimeline()):
        tl.sample(0, 0.0, 1)
        tl.sample(1, 0.01, 2)
        tl.sample(1, 0.02, 5)
        snaps.append(tl.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["n"] == 2 and snaps[0]["values"] == [1.0, 5.0]


def test_telemetry_attach_is_single_use(fp_model):
    tel = Telemetry()
    _engine(fp_model, telemetry=tel)
    with pytest.raises(ValueError, match="already attached"):
        _engine(fp_model, telemetry=tel)


# ------------------------------------------------- engine instrumentation

def test_engine_spans_equal_reference(fp_model):
    """Every lifecycle edge emits one event with the virtual time and the
    engine step; the port's event stream and per-request records equal
    the JAX engine's, and the latency histograms hold one sample per
    request, exact multiples of the step under a StepClock."""
    tel, jtel = Telemetry(), J.Telemetry()
    toks = _run(_engine(fp_model, telemetry=tel))
    _run(_jax_engine(fp_model, telemetry=jtel))
    kinds = {e["kind"] for e in tel.events}
    assert {"submit", "admit", "first_token", "step", "retire"} <= kinds
    assert json.dumps(tel.events, sort_keys=True) == json.dumps(
        jtel.events, sort_keys=True)
    assert tel.records == jtel.records
    for uid, r in tel.records.items():
        assert r["state"] == "finished"
        assert r["tokens_out"] == len(toks[uid]) > 0
        assert r["submit_step"] <= r["admit_step"] <= r["first_token_step"]
        ttft = (r["first_token_t"] - r["submit_t"]) * 1e3
        assert ttft == pytest.approx(
            (r["first_token_step"] - r["submit_step"]) * 10.0)
    for name in ("ttft_ms", "queue_wait_ms"):
        assert tel.registry.histogram(name).count == len(PROMPTS)
        assert (tel.registry.histogram(name).summary()
                == jtel.registry.histogram(name).summary())


def test_telemetry_is_observation_only(fp_model):
    assert _run(_engine(fp_model, telemetry=Telemetry())) == _run(
        _engine(fp_model))


def test_preempt_resume_events_and_accounting(fp_model):
    tel, jtel = Telemetry(), J.Telemetry()
    fin = _pressure_run(_engine(fp_model, telemetry=tel))
    _pressure_run(_jax_engine(fp_model, telemetry=jtel))
    assert all(r.state.value == "finished" for r in fin.values())
    assert json.dumps(tel.events, sort_keys=True) == json.dumps(
        jtel.events, sort_keys=True)
    preempts = [e for e in tel.events if e["kind"] == "preempt"]
    resumes = [e for e in tel.events if e["kind"] == "resume"]
    assert preempts and resumes
    assert all(s >= 0 for s in preempts[0]["slots"])
    assert sum(r["preemptions"] for r in tel.records.values()) >= 1
    assert all(r["replayed"] >= 0 for r in resumes)


def test_spec_steps_carry_window_summaries(fp_model):
    jcfg, tcfg, _, _ = fp_model
    jd = japi.init_params(jax.random.PRNGKey(99), jcfg)
    td = from_numpy_tree(jax_tree_to_numpy(jd), tcfg, device="cpu")
    tel, jtel = Telemetry(), J.Telemetry()
    toks = _run(_engine(fp_model, telemetry=tel, draft_params=td,
                        spec=SpecConfig(gamma=2)))
    _run(_jax_engine(fp_model, telemetry=jtel, draft_params=jd,
                     spec=J.SpecConfig(gamma=2)))
    assert toks == _run(_engine(fp_model))          # lossless
    steps = [e for e in tel.events if e["kind"] == "step"]
    assert steps and all(e["mode"] == "spec" for e in steps)
    for e in steps:
        w = e["window"]
        assert w["gamma"] == 2 and 0 <= w["accepted"] <= w["proposed"]
        assert len(e["uids"]) == len(e["tokens"]) == len(e["slots"])
    assert [e["window"] for e in steps] == [
        e["window"] for e in jtel.events if e["kind"] == "step"]
    h = tel.registry.histogram("spec_accepted_per_window", lo=0.5, hi=3.0,
                               per_decade=16)
    assert h.count > 0 and h.counts == jtel.registry.histogram(
        "spec_accepted_per_window", lo=0.5, hi=3.0, per_decade=16).counts


def test_perfetto_trace_structure(fp_model):
    tel = Telemetry()
    _pressure_run(_engine(fp_model, telemetry=tel))
    doc = perfetto_trace(tel)
    json.loads(json.dumps(doc))
    evs = doc["traceEvents"]
    tracks = [e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"]
    assert sorted(tracks) == ["queue", "slot 0", "slot 1"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert spans and all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
    assert {e["name"] for e in spans} <= {"prefill", "decode", "spec",
                                          "resume"}
    assert all(1 <= e["tid"] <= tel.n_slots for e in spans)
    names = {e["name"] for e in evs if e["ph"] == "i"}
    assert "submit" in names and "preempt" in names
    assert any(n.startswith("retire:") for n in names)
    counters = [e for e in evs if e["ph"] == "C"]
    assert {"queue_depth", "active_slots"} <= {e["name"] for e in counters}


def test_engine_metrics_consolidates_stats(fp_model):
    tel = Telemetry()
    eng = _engine(fp_model, telemetry=tel)
    _run(eng)
    reg = eng.metrics()
    assert reg is tel.registry
    assert reg.get("serve.engine_steps").value == eng.engine_steps
    assert reg.get("serve.lifecycle.finished").value == len(PROMPTS)
    out = reg.render()
    assert "serve.lifecycle.finished" in out and "ttft_ms" in out
    bare = _engine(fp_model)
    _run(bare)
    assert bare.metrics().get("serve.engine_steps").value > 0
    assert np.isfinite(reg.get("serve.tokens_per_step").value)
