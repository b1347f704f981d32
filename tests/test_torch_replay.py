"""Port parity for trace-driven replay, mirroring tests/test_replay.py:
trace synthesis (arrival for arrival the reference's) and the JSONL round
trip, the ``replay-report/v1`` report and its validator, byte-identical
replay under a seeded preempt/resume storm, the replay and launcher CLIs
(``python -m repro_torch.serve.replay``, ``repro_torch.launch.serve
--replay-trace``) on the CPU — and the whole-engine parity check: on a
seeded preempt storm and on an overload storm, both under ``StepClock`` +
``StepCostModel``, the port's report equals the JAX engine's byte for
byte after ``json.dumps(sort_keys=True)`` (llama1_7b smoke config, vocab
128, 2 layers; no field is left out)."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve.replay import overload_trace as jax_overload  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.serve import (Replayer, Telemetry,  # noqa: E402
                               load_trace, save_trace, synthesize_trace,
                               validate_report)
from repro_torch.serve import replay as replay_cli  # noqa: E402
from repro_torch.serve.replay import overload_trace  # noqa: E402
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = smoke_cfgs()
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    jd = japi.init_params(jax.random.PRNGKey(99), jcfg)
    conv = lambda p: from_numpy_tree(jax_tree_to_numpy(p), tcfg,  # noqa: E731
                                     device="cpu")
    return jcfg, tcfg, jp, jd, conv(jp), conv(jd)


def _engine(mod, models, telemetry=None, faults=False, seed=0, **kw):
    """The reference test's storm engine (3 slots, max_len 48, pressure
    windows below running fills) from package ``mod`` (T or J)."""
    jcfg, tcfg, jp, _, tm, _ = models
    inj = None
    if faults:
        inj = mod.FaultInjector(seed=seed + 7, horizon=32, nan_faults=0,
                                inf_faults=0, transient_failures=0,
                                pressure_windows=2,
                                pressure_frac=(0.15, 0.25))
    if mod is T:
        args, kw = (tm, tcfg), dict(kw, device="cpu")
    else:
        args, kw = (jp, jcfg), dict(kw, prepare=False)
    return mod.ServingEngine(*args, n_slots=3, max_len=48, min_bucket=8,
                             clock=mod.StepClock(10.0), telemetry=telemetry,
                             faults=inj, on_pressure="preempt", **kw)


def _dump(report):
    return json.dumps(report, sort_keys=True)


# -------------------------------------------------------------------- trace

@pytest.mark.parametrize("kw", [
    dict(seed=5, steps=20), dict(seed=2, steps=20, vocab=128,
                                 max_new=(4, 9)),
    dict(seed=0, steps=12, vocab=128, deadline_frac=0.5)])
def test_synthesize_trace_equals_reference(kw):
    a = synthesize_trace(**kw)
    assert a == synthesize_trace(**kw) and len(a) > 0
    assert [x.to_json() for x in a] == [
        x.to_json() for x in J.synthesize_trace(**kw)]
    assert all(x.t <= y.t for x, y in zip(a, a[1:]))
    assert [x.to_json() for x in overload_trace(kw["seed"])] == [
        x.to_json() for x in jax_overload(kw["seed"])]


def test_trace_jsonl_roundtrip_across_packages(tmp_path):
    trace = synthesize_trace(seed=1, steps=16)
    p = tmp_path / "trace.jsonl"
    save_trace(str(p), trace)
    assert load_trace(str(p)) == trace
    assert [a.to_json() for a in J.load_trace(str(p))] == [
        a.to_json() for a in trace]
    q = tmp_path / "ref.jsonl"
    J.save_trace(str(q), J.synthesize_trace(seed=1, steps=16))
    assert q.read_text() == p.read_text()
    shuffled = tmp_path / "shuffled.jsonl"
    save_trace(str(shuffled), list(reversed(trace)))
    got = load_trace(str(shuffled))
    assert all(x.t <= y.t for x, y in zip(got, got[1:]))
    assert sorted(map(repr, got)) == sorted(map(repr, trace))


def test_load_trace_names_bad_line(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"t": 0.0, "prompt": [1]}\n{"t": "nope"}\n')
    with pytest.raises(ValueError, match=r"bad\.jsonl:2"):
        load_trace(str(p))


# ------------------------------------------------------------------- report

def test_replay_report_schema_and_percentiles(models):
    trace = synthesize_trace(seed=0, steps=16, vocab=128, max_new=(4, 9))
    report = Replayer(_engine(T, models, telemetry=Telemetry()),
                      trace).run()
    validate_report(report)
    assert report["requests"]["submitted"] == len(trace)
    assert report["ttft_ms"]["count"] > 0
    assert report["ttft_ms"]["p50"] <= report["ttft_ms"]["p99"]
    assert report["tokens"]["total_out"] > 0
    assert report["tokens"]["per_s_per_slot"] > 0
    assert len(report["per_request"]) == len(trace)
    assert report["timelines"]["queue_depth"]["n"] > 0
    for row in report["per_request"]:
        if row["tpot_ms"] is not None:
            assert row["tokens_out"] >= 2


def test_preempt_storm_report_equals_reference(models):
    """A seeded preempt/resume storm under StepClock + StepCostModel: the
    storm preempts and resumes, the port's report and event stream are
    byte-identical across two runs, and its report equals the JAX
    engine's byte for byte."""
    trace = synthesize_trace(seed=2, steps=20, vocab=128, max_new=(4, 9))

    def run(mod, trace):
        tel = mod.Telemetry()
        eng = _engine(mod, models, telemetry=tel, faults=True,
                      cost_model=mod.StepCostModel())
        return mod.Replayer(eng, trace).run(), tel.events

    rep1, ev1 = run(T, trace)
    rep2, ev2 = run(T, trace)
    assert rep1["scheduling"]["preemptions"] >= 1
    assert rep1["scheduling"]["resumes"] >= 1
    assert _dump(rep1) == _dump(rep2)
    assert json.dumps(ev1) == json.dumps(ev2)
    jrep, jev = run(J, J.synthesize_trace(seed=2, steps=20, vocab=128,
                                          max_new=(4, 9)))
    assert _dump(rep1) == _dump(jrep)
    assert json.dumps(ev1, sort_keys=True) == json.dumps(jev, sort_keys=True)


def test_overload_storm_report_equals_reference(models):
    """The overload storm on a chunked speculative engine with the full
    controller ladder, under StepClock + StepCostModel: the report (the
    controller's decision log included) equals the JAX engine's byte for
    byte."""
    jcfg, tcfg, jp, jd, tm, td = models

    def run(mod, params, draft, cfg, trace, **kw):
        ctl = mod.AdmissionController(mod.SLOConfig(ttft_p99_ms=120.0),
                                      mode="full")
        eng = mod.ServingEngine(
            params, cfg, n_slots=3, max_len=64, min_bucket=8,
            draft_params=draft, spec=mod.SpecConfig(gamma=2),
            chunked_prefill=8, controller=ctl,
            cost_model=mod.StepCostModel(), clock=mod.StepClock(10.0),
            queue_depth=48, telemetry=mod.Telemetry(), **kw)
        return mod.Replayer(eng, trace,
                            retry=mod.RetryPolicy(backoff_s=0.0)).run()

    rep = run(T, tm, td, tcfg, overload_trace(seed=5, steps=40, vocab=128),
              device="cpu")
    jrep = run(J, jp, jd, jcfg, jax_overload(seed=5, steps=40, vocab=128),
               prepare=False)
    validate_report(rep)
    assert rep["controller"]["rung_changes"] > 0 and rep["controller"][
        "sheds"] > 0
    assert _dump(rep) == _dump(jrep)


def test_replay_without_telemetry_matches_token_streams(models):
    trace = synthesize_trace(seed=3, steps=16, vocab=128, max_new=(4, 9))

    def run(tel):
        eng = _engine(T, models, telemetry=tel, faults=True)
        rep = Replayer(eng, trace).run()
        fin = eng.take_finished()
        return rep, {u: list(r.tokens) for u, r in fin.items()}

    rep_off, toks_off = run(None)
    assert rep_off is None
    rep_on, toks_on = run(Telemetry())
    assert rep_on is not None and toks_on == toks_off


def test_validate_report_names_every_problem(models):
    trace = synthesize_trace(seed=0, steps=12, vocab=128)
    report = Replayer(_engine(T, models, telemetry=Telemetry()),
                      trace).run()
    bad = json.loads(json.dumps(report))
    bad["schema"] = "nope"
    bad["ttft_ms"]["p90"] = bad["ttft_ms"]["p50"] - 1.0
    del bad["tokens"]["per_s_per_slot"]
    with pytest.raises(ValueError) as ei:
        validate_report(bad)
    msg = str(ei.value)
    assert "schema" in msg and "not monotone" in msg
    assert "per_s_per_slot" in msg


# ---------------------------------------------------------------------- cli

def test_replay_cli_smoke(tmp_path, capsys):
    rep_path = tmp_path / "report.json"
    tr_path = tmp_path / "trace.json"
    rc = replay_cli.main(["--smoke", "--faults", "--steps", "12",
                          "--device", "cpu", "--report-json", str(rep_path),
                          "--perfetto", str(tr_path)])
    assert rc == 0
    report = validate_report(json.loads(rep_path.read_text()))
    assert report["ttft_ms"]["count"] > 0
    assert json.loads(tr_path.read_text())["traceEvents"]
    out = capsys.readouterr().out
    assert "ttft_ms p50=" in out and "tokens/s/slot=" in out


def test_replay_cli_overload_ab(capsys):
    """``--slo-ttft-p99-ms``: the SLO-guarded run beats the uncontrolled
    baseline on the same seeded burst trace and meets the target."""
    rc = replay_cli.main(["--slo-ttft-p99-ms", "150", "--slots", "3",
                          "--max-len", "64", "--device", "cpu"])
    assert rc == 0
    assert "[overload] OK" in capsys.readouterr().out


def test_launch_cli_replay_and_exports(tmp_path, capsys):
    from repro_torch.launch import serve as launch_serve
    trace_p = tmp_path / "trace.jsonl"
    save_trace(str(trace_p), synthesize_trace(seed=4, steps=10, vocab=64,
                                              max_new=(3, 6)))
    rep_p = tmp_path / "report.json"
    pf_p = tmp_path / "perfetto.json"
    launch_serve.main(["--arch", "llama1_7b", "--smoke", "--bits", "3",
                       "--slots", "2", "--max-len", "48",
                       "--min-bucket", "8", "--device", "cpu",
                       "--replay-trace", str(trace_p),
                       "--report-json", str(rep_p),
                       "--telemetry-trace", str(pf_p), "--stats"])
    report = validate_report(json.loads(rep_p.read_text()))
    assert report["ttft_ms"]["count"] > 0
    doc = json.loads(pf_p.read_text())
    tracks = [e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"]
    assert sorted(tracks) == ["queue", "slot 0", "slot 1"]
    out = capsys.readouterr().out
    assert "[serve metrics]" in out and "serve.lifecycle.finished" in out
