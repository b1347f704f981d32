"""Port parity for the overload control plane, mirroring
tests/test_admission.py: the cost model, SLO validation, the queue's
worst-first pop and peak reset, hysteresis, shedding, deferral and the
prefill budget on a host-only fake engine (each held to the reference's
classes on the same inputs), the capability-gated ladders of port engines,
and a seeded overload storm on a chunked speculative engine (llama1_7b
smoke config, vocab 128, 2 layers) whose typed decision stream walks the
whole ladder, replays byte for byte, and equals the JAX engine's byte for
byte."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serve as J  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve.replay import overload_trace as jax_overload  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro_torch.serve import (AdmissionController,  # noqa: E402
                               AdmissionQueue, ServingEngine, SLOConfig,
                               SpecConfig, StepCostModel)
from repro_torch.serve.admission import (RUNG_KV_INT8,  # noqa: E402
                                         RUNG_NOMINAL, RUNG_SHED,
                                         RUNG_SPEC_HALF, RUNG_SPEC_OFF)
from repro_torch.serve.replay import overload_trace  # noqa: E402
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FULL_LADDER = [RUNG_NOMINAL, RUNG_SPEC_HALF, RUNG_SPEC_OFF, RUNG_KV_INT8,
               RUNG_SHED]


# ---------------------------------------------------------------- cost model

@pytest.mark.parametrize("work", [
    {}, dict(prefill_tokens=100), dict(decode_calls=1, draft_calls=3,
                                       verify_tokens=3),
    dict(prefill_tokens=512, decode_calls=2, draft_calls=5,
         verify_tokens=10)])
def test_cost_model_equals_reference(work):
    assert StepCostModel().cost_ms(**work) == J.StepCostModel().cost_ms(**work)
    m = StepCostModel()
    whole = m.cost_ms(prefill_tokens=512)
    parts = sum(m.cost_ms(prefill_tokens=64) - m.base_ms
                for _ in range(8)) + m.base_ms
    assert whole == pytest.approx(parts)


@pytest.mark.parametrize("bad", [
    dict(ttft_p99_ms=0), dict(ttft_p99_ms=100, queue_wait_frac=0.0),
    dict(ttft_p99_ms=100, prefill_budget_tokens=0),
    dict(ttft_p99_ms=100, up_patience=0),
    dict(ttft_p99_ms=100, min_dwell_steps=-1)])
def test_slo_config_validation(bad):
    with pytest.raises(ValueError):
        SLOConfig(**bad)
    with pytest.raises(ValueError):
        J.SLOConfig(**bad)


def test_controller_mode_validation():
    with pytest.raises(ValueError):
        AdmissionController(SLOConfig(ttft_p99_ms=100), mode="degrade")


# -------------------------------------------------------------- queue units

class _Req:
    def __init__(self, uid, priority=0, tokens=(), preemptions=0):
        self.uid = uid
        self.priority = priority
        self.tokens = list(tokens)
        self.deadline = None
        self.preemptions = preemptions


def test_pop_worst_is_reverse_rank_and_spares_preempted():
    q = AdmissionQueue(8)
    fresh_lo = _Req(1, priority=-1)
    fresh_hi = _Req(2, priority=1)
    preempted = _Req(3, priority=-1, tokens=[7])
    q.push(fresh_hi)
    q.push(fresh_lo)
    q.push_front(preempted)
    assert q.pop_worst(lambda r: not r.tokens) is fresh_lo
    assert q.pop_worst(lambda r: not r.tokens) is fresh_hi
    assert q.pop_worst(lambda r: not r.tokens) is None
    assert len(q) == 1 and q.pop_worst() is preempted


def test_queue_peak_depth_reset():
    q = AdmissionQueue(8)
    for i in range(5):
        q.push(_Req(i))
    for _ in range(4):
        q.pop_worst()
    assert q.peak_depth == 5 and len(q) == 1
    q.reset_peaks()
    assert q.peak_depth == 1


# ------------------------------------------------- hysteresis (fake engine)

class _FakeEngine:
    """The attribute surface ``on_step``/``allow_fresh`` touch — no model,
    so the controller's timing is tested in isolation."""

    spec = None
    kv_dtype = None
    telemetry = None
    n_slots = 2
    last_step_cost_ms = None
    pending_prefills = 0
    prefill_backlog_tokens = 0

    def __init__(self, queue_cls):
        self.queue = queue_cls(64)
        self.engine_steps = 0
        self.active = {}
        self._kv_int8_admission = False
        self.t = 0.0
        self.retired = []

    def _clock(self):
        return self.t

    def _retire(self, req, state, diagnostics=None):
        self.queue._items = [(o, r) for o, r in self.queue._items
                             if r is not req]
        self.retired.append((req.uid, state.value, diagnostics))


def _stale_fresh(uid):
    r = _Req(uid)
    r.submitted_at = -100.0
    return r


def _both(slo_kw, mode="full"):
    """(port, reference) controller + fake engine pairs, attached."""
    out = []
    for mod in (None, J):
        ctl_cls = AdmissionController if mod is None else J.AdmissionController
        slo_cls = SLOConfig if mod is None else J.SLOConfig
        q_cls = AdmissionQueue if mod is None else J.AdmissionQueue
        ctl = ctl_cls(slo_cls(**slo_kw), mode=mode)
        eng = _FakeEngine(q_cls)
        ctl.attach(eng)
        out.append((ctl, eng))
    return out


def test_hysteresis_patience_and_dwell_equal_reference():
    runs = []
    for ctl, eng in _both(dict(ttft_p99_ms=100, up_patience=2,
                               down_patience=3, min_dwell_steps=3)):
        assert ctl.ladder == [RUNG_NOMINAL, RUNG_KV_INT8, RUNG_SHED]
        eng.queue.push(_stale_fresh(1))
        rungs, knobs = [], []
        for step in range(1, 20):
            if step == 9:
                eng.queue._items = []           # pressure clears
            eng.engine_steps = step
            ctl.on_step(eng)
            rungs.append(ctl.rung)
            knobs.append(eng._kv_int8_admission)
        runs.append((rungs, knobs, ctl.decision_log(), eng.retired,
                     ctl.stats()))
    assert runs[0] == runs[1]
    rungs = runs[0][0]
    assert rungs == [0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0,
                     0]
    assert [d["kind"] for d in runs[0][2] if d["kind"].startswith("rung")] \
        == ["rung_up", "rung_up", "rung_down", "rung_down"]


def test_shed_abandons_worst_first_to_target_depth():
    runs = []
    for ctl, eng in _both(dict(ttft_p99_ms=100, up_patience=1,
                               min_dwell_steps=0, shed_target_depth=1),
                          mode="admission"):
        assert ctl.ladder == [RUNG_NOMINAL, RUNG_SHED]
        preempted = _Req(9, tokens=[3], preemptions=1)
        preempted.submitted_at = 0.0
        eng.queue.push_front(preempted)
        prefilling = _Req(8, tokens=(), preemptions=1)
        prefilling.submitted_at = 0.0
        eng.queue.push_front(prefilling)
        for uid, prio in ((1, 0), (2, -1), (3, 1)):
            r = _stale_fresh(uid)
            r.priority = prio
            eng.queue.push(r)
        eng.engine_steps = 1
        ctl.on_step(eng)
        assert ctl.rung_name == RUNG_SHED
        assert set(eng.queue.requests()) == {preempted, prefilling}
        runs.append((eng.retired, ctl.decision_log(), ctl.sheds))
    assert runs[0] == runs[1]
    assert [u for u, _, _ in runs[0][0]] == [2, 1, 3]
    assert all(d["kind"] == "shed" for _, _, d in runs[0][0])


def test_defer_counter_and_idle_admission():
    for ctl, eng in _both(dict(ttft_p99_ms=100), mode="admission"):
        eng.engine_steps = 1
        ctl.note_defer(eng, blocked=2)
        ctl.note_defer(eng, blocked=2)
        eng.engine_steps = 2
        ctl.note_defer(eng, blocked=1)
        assert ctl.defers == len([d for d in ctl.decisions
                                  if d.kind == "defer"]) == 2
        ctl.rung = len(ctl.ladder) - 1
        ctl._breached = True
        assert ctl.allow_fresh(eng)           # nothing running: admit
        eng.active = {1: object()}
        assert not ctl.allow_fresh(eng)


def test_prefill_budget_halves_per_rung():
    ctl = AdmissionController(SLOConfig(ttft_p99_ms=100,
                                        prefill_budget_tokens=512,
                                        min_prefill_tokens=32))
    ctl.attach(_FakeEngine(AdmissionQueue))
    budgets = []
    for rung in range(len(ctl.ladder)):
        ctl.rung = rung
        budgets.append(ctl.prefill_budget())
    assert budgets == [512, 256, 128]
    ctl.rung = 5
    assert ctl.prefill_budget() == 32


def test_one_controller_per_engine():
    ctl = AdmissionController(SLOConfig(ttft_p99_ms=100))
    ctl.attach(_FakeEngine(AdmissionQueue))
    with pytest.raises(ValueError, match="already attached"):
        ctl.attach(_FakeEngine(AdmissionQueue))


# --------------------------------------------- engines and the seeded storm

@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = smoke_cfgs()
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    jd = japi.init_params(jax.random.PRNGKey(99), jcfg)
    conv = lambda p: from_numpy_tree(jax_tree_to_numpy(p), tcfg,  # noqa: E731
                                     device="cpu")
    return jcfg, tcfg, jp, jd, conv(jp), conv(jd)


def test_ladder_gating_capabilities(models):
    _, tcfg, _, _, tm, td = models
    slo = SLOConfig(ttft_p99_ms=250)

    def ladder(mode="full", **kw):
        ctl = AdmissionController(slo, mode=mode)
        eng = ServingEngine(tm, tcfg, n_slots=3, max_len=64, min_bucket=8,
                            controller=ctl, device="cpu", **kw)
        return ctl.ladder, eng

    assert ladder()[0] == [RUNG_NOMINAL, RUNG_KV_INT8, RUNG_SHED]
    assert ladder(mode="admission")[0] == [RUNG_NOMINAL, RUNG_SHED]
    lad, eng = ladder(draft_params=td, spec=SpecConfig(gamma=4))
    assert lad == FULL_LADDER
    assert eng.verify_gammas == {2, 4}
    lad, _ = ladder(kv_layout="paged", page_size=8, kv_dtype="int8")
    assert lad == [RUNG_NOMINAL, RUNG_SHED]


def test_overload_storm_rung_sequence_equals_reference(models):
    """The full 5-rung ladder under a seeded burst storm on a chunked
    speculative engine: the port's decision stream — every rung change,
    shed and defer, with virtual timestamps — is byte-identical across two
    runs and to the JAX engine's, and climbs one rung at a time to shed."""
    jcfg, tcfg, jp, jd, tm, td = models
    trace = overload_trace(seed=5, steps=40, vocab=tcfg.vocab)
    assert ([a.to_json() for a in trace]
            == [a.to_json() for a in jax_overload(seed=5, steps=40,
                                                  vocab=jcfg.vocab)])

    def run(mod, params, draft, cfg, trace, **kw):
        ctl = mod.AdmissionController(mod.SLOConfig(ttft_p99_ms=120.0),
                                      mode="full")
        eng = mod.ServingEngine(
            params, cfg, n_slots=3, max_len=64, min_bucket=8,
            draft_params=draft, spec=mod.SpecConfig(gamma=2),
            chunked_prefill=8, controller=ctl,
            cost_model=mod.StepCostModel(), clock=mod.StepClock(10.0),
            queue_depth=48, **kw)
        mod.Replayer(eng, trace,
                     retry=mod.RetryPolicy(backoff_s=0.0)).run()
        return eng, ctl

    eng1, ctl1 = run(T, tm, td, tcfg, trace, device="cpu")
    _, ctl2 = run(T, tm, td, tcfg, trace, device="cpu")
    _, jctl = run(J, jp, jd, jcfg,
                  jax_overload(seed=5, steps=40, vocab=jcfg.vocab),
                  prepare=False)
    assert ctl1.ladder == FULL_LADDER
    log1 = json.dumps(ctl1.decision_log(), sort_keys=True)
    assert log1 == json.dumps(ctl2.decision_log(), sort_keys=True)
    assert log1 == json.dumps(jctl.decision_log(), sort_keys=True)
    assert ctl1.stats() == jctl.stats()
    up = [d["rung_name"] for d in ctl1.decision_log()
          if d["kind"] == "rung_up"]
    assert up[:4] == FULL_LADDER[1:] and ctl1.sheds > 0
    assert eng1.stats()["queue_peak_depth"] > 0
    eng1.reset_peaks()
    assert eng1.stats()["queue_peak_depth"] == len(eng1.queue) == 0
