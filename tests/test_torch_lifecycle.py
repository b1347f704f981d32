"""Port parity for the request lifecycle, mirroring tests/test_lifecycle.py
on the llama1_7b smoke config (vocab 128, 2 layers, 2 slots, max_len 32):
the state machine and the queue bound, the fault injector's seeded plans
(value for value the reference's), the guard's per-row count, deadlines
(queued and running), preempt/resume (resumed tokens bitwise the port's
uninterrupted run), priority preemption and victim order, the truncate
policy, partial outputs of an incomplete run, guard quarantine of one
row (decode, and verify in the middle of a speculation window), bounded
retry of transient faults, and a seeded fault plan that replays exactly.
States, diagnostics and counters are held equal to the JAX engine's on the
same weights and inputs; tokens to its tokens under the near-tie rule."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.serve import FaultInjector as JaxFaults  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro.serve import SpecConfig as JaxSpec  # noqa: E402
from repro.serve import StepClock as JaxClock  # noqa: E402
from repro.serve import RetryPolicy as JaxRetry  # noqa: E402
from repro.serve.faults import nonfinite_rows as jax_nonfinite  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.serve import (AdmissionQueue, AdmissionRejected,  # noqa: E402
                               DeadlineExceeded, EngineFault, FaultInjector,
                               IncompleteRun, Request, RequestState,
                               RetryPolicy, ServingEngine, SpecConfig,
                               StepClock, TERMINAL_STATES, nonfinite_rows)
from repro_torch.serve.lifecycle import transition  # noqa: E402
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402
from test_torch_serving import _assert_tokens_match  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9]]


@pytest.fixture(scope="module")
def fp_model():
    jcfg, tcfg = smoke_cfgs()
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tm


def _engine(fp_model, **kw):
    _, tcfg, _, tm = fp_model
    for k, v in dict(n_slots=2, max_len=32, min_bucket=8).items():
        kw.setdefault(k, v)
    return ServingEngine(tm, tcfg, device="cpu", **kw)


def _jax_engine(fp_model, **kw):
    jcfg, _, jp, _ = fp_model
    for k, v in dict(n_slots=2, max_len=32, min_bucket=8,
                     prepare=False).items():
        kw.setdefault(k, v)
    return JaxEngine(jp, jcfg, **kw)


@pytest.fixture(scope="module")
def base_tokens(fp_model):
    """Uninterrupted port tokens of PROMPTS at 8 and 10 new tokens."""
    out = {}
    for n in (8, 10):
        eng = _engine(fp_model)
        uids = eng.add_requests(PROMPTS, max_new_tokens=n)
        eng.run_to_completion()
        fin = eng.take_finished()
        out[n] = [fin[u].tokens for u in uids]
    return out


def _outcome(fin, uids):
    return [(fin[u].state.value, fin[u].diagnostics, fin[u].preemptions)
            for u in uids]


def _match(fp_model, prompts, got, want):
    _assert_tokens_match(fp_model[3], fp_model[1], prompts, got, want)


# ------------------------------------------------------------------- units

def test_state_machine_enforced():
    req = Request(0, [1], 4)
    assert req.state is RequestState.QUEUED and not req.done
    for st in (RequestState.RUNNING, RequestState.PREEMPTED,
               RequestState.QUEUED, RequestState.PREFILLING,
               RequestState.RUNNING, RequestState.FINISHED):
        transition(req, st)
    assert req.done and not req.truncated and req.tokens_out == 0
    with pytest.raises(ValueError, match="illegal lifecycle transition"):
        transition(req, RequestState.QUEUED)
    with pytest.raises(ValueError, match="illegal"):
        transition(Request(1, [1], 4), RequestState.PREEMPTED)
    assert RequestState.PREEMPTED not in TERMINAL_STATES


def test_admission_queue_bound_priority_and_expiry():
    q = AdmissionQueue(2)
    a = Request(0, [1], 4, priority=0)
    b = Request(1, [1], 4, priority=5)
    q.push(a)
    q.push(b)
    with pytest.raises(AdmissionRejected, match="queue full"):
        q.push(Request(2, [1], 4))
    assert len(q) == 2 and q.uids() == [1, 0]
    q.push_front(Request(3, [1], 4, priority=5))   # bound-exempt
    assert q.pop_best().uid == 3 and len(q) == 2
    assert q.pop_best(lambda r: r.priority == 0).uid == 0
    b.deadline = 1.0
    assert [r.uid for r in q.expire(2.0)] == [1]
    assert len(q) == 0 and q.pop_best() is None and q.peak_depth == 3


def test_retry_policy_bounds_transient_faults():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise EngineFault("flaky", transient=True)
        return "ok"

    pol = RetryPolicy(max_attempts=3, backoff_s=0.0, sleep=lambda s: None)
    assert pol.run(flaky) == ("ok", 2)
    with pytest.raises(EngineFault, match="hard"):
        pol.run(lambda: (_ for _ in ()).throw(EngineFault("hard")))
    with pytest.raises(EngineFault, match="always"):
        pol.run(lambda: (_ for _ in ()).throw(
            EngineFault("always", transient=True)))


@pytest.mark.parametrize("seed", [0, 2, 5, 7, 11])
@pytest.mark.parametrize("kw", [
    {}, dict(horizon=16, pressure_windows=2, pressure_frac=(0.3, 0.4)),
    dict(horizon=8, nan_faults=3, inf_faults=2, transient_failures=3,
         max_consecutive_failures=3, burst_every=0, arrival_lambda=0.0)])
def test_fault_plan_equals_reference(seed, kw):
    """One seed, one plan: every consumer of the port's injector returns
    the reference's values, step by step."""
    a, j = FaultInjector(seed=seed, **kw), JaxFaults(seed=seed, **kw)
    assert a.describe() == j.describe()
    assert a.logit_faults == j.logit_faults
    assert a.pressure_spans == j.pressure_spans
    assert a.fail_steps == j.fail_steps
    assert a.arrival_counts == j.arrival_counts
    for step in range(a.horizon + 2):
        for occ in ([], [0], [1, 3], [0, 1, 2, 3]):
            np.testing.assert_array_equal(a.inject_vector(step, 4, occ),
                                          j.inject_vector(step, 4, occ))
        assert a.pressure(step, 64) == j.pressure(step, 64)
        assert a.arrivals(step) == j.arrivals(step)
        assert ([a.should_fail_step(step) for _ in range(4)]
                == [j.should_fail_step(step) for _ in range(4)])
    a.reset()
    j.reset()
    step = next(iter(a.fail_steps))
    assert a.should_fail_step(step) == j.should_fail_step(step) is True


def test_nonfinite_rows_equal_reference():
    x = np.zeros((4, 3, 6), np.float32)
    x[1, 0, 2] = np.nan
    x[2, 1, 1] = np.inf
    x[2, 2, 0] = -np.inf
    for arr in (x, x[:, 0], x[:, :2]):
        got = nonfinite_rows(torch.from_numpy(np.ascontiguousarray(arr)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_nonfinite(
                                          jnp.asarray(arr))))


# ---------------------------------------------------------- engine lifecycle

def test_step_with_zero_active_slots(fp_model):
    eng = _engine(fp_model)
    assert eng.step() == {} and eng.step() == {}
    assert eng.engine_steps == 0
    uid = eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.step()
    eng.step()
    assert eng.take_finished()[uid].state is RequestState.FINISHED


def test_typed_admission_errors(fp_model):
    eng = _engine(fp_model, queue_depth=1)
    with pytest.raises(AdmissionRejected):
        eng.add_requests([[1]] * 3, max_new_tokens=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(list(range(1, 31)), max_new_tokens=8)
    eng.submit(PROMPTS[0], max_new_tokens=2)
    with pytest.raises(AdmissionRejected, match="backpressure"):
        eng.submit(PROMPTS[1], max_new_tokens=2)
    assert eng.stats()["admission_rejections"] >= 1
    with pytest.raises(DeadlineExceeded):
        eng.submit(PROMPTS[1], max_new_tokens=2, deadline_ms=0)
    with pytest.raises(ValueError, match="on_pressure"):
        _engine(fp_model, on_pressure="panic")


def _deadline_run(eng, clock):
    blocker = eng.submit([2, 3, 4], max_new_tokens=12)
    eng.step()
    queued = eng.submit(PROMPTS[0], max_new_tokens=4, deadline_ms=25)
    clock.advance(30)
    eng.step()
    fin = dict(eng.take_finished())
    running = eng.submit([7, 8], max_new_tokens=10, deadline_ms=40)
    eng.step()
    clock.advance(5)
    for _ in range(11):
        eng.step()
    mid = running in eng.active
    clock.advance(50)
    eng.step()
    fin.update(eng.take_finished())
    uids = (blocker, queued, running)
    return _outcome(fin, [u for u in uids if u in fin]), mid, {
        u: fin[u].tokens for u in uids if u in fin}


def test_deadline_abandonment_queued_and_running(fp_model):
    clock = StepClock(step_ms=10.0)
    got, mid, toks = _deadline_run(_engine(fp_model, n_slots=1, clock=clock),
                                   clock)
    jclock = JaxClock(step_ms=10.0)
    want, jmid, jtoks = _deadline_run(_jax_engine(fp_model, n_slots=1,
                                                  clock=jclock), jclock)
    assert got == want and mid and jmid
    states = {d["where"]: s for s, d, _ in got if d is not None}
    assert states == {"queued": "abandoned", "running": "abandoned"}
    # the queued request never ran; the running one keeps its partial
    # output, as long as the reference's
    lens = [len(t) for t in toks.values()]
    assert lens == [len(t) for t in jtoks.values()]
    assert lens[:2] == [12, 0] and lens[2] >= 1


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_resume_token_parity(fp_model, base_tokens, paged):
    """Pressure below both fills preempts both requests; nothing readmits
    under sustained pressure; on release both resume — tokens bitwise the
    port's uninterrupted run (contiguous and paged), states and counters
    equal to the JAX engine's."""
    kw = dict(kv_layout="paged", page_size=8) if paged else {}

    def run(eng):
        uids = eng.add_requests(PROMPTS, max_new_tokens=8)
        for _ in range(3):
            eng.step()
        eng.set_cache_pressure(4)
        eng.step()
        st = eng.stats()
        assert st["preemptions"] == 2 and not eng.active and st["queued"] == 2
        eng.step()
        assert eng.stats()["preemptions"] == 2 and not eng.active
        eng.set_cache_pressure(None)
        eng.run_to_completion()
        fin = eng.take_finished()
        st = eng.stats()
        return ([fin[u].tokens for u in uids], _outcome(fin, uids),
                (st["preemptions"], st["resumes"], st["lifecycle"]))

    got, out, counts = run(_engine(fp_model, **kw))
    assert got == base_tokens[8]                      # bitwise resume
    jgot, jout, jcounts = run(_jax_engine(fp_model, **kw))
    assert out == jout and counts == jcounts
    assert counts[:2] == (2, 2) and counts[2]["finished"] == 2
    _match(fp_model, PROMPTS, got, jgot)


def test_priority_preemption_and_victim_order(fp_model, base_tokens):
    def run(eng):
        low = eng.add_requests([PROMPTS[0]], max_new_tokens=8, priority=0)[0]
        eng.step()
        hi = eng.submit([9, 9, 9], max_new_tokens=6, priority=5)
        eng.step()
        assert hi in eng.active and low not in eng.active
        assert eng.stats()["preemptions"] == 1
        eq = eng.submit([4, 4], max_new_tokens=2, priority=5)
        eng.step()
        assert hi in eng.active and eq not in eng.active
        eng.run_to_completion()
        fin = eng.take_finished()
        uids = (low, hi, eq)
        return [fin[u].tokens for u in uids], _outcome(fin, uids)

    got, out = run(_engine(fp_model, n_slots=1))
    jgot, jout = run(_jax_engine(fp_model, n_slots=1))
    assert got[0] == base_tokens[8][0]                # resumed bitwise
    assert out == jout
    assert all(s == "finished" for s, _, _ in out)
    _match(fp_model, [PROMPTS[0], [9, 9, 9], [4, 4]], got, jgot)


def test_on_pressure_truncate_is_opt_in(fp_model):
    def run(eng):
        uids = eng.add_requests(PROMPTS, max_new_tokens=8)
        for _ in range(3):
            eng.step()
        eng.set_cache_pressure(4)
        eng.step()
        return _outcome(eng.take_finished(), uids), eng.stats()["preemptions"]

    got = run(_engine(fp_model, on_pressure="truncate"))
    assert got == run(_jax_engine(fp_model, on_pressure="truncate"))
    assert all(s == "truncated" and d["kind"] == "cache_pressure"
               for s, d, _ in got[0]) and got[1] == 0


def test_incomplete_run_attaches_partials(fp_model):
    eng = _engine(fp_model)
    uids = eng.add_requests(PROMPTS, max_new_tokens=25)
    with pytest.raises(IncompleteRun, match="max_steps") as ei:
        eng.run_to_completion(max_steps=3)
    err = ei.value
    assert sorted(err.partial) == sorted(uids)
    for u in uids:
        assert err.partial[u] == eng.active[u].tokens
        assert len(err.partial[u]) == 4
        assert err.states[u] is RequestState.RUNNING
    assert isinstance(err, RuntimeError)
    assert eng.run_to_completion(max_steps=1, strict=False) == sorted(uids)


def _nan_plan(faults_cls):
    return faults_cls(seed=2, horizon=8, nan_faults=1, inf_faults=0,
                      pressure_windows=0, transient_failures=0,
                      burst_every=0, arrival_lambda=0.0)


def test_guards_quarantine_only_offending_row(fp_model, base_tokens):
    """A NaN injected into ONE slot's decode logits FAILS exactly that
    request, with the reference's diagnostics; the other row finishes
    with the fault-free tokens, bitwise."""
    (fault_step,) = _nan_plan(FaultInjector).logit_faults

    def run(eng):
        uids = eng.add_requests(PROMPTS, max_new_tokens=10)
        eng.run_to_completion()
        fin = eng.take_finished()
        return [fin[u].tokens for u in uids], _outcome(fin, uids)

    got, out = run(_engine(fp_model, guards=True,
                           faults=_nan_plan(FaultInjector)))
    _, jout = run(_jax_engine(fp_model, guards=True,
                              faults=_nan_plan(JaxFaults)))
    assert out == jout
    failed = [i for i, (s, _, _) in enumerate(out) if s == "failed"]
    assert len(failed) == 1
    (f,) = failed
    d = out[f][1]
    assert d["kind"] == "nonfinite_logits" and d["phase"] == "decode"
    assert d["engine_step"] == fault_step and d["nonfinite"] >= 1
    assert got[1 - f] == base_tokens[10][1 - f]
    assert got[f] == base_tokens[10][f][:fault_step + 1]


def test_guard_quarantine_mid_speculation_window(fp_model, base_tokens):
    """A NaN in one slot's verify logits: that request FAILS with phase
    "verify" and its window emits nothing (the slot rolled back, then
    quarantined); the other request's tokens are vanilla's, bitwise.  The
    draft is unrelated (another seed), so windows accept little and the
    run reaches the planned fault step."""
    jcfg, tcfg, _, _ = fp_model
    jp = japi.init_params(jax.random.PRNGKey(99), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")

    def run(eng):
        uids = eng.add_requests(PROMPTS, max_new_tokens=10)
        eng.run_to_completion()
        fin = eng.take_finished()
        return [fin[u].tokens for u in uids], _outcome(fin, uids)

    got, out = run(_engine(fp_model, guards=True, draft_params=tm,
                           spec=SpecConfig(gamma=2),
                           faults=_nan_plan(FaultInjector)))
    _, jout = run(_jax_engine(fp_model, guards=True, draft_params=jp,
                              spec=JaxSpec(gamma=2),
                              faults=_nan_plan(JaxFaults)))
    assert out == jout
    (f,) = [i for i, (s, _, _) in enumerate(out) if s == "failed"]
    assert out[f][1]["phase"] == "verify"
    assert got[1 - f] == base_tokens[10][1 - f]
    assert got[f] == base_tokens[10][f][:len(got[f])]


def test_transient_faults_need_bounded_retry(fp_model, base_tokens):
    def plan():
        return FaultInjector(seed=3, horizon=8, nan_faults=0, inf_faults=0,
                             pressure_windows=0, transient_failures=1,
                             max_consecutive_failures=2, burst_every=0,
                             arrival_lambda=0.0)

    eng = _engine(fp_model, faults=plan())
    uids = eng.add_requests(PROMPTS, max_new_tokens=10)
    with pytest.raises(EngineFault, match="transient") as ei:
        eng.run_to_completion()
    assert ei.value.transient
    before = [list(eng.active[u].tokens) for u in uids]
    eng.run_to_completion(retry=RetryPolicy(max_attempts=3, backoff_s=0.0))
    fin = eng.take_finished()
    got = [fin[u].tokens for u in uids]
    assert [t[:len(b)] for t, b in zip(got, before)] == before
    assert got == base_tokens[10]
    assert all(fin[u].state is RequestState.FINISHED for u in uids)


def test_seeded_fault_plan_replays_exactly(fp_model):
    """The full plan (NaN + Inf + pressure + transient failures) driven
    twice: terminal states, tokens and counters bitwise equal; states,
    diagnostics and counters equal to the JAX engine's."""
    def run(E, F, C, R, **kw):
        inj = F(seed=5, horizon=16, nan_faults=1, inf_faults=1,
                pressure_windows=1, pressure_frac=(0.3, 0.4),
                transient_failures=1, burst_every=0, arrival_lambda=0.0)
        clock = C()
        eng = E(fp_model, guards=True, faults=inj, clock=clock, **kw)
        uids = eng.add_requests(PROMPTS, max_new_tokens=10)
        retry = R(max_attempts=3, backoff_s=0.0)
        for _ in range(60):
            retry.run(eng.step)
            clock.advance()
            if not eng.active and not len(eng.queue):
                break
        fin = eng.take_finished()
        assert sorted(fin) == sorted(uids)
        st = eng.stats()
        return ([fin[u].tokens for u in uids], _outcome(fin, uids),
                st["lifecycle"], st["preemptions"], st["resumes"])

    a = run(_engine, FaultInjector, StepClock, RetryPolicy)
    assert a == run(_engine, FaultInjector, StepClock, RetryPolicy)
    j = run(_jax_engine, JaxFaults, JaxClock, JaxRetry)
    assert a[1:] == j[1:]
    _match(fp_model, PROMPTS, a[0], j[0])
