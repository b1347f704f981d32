"""Port parity for chunked prefill, mirroring tests/test_chunked_prefill.py
(the dense cases; MLA is not ported) on the llama1_7b smoke config (vocab
128, 2 layers, max_len 64, 8-token chunks).  On this CPU the port's
chunked prefill is BITWISE its monolithic prefill — the chunk's logits at
each row's last token and every K/V row written — so chunked tokens equal
monolithic tokens exactly: batched multi-length admission, budget pacing,
paged pools, inside speculation windows, and across a preempt/resume in
the middle of PREFILLING.  Against the JAX engine: tokens under the
near-tie rule, ``stats()["chunked"]`` equal."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.serve import ChunkedPrefillConfig as JaxChunk  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro.serve import SpecConfig as JaxSpec  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve import (AdmissionController,  # noqa: E402
                               ChunkedPrefillConfig,
                               ServingEngine, SLOConfig, SpecConfig,
                               StepClock, StepCostModel)
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402
from test_torch_serving import _assert_tokens_match  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]]
PAGED = dict(kv_layout="paged", page_size=8)


@pytest.fixture(scope="module")
def fp_model():
    jcfg, tcfg = smoke_cfgs()
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tm


def _engine(fp_model, **kw):
    _, tcfg, _, tm = fp_model
    for k, v in dict(n_slots=4, max_len=64, min_bucket=8).items():
        kw.setdefault(k, v)
    return ServingEngine(tm, tcfg, device="cpu", **kw)


def _jax_engine(fp_model, **kw):
    jcfg, _, jp, _ = fp_model
    for k, v in dict(n_slots=4, max_len=64, min_bucket=8,
                     prepare=False).items():
        kw.setdefault(k, v)
    return JaxEngine(jp, jcfg, **kw)


def _serve(eng, prompts, max_new):
    uids = eng.add_requests(prompts, max_new_tokens=max_new)
    eng.run_to_completion()
    fin = eng.take_finished()
    return [fin[u].tokens for u in uids]


@pytest.fixture(scope="module")
def mono(fp_model):
    """Monolithic port tokens of PROMPTS at 6 and 8 new tokens."""
    return {n: _serve(_engine(fp_model), PROMPTS, n) for n in (6, 8)}


# ------------------------------------------------------------------- gates

def test_config_validation():
    with pytest.raises(ValueError):
        ChunkedPrefillConfig(chunk_tokens=0)
    with pytest.raises(ValueError):
        ChunkedPrefillConfig(chunk_tokens=8, budget_tokens=0)


def test_chunk_must_divide_max_len(fp_model):
    with pytest.raises(ValueError, match="divide"):
        _engine(fp_model, n_slots=2, max_len=48, chunked_prefill=10)
    with pytest.raises(ValueError, match="divide"):
        _jax_engine(fp_model, n_slots=2, max_len=48, chunked_prefill=10)


def test_windowed_attention_rejected(fp_model):
    """Ring caches have no linear chunk positions: a hard gate with the
    reference's message, not a fallback to monolithic prefill."""
    _, tcfg, _, tm = fp_model
    wcfg = dataclasses.replace(tcfg, attn_window=16)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(tm, wcfg, n_slots=2, max_len=64, chunked_prefill=8,
                      device="cpu")


# ------------------------------------------------------------------ parity

def test_chunk_logits_and_cache_bitwise_monolithic(fp_model):
    """The primitive under the engine: two 8-token chunks into a fragment
    give the monolithic 16-token prefill's logits (at each row's true last
    token) and K/V rows bit for bit."""
    _, tcfg, _, tm = fp_model
    lens = np.array([len(p) for p in PROMPTS])
    toks = np.zeros((4, 16), np.int64)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    with torch.no_grad():
        lm, cm = tapi.prefill_step(
            tm, tcfg, {"tokens": torch.tensor(toks)},
            tapi.make_cache(tcfg, 4, 64, torch.float32, "cpu"),
            logits_at=torch.tensor(lens - 1))
        cc = tapi.make_cache(tcfg, 4, 64, torch.float32, "cpu")
        rows = {}
        for start in (0, 8):
            lg, cc = tapi.prefill_step(
                tm, tcfg, {"tokens": torch.tensor(toks[:, start:start + 8])},
                cc, logits_at=torch.tensor(np.clip(lens - 1 - start, 0, 7)))
            for i, n in enumerate(lens):
                if start <= n - 1 < start + 8:
                    rows[i] = lg[i]
    assert torch.equal(lm, torch.stack([rows[i] for i in range(4)]))
    for a, b in zip(cm, cc):
        for i, n in enumerate(lens):
            assert torch.equal(a.k[i, :n], b.k[i, :n])
            assert torch.equal(a.v[i, :n], b.v[i, :n])


def test_chunked_matches_monolithic_dense(fp_model, mono):
    """Multi-length batched admission: tokens bitwise the monolithic
    engine's, one chunk shape per batch bucket; tokens and the chunk
    counters equal to the JAX chunked engine's."""
    eng = _engine(fp_model, chunked_prefill=8)
    got = _serve(eng, PROMPTS, 6)
    assert got == mono[6]
    st = eng.stats()["chunked"]
    assert st["chunks_processed"] > 0 and st["prefilling"] == 0
    assert st["chunk_prefill_traces"] <= 3          # floor(log2 4) + 1
    jeng = _jax_engine(fp_model, chunked_prefill=8)
    want = _serve(jeng, PROMPTS, 6)
    assert st == jeng.stats()["chunked"]
    _assert_tokens_match(fp_model[3], fp_model[1], PROMPTS, got, want)


@pytest.mark.parametrize("budget", [8, 40])
def test_chunked_budget_pacing_parity(fp_model, mono, budget):
    """A per-step token budget spreads a group's chunks across steps
    (decode interleaves between them) without changing a token; a budget
    under one chunk still progresses.  Chunk counts equal the
    reference's."""
    cpc = dict(chunk_tokens=8, budget_tokens=budget)
    eng = _engine(fp_model, chunked_prefill=ChunkedPrefillConfig(**cpc))
    assert _serve(eng, PROMPTS, 6) == mono[6]
    jeng = _jax_engine(fp_model, chunked_prefill=JaxChunk(**cpc))
    _serve(jeng, PROMPTS, 6)
    assert eng.stats()["chunked"] == jeng.stats()["chunked"]
    assert eng.engine_steps == jeng.engine_steps


def test_chunked_paged_parity(fp_model):
    """Chunked groups prefill into a contiguous fragment and page in only
    at completion, with pages reserved up front: tokens bitwise the paged
    monolithic engine's, no reservation leak, page counters equal to the
    JAX engine's."""
    eng_m = _engine(fp_model, **PAGED)
    toks_m = _serve(eng_m, PROMPTS, 6)
    eng_c = _engine(fp_model, chunked_prefill=8, **PAGED)
    assert _serve(eng_c, PROMPTS, 6) == toks_m
    st = eng_c.stats()
    assert st["paged"]["pages_in_use"] == eng_m.stats()["paged"]["pages_in_use"]
    jeng = _jax_engine(fp_model, chunked_prefill=8, **PAGED)
    _serve(jeng, PROMPTS, 6)
    jst = jeng.stats()
    for key in ("pages_in_use", "peak_pages_in_use", "pages_allocated_total",
                "registry_entries", "prefix_hits"):
        assert st["paged"][key] == jst["paged"][key], key


def test_chunked_inside_speculative_window(fp_model, mono):
    """Chunked admission while other slots sit mid-window: a chunked
    speculative engine (an unrelated draft) emits the monolithic vanilla
    tokens, and fills the draft's fragment chunk by chunk too."""
    jcfg, tcfg, _, _ = fp_model
    jd = japi.init_params(jax.random.PRNGKey(99), jcfg)
    td = from_numpy_tree(jax_tree_to_numpy(jd), tcfg, device="cpu")
    eng = _engine(fp_model, draft_params=td, spec=SpecConfig(gamma=2),
                  chunked_prefill=8)
    got = _serve(eng, PROMPTS, 8)
    assert got == mono[8]
    st = eng.stats()["chunked"]
    assert st["chunks_processed"] > 0 and st["draft_chunk_prefill_traces"] >= 1
    jeng = _jax_engine(fp_model, draft_params=jd, spec=JaxSpec(gamma=2),
                       chunked_prefill=8)
    want = _serve(jeng, PROMPTS, 8)
    assert st == jeng.stats()["chunked"]
    _assert_tokens_match(fp_model[3], fp_model[1], PROMPTS, got, want)


# -------------------------------------------------- PREFILLING lifecycle

def test_preempt_resume_mid_prefilling(fp_model):
    """Preempting mid-PREFILLING drops fragment progress (the slot row was
    never written), releases the reservation and re-queues at the front;
    the re-run prefill emits the monolithic tokens bitwise."""
    long_a = list(range(1, 25))
    long_b = list(range(30, 52))
    toks_m = _serve(_engine(fp_model, n_slots=2), [long_a, long_b], 6)

    def run(eng):
        uids = eng.add_requests([long_a, long_b], max_new_tokens=6)
        eng.step()                                # one 8-token chunk only
        assert eng.pending_prefills == 2
        g = eng._prefill_groups[0]
        victim = next(r for r in g.live() if r.uid == uids[0])
        assert victim.state.value == "prefilling"
        assert 0 < g.progress < g.target_len
        g.cancel(victim.uid)
        eng._preempt_prefilling(victim, "test-pressure")
        assert victim.state.value == "queued"
        assert victim.slot == -1 and len(eng.queue) == 1
        eng.run_to_completion()
        fin = eng.take_finished()
        assert sorted(eng.free) == [0, 1]
        return ([fin[u].tokens for u in uids], eng.stats()["preemptions"],
                eng.engine_steps)

    got, pre, steps = run(_engine(
        fp_model, n_slots=2, chunked_prefill=ChunkedPrefillConfig(
            chunk_tokens=8, budget_tokens=8)))
    assert got == toks_m and pre >= 1
    _, jpre, jsteps = run(_jax_engine(
        fp_model, n_slots=2, chunked_prefill=JaxChunk(chunk_tokens=8,
                                                      budget_tokens=8)))
    assert (pre, steps) == (jpre, jsteps)


def test_prefilling_is_first_class_state(fp_model):
    cpc = ChunkedPrefillConfig(chunk_tokens=8, budget_tokens=8)
    eng = _engine(fp_model, n_slots=2, chunked_prefill=cpc)
    uid = eng.add_request(list(range(1, 30)), max_new_tokens=4)
    eng.step()
    st = eng.stats()["chunked"]
    assert st["prefilling"] == 1 and st["groups_pending"] == 1
    assert eng.prefill_backlog_tokens > 0
    eng.run_to_completion()
    assert len(eng.take_finished()[uid].tokens) == 4
    assert eng.stats()["chunked"]["prefilling"] == 0


def test_chunking_with_controller_and_cost_model(fp_model, mono):
    """Chunked prefill with the overload controller and the step cost
    model live on the engine: same tokens, a modeled cost per step."""
    ctl = AdmissionController(SLOConfig(ttft_p99_ms=250.0))
    eng = _engine(fp_model, n_slots=3, chunked_prefill=8, controller=ctl,
                  cost_model=StepCostModel(), clock=StepClock(10.0))
    toks = _serve(eng, PROMPTS[:3], 6)
    assert toks == [t for t in mono[6][:3]]
    assert eng.last_step_cost_ms is not None
