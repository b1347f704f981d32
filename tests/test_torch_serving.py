"""Port parity for the serving engine: ``repro_torch.serve.ServingEngine``
against the reference ``repro.serve.ServingEngine`` on the same AP+OR
CLAQ params (llama1_7b smoke config), mirroring tests/test_serving.py:
greedy tokens equal wherever the top-2 logit gap exceeds the logit
tolerance, bucketed == unbucketed, the prefill-shape bound, EOS at
prefill, one-token budgets, slot reuse and cache-full truncation."""
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from test_torch_models import (jax_tree_to_numpy, quantize_reference,  # noqa: E402
                               smoke_cfgs)

jax.config.update("jax_platform_name", "cpu")

# Logit tolerance of the cross-framework token comparison: f32 sums in
# another order through a whole prompt + decode history; a divergence is
# accepted only where the two best logits lie closer than this.
LOGIT_TOL = 1e-3


@pytest.fixture(scope="module")
def quantized():
    jcfg, tcfg = smoke_cfgs()
    qparams = quantize_reference(japi.init_params(jax.random.PRNGKey(0),
                                                  jcfg), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(qparams), tcfg, device="cpu")
    return jcfg, tcfg, qparams, tm


def _serve(eng, prompts, max_new, eos_id=None):
    uids = eng.add_requests(prompts, max_new_tokens=max_new, eos_id=eos_id)
    eng.run_to_completion()
    fin = eng.take_finished()
    return [fin[u].tokens for u in uids]


def _assert_tokens_match(tm, tcfg, prompts, got, want):
    """Equal tokens, except after a position where the model's top-2 logits
    are a near tie (there the frameworks may legitimately pick apart)."""
    for prompt, g, w in zip(prompts, got, want):
        if g == w:
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        seq = torch.tensor([list(prompt) + g[:j]])
        logits, _, _ = tapi.tf.forward(tm, tcfg, seq)
        top2 = torch.topk(logits[0, -1], 2).values
        assert float(top2[0] - top2[1]) < LOGIT_TOL, (prompt, g, w)


def test_tokens_match_reference_engine_bucketed_and_not(quantized):
    jcfg, tcfg, qparams, tm = quantized
    prompts = [[1, 2], [3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15, 16],
               [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32]]
    want = _serve(JaxEngine(qparams, jcfg, n_slots=4, max_len=64,
                            min_bucket=8), prompts, max_new=6)
    eng_b = ServingEngine(tm, tcfg, n_slots=4, max_len=64, min_bucket=8,
                          device="cpu")
    toks_b = _serve(eng_b, prompts, max_new=6)
    eng_u = ServingEngine(tm, tcfg, n_slots=4, max_len=64, bucketing=False,
                          device="cpu")
    toks_u = _serve(eng_u, prompts, max_new=6)
    assert toks_b == toks_u
    assert all(len(t) == 6 for t in toks_b)
    assert eng_b.prefill_traces < eng_u.prefill_traces
    _assert_tokens_match(tm, tcfg, prompts, toks_b, want)


def test_prefill_shapes_bounded_by_buckets(quantized):
    _, tcfg, _, tm = quantized
    lengths = [1, 3, 7, 9, 20, 40, 63]
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=64, min_bucket=8,
                        device="cpu")
    for n in lengths:
        eng.add_request(list(range(1, n + 1)), max_new_tokens=1)
    bound = math.ceil(math.log2(64 / 8)) + 1
    assert eng.bucketing.max_traces() == bound
    assert eng.prefill_traces <= bound
    assert eng.stats()["bucket_misses"] == eng.prefill_traces
    eng2 = ServingEngine(tm, tcfg, n_slots=2, max_len=64, bucketing=False,
                         device="cpu")
    for n in lengths:
        eng2.add_request(list(range(1, n + 1)), max_new_tokens=1)
    assert eng2.prefill_traces == len(lengths) > eng.prefill_traces


def test_eos_at_prefill_retires_at_admission(quantized):
    jcfg, tcfg, qparams, tm = quantized
    prompt = [5, 6, 7]
    logits, _ = japi.prefill_step(
        qparams, jcfg, {"tokens": jnp.asarray([prompt], jnp.int32)},
        japi.make_cache(jcfg, 1, 64, dtype=jnp.float32))
    first = int(jnp.argmax(logits[0]))
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu")
    uid = eng.add_request(prompt, max_new_tokens=8, eos_id=first)
    assert uid not in eng.active and eng.finished[uid].done
    assert eng.finished[uid].tokens == [first]
    assert len(eng.free) == 2
    assert eng.step() == {}


def test_max_new_tokens_one_emits_exactly_one(quantized):
    _, tcfg, _, tm = quantized
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu")
    uid = eng.add_request([1, 2, 3, 4], max_new_tokens=1)
    assert uid in eng.finished and len(eng.finished[uid].tokens) == 1
    (toks,) = _serve(eng, [[1, 2, 3, 4]], max_new=2)
    assert len(toks) == 2


def test_slot_reuse_matches_reference(quantized):
    jcfg, tcfg, qparams, tm = quantized

    def drive(eng):
        pending = [[i + 1, i + 2] for i in range(6)]  # 6 requests, 2 slots
        order = []
        while pending or eng.active:
            if pending and eng.free:
                batch = [pending.pop(0)
                         for _ in range(min(len(pending), len(eng.free)))]
                order += eng.add_requests(batch, max_new_tokens=3)
            eng.step()
        fin = eng.take_finished()
        assert sorted(fin) == sorted(order) and len(fin) == 6
        assert all(r.done and len(r.tokens) == 3 for r in fin.values())
        assert sorted(eng.free) == [0, 1]
        return [fin[u].tokens for u in order]

    got = drive(ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu"))
    want = drive(JaxEngine(qparams, jcfg, n_slots=2, max_len=64))
    _assert_tokens_match(tm, tcfg, [[i + 1, i + 2] for i in range(6)], got,
                         want)


def test_admission_rejects_overflow_and_cache_full_truncates(quantized):
    _, tcfg, _, tm = quantized
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(list(range(1, 10)), max_new_tokens=8)   # 9 + 8 > 16
    assert not eng.active and len(eng.free) == 2
    uid = eng.add_request(list(range(1, 9)), max_new_tokens=8)  # fits exactly
    eng.run_to_completion()
    req = eng.take_finished()[uid]
    assert len(req.tokens) == 8 and not req.truncated
    # a budget grown mid-flight: the full slot cache retires it TRUNCATED
    uid = eng.add_request(list(range(1, 9)), max_new_tokens=8)
    eng.active[uid].max_new_tokens = 100
    eng.run_to_completion()
    req = eng.take_finished()[uid]
    assert req.done and req.truncated
    assert len(req.tokens) == 16 - 8 + 1
    assert len(eng.free) == 2


def test_run_to_completion_surfaces_unfinished_work(quantized):
    _, tcfg, _, tm = quantized
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu")
    uid = eng.add_request([1, 2, 3], max_new_tokens=32)
    with pytest.raises(RuntimeError, match="max_steps"):
        eng.run_to_completion(max_steps=3)
    assert eng.run_to_completion(max_steps=2, strict=False) == [uid]
    assert eng.run_to_completion() == []


def test_engine_knobs_not_ported_are_rejected(quantized):
    """A mesh is accepted (``mesh=None`` here; multi-rank meshes in
    ``test_torch_dist_serving.py``): the mesh check admits every family
    on a multi-rank mesh, a pod axis too, and refuses another mesh dim;
    the engine refuses encdec (decoder-only families) with a mesh as
    without; the control plane's knobs and the contract gate are
    accepted."""
    _, tcfg, _, tm = quantized
    mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    ed_cfg = t_smoke("seamless_m4t_medium")
    assert ServingEngine._check_mesh(mesh, ed_cfg) == 2
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServingEngine(tapi.init_params(torch.Generator().manual_seed(0),
                                       ed_cfg, "cpu"), ed_cfg, n_slots=2,
                      max_len=16, device="cpu", mesh=mesh)
    assert ServingEngine._check_mesh(mesh, t_smoke("rwkv6_7b")) == 2
    assert ServingEngine._check_mesh(SimpleNamespace(shape={
        "pod": 2, "data": 1, "model": 2}), tcfg) == 4
    with pytest.raises(NotImplementedError, match="mesh dims"):
        ServingEngine._check_mesh(SimpleNamespace(shape={
            "replica": 2, "model": 2}), tcfg)
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=16, device="cpu",
                        guards=True, on_pressure="truncate",
                        chunked_prefill=8, telemetry=None, queue_depth=4,
                        verify_contracts=True, mesh=None)
    assert eng.stats()["mesh"] is None
    assert eng.contract_report.clean
    assert eng.guards and eng.on_pressure == "truncate"
    assert eng.chunked.chunk_tokens == 8 and eng.queue.depth == 4
