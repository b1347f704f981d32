"""Port parity for self-speculative decoding, mirroring
tests/test_speculative.py on the llama1_7b smoke config (vocab 128, 2
layers, 4 slots, max_len 64): the window's units, the span primitive, the
rollback, and the engine — speculative tokens equal the port's vanilla
tokens exactly with an unrelated draft and a self-draft; retirement
inside a window (EOS, budget, full cache).  The CLAQ target/draft pair
(the reference's ``claq_quantize_with_draft``) and its fixtures' tests
are in ``test_torch_speculative_quantized.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro.data import calibration_set  # noqa: E402
from repro.launch.quantize import claq_quantize_with_draft  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro.serve import SpecConfig as JaxSpec  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.serve import ServingEngine, SpecConfig  # noqa: E402
from repro_torch.serve import speculative as tspec  # noqa: E402
from repro_torch.serve.engine import _rollback_tail  # noqa: E402
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402
from test_torch_serving import _assert_tokens_match, _serve  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10],
           [11, 12, 13, 14, 15, 16, 17, 18, 19]]
ENG = dict(n_slots=4, max_len=64, min_bucket=8)


def _to_torch(params, tcfg):
    return from_numpy_tree(jax_tree_to_numpy(params), tcfg, device="cpu")


@pytest.fixture(scope="module")
def fp_model():
    """The reference's random-init fp params and their port, with an
    unrelated draft (another seed: acceptance near zero, so nearly every
    window takes the correction path)."""
    jcfg, tcfg = smoke_cfgs()
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    jd = japi.init_params(jax.random.PRNGKey(99), jcfg)
    return jcfg, tcfg, jp, jd, _to_torch(jp, tcfg), _to_torch(jd, tcfg)


@pytest.fixture(scope="module")
def quantized_pair(fp_model):
    """AP+OR target and flat 2-bit draft from the SAME fp weights and the
    SAME calibration (the reference's ``claq_quantize_with_draft``)."""
    jcfg, tcfg, jp, _, _, _ = fp_model
    qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                      orr=ORConfig(0.1))
    calib = calibration_set(vocab=jcfg.vocab, n_segments=4, seq_len=32)
    (jq, rep), (jdq, drep) = claq_quantize_with_draft(jp, jcfg, calib, qcfg,
                                                      draft_bits=2)
    assert drep.mean_effective_bits < rep.mean_effective_bits
    return jq, jdq


def _port_pair(quantized_pair, tcfg):
    """Fresh port modules of the pair (engines prepare plans in place)."""
    jq, jdq = quantized_pair
    return _to_torch(jq, tcfg), _to_torch(jdq, tcfg)


# ------------------------------------------------------------------ units

def test_spec_config_validation():
    assert SpecConfig().gamma == 4 and SpecConfig().draft_bits == 2
    with pytest.raises(ValueError, match="gamma"):
        SpecConfig(gamma=0)
    with pytest.raises(ValueError, match="draft_bits"):
        SpecConfig(gamma=2, draft_bits=0)


def test_accept_greedy_units():
    assert tspec.accept_greedy([5, 6, 7], [5, 6, 7, 8]) == (3, [5, 6, 7, 8])
    assert tspec.accept_greedy([5, 9, 7], [5, 6, 7, 8]) == (1, [5, 6])
    assert tspec.accept_greedy([5, 6], [4, 6, 7]) == (0, [4])
    with pytest.raises(ValueError, match="gamma"):
        tspec.accept_greedy([1, 2], [1, 2])
    # numpy rows (what the engine passes) give Python ints
    k, toks = tspec.accept_greedy(np.array([3, 4]), np.array([3, 5, 6]))
    assert (k, toks) == (1, [3, 5]) and all(type(t) is int for t in toks)


def test_window_summary_matches_reference():
    from repro.serve.speculative import window_summary as jsum
    for acc in ([0, 1, 4, 4], [], [2]):
        assert tspec.window_summary(4, acc) == jsum(4, acc)


def test_select_logits_span_positions():
    logits = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    assert torch.equal(tL.select_logits(logits), logits[:, -1])
    assert torch.equal(tL.select_logits(logits, torch.tensor([1, 3])),
                       torch.stack([logits[0, 1], logits[1, 3]]))
    got = tL.select_logits(logits, torch.tensor([[1, 3], [0, 4]]))
    assert got.shape == (2, 2, 3)
    assert torch.equal(got[0, 0], logits[0, 1])
    assert torch.equal(got[0, 1], logits[0, 3])
    assert torch.equal(got[1, 0], logits[1, 0])
    assert torch.equal(got[1, 1], logits[1, 4])


def test_rollback_tail_masks_and_rewinds():
    L_, B, S, KH, D = 2, 3, 8, 2, 4
    cfg = dataclasses.replace(t_smoke("llama1_7b"), n_layers=L_,
                              n_kv_heads=KH, head_dim=D)
    cache = tapi.make_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    for c in cache:
        c.k.fill_(1.0)
        c.v.fill_(1.0)
    rb = _rollback_tail(cache, np.array([0, 3, 8]))
    for c in rb:
        assert c.length.tolist() == [0, 3, 8]
        for b, n in enumerate([0, 3, 8]):
            assert torch.all(c.k[b, :n] == 1.0) and torch.all(c.v[b, :n] == 1)
            assert torch.all(c.k[b, n:] == 0.0) and torch.all(c.v[b, n:] == 0)


def _clone(cache):
    """A deep copy of a port cache (a paged cache's layers keep sharing
    one table)."""
    if isinstance(cache[0], tL.KVCache):
        return [tL.KVCache(c.k.clone(), c.v.clone(), c.length.clone())
                for c in cache]
    table = cache[0].table.clone()
    return [c._replace(kp=c.kp.clone(), vp=c.vp.clone(), table=table,
                       length=c.length.clone(),
                       k_scale=None if c.k_scale is None else c.k_scale.clone(),
                       v_scale=None if c.v_scale is None else c.v_scale.clone())
            for c in cache]


def _admitted(tm, tcfg, **kw):
    """An engine with three staggered requests admitted (bucketed)."""
    eng = ServingEngine(tm, tcfg, n_slots=3, max_len=32, min_bucket=4,
                        device="cpu", **kw)
    eng.add_requests([[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11]],
                     max_new_tokens=8)
    if eng._paged:
        eng._ensure_capacity(4)
        eng._sync_tables()
    return eng


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_rollback_leaves_the_cache_that_never_saw_the_tail(fp_model, layout):
    """A γ+1 span, then a rollback to the fill before it: a contiguous
    cache is bit for bit the cache that never saw the span; a paged one
    rewinds its fill counters and its view at every valid position."""
    _, tcfg, _, _, tm, _ = fp_model
    kw = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    eng = _admitted(tm, tcfg, **kw)
    before = _clone(eng.cache)
    lens = before[0].length.numpy().copy()
    span = torch.as_tensor(np.random.default_rng(1).integers(
        1, tcfg.vocab, size=(3, 5)))
    with torch.no_grad():
        _, after = tapi.decode_span(eng.params, tcfg, span, eng.cache)
    assert after[0].length.tolist() == (lens + 5).tolist()
    rb = _rollback_tail(after, lens)
    for a, b in zip(rb, before):
        assert torch.equal(a.length, b.length)
        if layout == "contiguous":
            assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
        else:
            for pa, pb in ((a.kp, b.kp), (a.vp, b.vp)):
                va = tL.pool_view(pa, None, a.table, pa.dtype)
                vb = tL.pool_view(pb, None, b.table, pb.dtype)
                for s, n in enumerate(lens):
                    assert torch.equal(va[s, :n], vb[s, :n])


# ------------------------------------------------------------- family gate

def test_speculation_gated_to_rollbackable_families(fp_model):
    _, tcfg, _, _, tm, _ = fp_model
    for arch, msg in (("rwkv6_7b", "recurrent state"),
                      ("zamba2_1p2b", "recurrent state"),
                      ("qwen3_moe_30b_a3b", "router")):
        with pytest.raises(NotImplementedError, match=msg):
            tspec.validate_spec_support(t_smoke(arch))
    wcfg = dataclasses.replace(tcfg, attn_window=16)
    with pytest.raises(NotImplementedError, match="ring"):
        tspec.validate_spec_support(wcfg)
    with pytest.raises(NotImplementedError, match="ring"):
        ServingEngine(tm, wcfg, n_slots=2, max_len=64, device="cpu",
                      draft_params=tm, spec=SpecConfig(gamma=2))
    with pytest.raises(ValueError, match="draft_params"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu",
                      spec=SpecConfig(gamma=2))
    with pytest.raises(ValueError, match="spec"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu",
                      draft_params=tm)
    with pytest.raises(ValueError, match="draft_plan_bn"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu",
                      draft_plan_bn=32)
    with pytest.raises(ValueError, match="prepare=False"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=64, device="cpu",
                      prepare=False, draft_params=tm,
                      spec=SpecConfig(gamma=2), draft_plan_bk=64)


def test_decode_span_rejects_unsupported_configs(fp_model):
    _, tcfg, _, _, tm, _ = fp_model
    toks = torch.zeros((2, 3), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="recurrent"):
        tapi.decode_span(None, t_smoke("rwkv6_7b"), toks, None)
    with pytest.raises(NotImplementedError, match="router"):
        tapi.decode_span(None, t_smoke("qwen3_moe_30b_a3b"), toks, None)
    with pytest.raises(NotImplementedError, match="ring"):
        tapi.decode_span(tm, dataclasses.replace(tcfg, attn_window=16), toks,
                         None)


# ----------------------------------------------------- span decode primitive

@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged_int8"])
@pytest.mark.parametrize("model", ["fp", "claq"])
def test_decode_span_bitwise_matches_successive_decodes(fp_model,
                                                        quantized_pair,
                                                        layout, model):
    """The verify primitive: one span call == γ+1 successive port decode
    steps, logits and caches bit for bit, at per-slot fill levels
    (staggered by bucketed admission), on both layouts."""
    _, tcfg, _, _, tm, _ = fp_model
    if model == "claq":
        tm, _ = _port_pair(quantized_pair, tcfg)
    kw = {"contiguous": {},
          "paged": dict(kv_layout="paged", page_size=8),
          "paged_int8": dict(kv_layout="paged", page_size=8,
                             kv_dtype="int8")}[layout]
    eng = _admitted(tm, tcfg, **kw)
    span = torch.as_tensor(np.random.default_rng(0).integers(
        1, tcfg.vocab, size=(3, 4)))
    c1, c2 = _clone(eng.cache), _clone(eng.cache)
    outs = []
    with torch.no_grad():
        for j in range(span.shape[1]):
            lg, c1 = tapi.decode_step(eng.params, tcfg, span[:, j], c1)
            outs.append(lg)
        got, c2 = tapi.decode_span(eng.params, tcfg, span, c2)
    assert torch.equal(got, torch.stack(outs, dim=1))
    for a, b in zip(c1, c2):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


def test_decode_span_matches_reference(fp_model):
    """decode_span logits against the reference's on the same admitted
    caches (f32 sums in another order: atol 1e-4, as the model tests)."""
    jcfg, tcfg, jp, _, tm, _ = fp_model
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11]]
    jeng = JaxEngine(jp, jcfg, n_slots=3, max_len=32, min_bucket=4,
                     prepare=False)
    jeng.add_requests(prompts, max_new_tokens=8)
    eng = _admitted(tm, tcfg)
    span = np.random.default_rng(0).integers(1, tcfg.vocab, size=(3, 4))
    want, _ = japi.decode_span(jp, jcfg, jnp.asarray(span, jnp.int32),
                               jeng.cache)
    with torch.no_grad():
        got, _ = tapi.decode_span(eng.params, tcfg, torch.as_tensor(span),
                                  eng.cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_span_write_past_the_cache_end_is_dropped(fp_model):
    """A span that runs past max_len drops its out-of-range rows (the
    reference's mode="drop"): the last real K/V row of the slot survives,
    where clamping would overwrite it."""
    _, tcfg, _, _, tm, _ = fp_model
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=16, device="cpu")
    eng.add_requests([list(range(1, 15)), [1, 2]], max_new_tokens=2)
    before = _clone(eng.cache)
    span = torch.as_tensor([[5, 6, 7, 8], [9, 10, 11, 12]])
    with torch.no_grad():
        _, after = tapi.decode_span(eng.params, tcfg, span, eng.cache)
        # slot 0 holds 14 rows: span rows 0 and 1 land at 14 and 15, rows
        # 2 and 3 fall past the end; the same two tokens decoded one by
        # one write rows 14 and 15 alone
        ref = _clone(before)
        for j in range(2):
            _, ref = tapi.decode_step(eng.params, tcfg, span[:, j], ref)
    for a, r, b in zip(after, ref, before):
        assert torch.equal(a.k[0], r.k[0]) and torch.equal(a.v[0], r.v[0])
        assert torch.equal(a.k[0, :14], b.k[0, :14])


# ------------------------------------------------------------ losslessness


def test_spec_lossless_with_unrelated_draft(fp_model):
    """Tokens never depend on the draft: an unrelated draft rejects
    nearly every window, yet the stream equals vanilla's and the JAX
    engine's."""
    jcfg, tcfg, jp, jd, tm, td = fp_model
    toks_v = _serve(ServingEngine(tm, tcfg, device="cpu", **ENG), PROMPTS,
                    max_new=7)
    eng = ServingEngine(tm, tcfg, device="cpu", draft_params=td,
                        spec=SpecConfig(gamma=3), **ENG)
    toks_s = _serve(eng, PROMPTS, max_new=7)
    assert toks_s == toks_v
    st = eng.stats()
    assert st["acceptance_rate"] < 0.5
    assert st["tokens_per_step"] >= 1.0
    want = _serve(JaxEngine(jp, jcfg, prepare=False, draft_params=jd,
                            spec=JaxSpec(gamma=3), **ENG), PROMPTS, max_new=7)
    _assert_tokens_match(tm, tcfg, PROMPTS, toks_s, want)


def test_spec_self_draft_accepts_everything(fp_model):
    """draft == target: every draft token verifies, so every window emits
    γ+1 tokens and acceptance is exactly 1.0."""
    _, tcfg, _, _, tm, _ = fp_model
    gamma = 2
    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=64, min_bucket=8,
                        device="cpu", draft_params=tm,
                        spec=SpecConfig(gamma=gamma))
    (toks,) = _serve(eng, [[1, 2, 3]], max_new=1 + 2 * (gamma + 1))
    st = eng.stats()
    assert st["acceptance_rate"] == 1.0
    assert st["engine_steps"] == 2
    assert st["tokens_per_step"] == gamma + 1
    (van,) = _serve(ServingEngine(tm, tcfg, n_slots=2, max_len=64,
                                  min_bucket=8, device="cpu"), [[1, 2, 3]],
                    max_new=1 + 2 * (gamma + 1))
    assert toks == van


# ------------------------------------------------- retirement inside windows

def test_eos_mid_window_retires_at_exact_token(fp_model):
    """EOS inside a window retires the request at exactly that token; the
    accepted tokens past it are rolled back, never emitted."""
    jcfg, tcfg, jp, jd, tm, td = fp_model
    base = _serve(ServingEngine(tm, tcfg, device="cpu", **ENG), PROMPTS,
                  max_new=8)
    eos = base[1][3]
    toks_v = _serve(ServingEngine(tm, tcfg, device="cpu", **ENG), PROMPTS,
                    max_new=8, eos_id=eos)
    toks_s = _serve(ServingEngine(tm, tcfg, device="cpu", draft_params=td,
                                  spec=SpecConfig(gamma=4), **ENG),
                    PROMPTS, max_new=8, eos_id=eos)
    assert toks_s == toks_v
    assert toks_s[1][-1] == eos and len(toks_s[1]) <= 4
    assert eos not in toks_s[1][:-1]
    want = _serve(JaxEngine(jp, jcfg, prepare=False, draft_params=jd,
                            spec=JaxSpec(gamma=4), **ENG), PROMPTS,
                  max_new=8, eos_id=eos)
    _assert_tokens_match(tm, tcfg, PROMPTS, toks_s, want)


@pytest.mark.parametrize("max_new", [2, 4, 5])
def test_budget_exhausted_mid_window(fp_model, max_new):
    """A budget that is not window-aligned stops at exactly the budget."""
    _, tcfg, _, _, tm, td = fp_model
    toks_v = _serve(ServingEngine(tm, tcfg, device="cpu", **ENG), PROMPTS,
                    max_new=max_new)
    toks_s = _serve(ServingEngine(tm, tcfg, device="cpu", draft_params=td,
                                  spec=SpecConfig(gamma=3), **ENG),
                    PROMPTS, max_new=max_new)
    assert toks_s == toks_v
    assert all(len(t) == max_new for t in toks_s)


def test_cache_full_truncates_mid_window(fp_model):
    """A budget grown past the slot cache retires TRUNCATED at exactly
    vanilla's token count: the span's out-of-range writes are dropped,
    never clamped onto the last real row."""
    _, tcfg, _, _, tm, td = fp_model
    counts = []
    for spec, draft in ((None, None), (SpecConfig(gamma=4), td)):
        eng = ServingEngine(tm, tcfg, n_slots=2, max_len=16, device="cpu",
                            draft_params=draft, spec=spec)
        uid = eng.add_request(list(range(1, 9)), max_new_tokens=8)
        eng.active[uid].max_new_tokens = 100
        eng.run_to_completion()
        req = eng.take_finished()[uid]
        assert req.done and req.truncated
        counts.append(req.tokens)
    assert counts[0] == counts[1]
    assert len(counts[0]) == 16 - 8 + 1


def test_slot_reuse_and_constant_shapes_across_waves(fp_model):
    """Waves of admissions through 2 slots: speculation keeps one
    draft-decode and one verify shape however many windows run, prefill
    shapes stay inside the bucket bound, and slots are reused cleanly
    (tokens equal a vanilla engine's driven the same way)."""
    _, tcfg, _, _, tm, td = fp_model

    def drive(eng):
        pending = [[i + 1, i + 2, i + 3] for i in range(6)]
        admitted = []
        while pending or eng.active:
            if pending and eng.free:
                batch = [pending.pop(0)
                         for _ in range(min(len(pending), len(eng.free)))]
                admitted += eng.add_requests(batch, max_new_tokens=5)
            eng.step()
        fin = eng.take_finished()
        assert sorted(fin) == sorted(admitted) and len(fin) == 6
        assert all(r.done and len(r.tokens) == 5 for r in fin.values())
        assert sorted(eng.free) == [0, 1]
        return [fin[u].tokens for u in admitted]

    eng = ServingEngine(tm, tcfg, n_slots=2, max_len=64, min_bucket=8,
                        device="cpu", draft_params=td,
                        spec=SpecConfig(gamma=2))
    got = drive(eng)
    st = eng.stats()
    assert st["verify_traces"] == 1 and st["draft_decode_traces"] == 1
    assert st["prefill_traces"] <= eng.bucketing.max_traces() * 2
    assert st["engine_steps"] > 2
    assert got == drive(ServingEngine(tm, tcfg, n_slots=2, max_len=64,
                                      min_bucket=8, device="cpu"))


# ------------------------------------------------- one calibration, two codes
