"""Port parity for the paged KV cache, mirroring tests/test_paged_serving.py
on the llama1_7b smoke config (vocab 128, 2 layers, 4 slots, max_len 64,
page_size 8): paged fp decode logits bit for bit the contiguous ones;
paged tokens, page tables, allocator and registry state equal to the JAX
paged engine's; int8 pages (the pool bitwise the reference's, budgets
kept, under 1/3 of fp's bytes); prefix sharing with copy-on-write;
all-or-nothing admission under ``PoolExhausted``; decode-time exhaustion
retiring TRUNCATED with ``pool_exhausted`` diagnostics under
``on_pressure="truncate"`` and preempting (then resuming) under the
default ``"preempt"``, both as the reference does; config validation; the
``stats()["paged"]`` keys; and speculation on paged caches."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro.serve import SpecConfig as JaxSpec  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.serve import (PoolExhausted, RequestState,  # noqa: E402
                               ServingEngine, SpecConfig)
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402
from test_torch_serving import _assert_tokens_match  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PROMPTS = [list(range(1, n + 1)) for n in (5, 9, 17, 3)]
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


def _drain(eng, prompts, max_new=8, batch=True):
    if batch:
        uids = eng.add_requests(prompts, max_new_tokens=max_new)
    else:
        uids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    eng.run_to_completion()
    fin = eng.take_finished()
    return [fin[u].tokens for u in uids]


# ------------------------------------------------------------ bitwise parity

def test_paged_decode_logits_bitwise_equal_contiguous(fp_model):
    """Raw decode logits, not just tokens, bit for bit after bucketed
    admission of mixed prompt lengths, over several decode steps."""
    _, tcfg, _, _ = fp_model
    eng_c = _engine(fp_model)
    eng_p = _engine(fp_model, **PAGED)
    for eng in (eng_c, eng_p):
        eng.add_requests(PROMPTS, max_new_tokens=8)
    with torch.no_grad():
        for _ in range(5):
            eng_p._ensure_capacity(1)
            eng_p._sync_tables()
            toks = torch.as_tensor(eng_c.last_token)
            lc, eng_c.cache = tapi.decode_step(eng_c.params, tcfg, toks,
                                               eng_c.cache)
            lp, eng_p.cache = tapi.decode_step(eng_p.params, tcfg, toks,
                                               eng_p.cache)
            assert torch.equal(lc, lp)
            nxt = lc.argmax(-1).numpy()
            for eng in (eng_c, eng_p):
                for r in eng.active.values():
                    r.tokens.append(int(nxt[r.slot]))
                eng.last_token[:] = nxt


def test_paged_tokens_and_tables_equal_reference(fp_model):
    """Bucketed paged serving: tokens equal the contiguous port engine's
    and the JAX paged engine's; the page tables, the pages each request
    holds and the allocator's free list equal the reference's after
    admission, mid-run and at the end."""
    base = _drain(_engine(fp_model), PROMPTS)
    eng, jeng = _engine(fp_model, **PAGED), _jax_engine(fp_model, **PAGED)
    uids = eng.add_requests(PROMPTS, max_new_tokens=8)
    juids = jeng.add_requests(PROMPTS, max_new_tokens=8)

    def same_state():
        np.testing.assert_array_equal(eng._tables, jeng._tables)
        assert eng._req_pages == jeng._req_pages
        assert list(eng.allocator._free) == list(jeng.allocator._free)
        assert eng.allocator._refs == jeng.allocator._refs

    same_state()
    for _ in range(3):
        eng.step()
        jeng.step()
        same_state()
    eng.run_to_completion()
    jeng.run_to_completion()
    same_state()
    fin, jfin = eng.take_finished(), jeng.take_finished()
    got = [fin[u].tokens for u in uids]
    assert got == base
    _assert_tokens_match(fp_model[3], fp_model[1], PROMPTS, got,
                         [jfin[u].tokens for u in juids])
    for key in ("pages_in_use", "peak_pages_in_use",
                "peak_pages_per_request", "pages_allocated_total",
                "pages_freed_total", "registry_entries", "prefix_hits"):
        assert eng.stats()["paged"][key] == jeng.stats()["paged"][key], key


# ------------------------------------------------------------------ int8 pages

def test_int8_pool_write_bitwise_reference_and_error_bound():
    """Quantize-to-page then gather-dequant: the int8 pool and its scales
    equal the reference's bit for bit, and the error per element is at
    most scale/2 (scale = per-token-row absmax / 127)."""
    rng = np.random.default_rng(0)
    B, ps, KH, D = 2, 8, 2, 16
    rows = (rng.normal(size=(B, ps, KH, D)) * 3).astype(np.float32)
    jc = jL.init_paged_kv_cache(B, 32, KH, D, page_size=ps, n_pages=B * 4,
                                dtype=jnp.float32, kv_dtype="int8")
    tc = tL.init_paged_kv_cache(B, 32, KH, D, page_size=ps, n_pages=B * 4,
                                dtype=torch.float32, kv_dtype="int8")
    jpid, joff = jL.paged_write_ids(jc.table.at[:, 0].set(jnp.arange(B)),
                                    jnp.zeros((B,), jnp.int32), ps, ps,
                                    jc.kp.shape[0] - 1)
    tc.table[:, 0] = torch.arange(B)
    pid, off = tL.paged_write_ids(tc.table, torch.zeros(B, dtype=torch.int32),
                                  ps, ps, tc.kp.shape[0] - 1)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    jkp, jks = jL.pool_write(jc.kp, jc.k_scale, jpid, joff, jnp.asarray(rows))
    tL.pool_write(tc.kp, tc.k_scale, pid, off, torch.from_numpy(rows))
    assert tc.kp.dtype == torch.int8 and tc.k_scale.dtype == torch.float32
    np.testing.assert_array_equal(tc.kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jks))
    got = tL.pool_view(tc.kp, tc.k_scale, torch.arange(B)[:, None],
                       torch.float32).numpy().reshape(B, ps, KH, D)
    want = np.asarray(jL.pool_view(jkp, jks, jnp.arange(B)[:, None],
                                   jnp.float32)).reshape(B, ps, KH, D)
    np.testing.assert_array_equal(got, want)
    scale = np.abs(rows.reshape(B, ps, -1)).max(-1) / 127.0
    err = np.abs(got - rows).reshape(B, ps, -1).max(-1)
    assert np.all(err <= scale / 2 + 1e-7)


def test_paged_write_ids_route_past_the_end_and_unallocated_to_scratch():
    table = torch.tensor([[3, 5, 9], [1, 9, 9]])
    pid, off = tL.paged_write_ids(table, torch.tensor([6, 3], dtype=torch.int32),
                                  4, 4, scratch=9)
    # slot 0: positions 6..9 -> blocks 1, 1, 2, 2 (block 2 unallocated)
    assert pid.tolist() == [[5, 5, 9, 9], [1, 9, 9, 9]]
    assert off.tolist() == [[2, 3, 0, 1], [3, 0, 1, 2]]
    # slot 1 position 12 lies past max_len = 12: scratch, not block 2
    pid, _ = tL.paged_write_ids(table, torch.tensor([0, 11],
                                                    dtype=torch.int32),
                                2, 4, scratch=9)
    assert pid[1].tolist() == [9, 9]


def test_int8_serving_within_budget_at_a_third_of_the_bytes(fp_model):
    """int8 pages serve end to end within every budget, report their
    dtype and under 1/3 of the fp pool's bytes per page, and emit the JAX
    int8 paged engine's tokens (near-tie rule)."""
    eng = _engine(fp_model, **PAGED, kv_dtype="int8")
    toks = _drain(eng, PROMPTS)
    assert [len(t) for t in toks] == [8, 8, 8, 8]
    st = eng.stats()["paged"]
    assert st["kv_dtype"] == "int8"
    fp = _engine(fp_model, **PAGED).stats()["paged"]
    assert st["bytes_per_page"] < fp["bytes_per_page"] / 3
    jst = _jax_engine(fp_model, **PAGED, kv_dtype="int8").stats()["paged"]
    assert st["bytes_per_page"] == jst["bytes_per_page"]
    want = _drain(_jax_engine(fp_model, **PAGED, kv_dtype="int8"), PROMPTS)
    _assert_tokens_match(fp_model[3], fp_model[1], PROMPTS, toks, want)


# -------------------------------------------------------------- prefix sharing

def test_prefix_sharing_parity_and_page_savings(fp_model):
    sys_p = list(range(1, 25))
    prompts = [sys_p + [30 + i] for i in range(4)]
    base = _drain(_engine(fp_model), prompts, max_new=6, batch=False)
    shared = _engine(fp_model, **PAGED)
    assert _drain(shared, prompts, max_new=6, batch=False) == base
    private = _engine(fp_model, **PAGED, share_prefixes=False)
    assert _drain(private, prompts, max_new=6, batch=False) == base
    ss, sp = shared.stats()["paged"], private.stats()["paged"]
    assert ss["prefix_hits"] == 3
    assert ss["prefix_shared_tokens"] == 3 * 24
    assert ss["cow_copies"] >= 1
    assert sp["cow_copies"] == 0 and sp["prefix_hits"] == 0
    assert ss["peak_pages_in_use"] < sp["peak_pages_in_use"]
    jeng = _jax_engine(fp_model, **PAGED)
    _drain(jeng, prompts, max_new=6, batch=False)
    js = jeng.stats()["paged"]
    for key in ("prefix_hits", "prefix_shared_tokens", "cow_copies",
                "peak_pages_in_use", "page_evictions", "registry_entries"):
        assert ss[key] == js[key], key


def test_exact_prompt_share_copies_on_write(fp_model):
    """Two identical prompts: the second shares every page, including the
    partial last one; the first decode write into that page copies it for
    each writer (the registry keeps a reference too), as in the
    reference."""
    base = _drain(_engine(fp_model), [PROMPTS[1]] * 2, max_new=6,
                  batch=False)
    eng = _engine(fp_model, **PAGED)
    assert _drain(eng, [PROMPTS[1]] * 2, max_new=6, batch=False) == base
    st = eng.stats()["paged"]
    assert st["prefix_hits"] == 1 and st["prefix_shared_tokens"] == 9
    assert st["cow_copies"] == 2
    jeng = _jax_engine(fp_model, **PAGED)
    _drain(jeng, [PROMPTS[1]] * 2, max_new=6, batch=False)
    assert jeng.stats()["paged"]["cow_copies"] == 2


# ----------------------------------------------------------- pool backpressure

def test_pool_exhaustion_at_admission_admits_nothing(fp_model):
    eng = _engine(fp_model, **PAGED, kv_pages=6)
    with pytest.raises(PoolExhausted):
        eng.add_requests([list(range(1, 30))] * 4, max_new_tokens=4)
    assert eng.allocator.pages_in_use == 0 and not eng.active
    assert len(eng.free) == 4 and not eng._req_pages
    # the engine still serves what fits
    assert len(_drain(eng, [list(range(1, 30))], max_new=4)[0]) == 4


def test_decode_time_exhaustion_retires_truncated_like_reference(fp_model):
    """Running requests outgrow a pool with nothing left to evict: the
    starved request retires TRUNCATED with pool diagnostics, as the
    reference does under on_pressure="truncate" — same states, same
    tokens."""
    prompts = [list(range(1, 14)), list(range(1, 14))]
    eng = _engine(fp_model, **PAGED, kv_pages=4, n_slots=2,
                  on_pressure="truncate")
    uids = eng.add_requests(prompts, max_new_tokens=20)
    eng.run_to_completion(max_steps=200)
    fin = eng.take_finished()
    jeng = _jax_engine(fp_model, **PAGED, kv_pages=4, n_slots=2,
                       on_pressure="truncate")
    juids = jeng.add_requests(prompts, max_new_tokens=20)
    jeng.run_to_completion(max_steps=200)
    jfin = jeng.take_finished()
    trunc = [fin[u] for u in uids if fin[u].state is RequestState.TRUNCATED]
    assert trunc, "pool never starved: the scenario is vacuous"
    d = trunc[0].diagnostics
    assert d["kind"] == "pool_exhausted" and d["n_pages"] == 4
    assert ([fin[u].state.value for u in uids]
            == [jfin[u].state.value for u in juids])
    assert ([fin[u].diagnostics for u in uids]
            == [jfin[u].diagnostics for u in juids])
    _assert_tokens_match(fp_model[3], fp_model[1], prompts,
                         [fin[u].tokens for u in uids],
                         [jfin[u].tokens for u in juids])


def test_decode_time_exhaustion_preempts_by_default_like_reference(fp_model):
    """The same starved pool under the default ``on_pressure="preempt"``:
    the younger request is preempted (not truncated) and resumes once the
    other retires — states, preemptions, resumes and ``stats()["paged"]``
    equal to the JAX engine's default, tokens bitwise the unpressured
    contiguous run's."""
    prompts = [list(range(1, 14)), list(range(1, 14))]
    base = _drain(_engine(fp_model, n_slots=2), prompts, max_new=20)

    def run(eng):
        uids = eng.add_requests(prompts, max_new_tokens=20)
        eng.run_to_completion(max_steps=200)
        fin = eng.take_finished()
        st = eng.stats()
        return ([fin[u].tokens for u in uids],
                [(fin[u].state.value, fin[u].diagnostics, fin[u].preemptions)
                 for u in uids],
                (st["preemptions"], st["resumes"], st["lifecycle"]),
                st["paged"])

    got, out, counts, paged = run(_engine(fp_model, **PAGED, kv_pages=4,
                                          n_slots=2))
    jgot, jout, jcounts, jpaged = run(_jax_engine(fp_model, **PAGED,
                                                  kv_pages=4, n_slots=2))
    assert counts[0] >= 1 and counts[1] == counts[0], counts
    assert all(s == "finished" for s, _, _ in out)
    assert out == jout and counts == jcounts
    for key in ("n_pages", "pages_in_use", "peak_pages_in_use",
                "peak_pages_per_request", "pages_allocated_total",
                "pages_freed_total", "prefix_hits", "prefix_shared_tokens",
                "cow_copies", "page_evictions", "registry_entries"):
        assert paged[key] == jpaged[key], key
    assert got == base
    _assert_tokens_match(fp_model[3], fp_model[1], prompts, got, jgot)


# -------------------------------------------------------------- config guards

def test_paged_config_validation(fp_model):
    _, tcfg, _, tm = fp_model
    with pytest.raises(ValueError, match="divide"):
        _engine(fp_model, kv_layout="paged", page_size=7)
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        _engine(fp_model, page_size=8)
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(fp_model, **PAGED, kv_dtype="int4")
    with pytest.raises(ValueError, match="kv_layout"):
        _engine(fp_model, kv_layout="ring")
    ring = dataclasses.replace(tcfg, attn_window=16)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tapi.make_cache(ring, 2, 64, dtype=torch.float32, device="cpu",
                        page_size=8)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        ServingEngine(tm, ring, n_slots=2, max_len=64, device="cpu", **PAGED)


def test_stats_reports_cache_utilization(fp_model):
    eng = _engine(fp_model, **PAGED)
    eng.add_requests(PROMPTS, max_new_tokens=4)
    st = eng.stats()["paged"]
    jeng = _jax_engine(fp_model, **PAGED)
    jeng.add_requests(PROMPTS, max_new_tokens=4)
    jst = jeng.stats()["paged"]
    assert st.keys() == jst.keys()
    assert st == jst
    assert st["pages_in_use"] + st["pages_free"] == st["n_pages"]
    assert 0 < st["pool_utilization"] <= 1
    assert st["bytes_pool"] == st["bytes_contiguous_fp"]
    assert st["bytes_resident"] < st["bytes_pool"]


# ------------------------------------------------------ speculation on pages

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("gamma", [2, 4])
def test_paged_speculative_window(fp_model, gamma, kv_dtype):
    """Propose/verify/rollback over paged caches (the draft's and the
    target's): fp pages emit exactly the contiguous vanilla tokens, int8
    pages their own vanilla tokens; both equal the JAX paged speculative
    engine's (near-tie rule), and every request releases its pages."""
    _, tcfg, jp, tm = fp_model
    kw = dict(PAGED, kv_dtype=kv_dtype)
    base = _drain(_engine(fp_model, **(kw if kv_dtype else {})), PROMPTS,
                  max_new=9)
    eng = _engine(fp_model, draft_params=tm, spec=SpecConfig(gamma=gamma),
                  **kw)
    got = _drain(eng, PROMPTS, max_new=9)
    assert got == base
    assert not eng._req_pages
    eng.prefix_registry.clear()
    assert eng.allocator.pages_in_use == 0
    want = _drain(_jax_engine(fp_model, draft_params=jp,
                              spec=JaxSpec(gamma=gamma), **kw), PROMPTS,
                  max_new=9)
    _assert_tokens_match(tm, tcfg, PROMPTS, got, want)
