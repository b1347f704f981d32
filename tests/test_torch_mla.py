"""Port parity for MLA attention (``repro_torch.models.mla``), on a dense
``use_mla`` smoke config (llama1_7b's, vocab 128, 2 layers, f32, as
tests/test_chunked_prefill.py and tests/test_speculative.py make it) and
on the smoke ``deepseek_v2_236b`` (moe + MLA, 1 layer); the reference's
params cross in through ``from_numpy_tree``.

``mla_attention`` matches the reference to 1e-5 on the expanded path
(no cache, and prefill into a cache), the absorbed decode and the
absorbed span, with equal latent caches, contiguous and paged (fp and
int8); on the CPU a span is bitwise its S successive decodes; paged fp
tokens are exactly the contiguous ones; chunked prefill is exactly
monolithic prefill and speculation exactly vanilla, and all equal the
JAX engine's tokens; the deepseek smoke model's prefill/decode logits
(fp and CLAQ) match to 1e-4, its engines (contiguous, paged fp and int8)
emit the JAX engines' tokens (fp), it refuses chunked prefill, one step's
gradients match, and a train state (params and AdamW moments) written
by either package restores in the other bitwise."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro.serve import SpecConfig as JaxSpec  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import (from_numpy_tree, param_tree,  # noqa: E402
                                 to_numpy_tree)
from repro_torch.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro_torch.kernels.plan import prepare_tree  # noqa: E402
from repro_torch.launch.quantize import quantize_model_params  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.serve import ServingEngine, SpecConfig  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_checkpoint import _assert_same  # noqa: E402
from test_torch_dense_configs import numpy_to_reference  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402
from test_torch_serving import _serve  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

F32_ATOL = 1e-5
LOGIT_ATOL = 1e-4
MLA = dict(use_mla=True, q_lora=32, kv_lora=16, rope_head_dim=8,
           v_head_dim=16, head_dim=16)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10],
           [11, 12, 13, 14, 15, 16, 17, 18, 19]]


def cfgs(arch, **kw):
    jcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(t_smoke(arch), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _port(jp, tcfg):
    return from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def dense_mla():
    """The dense use_mla smoke model (and an unrelated draft) in both
    packages."""
    jcfg, tcfg = cfgs("llama1_7b", vocab=128, n_layers=2, **MLA)
    jp = japi.init_params(jax.random.PRNGKey(3), jcfg)
    jd = japi.init_params(jax.random.PRNGKey(7), jcfg)
    return jcfg, tcfg, jp, jd, _port(jp, tcfg), _port(jd, tcfg)


@pytest.fixture(scope="module")
def deepseek():
    """The smoke deepseek-v2 (1 layer): fp params in both packages, and a
    CLAQ AP+OR model made by the port's quantizer (weight space) crossed
    into the reference, so both hold the same codes."""
    jcfg, tcfg = cfgs("deepseek_v2_236b", vocab=128, n_layers=1)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tq, _ = quantize_model_params(
        _port(jp, tcfg), tcfg, {},
        CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                   gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                   orr=ORConfig(0.1)))
    tree = to_numpy_tree(tq, tcfg)
    jq = numpy_to_reference(tree)
    return jcfg, tcfg, {"fp": (jp, jax_tree_to_numpy(jp)), "claq": (jq, tree)}


def _deepseek(deepseek, tag):
    """(reference params, a fresh port model: engines prepare in place)."""
    jcfg, tcfg, m = deepseek
    jp, tree = m[tag]
    return jp, from_numpy_tree(tree, tcfg, device="cpu")


def _jitted(jcfg, span=False):
    """The reference's mla_attention, jitted (eager JAX compiles op by op)."""
    return jax.jit(lambda p, x, c: jmla.mla_attention(p, x, jcfg, c,
                                                      span=span))


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _close(t, j, atol=F32_ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _jcache_of(tc):
    """The reference's cache holding the port's cache contents."""
    if isinstance(tc, tmla.PagedMLACache):
        return jmla.PagedMLACache(*(None if t is None else jnp.asarray(
            t.numpy()) for t in tc))
    return jmla.MLACache(*(jnp.asarray(t.numpy()) for t in tc))


def _check_cache(tc, jc):
    for f in tc._fields:
        t, j = getattr(tc, f), getattr(jc, f)
        if t is not None:
            _close(t, j)


def test_mla_attention_paths(dense_mla):
    """Expanded (no cache; prefill at a uniform fill level), absorbed
    decode and absorbed span against the reference at 1e-5, with equal
    latent caches."""
    jcfg, tcfg, jp, _, tm, _ = dense_mla
    p, tp = _layer(jp["blocks"]["attn"]), tm.blocks[0].attn
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    jattn = _jitted(jcfg)
    jo, _ = jattn(p, jnp.asarray(x), None)
    to, _ = tmla.mla_attention(tp, torch.from_numpy(x), tcfg)
    _close(to, jo)

    tc = tmla.init_mla_cache(2, 16, tcfg, torch.float32, "cpu")
    jc = jmla.init_mla_cache(2, 16, jcfg, jnp.float32)
    jo, jc = jattn(p, jnp.asarray(x[:, :5]), jc)
    to, tc = tmla.mla_attention(tp, torch.from_numpy(x[:, :5]), tcfg, tc)
    _close(to, jo)
    _check_cache(tc, jc)
    for s in (5, 6):                                   # absorbed decode
        jo, jc = jattn(p, jnp.asarray(x[:, s:s + 1]), jc)
        to, tc = tmla.mla_attention(tp, torch.from_numpy(x[:, s:s + 1]),
                                    tcfg, tc)
        _close(to, jo)
        _check_cache(tc, jc)
    # span at per-slot fill levels, past the cache end for slot 1
    tc = tc._replace(length=torch.tensor([7, 13], dtype=torch.int32))
    jc = jc._replace(length=jnp.asarray([7, 13], jnp.int32))
    y = rng.normal(size=(2, 4, jcfg.d_model)).astype(np.float32)
    jo, jc = _jitted(jcfg, span=True)(p, jnp.asarray(y), jc)
    to, tc = tmla.mla_attention(tp, torch.from_numpy(y), tcfg, tc, span=True)
    _close(to, jo)
    _check_cache(tc, jc)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_mla_cache_matches_reference(dense_mla, kv_dtype):
    """Paged absorbed decode and span through a page table: the pools,
    scales and outputs match the reference's; fp paged decode equals the
    contiguous decode bitwise."""
    jcfg, tcfg, jp, _, tm, _ = dense_mla
    p, tp = _layer(jp["blocks"]["attn"]), tm.blocks[0].attn
    rng = np.random.default_rng(1)
    kw = dict(page_size=4, n_pages=6)
    tc = tmla.init_paged_mla_cache(2, 16, tcfg, dtype=torch.float32,
                                   kv_dtype=kv_dtype, device="cpu", **kw)
    table = np.array([[0, 2, 6, 6], [1, 3, 4, 6]])
    tc.table.copy_(torch.from_numpy(table))
    tc = tc._replace(length=torch.tensor([3, 6], dtype=torch.int32))
    jc = _jcache_of(tc)
    cc = tmla.init_mla_cache(2, 16, tcfg, torch.float32, "cpu")._replace(
        length=tc.length.clone())
    for step, S in enumerate((1, 3, 1)):
        x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
        jo, jc = _jitted(jcfg, span=S > 1)(p, jnp.asarray(x), jc)
        to, tc = tmla.mla_attention(tp, torch.from_numpy(x), tcfg, tc,
                                    span=S > 1)
        _close(to, jo)
        _check_cache(tc, jc)
        co, cc = tmla.mla_attention(tp, torch.from_numpy(x), tcfg, cc,
                                    span=S > 1)
        if kv_dtype is None and step == 0:
            # fresh positions only (the contiguous cache holds zeros where
            # the pages hold nothing yet)
            assert torch.equal(co, to)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tmla.mla_attention(tp, torch.zeros(2, 3, jcfg.d_model), tcfg, tc)


def test_span_is_bitwise_successive_decodes(dense_mla):
    """decode_span over S tokens is bitwise S decode_step calls, logits
    and latent caches, contiguous and paged."""
    _, tcfg, _, _, tm, _ = dense_mla
    toks = torch.tensor([[3, 9, 4, 1], [7, 2, 8, 5]])
    for kw in ({}, dict(page_size=8)):
        base = tapi.make_cache(tcfg, 2, 32, torch.float32, "cpu", **kw)
        if kw:
            base[0].table.copy_(torch.arange(8).reshape(2, 4))
        # a prompt of 5 (slot 0) and 3 (slot 1): decode steps from empty
        for t in ([1, 6], [2, 5], [3, 4]):
            _, base = tapi.decode_step(tm, tcfg, torch.tensor(t), base)

        def clone(c):
            return [type(x)(*(None if t is None else t.clone() for t in x))
                    for x in c]
        span_l, span_c = tapi.decode_span(tm, tcfg, toks, clone(base))
        c, outs = clone(base), []
        for j in range(toks.shape[1]):
            lg, c = tapi.decode_step(tm, tcfg, toks[:, j], c)
            outs.append(lg)
        assert torch.equal(span_l, torch.stack(outs, dim=1))
        for a, b in zip(span_c, c):
            for t, u in zip(a, b):
                assert t is None or torch.equal(t, u)


def test_chunked_matches_monolithic_mla(dense_mla):
    """tests/test_chunked_prefill.py's MLA case: the latent c_kv/k_pe leaves
    ride the uniform-fill branch; tokens exactly the monolithic ones, and
    the JAX engine's."""
    jcfg, tcfg, jp, _, tm, _ = dense_mla
    kw = dict(n_slots=3, max_len=64, min_bucket=8)
    mono = _serve(ServingEngine(tm, tcfg, device="cpu", **kw), PROMPTS[:3],
                  max_new=6)
    eng = ServingEngine(tm, tcfg, device="cpu", chunked_prefill=8, **kw)
    assert _serve(eng, PROMPTS[:3], max_new=6) == mono
    assert eng.stats()["chunked"]["chunks_processed"] > 0
    assert mono == _serve(JaxEngine(jp, jcfg, **kw), PROMPTS[:3], max_new=6)


def test_spec_mla_matches_vanilla(dense_mla):
    """tests/test_speculative.py's MLA case: an unrelated draft at γ 2, on
    contiguous and paged latent caches (the rollback rides c_kv/k_pe):
    tokens exactly vanilla's and the JAX speculative engine's."""
    jcfg, tcfg, jp, jd, tm, td = dense_mla
    kw = dict(n_slots=3, max_len=64, min_bucket=8)
    vanilla = _serve(ServingEngine(tm, tcfg, device="cpu", **kw),
                     PROMPTS[:3], max_new=6)
    for extra in ({}, dict(kv_layout="paged", page_size=8)):
        eng = ServingEngine(tm, tcfg, device="cpu", draft_params=td,
                            spec=SpecConfig(gamma=2), **kw, **extra)
        assert _serve(eng, PROMPTS[:3], max_new=6) == vanilla
        assert eng.stats()["spec_drafted"] > 0
    assert vanilla == _serve(JaxEngine(jp, jcfg, draft_params=jd,
                                       spec=JaxSpec(gamma=2), **kw),
                             PROMPTS[:3], max_new=6)


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_deepseek_prefill_decode_logits(deepseek, tag):
    jcfg, tcfg, _ = deepseek
    jp, tm = _deepseek(deepseek, tag)
    tm = prepare_tree(tm)
    toks = np.random.default_rng(2).integers(0, 128, size=(2, 6))
    jc = japi.make_cache(jcfg, 2, 32, dtype=jnp.float32)
    tc = tapi.make_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    jl, jc = japi.prefill_step(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tapi.prefill_step(tm, tcfg, {"tokens": torch.from_numpy(toks)},
                               tc)
    _close(tl, jl, LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(2):
        jl, jc = japi.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc)
        tl, tc = tapi.decode_step(tm, tcfg, torch.tensor(tok), tc)
        _close(tl, jl, LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    _check_cache(tc[0], _layer(jc))


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_deepseek_engines_emit_reference_tokens(deepseek, tag):
    """Contiguous, paged fp (exactly the contiguous tokens) and paged int8
    engines, against the JAX engines (fp); chunked prefill refused (moe)."""
    jcfg, tcfg, _ = deepseek
    jp, tm = _deepseek(deepseek, tag)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15]]
    kw = dict(n_slots=4, max_len=32)
    # the JAX engines compile slowly: fp is held to the contiguous and the
    # int8-paged one (the CLAQ model's logits are held above, and the moe
    # file holds CLAQ engine tokens)
    held = () if tag == "claq" else ("contiguous", "paged_int8")
    runs = {}
    for name, extra in (("contiguous", {}),
                        ("paged", dict(kv_layout="paged", page_size=8)),
                        ("paged_int8", dict(kv_layout="paged", page_size=8,
                                            kv_dtype="int8"))):
        eng = ServingEngine(tm, tcfg, device="cpu", **kw, **extra)
        runs[name] = _serve(eng, prompts, max_new=4)
        if name in held:
            assert runs[name] == _serve(JaxEngine(jp, jcfg, **kw, **extra),
                                        prompts, max_new=4), name
    assert runs["paged"] == runs["contiguous"]
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(tm, tcfg, device="cpu", chunked_prefill=8, **kw)


def test_deepseek_loss_and_gradients(deepseek):
    jcfg, tcfg, _ = deepseek
    jp, tm = _deepseek(deepseek, "fp")
    toks = np.random.default_rng(3).integers(0, 128, size=(2, 12))
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    tl, tmet, tg = loss_and_grads(tm, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) < F32_ATOL
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) < F32_ATOL
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = tree_lib.flatten(tg)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        n for n, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        b = (np.stack([t.numpy() for t in b])
             if isinstance(b, tree_lib.LayerStack) else b.numpy())
        np.testing.assert_allclose(b, np.asarray(a), atol=F32_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_deepseek_checkpoint_crosses_packages(deepseek, tmp_path):
    """A train state of the deepseek smoke model ({params, AdamW state}:
    the MLA leaves, the router, the shared experts and the (L, E, ...)
    expert stacks) written by the port restores in the reference bitwise
    under the reference's leaf names, and the reference's restores in the
    port bitwise."""
    from repro.optim import OptimConfig as JOpt
    from repro.optim import init_opt_state as j_init
    from repro_torch.convert import opt_state_from_numpy
    from repro_torch.optim import OptimConfig, init_opt_state
    jcfg, tcfg, _ = deepseek
    jp, tm = _deepseek(deepseek, "fp")
    jopt = j_init(jp, JOpt())
    rng = np.random.default_rng(4)
    jopt = jopt._replace(m=jax.tree_util.tree_map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), jopt.m),
        step=jnp.asarray(5, jnp.int32))
    topt = opt_state_from_numpy(
        {"m": jax_tree_to_numpy(jopt.m), "v": jax_tree_to_numpy(jopt.v),
         "step": np.asarray(jopt.step)}, tm, tcfg, device="cpu")
    tstate = {"params": param_tree(tm, tcfg), "opt": topt}
    jstate = {"params": jp, "opt": jopt}
    names = [n for n, _ in tree_lib.flatten(tstate)]
    for leaf in ("['attn']['kv_up']['kernel']", "['mlp']['w_gate']",
                 "['mlp']['router']['kernel']",
                 "['mlp']['shared']['down']['kernel']"):
        assert f"['params']['blocks']{leaf}" in names
    CheckpointManager(str(tmp_path / "port")).save(1, tstate)
    _assert_same(tstate, JManager(str(tmp_path / "port")).restore(
        1, jax.tree_util.tree_map(jnp.zeros_like, jstate)))
    JManager(str(tmp_path / "ref")).save(2, jstate)
    fresh = tapi.init_params(torch.Generator().manual_seed(9), tcfg, "cpu")
    tmpl = param_tree(fresh, tcfg)
    back = CheckpointManager(str(tmp_path / "ref")).restore(
        2, {"params": tmpl, "opt": init_opt_state(tmpl, OptimConfig())})
    _assert_same(back, jstate)
