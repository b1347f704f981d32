"""Port parity for the moe family on the smoke ``qwen3_moe_30b_a3b``
(vocab 128, 1 layer, f32; 8 experts top-2) and ``deepseek_v2_236b``
(+1 shared expert, MLA): the reference's params cross in through
``from_numpy_tree``.

``moe_mlp`` (router, stable top-k, capacity drops, dispatch, expert
einsums, gate-weighted combine, shared experts, aux loss) matches the
reference to 1e-5 at capacity factor 0.25 (tokens dropped) and 16.0;
stacked expert tensors dequantize in one batched pass, bitwise the
reference's vmapped dequantize (bf16 cast before the lookup included)
and through prepared plans; calibration taps one Hessian per expert under
the reference's names; the expert quantizer gives the reference's codes
in weight space exactly and, from calibrated Hessians, its plans (the
codes then differ where the packages' Cholesky factors do); prefill and
decode logits of the fp and CLAQ models match to 1e-4; ``loss_fn``
carries the aux term and one step's gradients match; the moe engine
admits unpadded and unbatched, cannot preempt, refuses chunked prefill
and speculation, and emits the JAX engine's tokens."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import CLAQConfig as JCLAQ  # noqa: E402
from repro.data import calibration_set as jcalib  # noqa: E402
from repro.launch import quantize as jlq  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import (from_numpy_tree, quantized_to_numpy,  # noqa: E402
                                 to_numpy_tree)
from repro_torch.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro_torch.core import claq as claq_lib  # noqa: E402
from repro_torch.core.quantized import stack_quantized  # noqa: E402
from repro_torch.kernels.plan import (prepare_for_inference,  # noqa: E402
                                      prepare_tree)
from repro_torch.launch import quantize as tlq  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import modules as tmods  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import ServingEngine, SpecConfig  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_dense_configs import numpy_to_reference  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402
from test_torch_serving import _serve  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

F32_ATOL = 1e-5
LOGIT_ATOL = 1e-4
QCFG = dict(bits=4, method="kmeans", kmeans_iters=4, gptq_blocksize=32)


def cfgs(arch, **kw):
    kw = dict(dict(vocab=128, n_layers=1), **kw)
    jcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(t_smoke(arch), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def qwen():
    """The smoke qwen3-moe: reference fp params, their port, calibration
    Hessians of both packages, the reference's CLAQ params and the port's
    quantization of the same weights from the reference's Hessians."""
    jcfg, tcfg = cfgs("qwen3_moe_30b_a3b")
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    calib = np.array(jcalib(vocab=128, n_segments=4, seq_len=32))
    jh = jlq.calibrate(jp, jcfg, jnp.asarray(calib), batch_size=2)
    jq, jrep = jlq.quantize_model_params(jp, jcfg, jh, JCLAQ(**QCFG))
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    th = tlq.calibrate(tm, tcfg, torch.from_numpy(calib), batch_size=2)
    tq = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    tq, trep = tlq.quantize_model_params(
        tq, tcfg, {k: torch.from_numpy(np.array(v)) for k, v in jh.items()},
        CLAQConfig(**QCFG))
    # weight space (no taps: every matrix's Hessian is the identity)
    jq0, _ = jlq.quantize_model_params(jp, jcfg, {}, JCLAQ(**QCFG))
    tq0, _ = tlq.quantize_model_params(
        from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu"), tcfg, {},
        CLAQConfig(**QCFG))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tm=tm, jh=jh, th=th, jq=jq,
                jrep=jrep, tq=tq, trep=trep, calib=calib, jq0=jq0, tq0=tq0)


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("cf", [0.25, 16.0])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_236b"])
def test_moe_mlp_matches_reference(arch, cf):
    jcfg, tcfg = cfgs(arch, capacity_factor=cf)
    jp = japi.init_params(jax.random.PRNGKey(1), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    x = np.random.default_rng(2).normal(size=(2, 12, jcfg.d_model)).astype(
        np.float32)
    jy, jaux = jmoe.moe_mlp(_layer0(jp["blocks"]["mlp"]), jnp.asarray(x),
                            jcfg)
    stats = {}
    ty, taux = tmoe.moe_mlp(tm.blocks[0].mlp, torch.from_numpy(x), tcfg,
                            stats)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32_ATOL,
                               rtol=0)
    assert abs(float(taux) - float(jaux)) < F32_ATOL
    assert (int(stats["dropped"]) > 0) == (cf < 1.0)
    assert (tm.blocks[0].mlp.shared is not None) == (
        arch == "deepseek_v2_236b")


def test_top_k_ties_take_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3]])
    vals, idx = tmoe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2]]


def _expert_qts(seed, n_experts=3, rows=32, cols=48):
    rng = np.random.default_rng(seed)
    cfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=2,
                     gptq_blocksize=16, ap=APConfig(2.5, 2, 4),
                     orr=ORConfig(0.1))
    return [claq_lib.quantize_matrix(torch.from_numpy(
        rng.normal(size=(rows, cols)).astype(np.float32)), None, cfg)[0]
        for _ in range(n_experts)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_dequantize_is_the_reference_bitwise(dtype):
    """One batched pass over E equals each expert's own dequantize and the
    reference's vmapped dequantize bit for bit, in f32 and in bf16 (the
    port casts codebook and outlier values before placing them), plain
    and through a prepared stacked plan."""
    qts = _expert_qts(0)
    st = stack_quantized(qts)
    tdt = getattr(torch, dtype)
    got = st.dequantize(tdt)
    assert got.shape == (3, 32, 48)
    for e, q in enumerate(qts):
        assert torch.equal(got[e], q.dequantize(torch.float32).to(tdt))
    jst = numpy_to_reference(quantized_to_numpy(st))
    want = jax.vmap(lambda q: q.dequantize(getattr(jnp, dtype)))(jst)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    from repro.kernels.plan import prepare_for_inference as jprep
    w = tmoe.expert_weight(tmods.Dense(prepare_for_inference(st)), tdt)
    jw = jmoe._expert_weight(jprep(jst), getattr(jnp, dtype))
    assert w.shape == (3, 48, 32)
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw).astype(np.float32))
    assert torch.equal(w, got.transpose(1, 2))


def test_stacking_refuses_different_stripe_layouts():
    qts = _expert_qts(1, n_experts=2)
    other = claq_lib.quantize_matrix(
        torch.randn(32, 48, generator=torch.Generator().manual_seed(0)),
        None, CLAQConfig(bits=3, method="kmeans", kmeans_iters=2))[0]
    with pytest.raises(ValueError, match="stripe layouts differ"):
        stack_quantized(qts + [other])


def test_expert_taps_named_and_equal(qwen):
    """One Hessian per expert (``expert_in_{e}``, ``expert_mid_{e}``) and
    the router's, under the reference's names, within 1e-5 relative."""
    th, jh = qwen["th"], qwen["jh"]
    assert sorted(th) == sorted(jh)
    E = qwen["tcfg"].n_experts
    for e in range(E):
        assert f"layers.0.mlp.expert_in_{e}" in th
        assert f"layers.0.mlp.expert_mid_{e}" in th
    assert "layers.0.mlp.router" in th
    for k, H in th.items():
        Hj = np.asarray(jh[k])
        np.testing.assert_allclose(H.numpy(), Hj, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(Hj).max(), 1e-30))


def _experts_of(tq, jq, name):
    return (quantized_to_numpy(getattr(tq.blocks[0].mlp, name).kernel),
            _layer0(jq["blocks"]["mlp"][name]))


def test_expert_quantization_equal_codes(qwen):
    """In weight space (no taps: identity Hessians in both packages) every
    expert of every stack gets the reference's codes, codebooks, column
    order and outliers exactly; the router stays fp."""
    mlp = qwen["tq0"].blocks[0].mlp
    assert isinstance(mlp.router.kernel, torch.Tensor)
    for name in ("w_gate", "w_up", "w_down"):
        got, want = _experts_of(qwen["tq0"], qwen["jq0"], name)
        assert got["col_perm"].shape[0] == qwen["tcfg"].n_experts
        assert [s["bits"] for s in got["stripes"]] == [
            s.bits for s in want.stripes]
        for s, w in zip(got["stripes"], want.stripes):
            np.testing.assert_array_equal(s["packed"], np.asarray(w.packed))
            np.testing.assert_allclose(s["codebook"], np.asarray(w.codebook),
                                       rtol=1e-6, atol=1e-6)
        for f in ("col_perm", "out_idx", "out_count"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))


def test_expert_quantization_from_taps(qwen):
    """From the reference's per-expert Hessians: the stats keys, the mean
    effective bits and every expert's plan (bits, column order, outlier
    counts) are the reference's, the proxy loss within 5 % (the rule of
    tests/test_torch_quantize.py for a calibrated model: the packages'
    Cholesky factors differ in the last bits and GPTQ's error feedback
    carries that into some codes: 98.4-99.9 % of them agree in this test,
    all of them in weight space), and each expert is quantized with its
    own tap:
    the stack's member equals a ``quantize_matrix`` call on that expert
    with its ``expert_in``/``expert_mid`` Hessian, bitwise."""
    tq, jq, tcfg = qwen["tq"], qwen["jq"], qwen["tcfg"]
    trep, jrep = qwen["trep"], qwen["jrep"]
    assert sorted(trep.stats) == sorted(jrep.stats)
    assert "layers.0.mlp.w_down.w_down" in trep.stats
    assert trep.mean_effective_bits == jrep.mean_effective_bits
    assert trep.total_proxy_loss == pytest.approx(jrep.total_proxy_loss,
                                                  rel=0.05)
    fp = qwen["tm"].blocks[0].mlp
    for name in ("w_gate", "w_up", "w_down"):
        got, want = _experts_of(tq, jq, name)
        assert [s["bits"] for s in got["stripes"]] == [
            s.bits for s in want.stripes]
        for f in ("col_perm", "out_count"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
        tap = "expert_mid" if name == "w_down" else "expert_in"
        e = tcfg.n_experts - 1
        one, _, _ = claq_lib.quantize_matrix(
            getattr(fp, name).kernel[e].float().T,
            torch.from_numpy(np.array(qwen["jh"][f"layers.0.mlp.{tap}_{e}"])),
            CLAQConfig(**QCFG))
        stacked = getattr(tq.blocks[0].mlp, name).kernel
        for s, o in zip(stacked.stripes, one.stripes):
            assert torch.equal(s.packed[e], o.packed)


def _prefill_decode(jcfg, tcfg, jp, tm, lens=(5, 9)):
    """Each prompt prefilled alone (moe routing couples rows), then two
    decode steps of the batch; logits compared at every step."""
    rng = np.random.default_rng(1)
    B = len(lens)
    jc = japi.make_cache(jcfg, B, 32, dtype=jnp.float32)
    tc = tapi.make_cache(tcfg, B, 32, dtype=torch.float32, device="cpu")
    toks = rng.integers(0, jcfg.vocab, size=(B, max(lens)))
    # equal-length rows prefill together at the uniform fill level
    jl, jc = japi.prefill_step(jp, jcfg, {"tokens": jnp.asarray(
        toks[:, :lens[0]], jnp.int32)}, jc)
    tl, tc = tapi.prefill_step(tm, tcfg, {"tokens": torch.from_numpy(
        toks[:, :lens[0]])}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(2):
        jl, jc = japi.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc)
        tl, tc = tapi.decode_step(tm, tcfg, torch.tensor(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    for i, c in enumerate(tc):
        for f in c._fields:
            np.testing.assert_allclose(getattr(c, f).float().numpy(),
                                       np.asarray(getattr(jc, f)[i]),
                                       atol=LOGIT_ATOL, rtol=0)


def _claq_port(qwen):
    """The reference's CLAQ params in the port, through both converters
    (numpy -> port -> numpy -> port: the expert stacks cross both ways)."""
    tcfg = qwen["tcfg"]
    once = from_numpy_tree(jax_tree_to_numpy(qwen["jq"]), tcfg, "cpu")
    return from_numpy_tree(to_numpy_tree(once, tcfg), tcfg, "cpu")


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_prefill_decode_logits(qwen, tag):
    jcfg, tcfg = qwen["jcfg"], qwen["tcfg"]
    if tag == "fp":
        _prefill_decode(jcfg, tcfg, qwen["jp"], qwen["tm"])
    else:
        _prefill_decode(jcfg, tcfg, qwen["jq"], prepare_tree(
            _claq_port(qwen)))


def test_loss_aux_and_gradients(qwen):
    """loss = nll + 0.01 aux in both packages; every gradient of one step
    (router, expert stacks, attention) within 1e-5."""
    jcfg, tcfg, jp, tm = qwen["jcfg"], qwen["tcfg"], qwen["jp"], qwen["tm"]
    toks = np.random.default_rng(3).integers(0, 128, size=(2, 16))
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    tl, tmet, tg = loss_and_grads(tm, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float(tmet["aux"]) > 0
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) < F32_ATOL
    assert abs(float(tl) - float(tmet["nll"]) - 0.01 * float(tmet["aux"])) \
        < 1e-6
    assert abs(float(tl) - float(jl)) < F32_ATOL
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = tree_lib.flatten(tg)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        n for n, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        b = (np.stack([t.numpy() for t in b])
             if isinstance(b, tree_lib.LayerStack) else b.numpy())
        np.testing.assert_allclose(b, np.asarray(a), atol=F32_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_engine_unpadded_unbatched_and_tokens(qwen):
    """As tests/test_serving.py's moe case: no padding, one (1, len)
    prefill per request, not preemptible; the port's tokens are the JAX
    engine's exactly, fp and CLAQ."""
    jcfg, tcfg = qwen["jcfg"], qwen["tcfg"]
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12, 13, 14]]
    for jp, tm in ((qwen["jp"], qwen["tm"]),
                   (qwen["jq"], _claq_port(qwen))):
        eng = ServingEngine(tm, tcfg, n_slots=4, max_len=32, device="cpu")
        assert not eng.bucketing.enabled and not eng._preemptible
        got = _serve(eng, prompts, max_new=4)
        assert eng.bucketing.stats.per_shape == {(1, 3): 3, (1, 5): 1}
        want = _serve(JaxEngine(jp, jcfg, n_slots=4, max_len=32), prompts,
                      max_new=4)
        assert got == want


def test_engine_refuses_chunking_and_speculation(qwen):
    tcfg, tm = qwen["tcfg"], qwen["tm"]
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=32, chunked_prefill=8,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="capacity-bounded"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=32, draft_params=tm,
                      spec=SpecConfig(gamma=2), device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_1p2b",
                                  "seamless_m4t_medium"])
def test_other_families_still_refused(arch):
    """(Named when these families were refused.)  Each family initialises
    and the refusals left are the reference's own: encdec by
    ``ServingEngine`` and the paged cache, rwkv and the hybrid by
    speculation and paging.  A windowed moe config (refused before) now
    forwards with the window applied, to the reference's logits."""
    cfg = t_smoke(arch)
    model = tapi.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    if cfg.family == "encdec":
        with pytest.raises(NotImplementedError, match="decoder-only"):
            ServingEngine(model, cfg, n_slots=2, max_len=32, device="cpu")
        with pytest.raises(NotImplementedError, match="encdec serving"):
            tapi.make_cache(cfg, 2, 32, device="cpu", src_len=4,
                            page_size=8)
    else:
        with pytest.raises(NotImplementedError, match="recurrent state"):
            ServingEngine(model, cfg, n_slots=2, max_len=32,
                          draft_params=model, spec=SpecConfig(gamma=2),
                          device="cpu")
        with pytest.raises(NotImplementedError, match="nothing to page"):
            tapi.make_cache(cfg, 2, 32, device="cpu", page_size=8)
    jcfg, tcfg = cfgs("qwen3_moe_30b_a3b", attn_window=4)
    jp = japi.init_params(jax.random.PRNGKey(2), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    toks = np.arange(1, 13).reshape(1, 12)
    jl, _, _ = japi.tf.forward(jp, jcfg, jnp.asarray(toks))
    tl, _, _ = tapi.tf.forward(tm, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    unwindowed, _, _ = tapi.tf.forward(
        tm, dataclasses.replace(tcfg, attn_window=None),
        torch.from_numpy(toks))
    assert not torch.allclose(unwindowed, tl)
