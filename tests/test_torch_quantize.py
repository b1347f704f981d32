"""Port parity for the CLAQ quantizer: ``repro_torch.core`` (outlier,
policy, kmeans, gptq, claq), ``repro_torch.data`` and
``repro_torch.launch`` against the reference on the same numpy-made
inputs.  Integer results (plans, counts, masks, hashes) must be equal;
floating ones carry the tolerance stated in each test.  GPTQ is fed the
reference's own preconditioner U so LAPACK noise does not cascade through
the column loop."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro.core import claq as jclaq  # noqa: E402
from repro.core import gptq as jgptq  # noqa: E402
from repro.core import kmeans as jkm  # noqa: E402
from repro.core import outlier as jout  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.data import calibration_set as jcalib  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import quantize as jlq  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import claq as tclaq  # noqa: E402
from repro_torch.core import gptq as tgptq  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.core import outlier as tout  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import dequant_matmul as tdm  # noqa: E402
from repro_torch.launch import quantize as tlq  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from test_torch_models import jax_tree_to_numpy, smoke_cfgs  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _weights(rng, rows, cols, n_outliers=20):
    """Gaussian weights with a few large entries (real Outlier Order)."""
    W = rng.normal(size=(rows, cols)).astype(np.float32) * 0.05
    r = rng.integers(0, rows, n_outliers)
    c = rng.integers(0, cols, n_outliers)
    W[r, c] = rng.normal(size=n_outliers).astype(np.float32) * 2.0
    return W


def _hessian(rng, cols, n=256, dead=()):
    X = rng.normal(size=(n, cols)).astype(np.float32)
    X[:, list(dead)] = 0.0
    return (2.0 * X.T @ X / n).astype(np.float32)


def _q(**kw):
    """The same recipe in both packages."""
    j = dict(kw)
    t = dict(kw)
    for k, (jc, tc) in {"ap": (APConfig, tpol.APConfig),
                        "orr": (ORConfig, tpol.ORConfig)}.items():
        if kw.get(k) is not None:
            j[k] = jc(**kw[k])
            t[k] = tc(**kw[k])
    return CLAQConfig(**j), tpol.CLAQConfig(**t)


# ------------------------------------------------------ outlier / policy

def test_outlier_and_policy_outputs_equal():
    rng = np.random.default_rng(0)
    W = _weights(rng, 96, 160)
    Wj, Wt = jnp.asarray(W), torch.from_numpy(W)
    Rj = jout.outlier_ratio(Wj, 5.0)
    Rt = tout.outlier_ratio(Wt, 5.0)
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(tout.outlier_order(Rt).numpy(),
                                  np.asarray(jout.outlier_order(Rj)))
    for frac in (0.0, 0.1, 0.37, 1.0):
        np.testing.assert_array_equal(
            tout.top_fraction_mask(Rt, frac).numpy(),
            np.asarray(jout.top_fraction_mask(Rj, frac)))
    counts = rng.integers(0, 5, 160).astype(np.int32)
    np.testing.assert_array_equal(
        tout.topk_per_column_mask(Wt, torch.from_numpy(counts)).numpy(),
        np.asarray(jout.topk_per_column_mask(Wj, jnp.asarray(counts))))
    assert float(tout.layer_outlier_ratio(Wt, 5.0)) == pytest.approx(
        float(jout.layer_outlier_ratio(Wj, 5.0)), rel=1e-6)
    for target in (2.0, 2.2, 3.1, 4.0):
        bj, aj = jpol.ap_column_bits(Rj, APConfig(target, 2, 4))
        bt, at = tpol.ap_column_bits(Rt, tpol.APConfig(target, 2, 4))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        assert at == aj
    for extra in (0.07, 0.13, 0.5):
        cj, ej = jpol.or_reserve_counts(Rj, 96, ORConfig(extra))
        ct, et = tpol.or_reserve_counts(Rt, 96, tpol.ORConfig(extra))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert et == ej
    assert tpol.effective_bits(96, bt, ct) == jpol.effective_bits(
        96, jnp.asarray(bt.numpy()), jnp.asarray(ct.numpy()))
    act = rng.uniform(0.5, 2, 160).astype(np.float32)
    np.testing.assert_allclose(
        tpol.magnitude_mp_metric(Wt, torch.from_numpy(act)).numpy(),
        np.asarray(jpol.magnitude_mp_metric(Wj, jnp.asarray(act))),
        rtol=1e-6)
    jq, tq = _q(bits=3, ap=dict(target_bits=2.5), orr=dict(
        extra_bits=0.1))
    assert dataclasses.asdict(tpol.draft_config(tq, 2)) == \
        dataclasses.asdict(jpol.draft_config(jq, 2))
    assert tq.p_max == jq.p_max == 4


@pytest.mark.parametrize("ap,orr,metric", [
    (dict(target_bits=2.2), dict(extra_bits=0.1), "outlier_order"),
    (None, None, "outlier_order"),
    (dict(target_bits=3.0), None, "magnitude_mp"),
])
def test_plan_matrix_equal(ap, orr, metric):
    rng = np.random.default_rng(1)
    W = _weights(rng, 80, 192)
    jq, tq = _q(bits=2, ap=ap, orr=orr)
    pj = jclaq.plan_matrix(jnp.asarray(W), jq, metric=metric)
    pt = tclaq.plan_matrix(torch.from_numpy(W), tq, metric=metric)
    np.testing.assert_array_equal(pt.column_bits, pj.column_bits)
    np.testing.assert_array_equal(pt.reserve_counts, pj.reserve_counts)
    assert pt.achieved_code_bits == pj.achieved_code_bits
    assert pt.achieved_extra_bits == pj.achieved_extra_bits
    np.testing.assert_allclose(pt.outlier_ratio, pj.outlier_ratio,
                               rtol=1e-6)


# ------------------------------------------------------------ kmeans

@pytest.mark.parametrize("k_valid,weighted", [(16, False), (4, True),
                                              (2, True)])
def test_kmeans_1d_matches_reference(k_valid, weighted):
    """Centroids within 1e-6 (one-hot sums in another order), codes
    equal, invalid slots +inf, with k_valid < k_max and weights."""
    rng = np.random.default_rng(k_valid)
    x = rng.normal(size=(200,)).astype(np.float32)
    w = (rng.random(200) > 0.1).astype(np.float32) if weighted else None
    cj, aj = jkm.kmeans_1d(jnp.asarray(x), k_max=16, k_valid=k_valid,
                           iters=6, weight=None if w is None
                           else jnp.asarray(w))
    ct, at = tkm.kmeans_1d(torch.from_numpy(x), 16, k_valid, 6,
                           None if w is None else torch.from_numpy(w))
    assert torch.isinf(ct[k_valid:]).all()
    np.testing.assert_allclose(ct[:k_valid].numpy(),
                               np.asarray(cj)[:k_valid], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert float(tkm.inertia(torch.from_numpy(x), ct)) == pytest.approx(
        float(jkm.inertia(jnp.asarray(x), cj)), rel=1e-5)


def test_kmeans_columns_and_median_of_even_count():
    rng = np.random.default_rng(3)
    W = rng.normal(size=(64, 12)).astype(np.float32)
    kv = rng.choice([2, 4, 8, 16], 12).astype(np.int32)
    wt = (rng.random((64, 12)) > 0.2).astype(np.float32)
    cj, aj = jkm.kmeans_columns(jnp.asarray(W), 16, jnp.asarray(kv), 5,
                                jnp.asarray(wt))
    ct, at = tkm.kmeans_columns(torch.from_numpy(W), 16,
                                torch.from_numpy(kv), 5,
                                torch.from_numpy(wt))
    fin = np.isfinite(np.asarray(cj))
    np.testing.assert_array_equal(torch.isfinite(ct).numpy(), fin)
    np.testing.assert_allclose(ct.numpy()[fin], np.asarray(cj)[fin],
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(
        tkm.dequantize_codes(ct, at).numpy(),
        np.asarray(jkm.dequantize_codes(cj, aj)))
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(tkm._median(x)[0]) == float(jnp.median(
        jnp.asarray([4.0, 1.0, 3.0, 2.0]))) == 2.5


# ------------------------------------------------------------- gptq

def test_hessian_plumbing_and_hinv_cholesky():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(3, 50, 48)).astype(np.float32)
    sj, st = jgptq.init_hessian(48), tgptq.init_hessian(48)
    for b in X:
        sj = jgptq.accumulate_hessian(sj, jnp.asarray(b))
        st = tgptq.accumulate_hessian(st, torch.from_numpy(b))
    Hj, Ht = jgptq.finalize_hessian(sj), tgptq.finalize_hessian(st)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-5,
                               atol=1e-5)
    H = _hessian(rng, 96, dead=(5, 40))
    Uj = np.asarray(jgptq.prepare_hinv_cholesky(jnp.asarray(H), 0.01))
    Ut = tgptq.prepare_hinv_cholesky(torch.from_numpy(H), 0.01).numpy()
    assert np.allclose(np.triu(Ut), Ut)
    # within 1e-4 of the largest entry (LAPACK call orders differ)
    np.testing.assert_allclose(Ut, Uj, rtol=0, atol=1e-4 * np.abs(Uj).max())


@pytest.mark.parametrize("method,mode", [("kmeans", "live"),
                                         ("uniform", "live"),
                                         ("kmeans", "frozen")])
def test_gptq_quantize_matrix_same_u(method, mode):
    """Fed the reference's U: >= 99.9 % of codes equal, the first block's
    codebooks within 1e-5, proxy loss within 1e-3 relative."""
    rng = np.random.default_rng(5)
    rows, cols, B = 64, 128, 32
    W = _weights(rng, rows, cols)
    H = _hessian(rng, cols)
    U = np.asarray(jgptq.prepare_hinv_cholesky(jnp.asarray(H), 0.01))
    bits = rng.choice([2, 4], cols, p=[0.8, 0.2]).astype(np.int32)
    counts = rng.integers(0, 3, cols).astype(np.int32)
    res = np.array(jout.topk_per_column_mask(jnp.asarray(W),
                                             jnp.asarray(counts)))
    frozen_j = frozen_t = None
    if mode == "frozen":
        frozen_j, _ = jkm.kmeans_columns(jnp.asarray(W), 16,
                                         jnp.asarray(2 ** bits), 6,
                                         jnp.asarray(~res, jnp.float32))
        frozen_t = torch.from_numpy(np.array(frozen_j))
    kw = dict(k_max=16, blocksize=B, method=method, kmeans_iters=6,
              codebook_mode=mode)
    rj = jgptq.gptq_quantize_matrix(
        jnp.asarray(W), jnp.asarray(U), jnp.asarray(bits), jnp.asarray(res),
        frozen_codebooks=frozen_j, **kw)
    rt = tgptq.gptq_quantize_matrix(
        torch.from_numpy(W), torch.from_numpy(U.copy()), bits,
        torch.from_numpy(res), frozen_codebooks=frozen_t, **kw)
    same = (rt.codes.numpy() == np.asarray(rj.codes)).mean()
    assert same >= 0.999, same
    cbj = np.asarray(rj.codebooks)[:B]
    fin = np.isfinite(cbj)
    np.testing.assert_array_equal(torch.isfinite(rt.codebooks[:B]).numpy(),
                                  fin)
    np.testing.assert_allclose(rt.codebooks[:B].numpy()[fin], cbj[fin],
                               atol=1e-5, rtol=0)
    Hj = jnp.asarray(H)
    lj = float(jgptq.proxy_loss(jnp.asarray(W), rj.Q, Hj))
    lt = float(tgptq.proxy_loss(torch.from_numpy(W), rt.Q,
                                torch.from_numpy(H)))
    assert lt == pytest.approx(lj, rel=1e-3)


def test_quantize_model_dict_matches_reference():
    rng = np.random.default_rng(6)
    params = {"w1": _weights(rng, 96, 64), "norm": np.ones((96, 64),
                                                           np.float32),
              "tiny": _weights(rng, 16, 64)}
    jq, tq = _q(bits=2, ap=dict(target_bits=2.5), gptq_blocksize=32,
                kmeans_iters=4)
    pj, sj = jclaq.quantize_model({k: jnp.asarray(v)
                                   for k, v in params.items()}, {}, jq)
    pt, st = tclaq.quantize_model({k: torch.from_numpy(v)
                                   for k, v in params.items()}, {}, tq)
    assert list(sj) == ["['w1']"] and list(st) == ["w1"]
    assert isinstance(pt["w1"], tcore.QuantizedTensor)
    assert not isinstance(pt["norm"], tcore.QuantizedTensor)
    assert not isinstance(pt["tiny"], tcore.QuantizedTensor)
    (sj1,), (st1,) = sj.values(), st.values()
    assert st1.effective_bits == sj1.effective_bits
    assert st1.proxy_loss == pytest.approx(sj1.proxy_loss, rel=0.05)


# -------------------------------------------------------- data pipeline

def test_hash_successors_bit_exact():
    rng = np.random.default_rng(7)
    tok = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
    tok[:4] = [0, 1, -1, 2 ** 31 - 1]
    for vocab, branch, salt in ((32000, 4, 0x9E3779B1), (128, 3, 0x85EBCA77),
                                (7, 6, 0x9E3779B1)):
        want = np.asarray(jpipe._hash_successors(jnp.asarray(tok), vocab,
                                                 branch, salt))
        got = tpipe._hash_successors(torch.from_numpy(tok.astype(np.int64)),
                                     vocab, branch, salt)
        np.testing.assert_array_equal(got.numpy(), want)


def test_synth_batch_deterministic_and_structured():
    cfg = tpipe.DataConfig(vocab=500, seq_len=64, batch=8, seed=3)
    a = tpipe.synth_batch(cfg, 5)
    assert a.shape == (8, 64) and a.dtype == torch.int64
    assert torch.equal(a, tpipe.synth_batch(cfg, 5))
    assert not torch.equal(a, tpipe.synth_batch(cfg, 6))
    assert int(a.min()) >= 0 and int(a.max()) < 500
    succ = tpipe._hash_successors(a[:, :-1], 500, 4, 0x9E3779B1)
    follows = (succ == a[:, 1:, None]).any(-1).float().mean()
    assert float(follows) > 0.75               # struct_prob 0.85
    c = tpipe.calibration_set(500, n_segments=3, seq_len=16)
    assert c.shape == (3, 16)


# ------------------------------------------- calibration + whole model

@pytest.fixture(scope="module")
def smoke():
    """The reference's fp smoke model, its tokens, Hessians and CLAQ
    quantization (AP + OR, as tests/test_torch_models.py makes it), and the
    same model in the port."""
    jcfg, tcfg = smoke_cfgs()
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax_tree_to_numpy(params)
    calib = jcalib(vocab=jcfg.vocab, n_segments=4, seq_len=32)
    jq, tq = _q(bits=2, method="kmeans", kmeans_iters=4,
                gptq_blocksize=32, ap=dict(target_bits=2.2, p_lo=2, p_hi=4),
                orr=dict(extra_bits=0.1))
    jh = jlq.calibrate(params, jcfg, calib)
    (jqp, jrep) = jlq.quantize_model_params(params, jcfg, jh, jq)
    return jcfg, tcfg, tree, np.array(calib), jh, jqp, jrep, tq


def test_calibrate_hessians_key_for_key(smoke):
    """Hessians keyed by the reference's tap names, within 1e-5 relative
    of the largest entry (f32 sums through two layers in another order)."""
    jcfg, tcfg, tree, calib, jh, *_ = smoke
    tm = from_numpy_tree(tree, tcfg, device="cpu")
    th = tlq.calibrate(tm, tcfg, torch.from_numpy(calib))
    assert sorted(th) == sorted(jh)
    assert "layers.1.mlp.down" in th and "lm_head" in th
    for k, H in th.items():
        Hj = np.asarray(jh[k])
        np.testing.assert_allclose(H.numpy(), Hj, rtol=1e-5,
                                   atol=1e-5 * np.abs(Hj).max())


def test_claq_quantize_smoke_model_matches_reference(smoke):
    """Same matrices quantized, plans equal (bit classes, column order,
    outlier counts), mean effective bits equal, and the quantized port
    model serves."""
    jcfg, tcfg, tree, calib, _, jqp, jrep, tq = smoke
    tm = from_numpy_tree(tree, tcfg, device="cpu")
    tm, trep = tlq.claq_quantize(tm, tcfg, torch.from_numpy(calib), tq)
    assert sorted(trep.stats) == sorted(jrep.stats)
    assert len(trep.stats) == 7 * tcfg.n_layers
    assert trep.mean_effective_bits == jrep.mean_effective_bits
    assert trep.total_proxy_loss == pytest.approx(jrep.total_proxy_loss,
                                                  rel=0.05)
    for i, blk in enumerate(tm.blocks):
        for name, m in [("attn.q", blk.attn.q), ("mlp.down", blk.mlp.down)]:
            t = m.kernel
            j = jqp["blocks"]
            for part in name.split("."):
                j = j[part]
            j = j["kernel"]
            assert isinstance(t, tcore.QuantizedTensor)
            assert [s.bits for s in t.stripes] == [s.bits for s in j.stripes]
            np.testing.assert_array_equal(t.col_perm.numpy(),
                                          np.asarray(j.col_perm[i]))
            np.testing.assert_array_equal(t.out_count.numpy(),
                                          np.asarray(j.out_count[i]))
    assert not isinstance(tm.lm_head.kernel, tcore.QuantizedTensor)


def test_serve_launcher_quantizes_and_serves_int8(capsys, monkeypatch):
    plain = tdm.plain_count
    st = tserve.main(["--arch", "llama1_7b", "--smoke", "--bits", "2.2",
                      "--act-dtype", "int8", "--requests", "3",
                      "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "CLAQ-quantized to 2.2" in out
    assert "activations: per-token int8" in out
    assert "[serve] 3 requests, 12 tokens" in out
    assert st["act_dtype"] == "int8" and st["lifecycle"]["finished"] == 3
    assert tdm.plain_count > plain
    # the default device is the card: without one it says so
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "llama1_7b", "--smoke"])
