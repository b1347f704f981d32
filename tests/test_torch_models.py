"""Port parity for the dense model: on the llama1_7b smoke config (f32,
2 layers), the reference's fp params and its AP+OR CLAQ params cross
through ``repro_torch.convert.from_numpy_tree``; ``forward``,
``prefill_step`` (right-padded, with ``logits_at``) and successive
``decode_step`` logits and cache contents then match the reference to
atol 1e-4 (f32 sums taken in another order; the quantized port runs the
dequant-GEMM's plain version, the reference its dequantize + einsum)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro.core.quantized import QuantizedTensor  # noqa: E402
from repro.data import calibration_set  # noqa: E402
from repro.launch.quantize import claq_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import modules as jmods  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.kernels.plan import prepare_tree  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import modules as tmods  # noqa: E402
from test_torch_packing import qt_to_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL = 1e-4


def jax_tree_to_numpy(params):
    """Reference params -> the numpy tree the port's converter takes
    (QuantizedTensor leaves become dicts)."""
    return jax.tree_util.tree_map(
        lambda l: qt_to_numpy(l) if isinstance(l, QuantizedTensor)
        else np.asarray(l),
        params, is_leaf=lambda l: isinstance(l, QuantizedTensor))


def smoke_cfgs():
    """The same smoke config from both packages (the port's is a copy)."""
    kw = dict(vocab=128, n_layers=2)
    jcfg = dataclasses.replace(get_smoke_config("llama1_7b"), **kw)
    tcfg = dataclasses.replace(t_smoke("llama1_7b"), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def quantize_reference(params, cfg):
    """AP+OR CLAQ quantization, as tests/test_serving.py makes it."""
    qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                      orr=ORConfig(0.1))
    calib = calibration_set(vocab=cfg.vocab, n_segments=4, seq_len=32)
    qparams, report = claq_quantize(params, cfg, calib, qcfg)
    assert 2.0 < report.mean_effective_bits < 2.6
    return qparams


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = smoke_cfgs()
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    qparams = quantize_reference(params, jcfg)
    out = {}
    for tag, p in (("fp", params), ("claq", qparams)):
        tm = from_numpy_tree(jax_tree_to_numpy(p), tcfg, device="cpu")
        out[tag] = (p, prepare_tree(tm))
    return jcfg, tcfg, out


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_forward_logits(models, tag):
    jcfg, tcfg, m = models
    jp, tm = m[tag]
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 11))
    want, _, _ = jax.jit(lambda p, t: japi.tf.forward(p, jcfg, t))(
        jp, jnp.asarray(toks, jnp.int32))
    got, _, _ = tapi.tf.forward(tm, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("tag", ["fp", "claq"])
def test_prefill_and_decode_logits_and_cache(models, tag):
    jcfg, tcfg, m = models
    jp, tm = m[tag]
    rng = np.random.default_rng(1)
    lens = np.array([5, 9])
    toks = np.zeros((2, 16), np.int64)           # right-padded to a bucket
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(0, jcfg.vocab, size=n)
    jcache = japi.make_cache(jcfg, 2, 32, dtype=jnp.float32)
    tcache = tapi.make_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    jpre = jax.jit(lambda p, t, c, at: japi.prefill_step(
        p, jcfg, {"tokens": t}, c, logits_at=at))
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))

    jl, jcache = jpre(jp, jnp.asarray(toks, jnp.int32), jcache,
                      jnp.asarray(lens - 1, jnp.int32))
    tl, tcache = tapi.prefill_step(tm, tcfg, {"tokens": torch.from_numpy(toks)},
                                   tcache,
                                   logits_at=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)

    def check_cache():
        for i, c in enumerate(tcache):
            np.testing.assert_allclose(c.k.numpy(), np.asarray(jcache.k[i]),
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(c.v.numpy(), np.asarray(jcache.v[i]),
                                       atol=ATOL, rtol=0)
            np.testing.assert_array_equal(c.length.numpy(),
                                          np.asarray(jcache.length[i]))

    check_cache()
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(3):
        jl, jcache = jdec(jp, jnp.asarray(tok, jnp.int32), jcache)
        tl, tcache = tapi.decode_step(tm, tcfg, torch.tensor(tok),
                                      tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    check_cache()


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norms_match_reference(norm):
    """rms_norm / layer_norm in f32, to f32 summation order."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    if norm == "rms":
        want = jmods.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
        got = tmods.rms_norm(torch.from_numpy(scale), torch.from_numpy(x))
    else:
        want = jmods.layer_norm({"scale": jnp.asarray(scale),
                                 "bias": jnp.asarray(bias)}, jnp.asarray(x))
        got = tmods.layer_norm(torch.from_numpy(scale),
                               torch.from_numpy(bias), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device="cpu" the port's entry points want CUDA and, where
    there is none, say so instead of running on the CPU."""
    _, tcfg = smoke_cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.make_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.init_params(torch.Generator(), tcfg)


def test_other_families_are_not_ported_yet():
    cfg = t_smoke("qwen3_moe_30b_a3b")
    with pytest.raises(NotImplementedError):
        tapi.make_cache(cfg, 1, 8, device="cpu")
