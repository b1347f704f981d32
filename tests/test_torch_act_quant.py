"""Port parity for int8 activations (K1e's path): the port's
``quantize_activations`` bitwise against the reference (f32 and bf16 x,
all-zero rows, .5 ties), ``prepared_qmatmul(act_dtype="int8")`` in both
gather modes over 1/2/3/4/8-bit groups with and without outliers against
the reference's interpret-mode Pallas path (atol 1e-4: f32 sums taken in
another order), the analytic error bound of tests/test_act_quant.py, and
``ServingEngine(act_dtype="int8")`` against the reference engine."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import modules as jmods  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.convert import from_numpy_tree, quantized_from_numpy  # noqa: E402
from repro_torch.kernels import dequant_matmul as tdm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import modules as tmods  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from test_torch_models import (jax_tree_to_numpy, quantize_reference,  # noqa: E402
                               smoke_cfgs)
from test_torch_packing import qt_to_numpy  # noqa: E402
from test_torch_plan import make_qt  # noqa: E402
from test_torch_serving import _assert_tokens_match, _serve  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _same_inputs(x32, dtype):
    """The same x for both packages: f32 as is; bf16 rounded once by JAX
    and handed to torch through its 16-bit pattern."""
    if dtype == "f32":
        return jnp.asarray(x32), torch.from_numpy(x32.copy())
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    bits = np.asarray(xj).view(np.int16).copy()
    return xj, torch.from_numpy(bits).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_bitwise(dtype):
    """xq and scale bit for bit, the trap included: for bf16 x the absmax
    and absmax / 127 are bf16 arithmetic before the f32 cast."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 40)) * rng.uniform(0.01, 30, (6, 1))).astype(
        np.float32)
    x[2] = 0.0                                      # all-zero row: scale 1
    x[4, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]   # .5 ties
    x[4, 8:] = 0.0
    xj, xt = _same_inputs(x, dtype)
    qj, sj = jops.quantize_activations(xj)
    qt, st = tops.quantize_activations(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.shape == (6, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[2, 0]) == 1.0 and not qt[2].any()
    # half to even at the ties: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
    assert qt[4, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


def test_normalize_act_dtype_and_unprepared_rejection():
    assert tops.normalize_act_dtype("int8") == "int8"
    assert tops.normalize_act_dtype("f32") is None
    with pytest.raises(ValueError, match="act_dtype"):
        tops.normalize_act_dtype("int4")
    rng = np.random.default_rng(0)
    qt = quantized_from_numpy(qt_to_numpy(
        make_qt(rng, rows=32, stripe_spec=[(2, 48)])), device="cpu")
    with pytest.raises(ValueError, match="plan"):
        tops.qmatmul(torch.zeros((3, 48)), qt, use_kernel=True,
                     act_dtype="int8")


SPECS = [
    ([(1, 96)], 0, True),                 # aligned single width
    ([(8, 70)], 2, True),                 # 8-bit codebook, outliers
    ([(2, 80), (4, 48)], 3, False),       # two launches, scale on the last
    ([(2, 40), (3, 56), (4, 32)], 0, False),
]


@pytest.mark.parametrize("spec,k_out,identity", SPECS)
def test_prepared_int8_matches_reference_both_gathers(spec, k_out, identity):
    rng = np.random.default_rng(sum(b * n for b, n in spec) + k_out)
    jqt = make_qt(rng, rows=72, stripe_spec=spec, k_out=k_out,
                  identity=identity)
    jpqt = jplan.prepare_for_inference(jqt)
    pqt = tplan.prepare_for_inference(
        quantized_from_numpy(qt_to_numpy(jqt), device="cpu"))
    x = rng.normal(size=(5, jqt.cols)).astype(np.float32)
    xt = torch.from_numpy(x)
    out = {}
    for gather in ("kernel", "xla"):
        plain = tdm.plain_count
        got = tops.prepared_qmatmul(xt, pqt, gather=gather, act_dtype="int8")
        assert tdm.plain_count - plain == len(pqt.groups)
        want = jops.prepared_qmatmul(jnp.asarray(x), jpqt, interpret=True,
                                     gather=gather, act_dtype="int8")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        out[gather] = got
    assert torch.equal(out["kernel"], out["xla"])
    # the eager reference path (quantizes after the f32 cast)
    got = tops.qmatmul(xt, pqt, use_kernel=False, act_dtype="int8")
    want = jops.qmatmul(jnp.asarray(x), jpqt, use_kernel=False,
                        act_dtype="int8")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_prepared_int8_bf16_x_matches_reference():
    """A bf16 x is quantized in bf16 (the kernel path's trap) and the
    result comes back in bf16.  Products in f32 on both sides (the
    reference's CPU backend has no bf16 x bf16 -> f32 dot); the f32 sums
    may round to neighbouring bf16 values: one bf16 ulp (rtol 8e-3)."""
    rng = np.random.default_rng(5)
    jqt = make_qt(rng, rows=64, stripe_spec=[(2, 80), (4, 48)], k_out=2)
    jpqt = jplan.prepare_for_inference(jqt)
    pqt = tplan.prepare_for_inference(
        quantized_from_numpy(qt_to_numpy(jqt), device="cpu"))
    xj, xt = _same_inputs(rng.normal(size=(4, jqt.cols)).astype(np.float32),
                          "bf16")
    got = tops.qmatmul(xt, pqt, use_kernel=True, act_dtype="int8",
                       compute_dtype=torch.float32)
    want = jops.qmatmul(xj, jpqt, use_kernel=True, interpret=True,
                        act_dtype="int8", compute_dtype=jnp.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=1e-2)


@pytest.mark.parametrize("spec,k_out", [
    ([(2, 96)], 0),
    ([(3, 140)], 2),
    ([(2, 80), (4, 48)], 3),
])
def test_int8_error_bound_all_paths(spec, k_out):
    """Mirror of tests/test_act_quant.py::test_int8_error_bound_all_paths
    on the port: both gather modes bitwise equal, and every path within
    scale/2 * ||W||_1 (+1 % and 1e-5 for f32 summation order) of the f32
    product; the bound itself equals the reference's."""
    rng = np.random.default_rng(sum(b for b, _ in spec) + k_out)
    jqt = make_qt(rng, rows=64, stripe_spec=spec, k_out=k_out)
    qt = quantized_from_numpy(qt_to_numpy(jqt), device="cpu")
    pqt = tplan.prepare_for_inference(qt)
    x = torch.from_numpy(rng.normal(size=(5, qt.cols)).astype(np.float32))
    y_ref = tref.ref_qmatmul(x, qt)
    W = qt.dequantize()
    bound = tref.ref_act_int8_bound(x, W)
    np.testing.assert_allclose(
        bound.numpy(), np.asarray(jref.ref_act_int8_bound(
            jnp.asarray(x.numpy()), jnp.asarray(W.numpy()))), rtol=1e-6)
    bound = bound * 1.01 + 1e-5
    y_ker = tops.prepared_qmatmul(x, pqt, act_dtype="int8")
    y_pre = tops.prepared_qmatmul(x, pqt, gather="xla", act_dtype="int8")
    y_xla = tops.qmatmul(x, pqt, use_kernel=False, act_dtype="int8")
    assert torch.equal(y_ker, y_pre)
    for y in (y_ker, y_xla):
        err = (y - y_ref).abs()
        assert bool((err <= bound).all()), (float(err.max()),
                                            float(bound.max()))
    assert not torch.equal(y_ker, y_ref)      # int8 really quantized


def test_plain_kernel_x_scale_semantics():
    """The K1e operand on its own: int8 x and an (M, 1) scale multiply the
    whole output, acc seed included: (acc + x @ W^T) * scale."""
    rng = np.random.default_rng(2)
    jqt = make_qt(rng, rows=32, stripe_spec=[(2, 64)], identity=True)
    pqt = tplan.prepare_for_inference(
        quantized_from_numpy(qt_to_numpy(jqt), device="cpu"))
    g = pqt.groups[0]
    xq = torch.from_numpy(rng.integers(-127, 128, (3, 64)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 1, (3, 1)).astype(np.float32))
    acc = torch.from_numpy(rng.normal(size=(3, pqt.n_padded)).astype(
        np.float32))
    kw = dict(bits=2, n=pqt.n_padded, x_mode="aligned", k_cols=64)
    y = tdm.dequant_matmul(xq, g.planes, g.codebook, None, None, acc=acc,
                           x_scale=s, **kw)
    y0 = tdm.dequant_matmul(xq.float(), g.planes, g.codebook, None, None,
                            acc=acc, **kw)
    assert torch.equal(y, y0 * s)
    with pytest.raises(ValueError, match="x_scale"):
        tdm.dequant_matmul(xq, g.planes, g.codebook, None, None,
                           x_scale=s[:2], **kw)


def test_activation_quant_scopes_and_restores():
    assert tmods.QuantMode.act_dtype is None
    with tmods.activation_quant("int8"):
        assert tmods.QuantMode.act_dtype == "int8"
    assert tmods.QuantMode.act_dtype is None


@pytest.fixture(scope="module")
def quantized():
    jcfg, tcfg = smoke_cfgs()
    qparams = quantize_reference(japi.init_params(jax.random.PRNGKey(0),
                                                  jcfg), jcfg)
    tm = from_numpy_tree(jax_tree_to_numpy(qparams), tcfg, device="cpu")
    return jcfg, tcfg, qparams, tm


def test_engine_int8_tokens_match_reference_engine(quantized):
    """Greedy tokens of the int8 engines, the reference run in kernel mode
    (interpret-mode Pallas, quantizing in x's dtype like the port), equal
    except after a near tie of the port's f32 logits."""
    jcfg, tcfg, qparams, tm = quantized
    prompts = [[1, 2], [3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15, 16]]
    with jmods.quant_mode("kernel", interpret=True):
        want = _serve(JaxEngine(qparams, jcfg, n_slots=4, max_len=32,
                                min_bucket=8, act_dtype="int8"),
                      prompts, max_new=4)
    eng = ServingEngine(tm, tcfg, n_slots=4, max_len=32, min_bucket=8,
                        act_dtype="int8", device="cpu")
    assert eng.stats()["act_dtype"] == "int8"
    plain = tdm.plain_count
    got = _serve(eng, prompts, max_new=4)
    assert tdm.plain_count > plain
    assert tmods.QuantMode.act_dtype is None          # scope restored
    assert all(len(t) == 4 for t in got)
    with tmods.activation_quant("int8"):
        _assert_tokens_match(tm, tcfg, prompts, got, want)
    assert ServingEngine(tm, tcfg, n_slots=1, max_len=8,
                         device="cpu").stats()["act_dtype"] == "f32"


def test_engine_act_dtype_validation(quantized):
    _, tcfg, _, tm = quantized
    with pytest.raises(ValueError, match="act_dtype"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=32, act_dtype="int4",
                      device="cpu")
    with pytest.raises(ValueError, match="prepare"):
        ServingEngine(tm, tcfg, n_slots=2, max_len=32, act_dtype="int8",
                      prepare=False, device="cpu")
