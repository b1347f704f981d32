"""Port parity: ``repro_torch.kernels.plan`` builds the same inference plan
as ``repro.kernels.plan`` — every array bit-for-bit and every static field
equal — for single and mixed bit-widths, duplicate bit-widths, shapes that
are not block multiples, outliers, and a CLAQ AP+OR tensor."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import APConfig, CLAQConfig, ORConfig, quantize_matrix  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core.quantized import QuantStripe, QuantizedTensor  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro_torch.convert import quantized_from_numpy  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from test_torch_packing import qt_to_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def make_qt(rng, rows, stripe_spec, k_out=0, identity=False):
    """Synthetic multi-stripe reference QuantizedTensor (the layout of
    tests/test_plan.py::_make_qt).  stripe_spec: [(bits, n_cols)]."""
    cols = sum(n for _, n in stripe_spec)
    stripes = []
    for bits, n_cols in stripe_spec:
        codes = rng.integers(0, 2 ** bits, size=(rows, n_cols)).astype(np.int32)
        cb = np.sort(rng.normal(size=(n_cols, 2 ** bits)).astype(np.float32),
                     axis=1)
        stripes.append(QuantStripe(
            packed=jpack.pack_codes(jnp.asarray(codes), bits),
            codebook=jnp.asarray(cb), bits=bits))
    perm = np.arange(cols) if identity else rng.permutation(cols)
    if k_out > 0:
        oi = np.stack([rng.permutation(rows)[:k_out] for _ in range(cols)],
                      axis=1).astype(np.int32)
        ov = rng.normal(size=(k_out, cols)).astype(np.float32)
        cnt = rng.integers(0, k_out + 1, size=(cols,)).astype(np.int32)
    else:
        oi = np.zeros((0, cols), np.int32)
        ov = np.zeros((0, cols), np.float32)
        cnt = np.zeros((cols,), np.int32)
    return QuantizedTensor(
        stripes=tuple(stripes), col_perm=jnp.asarray(perm.astype(np.int32)),
        out_idx=jnp.asarray(oi), out_val=jnp.asarray(ov),
        out_count=jnp.asarray(cnt), shape=(rows, cols))


def _arr(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_same_plan(jqt, **kw):
    ref = jplan.prepare_for_inference(jqt, **kw)
    got = tplan.prepare_for_inference(
        quantized_from_numpy(qt_to_numpy(jqt), device="cpu"), **kw)
    assert (got.shape, got.n_padded, got.bn) == (tuple(ref.shape),
                                                 ref.n_padded, ref.bn)
    np.testing.assert_array_equal(got.gather_idx.numpy(), _arr(ref.gather_idx))
    assert len(got.groups) == len(ref.groups)
    for g, r in zip(got.groups, ref.groups):
        assert (g.bits, g.bk, g.k_cols, g.x_start) == (r.bits, r.bk, r.k_cols,
                                                       r.x_start)
        assert len(g.planes) == len(r.planes)
        for p, q in zip(g.planes, r.planes):
            np.testing.assert_array_equal(p.numpy(), _arr(q))
        np.testing.assert_array_equal(g.codebook.numpy(), _arr(r.codebook))
        for name in ("out_idx", "out_val", "x_idx"):
            a, b = getattr(g, name), getattr(r, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), _arr(b))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(ref.dequantize()))
    return got


@pytest.mark.parametrize("spec,k_out", [
    ([(2, 96)], 0), ([(3, 96)], 3), ([(4, 96)], 2),
    ([(2, 80), (4, 48)], 2),             # the layout AP emits
    ([(2, 40), (3, 56), (4, 32)], 0),    # three distinct bit-widths
    ([(2, 24), (4, 40), (2, 32)], 2),    # duplicate bit-widths fuse
])
def test_plan_equals_reference(spec, k_out):
    rng = np.random.default_rng(len(spec) * 100 + k_out)
    got = assert_same_plan(make_qt(rng, rows=96, stripe_spec=spec,
                                   k_out=k_out))
    assert len(got.groups) == len({b for b, _ in spec})


def test_non_block_multiple_shapes_and_small_blocks():
    rng = np.random.default_rng(5)
    jqt = make_qt(rng, rows=40, stripe_spec=[(2, 72), (4, 19)], k_out=2)
    assert_same_plan(jqt)
    assert_same_plan(jqt, bn=32, bk=128)


def test_identity_perm_is_aligned():
    rng = np.random.default_rng(21)
    jqt = make_qt(rng, rows=64, stripe_spec=[(3, 200)], k_out=2,
                  identity=True)
    got = assert_same_plan(jqt)
    assert got.x_gather_free and got.groups[0].x_idx is None


def test_claq_ap_or_tensor_plan():
    """A tensor from the reference's CLAQ quantizer (AP + OR)."""
    rng = np.random.default_rng(0)
    rows, cols = 96, 160
    W = rng.normal(size=(rows, cols)).astype(np.float32)
    W[:, :10] += rng.standard_t(df=2, size=(rows, 10)) * 4
    X = rng.normal(size=(256, cols)).astype(np.float32)
    jqt, _, _ = quantize_matrix(jnp.asarray(W), jnp.asarray(2 * X.T @ X),
                                CLAQConfig(bits=2, method="kmeans",
                                           kmeans_iters=5, gptq_blocksize=32,
                                           ap=APConfig(2.5, 2, 4),
                                           orr=ORConfig(0.15)))
    assert len(jqt.stripes) > 1 and jqt.out_idx.shape[0] > 0
    assert_same_plan(jqt)


def test_prepare_tree_replaces_quantized_kernels_in_place():
    from repro_torch.models.modules import Dense
    rng = np.random.default_rng(3)
    qt = quantized_from_numpy(qt_to_numpy(
        make_qt(rng, rows=32, stripe_spec=[(2, 48)])), device="cpu")
    mod = torch.nn.ModuleDict({"a": Dense(qt), "b": Dense(torch.ones(4, 4))})
    assert tplan.prepare_tree(mod) is mod
    assert isinstance(mod["a"].kernel, tplan.PreparedQuantizedTensor)
    assert isinstance(mod["b"].kernel, torch.Tensor)
    prepared = mod["a"].kernel
    tplan.prepare_tree(mod)               # idempotent on prepared kernels
    assert mod["a"].kernel is prepared
