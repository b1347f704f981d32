"""Port parity for K1, the dequant GEMM: the plain version of
``repro_torch.kernels.dequant_matmul`` (what the wrapper runs for CPU
tensors) against the reference Pallas kernel in interpret mode, in every
x mode, with and without acc and outliers, at the tolerances of
tests/test_kernels.py (f32: rtol 1e-4 / atol 1e-3; bf16: 0.15).  Plus the
port's dispatch contracts: gather="kernel" equals gather="xla" bitwise, one
group call per distinct bit-width, and nothing is built on import."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import dequant_matmul as jdm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import quantized_from_numpy  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels import dequant_matmul as tdm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_packing import qt_to_numpy  # noqa: E402
from test_torch_plan import make_qt  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

M = 5


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


@pytest.fixture(scope="module")
def layouts():
    """Reference plans: an identity-perm single-bit tensor (aligned, with a
    masked K tail: 200 columns in a 256 block) and a permuted
    mixed-precision one (gathered), both with outliers."""
    rng = np.random.default_rng(7)
    aligned = make_qt(rng, rows=64, stripe_spec=[(3, 200)], k_out=2,
                      identity=True)
    permuted = make_qt(rng, rows=96, stripe_spec=[(2, 80), (4, 48)], k_out=3)
    x = rng.normal(size=(M, 200)).astype(np.float32)
    xp = rng.normal(size=(M, 128)).astype(np.float32)
    return {"aligned": (jplan.prepare_for_inference(aligned, bn=32, bk=512),
                        x),
            "gathered": (jplan.prepare_for_inference(permuted, bn=32,
                                                     bk=128), xp)}


def _run_pair(pqt, x, x_mode, with_acc, with_outliers, compute):
    g = pqt.groups[-1]
    rng = np.random.default_rng(11)
    acc = (rng.normal(size=(M, pqt.n_padded)).astype(np.float32)
           if with_acc else None)
    oi = g.out_idx if with_outliers else None
    ov = g.out_val if with_outliers else None
    kw = dict(bits=g.bits, n=pqt.n_padded)
    jkw, tkw = {}, {}
    xj = x
    if x_mode == "aligned":
        jkw = dict(x_base=g.x_start // g.bk, k_cols=g.k_cols)
        tkw = dict(x_start=g.x_start, k_cols=g.k_cols)
    elif x_mode == "gathered":
        jkw = dict(x_idx=g.x_idx)
        tkw = dict(x_idx=_t(g.x_idx))
    else:  # blocked: x pre-gathered into the group's fused order
        off = sum(h.k_padded for h in pqt.groups[:-1])
        idx = np.asarray(pqt.gather_idx)[off:off + g.k_padded]
        xj = np.where(idx[None, :] < x.shape[1],
                      x[:, np.minimum(idx, x.shape[1] - 1)], 0.0)
        xj = xj.astype(np.float32)
    bm = 8
    xpad = np.zeros((bm, xj.shape[1]), np.float32)
    xpad[:M] = xj
    apad = None
    if acc is not None:
        apad = np.zeros((bm, pqt.n_padded), np.float32)
        apad[:M] = acc
    jdt = jnp.float32 if compute == "f32" else jnp.bfloat16
    want = jdm.dequant_matmul(
        jnp.asarray(xpad), g.planes, g.codebook, oi, ov, bm=bm, bn=pqt.bn,
        bk=g.bk, interpret=True, compute_dtype=jdt,
        acc=None if apad is None else jnp.asarray(apad), x_mode=x_mode,
        **jkw, **kw)
    tdt = torch.float32 if compute == "f32" else torch.bfloat16
    got = tdm.dequant_matmul_plain(
        torch.from_numpy(xj.copy()), tuple(_t(p) for p in g.planes),
        _t(g.codebook), None if oi is None else _t(oi),
        None if ov is None else _t(ov), compute_dtype=tdt,
        acc=None if acc is None else torch.from_numpy(acc),
        x_mode=x_mode, **tkw, **kw)
    return got.numpy(), np.asarray(want)[:M]


@pytest.mark.parametrize("x_mode", ["aligned", "gathered", "blocked"])
@pytest.mark.parametrize("with_acc,with_outliers",
                         [(False, False), (True, True)])
def test_plain_matches_pallas_interpret_f32(layouts, x_mode, with_acc,
                                            with_outliers):
    pqt, x = layouts["aligned" if x_mode == "aligned" else "gathered"]
    got, want = _run_pair(pqt, x, x_mode, with_acc, with_outliers, "f32")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("x_mode", ["aligned", "gathered"])
def test_plain_matches_pallas_interpret_bf16(layouts, x_mode):
    pqt, x = layouts[x_mode]
    got, want = _run_pair(pqt, x, x_mode, True, True, "bf16")
    np.testing.assert_allclose(got, want, rtol=0.15, atol=1.5)


@pytest.mark.parametrize("spec,identity", [
    ([(2, 96)], True), ([(2, 80), (4, 48)], False),
    ([(2, 40), (3, 56), (4, 32)], False), ([(2, 24), (4, 40), (2, 32)], False),
])
def test_prepared_qmatmul_gather_modes_bitwise_and_vs_reference(spec,
                                                                identity):
    rng = np.random.default_rng(len(spec))
    jqt = make_qt(rng, rows=72, stripe_spec=spec, k_out=2, identity=identity)
    cols = jqt.cols
    x = rng.normal(size=(3, 2, cols)).astype(np.float32)
    pqt = tplan.prepare_for_inference(
        quantized_from_numpy(qt_to_numpy(jqt), device="cpu"))
    xt = torch.from_numpy(x)
    y_k = tops.prepared_qmatmul(xt, pqt, gather="kernel")
    y_x = tops.prepared_qmatmul(xt, pqt, gather="xla")
    assert torch.equal(y_k, y_x), "gather='kernel' diverged from 'xla'"
    assert y_k.shape == (3, 2, jqt.rows) and y_k.dtype == torch.float32
    want = np.asarray(jref.ref_qmatmul(jnp.asarray(x), jqt))
    np.testing.assert_allclose(y_k.numpy(), want, rtol=1e-4, atol=1e-3)
    # the eager reference path over the plan agrees too
    y_ref = tops.qmatmul(xt, pqt, use_kernel=False)
    np.testing.assert_allclose(y_ref.numpy(), want, rtol=1e-5, atol=1e-5)
    # bf16 activations compute in bf16 and come back as bf16
    y_b = tops.qmatmul(xt.to(torch.bfloat16), pqt, use_kernel=True)
    assert y_b.dtype == torch.bfloat16
    np.testing.assert_allclose(y_b.float().numpy(), want, rtol=0.15,
                               atol=1.5)


def test_unprepared_qmatmul_matches_reference_kernel_path():
    rng = np.random.default_rng(4)
    jqt = make_qt(rng, rows=40, stripe_spec=[(2, 72), (4, 19)], k_out=2)
    x = rng.normal(size=(6, jqt.cols)).astype(np.float32)
    qt = quantized_from_numpy(qt_to_numpy(jqt), device="cpu")
    got = tops.qmatmul(torch.from_numpy(x), qt, use_kernel=True)
    want = jops.qmatmul(jnp.asarray(x), jqt, use_kernel=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_group_calls_are_distinct_bitwidths_and_nothing_is_built():
    """One dispatch per distinct bit-width (4 stripes, 3 widths), in both
    gather modes.  On CPU tensors the wrapper runs the plain version, so
    plain_count moves and launch_count (CUDA launches) does not; no CUDA
    library was built or loaded by importing or running the port."""
    rng = np.random.default_rng(9)
    jqt = make_qt(rng, rows=64, stripe_spec=[(2, 40), (4, 56), (2, 24),
                                             (3, 32)], k_out=1)
    pqt = tplan.prepare_for_inference(
        quantized_from_numpy(qt_to_numpy(jqt), device="cpu"))
    x = torch.from_numpy(rng.normal(size=(5, jqt.cols)).astype(np.float32))
    for gather in ("kernel", "xla"):
        launches, plain = tdm.launch_count, tdm.plain_count
        tops.prepared_qmatmul(x, pqt, gather=gather)
        assert tdm.plain_count - plain == 3
        assert tdm.launch_count == launches
    assert tdm._FN is None and cuda_build._BUILT == {}


@pytest.mark.parametrize("bits", [1, 3, 8])
def test_ref_oracles_match_reference(bits):
    """ref_dequant / ref_apply_outliers / ref_dequant_matmul over one stripe
    with outliers: W bit-exact, y to f32 summation order."""
    rng = np.random.default_rng(bits)
    jqt = make_qt(rng, rows=45, stripe_spec=[(bits, 70)], k_out=2,
                  identity=True)
    s = jqt.stripes[0]
    oi = np.asarray(jqt.out_idx)
    oi = np.where(np.arange(2)[:, None] < np.asarray(jqt.out_count)[None, :],
                  oi, -1).astype(np.int32)
    ov = np.asarray(jqt.out_val)
    x = rng.normal(size=(4, 70)).astype(np.float32)
    kw = dict(bits=bits, n=45)
    want_w = jref.ref_apply_outliers(
        jref.ref_dequant(s.packed, s.codebook, bits, 45), jnp.asarray(oi),
        jnp.asarray(ov))
    got_w = tref.ref_apply_outliers(
        tref.ref_dequant(_t(s.packed), _t(s.codebook), bits, 45), _t(oi),
        _t(ov))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    want = jref.ref_dequant_matmul(jnp.asarray(x), s.packed, s.codebook,
                                   jnp.asarray(oi), jnp.asarray(ov), **kw)
    got = tref.ref_dequant_matmul(torch.from_numpy(x), _t(s.packed),
                                  _t(s.codebook), _t(oi), _t(ov), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_rejects_int8_activations():
    """int8 x is accepted (K1e), but not with a malformed scale, and int8
    activations need a prepared plan, as in the reference."""
    rng = np.random.default_rng(1)
    jqt = make_qt(rng, rows=32, stripe_spec=[(2, 64)], identity=True)
    qt = quantized_from_numpy(qt_to_numpy(jqt), device="cpu")
    pqt = tplan.prepare_for_inference(qt)
    g = pqt.groups[0]
    xq = torch.zeros((2, 64), dtype=torch.int8)
    kw = dict(bits=2, n=pqt.n_padded, x_mode="aligned", k_cols=64)
    for bad in (torch.ones((2,)), torch.ones((3, 1)),
                torch.ones((2, 1), dtype=torch.float64)):
        with pytest.raises(ValueError, match="x_scale"):
            tdm.dequant_matmul(xq, g.planes, g.codebook, None, None,
                               x_scale=bad, **kw)
    with pytest.raises(TypeError, match="int8"):
        tdm.dequant_matmul(xq.to(torch.int16), g.planes, g.codebook, None,
                           None, **kw)
    with pytest.raises(ValueError, match="plan"):
        tops.qmatmul(torch.zeros((2, 64)), qt, use_kernel=True,
                     act_dtype="int8")
