"""Port parity: bit packing and the QuantizedTensor format of
``repro_torch.core`` against ``repro.core``, word for word and bit-exact.
Packed words cross as int32 views of the reference's uint32."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core import quantized as jq  # noqa: E402
from repro_torch.convert import quantized_from_numpy  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import quantized as tq  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def qt_to_numpy(qt):
    """A reference QuantizedTensor as the dict ``repro_torch.convert``
    takes (stacked or not)."""
    return {
        "stripes": [{"packed": np.asarray(s.packed),
                     "codebook": np.asarray(s.codebook), "bits": s.bits}
                    for s in qt.stripes],
        "col_perm": np.asarray(qt.col_perm),
        "out_idx": np.asarray(qt.out_idx),
        "out_val": np.asarray(qt.out_val),
        "out_count": np.asarray(qt.out_count),
        "shape": tuple(qt.shape)}


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("rows", [32, 45, 70])
def test_pack_unpack_word_for_word(bits, rows):
    rng = np.random.default_rng(bits * 100 + rows)
    codes = rng.integers(0, 2 ** bits, size=(rows, 13)).astype(np.int32)
    ref = np.asarray(jpack.pack_codes(jnp.asarray(codes), bits))
    got = tpack.pack_codes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.view(np.int32))
    assert got.shape[0] == tpack.packed_rows(rows, bits)
    # unpack the reference's words with the port (sign-bit words included)
    back = tpack.unpack_codes(torch.from_numpy(ref.view(np.int32).copy()),
                              bits,
                              rows)
    np.testing.assert_array_equal(back.numpy(), codes)
    for a, b in zip(tpack.split_planes(got, bits, rows),
                    jpack.split_planes(jnp.asarray(ref), bits, rows)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).view(np.int32))


def _jax_qt(rng, rows, cols, k_max):
    """Reference build_quantized_tensor on seeded AP-style inputs."""
    column_bits = rng.choice([2, 3, 4], size=cols, p=[0.6, 0.2, 0.2])
    codes = np.stack([rng.integers(0, 2 ** b, size=rows)
                      for b in column_bits], axis=1).astype(np.int32)
    cb = np.sort(rng.normal(size=(cols, 16)).astype(np.float32), axis=1)
    cb[np.arange(16)[None, :] >= (2 ** column_bits)[:, None]] = np.inf
    counts = rng.integers(0, k_max + 1, size=cols)
    mask = np.zeros((rows, cols), bool)
    for c in range(cols):
        mask[rng.permutation(rows)[:counts[c]], c] = True
    Q = rng.normal(size=(rows, cols)).astype(np.float32)
    args = (codes, cb, column_bits, counts, Q, mask)
    return args, jq.build_quantized_tensor(
        jnp.asarray(codes), jnp.asarray(cb), column_bits, counts,
        jnp.asarray(Q), jnp.asarray(mask))


@pytest.mark.parametrize("rows,cols,k_max", [(40, 24, 3), (64, 50, 0)])
def test_build_and_dequantize_bit_exact(rows, cols, k_max):
    rng = np.random.default_rng(rows + cols)
    (codes, cb, bits, counts, Q, mask), jqt = _jax_qt(rng, rows, cols, k_max)
    tqt = tq.build_quantized_tensor(
        torch.from_numpy(codes), torch.from_numpy(cb), bits, counts,
        torch.from_numpy(Q), torch.from_numpy(mask))
    ref = qt_to_numpy(jqt)
    assert [s.bits for s in tqt.stripes] == [s["bits"] for s in ref["stripes"]]
    for s, r in zip(tqt.stripes, ref["stripes"]):
        np.testing.assert_array_equal(s.packed.numpy(),
                                      r["packed"].view(np.int32))
        np.testing.assert_array_equal(s.codebook.numpy(), r["codebook"])
    for name in ("col_perm", "out_idx", "out_val", "out_count"):
        np.testing.assert_array_equal(getattr(tqt, name).numpy(), ref[name])
    # dequantize() bit-exact, from the port's build and from the handoff
    want = np.asarray(jqt.dequantize())
    np.testing.assert_array_equal(tqt.dequantize().numpy(), want)
    crossed = quantized_from_numpy(ref, device="cpu")
    np.testing.assert_array_equal(crossed.dequantize().numpy(), want)
    assert crossed.effective_bits() == pytest.approx(jqt.effective_bits())
