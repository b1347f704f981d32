"""Two small public functions of the reference held to it on the same
inputs: ``PreparedQuantizedTensor.effective_bits`` (with and without
codebooks; rtol 1e-12, both sum the same integer counts in float) and
``core.policy.codebook_overhead_bits`` (rtol 1e-6: the reference sums
2**bits in f32)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import policy as jpolicy  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro_torch.convert import quantized_from_numpy  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from test_torch_packing import qt_to_numpy  # noqa: E402
from test_torch_plan import make_qt  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("spec,k_out", [
    ([(2, 96)], 0), ([(2, 160), (4, 96)], 3), ([(1, 64), (3, 64), (8, 32)], 5),
    ([(4, 200), (2, 56)], 2)])
@pytest.mark.parametrize("codebooks", [False, True])
def test_plan_effective_bits_equals_reference(spec, k_out, codebooks):
    rng = np.random.default_rng(len(spec) * 10 + k_out)
    jqt = make_qt(rng, 96, spec, k_out=k_out)
    want = jplan.prepare_for_inference(jqt).effective_bits(
        include_codebooks=codebooks)
    got = tplan.prepare_for_inference(
        quantized_from_numpy(qt_to_numpy(jqt), device="cpu")
    ).effective_bits(include_codebooks=codebooks)
    assert got == pytest.approx(float(want), rel=1e-12)


@pytest.mark.parametrize("rows,seed", [(64, 0), (4096, 1), (11008, 2)])
def test_codebook_overhead_bits_equals_reference(rows, seed):
    bits = np.random.default_rng(seed).choice([1, 2, 3, 4, 8], size=257)
    want = jpolicy.codebook_overhead_bits(rows, jax.numpy.asarray(bits), 4)
    got = tpolicy.codebook_overhead_bits(rows, torch.from_numpy(bits), 4)
    assert got == pytest.approx(want, rel=1e-6)
