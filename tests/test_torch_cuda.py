"""K1 on the card: the CUDA dequant GEMM against its plain version on the
same CUDA tensors (f32/bf16 x, and int8 x with its per-token scale: K1e),
for every bit-width (1/2/3/4/8 — the 8-bit codebook is
read from device memory, the others from shared memory), every x mode,
f32 and bf16 compute, both tile shapes (M <= 16, with one or two 8-row
M blocks, and M > 16), ragged N and K, acc chaining and colliding outlier
slots.  Sums run in another order than the plain version's matmul, so f32
results agree to rtol 1e-4 / atol 1e-3 (the tolerance of
tests/test_kernels.py), not bitwise.

Imports torch and the port only, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is false."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.quantized import build_quantized_tensor  # noqa: E402
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import plan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-4, 1e-3
ROWS, COLS = 72, 300          # n_padded 96 (not a 64 multiple), K tails


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def random_qt(rng, column_bits, k_max, device):
    """A CLAQ tensor through build_quantized_tensor from numpy-seeded parts."""
    rows, cols = ROWS, len(column_bits)
    levels = 1 << np.asarray(column_bits)
    codes = rng.integers(0, 1 << 16, size=(rows, cols)) % levels[None, :]
    cb = rng.normal(size=(cols, 256)).astype(np.float32)
    cb[np.arange(256)[None, :] >= levels[:, None]] = np.inf
    cb = np.sort(cb, axis=1)                  # valid centroids first, sorted
    counts = rng.integers(0, k_max + 1, size=cols)
    mask = np.zeros((rows, cols), bool)
    for j, c in enumerate(counts):
        mask[rng.permutation(rows)[:c], j] = True
    Q = rng.normal(size=(rows, cols)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return build_quantized_tensor(t(codes), t(cb), column_bits, counts,
                                  t(Q), t(mask))


def plan_for(bits, x_mode, rng, device):
    """A prepared plan whose groups run in ``x_mode`` and include ``bits``:
    one bit-width keeps the identity permutation (aligned); a random mix
    with a second width permutes the columns (gathered, or blocked)."""
    if x_mode == "aligned":
        column_bits = np.full(COLS, bits)
    else:
        other = 4 if bits == 2 else 2
        column_bits = np.where(rng.random(COLS) < 0.6, bits, other)
    pqt = plan.prepare_for_inference(random_qt(rng, column_bits, 3, device))
    assert (x_mode == "aligned") == pqt.x_gather_free
    return pqt


@pytest.mark.parametrize("m", [3, 16, 37])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_mode", ["aligned", "gathered", "blocked"])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_kernel_matches_plain_version(card, bits, x_mode, compute, m):
    rng = np.random.default_rng(bits * 100 + m)
    pqt = plan_for(bits, x_mode, rng, card)
    x = torch.as_tensor(rng.normal(size=(m, COLS)).astype(np.float32),
                        device=card).to(compute)
    gather = "xla" if x_mode == "blocked" else "kernel"
    acc = None
    for xg, kw in ops.group_calls(x, pqt, gather):
        assert kw["x_mode"] == x_mode
        before = dm.launch_count
        got = dm.dequant_matmul(xg, acc=acc, compute_dtype=compute, **kw)
        assert dm.launch_count == before + 1
        want = dm.dequant_matmul_plain(xg, acc=acc, compute_dtype=compute,
                                       **kw)
        torch.cuda.synchronize()
        assert got.shape == (m, pqt.n_padded) and got.is_cuda
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        acc = got


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("m", [3, 16, 37])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_mode", ["aligned", "gathered", "blocked"])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_int8_kernel_matches_plain_version(card, bits, x_mode, compute, m,
                                           with_acc):
    """K1e: int8 x (from quantize_activations) with the (M, 1) scale on
    the last launch of the chain (gather="kernel"), or applied after it
    (blocked, as gather="xla" does); an optional acc seeds the first."""
    rng = np.random.default_rng(bits * 1000 + m * 10 + with_acc)
    pqt = plan_for(bits, x_mode, rng, card)
    x = torch.as_tensor(rng.normal(size=(m, COLS)).astype(np.float32),
                        device=card).to(compute)
    xq, scale = ops.quantize_activations(x)
    gather = "xla" if x_mode == "blocked" else "kernel"
    acc = (torch.as_tensor(rng.normal(size=(m, pqt.n_padded)).astype(
        np.float32), device=card) if with_acc else None)
    calls = list(ops.group_calls(xq, pqt, gather, x_scale=scale))
    assert (calls[-1][1].get("x_scale") is scale) == (gather == "kernel")
    for xg, kw in calls:
        assert xg.dtype == torch.int8 and kw["x_mode"] == x_mode
        before = dm.launch_count
        got = dm.dequant_matmul(xg, acc=acc, compute_dtype=compute, **kw)
        assert dm.launch_count == before + 1
        want = dm.dequant_matmul_plain(xg, acc=acc, compute_dtype=compute,
                                       **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        acc = got


def test_int8_gather_modes_bitwise_and_one_launch_per_bitwidth(card):
    """int8 activations on the card: the scale riding the last launch
    (gather="kernel") and one multiply after the blocked chain
    (gather="xla") give bitwise equal results; one launch per distinct
    bit-width, the plain version never runs; within the int8 error bound
    of the f32-activation product."""
    rng = np.random.default_rng(13)
    column_bits = rng.choice([2, 3, 4], size=COLS, p=[0.8, 0.1, 0.1])
    pqt = plan.prepare_for_inference(random_qt(rng, column_bits, 2, card))
    x = torch.randn((2, 5, COLS), device=card)
    launches, plain = dm.launch_count, dm.plain_count
    y_k = ops.prepared_qmatmul(x, pqt, act_dtype="int8")
    y_x = ops.prepared_qmatmul(x, pqt, gather="xla", act_dtype="int8")
    assert dm.launch_count - launches == 2 * 3
    assert dm.plain_count == plain
    assert torch.equal(y_k, y_x)
    W = pqt.dequantize(torch.float32)
    y_f = ops.prepared_qmatmul(x, pqt)
    bound = ref.ref_act_int8_bound(x, W) * 1.01 + 1e-4
    assert bool(((y_k - y_f).abs() <= bound).all())


def test_later_outlier_slot_wins(card):
    """Two slots naming the same row: the kernel keeps the later value,
    as the reference's where-chain and the plain version do."""
    rng = np.random.default_rng(5)
    pqt = plan_for(2, "aligned", rng, card)
    g = pqt.groups[0]
    oi = torch.full((2, g.k_padded), -1, dtype=torch.int32, device=card)
    oi[0, :COLS] = torch.as_tensor(rng.integers(0, ROWS, COLS), device=card)
    oi[1, ::2] = oi[0, ::2]
    ov = torch.as_tensor(rng.normal(size=(2, g.k_padded)).astype(np.float32),
                         device=card)
    x = torch.randn((4, COLS), device=card)
    kw = dict(bits=2, n=pqt.n_padded, x_mode="aligned", x_start=0,
              k_cols=g.k_cols)
    got = dm.dequant_matmul(x, g.planes, g.codebook, oi, ov, **kw)
    want = dm.dequant_matmul_plain(x, g.planes, g.codebook, oi, ov, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_gather_modes_bitwise_and_one_launch_per_bitwidth(card):
    """On the card too, reading raw x through x_idx (gather="kernel") and
    pre-gathering it (gather="xla") feed the kernel the same values in the
    same order: the results are bitwise equal.  Each matmul launches once
    per distinct bit-width and never runs the plain version."""
    rng = np.random.default_rng(3)
    column_bits = rng.choice([2, 3, 4], size=COLS, p=[0.8, 0.1, 0.1])
    pqt = plan.prepare_for_inference(random_qt(rng, column_bits, 2, card))
    x = torch.randn((2, 5, COLS), device=card, dtype=torch.bfloat16)
    launches, plain = dm.launch_count, dm.plain_count
    y_k = ops.prepared_qmatmul(x, pqt, compute_dtype=torch.bfloat16)
    y_x = ops.prepared_qmatmul(x, pqt, compute_dtype=torch.bfloat16,
                               gather="xla")
    assert dm.launch_count - launches == 2 * 3
    assert dm.plain_count == plain
    assert torch.equal(y_k, y_x)
    want = x.float() @ pqt.dequantize(torch.bfloat16).float().T
    torch.testing.assert_close(y_k.float(), want, rtol=2e-2, atol=2e-2)


def test_wrapper_raises_instead_of_falling_back(card):
    rng = np.random.default_rng(8)
    pqt = plan_for(2, "aligned", rng, card)
    g = pqt.groups[0]
    x = torch.randn((COLS, 4), device=card).T           # not contiguous
    plain = dm.plain_count
    with pytest.raises(ValueError, match="contiguous"):
        dm.dequant_matmul(x, g.planes, g.codebook, g.out_idx, g.out_val,
                          bits=2, n=pqt.n_padded, x_mode="aligned",
                          k_cols=g.k_cols)
    assert dm.plain_count == plain
