"""K1 on the card: the CUDA dequant GEMM against its plain version on the
same CUDA tensors (f32/bf16 x, and int8 x with its per-token scale: K1e),
for every bit-width (1/2/3/4/8 — the 8-bit codebook is
read from device memory, the others from shared memory), every x mode,
f32 and bf16 compute, both tile shapes (M <= 16, with one or two 8-row
M blocks, and M > 16), ragged N and K, acc chaining and colliding outlier
slots; and the split-K / tensor-core design at its edges: M at every tile
edge, K in one, many and a ragged last slice, outliers on tile edges in the
last slice, more outlier slots than a stage holds, acc and x_scale with
several slices, two calls bitwise equal, split-K launches on two streams at
once, a chain replayed from a CUDA graph equal to the eager one, and the
launch plan's shared memory and residency against the CUDA runtime's.  Sums
run in another order than the plain version's matmul, so f32 results agree
to rtol 1e-4 / atol 1e-3 (the tolerance of tests/test_kernels.py), not
bitwise.

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


# ------------------------------------------------- the split-K / mma design

def raw_group(rng, n, k_padded, bits, k_out, device):
    """One group's kernel operands from numpy: random plane words (every
    code occurs), a random codebook and ``k_out`` outlier slots per column
    (-1 = empty; some slots name a row twice, the later one wins)."""
    from repro_torch.core import packing
    planes = tuple(
        torch.as_tensor(rng.integers(-2**31, 2**31, size=(n // (32 // w),
                                                          k_padded),
                                     dtype=np.int64).astype(np.int32),
                        device=device)
        for w in packing.plane_widths(bits))
    cb = torch.as_tensor(rng.normal(size=(k_padded, 2 ** bits)).astype(
        np.float32), device=device)
    if k_out == 0:
        return planes, cb, None, None
    oi = rng.integers(-1, n, size=(k_out, k_padded)).astype(np.int32)
    if k_out > 1:
        oi[-1, ::3] = oi[0, ::3]
    ov = rng.normal(size=(k_out, k_padded)).astype(np.float32) * 4
    return (planes, cb, torch.as_tensor(oi, device=device),
            torch.as_tensor(ov, device=device))


def check_raw(card, rng, m, n, k_padded, bits, compute, k_out=2, acc=False,
              scale=False, x_dtype=None, oi_fix=None):
    """Kernel against its plain version on one raw group (blocked x);
    returns the kernel's output."""
    planes, cb, oi, ov = raw_group(rng, n, k_padded, bits, k_out, card)
    if oi_fix is not None:
        oi_fix(oi)
    x = torch.as_tensor(rng.normal(size=(m, k_padded)).astype(np.float32),
                        device=card).to(x_dtype or compute)
    x_scale = None
    if x_dtype == torch.int8:
        x, x_scale = ops.quantize_activations(
            torch.as_tensor(rng.normal(size=(m, k_padded)).astype(
                np.float32), device=card))
    elif scale:
        x_scale = torch.as_tensor(rng.uniform(0.5, 2, size=(m, 1)).astype(
            np.float32), device=card)
    a = (torch.as_tensor(rng.normal(size=(m, n)).astype(np.float32),
                         device=card) if acc else None)
    kw = dict(bits=bits, n=n, compute_dtype=compute, acc=a, x_scale=x_scale)
    before = dm.launch_count
    got = dm.dequant_matmul(x, planes, cb, oi, ov, **kw)
    assert dm.launch_count == before + 1
    want = dm.dequant_matmul_plain(x, planes, cb, oi, ov, **kw)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    return got


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 63, 64, 65, 512])
def test_every_m_tile_edge(card, m, compute):
    """M at every edge of the decode (8, 16) and prefill (64) tiles, on a
    160-row output (not a multiple of the 128-row N tile)."""
    rng = np.random.default_rng(m)
    check_raw(card, rng, m, 160, 512, 2, compute)


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("k_padded", [64, 128, 512, 704, 4096, 10240])
def test_k_slices(card, k_padded, m):
    """One K slice, many, and a ragged last slice (704 = 11 chunks in
    slices of 2 at M = 4 over 8192 rows), both compute types."""
    n = 8192 if k_padded == 704 else 480
    lp = dm.launch_plan(m, n, k_padded, 3, torch.bfloat16)
    if k_padded == 64:
        assert lp.slices == 1
    if k_padded == 704 and m == 4:
        assert lp.slices > 1 and lp.chunks % lp.chunks_per_slice
    if k_padded == 10240:
        assert lp.slices > 1
    rng = np.random.default_rng(k_padded + m)
    for compute in (torch.float32, torch.bfloat16):
        check_raw(card, rng, m, n, k_padded, 3, compute)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 64])
def test_outlier_on_tile_edges_in_last_slice(card, m, compute):
    """Outliers on the last row of an N tile (127, 255) and on the last row
    of the matrix, in columns of the last K slice."""
    n, k_padded = 288, 4096
    lp = dm.launch_plan(m, n, k_padded, 2, compute)
    assert lp.slices > 1
    lo, hi = lp.slice_bounds()[-1]

    def fix(oi):
        oi[:, lo:hi] = -1
        oi[0, lo:hi:3] = 127
        oi[1, lo + 1:hi:3] = 255
        oi[0, lo + 2:hi:3] = n - 1
        oi[1, lo + 2:hi:6] = 127          # a later slot on the same column

    check_raw(card, np.random.default_rng(7), m, n, k_padded, 2, compute,
              oi_fix=fix)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [3, 16, 40])
def test_8bit_codebook(card, m, compute):
    """256-level codebooks are read from device memory, not staged."""
    check_raw(card, np.random.default_rng(80 + m), m, 224, 1024, 8, compute)


@pytest.mark.parametrize("x_dtype", [None, torch.int8])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 16, 64])
def test_acc_and_scale_with_split_k(card, m, compute, x_dtype):
    """The acc seed and the (M, 1) scale with several K slices: the last
    block of a tile adds the slices onto acc, then scales."""
    n, k_padded = 1024, 4096
    assert dm.launch_plan(m, n, k_padded, 4, compute).slices > 1
    check_raw(card, np.random.default_rng(90 + m), m, n, k_padded, 4,
              compute, acc=True, scale=True, x_dtype=x_dtype)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 64, 512])
def test_two_calls_bitwise_equal(card, m, compute):
    """Split K reduces in slice order, without float atomics: the same call
    twice gives the same bits."""
    rng = np.random.default_rng(11)
    planes, cb, oi, ov = raw_group(rng, 2048, 4096, 2, 3, card)
    x = torch.randn((m, 4096), device=card).to(compute)
    acc = torch.randn((m, 2048), device=card)
    kw = dict(bits=2, n=2048, compute_dtype=compute, acc=acc)
    y1 = dm.dequant_matmul(x, planes, cb, oi, ov, **kw)
    y2 = dm.dequant_matmul(x, planes, cb, oi, ov, **kw)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("act", [None, "int8"])
@pytest.mark.parametrize("m", [4, 64])
def test_cuda_graph_equals_eager(card, m, act):
    """A prepared matmul (one launch per bit-width, split K, workspace and
    counters) captured in a CUDA graph and replayed gives the eager bits."""
    rng = np.random.default_rng(12)
    column_bits = rng.choice([2, 3, 4], size=COLS, p=[0.8, 0.1, 0.1])
    pqt = plan.prepare_for_inference(random_qt(rng, column_bits, 2, card))
    x = torch.randn((m, COLS), device=card, dtype=torch.bfloat16)
    eager = ops.prepared_qmatmul(x, pqt, compute_dtype=torch.bfloat16,
                                 act_dtype=act)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.prepared_qmatmul(x, pqt, compute_dtype=torch.bfloat16,
                             act_dtype=act)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ops.prepared_qmatmul(x, pqt, compute_dtype=torch.bfloat16,
                                 act_dtype=act)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 64])
def test_many_outlier_slots_on_an_11008_row_matrix(card, m, compute, bits):
    """OR 0.2 reserves about 190 slots a column of an 11008-row matrix:
    the kernel stages STAGE_OUT of them a chunk and reads the rest from
    device memory in slot order, within the card's shared memory."""
    k_out = 192
    assert k_out > dm.STAGE_OUT
    lp = dm.launch_plan(m, 11008, 4096, bits, compute, k_out)
    assert lp.smem <= dm.BLOCK_SMEM_MAX
    check_raw(card, np.random.default_rng(130 + m + bits), m, 11008, 4096,
              bits, compute, k_out=k_out)


def test_concurrent_streams_keep_their_own_counters(card):
    """Split-K launches on two streams at once, each with its own arrival
    counters: every result equals the single-stream one bit for bit."""
    rng = np.random.default_rng(14)
    planes, cb, oi, ov = raw_group(rng, 2048, 4096, 2, 3, card)
    kw = dict(bits=2, n=2048, compute_dtype=torch.bfloat16)
    assert dm.launch_plan(4, 2048, 4096, 2, torch.bfloat16, 3).slices > 1
    xs = [torch.randn((4, 4096), device=card).bfloat16() for _ in range(2)]
    want = [dm.dequant_matmul(x, planes, cb, oi, ov, **kw) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in xs]
    got = [[], []]
    for _ in range(50):
        for s, x, out in zip(streams, xs, got):
            with torch.cuda.stream(s):
                out.append(dm.dequant_matmul(x, planes, cb, oi, ov, **kw))
    torch.cuda.synchronize()
    for w, outs, x in zip(want, got, xs):
        torch.testing.assert_close(
            w, dm.dequant_matmul_plain(x, planes, cb, oi, ov, **kw),
            rtol=RTOL, atol=ATOL)
        for y in outs:
            assert torch.equal(y, w)


def test_plan_shared_memory_and_residency_match_the_card(card):
    """launch_plan's shared memory is the kernel's own, and the card holds
    at least the blocks per SM the plan counts on."""
    import ctypes
    from repro_torch.kernels import cuda_build
    fn = cuda_build.load("dequant_matmul.cu").lib.claq_dequant_occupancy
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for bits in (1, 2, 3, 4, 8):
        for k_out in (0, 3, 125):
            for m in (1, 4, 9, 16, 17, 512):
                for compute in (torch.float32, torch.bfloat16):
                    lp = dm.launch_plan(m, 11008, 4096, bits, compute, k_out,
                                        sms)
                    got = (ctypes.c_int * 2)()
                    rc = fn(bits, 2 ** bits, k_out, m, 4096,
                            int(compute == torch.bfloat16), lp.block_m,
                            lp.chunks_per_slice, got)
                    assert rc == 0, rc
                    assert got[0] == lp.smem, (bits, k_out, m, compute)
                    assert got[1] >= lp.blocks_per_sm, (bits, k_out, m,
                                                        compute, got[1])
