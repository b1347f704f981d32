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
once, a chain replayed from a CUDA graph equal to the eager one, the
quantizer's GPTQ column loop replayed from its CUDA graph equal to its
eager loop, and the launch plan's shared memory and residency against the
CUDA runtime's;
and, for the moe/MLA families, K1/K1e at their 10 full-width matrix
shapes, stacked experts dequantized on the card as on the CPU, and a
smoke deepseek_v2_236b serving with repeatable tokens.  Sums
run in another order than the plain version's matmul, so f32 results agree
to rtol 1e-4 / atol 1e-3 (the tolerance of tests/test_kernels.py), not
bitwise.

Imports torch and the port only, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is false."""
import functools

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


def random_qt(rng, column_bits, k_max, device, rows=ROWS, scale=1.0):
    """A CLAQ tensor through build_quantized_tensor from numpy-seeded parts
    (codebook and outlier values times ``scale``)."""
    cols = len(column_bits)
    levels = 1 << np.asarray(column_bits)
    codes = rng.integers(0, 1 << 16, size=(rows, cols)) % levels[None, :]
    cb = (rng.normal(size=(cols, 256)) * scale).astype(np.float32)
    cb[np.arange(256)[None, :] >= levels[:, None]] = np.inf
    cb = np.sort(cb, axis=1)                  # valid centroids first, sorted
    counts = rng.integers(0, k_max + 1, size=cols)
    mask = np.zeros((rows, cols), bool)
    for j, c in enumerate(counts):
        mask[rng.permutation(rows)[:c], j] = True
    Q = (rng.normal(size=(rows, cols)) * scale).astype(np.float32)
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


@pytest.mark.parametrize("m", [1, 3, 12, 16, 37])
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
@pytest.mark.parametrize("m", [1, 3, 12, 16, 37])
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


@pytest.mark.parametrize("rows,cols", [(96, 128), (4608, 64)])
def test_gptq_block_graph_equals_eager(card, rows, cols):
    """The GPTQ column loop replayed from its CUDA graph gives the eager
    loop's codes, codebooks and dequantized matrix bit for bit (4608 rows:
    a column longer than one sort block)."""
    from repro_torch.core import gptq
    rng = np.random.default_rng(21)
    W = torch.as_tensor(rng.normal(size=(rows, cols)).astype(np.float32),
                        device=card)
    X = torch.as_tensor(rng.normal(size=(4 * cols, cols)).astype(np.float32),
                        device=card)
    U = gptq.prepare_hinv_cholesky(2.0 * X.T @ X / X.shape[0])
    bits = rng.choice([2, 3, 4], size=cols, p=[0.8, 0.1, 0.1])
    reserved = torch.as_tensor(rng.random((rows, cols)) < 0.01, device=card)
    kw = dict(k_max=16, blocksize=32, method="kmeans", kmeans_iters=6)
    eager = gptq.gptq_quantize_matrix(W, U, bits, reserved,
                                      cuda_graph=False, **kw)
    graphed = gptq.gptq_quantize_matrix(W, U, bits, reserved, **kw)
    assert torch.equal(graphed.codes, eager.codes)
    assert torch.equal(graphed.codebooks, eager.codebooks)
    assert torch.equal(graphed.Q, eager.Q)


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


# ------------------------------------------------------------------ serving

def small_claq_model(seed, device, bits=None):
    """The llama1_7b smoke model (vocab 128, 2 layers) whose block matmuls
    are synthetic CLAQ tensors: columns 2/3/4-bit in a random mix (gathered
    plans, as an AP+OR target's), or all ``bits`` (aligned, as a flat
    draft's); 0..2 outliers a column.  Embedding, norms and lm_head are
    dense, from the same seed."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_smoke_config("llama1_7b"), vocab=128,
                              n_layers=2)
    rng = np.random.default_rng(seed)
    D, H, KH, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)

    def q(rows, cols):
        column_bits = (np.full(cols, bits) if bits is not None else
                       rng.choice([2, 3, 4], size=cols, p=[0.8, 0.1, 0.1]))
        levels = 1 << column_bits
        codes = rng.integers(0, 1 << 16, size=(rows, cols)) % levels[None]
        cb = rng.normal(size=(cols, 16)) * cols ** -0.5
        cb[np.arange(16)[None, :] >= levels[:, None]] = np.inf
        cb = np.sort(cb, axis=1)              # valid centroids first, sorted
        counts = rng.integers(0, 3, size=cols)
        mask = np.zeros((rows, cols), bool)
        for j, c in enumerate(counts):
            mask[rng.permutation(rows)[:c], j] = True
        Q = rng.normal(size=(rows, cols)) * (4 * cols ** -0.5)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32)  # noqa: E731
                                      if np.asarray(a).dtype.kind == "f"
                                      else a, device=device)
        return M.Dense(build_quantized_tensor(t(codes), t(cb), column_bits,
                                              counts, t(Q), t(mask)))

    def dense(i, o):
        return M.Dense(torch.as_tensor(
            rng.normal(size=(i, o)).astype(np.float32) * i ** -0.5,
            device=device))

    ones = lambda: torch.ones(D, device=device)    # noqa: E731
    blocks = [tf.Block(ones(), ones(),
                       L.Attention(q(H * hd, D), q(KH * hd, D),
                                   q(KH * hd, D), q(D, H * hd)),
                       L.SwiGLU(q(F, D), q(F, D), q(D, F)))
              for _ in range(cfg.n_layers)]
    emb = torch.as_tensor(rng.normal(size=(cfg.vocab, D)).astype(np.float32)
                          * 0.5, device=device)
    return cfg, tf.Transformer(emb, blocks, ones(), dense(D, cfg.vocab))


SERVE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10],
                 [11, 12, 13, 14, 15, 16, 17, 18, 19],
                 [20, 21, 22, 23], [30, 31, 32, 33, 34, 35, 36]]


def _serve_waves(eng, max_new=10, logits=None):
    """Admit SERVE_PROMPTS as slots free up; tokens in prompt order.  With
    ``logits`` (a dict, vanilla engines), each decoded token's logits row
    is filed there under (prompt index, token position)."""
    from repro_torch.models import api
    inner, last, rows = api.decode_step, {}, {}

    def recorded(*a, **k):
        out = inner(*a, **k)
        last["logits"] = out[0]
        return out

    pending, order = list(SERVE_PROMPTS), []
    if logits is not None:
        api.decode_step = recorded
    try:
        while pending or eng.active:
            if pending and eng.free:
                n = min(len(pending), len(eng.free))
                order += eng.add_requests(pending[:n], max_new_tokens=max_new)
                del pending[:n]
            at = {u: (r.slot, len(r.tokens)) for u, r in eng.active.items()}
            emitted = eng.step()
            if logits is not None:
                for u, t in emitted.items():
                    slot, j = at[u]
                    rows[u, j] = last["logits"][slot].float()
                    assert int(rows[u, j].argmax()) == t
    finally:
        api.decode_step = inner
    fin = eng.take_finished()
    assert all(fin[u].state.value == "finished" for u in order)
    if logits is not None:
        logits.update({(order.index(u), j): r for (u, j), r in rows.items()})
    return [fin[u].tokens for u in order]


def test_paged_fp_tokens_equal_contiguous_on_the_card(card):
    """Paged fp serving through K1 gives exactly the contiguous engine's
    tokens (the gathered view has the contiguous cache's shape, so the
    card runs the same ops on the same bits), with and without prefix
    sharing, f32 and bf16 caches."""
    from repro_torch.serve import ServingEngine
    cfg, model = small_claq_model(0, card)
    launches = dm.launch_count
    for dtype in (torch.float32, torch.bfloat16):
        kw = dict(n_slots=4, max_len=64, min_bucket=8, dtype=dtype,
                  device="cuda")
        base = _serve_waves(ServingEngine(model, cfg, **kw))
        for share in (True, False):
            eng = ServingEngine(model, cfg, kv_layout="paged", page_size=8,
                                share_prefixes=share, **kw)
            assert _serve_waves(eng) == base
            assert eng.stats()["paged"]["pages_in_use"] <= eng.n_pages
    assert dm.launch_count > launches


def test_speculative_tokens_equal_vanilla_on_the_card(card):
    """Speculative serving through K1 (the draft's aligned plans at
    M = n_slots, the target's gathered plans at the verify's
    M = n_slots * (gamma+1)) emits vanilla's tokens, except at a near
    tie: there vanilla's own decode logits must have a top-2 gap, and a
    deficit of the speculative token to their maximum, below twice the
    largest |verify - successive decode| logit difference measured on the
    same cache (K1 may sum a verify row in another order than a decode
    row).  The target as its own draft accepts most windows, so verify
    rows past the first are emitted and rollbacks keep k > 0 tokens."""
    import copy

    from repro_torch.models import api
    from repro_torch.serve import ServingEngine, SpecConfig
    cfg, target = small_claq_model(0, card)
    _, draft = small_claq_model(1, card, bits=2)
    kw = dict(n_slots=4, max_len=64, min_bucket=8, device="cuda")
    rows = {}
    base = _serve_waves(ServingEngine(target, cfg, **kw), logits=rows)

    # the verify's difference from successive decodes on one window
    eng = ServingEngine(target, cfg, **kw)
    eng.add_requests(SERVE_PROMPTS[:4], max_new_tokens=10)
    span = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab, size=(4, 5)), device=card)
    with torch.no_grad():
        c = copy.deepcopy(eng.cache)
        vl, _ = api.decode_span(eng.params, cfg, span, copy.deepcopy(c))
        outs = []
        for j in range(span.shape[1]):
            lg, c = api.decode_step(eng.params, cfg, span[:, j], c)
            outs.append(lg)
    tol = 2 * float((vl - torch.stack(outs, 1)).abs().max())

    aligned = dm.aligned_launch_count
    for gamma, d in ((1, draft), (4, draft), (4, target)):
        eng = ServingEngine(target, cfg, draft_params=d,
                            spec=SpecConfig(gamma=gamma), **kw)
        got = _serve_waves(eng)
        for i, (g, b) in enumerate(zip(got, base)):
            if g == b:
                continue
            j = next(k for k, (u, v) in enumerate(zip(g, b)) if u != v)
            row = rows[i, j]            # a KeyError: it diverged at prefill
            top2 = torch.topk(row, 2).values
            assert float(top2[0] - top2[1]) < tol, (i, g, b, tol)
            assert float(top2[0] - row[g[j]]) < tol, (i, g, b, tol)
        assert eng.stats()["verify_traces"] == 1
        if d is target:
            assert eng.stats()["acceptance_rate"] > 0.5
    assert dm.aligned_launch_count > aligned


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_mode", ["aligned", "gathered"])
def test_decode_rows_at_m1_bitwise_rows_at_n_slots(card, x_mode, compute):
    """A resume replays decode at M = 1; the batch decodes at M = n_slots
    (4).  Both take the same launch plan (one M tile of block_m rows, the
    same K slices), so each row of the M = 4 chain is bit for bit the
    M = 1 chain on that row alone — at the test's shape and at
    llama1_7b's."""
    for n, k in ((4096, 4096), (11008, 4096), (4096, 11008)):
        p1, p4 = (dm.launch_plan(m, n, k, 2, compute) for m in (1, 4))
        assert (p1.block_m, p1.m_tiles, p1.chunks_per_slice, p1.slices) == (
            p4.block_m, p4.m_tiles, p4.chunks_per_slice, p4.slices)
    rng = np.random.default_rng(11)
    pqt = plan_for(2, x_mode, rng, card)
    x = torch.as_tensor(rng.normal(size=(4, COLS)).astype(np.float32),
                        device=card).to(compute)

    def chain(xs):
        y = None
        for xg, kw in ops.group_calls(xs, pqt, "kernel"):
            y = dm.dequant_matmul(xg, acc=y, compute_dtype=compute, **kw)
        return y

    full = chain(x)
    for r in range(4):
        assert torch.equal(chain(x[r:r + 1].contiguous())[0], full[r]), r


def test_guarded_decode_quarantines_an_injected_row_on_the_card(card):
    """Guards on the card: a NaN the fault plan adds to one slot's decode
    logits FAILS exactly that request (phase "decode", its count), in the
    same host transfer as the tokens; the other requests emit the
    unguarded engine's tokens bit for bit."""
    from repro_torch.serve import FaultInjector, ServingEngine
    cfg, model = small_claq_model(0, card)
    kw = dict(n_slots=4, max_len=64, min_bucket=8, device="cuda")
    base = _serve_waves(ServingEngine(model, cfg, **kw))
    plan = FaultInjector(seed=2, horizon=8, nan_faults=1, inf_faults=0,
                         pressure_windows=0, transient_failures=0,
                         burst_every=0, arrival_lambda=0.0)
    (step,) = plan.logit_faults
    eng = ServingEngine(model, cfg, guards=True, faults=plan, **kw)
    uids = eng.add_requests(SERVE_PROMPTS[:4], max_new_tokens=10)
    eng.run_to_completion()
    fin = eng.take_finished()
    failed = [u for u in uids if fin[u].state.value == "failed"]
    assert len(failed) == 1
    d = fin[failed[0]].diagnostics
    assert d["kind"] == "nonfinite_logits" and d["phase"] == "decode"
    assert d["engine_step"] == step and d["nonfinite"] == cfg.vocab
    for i, u in enumerate(uids):
        if u in failed:
            assert fin[u].tokens == base[i][:step + 1]
        else:
            assert fin[u].state.value == "finished" and fin[u].tokens == base[i]


# ------------------------------------------------- moe and MLA (slice 7)

# (out, in) of every K1 matmul the full-width moe/MLA configs run:
# qwen3_moe_30b_a3b's attention, deepseek_v2_236b's MLA projections and
# its shared SwiGLU
MOE_MLA_SHAPES = [(4096, 2048), (512, 2048), (2048, 4096), (1536, 5120),
                  (24576, 1536), (576, 5120), (32768, 512), (5120, 16384),
                  (3072, 5120), (5120, 3072)]


def _ap_bits(rng, cols):
    """~90 % 2-bit, 5 % 3-bit, 5 % 4-bit columns, permuted."""
    return rng.choice([2, 3, 4], size=cols, p=[0.9, 0.05, 0.05])


@functools.lru_cache(maxsize=None)
def _ap_plan(rows, cols):
    """One AP plan per shape, built on the card at first use, its values at
    a layer's scale (cols^-0.5, as a trained layer's and chip_smoke.py's
    synthetic weights: outputs O(1), where rtol/atol apply as elsewhere in
    this file; at unit scale, outputs near 100 make two f32 summation
    orders of K >= 3072 terms differ by more than the 1e-3 atol)."""
    rng = np.random.default_rng(rows + cols)
    return plan.prepare_for_inference(
        random_qt(rng, _ap_bits(rng, cols), 3, "cuda", rows=rows,
                  scale=cols ** -0.5))


@pytest.mark.parametrize("act", [None, "int8"])
@pytest.mark.parametrize("m", [4, 100, 256])
@pytest.mark.parametrize("shape", MOE_MLA_SHAPES,
                         ids=[f"{r}x{c}" for r, c in MOE_MLA_SHAPES])
def test_k1_at_moe_and_mla_shapes(card, shape, m, act):
    """K1 (and K1e) against the plain version at the moe/MLA shapes: K 512
    (one 512-wide block per group), 576 rows (N padded to 640), K 16384,
    N 24576; decode M 4, a prefill M and MLA's expanded M = max_len."""
    rows, cols = shape
    pqt = _ap_plan(rows, cols)
    assert not pqt.x_gather_free
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.normal(size=(m, cols)).astype(np.float32),
                        device=card).to(torch.bfloat16)
    scale = None
    if act == "int8":
        x, scale = ops.quantize_activations(x)
    acc = None
    for xg, kw in ops.group_calls(x, pqt, "kernel", x_scale=scale):
        got = dm.dequant_matmul(xg, acc=acc, compute_dtype=torch.bfloat16,
                                **kw)
        want = dm.dequant_matmul_plain(xg, acc=acc,
                                       compute_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        acc = got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_experts_dequantize_on_the_card(card, dtype):
    """A stack of CLAQ experts and its prepared plan dequantize on the card
    in one batched pass, bitwise as on the CPU."""
    from repro_torch.core.quantized import stack_quantized
    out = {}
    for dev in ("cpu", card):
        rng = np.random.default_rng(7)
        bits = _ap_bits(rng, 300)
        st = stack_quantized([random_qt(rng, bits, 3, dev) for _ in range(5)])
        out[str(dev)] = (st.dequantize(dtype),
                         plan.prepare_for_inference(st).dequantize(dtype))
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b.cpu())
    assert torch.equal(out["cpu"][0], out["cpu"][1])


def test_moe_mla_model_serves_on_the_card(card):
    """The smoke deepseek_v2_236b (moe + MLA, f32) quantized in weight
    space serves on the card: a repeated serve gives equal tokens (the
    expert combine is a gather, not atomics), paged fp tokens equal
    contiguous ones, and K1 launched."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import CLAQConfig
    from repro_torch.launch.quantize import quantize_model_params
    from repro_torch.models import api
    from repro_torch.serve import ServingEngine
    cfg = dataclasses.replace(get_smoke_config("deepseek_v2_236b"),
                              vocab=128, n_layers=1)
    model = api.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    model, _ = quantize_model_params(model, cfg, {}, CLAQConfig(
        bits=2, method="kmeans", kmeans_iters=2))
    launches = dm.launch_count
    kw = dict(n_slots=4, max_len=64, device="cuda")
    runs = [_serve_waves(ServingEngine(model, cfg, **kw)) for _ in range(2)]
    runs.append(_serve_waves(ServingEngine(model, cfg, kv_layout="paged",
                                           page_size=8, **kw)))
    assert runs[0] == runs[1] == runs[2]
    assert dm.launch_count > launches


# ------------------------------------------------ the contract gate (slice 9)

@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged", page_size=8,
                                              kv_dtype="int8")],
                         ids=["contiguous", "paged_int8"])
def test_contract_gate_on_the_card(card, kw):
    """``verify_contracts=True`` over the smoke AP model on the card: the
    gate is clean, its profiled decode step launched K1 'gathered' and made
    exactly one device-to-host memcpy (``_sample``'s), counted against the
    engine's helpers, and a violating trace keeps the engine from coming
    up; the engine then serves the tokens of an engine without the gate."""
    from repro_torch.analysis import ContractViolation, artifacts
    from repro_torch.analysis import op_trace as OT
    from repro_torch.serve import ServingEngine
    cfg, model = small_claq_model(0, card)
    base = dict(n_slots=4, max_len=64, min_bucket=8, device="cuda", **kw)
    traces = []
    real = artifacts.decode_ops

    def keep(engine):
        traces.append(real(engine))
        return traces[-1]

    artifacts.decode_ops = keep
    try:
        eng = ServingEngine(model, cfg, verify_contracts=True, **base)
    finally:
        artifacts.decode_ops = real
    rep = eng.contract_report
    assert rep.clean, rep.render()
    assert "HLO-GA1" in rep.rules_run and "HLO-HT1" in rep.rules_run
    counts = OT.transfer_counts(traces[0])
    assert counts["to_host"] == 1 and counts["dtoh"] == 1, counts
    assert OT.k1_modes(traces[0]).get("gathered", 0) > 0
    assert _serve_waves(eng) == _serve_waves(ServingEngine(model, cfg,
                                                           **base))
    bad = OT.OpTrace([OT.OpRecord(OT.TO_HOST), OT.OpRecord(
        "Memcpy DtoH (Device -> Pageable)", "device"), OT.OpRecord(
        "Memcpy DtoH (Device -> Pageable)", "device")])
    artifacts.decode_ops = lambda engine: bad
    try:
        with pytest.raises(ContractViolation, match="HLO-HT1"):
            ServingEngine(model, cfg, verify_contracts=True, **base)
    finally:
        artifacts.decode_ops = real
