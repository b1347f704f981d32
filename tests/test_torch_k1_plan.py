"""K1's launch plan and the build digest, on the CPU.

``launch_plan`` (kernels/dequant_matmul.py) tiles one launch of the CUDA
dequant GEMM: the decode/prefill switch, the M tile, the K slices and the
split-K workspace, and the shared memory and residency they come from.
The kernel cannot run here; these tests hold the plan to what
csrc/dequant_matmul.cu expects of it (the card tests hold its shared
memory and residency to the CUDA runtime's), and ``cuda_build``'s digest
to every file the source includes."""
import inspect
import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.core import policy
from repro_torch.kernels import cuda_build
from repro_torch.kernels import dequant_matmul as dm

CSRC = Path(dm.__file__).resolve().parents[1] / "csrc"
SHAPES = [(1, 32, 64), (4, 96, 128), (4, 11008, 4096), (4, 4096, 10240),
          (7, 4096, 256), (15, 160, 512), (16, 11008, 4096),
          (17, 4096, 4096), (64, 4096, 10240), (65, 288, 704),
          (512, 11008, 4096), (512, 4096, 1024)]
DTYPES = [torch.float32, torch.bfloat16]


def source_constant(name):
    """An integer constexpr of the kernel's sources."""
    text = "".join(p.read_text() for p in CSRC.glob("*.cu*"))
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (name, found)
    return int(found[0])


def launch_bounds():
    """{kernel: its __launch_bounds__ minimum blocks per SM, as text}."""
    text = (CSRC / "dequant_kernels.cuh").read_text()
    found = re.findall(r"__launch_bounds__\((\w+), ([^)]+)\)\n(\w+)\(",
                       text)
    return {kernel: minimum for _, minimum, kernel in found}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k_padded", SHAPES)
def test_slices_cover_k_once_on_chunk_boundaries(m, n, k_padded, dtype):
    for bits in (1, 2, 3, 4, 8):
        lp = dm.launch_plan(m, n, k_padded, bits, dtype)
        bounds = lp.slice_bounds()
        assert len(bounds) == lp.slices >= 1
        assert bounds[0][0] == 0 and bounds[-1][1] == k_padded
        for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
            assert hi == lo2                       # no gap, no overlap
        for lo, hi in bounds:
            assert lo % dm.CHUNK_K == 0 and hi % dm.CHUNK_K == 0
            assert 0 < hi - lo <= lp.chunks_per_slice * dm.CHUNK_K
        # the kernel's slice count: ceil(chunks / chunks_per_slice)
        assert lp.slices == -(-lp.chunks // lp.chunks_per_slice)
        assert lp.chunks == k_padded // dm.CHUNK_K


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k_padded", SHAPES)
def test_workspace_size(m, n, k_padded, dtype):
    lp = dm.launch_plan(m, n, k_padded, 2, dtype)
    if lp.slices > 1:
        assert lp.workspace_elems == lp.slices * m * n
        assert lp.counters == lp.m_tiles * lp.n_tiles
    else:
        assert lp.workspace_elems == 0 and lp.counters == 0
    assert lp.x_elems == m * k_padded
    assert lp.n_tiles == -(-n // dm.BLOCK_N)
    assert lp.m_tiles == -(-m // lp.block_m)
    assert lp.blocks == lp.n_tiles * lp.m_tiles * lp.slices


def test_decode_prefill_switch_matches_the_kernel():
    """M <= 16 is the decode path (bf16: M padded to 8 or 16; f32: 4-row
    tiles), above it the 64-row prefill tile; the constants agree with the
    CUDA source, and decode slices fit its x staging.  The plan takes no
    x_mode: gathered, aligned and blocked x sum in the same order."""
    params = list(inspect.signature(dm.launch_plan).parameters)
    assert params == ["m", "n", "k_padded", "bits", "compute_dtype",
                      "k_out", "sms"]
    assert source_constant("kBlockN") == dm.BLOCK_N
    assert source_constant("kChunkK") == dm.CHUNK_K
    assert source_constant("kPrefillM") == dm.PREFILL_M
    assert source_constant("kDecodeMaxSliceChunks") == \
        dm.DECODE_MAX_SLICE_CHUNKS
    cu = (CSRC / "dequant_matmul.cu").read_text()
    assert f"M > {dm.DECODE_MAX_M}" in cu
    for m in range(1, 70):
        for dtype in DTYPES:
            lp = dm.launch_plan(m, 4096, 4096, 2, dtype)
            assert lp.decode == (m <= dm.DECODE_MAX_M)
            if not lp.decode:
                assert lp.block_m == dm.PREFILL_M
            elif dtype == torch.bfloat16:
                assert lp.block_m == (8 if m <= 8 else 16)
            else:
                assert lp.block_m == 4
            if lp.decode:
                assert lp.chunks_per_slice <= dm.DECODE_MAX_SLICE_CHUNKS
            assert lp.blocks <= lp.blocks_per_sm * dm.N_SMS \
                or lp.slices == 1


def test_split_k_on_the_llama_decode_shapes():
    """At M = 4 the main shapes split K into enough slices for 2-4
    resident blocks per SM (the first design ran 128-344 blocks)."""
    for n, k_padded in ((11008, 4096), (4096, 4096), (4096, 10240)):
        lp = dm.launch_plan(4, n, k_padded, 2, torch.bfloat16)
        assert lp.slices > 1
        assert 2 * dm.N_SMS <= lp.blocks <= 4 * dm.N_SMS, (n, lp)


def test_shared_memory_constants_match_the_kernel():
    """The plan's copy of the kernel's shared-memory layout and launch
    bounds agrees with csrc/ (the card tests compare the bytes)."""
    assert source_constant("kStageOut") == dm.STAGE_OUT
    assert source_constant("kWordPad") == dm.WORD_PAD
    assert source_constant("kXPad") == dm.X_PAD
    assert source_constant("kSmemLevels") == dm.SMEM_LEVELS
    assert source_constant("kDecodeStages") == dm.STAGES
    assert source_constant("kPrefillStages") == dm.STAGES
    assert dm.TILE_PITCH == dm.BLOCK_N + 4
    bounds = launch_bounds()
    assert bounds["decode_kernel"] == "MT == 16 ? 3 : 4"
    assert bounds["prefill_kernel"] == str(dm.LAUNCH_MIN_BLOCKS[dm.PREFILL_M])
    assert dm.LAUNCH_MIN_BLOCKS == {4: 4, 8: 4, 16: 3, dm.PREFILL_M: 2}


def paper_k_outs():
    """k_out of the paper's OR settings (0.07 and 0.13 extra bits, Setting
    2's 28/72 split) on llama1_7b's matrices: the most outlier slots any
    column of a (rows, cols) matrix reserves."""
    found = {}
    R = torch.rand(11008, generator=torch.Generator().manual_seed(0))
    for extra in (0.07, 0.13, 0.2):
        for rows, cols in ((4096, 4096), (11008, 4096), (4096, 11008)):
            counts, _ = policy.or_reserve_counts(
                R[:cols], rows, policy.ORConfig(extra))
            found[(extra, rows, cols)] = int(counts.max())
    return found


def test_paper_outlier_ratios_fit_shared_memory():
    """AP + OR 0.07 / 0.13 reserve up to 125 slots a column on the 11008-row
    matrices (and OR 0.2 about 190): every plan of every bit-width and M
    fits the card's shared memory with at least one block an SM, and the
    staged slots stop growing at STAGE_OUT."""
    k_outs = paper_k_outs()
    assert k_outs[(0.13, 11008, 4096)] == 125
    assert k_outs[(0.2, 11008, 4096)] >= 180
    for (extra, rows, cols), k_out in k_outs.items():
        for bits in (1, 2, 3, 4, 8):
            for m in (1, 4, 8, 9, 16, 17, 64, 512):
                for dtype in DTYPES:
                    lp = dm.launch_plan(m, rows, cols, bits, dtype, k_out)
                    assert 0 < lp.smem <= dm.BLOCK_SMEM_MAX
                    assert lp.blocks_per_sm >= 1
                    capped = dm.launch_plan(m, rows, cols, bits, dtype,
                                            dm.STAGE_OUT)
                    assert lp == capped


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k_padded", SHAPES)
def test_residency_follows_shared_memory(m, n, k_padded, dtype):
    """blocks_per_sm is the launch bounds' minimum, cut to what the
    launch's shared memory lets an SM hold; the grid fits that wave."""
    for bits in (2, 4, 8):
        for k_out in (0, 3, 125):
            lp = dm.launch_plan(m, n, k_padded, bits, dtype, k_out)
            assert lp.smem == dm.kernel_smem(bits, k_out, lp.block_m,
                                             lp.chunks_per_slice,
                                             dtype == torch.bfloat16)
            assert 1 <= lp.blocks_per_sm <= dm.LAUNCH_MIN_BLOCKS[lp.block_m]
            per_block = lp.smem + dm.BLOCK_SMEM_RESERVED
            assert lp.blocks_per_sm * per_block <= dm.SM_SMEM
            assert lp.blocks_per_sm == dm.resident_blocks(lp.block_m,
                                                          lp.smem)
            if lp.slices > 1 and lp.chunks_per_slice > 1 and not (
                    lp.decode and lp.chunks_per_slice
                    == dm.DECODE_MAX_SLICE_CHUNKS):
                assert lp.blocks <= lp.blocks_per_sm * dm.N_SMS


def test_plan_follows_the_cards_sm_count():
    """Fewer SMs, fewer slices: the plan fills one wave of the card it is
    given (the wrapper passes the device's SM count)."""
    for m, n, k_padded in ((4, 4096, 4096), (4, 11008, 1024),
                           (64, 4096, 4096)):
        full = dm.launch_plan(m, n, k_padded, 2, torch.bfloat16, 3)
        half = dm.launch_plan(m, n, k_padded, 2, torch.bfloat16, 3,
                              sms=dm.N_SMS // 2)
        assert half.slices < full.slices
        assert half.blocks <= half.blocks_per_sm * dm.N_SMS // 2


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        dm.launch_plan(4, 100, 128, 2)            # n % 32
    with pytest.raises(ValueError):
        dm.launch_plan(4, 96, 96, 2)              # k_padded % 64
    with pytest.raises(ValueError):
        dm.launch_plan(0, 96, 128, 2)
    with pytest.raises(ValueError):
        dm.launch_plan(4, 96, 128, 5)             # no 5-bit planes
    with pytest.raises(ValueError):
        dm.launch_plan(4, 96, 128, 2, k_out=-1)


def test_digest_covers_included_headers(tmp_path):
    """Editing a header the source includes changes the library's digest
    (so it is rebuilt); an unrelated file does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    names = [p.name for p in cuda_build.sources("dequant_matmul.cu", csrc)]
    assert names[0] == "dequant_matmul.cu"
    assert "dequant_common.cuh" in names
    before = cuda_build.digest("dequant_matmul.cu", csrc)
    (csrc / "unrelated.cuh").write_text("// not included\n")
    assert cuda_build.digest("dequant_matmul.cu", csrc) == before
    header = csrc / "dequant_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = cuda_build.digest("dequant_matmul.cu", csrc)
    assert after != before
    # a header only the per-bit-width sources include counts too
    kernels = csrc / "dequant_kernels.cuh"
    kernels.write_text(kernels.read_text() + "\n// edited\n")
    assert cuda_build.digest("dequant_matmul.cu", csrc) != after


def test_digest_follows_nested_includes(tmp_path):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("int c;\n")
    assert [p.name for p in cuda_build.sources("a.cu", tmp_path)] == [
        "a.cu", "b.cuh", "c.cuh"]
    before = cuda_build.digest("a.cu", tmp_path)
    (tmp_path / "c.cuh").write_text("int c2;\n")
    assert cuda_build.digest("a.cu", tmp_path) != before
