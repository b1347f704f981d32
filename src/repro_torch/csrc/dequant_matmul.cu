// K1: fused CLAQ dequant GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_matmul.py:_kernel
// (launched by _dequant_matmul, pallas_call at dequant_matmul.py:242).  It
// computes, for ONE uniform-bit-width group of a prepared CLAQ plan,
//
//     out[m, n] = ([acc[m, n] +] sum_k x_tile[m, k] * W[n, k]) [* x_scale[m]]
//
// where W (n_padded x k_padded) never exists in device memory: it is
// rebuilt on chip from
//   * packed code planes: one u32 word holds cpw = 32/width consecutive
//     ROWS (N) of one COLUMN (K), low bits first; words of neighbouring K
//     columns are contiguous (plane layout (n_padded/cpw, k_padded)); a
//     3-bit code is a 2-bit plane plus a 1-bit plane shifted left by 2;
//   * a per-column codebook (k_padded, 2^bits) f32;
//   * k_out reserved outliers per column, (k_out, k_padded) row ids (-1 =
//     empty slot) and values, applied in slot order so a later slot wins;
//     any k_out is served (see kStageOut).
// x is f32, bf16 or int8 (K1e: per-token int8 activations, converted to
// float after the load -- an int8 value is exact in bf16).  The (M,) f32
// x_scale multiplies each output once, after the whole K sum and the acc
// seed, as the reference folds it at its last K step
// (dequant_matmul.py:160-167).  x_tile is selected by x_mode: "blocked"
// (x already in fused, padded K order), "aligned" (raw x read at column
// x_start + k, zero past k_cols) or "gathered" (raw x read at column
// x_idx[k], zero where x_idx[k] == x_cols).  With compute_bf16, x and W
// are rounded to bf16 before the product; the sum is always f32.
//
// What bounds it on an H100.  At decode (M <= 16) the work is the bytes
// of the packed planes (~2.15 bits a weight on the main path: 11.3 MB for
// an 11008 x 4096 matrix, 3.4 us at 3.35 TB/s): the kernel has to keep many
// plane words in flight.  At prefill (M > 16) it is the operations, 2 M N K,
// which only the tensor cores deliver.  The first design (one block per
// output tile walking all of K through a chain of dependent loads and
// three barriers per 64 columns) ran at ~7 us a chunk whatever the shape:
// latency, not bandwidth, and CUDA-core FMAs at every M.
//
// What this design does about it:
//   * Split K.  The grid is (N tiles of 128 rows) x (M tiles) x (K slices);
//     the launch plan (kernels/dequant_matmul.py:launch_plan) picks as
//     many slices as fit one wave of resident blocks, from the kernels'
//     launch bounds and the launch's shared memory (claq_dequant_occupancy
//     reports both for the card tests).  Each slice writes its partial
//     tile to a workspace, and the last block to arrive at a tile (an
//     arrival counter per tile, in the launch's own workspace) adds the
//     slices in slice order onto the acc seed and applies x_scale:
//     deterministic, no float atomics.
//   * A pre-pass gathers x once per launch into fused K order and the
//     compute type, so every block reads its x rows contiguously, and
//     zeroes the launch's arrival counters.
//   * A cp.async ring (3 stages on both paths) of 64-column
//     chunks: plane words (16 bytes a thread, neighbouring threads on
//     neighbouring K), codebook rows and the first kStageOut outlier slots
//     arrive while the previous chunk is used; no global load waits on
//     another one.  Slots past kStageOut (plans with a large outlier
//     ratio) are read from device memory in slot order, so the stage does
//     not outgrow shared memory whatever k_out is.
//   * Register-resident W.  Lane (g, t) of a warp takes the 16 rows
//     n0 + 16 g .. of one word row (the word layout already holds 16 rows
//     of a column at 2 bits) at 4 consecutive K columns, and unpacks them
//     straight into the A fragment of mma.m16n8k16: its columns play the
//     fragment's K 2t, 2t+1, 2t+8, 2t+9 and x is read in the same order.
//     A 2-bit column's four levels sit in registers as bf16, and one prmt
//     reads two weights.  A warp whose rows no outlier slot names (the
//     common case) skips them; the others patch their fragments in slot
//     order through shared memory.
//   * Decode (M <= 16): x of the block's whole K slice is copied into
//     shared memory once; each of the 4 warps multiplies its own 16-column
//     step of every chunk (bf16: mma.sync with M padded to 8 or 16; f32:
//     CUDA-core FMAs on a 4-row M tile), and the warps' partial tiles are
//     added in warp order.
//   * Prefill (M > 16, 64 x 128 tiles, 8 warps): the warps unpack each
//     chunk once into shared memory (bf16: in A-fragment order; f32: as a
//     K x N tile), x arriving through the ring, then each warp
//     multiplies its 8 rows of M: mma.sync bf16 -> f32 on the tensor cores,
//     or f32 FMAs (never TF32) for compute in f32.
// The tile, split and reduction order depend only on (M, n, k_padded,
// bits, compute type), never on x_mode: gathered, aligned and blocked x
// give bitwise equal results.

#include "dequant_common.cuh"

namespace claq {
// One bit-width's launches, instantiated in dequant_bits<B>.cu.
// grid null: report instead of launching (claq_dequant_occupancy).
template <int BITS>
cudaError_t dispatch(int block_m, bool bf16, dim3* grid, cudaStream_t s,
                     const Args& a, int* query);

cudaError_t dispatch_bits(int bits, int block_m, bool bf16, dim3* grid,
                          cudaStream_t s, const Args& a, int* query) {
  switch (bits) {
    case 1: return dispatch<1>(block_m, bf16, grid, s, a, query);
    case 2: return dispatch<2>(block_m, bf16, grid, s, a, query);
    case 3: return dispatch<3>(block_m, bf16, grid, s, a, query);
    case 4: return dispatch<4>(block_m, bf16, grid, s, a, query);
    case 8: return dispatch<8>(block_m, bf16, grid, s, a, query);
    default: return cudaErrorInvalidValue;
  }
}

bool plan_ok(int M, int n_padded, int k_padded, bool bf16, int block_m,
             int chunks_per_slice) {
  return M > 0 && n_padded % 32 == 0 && k_padded % kChunkK == 0 &&
         k_padded > 0 && chunks_per_slice > 0 &&
         (M > 16 || chunks_per_slice <= kDecodeMaxSliceChunks) &&
         (M > 16 ? block_m == kPrefillM
                 : block_m == (bf16 ? (M <= 8 ? 8 : 16) : 4));
}
}  // namespace claq

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a launch plan the kernels do not take.
// The caller guarantees: planes (n_padded/cpw, k_padded) u32, codebook
// (k_padded, levels) f32, out_idx/out_val (k_out, k_padded), acc/out
// (M, n_padded) f32, x_idx (k_padded) i32, x_scale (M,) f32 or null, all
// contiguous and 16-byte aligned on one device; x_type 0 = f32, 1 = bf16,
// 2 = int8; n_padded % 32 == 0 and k_padded % 64 == 0.  The launch plan
// (block_m, chunks_per_slice) comes from launch_plan in
// kernels/dequant_matmul.py: block_m 4 (f32) or 8/16 (bf16) for M <= 16,
// 64 above; with more than one K slice, `workspace` holds (slices, M,
// n_padded) f32 and `counters` one int per output tile, of this launch
// alone (the pre-pass zeroes them);
// `x_gathered` holds (M, k_padded) of the compute type (written by the
// pre-pass before the product).
extern "C" int claq_dequant_matmul(
    const void* x, int x_type, const void* x_scale, int M, int x_cols,
    const void* plane0, const void* plane1, int width0, int width1,
    int nplanes, const void* codebook, int levels,
    const void* out_idx, const void* out_val, int k_out,
    const void* acc, const void* x_idx, void* out,
    int n_padded, int k_padded, int x_mode, int x_start, int k_cols,
    int compute_bf16, int block_m, int chunks_per_slice, void* workspace,
    void* counters, void* x_gathered, void* stream) {
  using namespace claq;
  Args a;
  a.x = x;
  a.x_type = x_type;
  a.x_scale = static_cast<const float*>(x_scale);
  a.M = M;
  a.x_cols = x_cols;
  a.plane[0] = static_cast<const uint32_t*>(plane0);
  a.plane[1] = static_cast<const uint32_t*>(plane1);
  a.codebook = static_cast<const float*>(codebook);
  a.levels = levels;
  a.out_idx = static_cast<const int*>(out_idx);
  a.out_val = static_cast<const float*>(out_val);
  a.k_out = k_out;
  a.acc = static_cast<const float*>(acc);
  a.x_idx = static_cast<const int*>(x_idx);
  a.out = static_cast<float*>(out);
  a.n_padded = n_padded;
  a.k_padded = k_padded;
  a.x_mode = x_mode;
  a.x_start = x_start;
  a.k_cols = k_cols;
  a.chunks_per_slice = chunks_per_slice;
  a.workspace = static_cast<float*>(workspace);
  a.counters = static_cast<int*>(counters);
  a.xg = x_gathered;

  const bool bf16 = compute_bf16 != 0;
  if (!plan_ok(M, n_padded, k_padded, bf16, block_m, chunks_per_slice))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = k_padded / kChunkK;
  const int slices = (chunks + chunks_per_slice - 1) / chunks_per_slice;
  if ((slices > 1 && (workspace == nullptr || counters == nullptr)) ||
      x_gathered == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n_padded + kBlockN - 1) / kBlockN, (M + block_m - 1) / block_m,
            slices);
  a.n_counters = slices > 1 ? (int)(grid.x * grid.y) : 0;
  const int bits = nplanes == 2 ? width0 + width1 : width0;
  return static_cast<int>(dispatch_bits(bits, block_m, bf16, &grid,
                                        static_cast<cudaStream_t>(stream),
                                        a, nullptr));
}

// The product kernel that claq_dequant_matmul would launch for this plan:
// writes its dynamic shared memory (bytes) to out[0] and the blocks an SM
// of the current device holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// to out[1].  Returns a CUDA error code (0 = ok).  The card tests hold
// launch_plan's own figures to these.
extern "C" int claq_dequant_occupancy(int bits, int levels, int k_out, int M,
                                      int k_padded, int compute_bf16,
                                      int block_m, int chunks_per_slice,
                                      int* out) {
  using namespace claq;
  const bool bf16 = compute_bf16 != 0;
  if (!plan_ok(M, 32, k_padded, bf16, block_m, chunks_per_slice))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.M = M;
  a.levels = levels;
  a.k_out = k_out;
  a.k_padded = k_padded;
  a.chunks_per_slice = chunks_per_slice;
  return static_cast<int>(
      dispatch_bits(bits, block_m, bf16, nullptr, nullptr, a, out));
}
