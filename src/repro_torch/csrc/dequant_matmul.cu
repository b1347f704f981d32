// K1: fused CLAQ dequant GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_matmul.py:_kernel
// (launched by _dequant_matmul, pallas_call at dequant_matmul.py:242).  It
// computes, for ONE uniform-bit-width group of a prepared CLAQ plan,
//
//     out[m, n] = [acc[m, n] +] sum_k x_tile[m, k] * W[n, k]
//
// where W (n_padded x k_padded) never exists in device memory: each K chunk
// of W is rebuilt in shared memory from
//   * packed code planes: one u32 word holds cpw = 32/width consecutive
//     ROWS (N) of one COLUMN (K), low bits first; words of neighbouring K
//     columns are contiguous (plane layout (n_padded/cpw, k_padded)); a
//     3-bit code is a 2-bit plane plus a 1-bit plane shifted left by 2;
//   * a per-column codebook (k_padded, 2^bits) f32, staged in shared memory;
//   * k_out reserved outliers per column, (k_out, k_padded) row ids (-1 =
//     empty slot) and values, applied in slot order so a later slot wins.
// x is f32, bf16 or int8 (K1e: per-token int8 activations, converted to
// float after the load -- an int8 value is exact in bf16).  With an (M,)
// f32 x_scale, each output row is multiplied by x_scale[m] once, after the
// whole K loop, so the acc seed is scaled too: (acc + sum) * scale, as the
// reference folds it at its last K step (dequant_matmul.py:160-167).
// x_tile is selected by x_mode: "blocked" (x already in fused, padded K
// order), "aligned" (raw x read at column x_start + k, zero past k_cols) or
// "gathered" (raw x read at column x_idx[k], zero where x_idx[k] == x_cols).
// With compute_bf16, x and W are rounded to bf16 before the product; the
// sum is always f32.
//
// What bounds it on an H100: at decode (M = a few slots) the work is the
// bytes of the packed planes (~2.15 bits per weight on the main path, about
// 12 MB for an 11008 x 4096 matrix, 3.6 us at 3.35 TB/s) -- the kernel is
// memory-bound; at large-M prefill it is the FLOPs (2 M N K).
//
// What this first design does about it: every plane word is read from
// device memory once per M tile, coalesced (threads run along K), and
// unpacked in registers -- W reaches shared memory already dequantized and
// is never written back.  The TPU's sequential K grid axis becomes a loop
// inside the block (Hopper blocks run in no order), and the acc operand
// seeds the registers, so a mixed-precision matmul is one launch per
// distinct bit-width.  Two tile shapes: a skinny 8 x 32 tile for decode
// (more blocks in flight over N) and a 64 x 64 tile for prefill.  The
// product runs as f32 FMAs on CUDA cores; wgmma / mma.sync, TMA and a
// pipelined ring of tiles are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum XMode { kBlocked = 0, kAligned = 1, kGathered = 2 };
enum XType { kF32 = 0, kBf16 = 1, kInt8 = 2 };

constexpr int kMaxLevels = 16;   // codebooks of <= 4 bits stage in smem

struct Args {
  const void* x;
  int x_type;
  const float* x_scale;
  int M;
  int x_cols;
  const uint32_t* plane[2];
  int width[2];
  int nplanes;
  const float* codebook;
  int levels;
  const int* out_idx;
  const float* out_val;
  int k_out;
  const float* acc;
  const int* x_idx;
  float* out;
  int n_padded;
  int k_padded;
  int x_mode;
  int x_start;
  int k_cols;
  int bf16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_x(const Args& a, int m, int k) {
  int col;
  if (a.x_mode == kBlocked) {
    col = k;
  } else if (a.x_mode == kAligned) {
    if (k >= a.k_cols) return 0.f;
    col = a.x_start + k;
  } else {
    col = a.x_idx[k];
    if (col >= a.x_cols) return 0.f;
  }
  const size_t off = (size_t)m * a.x_cols + col;
  if (a.x_type == kBf16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.x)[off]);
  if (a.x_type == kInt8)
    return static_cast<float>(reinterpret_cast<const int8_t*>(a.x)[off]);
  return reinterpret_cast<const float*>(a.x)[off];
}

__device__ __forceinline__ int log2_cpw(int width) {
  return width == 1 ? 5 : width == 2 ? 4 : width == 4 ? 3 : 2;
}

// One block owns a BM x BN output tile and loops over all of K in chunks
// of BK.  Thread (ty, tx) keeps a TM x TN register tile at rows
// ty + i * (BM / TM) and columns tx + j * (BN / TN) (strided, so shared
// memory reads are free of bank conflicts).
template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
dequant_matmul_kernel(const Args a) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kRowGroups = kThreads / BK;   // W rows split across groups
  constexpr int kRowsPerThread = BN / kRowGroups;
  static_assert(kThreads % BK == 0, "threads must cover the K chunk");
  static_assert(kRowGroups * kRowsPerThread == BN, "rows must tile BN");

  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BN][BK + 1];
  __shared__ float cbs[BK][kMaxLevels + 1];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float accum[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + i * (BM / TM);
      const int n = n0 + tx + j * (BN / TN);
      accum[i][j] = (a.acc != nullptr && m < a.M && n < a.n_padded)
                        ? a.acc[(size_t)m * a.n_padded + n]
                        : 0.f;
    }
  }

  const bool cb_in_smem = a.levels <= kMaxLevels;
  const int wk = tid % BK;                        // this thread's W column
  const int wrow = (tid / BK) * kRowsPerThread;   // and its first W row

  for (int k0 = 0; k0 < a.k_padded; k0 += BK) {
    // ---- x tile (masked rows / K tail / fill slots read as 0) ----------
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int mm = e / BK, kk = e % BK;
      const int m = m0 + mm;
      float v = m < a.M ? load_x(a, m, k0 + kk) : 0.f;
      if (a.bf16) v = round_bf16(v);
      xs[mm][kk] = v;
    }
    // ---- codebook rows of this K chunk ---------------------------------
    if (cb_in_smem) {
      for (int e = tid; e < BK * a.levels; e += kThreads) {
        const int kk = e / a.levels, l = e % a.levels;
        cbs[kk][l] = a.codebook[(size_t)(k0 + kk) * a.levels + l];
      }
    }
    __syncthreads();

    // ---- W tile: unpack planes -> codes -> centroids -------------------
    {
      const int k = k0 + wk;
      int codes[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) codes[j] = 0;
      int shift = 0;
      for (int p = 0; p < a.nplanes; ++p) {
        const int w = a.width[p];
        const int lg = log2_cpw(w);
        const uint32_t mask = (1u << w) - 1u;
        const uint32_t* pl = a.plane[p];
        int cur = -1;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int n = n0 + wrow + j;
          if (n < a.n_padded) {
            const int wi = n >> lg;
            if (wi != cur) {
              word = pl[(size_t)wi * a.k_padded + k];
              cur = wi;
            }
            codes[j] |= (int)((word >> ((n & ((1 << lg) - 1)) * w)) & mask)
                        << shift;
          }
        }
        shift += w;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        float v = 0.f;
        if (n0 + wrow + j < a.n_padded) {
          v = cb_in_smem ? cbs[wk][codes[j]]
                         : a.codebook[(size_t)k * a.levels + codes[j]];
          if (a.bf16) v = round_bf16(v);
        }
        ws[wrow + j][wk] = v;
      }
    }
    // ---- outlier override, slot order (a later slot wins) --------------
    if (a.k_out > 0) {
      __syncthreads();
      if (tid < BK) {
        const int k = k0 + tid;
        for (int r = 0; r < a.k_out; ++r) {
          const int idx = a.out_idx[(size_t)r * a.k_padded + k];
          if (idx >= n0 && idx < n0 + BN) {
            float v = a.out_val[(size_t)r * a.k_padded + k];
            if (a.bf16) v = round_bf16(v);
            ws[idx - n0][tid] = v;
          }
        }
      }
    }
    __syncthreads();

    // ---- f32 product over the chunk ------------------------------------
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[ty + i * (BM / TM)][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[tx + j * (BN / TN)][kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          accum[i][j] = fmaf(xv[i], wv[j], accum[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= a.M) continue;
    const float s = a.x_scale != nullptr ? a.x_scale[m] : 1.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * (BN / TN);
      if (n < a.n_padded)   // * 1.f (no x_scale) is exact
        a.out[(size_t)m * a.n_padded + n] = accum[i][j] * s;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller guarantees: planes (n_padded/cpw, k_padded) u32, codebook
// (k_padded, levels) f32, out_idx/out_val (k_out, k_padded), acc/out
// (M, n_padded) f32, x_idx (k_padded) i32, x_scale (M,) f32 or null, all
// contiguous on one device; x_type 0 = f32, 1 = bf16, 2 = int8;
// n_padded % 32 == 0 and k_padded % 64 == 0.
extern "C" int claq_dequant_matmul(
    const void* x, int x_type, const void* x_scale, int M, int x_cols,
    const void* plane0, const void* plane1, int width0, int width1,
    int nplanes, const void* codebook, int levels,
    const void* out_idx, const void* out_val, int k_out,
    const void* acc, const void* x_idx, void* out,
    int n_padded, int k_padded, int x_mode, int x_start, int k_cols,
    int compute_bf16, void* stream) {
  Args a;
  a.x = x;
  a.x_type = x_type;
  a.x_scale = static_cast<const float*>(x_scale);
  a.M = M;
  a.x_cols = x_cols;
  a.plane[0] = static_cast<const uint32_t*>(plane0);
  a.plane[1] = static_cast<const uint32_t*>(plane1);
  a.width[0] = width0;
  a.width[1] = width1;
  a.nplanes = nplanes;
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
  a.bf16 = compute_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    dim3 grid((n_padded + 31) / 32, (M + 7) / 8);
    dequant_matmul_kernel<8, 32, 64, 1, 2><<<grid, 128, 0, s>>>(a);
  } else {
    dim3 grid((n_padded + 63) / 64, (M + 63) / 64);
    dequant_matmul_kernel<64, 64, 32, 4, 4><<<grid, 256, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
