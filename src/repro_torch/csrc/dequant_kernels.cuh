// K1's kernels (see dequant_matmul.cu for what they compute and why they
// are built this way).  Each dequant_bits<B>.cu includes this file and
// instantiates dispatch<B>, so the five bit-widths compile in parallel.
#pragma once

#include <type_traits>

#include "dequant_common.cuh"

namespace claq {
namespace {

constexpr int kDecodeStages = 3;
constexpr int kPrefillStages = 3;
constexpr int kDecodeThreads = 128;   // 4 warps: one 16-column step each
constexpr int kPrefillThreads = 256;  // 8 warps
constexpr int kWfPitch = kBlockN + 1;      // f32 prefill W: [k][n]

template <bool BF16>
using XT = typename std::conditional<BF16, __nv_bfloat16, float>::type;

template <bool BF16>
__device__ __forceinline__ XT<BF16> to_x(float v) {
  if constexpr (BF16) return __float2bfloat16_rn(v);
  else return v;
}

// Shared memory of the decode path: the ring, x of the K slice
// ([MT][chunks_per_slice * 64 + kXPad]) and, for bf16, a 4 KB fragment
// scratch per warp; after the loop the same bytes hold the 4 warps'
// partial tiles.
// byte offset of the fragment scratch: after the ring and x
__host__ __device__ inline size_t decode_scratch(const StageLayout& L,
                                                 int mt, int cps, bool bf16) {
  const size_t xs = (size_t)mt * (cps * kChunkK + kXPad) * (bf16 ? 2 : 4);
  return (kDecodeStages * (size_t)L.bytes + xs + 15) / 16 * 16;
}

__host__ __device__ inline size_t decode_smem(const StageLayout& L, int mt,
                                              int cps, bool bf16) {
  const size_t scratch = bf16 ? 4 * 8 * 32 * 16 : 0;
  const size_t used = decode_scratch(L, mt, cps, bf16) + scratch;
  const size_t red = (size_t)4 * mt * kTilePitch * 4;
  return used > red ? used : red;
}

// Decode path, M <= 16.  Block (N tile, M tile of MT rows, K slice),
// 4 warps; warp w owns the 16-column step w of every chunk.
template <int BITS, bool BF16, int MT>
__global__ void __launch_bounds__(kDecodeThreads, MT == 16 ? 3 : 4)
decode_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  using P = Planes<BITS>;
  const StageLayout L = stage_layout(P::n, P::w0, P::w1, a.levels, a.k_out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockN, m0 = blockIdx.y * MT;
  const int c_lo = blockIdx.z * a.chunks_per_slice;
  const int nc = min(a.k_padded / kChunkK, c_lo + a.chunks_per_slice) - c_lo;
  const int xpitch = a.chunks_per_slice * kChunkK + kXPad;
  XT<BF16>* xs = reinterpret_cast<XT<BF16>*>(smem + kDecodeStages * L.bytes);
  // bf16: the warp's fragments, where outliers are patched in
  uint4* scratch = reinterpret_cast<uint4*>(
                       smem + decode_scratch(L, MT, a.chunks_per_slice,
                                             BF16)) +
                   warp * 8 * 32 + lane;

  // x of the whole slice, once, from the pre-gathered rows (with the
  // first stage's copies); rows past M read as zeros
  {
    constexpr int kPer = 16 / sizeof(XT<BF16>);   // elements per copy
    const int pieces = nc * kChunkK / kPer;
    const XT<BF16>* xg = reinterpret_cast<const XT<BF16>*>(a.xg);
    for (int e = tid; e < MT * pieces; e += kDecodeThreads) {
      const int mm = e / pieces, pc = (e % pieces) * kPer;
      const bool valid = m0 + mm < a.M;
      cp_async16(xs + mm * xpitch + pc,
                 xg + (size_t)(valid ? m0 + mm : 0) * a.k_padded +
                     c_lo * kChunkK + pc,
                 valid);
    }
  }
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) {
    if (s < nc)
      load_stage<BITS>(a, L, smem + s * L.bytes, n0, c_lo + s, tid,
                       kDecodeThreads);
    cp_async_commit();
  }

  constexpr int NT = BF16 ? MT / 8 : 1;     // n8 tiles of the mma
  float cf[8][NT][4];                        // bf16: fragment sums
  float fa[16][4];                           // f32: [row slot][m]
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) cf[r][j][q] = 0.f;
#pragma unroll
  for (int s = 0; s < 16; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) fa[s][q] = 0.f;

  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();
    {
      const int nxt = c + kDecodeStages - 1;
      if (nxt < nc)
        load_stage<BITS>(a, L, smem + (nxt % kDecodeStages) * L.bytes, n0,
                         c_lo + nxt, tid, kDecodeThreads);
      cp_async_commit();
    }
    const char* stage = smem + (c % kDecodeStages) * L.bytes;
    const int kk = warp * 16 + 4 * t;              // column 0, in the chunk
    LaneW<BITS> lw;
    lw.load(a, L, stage, n0, g, kk, (c_lo + c) * kChunkK + kk);
    if constexpr (BF16) lw.load_cb_bf16();
    const int xk = c * kChunkK + kk;               // in the slice
    auto product = [&](auto out) {
      constexpr bool OUT = decltype(out)::value;
      if constexpr (BF16) {
        uint2 b[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          b[j] = *reinterpret_cast<const uint2*>(xs + (j * 8 + g) * xpitch +
                                                 xk);
        if (OUT) {              // patch the outliers through the scratch
#pragma unroll
          for (int r = 0; r < 8; ++r)
            scratch[r * 32] = lw.frag(r);
          lw.patch_frags(a, reinterpret_cast<__nv_bfloat16*>(scratch), 0,
                         8);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(cf[r][j], scratch[r * 32], b[j]);
        } else {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const uint4 f = lw.frag(r);
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(cf[r][j], f, b[j]);
          }
        }
      } else {
        float4 xv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          xv[m] = *reinterpret_cast<const float4*>(xs + m * xpitch + xk);
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          const float w0 = OUT ? lw.w_out(a, 0, s) : lw.w(0, s),
                      w1 = OUT ? lw.w_out(a, 1, s) : lw.w(1, s),
                      w2 = OUT ? lw.w_out(a, 2, s) : lw.w(2, s),
                      w3 = OUT ? lw.w_out(a, 3, s) : lw.w(3, s);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float v = fa[s][m];
            v = fmaf(w0, xv[m].x, v);
            v = fmaf(w1, xv[m].y, v);
            v = fmaf(w2, xv[m].z, v);
            v = fmaf(w3, xv[m].w, v);
            fa[s][m] = v;
          }
        }
      }
    };
    if (__any_sync(0xffffffffu, lw.any_hit()))
      product(std::true_type{});
    else
      product(std::false_type{});
  }
  cp_async_wait<0>();
  __syncthreads();

  // partial tiles of the 4 warps, then their sum in warp order
  float* red = reinterpret_cast<float*>(smem);
  float* mine = red + warp * MT * kTilePitch;
  if constexpr (BF16) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int m = j * 8 + 2 * t, n = 16 * g + r;
        mine[m * kTilePitch + n] = cf[r][j][0];
        mine[(m + 1) * kTilePitch + n] = cf[r][j][1];
        mine[m * kTilePitch + n + 8] = cf[r][j][2];
        mine[(m + 1) * kTilePitch + n + 8] = cf[r][j][3];
      }
  } else {
    // the 4 lanes t of a row group hold the same rows over other columns
#pragma unroll
    for (int s = 0; s < 16; ++s)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float v = fa[s][m];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        fa[s][m] = v;
      }
#pragma unroll
    for (int s = 0; s < 16; ++s)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (m == t) mine[m * kTilePitch + 16 * g + s] = fa[s][m];
  }
  __syncthreads();
  for (int e = tid; e < MT * kBlockN; e += kDecodeThreads) {
    const int o = (e / kBlockN) * kTilePitch + e % kBlockN;
    red[o] = ((red[o] + red[MT * kTilePitch + o]) +
              red[2 * MT * kTilePitch + o]) + red[3 * MT * kTilePitch + o];
  }
  __syncthreads();
  epilogue(a, red, m0, MT, n0, tid, kDecodeThreads);
}

// x in the fused, padded K order and the compute type, (M, k_padded): the
// pre-pass of both paths, so that every N tile and K slice then reads x
// contiguously through cp.async instead of gathering it again (a gather
// at block start cost decode 8-17 us a launch; at prefill, every N tile
// re-read the gathered columns).  It also zeroes the launch's split-K
// arrival counters, which the product kernel then counts up.
template <bool BF16>
__global__ void __launch_bounds__(256) gather_x_kernel(const Args a) {
  constexpr int kPer = 4;
  const size_t id = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id < (size_t)a.n_counters) a.counters[id] = 0;
  const size_t e0 = id * kPer;
  if (e0 >= (size_t)a.M * a.k_padded) return;
  const int m = (int)(e0 / a.k_padded), k0 = (int)(e0 % a.k_padded);
  int mi[kPer], ci[kPer];
  float v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    mi[q] = m;
    ci[q] = x_col(a, k0 + q, x_idx_at(a, k0 + q));
  }
  load_x(a, mi, ci, v);
  XT<BF16>* xg = reinterpret_cast<XT<BF16>*>(const_cast<void*>(a.xg));
#pragma unroll
  for (int q = 0; q < kPer; ++q) xg[e0 + q] = to_x<BF16>(v[q]);
}

// Shared memory of the prefill path: a ring of stages (the W operands of
// a chunk, then its x tile [64][64 + pad] in the compute type), the
// unpacked W chunk (bf16: 4 steps x 8 fragments x 32 lanes x 16 bytes;
// f32: [64][kWfPitch]); after the loop the same bytes hold the output tile.
struct PrefillSmem {
  size_t x, stage, w, bytes;
};

__host__ __device__ constexpr int prefill_x_pitch(bool bf16) {
  return kChunkK + (bf16 ? kXPad : 4);
}

__host__ __device__ inline PrefillSmem prefill_smem(const StageLayout& L,
                                                    bool bf16) {
  PrefillSmem s;
  s.x = L.bytes;
  s.stage = s.x + (size_t)kPrefillM * prefill_x_pitch(bf16) * (bf16 ? 2 : 4);
  s.w = kPrefillStages * s.stage;
  s.bytes = s.w + (bf16 ? 4 * 8 * 32 * 16 : (size_t)kChunkK * kWfPitch * 4);
  const size_t tile = (size_t)kPrefillM * kTilePitch * 4;
  if (s.bytes < tile) s.bytes = tile;
  return s;
}

// Prefill path, M > 16.  Block (N tile, 64-row M tile, K slice), 8 warps.
template <int BITS, bool BF16>
__global__ void __launch_bounds__(kPrefillThreads, 2)
prefill_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  using P = Planes<BITS>;
  const StageLayout L = stage_layout(P::n, P::w0, P::w1, a.levels, a.k_out);
  const PrefillSmem S = prefill_smem(L, BF16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockN, m0 = blockIdx.y * kPrefillM;
  const int c_lo = blockIdx.z * a.chunks_per_slice;
  const int nc = min(a.k_padded / kChunkK, c_lo + a.chunks_per_slice) - c_lo;
  constexpr int kXP = prefill_x_pitch(BF16);
  constexpr int kPieces = kChunkK * (BF16 ? 2 : 4) / 16;   // per x row

  auto load = [&](int c) {               // chunk c of the slice -> its stage
    char* stage = smem + (c % kPrefillStages) * S.stage;
    load_stage<BITS>(a, L, stage, n0, c_lo + c, tid, kPrefillThreads);
    const XT<BF16>* xg = reinterpret_cast<const XT<BF16>*>(a.xg);
    XT<BF16>* xs = reinterpret_cast<XT<BF16>*>(stage + S.x);
    const int k0 = (c_lo + c) * kChunkK;
    constexpr int kElems = 16 / (BF16 ? 2 : 4);
    for (int e = tid; e < kPrefillM * kPieces; e += kPrefillThreads) {
      const int mm = e / kPieces, pc = (e % kPieces) * kElems;
      const bool valid = m0 + mm < a.M;
      cp_async16(xs + mm * kXP + pc,
                 xg + (size_t)(valid ? m0 + mm : 0) * a.k_padded + k0 + pc,
                 valid);
    }
  };

#pragma unroll
  for (int s = 0; s < kPrefillStages - 1; ++s) {
    if (s < nc) load(s);
    cp_async_commit();
  }

  float cf[8][4];                 // bf16: warp's 8 fragments (M rows 8w..)
  float fa[4][8];                 // f32: rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) cf[r][q] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) fa[i][j] = 0.f;

  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kPrefillStages - 2>();
    __syncthreads();
    if (c + kPrefillStages - 1 < nc) load(c + kPrefillStages - 1);
    cp_async_commit();
    const char* stage = smem + (c % kPrefillStages) * S.stage;

    // unpack: warp w takes step w % 4, half w / 4 of the rows
    {
      const int step = warp & 3, half = warp >> 2;
      const int kk = step * 16 + 4 * t;
      LaneW<BITS> lw;
      lw.load(a, L, stage, n0, g, kk, (c_lo + c) * kChunkK + kk);
      if constexpr (BF16) lw.load_cb_bf16();
      const bool hit = __any_sync(0xffffffffu, lw.any_hit());
      if constexpr (BF16) {
        uint4* wf = reinterpret_cast<uint4*>(smem + S.w) + step * 8 * 32 + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = half * 4 + q;
          wf[r * 32] = lw.frag(r);
        }
        if (hit)
          lw.patch_frags(a, reinterpret_cast<__nv_bfloat16*>(wf), half * 4,
                         4);
      } else {
        float* wt = reinterpret_cast<float*>(smem + S.w) + kk * kWfPitch +
                    16 * g;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int s = half * 8 + q;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wt[i * kWfPitch + s] = lw.w(i, s);
        }
        if (hit) lw.patch_rows(a, wt, kWfPitch, half * 8, 8);
      }
    }
    __syncthreads();

    if constexpr (BF16) {
      const uint4* wf = reinterpret_cast<const uint4*>(smem + S.w);
      const __nv_bfloat16* x =
          reinterpret_cast<const __nv_bfloat16*>(stage + S.x);
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            x + (warp * 8 + g) * kXP + step * 16 + 4 * t);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          mma_bf16(cf[r], wf[(step * 8 + r) * 32 + lane], b);
      }
    } else {
      const float* wt = reinterpret_cast<const float*>(smem + S.w);
      const float* x = reinterpret_cast<const float*>(stage + S.x);
      const int ty = tid / 16, tx = tid % 16;
#pragma unroll 4
      for (int k = 0; k < kChunkK; ++k) {
        float xv[4], wv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = x[(ty + 16 * i) * kXP + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = wt[k * kWfPitch + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) fa[i][j] = fmaf(xv[i], wv[j], fa[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* tile = reinterpret_cast<float*>(smem);
  if constexpr (BF16) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = warp * 8 + 2 * t, n = 16 * g + r;
      tile[m * kTilePitch + n] = cf[r][0];
      tile[(m + 1) * kTilePitch + n] = cf[r][1];
      tile[m * kTilePitch + n + 8] = cf[r][2];
      tile[(m + 1) * kTilePitch + n + 8] = cf[r][3];
    }
  } else {
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tile[(ty + 16 * i) * kTilePitch + tx + 16 * j] = fa[i][j];
  }
  __syncthreads();
  epilogue(a, tile, m0, kPrefillM, n0, tid, kPrefillThreads);
}

// Launch one instantiation on `grid`, raising its dynamic shared memory
// limit the first time it needs more than the default 48 KB.  Where `grid`
// is null, write the launch's dynamic shared memory and the blocks an SM
// holds to query[0..1] instead (claq_dequant_occupancy).
template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t& configured, dim3* grid,
                   int threads, size_t smem, cudaStream_t stream,
                   const Args& a, int* query) {
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  if (grid == nullptr) {
    query[0] = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(query + 1, kernel,
                                                         threads, smem);
  }
  kernel<<<*grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BITS, bool BF16, int MT>
cudaError_t launch_decode(dim3* grid, cudaStream_t s, const Args& a,
                          int* query) {
  static size_t configured = 0;
  using P = Planes<BITS>;
  const StageLayout L = stage_layout(P::n, P::w0, P::w1, a.levels, a.k_out);
  return launch(decode_kernel<BITS, BF16, MT>, configured, grid,
                kDecodeThreads, decode_smem(L, MT, a.chunks_per_slice, BF16),
                s, a, query);
}

template <int BITS, bool BF16>
cudaError_t launch_prefill(dim3* grid, cudaStream_t s, const Args& a,
                           int* query) {
  static size_t configured = 0;
  using P = Planes<BITS>;
  const StageLayout L = stage_layout(P::n, P::w0, P::w1, a.levels, a.k_out);
  return launch(prefill_kernel<BITS, BF16>, configured, grid,
                kPrefillThreads, prefill_smem(L, BF16).bytes, s, a, query);
}

// The product kernel of a launch plan: launch it on `grid`, or (grid null)
// write its shared memory and resident blocks per SM to query[0..1].
template <int BITS>
cudaError_t product(int block_m, bool bf16, dim3* grid, cudaStream_t s,
                    const Args& a, int* query) {
  if (block_m == kPrefillM)
    return bf16 ? launch_prefill<BITS, true>(grid, s, a, query)
                : launch_prefill<BITS, false>(grid, s, a, query);
  if (bf16)
    return block_m == 8 ? launch_decode<BITS, true, 8>(grid, s, a, query)
                        : launch_decode<BITS, true, 16>(grid, s, a, query);
  return launch_decode<BITS, false, 4>(grid, s, a, query);
}

}  // namespace

template <int BITS>
cudaError_t dispatch(int block_m, bool bf16, dim3* grid, cudaStream_t s,
                     const Args& a, int* query) {
  if (grid == nullptr) return product<BITS>(block_m, bf16, grid, s, a, query);
  size_t threads = ((size_t)a.M * a.k_padded + 3) / 4;
  if (threads < (size_t)a.n_counters) threads = a.n_counters;
  const unsigned gather_blocks = (unsigned)((threads + 255) / 256);
  if (bf16)
    gather_x_kernel<true><<<gather_blocks, 256, 0, s>>>(a);
  else
    gather_x_kernel<false><<<gather_blocks, 256, 0, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return product<BITS>(block_m, bf16, grid, s, a, query);
}

}  // namespace claq
