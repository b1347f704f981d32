// Device pieces shared by K1's two paths (decode and prefill), see
// dequant_matmul.cu: the argument block, the staged-chunk layout, the
// cp.async ring's copies, one lane's view of the packed code planes, the
// bf16 tensor-core product and the split-K epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace claq {

enum XMode { kBlocked = 0, kAligned = 1, kGathered = 2 };
enum XType { kF32 = 0, kBf16 = 1, kInt8 = 2 };

constexpr int kBlockN = 128;      // output rows (N) of every block tile
constexpr int kChunkK = 64;       // K columns one pipeline stage holds
constexpr int kWordPad = 16;      // words of padding per staged plane row
constexpr int kXPad = 16;         // elements of padding per staged x row
constexpr int kSmemLevels = 16;   // codebooks of <= 4 bits are staged
constexpr int kTilePitch = kBlockN + 4;   // f32 pitch of an output tile
constexpr int kPrefillM = 64;     // M rows of a prefill tile (M > 16)
constexpr int kDecodeMaxSliceChunks = 16;   // x of a decode slice is staged
// Outlier slots staged with each chunk.  Slots past this many are read in
// slot order from device memory (plans with a large outlier ratio): the
// stage's size, and with it the blocks an SM holds, does not grow with
// k_out.
constexpr int kStageOut = 8;

struct Args {
  const void* x;
  int x_type;
  const float* x_scale;
  int M;
  int x_cols;
  const uint32_t* plane[2];
  const float* codebook;
  int levels;
  const int* out_idx;
  const float* out_val;
  int k_out;
  const float* acc;
  const int* x_idx;
  const void* xg;         // prefill: x in fused K order, compute type
  float* out;
  int n_padded;
  int k_padded;
  int x_mode;
  int x_start;
  int k_cols;
  int chunks_per_slice;   // K chunks of one split-K slice (gridDim.z)
  float* workspace;       // (slices, M, n_padded) partial sums, slices > 1
  int* counters;          // one arrival counter per output tile, slices > 1
  int n_counters;         // zeroed by the pre-pass of every launch
};

// Plane widths of a bit-width: a 3-bit code is a 2-bit plane plus a 1-bit
// plane shifted left by 2 (core/packing.py).
template <int BITS> struct Planes;
template <> struct Planes<1> { static constexpr int n = 1, w0 = 1, w1 = 0; };
template <> struct Planes<2> { static constexpr int n = 1, w0 = 2, w1 = 0; };
template <> struct Planes<3> { static constexpr int n = 2, w0 = 2, w1 = 1; };
template <> struct Planes<4> { static constexpr int n = 1, w0 = 4, w1 = 0; };
template <> struct Planes<8> { static constexpr int n = 1, w0 = 8, w1 = 0; };

// Byte offsets inside one pipeline stage: the plane words of kBlockN rows
// x kChunkK columns (a plane of width w has kBlockN * w / 32 word rows),
// the chunk's codebook rows (<= 4 bits) and the idx and val rows of its
// first staged_slots(k_out) outlier slots.
struct StageLayout {
  int plane[2];
  int cb;
  int oidx;
  int oval;
  int bytes;
};

__host__ __device__ inline int plane_word_rows(int width) {
  return kBlockN * width / 32;
}

__host__ __device__ inline int staged_slots(int k_out) {
  return k_out < kStageOut ? k_out : kStageOut;
}

__host__ __device__ inline StageLayout stage_layout(int nplanes, int w0,
                                                    int w1, int levels,
                                                    int k_out) {
  StageLayout s;
  int off = 0;
  for (int p = 0; p < 2; ++p) {
    s.plane[p] = off;
    if (p < nplanes)
      off += plane_word_rows(p == 0 ? w0 : w1) * (kChunkK + kWordPad) * 4;
  }
  s.cb = off;
  if (levels <= kSmemLevels) off += kChunkK * levels * 4;
  s.oidx = off;
  off += staged_slots(k_out) * kChunkK * 4;
  s.oval = off;
  off += staged_slots(k_out) * kChunkK * 4;
  s.bytes = off;
  return s;
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;           // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of K chunk `chunk` for the tile at row n0 into `stage`,
// 16 bytes a thread, neighbouring threads on neighbouring K.  Word rows
// past the plane's end read as zeros.
template <int BITS>
__device__ __forceinline__ void load_stage(const Args& a,
                                           const StageLayout& L, char* stage,
                                           int n0, int chunk, int tid,
                                           int nthreads) {
  using P = Planes<BITS>;
  const int k0 = chunk * kChunkK;
#pragma unroll
  for (int p = 0; p < P::n; ++p) {
    const int w = p == 0 ? P::w0 : P::w1;
    const int rows = plane_word_rows(w);
    const int wr0 = n0 * w / 32;
    const int total = a.n_padded * w / 32;
    uint32_t* dst = reinterpret_cast<uint32_t*>(stage + L.plane[p]);
    for (int e = tid; e < rows * (kChunkK / 4); e += nthreads) {
      const int r = e / (kChunkK / 4), c = (e % (kChunkK / 4)) * 4;
      const bool valid = wr0 + r < total;
      const uint32_t* src =
          a.plane[p] + (size_t)(valid ? wr0 + r : 0) * a.k_padded + k0 + c;
      cp_async16(dst + r * (kChunkK + kWordPad) + c, src, valid);
    }
  }
  if (a.levels <= kSmemLevels) {
    float* dst = reinterpret_cast<float*>(stage + L.cb);
    const float* src = a.codebook + (size_t)k0 * a.levels;
    for (int e = tid; e < kChunkK * a.levels / 4; e += nthreads)
      cp_async16(dst + 4 * e, src + 4 * e, true);
  }
  for (int e = tid; e < staged_slots(a.k_out) * (kChunkK / 4);
       e += nthreads) {
    const int o = e / (kChunkK / 4), c = (e % (kChunkK / 4)) * 4;
    const size_t g = (size_t)o * a.k_padded + k0 + c;
    cp_async16(reinterpret_cast<int*>(stage + L.oidx) + o * kChunkK + c,
               a.out_idx + g, true);
    cp_async16(reinterpret_cast<float*>(stage + L.oval) + o * kChunkK + c,
               a.out_val + g, true);
  }
}

// ---------------------------------------------------------------- x

// The column of x that fused column k reads, or -1 where it reads 0
// (aligned: past k_cols; gathered: the fill slot x_idx[k] == x_cols);
// `idx` is x_idx[k] (x_idx_at), read ahead of time by the caller.
__device__ __forceinline__ int x_idx_at(const Args& a, int k) {
  return a.x_mode == kGathered ? __ldg(a.x_idx + k) : 0;
}

__device__ __forceinline__ int x_col(const Args& a, int k, int idx) {
  if (a.x_mode == kGathered) return idx < a.x_cols ? idx : -1;
  if (a.x_mode == kAligned) return k < a.k_cols ? a.x_start + k : -1;
  return k;
}

// x[m][col] for N pairs at once, as f32: every load is issued before any
// use, so the N round trips overlap.  Rows past M and col < 0 read as 0.
template <int N>
__device__ __forceinline__ void load_x(const Args& a, const int (&m)[N],
                                       const int (&col)[N], float (&v)[N]) {
  size_t off[N];
  bool ok[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    ok[q] = m[q] < a.M && col[q] >= 0;
    off[q] = ok[q] ? (size_t)m[q] * a.x_cols + col[q] : 0;
  }
  if (a.x_type == kBf16) {
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(a.x);
    __nv_bfloat16 r[N];
#pragma unroll
    for (int q = 0; q < N; ++q) r[q] = x[off[q]];
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = ok[q] ? __bfloat162float(r[q]) : 0.f;
  } else if (a.x_type == kInt8) {
    const int8_t* x = reinterpret_cast<const int8_t*>(a.x);
    int8_t r[N];
#pragma unroll
    for (int q = 0; q < N; ++q) r[q] = x[off[q]];
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = ok[q] ? static_cast<float>(r[q]) : 0.f;
  } else {
    const float* x = reinterpret_cast<const float*>(a.x);
    float r[N];
#pragma unroll
    for (int q = 0; q < N; ++q) r[q] = x[off[q]];
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = ok[q] ? r[q] : 0.f;
  }
}

// ---------------------------------------------------------------- W

__device__ __forceinline__ uint32_t word_k(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One lane's view of a 16-column K step of a staged chunk: lane (g, t)
// holds the words of output rows n0 + 16 g .. + 15 at the four K columns
// 4 t .. 4 t + 3 of the step (16 bytes of each word row it needs), its
// four columns' codebooks and staged outlier slots, and a mask per column
// of the rows an outlier slot names.  Slots past the stage are read from
// device memory through the kernel's Args, which cost no registers.  w(i, s) is W[n0 + 16 g + s][k of column i]
// after the outlier override (a later slot wins), as f32.
template <int BITS>
struct LaneW {
  using P = Planes<BITS>;
  static constexpr int kWords0 = P::w0 >= 2 ? P::w0 / 2 : 1;
  uint4 w0[kWords0];
  uint4 w1;
  int base0, base1;      // bit offset of row 16 g in a 1-bit plane's word
  const float* cb;       // codebook of column 0 (smem or device memory)
  int cb_stride;         // between neighbouring columns
  const int* oidx;       // outlier slots of column 0 in the stage
  const float* oval;
  int k_out;
  int kg;                // column 0's fused K column (slots past the stage)
  int row0;              // n0 + 16 g
  unsigned hit[4];
  uint32_t cblo[4], cbhi[4];   // 2-bit, bf16: column i's 4 levels in bf16

  __device__ __forceinline__ void load(const Args& a, const StageLayout& L,
                                       const char* stage, int n0, int g,
                                       int kk, int kglob) {
    const int pitch = kChunkK + kWordPad;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(stage + L.plane[0]);
    if (P::w0 >= 2) {
#pragma unroll
      for (int j = 0; j < kWords0; ++j)
        w0[j] = *reinterpret_cast<const uint4*>(
            p0 + (g * kWords0 + j) * pitch + kk);
      base0 = 0;
    } else {
      w0[0] = *reinterpret_cast<const uint4*>(p0 + (g >> 1) * pitch + kk);
      base0 = 16 * (g & 1);
    }
    if (P::n == 2) {
      const uint32_t* p1 =
          reinterpret_cast<const uint32_t*>(stage + L.plane[1]);
      w1 = *reinterpret_cast<const uint4*>(p1 + (g >> 1) * pitch + kk);
      base1 = 16 * (g & 1);
    }
    if (a.levels <= kSmemLevels) {
      cb = reinterpret_cast<const float*>(stage + L.cb) + kk * a.levels;
    } else {
      cb = a.codebook + (size_t)kglob * a.levels;
    }
    cb_stride = a.levels;
    oidx = reinterpret_cast<const int*>(stage + L.oidx) + kk;
    oval = reinterpret_cast<const float*>(stage + L.oval) + kk;
    k_out = a.k_out;
    kg = kglob;
    row0 = n0 + 16 * g;
#pragma unroll
    for (int i = 0; i < 4; ++i) hit[i] = 0u;
    const int staged = staged_slots(k_out);
    for (int o = 0; o < staged; ++o)      // the 4 columns' slot o at once
      mark(*reinterpret_cast<const int4*>(oidx + o * kChunkK));
    for (int o = staged; o < k_out; ++o)  // past the stage: device memory
      mark(__ldg(reinterpret_cast<const int4*>(
          a.out_idx + (size_t)o * a.k_padded + kg)));
  }

  __device__ __forceinline__ void mark(const int4& id) {
    const unsigned d[4] = {static_cast<unsigned>(id.x - row0),
                           static_cast<unsigned>(id.y - row0),
                           static_cast<unsigned>(id.z - row0),
                           static_cast<unsigned>(id.w - row0)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d[i] < 16u) hit[i] |= 1u << d[i];
  }

  // f(row id, o) for every outlier slot o of column i, in slot order: the
  // staged slots from shared memory, then the rest from device memory
  template <typename F>
  __device__ __forceinline__ void each_slot(const Args& a, int i, F f) const {
    const int staged = staged_slots(k_out);
#pragma unroll 1
    for (int o = 0; o < staged; ++o) f(oidx[o * kChunkK + i], o);
#pragma unroll 1
    for (int o = staged; o < k_out; ++o)
      f(__ldg(a.out_idx + (size_t)o * a.k_padded + kg + i), o);
  }
  __device__ __forceinline__ float slot_val(const Args& a, int o,
                                            int i) const {
    return o < staged_slots(k_out)
               ? oval[o * kChunkK + i]
               : __ldg(a.out_val + (size_t)o * a.k_padded + kg + i);
  }

  __device__ __forceinline__ int code(int i, int s) const {
    int c;
    if (P::w0 >= 2) {
      constexpr int cpw = 32 / (P::w0 >= 2 ? P::w0 : 2);
      c = (int)((word_k(w0[s / cpw], i) >> ((s % cpw) * P::w0)) &
                ((1u << P::w0) - 1u));
    } else {
      c = (int)((word_k(w0[0], i) >> (base0 + s)) & 1u);
    }
    if (P::n == 2) c |= (int)((word_k(w1, i) >> (base1 + s)) & 1u) << 2;
    return c;
  }

  // 2-bit groups in bf16: hold each column's codebook in registers (four
  // bf16 levels in 8 bytes), for frag's byte-permute lookup.
  __device__ __forceinline__ void load_cb_bf16() {
    if constexpr (BITS == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 c = *reinterpret_cast<const float4*>(cb + i * 4);
        cblo[i] = pack(c.x, c.y);
        cbhi[i] = pack(c.z, c.w);
      }
    }
  }

  // whether an outlier slot names one of the lane's rows in its columns
  __device__ __forceinline__ bool any_hit() const {
    return (hit[0] | hit[1] | hit[2] | hit[3]) != 0u;
  }

  // The codebook's weight, without the outlier override: what the caller
  // takes when no lane of the warp has a hit (the common case: a few
  // outliers per column among thousands of rows).  The bf16 paths always
  // take it: they build fragments from the codebook and patch them
  // afterwards (patch_frags), which keeps the unrolled code small.
  __device__ __forceinline__ float w(int i, int s) const {
    return BITS <= 4 ? cb[i * cb_stride + code(i, s)]
                     : __ldg(cb + (size_t)i * cb_stride + code(i, s));
  }

  // The same with the outlier override.
  __device__ __forceinline__ float w_out(const Args& a, int i, int s) const {
    float v = w(i, s);
    if ((hit[i] >> s) & 1u)
      each_slot(a, i, [&](int id, int o) {
        if (id == row0 + s) v = slot_val(a, o, i);
      });
    return v;
  }

  // The A fragment of mma.m16n8k16 for slots r (rows 0-7 of the
  // fragment) and r + 8 (rows 8-15): the lane's columns 4t .. 4t+3 play
  // the fragment's K 2t, 2t+1, 2t+8, 2t+9 (x is taken in the same order,
  // so the sum is the same), rounded to bf16; outliers not yet applied.
  __device__ __forceinline__ uint4 frag(int r) const {
    uint4 f;
    if constexpr (BITS == 2) {
      // byte-permute lookup (after load_cb_bf16): the codes of rows r and
      // r + 8 become the selector nibbles (2c, 2c + 1) of their levels'
      // bytes, so one prmt reads both weights of a column
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t c2 =
            __byte_perm((word_k(w0[0], i) >> (2 * r)) & 0x00030003u, 0u,
                        0x0020u);                 // byte 0: row r, 1: r + 8
        v[i] = __byte_perm(cblo[i], cbhi[i], c2 * 0x22u + 0x1010u);
      }
      f.x = __byte_perm(v[0], v[1], 0x5410u);     // row r, columns 0, 1
      f.y = __byte_perm(v[0], v[1], 0x7632u);     // row r + 8
      f.z = __byte_perm(v[2], v[3], 0x5410u);     // row r, columns 2, 3
      f.w = __byte_perm(v[2], v[3], 0x7632u);
      return f;
    }
    f.x = pack(w(0, r), w(1, r));
    f.y = pack(w(0, r + 8), w(1, r + 8));
    f.z = pack(w(2, r), w(3, r));
    f.w = pack(w(2, r + 8), w(3, r + 8));
    return f;
  }

  // Overwrite the outliers of the lane's rows in its fragments, column by
  // column in slot order (a later slot wins).  Fragment r of the lane sits at
  // frags[r * 32 * 8 ..] (8 bf16, the order of frag()); only fragments
  // r_lo .. r_lo + r_n - 1 are the caller's.  Compact on purpose: a
  // runtime loop, taken only by warps with a hit.
  __device__ __forceinline__ void patch_frags(const Args& a,
                                              __nv_bfloat16* frags, int r_lo,
                                              int r_n) const {
#pragma unroll 1
    for (int i = 0; i < 4; ++i)
      each_slot(a, i, [&](int id, int o) {
        const unsigned d = static_cast<unsigned>(id - row0);
        const int r = static_cast<int>(d & 7u) - r_lo;
        if (d < 16u && r >= 0 && r < r_n)
          frags[(r_lo + r) * 32 * 8 + ((i >> 1) * 2 + (d >> 3)) * 2 +
                (i & 1)] = __float2bfloat16_rn(slot_val(a, o, i));
      });
  }

  // The same for a K x N f32 tile: column i of the lane, row 16 g + s,
  // at tile[i * pitch + s], for rows s_lo .. s_lo + s_n - 1.
  __device__ __forceinline__ void patch_rows(const Args& a, float* tile,
                                             int pitch, int s_lo,
                                             int s_n) const {
#pragma unroll 1
    for (int i = 0; i < 4; ++i)
      each_slot(a, i, [&](int id, int o) {
        const unsigned d = static_cast<unsigned>(id - row0);
        const int s = static_cast<int>(d) - s_lo;
        if (d < 16u && s >= 0 && s < s_n)
          tile[i * pitch + s_lo + s] = slot_val(a, o, i);
      });
  }

  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
};

// c += A (16 x 16, bf16) * B (16 x 8, bf16), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// ---------------------------------------------------------------- epilogue

// Store the block's tile sum `tile` ([mt][kTilePitch] f32 in shared memory,
// rows m0.., columns n0..): with one K slice, out = ([acc +] tile) * scale;
// with several, every slice writes its partial sums to the workspace and
// the last block to arrive at the tile adds the slices in slice order onto
// the acc seed, then scales.  No float atomics: the result is the same
// from call to call.  Every launch has counters of its own, zeroed by its
// pre-pass (gather_x_kernel), so launches on other streams never share
// one.
__device__ __forceinline__ void epilogue(const Args& a, const float* tile,
                                         int m0, int mt, int n0, int tid,
                                         int nthreads) {
  __shared__ int last;
  const int slices = gridDim.z;
  const size_t plane = (size_t)a.M * a.n_padded;
  if (slices > 1) {
    float* part = a.workspace + blockIdx.z * plane;
    for (int e = tid; e < mt * kBlockN; e += nthreads) {
      const int mm = e / kBlockN, nn = e % kBlockN;
      const int m = m0 + mm, n = n0 + nn;
      if (m < a.M && n < a.n_padded)
        part[(size_t)m * a.n_padded + n] = tile[mm * kTilePitch + nn];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int id = blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(a.counters + id, 1) == slices - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  // 4 outputs a thread at a time, their slices read 4 at a time, so that
  // 16 loads are in flight; the sum runs in slice order all the same
  constexpr int kE = 4;
  for (int e0 = tid; e0 < mt * kBlockN; e0 += kE * nthreads) {
    size_t o[kE];
    bool ok[kE];
    float v[kE];
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      const int e = e0 + q * nthreads;
      const int m = m0 + e / kBlockN, n = n0 + e % kBlockN;
      ok[q] = e < mt * kBlockN && m < a.M && n < a.n_padded;
      o[q] = ok[q] ? (size_t)m * a.n_padded + n : 0;
      v[q] = a.acc != nullptr && ok[q] ? a.acc[o[q]] : 0.f;
      if (slices == 1 && ok[q])
        v[q] = a.acc != nullptr ? v[q] + tile[(e / kBlockN) * kTilePitch +
                                              e % kBlockN]
                                : tile[(e / kBlockN) * kTilePitch +
                                       e % kBlockN];
    }
    if (slices > 1) {
      int s = 0;
      for (; s + 4 <= slices; s += 4) {
        float p[4][kE];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < kE; ++q)
            p[j][q] = __ldcg(a.workspace + (s + j) * plane + o[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < kE; ++q) v[q] += p[j][q];
      }
      for (; s < slices; ++s)
#pragma unroll
        for (int q = 0; q < kE; ++q)
          v[q] += __ldcg(a.workspace + s * plane + o[q]);
    }
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      if (!ok[q]) continue;
      const int m = (int)(o[q] / a.n_padded);
      a.out[o[q]] = v[q] * (a.x_scale != nullptr ? a.x_scale[m] : 1.f);
    }
  }
}

}  // namespace claq
