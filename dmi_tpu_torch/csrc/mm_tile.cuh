// One block-tiled tensor-core matmul (warp-level wmma, a cp.async ring) for
// the probe kernels of dmi_tpu_torch, at shapes whose rows TMA cannot take
// (not whole 16-byte units, or a base off 16 bytes): the wmma instances of
// the blocked matmul (block_mm.cu, kRowMajorA), the weight-stream matmul
// (stream_mm.cu, kTransA) and the packed-W4 probes (w4_probe.cu, kSplitOut
// and kSplitK), all at kBM 128.  Their main instances are TMA rings into
// wgmma (block_mm.cu; stream_mm.cu over stream_ring.cuh; w4_probe.cu).
//
//   out[m, n] = sum_k A[m, k] * B[k, n]        out [M, N] row-major
//
// B [K, N] is row-major.  A comes in one of four layouts (kLayout):
//   kRowMajorA  A [M, K] row-major                  (blocked int8/bf16 matmul)
//   kTransA     A stored as [K, M] row-major: w^T h (weight-stream matmul)
//   kSplitOut   A^T = int4 weights [K, M] packed as p [K, M/2] uint8: byte
//               (k, j) holds column j in its low nibble and j + M/2 in its high
//   kSplitK     A^T packed as p [K/2, M] uint8: byte (k, n) holds row k in its
//               low nibble and row k + K/2 in its high
// int8 operands (signed char) accumulate in int32, bf16 ones in f32; the
// output is the accumulator or, for bf16, the f32 sum rounded once.
//
// A block owns a kBM x 128 output tile (kBM 64, 128 or 256); 8 warps in a
// 2 x 4 grid each own kBM/2 x 32 of it as 16 x 16 wmma fragments that stay in
// registers over the whole K loop.  K goes through a ring of kStages chunks
// of 64 bytes per staged row (64 int8 or 32 bf16 values of K) in shared
// memory, filled by 16-byte cp.async copies that stay in flight while the
// chunk before them is multiplied (one barrier per chunk).
//
// Shared-memory layout: a staged tile [rows][cols] is kept as panels
// [cols/16][rows][16], so that every 16 x 16 fragment is one contiguous,
// 256-byte-aligned block that wmma loads with a leading dimension of 16: the
// int8 fragment of a row-major tile would otherwise start 16 bytes into a
// row, off wmma's 32-byte alignment.  The packed layouts are unpacked while
// staging: each thread reads 16 packed bytes once, sign-extends both nibbles
// (dmi::sext_nibbles) and writes the low and the high values to their two
// places in the tile (two column ranges for kSplitOut, two row ranges of the
// chunk for kSplitK), so the unpacked weights never reach device memory and
// every packed byte is read once per block.  kSplitK's chunk holds 32 rows
// of each half of K; integer sums are exact in any order.
//
// Any M, N and K: rows and columns past the matrices are staged as zeros and
// outputs past them are not written; 16-byte copies are used where a
// matrix's rows are whole vectors, element copies elsewhere.
#pragma once

#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace dmi {
namespace mm {

namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // 8 warps: 2 along M, 4 along N
constexpr int kBN = 128;       // output columns per block
constexpr int kRowBytes = 64;  // bytes of K per staged row
constexpr int kStages = 4;
constexpr int kRowMajorA = 0, kTransA = 1, kSplitOut = 2, kSplitK = 3;

template <typename T>
struct Acc;
template <>
struct Acc<signed char> {
  using type = int;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

template <typename T, int kBM>
struct Shape {
  static constexpr int kVE = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int kBK = kRowBytes / sizeof(T);
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBK * kBN * (int)sizeof(T);
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kFM = kBM / 32, kFN = kBN / 64;  // fragments per warp
};

// element offset of (r, c) in a tile of `rows` rows kept as 16-wide panels
__device__ __forceinline__ int panel_off(int r, int c, int rows) {
  return ((c >> 4) * rows + r) * 16 + (c & 15);
}

// The source row of row r of a staged chunk, -1 past the end.  hb == 0: rows
// r0 + r of [0, n_rows).  hb > 0 (kSplitK's B): the chunk's first hb rows are
// rows r0 + r of the first half [0, kh), the others rows r0 + r - hb of the
// second half [kh, 2 kh).
__device__ __forceinline__ int chunk_row(int r, int r0, int n_rows, int kh, int hb) {
  if (hb == 0) return r0 + r < n_rows ? r0 + r : -1;
  const int rr = r < hb ? r : r - hb;
  if (r0 + rr >= kh) return -1;
  return r < hb ? r0 + rr : kh + r0 + rr;
}

// A [kRows][kCols] tile of the row-major matrix src (ld elements per row) at
// source rows chunk_row(r, ...) and columns c0.. into panels at dst; entries
// past the matrix are zero.  vec: n_cols is a multiple of the vector and src
// is 16-byte aligned, so one cp.async per 16 bytes.
template <typename T, int kRows, int kCols>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int ld, int r0,
                                           int n_rows, int kh, int hb, int c0, int n_cols,
                                           bool vec) {
  using Raw = std::conditional_t<sizeof(T) == 1, uint8_t, uint16_t>;
  constexpr int kVE = 16 / sizeof(T), kVPR = kCols / kVE;
  for (int v = threadIdx.x; v < kRows * kVPR; v += kThreads) {
    const int r = v / kVPR, c = (v % kVPR) * kVE;
    const int g = chunk_row(r, r0, n_rows, kh, hb);
    T* d = dst + panel_off(r, c, kRows);
    if (vec) {
      const bool ok = g >= 0 && c0 + c < n_cols;
      __pipeline_memcpy_async(d, ok ? src + (size_t)g * ld + c0 + c : src, 16, ok ? 0 : 16);
    } else {
      const Raw* s = reinterpret_cast<const Raw*>(src) + (size_t)max(g, 0) * ld + c0 + c;
#pragma unroll
      for (int i = 0; i < kVE; ++i)
        reinterpret_cast<Raw*>(d)[i] = (g >= 0 && c0 + c + i < n_cols) ? s[i] : Raw(0);
    }
  }
}

// The packed weights of one chunk: kItemRows packed rows from r0 (of n_rows)
// by kItemCols packed columns from c0 (of n_cols), unpacked into the A tile
// [64 rows][kBM cols].  kSplitK: the low nibbles go to row r, the high ones to
// row r + 32; kSplitOut: to columns c and c + kBM / 2.
template <int kLayout, int kBM>
__device__ __forceinline__ void stage_packed(signed char* dst, const uint8_t* __restrict__ p,
                                             int ld, int r0, int n_rows, int c0, int n_cols,
                                             bool vec) {
  constexpr int kBK = kRowBytes;
  constexpr int kItemRows = kLayout == kSplitK ? kBK / 2 : kBK;
  constexpr int kVPR = (kLayout == kSplitK ? kBM : kBM / 2) / 16;
  for (int v = threadIdx.x; v < kItemRows * kVPR; v += kThreads) {
    const int r = v / kVPR, c = (v % kVPR) * 16;
    const int g = r0 + r;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (g < n_rows) {
      const uint8_t* s = p + (size_t)g * ld + c0 + c;
      if (vec) {
        if (c0 + c < n_cols) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(s));
          w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (c0 + c + i < n_cols) w[i / 4] |= (uint32_t)__ldg(s + i) << (8 * (i % 4));
      }
    }
    const int lo = panel_off(r, c, kBK);
    const int hi = kLayout == kSplitK ? panel_off(r + kBK / 2, c, kBK)
                                      : panel_off(r, c + kBM / 2, kBK);
    *reinterpret_cast<uint4*>(dst + lo) =
        make_uint4(sext_nibbles(w[0]), sext_nibbles(w[1]), sext_nibbles(w[2]),
                   sext_nibbles(w[3]));
    *reinterpret_cast<uint4*>(dst + hi) =
        make_uint4(sext_nibbles(w[0] >> 4), sext_nibbles(w[1] >> 4), sext_nibbles(w[2] >> 4),
                   sext_nibbles(w[3] >> 4));
  }
}

// a: the A operand in kLayout (T, or uint8 for the packed layouts).  Grid:
// x over the 128-column tiles of N (neighbouring blocks share their A rows,
// which the second one finds in L2), y over the kBM-row tiles of M.
template <typename T, typename TOut, int kLayout, int kBM>
__global__ void __launch_bounds__(kThreads)
    mm_kernel(const void* __restrict__ a, const T* __restrict__ b, TOut* __restrict__ out,
              int M, int N, int K, bool vec_a, bool vec_b) {
  using S = Shape<T, kBM>;
  using TAcc = typename Acc<T>::type;
  constexpr int kBK = S::kBK, kFM = S::kFM, kFN = S::kFN;
  constexpr bool kPacked = kLayout == kSplitOut || kLayout == kSplitK;
  static_assert(!kPacked || sizeof(T) == 1, "packed weights are int4 against int8");
  using ALayout = std::conditional_t<kLayout == kRowMajorA, wmma::row_major, wmma::col_major>;

  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * kBN;
  // kSplitOut: the block's rows are packed columns j0.. (low nibbles) and
  // M/2 + j0.. (high nibbles), kBM / 2 of each
  const int half = M / 2, j0 = blockIdx.y * (kBM / 2), m0 = blockIdx.y * kBM;
  const int kh = K / 2;
  const int hb = kLayout == kSplitK ? kBK / 2 : 0;  // kSplitK: rows of each half per chunk
  const int chunks = kLayout == kSplitK ? (kh + hb - 1) / hb : (K + kBK - 1) / kBK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, TAcc> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], TAcc(0));

  auto stage = [&](int c) {
    unsigned char* slot = smem + (c % kStages) * S::kStageBytes;
    T* a_s = reinterpret_cast<T*>(slot);
    T* b_s = reinterpret_cast<T*>(slot + S::kABytes);
    const int k0 = c * (hb ? hb : kBK);
    if constexpr (kLayout == kRowMajorA)
      stage_tile<T, kBM, kBK>(a_s, static_cast<const T*>(a), K, m0, M, 0, 0, k0, K, vec_a);
    else if constexpr (kLayout == kTransA)
      stage_tile<T, kBK, kBM>(a_s, static_cast<const T*>(a), M, k0, K, 0, 0, m0, M, vec_a);
    else if constexpr (kLayout == kSplitOut)
      stage_packed<kLayout, kBM>(reinterpret_cast<signed char*>(a_s),
                                 static_cast<const uint8_t*>(a), half, k0, K, j0, half, vec_a);
    else
      stage_packed<kLayout, kBM>(reinterpret_cast<signed char*>(a_s),
                                 static_cast<const uint8_t*>(a), M, k0, kh, m0, M, vec_a);
    stage_tile<T, kBK, kBN>(b_s, b, N, k0, K, kh, hb, n0, N, vec_b);
  };

  // chunk c lives in slot c % kStages; one commit per chunk, with copies or
  // empty, so that chunk c is always the kStages - 2 newest groups away
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) stage(c);
    __pipeline_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have, and everyone is done with chunk c - 1
    if (c + kStages - 1 < chunks) stage(c + kStages - 1);
    __pipeline_commit();
    const unsigned char* slot = smem + (c % kStages) * S::kStageBytes;
    const T* a_s = reinterpret_cast<const T*>(slot);
    const T* b_s = reinterpret_cast<const T*>(slot + S::kABytes);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> fa[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        const int mi = wm * (kBM / 2) + 16 * i;
        // row-major A: panels over K; otherwise A^T [K][M]: panels over M
        const int off = kLayout == kRowMajorA ? panel_off(mi, 16 * ks, kBM)
                                              : panel_off(16 * ks, mi, kBK);
        wmma::load_matrix_sync(fa[i], a_s + off, 16);
      }
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(fb[j], b_s + panel_off(16 * ks, wn * 32 + 16 * j, kBK), 16);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is free: each warp stages its fragments there

  TAcc* scratch = reinterpret_cast<TAcc*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int t = wm * (kBM / 2) + 16 * i + e / 16;  // row of the block's tile
        int row;
        if constexpr (kLayout == kSplitOut) {
          const int jj = j0 + (t < kBM / 2 ? t : t - kBM / 2);
          row = jj < half ? (t < kBM / 2 ? jj : half + jj) : M;
        } else {
          row = m0 + t;
        }
        const int col = n0 + wn * 32 + 16 * j + e % 16;
        if (row < M && col < N) {
          if constexpr (std::is_same_v<TOut, TAcc>)
            out[(size_t)row * N + col] = scratch[e];
          else
            out[(size_t)row * N + col] = Num<TOut>::store(scratch[e]);
        }
      }
      __syncwarp();
    }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Checks the shapes, sets the kernel's shared memory and launches it on
// `stream`; returns the CUDA error code (0 on success).
template <typename T, typename TOut, int kLayout, int kBM>
int launch(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t stream) {
  using S = Shape<T, kBM>;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if ((kLayout == kSplitOut && M % 2) || (kLayout == kSplitK && K % 2))
    return (int)cudaErrorInvalidValue;
  const int m_tiles = kLayout == kSplitOut ? (M / 2 + kBM / 2 - 1) / (kBM / 2)
                                           : (M + kBM - 1) / kBM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  auto kernel = mm_kernel<T, TOut, kLayout, kBM>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (e != cudaSuccess) return (int)e;
  // the length of a row of A as stored, in elements (packed: bytes)
  const int a_row = kLayout == kRowMajorA ? K : kLayout == kSplitOut ? M / 2 : M;
  const int a_vec = kLayout == kSplitOut || kLayout == kSplitK ? 16 : S::kVE;
  const bool vec_a = a_row % a_vec == 0 && aligned16(a);
  const bool vec_b = N % S::kVE == 0 && aligned16(b);
  kernel<<<dim3((N + kBN - 1) / kBN, m_tiles), kThreads, S::kSmem, stream>>>(
      a, static_cast<const T*>(b), static_cast<TOut*>(out), M, N, K, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace mm
}  // namespace dmi
