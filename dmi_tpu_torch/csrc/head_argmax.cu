// Tied vocab-head product fused with the greedy argmax, for Hopper:
//   ids[b] = argmax_v score[v, b],  score = round_bf16(embed[v, :] . h[:, b])
// with the logits never stored.
//
// Replaces the TPU kernel dmi_tpu/ops/pallas/head_argmax.py:_head_argmax_pallas
// (body _kernel), behind head_argmax.
//
//   embed [V, H] row-major, bf16 or int8; scales [V] f32 (int8 modes); h
//   [H, B] row-major, bf16 (int8 in the q8 mode); act_scales [B] f32 (q8);
//   ids [B] int32.  H is a multiple of 16 and B of 16 (the wrapper pads the
//   batch).  part_val/part_idx [blocks, B] are scratch the caller allocates.
//
// Three modes, each with the rounding order of the logits path it replaces
// (head_argmax.py:61-79), so that the compare sees the values that path would:
//   bf16  f32 accumulation, rounded to bf16
//   q     bf16(embed int8) . h accumulated in f32 and rounded to bf16, then
//         times the bf16 scale, rounded to bf16
//   q8    int8 x int8 accumulated in int32, (float(acc) * s) * a rounded to
//         bf16: integer work, equal to the plain twin bit for bit
// Scores are compared as the f32 of their bf16 value; ties go to the smallest
// row (argmax's first occurrence).
//
// What bounds it on the H100: at V 128256, H 2048, B 128 a call reads the
// embed once, 525 MB in bf16 (157 us at 3.35 TB/s) or 263 MB in int8 (78 us),
// and does 67 G operations (68 us on the bf16 tensor cores): the embed stream
// bounds it.  One TPU core walks the vocab blocks in order with a running
// (best, index) pair; here a block owns a slice of 128 vocab rows (1002
// blocks, the last one guarded: V is not padded) and all of a 128-column
// batch tile, forms the slice's scores in shared memory and writes one
// (best score, first index) pair per column; a second kernel merges the
// blocks' pairs by (score descending, index ascending), which does not depend
// on the order blocks ran in.  The bf16 and q modes multiply on the tensor
// cores (nvcuda::wmma, the embed chunk and the h chunk staged through shared
// memory with the next chunk's 16-byte loads in flight); the q8 mode with
// __dp4a on the CUDA cores over words of four k, which first kernel is bound
// by that instruction's rate, not by the stream.
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dmi::transpose4x4;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kTileV = 128;            // vocab rows per block
constexpr int kTileB = 128;            // batch columns per block
constexpr int kChunk = 64;             // contraction elements per staged chunk (wmma modes)
constexpr int kLdE = kChunk + 8;       // bf16 per staged embed row
constexpr int kLdH = kTileB + 8;       // bf16 per staged h row
constexpr int kLdC = kTileB + 4;       // words per row of the staged scores
constexpr int kWords = 32;             // words of four k per staged chunk (q8 mode)
constexpr int kLdE8 = kTileV + 4;      // words per staged embed word row (q8 mode)
constexpr int kLdH8 = kTileB;          // words per staged h word row (q8 mode)
constexpr int kEBytes = kTileV * kLdE * 2;   // 18432 >= kWords * kLdE8 * 4
constexpr int kHBytes = kChunk * kLdH * 2;   // 17408 >= kWords * kLdH8 * 4
constexpr int kCBytes = kTileV * kLdC * 4;
constexpr int kSmemBytes = kEBytes + kHBytes + kCBytes;
constexpr int kModeBf16 = 0, kModeQ = 1, kModeQ8 = 2;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The block's scores c_s [128][kLdC] (f32 sums, or int32 sums in the q8 mode)
// -> one (best score, first row) pair per batch column of the tile.
template <int kMode>
__device__ __forceinline__ void scan_tile(const float* c_s, const float* __restrict__ scales,
                                          const float* __restrict__ act_scales,
                                          float* __restrict__ part_val,
                                          int* __restrict__ part_idx, int V, int B, int v0,
                                          int nx0, int nb) {
  __shared__ float red_val[kThreads];
  __shared__ int red_idx[kThreads];
  const int t = threadIdx.x, col = t % kTileB, half = t / kTileB;
  const int rows = min(kTileV, V - v0);
  float best = -INFINITY;
  int bidx = INT_MAX;
  if (col < nb) {
    const float a = kMode == kModeQ8 ? act_scales[nx0 + col] : 1.0f;
    const int r1 = min(rows, (half + 1) * (kTileV / 2));
    for (int r = half * (kTileV / 2); r < r1; ++r) {
      float val;
      if (kMode == kModeQ8) {
        const int acc = reinterpret_cast<const int*>(c_s)[r * kLdC + col];
        val = round_bf16(__fmul_rn(__fmul_rn((float)acc, scales[v0 + r]), a));
      } else if (kMode == kModeQ) {
        val = round_bf16(__fmul_rn(round_bf16(c_s[r * kLdC + col]), round_bf16(scales[v0 + r])));
      } else {
        val = round_bf16(c_s[r * kLdC + col]);
      }
      if (val > best || bidx == INT_MAX) {  // strict >: the earlier row keeps a tie
        best = val;
        bidx = v0 + r;
      }
    }
  }
  red_val[t] = best;
  red_idx[t] = bidx;
  __syncthreads();
  if (half == 0 && col < nb) {
    const float v1 = red_val[t + kTileB];
    const int i1 = red_idx[t + kTileB];
    if (i1 != INT_MAX && (v1 > best || bidx == INT_MAX)) {
      best = v1;
      bidx = i1;
    }
    part_val[(size_t)blockIdx.x * B + nx0 + col] = best;
    part_idx[(size_t)blockIdx.x * B + nx0 + col] = bidx;
  }
}

// 16 int8 -> 16 bf16 (exact), stored as two 16-byte vectors at dst
__device__ __forceinline__ void store_int8_as_bf16(__nv_bfloat16* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  __align__(16) __nv_bfloat16 tmp[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    tmp[i] = __float2bfloat16((float)(signed char)((w[i / 4] >> (8 * (i % 4))) & 0xFFu));
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(tmp)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(tmp)[1];
}

// bf16 (kQ false: embed bf16) and q (kQ true: embed int8) modes
template <bool kQ>
__global__ void __launch_bounds__(kThreads)
    head_scores_wmma_kernel(const void* __restrict__ embed_v, const float* __restrict__ scales,
                            const __nv_bfloat16* __restrict__ h, float* __restrict__ part_val,
                            int* __restrict__ part_idx, int V, int H, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* e_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + kEBytes);
  float* c_s = reinterpret_cast<float*>(smem + kEBytes + kHBytes);
  const int t = threadIdx.x, warp = t / 32;
  const int v0 = blockIdx.x * kTileV, nx0 = blockIdx.y * kTileB;
  const int nb = min(kTileB, B - nx0);
  constexpr int kEVecs = kQ ? 2 : 4;                // 16-byte loads of the embed per thread
  constexpr int kEPerRow = kChunk / (kQ ? 16 : 8);  // ... per staged embed row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 er[kEVecs], hr[4];

  auto load = [&](int kc) {
#pragma unroll
    for (int i = 0; i < kEVecs; ++i) {
      const int vec = t + i * kThreads;
      const int row = v0 + vec / kEPerRow, k = kc + (vec % kEPerRow) * (kQ ? 16 : 8);
      const char* p = static_cast<const char*>(embed_v) + ((size_t)row * H + k) * (kQ ? 1 : 2);
      er[i] = (row < V && k < H) ? __ldg(reinterpret_cast<const uint4*>(p)) : zero;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int vec = t + i * kThreads;
      const int k = kc + vec / (kTileB / 8), col = (vec % (kTileB / 8)) * 8;
      hr[i] = (k < H && col < nb)
                  ? __ldg(reinterpret_cast<const uint4*>(h + (size_t)k * B + nx0 + col))
                  : zero;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kEVecs; ++i) {
      const int vec = t + i * kThreads;
      __nv_bfloat16* dst = e_s + (vec / kEPerRow) * kLdE + (vec % kEPerRow) * (kQ ? 16 : 8);
      if (kQ)
        store_int8_as_bf16(dst, er[i]);
      else
        *reinterpret_cast<uint4*>(dst) = er[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int vec = t + i * kThreads;
      *reinterpret_cast<uint4*>(h_s + (vec / (kTileB / 8)) * kLdH + (vec % (kTileB / 8)) * 8) =
          hr[i];
    }
  };

  // warp w owns vocab row tiles 2 (w % 4), 2 (w % 4) + 1 and the column tiles w / 4 + 2 i
  const int mt = 2 * (warp % 4), nh = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(c[m][i], 0.f);

  load(0);
  for (int kc = 0; kc < H; kc += kChunk) {
    store();
    __syncthreads();
    if (kc + kChunk < H) load(kc + kChunk);  // in flight while this chunk is multiplied
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wmma::load_matrix_sync(a[m], e_s + (mt + m) * 16 * kLdE + kk, kLdE);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = nh + 2 * i;
        if (nt * 16 < nb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, h_s + kk * kLdH + nt * 16, kLdH);
#pragma unroll
          for (int m = 0; m < 2; ++m) wmma::mma_sync(c[m][i], a[m], b, c[m][i]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = nh + 2 * i;
      if (nt * 16 < nb)
        wmma::store_matrix_sync(c_s + (mt + m) * 16 * kLdC + nt * 16, c[m][i], kLdC,
                                wmma::mem_row_major);
    }
  __syncthreads();
  scan_tile<kQ ? kModeQ : kModeBf16>(c_s, scales, nullptr, part_val, part_idx, V, B, v0, nx0,
                                     nb);
}

// q8 mode: embed int8 [V, H] (k contiguous: its words of four k load as they
// lie), h int8 [H, B] (words of four k through a 4x4 byte transpose)
__global__ void __launch_bounds__(kThreads)
    head_scores_q8_kernel(const int8_t* __restrict__ embed, const float* __restrict__ scales,
                          const int8_t* __restrict__ h, const float* __restrict__ act_scales,
                          float* __restrict__ part_val, int* __restrict__ part_idx, int V, int H,
                          int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* e_s = reinterpret_cast<uint32_t*>(smem);            // [kWords][kLdE8]
  uint32_t* h_s = reinterpret_cast<uint32_t*>(smem + kEBytes);  // [kWords][kLdH8]
  float* c_s = reinterpret_cast<float*>(smem + kEBytes + kHBytes);
  const int t = threadIdx.x;
  const int v0 = blockIdx.x * kTileV, nx0 = blockIdx.y * kTileB;
  const int nb = min(kTileB, B - nx0);
  const int tv = t % 16, tb = t / 16;  // thread: vocab rows 8 tv .. + 7, columns 8 tb .. + 7

  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int kc = 0; kc < H; kc += 4 * kWords) {
    // embed: 128 rows x 128 bytes, 16 bytes (4 words of one row) per load
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int vec = t + i * kThreads;
      const int row = vec / 8, kq = vec % 8, k = kc + 16 * kq;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (v0 + row < V && k < H)
        raw = __ldg(reinterpret_cast<const uint4*>(embed + (size_t)(v0 + row) * H + k));
      e_s[(4 * kq + 0) * kLdE8 + row] = raw.x;
      e_s[(4 * kq + 1) * kLdE8 + row] = raw.y;
      e_s[(4 * kq + 2) * kLdE8 + row] = raw.z;
      e_s[(4 * kq + 3) * kLdE8 + row] = raw.w;
    }
    // h: 128 rows of k x 128 columns, transposed in 4x4 byte blocks
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int item = t + i * kThreads;
      const int j = item / (kTileB / 4), cg = item % (kTileB / 4);
      uint32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = kc + 4 * j + q;
        r[q] = (k < H && 4 * cg < nb)
                   ? __ldg(reinterpret_cast<const uint32_t*>(h + (size_t)k * B + nx0 + 4 * cg))
                   : 0u;
      }
      transpose4x4(r);
      *reinterpret_cast<uint4*>(h_s + j * kLdH8 + 4 * cg) = make_uint4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();
    if (8 * tb < nb) {
#pragma unroll 2
      for (int j = 0; j < kWords; ++j) {
        const uint4 e0 = *reinterpret_cast<const uint4*>(e_s + j * kLdE8 + 8 * tv);
        const uint4 e1 = *reinterpret_cast<const uint4*>(e_s + j * kLdE8 + 8 * tv + 4);
        const uint4 h0 = *reinterpret_cast<const uint4*>(h_s + j * kLdH8 + 8 * tb);
        const uint4 h1 = *reinterpret_cast<const uint4*>(h_s + j * kLdH8 + 8 * tb + 4);
        const int ev[8] = {(int)e0.x, (int)e0.y, (int)e0.z, (int)e0.w,
                           (int)e1.x, (int)e1.y, (int)e1.z, (int)e1.w};
        const int hv[8] = {(int)h0.x, (int)h0.y, (int)h0.z, (int)h0.w,
                           (int)h1.x, (int)h1.y, (int)h1.z, (int)h1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = __dp4a(ev[a], hv[b], acc[a][b]);
      }
    }
    __syncthreads();
  }
  if (8 * tb < nb) {
    int* ci = reinterpret_cast<int*>(c_s);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) ci[(8 * tv + a) * kLdC + 8 * tb + b] = acc[a][b];
  }
  __syncthreads();
  scan_tile<kModeQ8>(c_s, scales, act_scales, part_val, part_idx, V, B, v0, nx0, nb);
}

// ids[b] = the index of the best pair over the blocks: score descending, then
// index ascending
__global__ void merge_kernel(const float* __restrict__ part_val,
                             const int* __restrict__ part_idx, int* __restrict__ ids,
                             int blocks, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float best = part_val[b];
  int bidx = part_idx[b];
  for (int i = 1; i < blocks; ++i) {
    const float v = part_val[(size_t)i * B + b];
    const int idx = part_idx[(size_t)i * B + b];
    if (v > best || (v == best && idx < bidx)) {
      best = v;
      bidx = idx;
    }
  }
  ids[b] = bidx;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// first failed launch, 0 on success.  mode: 0 bf16, 1 q, 2 q8.
extern "C" int dmi_head_argmax(const void* embed, const void* scales, const void* h,
                               const void* act_scales, void* part_val, void* part_idx,
                               void* ids, int V, int H, int B, int mode, void* stream) {
  if (V < 1 || H < 16 || B < 16 || H % 16 || B % 16 || (B + kTileB - 1) / kTileB > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(embed) || !aligned16(h)) return (int)cudaErrorMisalignedAddress;
  if ((mode != kModeBf16 && scales == nullptr) || (mode == kModeQ8 && act_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (V + kTileV - 1) / kTileV;
  const dim3 grid(blocks, (B + kTileB - 1) / kTileB);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_idx);
  const float* sc = static_cast<const float*>(scales);
  cudaError_t e;
  if (mode == kModeBf16) {
    if ((e = allow_smem(head_scores_wmma_kernel<false>)) != cudaSuccess) return (int)e;
    head_scores_wmma_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(
        embed, sc, static_cast<const __nv_bfloat16*>(h), pv, pi, V, H, B);
  } else if (mode == kModeQ) {
    if ((e = allow_smem(head_scores_wmma_kernel<true>)) != cudaSuccess) return (int)e;
    head_scores_wmma_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(
        embed, sc, static_cast<const __nv_bfloat16*>(h), pv, pi, V, H, B);
  } else if (mode == kModeQ8) {
    if ((e = allow_smem(head_scores_q8_kernel)) != cudaSuccess) return (int)e;
    head_scores_q8_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        static_cast<const int8_t*>(embed), sc, static_cast<const int8_t*>(h),
        static_cast<const float*>(act_scales), pv, pi, V, H, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  merge_kernel<<<(B + 127) / 128, 128, 0, st>>>(pv, pi, static_cast<int*>(ids), blocks, B);
  return (int)cudaGetLastError();
}
