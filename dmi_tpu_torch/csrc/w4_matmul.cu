// Integer matmuls of the batch-last decode loop for Hopper:
//   W4A8  out[n, b] = (sum_k q4[k, n] * hq[k, b]) * s[n] * a[b]
//   W8A8  the same over int8 weights q8[k, n]
//
// Replaces the TPU kernel dmi_tpu/ops/pallas/w4_matmul.py:w4_mm_bl (body
// _kernel).  The template's second instance drops the unpack and serves the
// W8A8 product that dmi_tpu leaves to XLA (dmi_tpu/models/decode.py:461-469).
//
//   packed: qp [K/2, out] uint8, byte (k, n) = row k in the low nibble and
//           row k + K/2 in the high nibble (quant.pack_w4);
//   int8:   q8 [K, out] int8;
//   hq [K, B] int8 (per-token quantized activations), a [B] f32 their
//   scales, s [out] f32 the channel scales; out [out, B] f32 or bf16.
//
// Math, as the Pallas body (w4_matmul.py:64-77): nibbles sign-extended in
// registers, two half products (low nibbles against hq[:K/2], high nibbles
// against hq[K/2:]) accumulated in int32, then (float(acc) * s) * a rounded
// once to the output type.  Integer accumulation is exact in any order, so
// the result equals the plain twin bit for bit.
//
// What bounds it on the H100: at the serving batch (B 128) the w_gu call
// (K 2048, out 16384) reads 16.8 MB of packed weights (~5 us at 3.35 TB/s)
// and does 8.6 G int8 operations.  This first kernel does them with __dp4a
// on the CUDA cores, whose rate (not the stream) bounds it; the int8 tensor
// cores are the next step.  Both operands hold the contraction axis
// outermost, and __dp4a wants four consecutive k in one register, so a block
// transposes 4x4 byte blocks (__byte_perm) as it stages a chunk of weights
// and activations into shared memory as words of four k; the unpack happens
// there too, once per weight byte.  A block owns 32 output channels and 64
// batch columns, a thread 4 x 4 of them; any K/2, out and B are taken (the
// ragged edges are zero-filled or masked).
#include <stdint.h>

#include "common.cuh"

namespace {

using dmi::Num;
using dmi::sext_nibbles;
using dmi::transpose4x4;

constexpr int kThreads = 128;
constexpr int kTileN = 32;    // output channels per block
constexpr int kTileB = 64;    // batch columns per block
constexpr int kChunk4 = 32;   // words of four contraction rows per staged chunk
constexpr int kLdW = kTileN;  // words per row of the staged weights
constexpr int kLdH = kTileB;  // words per row of the staged activations

// Bytes c..c+3 of row r of a row-major byte matrix with `cols` columns, as one
// little-endian word; rows at or past r_end and columns past cols read as 0.
// vec: cols % 4 == 0 and the base is 4-byte aligned.
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ m, int r, int r_end,
                                          int cols, int c, bool vec) {
  if (r >= r_end || c >= cols) return 0u;
  const uint8_t* p = m + (size_t)r * cols + c;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < cols) v |= (uint32_t)__ldg(p + i) << (8 * i);
  return v;
}

template <bool kPacked, typename TOut>
__global__ void __launch_bounds__(kThreads)
    int8_mm_kernel(const uint8_t* __restrict__ wq, const uint8_t* __restrict__ hq,
                   const float* __restrict__ a, const float* __restrict__ s,
                   TOut* __restrict__ out, int K, int N, int B, bool vec_w, bool vec_h) {
  constexpr int kHalves = kPacked ? 2 : 1;
  __shared__ __align__(16) uint32_t w_s[kHalves][kChunk4][kLdW];
  __shared__ __align__(16) uint32_t h_s[kHalves][kChunk4][kLdH];
  const int kh = kPacked ? K / 2 : K;  // rows of wq; rows of one half of hq
  const int n0 = blockIdx.x * kTileN, b0 = blockIdx.y * kTileB;
  const int t = threadIdx.x;
  const int tn = t % (kTileN / 4), tb = t / (kTileN / 4);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kh; k0 += 4 * kChunk4) {
    const int words = min(kChunk4, (kh - k0 + 3) / 4);
    // weights: item = (word row j, group of 4 channels)
    for (int item = t; item < words * (kTileN / 4); item += kThreads) {
      const int j = item / (kTileN / 4), cg = item % (kTileN / 4);
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = load4(wq, k0 + 4 * j + i, kh, N, n0 + 4 * cg, vec_w);
      transpose4x4(r);
      if (kPacked) {
        *reinterpret_cast<uint4*>(&w_s[0][j][4 * cg]) =
            make_uint4(sext_nibbles(r[0]), sext_nibbles(r[1]), sext_nibbles(r[2]),
                       sext_nibbles(r[3]));
        *reinterpret_cast<uint4*>(&w_s[kHalves - 1][j][4 * cg]) =
            make_uint4(sext_nibbles(r[0] >> 4), sext_nibbles(r[1] >> 4),
                       sext_nibbles(r[2] >> 4), sext_nibbles(r[3] >> 4));
      } else {
        *reinterpret_cast<uint4*>(&w_s[0][j][4 * cg]) = make_uint4(r[0], r[1], r[2], r[3]);
      }
    }
    // activations: the same rows of each half of hq
    for (int item = t; item < kHalves * words * (kTileB / 4); item += kThreads) {
      const int half = item / (words * (kTileB / 4));
      const int rest = item % (words * (kTileB / 4));
      const int j = rest / (kTileB / 4), cg = rest % (kTileB / 4);
      const int row = half * kh + k0 + 4 * j;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = load4(hq, row + i, (half + 1) * kh, B, b0 + 4 * cg, vec_h);
      transpose4x4(r);
      *reinterpret_cast<uint4*>(&h_s[half][j][4 * cg]) = make_uint4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
#pragma unroll 4
      for (int j = 0; j < words; ++j) {
        const uint4 w = *reinterpret_cast<const uint4*>(&w_s[half][j][4 * tn]);
        const uint4 h = *reinterpret_cast<const uint4*>(&h_s[half][j][4 * tb]);
        const int wv[4] = {(int)w.x, (int)w.y, (int)w.z, (int)w.w};
        const int hv[4] = {(int)h.x, (int)h.y, (int)h.z, (int)h.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = __dp4a(wv[i], hv[jj], acc[i][jj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * tn + i;
    if (n >= N) continue;
    const float sn = s[n];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + 4 * tb + j;
      if (b < B)
        out[(size_t)n * B + b] =
            Num<TOut>::store(__fmul_rn(__fmul_rn((float)acc[i][j], sn), a[b]));
    }
  }
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

template <bool kPacked, typename TOut>
int launch(const void* wq, const void* hq, const void* a, const void* s, void* out, int K,
           int N, int B, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB);
  int8_mm_kernel<kPacked, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(wq), static_cast<const uint8_t*>(hq),
      static_cast<const float*>(a), static_cast<const float*>(s), static_cast<TOut*>(out), K, N,
      B, N % 4 == 0 && aligned4(wq), B % 4 == 0 && aligned4(hq));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// launch, 0 on success.  All tensors are contiguous.
extern "C" int dmi_w4_mm(const void* wq, const void* hq, const void* a, const void* s, void* out,
                         int K, int N, int B, int packed, int dtype, void* stream) {
  if (K < 1 || N < 1 || B < 1 || (packed && K % 2)) return (int)cudaErrorInvalidValue;
  if ((B + kTileB - 1) / kTileB > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32)
    return packed ? launch<true, float>(wq, hq, a, s, out, K, N, B, st)
                  : launch<false, float>(wq, hq, a, s, out, K, N, B, st);
  if (dtype == dmi::kBFloat16)
    return packed ? launch<true, __nv_bfloat16>(wq, hq, a, s, out, K, N, B, st)
                  : launch<false, __nv_bfloat16>(wq, hq, a, s, out, K, N, B, st);
  return (int)cudaErrorInvalidValue;
}
