// The gated MLP of one batch-last decode step for Hopper, every weight byte
// read once:
//   g = w_gu[:, :I]^T @ h,  u = w_gu[:, I:]^T @ h      [I, B]
//   out = w_down^T @ (act(g) * u)                      [H, B]
//
// Replaces the TPU kernel dmi_tpu/ops/pallas/decode_mlp.py:_mlp_pallas_bl
// (body _kernel), behind fused_decode_mlp_bl.
//
//   w_gu [H, 2I] (gate | up columns), w_down [I, H], h [H, B], out [H, B]:
//   row-major, one dtype (f32 or bf16); H and I multiples of 8, B of 16 (the
//   wrapper pads the batch), so every 16-byte load is whole and aligned.
//
// Math, as the Pallas body (decode_mlp.py:62-80): g and u accumulate in f32
// and are rounded to the tensors' dtype; act(g) (silu or tanh-GELU, in f32) is
// rounded, and its product with u is rounded; the down product accumulates
// in f32 and is rounded once at the end.
//
// What bounds it on the H100: at the serving shape (H 2048, I 8192, B 128,
// bf16) a call reads 100.7 MB of weights (30 us at 3.35 TB/s) and does 12.9
// GFLOP (13 us on the tensor cores), so the weight stream bounds it and that
// stream has to cover the card.  One TPU core walks the I tiles in order
// with one resident accumulator; here three kernels of one launch sequence:
//   1. gate_up_act: a block owns 64 columns of I (128 blocks): it streams
//      its gate and its up columns of w_gu over all of H in one pass (h is
//      staged once for both) and writes act(g) * u [I, B] (2 MB at B 128,
//      which stays in the L2 cache);
//   2. down_partial: a block owns 64 columns of H and one split of the I
//      axis (32 x 4 blocks): it streams its rows of w_down and writes an f32
//      partial [splits, H, B];
//   3. reduce: the partials are added in split order and rounded once.  No
//      float atomics: the order of the sum, and with it the greedy tokens,
//      is the same in every run.
// Both products run the same tile routine: a 64 x 128 output tile per weight
// column range, the contraction axis staged through a ring of three chunks
// in shared memory, filled by 16-byte cp.async copies that stay in flight
// while the chunk before them is multiplied (one barrier per chunk).  A
// first version staged one chunk at a time through registers and ran gate
// and up as two passes: 212 us at the serving shape, latency bound on one
// chunk in flight per SM (PERF.md).  bf16 tiles multiply on the tensor cores
// (nvcuda::wmma, 16 x 16 x 16, f32 accumulators); f32 tiles with FMAs on
// the CUDA cores, no TF32, so an f32 call agrees with f32 math up to
// summation order.
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dmi::gelu_tanh;
using dmi::Num;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kTileM = 64;    // weight columns (rows of the output) per block
constexpr int kTileN = 128;   // batch columns per block
constexpr int kLdC = kTileN + 4;        // f32 words per row of a staged output tile
constexpr int kStages = 3;              // chunks in the shared-memory ring
constexpr int kWBytes = 64 * 72 * 2;    // one staged weight chunk, the larger of the two types
constexpr int kXBytes = 64 * 136 * 2;   // one staged activation chunk
constexpr int kCBytes = kTileM * kLdC * 4;
// one ring slot: kNW weight chunks, then the activation chunk
__host__ __device__ constexpr int stage_bytes(int nw) { return nw * kWBytes + kXBytes; }
__host__ __device__ constexpr int smem_bytes(int nw) {
  return kStages * stage_bytes(nw) + nw * kCBytes;
}
constexpr int kActSilu = 0, kActGelu = 1;

// Per-type staging constants and one thread's accumulators of kNW 64 x 128
// tiles that share the activations.  step() multiplies one staged chunk: w_s
// (kNW chunks [kChunk][kLdW], kWBytes apart) holds W[k, m], x_s [kChunk][kLdX]
// holds X[k, n]; nb (a multiple of 16) is the tile's valid batch columns.
template <typename T, int kNW>
struct Tile;

template <int kNW>
struct Tile<__nv_bfloat16, kNW> {
  static constexpr int kChunk = 64, kLdW = kTileM + 8, kLdX = kTileN + 8;
  // warp w owns output rows 16 * (w % 4) and the column tiles w / 4 + 2 i
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kNW][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::fill_fragment(c[w][i], 0.f);
  }
  __device__ __forceinline__ void step(const unsigned char* w_s, const __nv_bfloat16* x_s,
                                       int nb) {
    const int warp = threadIdx.x / 32, mt = warp % 4, nh = warp / 4;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      // A[m, k] = w_s[k][m]: column-major with leading dimension kLdW
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[kNW];
#pragma unroll
      for (int w = 0; w < kNW; ++w)
        wmma::load_matrix_sync(
            a[w],
            reinterpret_cast<const __nv_bfloat16*>(w_s + w * kWBytes) + kk * kLdW + mt * 16,
            kLdW);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = nh + 2 * i;
        if (nt * 16 < nb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, x_s + kk * kLdX + nt * 16, kLdX);
#pragma unroll
          for (int w = 0; w < kNW; ++w) wmma::mma_sync(c[w][i], a[w], b, c[w][i]);
        }
      }
    }
  }
  // tile w goes to c_s + w * kTileM * kLdC
  __device__ __forceinline__ void store(float* c_s, int nb) {
    const int warp = threadIdx.x / 32, mt = warp % 4, nh = warp / 4;
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = nh + 2 * i;
        if (nt * 16 < nb)
          wmma::store_matrix_sync(c_s + (w * kTileM + mt * 16) * kLdC + nt * 16, c[w][i], kLdC,
                                  wmma::mem_row_major);
      }
  }
};

template <int kNW>
struct Tile<float, kNW> {
  static constexpr int kChunk = 32, kLdW = kTileM + 4, kLdX = kTileN + 4;
  // thread t owns output rows 4 * (t % 16) .. + 3 and columns 8 * (t / 16) .. + 7
  float acc[kNW][4][8];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[w][i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const unsigned char* w_s, const float* x_s, int nb) {
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
    if (8 * tn >= nb) return;
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(x_s + k * kLdX + 8 * tn);
      const float4 x1 = *reinterpret_cast<const float4*>(x_s + k * kLdX + 8 * tn + 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int w = 0; w < kNW; ++w) {
        const float4 wq = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(w_s + w * kWBytes) + k * kLdW + 4 * tm);
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[w][i][j] = fmaf(wv[i], xv[j], acc[w][i][j]);
      }
    }
  }
  __device__ __forceinline__ void store(float* c_s, int nb) {
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
    if (8 * tn >= nb) return;
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          c_s[(w * kTileM + 4 * tm + i) * kLdC + 8 * tn + j] = acc[w][i][j];
  }
};

// One chunk of every operand from device memory into ring slot `slot`, as
// asynchronous 16-byte copies: 2 per weight range and 4 of the activations
// per thread.  Rows at or past k1, weight columns at or past m_end[w] and
// batch columns at or past nb are zero-filled (nothing is read for them).
template <typename T, int kNW>
__device__ __forceinline__ void stage_async(unsigned char* slot, const T* __restrict__ W,
                                            int ldw, const int (&m0)[kNW],
                                            const int (&m_end)[kNW], const T* __restrict__ X,
                                            int ldx, int nx0, int nb, int kc, int k1) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWv = kTileM / kVec, kXv = kTileN / kVec;  // vectors per staged row
  constexpr int kLdW = Tile<T, kNW>::kLdW, kLdX = Tile<T, kNW>::kLdX;
#pragma unroll
  for (int w = 0; w < kNW; ++w) {
    T* w_s = reinterpret_cast<T*>(slot + w * kWBytes);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int row = v / kWv, col = (v % kWv) * kVec;
      const bool ok = kc + row < k1 && m0[w] + col < m_end[w];
      __pipeline_memcpy_async(w_s + row * kLdW + col,
                              ok ? W + (size_t)(kc + row) * ldw + m0[w] + col : W, 16,
                              ok ? 0 : 16);
    }
  }
  T* x_s = reinterpret_cast<T*>(slot + kNW * kWBytes);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int row = v / kXv, col = (v % kXv) * kVec;
    const bool ok = kc + row < k1 && col < nb;
    __pipeline_memcpy_async(x_s + row * kLdX + col,
                            ok ? X + (size_t)(kc + row) * ldx + nx0 + col : X, 16, ok ? 0 : 16);
  }
}

// For each weight range w < kNW: c_s[w][m][n] = sum over k in [k0, k1) of
// W[k, m0[w] + m] * X[k, nx0 + n] for m < 64 (columns of W at or past
// m_end[w] count as zero) and n < nb, accumulated in f32.  W and X are
// row-major with ldw and ldx elements per row; ring is kStages slots of
// stage_bytes(kNW).  All threads of the block call it; it ends with the tiles
// in shared memory, unsynchronised.
template <typename T, int kNW>
__device__ __forceinline__ void tile_gemm(const T* __restrict__ W, int ldw,
                                          const int (&m0)[kNW], const int (&m_end)[kNW],
                                          const T* __restrict__ X, int ldx, int nx0, int nb,
                                          int k0, int k1, unsigned char* ring, float* c_s) {
  constexpr int kChunk = Tile<T, kNW>::kChunk;
  Tile<T, kNW> tile;
  tile.init();
  const int chunks = (k1 - k0 + kChunk - 1) / kChunk;
  // chunk c lives in slot c % kStages; one commit per chunk, with copies or
  // empty, so that chunk c is always the kStages - 2 newest groups away
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks)
      stage_async<T, kNW>(ring + c * stage_bytes(kNW), W, ldw, m0, m_end, X, ldx, nx0, nb,
                          k0 + c * kChunk, k1);
    __pipeline_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have, and everyone is done with chunk c - 1
    const int next = c + kStages - 1;    // refills the slot of chunk c - 1
    if (next < chunks)
      stage_async<T, kNW>(ring + (next % kStages) * stage_bytes(kNW), W, ldw, m0, m_end, X, ldx,
                          nx0, nb, k0 + next * kChunk, k1);
    __pipeline_commit();
    const unsigned char* slot = ring + (c % kStages) * stage_bytes(kNW);
    tile.step(slot, reinterpret_cast<const T*>(slot + kNW * kWBytes), nb);
  }
  tile.store(c_s, nb);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Num<T>::load(Num<T>::store(v));
}

// act_out[i, b] = act(g[i, b]) * u[i, b] for the block's 64 columns i of I
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gate_up_act_kernel(const T* __restrict__ w_gu, const T* __restrict__ h,
                       T* __restrict__ act_out, int H, int I, int B, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* g_s = reinterpret_cast<float*>(smem + kStages * stage_bytes(2));
  const float* u_s = g_s + kTileM * kLdC;
  const int i0 = blockIdx.x * kTileM, nx0 = blockIdx.y * kTileN;
  const int nb = min(kTileN, B - nx0);
  const int m0[2] = {i0, I + i0}, m_end[2] = {I, 2 * I};  // the gate and the up columns
  tile_gemm<T, 2>(w_gu, 2 * I, m0, m_end, h, B, nx0, nb, 0, H, smem, g_s);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileM * nb; idx += kThreads) {
    const int m = idx / nb, n = idx % nb;
    if (i0 + m >= I) break;
    const float g = round_to<T>(g_s[m * kLdC + n]);
    const float u = round_to<T>(u_s[m * kLdC + n]);
    const float a = round_to<T>(act == kActSilu ? g / (1.0f + expf(-g)) : gelu_tanh(g));
    act_out[(size_t)(i0 + m) * B + nx0 + n] = Num<T>::store(__fmul_rn(a, u));
  }
}

// partial[s, m, b] = sum over the split's rows i of w_down[i, m] * act[i, b]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    down_partial_kernel(const T* __restrict__ w_down, const T* __restrict__ act,
                        float* __restrict__ partial, int I, int H, int B, int per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* c_s = reinterpret_cast<float*>(smem + kStages * stage_bytes(1));
  const int nx0 = blockIdx.y * kTileN;
  const int m0[1] = {(int)blockIdx.x * kTileM}, m_end[1] = {H};
  const int nb = min(kTileN, B - nx0);
  const int k0 = min(I, (int)blockIdx.z * per_split), k1 = min(I, k0 + per_split);
  tile_gemm<T, 1>(w_down, H, m0, m_end, act, B, nx0, nb, k0, k1, smem, c_s);
  __syncthreads();
  float* dst = partial + (size_t)blockIdx.z * H * B;
  for (int idx = threadIdx.x; idx < kTileM * nb; idx += kThreads) {
    const int m = idx / nb, n = idx % nb;
    if (m0[0] + m >= H) break;
    dst[(size_t)(m0[0] + m) * B + nx0 + n] = c_s[m * kLdC + n];
  }
}

// out = the partials added in split order, rounded once
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ partial, T* __restrict__ out, int n,
                              int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = partial[i];
  for (int s = 1; s < splits; ++s) sum += partial[(size_t)s * n + i];
  out[i] = Num<T>::store(sum);
}

template <typename T>
int launch(const void* w_gu, const void* w_down, const void* h, void* act_buf, void* partial,
           void* out, int H, int I, int B, int splits, int act, cudaStream_t stream) {
  const int smem_a = smem_bytes(2), smem_b = smem_bytes(1);
  cudaError_t e = cudaFuncSetAttribute(gate_up_act_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(down_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_b);
  if (e != cudaSuccess) return (int)e;
  const int bt = (B + kTileN - 1) / kTileN;
  // whole chunks per split, so that only the last split is ragged
  const int per_split = ((I + splits - 1) / splits + 63) / 64 * 64;
  gate_up_act_kernel<T><<<dim3((I + kTileM - 1) / kTileM, bt), kThreads, smem_a, stream>>>(
      static_cast<const T*>(w_gu), static_cast<const T*>(h), static_cast<T*>(act_buf), H, I, B,
      act);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  down_partial_kernel<T>
      <<<dim3((H + kTileM - 1) / kTileM, bt, splits), kThreads, smem_b, stream>>>(
          static_cast<const T*>(w_down), static_cast<const T*>(act_buf),
          static_cast<float*>(partial), I, H, B, per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = H * B;
  reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                        static_cast<T*>(out), n, splits);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// first failed launch, 0 on success.  act_buf [I, B] (the tensors' dtype) and
// partial [splits, H, B] (f32) are scratch the caller allocates.
extern "C" int dmi_decode_mlp(const void* w_gu, const void* w_down, const void* h, void* act_buf,
                              void* partial, void* out, int H, int I, int B, int splits, int act,
                              int dtype, void* stream) {
  if (H < 8 || I < 8 || B < 16 || H % 8 || I % 8 || B % 16 || splits < 1 || splits > 64 ||
      (act != kActSilu && act != kActGelu) || (B + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(w_gu) || !aligned16(w_down) || !aligned16(h) || !aligned16(act_buf))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32)
    return launch<float>(w_gu, w_down, h, act_buf, partial, out, H, I, B, splits, act, s);
  if (dtype == dmi::kBFloat16)
    return launch<__nv_bfloat16>(w_gu, w_down, h, act_buf, partial, out, H, I, B, splits, act,
                                 s);
  return (int)cudaErrorInvalidValue;
}
