// Fused projector MLP2 for Hopper: out = gelu_tanh(x @ w0 + b0) @ w1 + b1.
//
// Replaces the TPU kernels dmi_tpu/ops/pallas/projector.py:_mlp2_pallas
// (body _mlp2_kernel) and :_mlp2_pallas_tiled (body _mlp2_tiled_kernel), the
// two variants behind fused_mlp2, as one kernel.
//
// Semantics: f32 accumulation; the hidden activation is rounded to the
// weights' dtype before the second product (projector.py:43-46); output in
// the input dtype.  Plain FMA on the CUDA cores, no tensor cores and no TF32,
// so an f32 call agrees with f32 math up to summation order.
//
// What bounds it on the H100: at the serving shapes (B = 64-256 rows,
// mm = 1024, lm = lm2 = 2048, f32) the call is 2*B*(mm*lm + lm*lm2) = 1.6
// GFLOP at B = 128 against 24 MiB of f32 weights, so it is compute bound on
// the CUDA cores and its cost is the f32 FMA rate of the SMs it occupies.
// The TPU plan keeps both weights resident in VMEM; they do not fit the
// 227 KB of shared memory of an SM.  Here one block owns a tile of `tb`
// rows of x: phase 1 computes the tile's whole hidden [tb, lm] into dynamic
// shared memory (16 x 2048 x 4 = 128 KB), phase 2 streams w1 against it, so
// the hidden never goes to device memory.  Threads run over output columns
// (kCols per thread, stride kThreads), so each weight row is read coalesced
// in the (in, out) row-major layout and every loaded weight feeds tb FMAs.
// Simple and right first: one block per row tile fills only B/tb SMs, which
// is the first thing a faster version changes.
#include <stdint.h>

#include "common.cuh"

namespace {

using dmi::Num;

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 4;       // output columns per thread per pass
constexpr int kMaxRows = 16;   // upper bound of tb (rows of x per block)

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// rows x K tile in shared memory (f32, row stride K) times W [K, N].
// kHidden: epilogue gelu(acc + bias) rounded to T, stored f32 into hid_s
// [rows, N]; otherwise acc + bias stored as T into out [rows, N].
template <typename T, bool kHidden>
__device__ __forceinline__ void tile_times_matrix(const float* in_s, int rows, int K,
                                                  const T* __restrict__ W,
                                                  const T* __restrict__ bias, int N,
                                                  float* hid_s, T* __restrict__ out) {
  for (int base = 0; base < N; base += kThreads * kCols) {
    float acc[kMaxRows][kCols];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

    for (int k = 0; k < K; ++k) {
      float w[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = base + j * kThreads + threadIdx.x;
        w[j] = c < N ? Num<T>::load(W[(size_t)k * N + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float xv = in_s[r * K + k];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = base + j * kThreads + threadIdx.x;
          if (c < N) {
            const float v = acc[r][j] + Num<T>::load(bias[c]);
            if (kHidden) {
              hid_s[r * N + c] = Num<T>::load(Num<T>::store(gelu_tanh(v)));
            } else {
              out[(size_t)r * N + c] = Num<T>::store(v);
            }
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp2_kernel(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
                const T* __restrict__ w1, const T* __restrict__ b1, T* __restrict__ out,
                int B, int mm, int lm, int lm2, int tb) {
  extern __shared__ float smem[];
  float* x_s = smem;            // [tb, mm]
  float* h_s = smem + tb * mm;  // [tb, lm]
  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, B - row0);  // the last tile may be ragged

  for (int i = threadIdx.x; i < rows * mm; i += kThreads)
    x_s[i] = Num<T>::load(x[(size_t)row0 * mm + i]);
  __syncthreads();
  tile_times_matrix<T, true>(x_s, rows, mm, w0, b0, lm, h_s, nullptr);
  __syncthreads();
  tile_times_matrix<T, false>(h_s, rows, lm, w1, b1, lm2, nullptr,
                              out + (size_t)row0 * lm2);
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
           void* out, int B, int mm, int lm, int lm2, int tb, cudaStream_t stream) {
  const size_t smem = (size_t)tb * (mm + lm) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mlp2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + tb - 1) / tb);
  mlp2_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(b0),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<T*>(out),
      B, mm, lm, lm2, tb);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// launch, 0 on success.  All tensors are contiguous and of one dtype.
extern "C" int dmi_mlp2(const void* x, const void* w0, const void* b0, const void* w1,
                        const void* b1, void* out, int B, int mm, int lm, int lm2, int tb,
                        int dtype, void* stream) {
  if (tb < 1 || tb > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32) return launch<float>(x, w0, b0, w1, b1, out, B, mm, lm, lm2, tb, s);
  if (dtype == dmi::kBFloat16)
    return launch<__nv_bfloat16>(x, w0, b0, w1, b1, out, B, mm, lm, lm2, tb, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dmi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
