// Fused projector MLP2 for Hopper: out = gelu_tanh(x @ w0 + b0) @ w1 + b1.
//
// Replaces the TPU kernels dmi_tpu/ops/pallas/projector.py:_mlp2_pallas
// (body _mlp2_kernel) and :_mlp2_pallas_tiled (body _mlp2_tiled_kernel), the
// two variants behind fused_mlp2, as one pair of passes.
//
// Semantics: f32 accumulation; the hidden activation is rounded to the
// weights' dtype before the second product (projector.py:43-46); output in
// the input dtype.  Plain FMA on the CUDA cores, no tensor cores and no TF32,
// so an f32 call agrees with f32 math up to summation order.
//
// What bounds it on the H100: at the serving shapes (B = 64-256 rows,
// mm = 1024, lm = lm2 = 2048, f32) the call is 2*B*(mm*lm + lm*lm2) = 1.6
// GFLOP at B = 128 against 24 MiB of f32 weights: compute bound on the CUDA
// cores, 24 us at their 67 TFLOP/s (NVIDIA's data sheet), so its cost is the
// FMA rate of the SMs it keeps busy.  The TPU plan keeps both weights
// resident in VMEM; they do not fit the 227 KB of an SM.
//
// Design: two passes, each a register-tiled product over many blocks.
// Pass 1 writes H = round(gelu(x w0 + b0)) as f32 into a [B, lm] scratch
// buffer (1 MB at B = 128, which stays in the 50 MB L2); pass 2 computes
// H w1 + b1.  Two launches on one stream order them.  A block owns a
// kBM x 64 output tile (kBM = 8 * kTM, kTM rows per thread: 2, 4 or 8,
// chosen by ops/cuda/projector.py:mlp2_plan so that B 64-256 put at least
// 128 blocks on the 132 SMs).  Its 512 threads are kSplit = 4 groups of
// 128 that split each K chunk of 128 between them (32 each), so one block
// keeps 16 warps on its SM; each thread keeps a kTM x 4 tile of f32 sums
// in registers and reads four K values of each of its rows and four
// columns of w per 16-byte (f32) or 8-byte (bf16) shared-memory load.  K
// chunks go through a ring of three stages filled by 16-byte cp.async
// copies along the contiguous dimension (x's K, w's output columns), in
// flight while the chunk before them is multiplied.  At the end groups
// 1-3 hand their sums to group 0 through shared memory, which adds them in
// a fixed order (0, 1, 2, 3), then the bias and the epilogue.  Widths that
// are no whole vector, or misaligned tensors, are staged element by
// element; rows and columns past the matrices are zeros.  The shape of
// the groups, the chunk and the ring was chosen on the card among 2 or 4
// groups, chunks of 32-128 and rings of 2-6 (PERF.md).
#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dmi::gelu_tanh;
using dmi::Num;

constexpr int kSplit = 4;                 // parts of each K chunk, one per group
constexpr int kGroup = 128;               // threads of a group: 8 row x 16 column slots
constexpr int kThreads = kSplit * kGroup;
constexpr int kBN = 64;                   // output columns per block: 16 threads x 4
constexpr int kBK = 128;                  // K per staged chunk
constexpr int kPart = kBK / kSplit;       // K of a chunk per group
constexpr int kStages = 3;
static_assert(kPart % 4 == 0, "a group reads K four at a time");

// four consecutive elements widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Shared-memory layout of one pass: a ring of kStages chunks, each the A
// tile [kBM][kBK] (a pitch one vector wider, rows stay 16-byte aligned)
// and the w tile [kBK][kBN]; after the K loop the same bytes hold the
// sums of groups 1.. for group 0.  ops/cuda/projector.py:mlp2_plan mirrors kSmem.
template <typename TA, typename TW, int kBM>
struct Tiles {
  static constexpr int kLdA = kBK + 16 / (int)sizeof(TA);
  static constexpr int kABytes = kBM * kLdA * (int)sizeof(TA);
  static constexpr int kStageBytes = kABytes + kBK * kBN * (int)sizeof(TW);
  static constexpr int kRedBytes = (kSplit - 1) * kGroup * (kBM / 8) * 4 * (int)sizeof(float);
  static constexpr int kSmem =
      kStages * kStageBytes > kRedBytes ? kStages * kStageBytes : kRedBytes;
};

// Rows [r0, r0 + kRows) by columns [c0, c0 + kCols) of the row-major src
// (ld elements per row, n_rows x n_cols) into dst (kLd per row), zeros past
// the matrix.  vec: n_cols is a multiple of the 16-byte vector and src is
// 16-byte aligned, so one cp.async per vector.
template <typename T, int kRows, int kCols, int kLd>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int ld, int r0,
                                           int n_rows, int c0, int n_cols, bool vec) {
  constexpr int kVE = 16 / sizeof(T), kVPR = kCols / kVE;
  for (int v = threadIdx.x; v < kRows * kVPR; v += kThreads) {
    const int r = v / kVPR, c = (v % kVPR) * kVE;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * kLd + c;
    if (vec) {
      const bool ok = gr < n_rows && gc < n_cols;
      __pipeline_memcpy_async(d, ok ? src + (size_t)gr * ld + gc : src, 16, ok ? 0 : 16);
    } else {
#pragma unroll
      for (int i = 0; i < kVE; ++i)
        d[i] = (gr < n_rows && gc + i < n_cols) ? src[(size_t)gr * ld + gc + i]
                                                : Num<T>::store(0.f);
    }
  }
}

// out [M, N] = epilogue(a [M, K] @ w [K, N] + bias).  kHidden: out is the f32
// scratch H, gelu of the sum rounded to TW; else out is TW.
template <typename TA, typename TW, bool kHidden, int kTM>
__global__ void __launch_bounds__(kThreads)
    mlp2_pass(const TA* __restrict__ a, const TW* __restrict__ w, const TW* __restrict__ bias,
              void* __restrict__ out, int M, int N, int K, bool vec_a, bool vec_w) {
  constexpr int kBM = 8 * kTM;
  using L = Tiles<TA, TW, kBM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int part = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int tx = t % 16, ty = t / 16;  // columns tx * 4.., rows ty * kTM..
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int chunks = (K + kBK - 1) / kBK;

  auto stage = [&](int c) {
    unsigned char* slot = smem + (c % kStages) * L::kStageBytes;
    stage_tile<TA, kBM, kBK, L::kLdA>(reinterpret_cast<TA*>(slot), a, K, m0, M, c * kBK, K,
                                      vec_a);
    stage_tile<TW, kBK, kBN, kBN>(reinterpret_cast<TW*>(slot + L::kABytes), w, N, c * kBK, K,
                                  n0, N, vec_w);
  };

  float acc[kTM][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage(s);
    __pipeline_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of chunk c have landed
    __syncthreads();                     // everyone's have, and chunk c - 1 is consumed
    if (c + kStages - 1 < chunks) stage(c + kStages - 1);
    __pipeline_commit();
    const unsigned char* slot = smem + (c % kStages) * L::kStageBytes;
    const TA* as = reinterpret_cast<const TA*>(slot) + ty * kTM * L::kLdA + part * kPart;
    const TW* ws = reinterpret_cast<const TW*>(slot + L::kABytes) + part * kPart * kBN + tx * 4;
#pragma unroll
    for (int kq = 0; kq < kPart; kq += 4) {
      float4 av[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = load4(as + i * L::kLdA + kq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv = load4(ws + (kq + j) * kBN);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float xv = lane4(av[i], j);
          acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
        }
      }
    }
  }

  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is consumed: its bytes take the other groups' sums
  float* red = reinterpret_cast<float*>(smem);
  if (part > 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[((part - 1) * kTM * 4 + i * 4 + j) * kGroup + t] = acc[i][j];
  }
  __syncthreads();
  if (part > 0) return;
#pragma unroll
  for (int q = 1; q < kSplit; ++q)  // a fixed order: group 0, then 1, 2, ..
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += red[((q - 1) * kTM * 4 + i * 4 + j) * kGroup + t];

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty * kTM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      const float v = acc[i][j] + Num<TW>::load(bias[col]);
      if (kHidden) {
        static_cast<float*>(out)[(size_t)r * N + col] =
            Num<TW>::load(Num<TW>::store(gelu_tanh(v)));
      } else {
        static_cast<TW*>(out)[(size_t)r * N + col] = Num<TW>::store(v);
      }
    }
  }
}

template <typename T>
bool vectors(const T* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && n % (16 / (int)sizeof(T)) == 0;
}

template <typename TA, typename TW, bool kHidden, int kTM>
cudaError_t launch_pass(const TA* a, const TW* w, const TW* bias, void* out, int M, int N,
                        int K, cudaStream_t stream) {
  using L = Tiles<TA, TW, 8 * kTM>;
  auto kernel = mlp2_pass<TA, TW, kHidden, kTM>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + 8 * kTM - 1) / (8 * kTM));
  kernel<<<grid, kThreads, L::kSmem, stream>>>(a, w, bias, out, M, N, K, vectors(a, K),
                                               vectors(w, N));
  return cudaGetLastError();
}

template <typename TA, typename TW, bool kHidden>
cudaError_t pass(int tm, const TA* a, const TW* w, const TW* bias, void* out, int M, int N,
                 int K, cudaStream_t s) {
  switch (tm) {
    case 2: return launch_pass<TA, TW, kHidden, 2>(a, w, bias, out, M, N, K, s);
    case 4: return launch_pass<TA, TW, kHidden, 4>(a, w, bias, out, M, N, K, s);
    case 8: return launch_pass<TA, TW, kHidden, 8>(a, w, bias, out, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
           void* out, float* hidden, int B, int mm, int lm, int lm2, int tm1, int tm2,
           cudaStream_t s) {
  cudaError_t e = pass<T, T, true>(tm1, static_cast<const T*>(x), static_cast<const T*>(w0),
                                   static_cast<const T*>(b0), hidden, B, lm, mm, s);
  if (e != cudaSuccess) return (int)e;
  return (int)pass<float, T, false>(tm2, hidden, static_cast<const T*>(w1),
                                    static_cast<const T*>(b1), out, B, lm2, lm, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  hidden is the f32 scratch
// [B, lm]; tm1 and tm2 are the rows per thread of the two passes
// (mlp2_plan).  Returns the CUDA error code of the launches, 0 on success.
// x, the weights and out are contiguous and of one dtype.
extern "C" int dmi_mlp2(const void* x, const void* w0, const void* b0, const void* w1,
                        const void* b1, void* out, float* hidden, int B, int mm, int lm, int lm2,
                        int tm1, int tm2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32)
    return launch<float>(x, w0, b0, w1, b1, out, hidden, B, mm, lm, lm2, tm1, tm2, s);
  if (dtype == dmi::kBFloat16)
    return launch<__nv_bfloat16>(x, w0, b0, w1, b1, out, hidden, B, mm, lm, lm2, tm1, tm2, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dmi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
