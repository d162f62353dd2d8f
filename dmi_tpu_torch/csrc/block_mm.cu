// Blocked matmul probe for Hopper: out = a @ b, with a [M, K] and b [K, N]
// both int8 (int32 out) or both bf16 (f32 out), on the tensor cores.
//
// Replaces the TPU kernel pallas_mm of scripts/profile_int8_mxu.py:74-85
// (body mm_kernel :71-72), which asks whether int8 operands run at about
// twice the bf16 rate.  On the H100 the dense tensor-core peaks are 1979
// int8 TOP/s and 989 bf16 TFLOP/s, so that is the ratio to look for; the
// kernel runs both types through one routine (mm_tile.cuh: wmma m16n16k16,
// s8 with int32 accumulators, bf16 with f32 ones) so that only the type
// differs.
//
// What bounds it: at the probe's N 4096 a call does 137 G operations (69 us
// at the int8 peak, 139 us at the bf16 one) and moves 101 MB in int8 (30 us
// at 3.35 TB/s), so the operations bound it.  The TPU body takes full-K
// strips (a 256 x 4096 bf16 strip is 2 MB, beyond a block's 227 KB of
// shared memory); here M, N and K are tiled and the sums stay in registers.
// A block owns block_m x 128 outputs (block_m 64, 128 or 256, the script's
// --bm).  wmma is the simple tensor-core path; wgmma and TMA are later work.
#include "mm_tile.cuh"

namespace {

template <typename T, typename TOut>
int launch(const void* a, const void* b, void* out, int M, int N, int K, int block_m,
           cudaStream_t st) {
  using dmi::mm::kRowMajorA;
  if (block_m == 64) return dmi::mm::launch<T, TOut, kRowMajorA, 64>(a, b, out, M, N, K, st);
  if (block_m == 128) return dmi::mm::launch<T, TOut, kRowMajorA, 128>(a, b, out, M, N, K, st);
  if (block_m == 256) return dmi::mm::launch<T, TOut, kRowMajorA, 256>(a, b, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes).  int8: a, b int8 and out int32;
// otherwise a, b bf16 and out f32.  All row-major and contiguous.  Returns
// the CUDA error code of the launch, 0 on success.
extern "C" int dmi_block_mm(const void* a, const void* b, void* out, int M, int N, int K,
                            int block_m, int int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int8 ? launch<signed char, int>(a, b, out, M, N, K, block_m, st)
              : launch<__nv_bfloat16, float>(a, b, out, M, N, K, block_m, st);
}
