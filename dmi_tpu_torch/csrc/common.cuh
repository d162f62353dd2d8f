// Shared device helpers for the hand-written Hopper kernels of dmi_tpu_torch.
//
// Every kernel computes in f32 whatever its storage type: Num<T>::load widens
// a stored element to f32, Num<T>::store rounds an f32 result to T (round to
// nearest even, as torch's own float -> bfloat16 cast does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dmi {

// dtype codes shared with the ctypes wrappers (ops/cuda/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};

// tanh-approximated GELU in f32 (jax.nn.gelu(approximate=True), torch's
// gelu(approximate="tanh"))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// r[i] holds bytes (i, 0..3) of a 4x4 byte block; afterwards r[j] holds bytes
// (0..3, j): the four rows' values of column j, row 0 in the low byte.  It
// turns four rows of int8 into words of four consecutive rows, which is what
// __dp4a contracts.
__device__ __forceinline__ void transpose4x4(unsigned (&r)[4]) {
  const unsigned a = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const unsigned b = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const unsigned c = __byte_perm(r[2], r[3], 0x5140);
  const unsigned d = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(a, c, 0x5410);
  r[1] = __byte_perm(a, c, 0x7632);
  r[2] = __byte_perm(b, d, 0x5410);
  r[3] = __byte_perm(b, d, 0x7632);
}

}  // namespace dmi
