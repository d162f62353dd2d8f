// bt [N, K] = b [K, N]^T for int8, the pass that turns an N-major int8
// operand into the K-major one that wgmma's s8 form takes.  Shared by the
// blocked matmul probe (block_mm.cu: b^T of its int8 call) and the packed-W4
// probes (w4_probe.cu: h^T).  Each caller launches its matmul as a
// programmatic dependent of the pass (hopper.cuh: griddep_*).
#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace {

// 128 x 128 tiles: 16-byte rows of b into shared memory (chunk c of row r at
// chunk c ^ (r / 16 % 8), so that both passes are free of bank conflicts),
// then each thread gathers 4 columns x 16 rows as words, transposes four 4 x
// 4 byte blocks in registers and writes 4 rows of bt, 16 bytes each.  K is a
// multiple of 16; N is any width: rows of b that are whole 16-byte units are
// read 16 bytes at a time, others byte by byte.
__global__ void __launch_bounds__(256) transpose_s8_kernel(const uint8_t* __restrict__ b,
                                                           uint8_t* __restrict__ bt, int K,
                                                           int N) {
  __shared__ uint4 tile[128 * 8];
  dmi::hopper::griddep_launch_dependents();  // the matmul may set up while this pass runs
  const int k0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  if ((N & 15) == 0) {  // rows of b are whole 16-byte units
    for (int i = threadIdx.x; i < 128 * 8; i += 256) {
      const int r = i >> 3, c = i & 7;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < K && n0 + 16 * c < N)
        v = *reinterpret_cast<const uint4*>(b + (size_t)(k0 + r) * N + n0 + 16 * c);
      tile[r * 8 + (c ^ ((r >> 4) & 7))] = v;
    }
  } else {
    for (int i = threadIdx.x; i < 128 * 8; i += 256) {
      const int r = i >> 3, c = i & 7;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (k0 + r < K) {
        const uint8_t* src = b + (size_t)(k0 + r) * N + n0 + 16 * c;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (n0 + 16 * c + e < N) w[e / 4] |= (uint32_t)src[e] << (8 * (e % 4));
      }
      tile[r * 8 + (c ^ ((r >> 4) & 7))] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncthreads();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(tile);
  const int ks = threadIdx.x & 7, n4 = threadIdx.x >> 3;  // 16 rows of K, 4 columns
  uint32_t o[4][4];  // o[j][g]: column 4 n4 + j, rows 16 ks + 4 g .. + 3
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * ks + 4 * g + q;
      r[q] = words[row * 32 + (((n4 >> 2) ^ ks) << 2) + (n4 & 3)];
    }
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
    o[0][g] = __byte_perm(t0, t2, 0x5410);
    o[1][g] = __byte_perm(t0, t2, 0x7632);
    o[2][g] = __byte_perm(t1, t3, 0x5410);
    o[3][g] = __byte_perm(t1, t3, 0x7632);
  }
  if (k0 + 16 * ks >= K) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * n4 + j;
    if (n < N)
      *reinterpret_cast<uint4*>(bt + (size_t)n * K + k0 + 16 * ks) =
          make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
}

}  // namespace
