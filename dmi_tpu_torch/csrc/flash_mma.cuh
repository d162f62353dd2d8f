// Tensor-core fragment routines of the bf16 flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): ldmatrix, mma.sync m16n8k16 with
// f32 accumulators, exp2 on the SFU, bf16 packing and the cp.async tile
// stager, which decode attention's tensor-core kernel (decode_attn.cu) uses
// too; and the TMA and mbarrier helpers, with the driver's tensor-map
// encoder, that the flash backward shares with the decode MLP
// (decode_mlp.cu).
//
// Fragments of mma.sync.m16n8k16 (g = lane / 4, tig = lane % 4):
//   A, 16 x 16 row-major: a[0] (row g, cols 2 tig, +1), a[1] (row g + 8,
//     the same cols), a[2] (row g, cols 8 + 2 tig, +1), a[3] (row g + 8,
//     cols 8 + 2 tig, +1);
//   B, 16 x 8: b0 (k rows 2 tig, +1 of col g), b1 (k rows 8 + 2 tig, +1);
//   C, 16 x 8 f32: c[0], c[1] (row g, cols 2 tig, +1), c[2], c[3] (row g + 8).
// So the C tiles 2 kk and 2 kk + 1 of a product, packed to bf16 pairs,
// are the A fragment of its next product over k = 16 kk..16 kk + 15.
// Row-major tiles [rows][kLd] in shared memory, kLd = 16 kD + 8 elements:
// ldsm_x4 of rows gives A fragments (rows as M) and B fragments (rows as
// N, so B = rows^T); ldsm_x4_trans of rows gives B fragments with rows as
// K.  The pitch of 16 kD + 8 keeps all of them free of bank conflicts.
#pragma once

#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmi {
namespace flash {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx: ~2^-22 relative error, far inside the bf16
// rounding of p; results below 2^-126 flush to 0, exp2(-inf) = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 rows x 16 k) of the C tiles c0 (k 0-7) and c1 (k
// 8-15), rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane offsets (in elements) from the corner of a 16 x 16 block of a
// row-major tile: a_off for ldsm_x4 as an A fragment (rows as M) and for
// ldsm_x4_trans as two B fragments (rows as K: n-tile 0 = cols 0-7 in r[0],
// r[1], n-tile 1 = cols 8-15 in r[2], r[3]); b_off for ldsm_x4 as two B
// fragments (rows as N: n-tile 0 = rows 0-7 in r[0], r[1], n-tile 1 in
// r[2], r[3])
template <int kLd>
__device__ __forceinline__ int a_off(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
}

template <int kLd>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
}

// ---- TMA: 2-D tiles copied by the Tensor Memory Accelerator ----
//
// One thread asks for a whole box of a tensor (described by a CUtensorMap
// made on the host) to be copied into shared memory; the hardware zero-fills
// what lies outside the tensor and reports the bytes to an mbarrier in
// shared memory, on which the consumers wait for the barrier's phase.  With
// CU_TENSOR_MAP_SWIZZLE_128B a box of 128-byte rows lands at a 1024-byte
// aligned address with 16-byte chunk c of row r stored at chunk c ^ (r % 8):
// swz_off gives that element offset, so that ldmatrix's eight row addresses
// fall in eight different bank groups.
__device__ __forceinline__ int swz_off(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // visible to TMA
}

// one arrival that also expects `bytes` of TMA copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one plain arrival (a consumer releasing a stage)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The driver's tensor-map encoder (cuTensorMapEncodeTiled), looked up once
// per process; nullptr where the driver has none.  Host code: a kernel's
// maps are encoded before its launch and passed as __grid_constant__.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn) : nullptr;
  }();
  return encode;
}

// the box of `map` at coordinates (c0, c1), innermost first
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the box of `map` at coordinates (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int c0, int c1, int c2,
                                           int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + kRows) of one head into dst [kRows][kD * 16 + 8] as
// bf16, by threads tid0 + i * n_threads; rows at or past n_rows and columns
// at or past hd are zeros.  vec: hd is a multiple of 8 and every row 16-byte
// aligned, so one cp.async per 8 elements; else element by element.
template <int kD, int kRows>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* head, long long row_stride,
                                           int row0, int n_rows, int hd, bool vec, int tid0,
                                           int n_threads) {
  constexpr int kLd = kD * 16 + 8, kVPR = kD * 2;
  for (int v = tid0; v < kRows * kVPR; v += n_threads) {
    const int r = v / kVPR, c = (v % kVPR) * 8;
    const int row = row0 + r;
    bf16* d = dst + r * kLd + c;
    if (vec) {
      const bool ok = row < n_rows && c < hd;
      __pipeline_memcpy_async(d, ok ? head + row * row_stride + c : head, 16, ok ? 0 : 16);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = (row < n_rows && c + i < hd) ? head[row * row_stride + c + i]
                                            : __float2bfloat16(0.f);
    }
  }
}

}  // namespace flash
}  // namespace dmi
