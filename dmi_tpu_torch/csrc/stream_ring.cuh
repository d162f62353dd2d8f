// The weight-streaming ring of TMA boxes and wgmma, shared by the decode
// MLP's bf16 kernels (decode_mlp.cu) and the weight-stream probe
// (stream_mm.cu): a block's output tile is W^T X over its weight columns and
// batch columns, with W [K, cols] and X [K, batch] row-major.
//
// A block's K rows stream through a ring of stages: stage c holds 64 rows of
// the block's kMT weight tiles (64 columns each) and of its kWG x kN batch
// columns of the activations, each a 64 x 64 TMA box of 8 KB that lands
// 128-byte swizzled.  The producer (one thread of warpgroup 0) waits for a
// stage's `empty` barrier, announces its bytes on the `full` barrier and
// issues the boxes; consumer warpgroup w waits for `full`, runs wgmma over
// its kN columns, and releases the stage (lane 0 of each of its warps
// arrives on `empty`).  Both operands are MN-major (their rows are K), which
// wgmma takes for 16-bit types through its transpose bits; with 128-byte
// swizzle a 64-column box is one swizzle atom along MN: 8 K rows of 128
// bytes make 1024 bytes (the stride byte offset between 8-row groups), the
// next 64 columns of a wider operand lie one box (8 KB, the leading byte
// offset) further, and a wgmma's 16 K rows start 2 KB after the previous
// one's.  TMA zero-fills rows and columns outside the tensor, so ragged
// edges multiply zeros.

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace dmi {
namespace ring {

using namespace dmi::flash;   // bf16, smem_addr, the mbarrier and TMA helpers
using namespace dmi::hopper;  // tensor maps, descriptors, wgmma

constexpr int kKc = 64;                          // K rows per ring stage
constexpr int kTileCols = 64;                    // columns of a box: one 128-byte swizzled row
constexpr int kBoxBytes = kKc * kTileCols * 2;   // 8 KB
constexpr int kKStep = 16 * 128;                 // bytes of one wgmma's 16 K rows
constexpr int kMaxStages = 8;

// kStages stages of kMT weight boxes, then kWG x kN / 64 activation boxes,
// from a 1024-byte aligned base, then the full and empty barriers
template <int kMT, int kN, int kWG>
struct Ring {
  static constexpr int kXBoxes = kN / kTileCols;
  static constexpr int kStageBytes = kBoxBytes * (kMT + kWG * kXBoxes);
  static constexpr int kFit = (kSmemMax - 1024 - 2 * kMaxStages * 8) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// The map of a row-major bf16 matrix ([rows, cols], row_bytes apart) in
// boxes of 64 columns x kKc rows, 128-byte swizzled
inline MapShape bf16_boxes(uint64_t cols, uint64_t rows, uint64_t row_bytes) {
  return {CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, rows, row_bytes, kTileCols, kKc,
          CU_TENSOR_MAP_SWIZZLE_128B};
}

template <int kN>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (kN == 128)
    wgmma_bf16_n128<1, 1>(d, da, db);  // both operands MN-major
  else
    wgmma_bf16_n64<1, 1>(d, da, db);
}

// Producer: chunk c (rows k0 + 64 c ..) of the weight boxes at columns
// w_col[t] of wmap and of the kWG x kN activation columns from x_col of xmap
// into stage c % kStages, for c < n_chunks.  One thread calls it.
template <int kMT, int kN, int kWG>
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* wmap, const int (&w_col)[kMT],
                                        const CUtensorMap* xmap, int x_col, int k0,
                                        int n_chunks) {
  using R = Ring<kMT, kN, kWG>;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % R::kStages;
    mbar_wait(&empty[s], ((c / R::kStages) & 1) ^ 1);  // the first round passes at once
    mbar_expect_tx(&full[s], R::kStageBytes);
    unsigned char* st = ring + s * R::kStageBytes;
    const int row = k0 + c * kKc;
#pragma unroll
    for (int t = 0; t < kMT; ++t) tma_load_2d(st + t * kBoxBytes, wmap, w_col[t], row, &full[s]);
#pragma unroll
    for (int j = 0; j < kWG * R::kXBoxes; ++j)
      tma_load_2d(st + (kMT + j) * kBoxBytes, xmap, x_col + j * kTileCols, row, &full[s]);
  }
}

// Consumer warpgroup w (0 .. kWG - 1): acc[t] += its kN batch columns of the
// product with weight tile t, over n_chunks chunks.  All 128 threads of the
// warpgroup call it; lane 0 of each warp releases a stage (the empty
// barriers count 4 kWG arrivals).
template <int kMT, int kN, int kWG>
__device__ __forceinline__ void consume(float (&acc)[kMT][kN / 2], const unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int w, int n_chunks) {
  using R = Ring<kMT, kN, kWG>;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % R::kStages;
    mbar_wait(&full[s], (c / R::kStages) & 1);
    const unsigned char* st = ring + s * R::kStageBytes;
    const unsigned char* xs = st + (kMT + w * R::kXBoxes) * kBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKc / 16; ++kk) {
      const uint64_t db = smem_desc(xs + kk * kKStep, kBoxBytes);
#pragma unroll
      for (int t = 0; t < kMT; ++t)
        wgmma<kN>(acc[t], smem_desc(st + t * kBoxBytes + kk * kKStep, kBoxBytes), db);
    }
    wgmma_commit();
    wgmma_wait0();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
}

// With two consumer warpgroups the producer gives its registers to them
template <int kWG>
__device__ __forceinline__ void regs_producer() {
  if constexpr (kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}
template <int kWG>
__device__ __forceinline__ void regs_consumer() {
  if constexpr (kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

// The ring's barriers, after its stages: full (one arrival and the TMA
// bytes), empty (lane 0 of each consumer warp)
template <int kMT, int kN, int kWG>
__device__ __forceinline__ void init_ring(unsigned char* ring, uint64_t*& full, uint64_t*& empty) {
  using R = Ring<kMT, kN, kWG>;
  full = reinterpret_cast<uint64_t*>(ring + R::kStages * R::kStageBytes);
  empty = full + R::kStages;
  if (threadIdx.x == 0)
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);
    }
  __syncthreads();
}

}  // namespace ring
}  // namespace dmi
