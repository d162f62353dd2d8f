// Tied vocab-head product fused with the greedy argmax, for Hopper:
//   ids[b] = argmax_v score[v, b],  score = round_bf16(embed[v, :] . h[:, b])
// with the logits never stored.
//
// Replaces the TPU kernel dmi_tpu/ops/pallas/head_argmax.py:_head_argmax_pallas
// (body _kernel), behind head_argmax.
//
//   embed [V, H] row-major, bf16 or int8; scales [V] f32 (int8 modes); h
//   [H, B] row-major bf16 (bf16 and q modes) or its quantized transpose hq
//   [B, H] int8 (q8 mode); act_scales [B] f32 (q8); ids [B] int32.  H is a
//   multiple of 16 and B of 16 (the wrapper pads the batch); part_val /
//   part_idx [blocks, B] are scratch the caller allocates.
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
// embed once, 525 MB in bf16 (157 us at 3.35 TB/s) or 263 MB in int8 (78.7
// us), and does 67 G operations (68 us on the bf16 tensor cores, 34 us on the
// int8 ones): the embed stream bounds it.  One TPU core walks the vocab blocks
// in order with a running (best, index) pair.  Here:
//   - Persistent blocks, about one an SM (launch plan: ops/cuda/head_argmax.py
//     :plan), each walk a contiguous run of 256-row vocab tiles for one batch
//     tile of 128 columns, keeping a running (best, first index) per column
//     across tiles; a second small kernel merges the blocks' pairs by (score
//     descending, index ascending), which does not depend on the order blocks
//     ran in.
//   - Warp-specialised: warpgroup 0's first thread is the producer, which
//     streams the tiles' K chunks through a ring of stages in shared memory as
//     TMA boxes (mbarriers count their bytes); two consumer warpgroups take
//     128 vocab rows of a tile each, as two wgmma m64n128 products that share
//     the staged h chunk.  So one h chunk (read from L2) meets 256 embed rows
//     and h's traffic is half of the embed's.
//   - The embed is the 64-row side of wgmma (A), K-major as it lies, 128-byte
//     swizzled; the batch is N.  bf16: h [H, B] is N-major, which wgmma takes
//     for 16-bit types through its transpose bit.  q: each consumer widens its
//     rows of the int8 box (exact) into a bf16 K-major tile of its own and
//     multiplies that.  q8: wgmma's s8 form takes K-major operands only, so
//     the wrapper hands over the quantized h transposed, [B, H] (one 256 KB
//     copy at B 128, made where h is quantized anyway), and both operands come
//     by TMA as they lie.
//   - The epilogue works in registers: each accumulator is rounded as the mode
//     says, the tile's best per column is found with warp shuffles over the
//     rows a warp holds and an exchange through shared memory between the
//     eight consumer warps; the logits never reach device memory.  The last
//     tile of a run is rows past V, which TMA reads as zeros: they are masked.
// The first version (nvcuda::wmma in bf16 and q, __dp4a in q8, 1002 blocks
// that each re-read all of h) took 762-770 us in bf16 and 805-836 us in q
// and q8 at the serving shape.  This design, measured by chip_smoke.py
// (device time per call, V 128256, H 2048, B 128, four runs, NVIDIA H100
// 80GB HBM3, 700.00 W): bf16 198.9-208.7 us against 538.0-553.9 us for
// matmul + argmax (bound 157 us), q 179.4-181.3 us, q8 167.7-172.6 us
// (bound 78.7 us).
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace dmi::flash;   // bf16, smem_addr, the mbarrier and TMA helpers
using namespace dmi::hopper;  // tensor maps, descriptors, wgmma

constexpr int kModeBf16 = 0, kModeQ = 1, kModeQ8 = 2;
constexpr int kTileV = 256;      // vocab rows of a tile: two consumer warpgroups of 128
constexpr int kTileB = 128;      // batch columns of a block: the wgmma N
constexpr int kThreads = 384;    // the producer warpgroup, two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kMaxStages = 8;
// the epilogue's exchange, two tiles deep, and the batch tile's activation scales
constexpr int kRedBytes = 2 * 8 * kTileB * 8 + kTileB * 4;

// The ring of one mode: kStages stages, each the embed box (kTileV rows x
// kK contraction elements) and then the h box(es) (kK x kTileB), from a
// 1024-byte aligned base; then (q) each consumer's widened rows; then the
// epilogue's exchange and the full and empty barriers.
template <int kMode>
struct Ring {
  static constexpr int kK = kMode == kModeQ8 ? 128 : 64;  // contraction elements a stage
  static constexpr int kABytes = kTileV * (kMode == kModeQ ? 64 : 128);
  static constexpr int kBBytes = kK * kTileB * (kMode == kModeQ8 ? 1 : 2);
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kCvtBytes = kMode == kModeQ ? 2 * 128 * 128 : 0;
  static constexpr int kFit =
      (kSmemMax - 1024 - kCvtBytes - kRedBytes - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kCvtBytes + kRedBytes + 16 * kStages;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// (v, i) beats (best, bi): a higher score, or the same score at a smaller row
__device__ __forceinline__ bool beats(float v, int i, float best, int bi) {
  return v > best || (v == best && i < bi);
}

// the accumulators of a mode: f32 sums, or int32 sums in the q8 mode
template <int kMode>
using Acc = std::conditional_t<kMode == kModeQ8, int, float>;

// 16 int8 (one 16-byte chunk) -> 16 bf16 (two 16-byte chunks), exact: byte x
// + 128 is the low mantissa byte of 2^23 + x + 128, from which 2^23 + 128 is
// subtracted
__device__ __forceinline__ void widen16(uint4 raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = w[i / 2];
    const int b = 2 * (i % 2);
    const float f0 = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | b)) - 8388736.0f;
    const float f1 =
        __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | (b + 1))) - 8388736.0f;
    out[i] = pack_bf16(f0, f1);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// Consumer warpgroup cw's 128 rows of a q-mode stage (int8, rows of 64 bytes
// as TMA left them, unswizzled) into its own bf16 K-major tile (rows of 64
// elements, 128-byte swizzled).  Four threads a row, 16 bytes each: a
// quarter-warp reads two whole rows and writes eight distinct chunk columns.
__device__ __forceinline__ void widen_rows(const unsigned char* a8, unsigned char* cvt, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int item = j * 128 + t, row = item / 4, c = item % 4;
    const uint4 raw = *reinterpret_cast<const uint4*>(a8 + row * 64 + c * 16);
    uint4 lo, hi;
    widen16(raw, lo, hi);
    *reinterpret_cast<uint4*>(cvt + swz128(row, 32 * c)) = lo;
    *reinterpret_cast<uint4*>(cvt + swz128(row, 32 * c + 16)) = hi;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    head_argmax_kernel(const __grid_constant__ CUtensorMap e_map,
                       const __grid_constant__ CUtensorMap h_map, const float* __restrict__ scales,
                       const float* __restrict__ act_scales, float* __restrict__ part_val,
                       int* __restrict__ part_idx, int V, int H, int B) {
  using R = Ring<kMode>;
  using T = Acc<kMode>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* cvt = ring + R::kStages * R::kStageBytes;
  float* red_val = reinterpret_cast<float*>(cvt + R::kCvtBytes);  // [2][8][kTileB]
  int* red_idx = reinterpret_cast<int*>(red_val + 2 * 8 * kTileB);
  float* act_s = reinterpret_cast<float*>(red_idx + 2 * 8 * kTileB);  // [kTileB]
  uint64_t* full = reinterpret_cast<uint64_t*>(act_s + kTileB);
  uint64_t* empty = full + R::kStages;
  if (threadIdx.x == 0)
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
  __syncthreads();

  // the block's run of vocab tiles and its batch tile
  const int tiles = (V + kTileV - 1) / kTileV;
  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int b0 = blockIdx.y * kTileB;
  const int n_chunks = (H + R::kK - 1) / R::kK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int tile = t0; tile < t1; ++tile)
      for (int c = 0; c < n_chunks; ++c, ++it) {
        const int s = it % R::kStages;
        mbar_wait(&empty[s], ((it / R::kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[s], R::kStageBytes);
        unsigned char* st = ring + s * R::kStageBytes;
        const int k0 = c * R::kK;
        tma_load_2d(st, &e_map, k0, tile * kTileV, &full[s]);
        if (kMode == kModeQ8) {
          tma_load_2d(st + R::kABytes, &h_map, k0, b0, &full[s]);
        } else {
          tma_load_2d(st + R::kABytes, &h_map, b0, k0, &full[s]);
          tma_load_2d(st + R::kABytes + 8192, &h_map, b0 + 64, k0, &full[s]);
        }
      }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int cw = wg - 1, t = threadIdx.x & 127, ct = threadIdx.x - 128;
  const int lane = t & 31, warp = ct >> 5;  // warp 0 .. 7 of the consumers
  // q8: the batch tile's activation scales, in shared memory for the epilogues
  if constexpr (kMode == kModeQ8) {
    if (ct < kTileB) act_s[ct] = b0 + ct < B ? act_scales[b0 + ct] : 1.0f;
    named_bar_sync(3, kConsumers);
  }
  unsigned char* my_cvt = cvt + cw * 128 * 128;
  float run_best = -INFINITY;  // thread ct < kTileB: column b0 + ct's best so far
  int run_idx = INT_MAX;
  int it = 0;
  for (int tile = t0; tile < t1; ++tile) {
    // the scales of the thread's four rows, read now for the tile's epilogue
    const int v0 = tile * kTileV + cw * 128;
    float sc[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = v0 + 64 * m + frag_row(2 * hh, t);
        sc[m][hh] = kMode != kModeBf16 && v < V ? scales[v] : 0.f;
      }
    T acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[m][r] = 0;
    for (int c = 0; c < n_chunks; ++c, ++it) {
      const int s = it % R::kStages;
      mbar_wait(&full[s], (it / R::kStages) & 1);
      const unsigned char* st = ring + s * R::kStageBytes;
      const unsigned char* hs = st + R::kABytes;
      if constexpr (kMode == kModeQ) {
        named_bar_sync(1 + cw, 128);  // the group's wgmma of the last chunk has read my_cvt
        widen_rows(st + cw * 128 * 64, my_cvt, t);
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);
      }
      wgmma_fence();
      if constexpr (kMode == kModeQ8) {
#pragma unroll
        for (int kk = 0; kk < R::kK / 32; ++kk) {
          const uint64_t db = smem_desc(hs + 32 * kk, 16);
#pragma unroll
          for (int m = 0; m < 2; ++m)
            wgmma_s8_n128(acc[m], smem_desc(st + (2 * cw + m) * 64 * 128 + 32 * kk, 16), db);
        }
      } else {
        const unsigned char* as = kMode == kModeQ ? my_cvt : st + cw * 128 * 128;
#pragma unroll
        for (int kk = 0; kk < R::kK / 16; ++kk) {
          const uint64_t db = smem_desc(hs + kk * 16 * 128, 8192);
#pragma unroll
          for (int m = 0; m < 2; ++m)
            wgmma_bf16_n128<0, 1>(acc[m], smem_desc(as + m * 64 * 128 + 32 * kk, 16), db);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the tile's best per column: within the thread (its four rows of a
    // column, ascending), then over the warp's 32 rows, then over the warps
    float* rv = red_val + (tile & 1) * 8 * kTileB + warp * kTileB;
    int* ri = red_idx + (tile & 1) * 8 * kTileB + warp * kTileB;
#pragma unroll
    for (int r8 = 0; r8 < 64; r8 += 4)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = frag_col(r8 + cc, t);
        const float a = kMode == kModeQ8 ? act_s[col] : 1.0f;
        float best = -INFINITY;
        int bi = INT_MAX;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r8 + 2 * hh + cc, v = v0 + 64 * m + frag_row(r, t);
            float val;
            if constexpr (kMode == kModeQ8)
              val = round_bf16(__fmul_rn(__fmul_rn((float)acc[m][r], sc[m][hh]), a));
            else if constexpr (kMode == kModeQ)
              val = round_bf16(__fmul_rn(round_bf16(acc[m][r]), round_bf16(sc[m][hh])));
            else
              val = round_bf16(acc[m][r]);
            if (v < V && (val > best || bi == INT_MAX)) {  // strict >: the earlier row keeps a tie
              best = val;
              bi = v;
            }
          }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (beats(ov, oi, best, bi)) {
            best = ov;
            bi = oi;
          }
        }
        if (lane < 4) {
          rv[col] = best;
          ri[col] = bi;
        }
      }
    named_bar_sync(3, kConsumers);
    if (ct < kTileB) {
      const float* bv = red_val + (tile & 1) * 8 * kTileB;
      const int* bx = red_idx + (tile & 1) * 8 * kTileB;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const float v = bv[w * kTileB + ct];
        const int i = bx[w * kTileB + ct];
        if (beats(v, i, run_best, run_idx)) {
          run_best = v;
          run_idx = i;
        }
      }
    }
  }
  if (ct < kTileB && b0 + ct < B) {
    part_val[(size_t)blockIdx.x * B + b0 + ct] = run_best;
    part_idx[(size_t)blockIdx.x * B + b0 + ct] = run_idx;
  }
}

// ids[b] = the index of the best pair over the blocks: score descending, then
// index ascending; scores[b] (where scores is not null) its score, for the
// merge of a vocab-sharded head's ranks
__global__ void merge_kernel(const float* __restrict__ part_val,
                             const int* __restrict__ part_idx, int* __restrict__ ids,
                             float* __restrict__ scores, int blocks, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float best = part_val[b];
  int bidx = part_idx[b];
  for (int i = 1; i < blocks; ++i) {
    const float v = part_val[(size_t)i * B + b];
    const int idx = part_idx[(size_t)i * B + b];
    if (beats(v, idx, best, bidx)) {
      best = v;
      bidx = idx;
    }
  }
  ids[b] = bidx;
  if (scores != nullptr) scores[b] = best;
}

// ---- host ----

// The embed's maps (one a model: a few models' kept) and, apart from them,
// the activations' (a new h every call)
MapCache<16>& embed_maps() {
  static MapCache<16> cache;
  return cache;
}
MapCache<16>& act_maps() {
  static MapCache<16> cache;
  return cache;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kMode>
int launch(const void* embed, const float* scales, const void* h, const float* act_scales,
           float* part_val, int* part_idx, int* ids, float* scores, int V, int H, int B,
           int blocks, cudaStream_t stream) {
  using R = Ring<kMode>;
  const int batch_tiles = (B + kTileB - 1) / kTileB;
  const int tiles = (V + kTileV - 1) / kTileV;
  if (blocks < 1 || blocks > tiles || batch_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const uint64_t v = V, hh = H, b = B;
  // embed [V, H]: boxes of kTileV rows x one stage's contraction (128 bytes,
  // swizzled for wgmma; q: 64 bytes, unswizzled, widened by the consumers)
  const MapShape e_shape =
      kMode == kModeBf16
          ? MapShape{CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, hh, v, 2 * hh, 64, kTileV,
                     CU_TENSOR_MAP_SWIZZLE_128B}
          : MapShape{CU_TENSOR_MAP_DATA_TYPE_UINT8, hh, v, hh, (uint32_t)R::kK, kTileV,
                     kMode == kModeQ ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B};
  // h [H, B] bf16 in boxes of 64 columns x 64 K rows (N-major), or hq [B, H]
  // int8 in boxes of 128 K x 128 batch rows (K-major)
  const MapShape h_shape =
      kMode == kModeQ8 ? MapShape{CU_TENSOR_MAP_DATA_TYPE_UINT8, hh, b, hh, 128, kTileB,
                                  CU_TENSOR_MAP_SWIZZLE_128B}
                       : MapShape{CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, hh, 2 * b, 64, 64,
                                  CU_TENSOR_MAP_SWIZZLE_128B};
  CUtensorMap e_map, h_map;
  if (!embed_maps().get(&e_map, embed, e_shape) || !act_maps().get(&h_map, h, h_shape))
    return (int)cudaErrorInvalidValue;
  // per call: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(head_argmax_kernel<kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (e != cudaSuccess) return (int)e;
  head_argmax_kernel<kMode><<<dim3(blocks, batch_tiles), kThreads, R::kSmem, stream>>>(
      e_map, h_map, scales, act_scales, part_val, part_idx, V, H, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  merge_kernel<<<(B + 127) / 128, 128, 0, stream>>>(part_val, part_idx, ids, scores, blocks,
                                                    B);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// first failed launch, 0 on success.  mode: 0 bf16, 1 q, 2 q8.  The launch
// plan of ops/cuda/head_argmax.py:plan: `blocks` persistent blocks a batch
// tile (each walks a contiguous run of the 256-row vocab tiles).  The ring's
// stages are the kernel's own (Ring<mode>::kStages).  scores: null, or [B]
// f32 that takes each column's winning (bf16-rounded) score.
extern "C" int dmi_head_argmax(const void* embed, const void* scales, const void* h,
                               const void* act_scales, void* part_val, void* part_idx,
                               void* ids, void* scores, int V, int H, int B, int mode,
                               int blocks, void* stream) {
  if (V < 1 || H < 16 || B < 16 || H % 16 || B % 16) return (int)cudaErrorInvalidValue;
  if (!aligned16(embed) || !aligned16(h)) return (int)cudaErrorMisalignedAddress;
  if ((mode != kModeBf16 && scales == nullptr) || (mode == kModeQ8 && act_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const float* as = static_cast<const float*>(act_scales);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_idx);
  int* out = static_cast<int*>(ids);
  float* best = static_cast<float*>(scores);
  if (mode == kModeBf16)
    return launch<kModeBf16>(embed, sc, h, as, pv, pi, out, best, V, H, B, blocks, st);
  if (mode == kModeQ)
    return launch<kModeQ>(embed, sc, h, as, pv, pi, out, best, V, H, B, blocks, st);
  if (mode == kModeQ8)
    return launch<kModeQ8>(embed, sc, h, as, pv, pi, out, best, V, H, B, blocks, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor maps encoded since the library was loaded (a cache hit encodes
// none): the embeds' (acts 0) or the activations' (acts 1)
extern "C" long long dmi_head_argmax_map_encodes(int acts) {
  return acts ? act_maps().encodes : embed_maps().encodes;
}
