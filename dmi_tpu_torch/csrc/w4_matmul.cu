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
//   hq [K, ldh] int8 (per-token quantized activations; the first B columns
//   hold the batch, the wrapper pads ldh to 16), a [B] f32 their scales, s
//   [out] f32 the channel scales; out [out, B] f32 or bf16.
//
// Math, as the Pallas body (w4_matmul.py:64-77): two half products (low
// nibbles against hq[:K/2], high nibbles against hq[K/2:]) accumulated in
// int32, then (float(acc) * s) * a rounded once to the output type.  Integer
// accumulation is exact in any order, so the result equals the plain twin bit
// for bit at every launch plan.
//
// What bounds it on the H100: at the serving batch (B 128) the w_gu call (K
// 2048, out 16384) reads 16.8 MB of packed weights (5 us at 3.35 TB/s) and
// does 8.6 G int8 operations (4.3 us on the int8 tensor cores): both the
// stream and the tensor cores have to be kept busy.  Design:
//   - A block owns 128 output channels, 128 batch columns and one split of
//     the contraction rows.  Warp 0 is the producer: its first lane streams
//     the split's 64-row chunks of the weights and of the matching rows of hq
//     (both halves for W4) through a ring of stages in shared memory as TMA
//     boxes of 128-byte rows, 128-byte swizzled, as they lie in memory (the
//     weight tree's layout is the one the JAX package and the twins share);
//     mbarriers count the bytes.  Eight consumer warps, each 32 channels x 64
//     batch columns, multiply on the int8 tensor cores with
//     mma.sync.m16n8k32.s32.s8.s8, both operands built in registers.
//   - The int8 products take K-major fragments, and both stored operands are
//     N-major.  So a thread reads four rows of one 32-bit column of a staged
//     box and transposes the 4 x 4 bytes (byte permutes), which gives four
//     adjacent channels (or batch columns) four k each.  The channels a thread
//     holds in its two m16 tiles, and the batch columns of its n8 tiles, are
//     assigned so that those four are the ones it needs; the epilogue maps
//     them back.  The k rows a fragment's positions stand for are permuted the
//     same way in both operands (position 4 tig + i of slot s is row 8 i + 2
//     tig + s of a 32-row group), so that the eight lanes of a load read eight
//     different swizzled chunks: no bank conflicts.
//   - W4: a packed word gives both halves' fragments.  (byte << 4) & 0xF0
//     holds the low nibble and byte & 0xF0 the high one as 16 x their signed
//     values, so both multiply as they are and the int32 sum, 16 x the true
//     one, is shifted back once at the end (exact: |sum| < 2^31 up to K 131072).
//   - out 2048 has only 16 channel tiles, so the contraction rows are split
//     over blocks (launch plan: ops/cuda/w4_matmul.py:plan).  Each split
//     writes its int32 partial (fragment order, 16-byte vectors, coalesced);
//     the last block of a tile to arrive (per-call counters, set back to 0 by
//     it) adds them and rescales once.  No float atomics: bit-equal to the
//     twin at every plan.  The tile's sums go out through shared memory, so
//     that each warp's stores cover consecutive columns of one channel.
//   - Shapes TMA cannot take (out not a multiple of 16, a weight base off 16
//     bytes) run a second instance whose producer warp copies the same boxes
//     byte by byte into the same swizzled layout; everything else is shared.
// The first version (__dp4a on the CUDA cores) took 120.3-120.9 us at w_gu.
// This design, measured by chip_smoke.py (device time per call, B 128, bf16
// out, four runs, NVIDIA H100 80GB HBM3, 700.00 W), W4A8: w_gu 24.3-24.4 us
// against 170.1-171.2 us for the unpack + _int_mm + rescale chain, w_qkv
// 15.4-15.8, wo 15.6-16.1, w_down 22.2-22.8 us; W8A8: 16.5-16.8, 15.9-16.4,
// 28.8-29.0, 23.9-24.2 us at w_qkv, wo, w_gu, w_down.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dmi::flash;   // smem_addr, the mbarrier and TMA helpers
using namespace dmi::hopper;  // tensor maps, swz128
using dmi::Num;
using dmi::transpose4x4;

constexpr int kTileM = 128;        // output channels of a block: one 128-byte box row
constexpr int kTileB = 128;        // batch columns of a block
constexpr int kKc = 64;            // weight rows of a stage (packed rows for W4)
constexpr int kBox = kKc * 128;    // one 64-row box of 128-byte rows: 8 KB
constexpr int kConsumers = 256;    // eight consumer warps
constexpr int kThreads = 32 + kConsumers;
constexpr int kMaxStages = 8;
constexpr int kLdc = kTileB + 4;   // int32 words of a staged output row

// kStages stages of (weights, hq rows, and for W4 hq's second half) boxes from
// a 1024-byte aligned base, then the full and empty barriers
template <bool kPacked>
struct Ring {
  static constexpr int kBoxes = kPacked ? 3 : 2;
  static constexpr int kStageBytes = kBoxes * kBox;
  static constexpr int kFit = (kSmemMax - 1024 - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
  static_assert(kStages * kStageBytes >= kTileM * kLdc * 4, "the output tile is staged in the ring");
};

// d (16 x 8 s32) += a (16 x 32 s8, row) * b (32 x 8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's byte offset in a staged box of its slot-sl rows (8 i + 2 tig + sl
// of each 32-row group) at byte column col: the swizzle sees only row % 8 =
// 2 tig + sl, so the rows' offsets differ by constants, 128 (32 j + 8 i)
__device__ __forceinline__ int lane_off(int tig, int sl, int col) {
  const int r = 2 * tig + sl;
  return r * 128 + ((((col >> 4) ^ r) & 7) << 4) + (col & 15);
}

// The words of one slot of a 32-row group j at the lane's offset off,
// transposed: w[c] holds column c's four k, row i in byte i
__device__ __forceinline__ void load_words(uint32_t (&w)[4], const unsigned char* box, int off,
                                           int j) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = *reinterpret_cast<const uint32_t*>(box + off + 128 * (32 * j + 8 * i));
  transpose4x4(w);
}

// acc[mt][nt] += A fragments af (2 m16 tiles) x the B fragments of group j of
// the activation box hb (lane offsets b_off[u][slot]), over the warp's n8
// tiles whose batch columns exist (u < nu)
__device__ __forceinline__ void mma_group(int (&acc)[2][8][4], const uint32_t (&af)[2][4],
                                          const unsigned char* hb, const int (&b_off)[2][2],
                                          int j, int nu) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u >= nu) break;  // n8 tiles 4u .. 4u + 3 hold no batch column
    uint32_t b[2][4];
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) load_words(b[sl], hb, b_off[u][sl], j);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][4 * u + q], af[mt], b[0][q], b[1][q]);
  }
}

__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");
}

// Block (split, channel tile, batch tile): out[n0 .. n0 + 127, b0 .. b0 + 127]
// over weight rows [split * per_split, + per_split) (of each half for W4).
// kTma: the producer's first lane issues TMA boxes; else the producer warp
// copies them.
template <bool kPacked, bool kTma, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    int8_mm_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap h_map, const uint8_t* __restrict__ wq,
                   const uint8_t* __restrict__ hq, const float* __restrict__ a,
                   const float* __restrict__ s, TOut* __restrict__ out, int* __restrict__ partial,
                   int* __restrict__ counters, int K, int N, int B, int ldh, int per_split) {
  using R = Ring<kPacked>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kStages * R::kStageBytes);
  uint64_t* empty = full + R::kStages;
  __shared__ int last;
  if (threadIdx.x == 0)
    for (int st = 0; st < R::kStages; ++st) {
      mbar_init(&full[st], kTma ? 1 : 32);
      mbar_init(&empty[st], kConsumers / 32);
    }
  __syncthreads();

  const int rows = kPacked ? K / 2 : K;  // rows of the weights; of each half of hq
  const int split = blockIdx.x, splits = gridDim.x;
  const int n0 = blockIdx.y * kTileM, b0 = blockIdx.z * kTileB;
  const int k0 = split * per_split, k1 = min(rows, k0 + per_split);
  const int n_chunks = (k1 - k0 + kKc - 1) / kKc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (warp == 0) {  // the producer
    if (kTma && lane != 0) return;
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % R::kStages, row = k0 + c * kKc;
      unsigned char* stage = ring + st * R::kStageBytes;
      mbar_wait(&empty[st], ((c / R::kStages) & 1) ^ 1);  // the first round passes at once
      if constexpr (kTma) {
        mbar_expect_tx(&full[st], R::kStageBytes);
        tma_load_2d(stage, &w_map, n0, row, &full[st]);
        tma_load_2d(stage + kBox, &h_map, b0, row, &full[st]);
        if (kPacked) tma_load_2d(stage + 2 * kBox, &h_map, b0, rows + row, &full[st]);
      } else {
        // the boxes TMA would bring: rows and columns outside the tensors are 0
        for (int e = lane; e < kKc * 128; e += 32) {
          const int r = e / 128, col = e % 128, off = swz128(r, col);
          stage[off] = row + r < rows && n0 + col < N ? wq[(size_t)(row + r) * N + n0 + col] : 0;
          stage[kBox + off] =
              row + r < K && b0 + col < ldh ? hq[(size_t)(row + r) * ldh + b0 + col] : 0;
          if (kPacked)
            stage[2 * kBox + off] = rows + row + r < K && b0 + col < ldh
                                        ? hq[(size_t)(rows + row + r) * ldh + b0 + col]
                                        : 0;
        }
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // consumer warp cw: channels n0 + 32 wm .. + 31, batch columns b0 + 64 wn .. + 63
  const int ct = threadIdx.x - 32, cw = ct / 32, wm = cw & 3, wn = cw >> 2;
  const int g = lane >> 2, tig = lane & 3;
  // the scales of the rows and columns this thread stores in the epilogue
  // (rows cw + 8 i, columns lane + 32 q of the tile), read now so that their
  // latency hides behind the main loop
  float sn[kTileM / 8], ab[kTileB / 32];
#pragma unroll
  for (int i = 0; i < kTileM / 8; ++i) sn[i] = n0 + cw + 8 * i < N ? s[n0 + cw + 8 * i] : 0.f;
#pragma unroll
  for (int q = 0; q < kTileB / 32; ++q) ab[q] = b0 + lane + 32 * q < B ? a[b0 + lane + 32 * q] : 0.f;
  const int bcol0 = 64 * wn;  // the warp's first batch column within the block's tile
  // n8 tile groups (32 batch columns each) that hold batch columns
  const int nu = min(2, max(0, (ldh - b0 - bcol0 + 31) / 32));
  int a_off[2], b_off[2][2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    a_off[sl] = lane_off(tig, sl, 32 * wm + 4 * g);
#pragma unroll
    for (int u = 0; u < 2; ++u) b_off[u][sl] = lane_off(tig, sl, bcol0 + 32 * u + 4 * g);
  }
  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % R::kStages;
    mbar_wait(&full[st], (c / R::kStages) & 1);
    const unsigned char* stage = ring + st * R::kStageBytes;
    if (nu > 0) {
#pragma unroll
      for (int j = 0; j < kKc / 32; ++j) {
        // the A words of channels 32 wm + 4 g + 0..3, each slot's four k
        uint32_t w[2][4];
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) load_words(w[sl], stage, a_off[sl], j);
        // channel 4 g + 2 mt + h is row g + 8 h of m16 tile mt
        uint32_t af[2][4];
        if constexpr (kPacked) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int sl = 0; sl < 2; ++sl)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                af[mt][hh + 2 * sl] = (w[sl][2 * mt + hh] << 4) & 0xF0F0F0F0u;  // low nibbles
          mma_group(acc, af, stage + kBox, b_off, j, nu);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int sl = 0; sl < 2; ++sl)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                af[mt][hh + 2 * sl] = w[sl][2 * mt + hh] & 0xF0F0F0F0u;  // high nibbles
          mma_group(acc, af, stage + 2 * kBox, b_off, j, nu);
        } else {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int sl = 0; sl < 2; ++sl)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) af[mt][hh + 2 * sl] = w[sl][2 * mt + hh];
          mma_group(acc, af, stage + kBox, b_off, j, nu);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the sums as 16 vectors of four batch-adjacent columns: vector (mt, hh, u,
  // cc) holds channel 32 wm + 4 g + 2 mt + hh at batch columns 64 wn + 32 u +
  // 8 tig + 4 cc + (0..3), the C entries e = 2 hh + cc of n8 tiles 4 u + q
  int4 v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int mt = i >> 3, hh = (i >> 2) & 1, u = (i >> 1) & 1, e = 2 * hh + (i & 1);
    v[i] = make_int4(acc[mt][4 * u][e], acc[mt][4 * u + 1][e], acc[mt][4 * u + 2][e],
                     acc[mt][4 * u + 3][e]);
  }
  if (splits > 1) {
    // this split's partial (coalesced: vector i of consumer thread ct at i *
    // kConsumers + ct); the last split of the tile to arrive adds the others'
    // to its own
    const int tile = blockIdx.z * gridDim.y + blockIdx.y;
    int4* parts = reinterpret_cast<int4*>(partial) + (size_t)tile * splits * 16 * kConsumers;
#pragma unroll
    for (int i = 0; i < 16; ++i) __stcg(parts + (split * 16 + i) * kConsumers + ct, v[i]);
    __threadfence();
    consumer_bar();
    if (ct == 0) {
      last = atomicAdd(&counters[tile], 1) == splits - 1;
      if (last) counters[tile] = 0;  // every split has counted: ready for the next call
    }
    consumer_bar();
    if (!last) return;
    __threadfence();
    // two other splits' partials in flight at a time (the sum is exact in
    // any order)
    for (int p = 0; p < splits; p += 2) {
      const bool first = p != split, second = p + 1 < splits && p + 1 != split;
      int4 o[2][16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[0][i] = first ? __ldcg(parts + (p * 16 + i) * kConsumers + ct) : make_int4(0, 0, 0, 0);
        o[1][i] = second ? __ldcg(parts + ((p + 1) * 16 + i) * kConsumers + ct)
                         : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[i].x += o[0][i].x + o[1][i].x, v[i].y += o[0][i].y + o[1][i].y;
        v[i].z += o[0][i].z + o[1][i].z, v[i].w += o[0][i].w + o[1][i].w;
      }
    }
  }

  // the tile's sums through shared memory (the ring, which every consumer
  // warp is done with), then rescaled and stored a row at a time: each
  // warp's stores cover consecutive batch columns of one channel.  Columns
  // of rows 4 .. 7 mod 8 are stored 4 words over (col ^ 4): a quarter-warp's
  // eight 16-byte stores then fall in eight different bank groups.
  consumer_bar();
  int* c_s = reinterpret_cast<int*>(ring);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int mt = i >> 3, hh = (i >> 2) & 1, u = (i >> 1) & 1, cc = i & 1;
    const int r = 32 * wm + 4 * g + 2 * mt + hh, col = bcol0 + 32 * u + 8 * tig + 4 * cc;
    *reinterpret_cast<int4*>(c_s + r * kLdc + (col ^ (r & 4))) = v[i];
  }
  consumer_bar();
  constexpr int kShift = kPacked ? 4 : 0;  // the scaled nibbles' factor 16
#pragma unroll
  for (int i = 0; i < kTileM / 8; ++i) {
    const int r = cw + 8 * i;
#pragma unroll
    for (int q = 0; q < kTileB / 32; ++q) {
      const int bl = lane + 32 * q, b = b0 + bl;
      if (n0 + r < N && b < B)
        out[(size_t)(n0 + r) * B + b] = Num<TOut>::store(
            __fmul_rn(__fmul_rn((float)(c_s[r * kLdc + (bl ^ (r & 4))] >> kShift), sn[i]), ab[q]));
    }
  }
}

// ---- host ----

// The weights' maps (four a layer: a model of up to 64 layers keeps them
// all) and, apart from them, the activations' (a new hq every call)
MapCache<256>& weight_maps() {
  static MapCache<256> cache;
  return cache;
}
MapCache<16>& act_maps() {
  static MapCache<16> cache;
  return cache;
}

// a row-major byte matrix [rows, cols] in boxes of 128 columns x kKc rows
MapShape byte_boxes(uint64_t cols, uint64_t rows) {
  return {CU_TENSOR_MAP_DATA_TYPE_UINT8, cols, rows, cols, 128, kKc, CU_TENSOR_MAP_SWIZZLE_128B};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool kPacked, bool kTma, typename TOut>
int launch(const void* wq, const void* hq, const void* a, const void* s, void* out, void* partial,
           void* counters, int K, int N, int B, int ldh, int splits, int per_split,
           cudaStream_t stream) {
  using R = Ring<kPacked>;
  CUtensorMap w_map = {}, h_map = {};
  if (kTma && (!weight_maps().get(&w_map, wq, byte_boxes(N, kPacked ? K / 2 : K)) ||
               !act_maps().get(&h_map, hq, byte_boxes(ldh, K))))
    return (int)cudaErrorInvalidValue;
  auto kernel = int8_mm_kernel<kPacked, kTma, TOut>;
  // per call: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       R::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(splits, (N + kTileM - 1) / kTileM, (B + kTileB - 1) / kTileB);
  kernel<<<grid, kThreads, R::kSmem, stream>>>(
      w_map, h_map, static_cast<const uint8_t*>(wq), static_cast<const uint8_t*>(hq),
      static_cast<const float*>(a), static_cast<const float*>(s), static_cast<TOut*>(out),
      static_cast<int*>(partial), static_cast<int*>(counters), K, N, B, ldh, per_split);
  return (int)cudaGetLastError();
}

template <bool kPacked, typename TOut>
int launch_any(bool tma, const void* wq, const void* hq, const void* a, const void* s, void* out,
               void* partial, void* counters, int K, int N, int B, int ldh, int splits,
               int per_split, cudaStream_t stream) {
  return tma ? launch<kPacked, true, TOut>(wq, hq, a, s, out, partial, counters, K, N, B, ldh,
                                           splits, per_split, stream)
             : launch<kPacked, false, TOut>(wq, hq, a, s, out, partial, counters, K, N, B, ldh,
                                            splits, per_split, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// launch, 0 on success.  All tensors are contiguous; hq's rows are ldh >= B
// bytes (a multiple of 16, 16-byte aligned).  The launch plan of
// ops/cuda/w4_matmul.py:plan: the weight rows (packed rows for W4) fall into
// `splits` splits of per_split rows (a multiple of 64), none empty; with
// more than one split, partial holds every split's int32 partial of every
// 128 x 128 tile and counters (int32, one per tile, zero before the call and
// after it) order their sum: calls that share counters run on one stream.
// The ring's stages are the kernel's own (Ring::kStages).  TMA takes the weights
// where out is a multiple of 16 and their base 16-byte aligned; otherwise
// the byte-copying instance runs.
extern "C" int dmi_w4_mm(const void* wq, const void* hq, const void* a, const void* s, void* out,
                         void* partial, void* counters, int K, int N, int B, int ldh, int packed,
                         int dtype, int splits, int per_split, void* stream) {
  const int rows = packed ? K / 2 : K;
  if (K < 1 || N < 1 || B < 1 || (packed && (K % 2 || K > 131072)) || ldh < B || ldh % 16 ||
      !aligned16(hq) || splits < 1 || per_split < kKc || per_split % kKc ||
      (long long)splits * per_split < rows || (long long)(splits - 1) * per_split >= rows ||
      (B + kTileB - 1) / kTileB > 65535 || (N + kTileM - 1) / kTileM > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const bool tma = N % 16 == 0 && aligned16(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32)
    return packed ? launch_any<true, float>(tma, wq, hq, a, s, out, partial, counters, K, N, B,
                                            ldh, splits, per_split, st)
                  : launch_any<false, float>(tma, wq, hq, a, s, out, partial, counters, K, N, B,
                                             ldh, splits, per_split, st);
  if (dtype == dmi::kBFloat16)
    return packed ? launch_any<true, __nv_bfloat16>(tma, wq, hq, a, s, out, partial, counters,
                                                    K, N, B, ldh, splits, per_split, st)
                  : launch_any<false, __nv_bfloat16>(tma, wq, hq, a, s, out, partial, counters,
                                                     K, N, B, ldh, splits, per_split, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor maps encoded since the library was loaded (a cache hit encodes
// none): the weights' (acts 0) or the activations' (acts 1)
extern "C" long long dmi_w4_mm_map_encodes(int acts) {
  return acts ? act_maps().encodes : weight_maps().encodes;
}
