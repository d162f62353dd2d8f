// Packed-W4 matmul probes for Hopper: out [OUT, B] int32 = W^T h, with W
// [K, OUT] int4 weights stored two to a byte and h [K, B] int8.
//
// Replaces the two TPU kernels of scripts/profile_w4_matmul.py, which ask
// whether streaming the packed nibbles beats streaming int8 weights:
//   split-OUT  dot_w4_pallas :156-170 (body _w4_kernel :145-154): p [K, OUT/2],
//              byte (k, j) = column j (low nibble) and j + OUT/2 (high);
//   split-K    dot_w4_pallas_k :184-197 (body _w4k_kernel :174-182): p [K/2,
//              OUT], byte (k, n) = row k (low) and k + K/2 (high): the layout
//              of quant.pack_w4 and of kernel 7 (w4_matmul.cu), without its
//              rescale.
//
// What bounds it: at the probe's K 2048, OUT 16384, B 256 a call reads 16.8
// MB of packed weights and 0.5 MB of activations and writes 16.8 MB of int32
// (10.2 us at 3.35 TB/s); its 17.2 G int8 operations take 8.7 us at the
// tensor-core peak.  So the bytes bound it, half of them the output, and the
// products have to run near the peak beside them.
//
// The design (warp-specialised, persistent; ops/cuda/w4_probe.py:plan):
//   - A pass writes h^T [B, K] (transpose_s8.cuh, 0.5 MB each way at the
//     probe's shape, counted in the call): s8 wgmma takes K-major operands
//     only.  The matmul is its programmatic dependent; its producer issues
//     the first stages' packed boxes before it waits for the pass.
//   - A block owns 256 output rows x kBN = 128 batch columns (tiles walked
//     u = block, block + blocks, ..., batch fastest, so that the blocks that
//     share a packed box run together and the second finds it in L2).  The
//     producer thread streams stages of 128 packed rows through a ring
//     counted on full / empty mbarriers: the packed box(es), 128 x 128 bytes
//     each, and h^T's box(es), kBN rows x 128 bytes of K, all 128-byte
//     swizzled.  split-OUT: one packed box (128 packed columns) and h^T at
//     k; split-K: two packed boxes (256 columns) and h^T at k and at K/2 + k.
//   - Two consumer warpgroups, 128 output rows x kBN columns each, keep their
//     sums in registers over all of K: two m64n128k32 wgmmas a k step (m64
//     tiles 0 and 1), with A from registers (wgmma_s8_rs_n128) and B = h^T by
//     descriptor.  Thread t of warp w (g = lane / 4, tig = lane % 4) holds
//     rows g and g + 8 of each tile, 4 k of each in a register; it builds
//     them from the swizzled packed box with byte permutes, and the epilogue
//     maps its rows back:
//       split-K: warpgroup v takes box v.  Four words (four rows) of four
//       adjacent packed columns 4 c .. 4 c + 3 (c = 8 w + g), transposed 4 x
//       4, give four columns of four k: column 4 c + 2 i + h is row g + 8 h
//       of tile i.
//       Their low nibbles go against h^T at k, the high ones against h^T at
//       K/2 + k, into the same sums.
//       split-OUT: warpgroup v takes packed columns 64 v .. 64 v + 63 of the
//       box.  Four halfwords of its columns 2 c, 2 c + 1 give the two
//       columns' four k: column 2 c + h is row g + 8 h of tile 0
//       (its low nibbles, output row j) and of tile 1 (its high nibbles, row
//       OUT/2 + j).  Words of four columns, with the warpgroups on the low
//       and the high nibbles of the whole box, took 24.5-24.7 us against
//       22.0-22.3 for these pairs (PERF.md, section 6): both loaded and permuted
//       every byte for one nibble each.
//     Lanes with tig >= 2 read their four rows in the order 2, 3, 0, 1
//     (their last permutes take other selectors), so that the four rows of a
//     load have four different rows mod 8 and the warp's loads hit different
//     swizzled chunks: no bank conflicts, with h^T in its natural K order.
//   - The nibbles: (byte << 4) & 0xF0 holds the low one and byte & 0xF0 the
//     high one, each as 16 x its signed value, so both multiply as they are
//     and the sums are shifted back once at the end (exact: |16 sum| <= 16 *
//     8 * 128 * K < 2^31 for K < 131072; at K 131072 a row of -8 against a
//     column of -128 sums to 2^31, which wraps).
//   - A warpgroup builds a group of four wgmmas' A registers while the group
//     before it is in flight (wgmma_wait1 after each commit); a stage is
//     released when its last group is done.  Two groups a stage: a group's A
//     registers must not be rewritten while its wgmmas may read them, and the
//     stage loop would rewrite a lone group's (a whole stage a group gave
//     wrong sums).  Measured (PERF.md, section 6): split-OUT's word loads in
//     groups of two k steps took 24.87 us against 26.25 for one; split-K's
//     one step (four wgmmas) 21.14 against 21.30 for two.
//   - The epilogue writes each 64 x 32 piece of a warpgroup's sums into one
//     of its two 8 KB buffers (128-byte swizzled) and hands it to a TMA store,
//     which clips the ragged edges.  split-OUT's halves go through two maps
//     of OUT/2 rows each, so that the low half's rows past OUT/2 never reach
//     the high half.  At the probe's shape the 128 tiles are one a block, so
//     the last epilogue (16.8 MB over all blocks) is not hidden; 256 tiles
//     of 64 batch columns hide half of it but build A twice as often a
//     product, and took longer (28.1 against 22.1 us split-OUT, 24.3 against
//     20.4 split-K; PERF.md, section 6).
//
// Shapes TMA cannot take (K off a multiple of 16, or of 32 for split-K, whose
// box of h^T's second half starts K/2 bytes into a row and must start on 16;
// B off 4; split-OUT's OUT off 32 or split-K's off 16; K from 131072; a base
// off 16 bytes): the wmma tile of mm_tile.cuh (kSplitOut / kSplitK at kBM
// 128: each thread unpacks 16 packed bytes into shared memory), which the
// wrapper picks by shape before the launch.  Integer sums are exact in any
// order, so both routes equal the int8 product bit for bit.
#include <stdint.h>

#include "hopper.cuh"
#include "mm_tile.cuh"
#include "transpose_s8.cuh"

namespace {

using namespace dmi::flash;   // smem_addr, the mbarrier and TMA helpers
using namespace dmi::hopper;  // tensor maps, descriptors, wgmma, TMA stores

constexpr int kStageK = 128;        // packed rows a stage
constexpr int kBox = 128 * 128;     // a packed box: 128 rows of 128 packed columns
constexpr int kMaxStages = 8;
constexpr int kThreads = 384;       // the producer warpgroup, two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kOutBox = 64 * 128;   // an epilogue buffer: 64 rows x 32 int32 sums
constexpr int kBN = 128;            // batch columns a block
constexpr uint32_t kNib = 0xF0F0F0F0u;

// the ring of kSplitK's layout (ops/cuda/w4_probe.py:plan)
template <bool kSplitK>
struct Ring {
  static constexpr int kPackedBytes = (kSplitK ? 2 : 1) * kBox;
  static constexpr int kHtBytes = kBN * 128;  // an h^T box: kBN rows x 128 bytes of K
  static constexpr int kStageBytes = kPackedBytes + (kSplitK ? 2 : 1) * kHtBytes;
  static constexpr int kOutBytes = 2 * 2 * kOutBox;  // two buffers a consumer warpgroup
  static constexpr int kFit = (kSmemMax - 1024 - kOutBytes - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kOutBytes + 16 * kStages;
};

// The words of packed rows 4 tig .. 4 tig + 3 at the lane's column (off[q]:
// the lane's offset of row 4 tig + (q ^ (tig & 2))), transposed: w[j] holds
// column 4 c + j's four rows, row 4 tig + i in byte i.  The 4 x 4 byte
// transpose of transpose4x4 (common.cuh), whose last step takes the lane's
// selectors sel: {0x5410, 0x7632}, or {0x1054, 0x3276} where the words came
// in the row order 2, 3, 0, 1, which puts the two halves back in order.
__device__ __forceinline__ void load_words(uint32_t (&w)[4], const unsigned char* rows,
                                           const int (&off)[4], const uint32_t (&sel)[2]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const uint32_t*>(rows + off[q]);
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t c = __byte_perm(w[2], w[3], 0x5140), d = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(a, c, sel[0]);
  w[1] = __byte_perm(a, c, sel[1]);
  w[2] = __byte_perm(b, d, sel[0]);
  w[3] = __byte_perm(b, d, sel[1]);
}

// split-OUT's loads: the halfwords of packed rows 4 tig .. 4 tig + 3 at
// the lane's two columns (off[q]: row 4 tig + (q ^ (tig & 2))), as two
// words c[h]: column h's four rows, row 4 tig + i in byte i.  sel: {0x6420,
// 0x7531}, or {0x2064, 0x3175} where the rows came in the order 2, 3, 0, 1.
__device__ __forceinline__ void load_pairs(uint32_t (&c)[2], const unsigned char* rows,
                                           const int (&off)[4], const uint32_t (&sel)[2]) {
  uint32_t h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = *reinterpret_cast<const uint16_t*>(rows + off[q]);
  const uint32_t x01 = __byte_perm(h[0], h[1], 0x5410), x23 = __byte_perm(h[2], h[3], 0x5410);
  c[0] = __byte_perm(x01, x23, sel[0]);
  c[1] = __byte_perm(x01, x23, sel[1]);
}

// the low and the high nibbles of four bytes, each as 16 x its signed value
__device__ __forceinline__ uint32_t lo16(uint32_t v) { return (v << 4) & kNib; }
__device__ __forceinline__ uint32_t hi16(uint32_t v) { return v & kNib; }

template <bool kSplitK>
__global__ void __launch_bounds__(kThreads, 1)
    w4_wgmma_kernel(const __grid_constant__ CUtensorMap p_map,
                    const __grid_constant__ CUtensorMap ht_map,
                    const __grid_constant__ CUtensorMap out_lo,
                    const __grid_constant__ CUtensorMap out_hi, int OUT, int B, int K) {
  using R = Ring<kSplitK>;
  constexpr int kStages = R::kStages;
  // k steps of 32 packed rows a commit group: four wgmmas a group either way
  // (split-K's step has a low and a high pair); two groups a stage, so that
  // a group's A registers are never the ones of the group still in flight
  constexpr int kSteps = kSplitK ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* out_s = ring + kStages * R::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + R::kOutBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
  __syncthreads();

  // the walk: tile u = (row tile u / n_tiles, batch tile u % n_tiles); a
  // row tile is 128 packed columns (split-OUT) or 256 (split-K)
  const int packed_rows = kSplitK ? K / 2 : K;
  const int m_tiles = kSplitK ? (OUT + 255) / 256 : (OUT / 2 + 127) / 128;
  const int n_tiles = (B + kBN - 1) / kBN;
  const int tiles = m_tiles * n_tiles;
  const int chunks = (packed_rows + kStageK - 1) / kStageK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int total = mine * chunks;
    const CUtensorMap* pm = &p_map;
    const CUtensorMap* hm = &ht_map;
    auto where = [&](int it, int& col0, int& b0, int& k) {
      const int u = blockIdx.x + (it / chunks) * gridDim.x;
      col0 = (u / n_tiles) * (kSplitK ? 256 : 128);
      b0 = (u % n_tiles) * kBN;
      k = (it % chunks) * kStageK;
    };
    auto load_packed = [&](int it) {
      int col0, b0, k;
      where(it, col0, b0, k);
      unsigned char* st = ring + (it % kStages) * R::kStageBytes;
      uint64_t* bar = &full[it % kStages];
      tma_load_2d(st, pm, col0, k, bar);
      if constexpr (kSplitK) tma_load_2d(st + kBox, pm, col0 + 128, k, bar);
    };
    auto load_ht = [&](int it) {
      int col0, b0, k;
      where(it, col0, b0, k);
      unsigned char* st = ring + (it % kStages) * R::kStageBytes + R::kPackedBytes;
      uint64_t* bar = &full[it % kStages];
      tma_load_2d(st, hm, k, b0, bar);
      if constexpr (kSplitK) tma_load_2d(st + R::kHtBytes, hm, K / 2 + k, b0, bar);
    };
    // the first round of stages: the packed boxes need nothing from the pass
    const int pre = total < kStages ? total : kStages;
    for (int it = 0; it < pre; ++it) {
      mbar_expect_tx(&full[it], R::kStageBytes);
      load_packed(it);
    }
    griddep_wait();  // the pass before has written h^T
    for (int it = 0; it < pre; ++it) load_ht(it);
    for (int it = pre; it < total; ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], R::kStageBytes);
      load_packed(it);
      load_ht(it);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int cw = wg - 1, t = threadIdx.x & 127, lane = t & 31, w = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  // The lane's packed columns and the byte permutes that undo its row order
  // (row 4 tig + (q ^ (tig & 2)) in load q).  split-K: columns 4 c .. 4 c + 3
  // (c = 8 w + g) of box cw, the four rows of m64 tiles i = 0, 1 (column 4 c +
  // 2 i + h is row g + 8 h of tile i).  split-OUT: columns 64 cw + 16 w + 2 g
  // + h, row g + 8 h of tile 0 (low nibbles) and of tile 1 (high nibbles).
  int off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    off[q] = swz128(4 * tig + (q ^ (tig & 2)),
                    kSplitK ? 32 * w + 4 * g : 64 * cw + 16 * w + 2 * g);
  const bool x = tig & 2;
  const uint32_t sel[2] = {kSplitK ? (x ? 0x1054u : 0x5410u) : (x ? 0x2064u : 0x6420u),
                           kSplitK ? (x ? 0x3276u : 0x7632u) : (x ? 0x3175u : 0x7531u)};
  const int box = kSplitK ? cw * kBox : 0;
  int acc[2][kBN / 2];
  int it = 0;
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    const int col0 = (u / n_tiles) * (kSplitK ? 256 : 128), b0 = (u % n_tiles) * kBN;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) acc[i][r] = 0;
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* st = ring + s * R::kStageBytes + box;
      const unsigned char* ht = ring + s * R::kStageBytes + R::kPackedBytes;
#pragma unroll
      for (int kg = 0; kg < kStageK / 32; kg += kSteps) {  // kSteps x 32 packed rows a group
        uint32_t a[kSteps][kSplitK ? 4 : 2][4];  // [step][wgmma][register]
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const unsigned char* rows = st + 4096 * (kg + j);  // k 0-15, then 16-31 of the step
          if constexpr (kSplitK) {
            uint32_t w0[4], w1[4];
            load_words(w0, rows, off, sel);
            load_words(w1, rows + 2048, off, sel);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t v[4] = {w0[2 * i], w0[2 * i + 1], w1[2 * i], w1[2 * i + 1]};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                a[j][i][e] = lo16(v[e]);      // tile i against h^T at k
                a[j][2 + i][e] = hi16(v[e]);  // tile i against h^T at K/2 + k
              }
            }
          } else {
            uint32_t c0[2], c1[2];
            load_pairs(c0, rows, off, sel);
            load_pairs(c1, rows + 2048, off, sel);
            const uint32_t v[4] = {c0[0], c0[1], c1[0], c1[1]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a[j][0][e] = lo16(v[e]);
              a[j][1][e] = hi16(v[e]);
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const uint64_t db = smem_desc(ht + 32 * (kg + j), 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) wgmma_s8_rs_n128(acc[i], a[j][i], db);
          if constexpr (kSplitK) {
            const uint64_t dh = smem_desc(ht + R::kHtBytes + 32 * (kg + j), 16);
#pragma unroll
            for (int i = 0; i < 2; ++i) wgmma_s8_rs_n128(acc[i], a[j][2 + i], dh);
          }
        }
        wgmma_commit();
        wgmma_wait1();  // the group before this one is done
        if (kg == 0 && c > 0) release((it - 1) % kStages);
      }
    }
    wgmma_wait0();
    release((it - 1) % kStages);
#pragma unroll
    for (int i = 0; i < 2; ++i) reg_fence(acc[i]);
    // 64 rows x 32 columns a buffer, both filled, then stored.  split-K:
    // buffer h holds the warpgroup's rows 64 h .. (warps 2 h, 2 h + 1);
    // split-OUT: buffer i holds tile i, for the low half's map or the high's
    const int rows = kSplitK ? OUT : OUT / 2;
    const int row0 = col0 + (kSplitK ? 128 * cw : 64 * cw);
#pragma unroll
    for (int j = 0; j < kBN / 32; ++j) {
      if (t == 0) bulk_wait_read<0>();  // the stores before have read both buffers
      named_bar_sync(1 + cw, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 16 * j; r < 16 * j + 16; r += 2) {
          const int h = (r >> 1) & 1;  // row g + 8 h of tile i
          unsigned char* buf = out_s + (2 * cw + (kSplitK ? w >> 1 : i)) * kOutBox;
          const int row = kSplitK ? 32 * (w & 1) + 4 * g + 2 * i + h : 16 * w + 2 * g + h;
          *reinterpret_cast<int2*>(buf + swz128(row, 4 * (frag_col(r, t) - 32 * j))) =
              make_int2(acc[i][r] >> 4, acc[i][r + 1] >> 4);
        }
      fence_proxy_async();  // the writes, visible to the TMA store
      named_bar_sync(1 + cw, 128);
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = kSplitK ? row0 + 64 * h : row0;
          if (row < rows && b0 + 32 * j < B)
            tma_store_2d(h && !kSplitK ? &out_hi : &out_lo, out_s + (2 * cw + h) * kOutBox,
                         b0 + 32 * j, row);
        }
        bulk_commit();
      }
    }
  }
  if (t == 0) bulk_wait_all();  // the buffers are read and the stores done before exit
}

// the operands' maps: new addresses as the caching allocator hands them out
MapCache<32>& maps() {
  static MapCache<32> cache;
  return cache;
}

template <bool kSplitK>
int launch_tma(const void* p, const void* ht, void* out, int OUT, int B, int K, int grid,
               int stages, cudaStream_t stream) {
  using R = Ring<kSplitK>;
  if (stages != R::kStages || grid < 1) return (int)cudaErrorInvalidValue;
  auto kernel = w4_wgmma_kernel<kSplitK>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (e != cudaSuccess) return (int)e;
  const uint64_t o = OUT, b = B, k = K;
  const uint64_t cols = kSplitK ? o : o / 2, rows = kSplitK ? k / 2 : k;
  const uint64_t out_rows = kSplitK ? o : o / 2;
  const MapShape p_shape = {CU_TENSOR_MAP_DATA_TYPE_UINT8, cols, rows, cols, 128, kStageK,
                            CU_TENSOR_MAP_SWIZZLE_128B};
  const MapShape ht_shape = {CU_TENSOR_MAP_DATA_TYPE_UINT8, k, b, k, 128, kBN,
                             CU_TENSOR_MAP_SWIZZLE_128B};
  const MapShape out_shape = {CU_TENSOR_MAP_DATA_TYPE_INT32, b, out_rows, 4 * b, 32, 64,
                              CU_TENSOR_MAP_SWIZZLE_128B};
  // split-OUT's high half starts OUT/2 rows in (16-byte aligned: OUT/2 is a
  // multiple of 16 and B of 4)
  const void* hi = kSplitK ? static_cast<const void*>(out)
                           : static_cast<const void*>(static_cast<char*>(out) + (o / 2) * b * 4);
  CUtensorMap p_map, ht_map, lo_map, hi_map;
  if (!maps().get(&p_map, p, p_shape) || !maps().get(&ht_map, ht, ht_shape) ||
      !maps().get(&lo_map, out, out_shape) || !maps().get(&hi_map, hi, out_shape))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute dependent;  // may set up while the h^T pass finishes
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &dependent;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p_map, ht_map, lo_map, hi_map, OUT, B, K);
}

}  // namespace

using dmi::mm::aligned16;

// Plain C entry point (bound with ctypes).  split_k: p [K/2, OUT], else p
// [K, OUT/2]; h [K, B]; all contiguous.  The launch plan of
// ops/cuda/w4_probe.py:plan: tma 1 takes the h^T pass into ht (B x K bytes of
// scratch) and the wgmma kernel, with `grid` persistent blocks and a ring
// of `stages`; tma 0 takes the wmma tile (ht, grid and stages are not
// read).  Returns the CUDA error code of
// the first failed launch, 0 on success.
extern "C" int dmi_w4_probe(const void* p, const void* h, void* ht, void* out, int OUT, int B,
                            int K, int split_k, int tma, int grid, int stages, void* stream) {
  using namespace dmi::mm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tma)
    return split_k ? launch<signed char, int, kSplitK, 128>(p, h, out, OUT, B, K, st)
                   : launch<signed char, int, kSplitOut, 128>(p, h, out, OUT, B, K, st);
  if (OUT < 1 || B < 1 || K < 1 || K % (split_k ? 32 : 16) || K >= 131072 || B % 4 ||
      OUT % (split_k ? 16 : 32))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(p) || !aligned16(h) || !aligned16(out) || ht == nullptr || !aligned16(ht))
    return (int)cudaErrorMisalignedAddress;
  transpose_s8_kernel<<<dim3((B + 127) / 128, (K + 127) / 128), 256, 0, st>>>(
      static_cast<const uint8_t*>(h), static_cast<uint8_t*>(ht), K, B);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return split_k ? launch_tma<true>(p, ht, out, OUT, B, K, grid, stages, st)
                 : launch_tma<false>(p, ht, out, OUT, B, K, grid, stages, st);
}
