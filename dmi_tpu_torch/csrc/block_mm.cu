// Blocked matmul probe for Hopper: out = a @ b, with a [M, K] and b [K, N]
// both int8 (int32 out) or both bf16 (f32 out), on the tensor cores.
//
// Replaces the TPU kernel pallas_mm of scripts/profile_int8_mxu.py:74-85
// (body mm_kernel :71-72), which asks whether int8 operands run at about
// twice the bf16 rate.  On the H100 the dense tensor-core peaks are 1979
// int8 TOP/s and 989 bf16 TFLOP/s, so that is the ratio to look for; both
// types run one kernel, so that only the type differs.
//
// What bounds it: at the probe's N 4096 a call does 137 G operations (69 us
// at the int8 peak, 139 us at the bf16 one) and moves 101 MB in int8 (30 us
// at 3.35 TB/s), so the operations bound it; the 67.1 MB output alone takes
// 20 us to write, so the epilogue has to overlap the products.
//
// The design (warp-specialised, persistent):
//   - One block an SM (grid: the plan's, ops/cuda/block_mm.py:plan) walks
//     the output tiles u = block, block + blocks, ... (rows fastest);
//     warpgroup 0's first thread is the producer, warpgroups 1 and 2
//     multiply.
//   - K streams through a ring of stages of 128 bytes of K (64 bf16 or 128
//     int8 values): a's rows as a K-major TMA box, b's as boxes that land
//     128-byte swizzled, counted on full / empty mbarriers.  The producer
//     runs ahead across tiles, so one tile's epilogue overlaps the next
//     tile's loads.
//   - Consumers run wgmma (bf16: m64nNk16 into f32; int8: m64nNk32 into s32)
//     with the sums in registers over all of K, one stage's products in
//     flight while the next stage is awaited.  The epilogue writes each 64 x
//     32 piece of a warpgroup's sums into one of its two 8 KB buffers in
//     shared memory (128-byte swizzled) and hands it to a TMA store, which
//     clips the ragged edges: the warpgroup goes back to its products while
//     the stores drain.  Stores straight from registers stalled the
//     consumers until the 128 KB of a tile had drained, about 20 us a call
//     at N 4096 (the output's own write time).
//   - block_m picks the tile: 64 -> 64 x 256 (the two warpgroups take 128
//     columns each, m64n128), 128 -> 128 x 256 (64 rows each, m64n256), 256
//     -> 256 x 128 (128 rows each, two m64n128).  Every instance keeps at
//     most 128 accumulators a thread; the producer hands its registers to
//     the consumers (setmaxnreg).
//   - What holds it (PERF.md, section 6): a 128 x 256 stage of 64 bf16 (128
//     int8) of K is 1024 clocks of products and 128 KB of shared-memory
//     traffic (48 KB landing, 80 KB read by wgmma), about the SM's 128
//     bytes a clock; at N 4096 the products run at ~790 TFLOP/s (H100
//     80GB HBM3 at 700 W), the rest is the tail of 512 tiles on 132 SMs.  Clusters of two that multicast
//     b's boxes were within 2% (dropped).
//   - bf16 takes both operands as they lie: a K-major, b [K, N] MN-major
//     through the transpose bit.  wgmma's s8 form takes K-major operands
//     only, and b is N-major: an int8 call first runs transpose_s8_kernel,
//     which writes b^T [N, K] (16.8 MB each way at N = K 4096, its time
//     counted in the call's), and the matmul is a programmatic dependent of
//     it.  A register-fed A operand (out^T = b^T a^T) or a transpose in
//     shared memory would spend the producer's issue slots or shared-memory
//     bandwidth on every stage of every tile; the pass spends them once.
//
// Shapes TMA cannot take (bf16: K or N off a multiple of 8; int8: off a
// multiple of 16; an operand off 16 bytes): the wmma instance of
// mm_tile.cuh (kRowMajorA, 128 x 128 tiles), which the wrapper picks by
// shape before launching.
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mm_tile.cuh"
#include "transpose_s8.cuh"  // transpose_s8_kernel: the int8 call's b^T pass

namespace {

using namespace dmi::flash;   // bf16, smem_addr, the mbarrier and TMA helpers
using namespace dmi::hopper;  // tensor maps, descriptors, wgmma, TMA stores

constexpr int kStageK = 128;  // bytes of K a stage: one 128-byte swizzled row
constexpr int kMaxStages = 8;
constexpr int kThreads = 384;  // the producer warpgroup, two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kOutBox = 64 * 128;  // an epilogue buffer: 64 rows x 32 four-byte sums

// block_m's tile: kWM consumer warpgroups along M (the others along N), each
// kMT m64 tiles by kN columns (ops/cuda/block_mm.py:TILES)
template <int kBM>
struct Tile {
  static constexpr int kWM = kBM == 64 ? 1 : 2;
  static constexpr int kMT = kBM == 256 ? 2 : 1;
  static constexpr int kN = kBM == 128 ? 256 : 128;
  static constexpr int kBN = kN * (2 / kWM);
  static constexpr int kABytes = kBM * kStageK, kBBytes = kBN * kStageK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOutBytes = 2 * 2 * kOutBox;  // two buffers for each consumer warpgroup
  static constexpr int kFit = (kSmemMax - 1024 - kOutBytes - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kOutBytes + 16 * kStages;
};

template <typename T>
using AccT = std::conditional_t<sizeof(T) == 1, int, float>;

template <typename T, int kN>
__device__ __forceinline__ void mma(AccT<T> (&d)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (sizeof(T) == 1) {
    if constexpr (kN == 256)
      wgmma_s8_n256(d, da, db);
    else
      wgmma_s8_n128(d, da, db);
  } else {
    if constexpr (kN == 256)
      wgmma_bf16_n256<0, 1>(d, da, db);  // a K-major, b MN-major
    else
      wgmma_bf16_n128<0, 1>(d, da, db);
  }
}

template <typename T, int kBM>
__global__ void __launch_bounds__(kThreads, 1)
    block_mm_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map,
                    const __grid_constant__ CUtensorMap out_map, int M, int N, int K) {
  using G = Tile<kBM>;
  constexpr int kBN = G::kBN, kMT = G::kMT, kN = G::kN, kStages = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* out_s = ring + kStages * G::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + G::kOutBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
  __syncthreads();
  griddep_launch_dependents();

  // the walk: tile u = (row tile u % m_tiles, column tile u / m_tiles)
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const int tiles = m_tiles * n_tiles;
  const int chunks = (K * (int)sizeof(T) + kStageK - 1) / kStageK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    griddep_wait();  // the kernel before (the int8 transpose) has written b^T
    int it = 0;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const int m0 = (u % m_tiles) * kBM, n0 = (u / m_tiles) * kBN;
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[s], G::kStageBytes);
        unsigned char* st = ring + s * G::kStageBytes;
        const int k = c * (kStageK / (int)sizeof(T));  // K coordinate, in elements
        tma_load_2d(st, &a_map, k, m0, &full[s]);
        if constexpr (sizeof(T) == 2) {  // b [K, N]: 64-column boxes, MN-major
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(st + G::kABytes + j * 8192, &b_map, n0 + 64 * j, k, &full[s]);
        } else {  // b^T [N, K]: one box of kBN rows, K-major
          tma_load_2d(st + G::kABytes, &b_map, k, n0, &full[s]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int cw = wg - 1, t = threadIdx.x & 127, lane = t & 31;
  const int wm = G::kWM == 2 ? cw : 0, wn = G::kWM == 2 ? 0 : cw;
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  // this warpgroup's operands within a stage, and a wgmma's K step
  const int a_off = wm * kMT * 64 * 128;
  const int b_off = G::kABytes + (sizeof(T) == 2 ? (wn * kN / 64) * 8192 : wn * kN * 128);
  const uint32_t b_lbo = sizeof(T) == 2 ? 8192 : 16;
  const int b_step = sizeof(T) == 2 ? 16 * 128 : 32;  // 16 K rows MN-major, 32 bytes K-major
  AccT<T> acc[kMT][kN / 2];
  int it = 0;
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    const int m0 = (u % m_tiles) * kBM, n0 = (u / m_tiles) * kBN;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int r = 0; r < kN / 2; ++r) acc[i][r] = 0;
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* st = ring + s * G::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 4 steps of 32 bytes of K
        const uint64_t db = smem_desc(st + b_off + kk * b_step, b_lbo);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          mma<T, kN>(acc[i], smem_desc(st + a_off + i * 64 * 128 + 32 * kk, 16), db);
      }
      wgmma_commit();
      wgmma_wait1();  // the stage before this one has been read
      if (c > 0) release((it - 1) % kStages);
    }
    wgmma_wait0();
    release((it - 1) % kStages);
#pragma unroll
    for (int i = 0; i < kMT; ++i) reg_fence(acc[i]);
    // 64 rows x 32 columns at a time through this warpgroup's two buffers
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kN / 32; ++j) {
        unsigned char* buf = out_s + (2 * cw + ((i * (kN / 32) + j) & 1)) * kOutBox;
        if (t == 0) bulk_wait_read<1>();  // the store of two pieces ago has read buf
        named_bar_sync(1 + cw, 128);  // this warpgroup's threads
#pragma unroll
        for (int r = 16 * j; r < 16 * j + 16; r += 2) {  // the registers of columns 32 j ..
          unsigned char* p = buf + swz128(frag_row(r, t), 4 * (frag_col(r, t) - 32 * j));
          if constexpr (sizeof(T) == 1)
            *reinterpret_cast<int2*>(p) = make_int2(acc[i][r], acc[i][r + 1]);
          else
            *reinterpret_cast<float2*>(p) = make_float2(acc[i][r], acc[i][r + 1]);
        }
        fence_proxy_async();  // the writes, visible to the TMA store
        named_bar_sync(1 + cw, 128);
        if (t == 0) {
          const int row = m0 + (wm * kMT + i) * 64, col = n0 + wn * kN + 32 * j;
          if (row < M && col < N) tma_store_2d(&out_map, buf, col, row);
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

// bm: the plan's grid and the ring's stages, checked against the kernel's
// own; b is b^T [N, K] for int8
template <typename T, int kBM>
int launch_tma(const void* a, const void* b, void* out, int M, int N, int K, int grid,
               int stages, cudaStream_t stream) {
  using G = Tile<kBM>;
  if (stages != G::kStages || grid < 1) return (int)cudaErrorInvalidValue;
  auto kernel = block_mm_kernel<T, kBM>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return (int)e;
  const uint64_t m = M, n = N, k = K;
  constexpr uint32_t kBox = kStageK / sizeof(T);  // K elements of a box row
  MapShape a_shape, b_shape;
  const MapShape out_shape = {sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              n, m, 4 * n, 32, 64, CU_TENSOR_MAP_SWIZZLE_128B};
  if constexpr (sizeof(T) == 1) {
    a_shape = {CU_TENSOR_MAP_DATA_TYPE_UINT8, k, m, k, kBox, kBM, CU_TENSOR_MAP_SWIZZLE_128B};
    b_shape = {CU_TENSOR_MAP_DATA_TYPE_UINT8, k, n, k, kBox, G::kBN, CU_TENSOR_MAP_SWIZZLE_128B};
  } else {
    a_shape = {CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, m, 2 * k, kBox, kBM,
               CU_TENSOR_MAP_SWIZZLE_128B};
    b_shape = {CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n, k, 2 * n, 64, kBox,
               CU_TENSOR_MAP_SWIZZLE_128B};
  }
  CUtensorMap a_map, b_map, out_map;
  if (!maps().get(&a_map, a, a_shape) || !maps().get(&b_map, b, b_shape) ||
      !maps().get(&out_map, out, out_shape))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute dependent;  // may set up while the kernel before finishes
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &dependent;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a_map, b_map, out_map, M, N, K);
}

template <typename T>
int launch_tile(const void* a, const void* b, void* out, int M, int N, int K, int block_m,
                int grid, int stages, cudaStream_t st) {
  if (block_m == 64) return launch_tma<T, 64>(a, b, out, M, N, K, grid, stages, st);
  if (block_m == 128) return launch_tma<T, 128>(a, b, out, M, N, K, grid, stages, st);
  if (block_m == 256) return launch_tma<T, 256>(a, b, out, M, N, K, grid, stages, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

using dmi::mm::aligned16;

// Plain C entry point (bound with ctypes).  int8: a, b int8 and out int32;
// otherwise a, b bf16 and out f32.  All row-major and contiguous.  The
// launch plan of ops/cuda/block_mm.py:plan: tma 1 takes the TMA kernel at
// block_m with `grid` persistent blocks and a ring of `stages`; int8 then
// needs bt, N x K bytes of scratch for b^T.  tma 0 takes the wmma instance
// (block_m, grid, stages and bt are not read).  Returns the CUDA error code
// of the first failed launch, 0 on success.
extern "C" int dmi_block_mm(const void* a, const void* b, void* bt, void* out, int M, int N,
                            int K, int block_m, int int8, int tma, int grid, int stages,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (!tma)
    return int8 ? dmi::mm::launch<signed char, int, dmi::mm::kRowMajorA, 128>(a, b, out, M, N, K,
                                                                              st)
                : dmi::mm::launch<__nv_bfloat16, float, dmi::mm::kRowMajorA, 128>(a, b, out, M, N,
                                                                                  K, st);
  if (!aligned16(a) || !aligned16(b) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (!int8) {
    if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    return launch_tile<__nv_bfloat16>(a, b, out, M, N, K, block_m, grid, stages, st);
  }
  if (K % 16 || N % 16 || bt == nullptr || !aligned16(bt)) return (int)cudaErrorInvalidValue;
  if ((K + 127) / 128 > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  transpose_s8_kernel<<<dim3((N + 127) / 128, (K + 127) / 128), 256, 0, st>>>(
      static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), K, N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_tile<signed char>(a, bt, out, M, N, K, block_m, grid, stages, st);
}
