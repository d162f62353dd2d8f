// Weight-stream matmul probe for Hopper: out = w^T h, with w [I, O] and h
// [I, B] bf16, out [O, B] bf16 (an f32 sum rounded once).
//
// Replaces the TPU kernel pallas_mm of scripts/profile_mlp_stream.py:67-78
// (body :61-65), which asks whether a hand-written kernel streams the decode
// MLP's gate-up weights (I 2048, O 16384, B 256) faster than the library.
//
// What bounds it: a call reads 67.1 MB of weights and writes 8.4 MB (22.8 us
// at 3.35 TB/s) and does 17.2 GFLOP (17 us on the bf16 tensor cores), so the
// weight stream bounds it and has to cover the card.
//
// The design is the decode MLP's gate-up product (stream_ring.cuh): a block
// owns block_o rows of O and every batch column of its batch tile; w's
// [I, block_o] slice and h stream through one ring of 64-row stages as
// MN-major TMA boxes into wgmma (both transpose bits set), one producer
// thread and two consumer warpgroups, each taking half of the batch tile's
// columns against all of the block's weight tiles, the sums in registers
// over all of I.  block_o (the counterpart of the script's bo sweep, one
// instance each):
//   64   one weight tile, two warpgroups of 128 batch columns (64 x 256 a
//        block, 256 blocks at O 16384: 1.94 waves of the 132 SMs);
//   128  two weight tiles, two warpgroups of 128 columns (128 x 256: 128
//        blocks, one wave, each weight byte read once);
//   256  four weight tiles, two warpgroups of 64 columns (256 x 128: a batch
//        of 256 takes two batch tiles, so each w slice is read twice, the
//        second time mostly from L2).
// The launch is a programmatic dependent of the kernel before it: a block
// prefetches its first weight boxes into L2 and only then waits for that
// kernel, so calls back to back overlap one's tail with the next one's
// start.
//
// What holds it (PERF.md, section 6; H100 80GB HBM3 at 700 W): at block_o
// 128 the weights stream at 1.8 TB/s, about 37 us a call (1.19x w.t() @
// h).  h fills two thirds of every 48 KB stage, so a block keeps only three
// stages of 16 KB of weights in flight.  Tried and dropped, none faster:
// clusters of 2 and 4 that multicast h's boxes (every block reads all of h
// from L2: 128 MB at B 256), w asked into L2 8-32 stages ahead of the ring,
// 256-byte L2 sectors for w, and consumers that keep a stage's products in
// flight (they hold each stage one stage longer).
//
// Shapes TMA cannot take (O or B off a multiple of 8, so rows are not whole
// 16-byte units, or a base off 16 bytes): the wmma instance of mm_tile.cuh
// (kTransA, 128 output rows a block), which the wrapper picks by shape
// before launching (ops/cuda/stream_mm.py:plan).
#include "mm_tile.cuh"
#include "stream_ring.cuh"

namespace {

using namespace dmi::ring;

// block_o -> weight tiles of 64 rows a block and batch columns a consumer
// warpgroup (ops/cuda/stream_mm.py:TILES)
template <int kBO>
struct Shape {
  static constexpr int kMT = kBO / 64;
  static constexpr int kN = kBO == 256 ? 64 : 128;
  static constexpr int kWG = 2;
  using R = Ring<kMT, kN, kWG>;
};

template <int kBO>
__global__ void __launch_bounds__(384, 1)
    stream_mm_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap h_map, bf16* __restrict__ out, int O,
                     int B, int I) {
  using S = Shape<kBO>;
  constexpr int kMT = S::kMT, kN = S::kN, kWG = S::kWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t *full, *empty;
  init_ring<kMT, kN, kWG>(ring, full, empty);
  griddep_launch_dependents();  // the next call may take the SMs this one leaves
  const int m0 = blockIdx.x * kBO, x_col = blockIdx.y * kWG * kN;
  const int n_chunks = (I + kKc - 1) / kKc;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_producer<kWG>();
    if (threadIdx.x == 0) {
      int w_col[kMT];
#pragma unroll
      for (int t = 0; t < kMT; ++t) w_col[t] = m0 + t * kTileCols;
      // the first stages' weights into L2 while the kernel before finishes
      for (int c = 0; c < n_chunks && c < S::R::kStages; ++c)
#pragma unroll
        for (int t = 0; t < kMT; ++t) tma_prefetch_2d(&w_map, w_col[t], c * kKc);
      griddep_wait();
      produce<kMT, kN, kWG>(ring, full, empty, &w_map, w_col, &h_map, x_col, 0, n_chunks);
    }
    return;
  }
  regs_consumer<kWG>();
  float acc[kMT][kN / 2];
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int r = 0; r < kN / 2; ++r) acc[t][r] = 0.f;
  consume<kMT, kN, kWG>(acc, ring, full, empty, wg - 1, n_chunks);
  const int t = threadIdx.x & 127, b0 = x_col + (wg - 1) * kN;
#pragma unroll
  for (int tt = 0; tt < kMT; ++tt)
#pragma unroll
    for (int r = 0; r < kN / 2; r += 2) {
      const int o = m0 + tt * 64 + frag_row(r, t), b = b0 + frag_col(r, t);
      if (o < O && b < B)  // B is even: a pair is whole
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)o * B + b) =
            __floats2bfloat162_rn(acc[tt][r], acc[tt][r + 1]);
    }
}

// h's and w's maps: new addresses as the caching allocator hands them out
MapCache<32>& maps() {
  static MapCache<32> cache;
  return cache;
}

// grid_x blocks over O, grid_y batch tiles, `stages` the ring's: the
// plan's, checked against the kernel's own
template <int kBO>
int launch_tma(const void* w, const void* h, void* out, int O, int B, int I, int grid_x,
               int grid_y, int stages, cudaStream_t stream) {
  using S = Shape<kBO>;
  using R = typename S::R;
  if (stages != R::kStages || grid_x != (O + kBO - 1) / kBO ||
      grid_y != (B + S::kWG * S::kN - 1) / (S::kWG * S::kN) || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = stream_mm_kernel<kBO>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap w_map, h_map;
  const uint64_t ii = I, oo = O, bb = B;
  if (!maps().get(&w_map, w, bf16_boxes(oo, ii, 2 * oo)) ||
      !maps().get(&h_map, h, bf16_boxes(bb, ii, 2 * bb)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, grid_y);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute dependent;  // may start while the kernel before finishes
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &dependent;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, w_map, h_map, static_cast<bf16*>(out), O, B, I);
}

}  // namespace

using dmi::mm::aligned16;

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch, 0 on success.  The launch plan of ops/cuda/stream_mm.py:plan:
// tma 1 takes the TMA kernel at block_o on a grid_x x grid_y grid with a
// ring of `stages` (O and B multiples of 8, w and h 16-byte aligned); tma 0
// the wmma instance (block_o, the grid and stages are not read).
extern "C" int dmi_stream_mm(const void* w, const void* h, void* out, int O, int B, int I,
                             int block_o, int tma, int grid_x, int grid_y, int stages,
                             void* stream) {
  using T = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O < 1 || B < 1 || I < 1) return (int)cudaErrorInvalidValue;
  if (!tma) return dmi::mm::launch<T, T, dmi::mm::kTransA, 128>(w, h, out, O, B, I, st);
  if (O % 8 || B % 8) return (int)cudaErrorInvalidValue;
  if (!aligned16(w) || !aligned16(h) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (block_o == 64) return launch_tma<64>(w, h, out, O, B, I, grid_x, grid_y, stages, st);
  if (block_o == 128) return launch_tma<128>(w, h, out, O, B, I, grid_x, grid_y, stages, st);
  if (block_o == 256) return launch_tma<256>(w, h, out, O, B, I, grid_x, grid_y, stages, st);
  return (int)cudaErrorInvalidValue;
}
