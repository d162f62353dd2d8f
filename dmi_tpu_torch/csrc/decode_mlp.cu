// The gated MLP of one batch-last decode step for Hopper, every weight byte
// read once:
//   g = w_gu[:, :I]^T @ h,  u = w_gu[:, I:]^T @ h      [I, B]
//   out = w_down^T @ (act(g) * u)                      [H, B]
//
// Replaces the TPU kernel dmi_tpu/ops/pallas/decode_mlp.py:_mlp_pallas_bl
// (body _kernel), behind fused_decode_mlp_bl.
//
//   w_gu [H, 2I] (gate | up columns), w_down [I, H], h [H, B], out [H, B]:
//   row-major, one dtype (f32 or bf16); H and I multiples of 8, B of 16 in
//   f32 and of 8 in bf16 (the wrapper pads the batch), so every 16-byte load
//   is whole and aligned and every TMA row stride a multiple of 16 bytes.
//
// Math, as the Pallas body (decode_mlp.py:62-80): g and u accumulate in f32
// and are rounded to the tensors' dtype; act(g) (silu or tanh-GELU, in f32) is
// rounded, and its product with u is rounded; the down product accumulates
// in f32 and is rounded once at the end.
//
// What bounds it on the H100: at the serving shape (H 2048, I 8192, B 128,
// bf16) a call reads 100.7 MB of weights (30 us at 3.35 TB/s) and does 12.9
// GFLOP (13 us on the tensor cores), so the weight stream bounds it, and that
// stream has to cover the card and keep enough bytes in flight on every SM.
// One TPU core walks the I tiles in order with one resident accumulator; on
// the card the I axis is spread over blocks, in two kernels.
//
// bf16, TMA and wgmma (warp-specialised: warpgroup 0 is the producer, one
// or two consumer warpgroups multiply):
//   1. gate_up_wgmma: a block owns 64 columns of I (128 blocks at I 8192,
//      one wave of the 132 SMs): its gate and its up tiles of w_gu and the
//      batch's h stream through one ring of stages in shared memory, as TMA
//      boxes of 64 K rows x 64 columns landing 128-byte swizzled, counted on
//      mbarriers; both products run as wgmma m64nNk16 with the weight tile
//      as the 64-row side and h as the N side, accumulating in registers;
//      the epilogue writes act(g) * u [I, B] in bf16 (2 MB at B 128, which
//      stays in the L2 cache);
//   2. down_wgmma: a block owns 64 columns of H and one split of the I axis
//      (32 x 4 = 128 blocks at H 2048), launched as a programmatic dependent
//      of the gate-up pass, so that it prefetches its first weight boxes into
//      L2 while that pass finishes; the splits write f32 partials and the
//      last of a tile's splits to arrive adds them in split order (its own
//      from registers) and rounds once.  No float atomics and no reduce
//      launch: the order of the sum, and with it the greedy tokens, is the
//      same in every run.
//   A batch of up to 64 columns takes m64n64 products, up to 128 m64n128,
//   up to 256 two consumer warpgroups of 128 columns that share the weight
//   boxes; wider batches tile the grid.  The TMA descriptors (tensor maps)
//   are encoded on the host once per tensor and cached.
//   The first version (cp.async into padded tiles, nvcuda::wmma 16 x 16 x
//   16, three launches with an f32 partial round trip) took 140.6-145.5 us
//   at the serving shape against 49.8-58.1 us for its cuBLAS chain, bound by
//   the wmma fragment loads of its inner loop (PERF.md).  This
//   design, measured by chip_smoke.py (device time per call, three runs,
//   NVIDIA H100 80GB HBM3, 700.00 W): 49.5-50.0 us at B 128 against
//   56.6-57.3 us for the chain (bound 30.4 us); B 8 54.2-54.7 against
//   50.1-50.9, B 64 44.1-44.3 against 49.5-50.4, B 100 62.1-62.2 against
//   77.6-78.3, B 256 57.0-57.5 against 63.5-64.0.
//
// f32 (no tensor cores: TF32 would not hold 1e-4), three kernels on the
// CUDA cores: gate_up_act as above, down_partial (64 columns of H x one
// split of I, writing an f32 partial [splits, H, B]) and a reduce that adds
// the partials in split order.  Both products run one tile routine: a
// 64 x 128 output tile per weight column range, the contraction axis staged
// through a ring of three chunks in shared memory by 16-byte cp.async
// copies, FMAs on the CUDA cores, so an f32 call agrees with f32 math up to
// summation order.
#include <cuda_pipeline.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

using dmi::gelu_tanh;
using dmi::Num;

constexpr int kActSilu = 0, kActGelu = 1;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Num<T>::load(Num<T>::store(v));
}

// act(g) * u from f32 sums, with the Pallas body's rounding points: g and u
// rounded to T, act(g) rounded, the product rounded by the caller's store.
// bf16 takes silu's exp and division from the SFU (__expf, __fdividef:
// relative errors near 2^-21, far inside the bf16 rounding of act(g) that
// follows); in f32 both are exact to the last bit of f32 math.
template <typename T>
__device__ __forceinline__ float act_mul(float g_sum, float u_sum, int act) {
  const float g = round_to<T>(g_sum), u = round_to<T>(u_sum);
  float a;
  if (act != kActSilu)
    a = gelu_tanh(g);
  else if constexpr (sizeof(T) == 2)
    a = __fdividef(g, 1.0f + __expf(-g));
  else
    a = g / (1.0f + expf(-g));
  return __fmul_rn(round_to<T>(a), u);
}

// ---- f32: a cp.async ring and FMAs on the CUDA cores ----

constexpr int kThreads = 256;
constexpr int kTileM = 64;    // weight columns (rows of the output) per block
constexpr int kTileN = 128;   // batch columns per block
constexpr int kChunk = 32;    // contraction rows per ring slot
constexpr int kLdW = kTileM + 4, kLdX = kTileN + 4;  // f32 words per staged row
constexpr int kLdC = kTileN + 4;        // f32 words per row of a staged output tile
constexpr int kStages = 3;              // chunks in the shared-memory ring
constexpr int kWBytes = kChunk * kLdW * 4;  // one staged weight chunk
constexpr int kXBytes = kChunk * kLdX * 4;  // one staged activation chunk
constexpr int kCBytes = kTileM * kLdC * 4;
// one ring slot: kNW weight chunks, then the activation chunk
__host__ __device__ constexpr int stage_bytes(int nw) { return nw * kWBytes + kXBytes; }
__host__ __device__ constexpr int smem_bytes(int nw) {
  return kStages * stage_bytes(nw) + nw * kCBytes;
}

// One thread's accumulators of kNW 64 x 128 tiles that share the
// activations.  step() multiplies one staged chunk: w_s (kNW chunks
// [kChunk][kLdW], kWBytes apart) holds W[k, m], x_s [kChunk][kLdX] holds
// X[k, n]; nb is the tile's valid batch columns.  Thread t owns output rows
// 4 * (t % 16) .. + 3 and columns 8 * (t / 16) .. + 7.
template <int kNW>
struct Tile {
  float acc[kNW][4][8];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[w][i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const unsigned char* w_s, const float* x_s, int nb) {
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
    if (8 * tn >= nb) return;
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(x_s + k * kLdX + 8 * tn);
      const float4 x1 = *reinterpret_cast<const float4*>(x_s + k * kLdX + 8 * tn + 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int w = 0; w < kNW; ++w) {
        const float4 wq = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(w_s + w * kWBytes) + k * kLdW + 4 * tm);
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[w][i][j] = fmaf(wv[i], xv[j], acc[w][i][j]);
      }
    }
  }
  // tile w goes to c_s + w * kTileM * kLdC
  __device__ __forceinline__ void store(float* c_s, int nb) {
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
    if (8 * tn >= nb) return;
#pragma unroll
    for (int w = 0; w < kNW; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          c_s[(w * kTileM + 4 * tm + i) * kLdC + 8 * tn + j] = acc[w][i][j];
  }
};

// One chunk of every operand from device memory into ring slot `slot`, as
// asynchronous 16-byte copies: 2 per weight range and 4 of the activations
// per thread.  Rows at or past k1, weight columns at or past m_end[w] and
// batch columns at or past nb are zero-filled (nothing is read for them).
template <int kNW>
__device__ __forceinline__ void stage_async(unsigned char* slot, const float* __restrict__ W,
                                            int ldw, const int (&m0)[kNW],
                                            const int (&m_end)[kNW], const float* __restrict__ X,
                                            int ldx, int nx0, int nb, int kc, int k1) {
  constexpr int kWv = kTileM / 4, kXv = kTileN / 4;  // 16-byte vectors per staged row
#pragma unroll
  for (int w = 0; w < kNW; ++w) {
    float* w_s = reinterpret_cast<float*>(slot + w * kWBytes);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int row = v / kWv, col = (v % kWv) * 4;
      const bool ok = kc + row < k1 && m0[w] + col < m_end[w];
      __pipeline_memcpy_async(w_s + row * kLdW + col,
                              ok ? W + (size_t)(kc + row) * ldw + m0[w] + col : W, 16,
                              ok ? 0 : 16);
    }
  }
  float* x_s = reinterpret_cast<float*>(slot + kNW * kWBytes);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int row = v / kXv, col = (v % kXv) * 4;
    const bool ok = kc + row < k1 && col < nb;
    __pipeline_memcpy_async(x_s + row * kLdX + col,
                            ok ? X + (size_t)(kc + row) * ldx + nx0 + col : X, 16, ok ? 0 : 16);
  }
}

// For each weight range w < kNW: c_s[w][m][n] = sum over k in [k0, k1) of
// W[k, m0[w] + m] * X[k, nx0 + n] for m < 64 (columns of W at or past
// m_end[w] count as zero) and n < nb, accumulated in f32.  W and X are
// row-major with ldw and ldx elements per row; ring is kStages slots of
// stage_bytes(kNW).  All threads of the block call it; it ends with the tiles
// in shared memory, unsynchronised.
template <int kNW>
__device__ __forceinline__ void tile_gemm(const float* __restrict__ W, int ldw,
                                          const int (&m0)[kNW], const int (&m_end)[kNW],
                                          const float* __restrict__ X, int ldx, int nx0, int nb,
                                          int k0, int k1, unsigned char* ring, float* c_s) {
  Tile<kNW> tile;
  tile.init();
  const int chunks = (k1 - k0 + kChunk - 1) / kChunk;
  // chunk c lives in slot c % kStages; one commit per chunk, with copies or
  // empty, so that chunk c is always the kStages - 2 newest groups away
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks)
      stage_async<kNW>(ring + c * stage_bytes(kNW), W, ldw, m0, m_end, X, ldx, nx0, nb,
                       k0 + c * kChunk, k1);
    __pipeline_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have, and everyone is done with chunk c - 1
    const int next = c + kStages - 1;    // refills the slot of chunk c - 1
    if (next < chunks)
      stage_async<kNW>(ring + (next % kStages) * stage_bytes(kNW), W, ldw, m0, m_end, X, ldx,
                       nx0, nb, k0 + next * kChunk, k1);
    __pipeline_commit();
    const unsigned char* slot = ring + (c % kStages) * stage_bytes(kNW);
    tile.step(slot, reinterpret_cast<const float*>(slot + kNW * kWBytes), nb);
  }
  tile.store(c_s, nb);
}

// act_out[i, b] = act(g[i, b]) * u[i, b] for the block's 64 columns i of I
__global__ void __launch_bounds__(kThreads)
    gate_up_act_kernel(const float* __restrict__ w_gu, const float* __restrict__ h,
                       float* __restrict__ act_out, int H, int I, int B, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* g_s = reinterpret_cast<float*>(smem + kStages * stage_bytes(2));
  const float* u_s = g_s + kTileM * kLdC;
  const int i0 = blockIdx.x * kTileM, nx0 = blockIdx.y * kTileN;
  const int nb = min(kTileN, B - nx0);
  const int m0[2] = {i0, I + i0}, m_end[2] = {I, 2 * I};  // the gate and the up columns
  tile_gemm<2>(w_gu, 2 * I, m0, m_end, h, B, nx0, nb, 0, H, smem, g_s);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileM * nb; idx += kThreads) {
    const int m = idx / nb, n = idx % nb;
    if (i0 + m >= I) break;
    act_out[(size_t)(i0 + m) * B + nx0 + n] =
        act_mul<float>(g_s[m * kLdC + n], u_s[m * kLdC + n], act);
  }
}

// partial[s, m, b] = sum over the split's rows i of w_down[i, m] * act[i, b]
__global__ void __launch_bounds__(kThreads)
    down_partial_kernel(const float* __restrict__ w_down, const float* __restrict__ act,
                        float* __restrict__ partial, int I, int H, int B, int per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* c_s = reinterpret_cast<float*>(smem + kStages * stage_bytes(1));
  const int nx0 = blockIdx.y * kTileN;
  const int m0[1] = {(int)blockIdx.x * kTileM}, m_end[1] = {H};
  const int nb = min(kTileN, B - nx0);
  const int k0 = min(I, (int)blockIdx.z * per_split), k1 = min(I, k0 + per_split);
  tile_gemm<1>(w_down, H, m0, m_end, act, B, nx0, nb, k0, k1, smem, c_s);
  __syncthreads();
  float* dst = partial + (size_t)blockIdx.z * H * B;
  for (int idx = threadIdx.x; idx < kTileM * nb; idx += kThreads) {
    const int m = idx / nb, n = idx % nb;
    if (m0[0] + m >= H) break;
    dst[(size_t)(m0[0] + m) * B + nx0 + n] = c_s[m * kLdC + n];
  }
}

// out = the partials added in split order
__global__ void reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n,
                              int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = partial[i];
  for (int s = 1; s < splits; ++s) sum += partial[(size_t)s * n + i];
  out[i] = sum;
}

int launch_f32(const float* w_gu, const float* w_down, const float* h, float* act_buf,
               float* partial, float* out, int H, int I, int B, int splits, int per_split,
               int act, cudaStream_t stream) {
  const int smem_a = smem_bytes(2), smem_b = smem_bytes(1);
  cudaError_t e = cudaFuncSetAttribute(gate_up_act_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(down_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_b);
  if (e != cudaSuccess) return (int)e;
  const int bt = (B + kTileN - 1) / kTileN;
  gate_up_act_kernel<<<dim3((I + kTileM - 1) / kTileM, bt), kThreads, smem_a, stream>>>(
      w_gu, h, act_buf, H, I, B, act);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  down_partial_kernel<<<dim3((H + kTileM - 1) / kTileM, bt, splits), kThreads, smem_b,
                        stream>>>(w_down, act_buf, partial, I, H, B, per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = H * B;
  reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, n, splits);
  return (int)cudaGetLastError();
}

// ---- bf16: a TMA ring and wgmma ----
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

using namespace dmi::flash;  // bf16, smem_addr, the mbarrier and TMA helpers

constexpr int kKc = 64;                          // K rows per ring stage
constexpr int kTileCols = 64;                    // columns of a box: one 128-byte swizzled row
constexpr int kBoxBytes = kKc * kTileCols * 2;   // 8 KB
constexpr int kSbo = 1024;                       // bytes between 8-row groups along K
constexpr int kKStep = 16 * 128;                 // bytes of one wgmma's 16 K rows
constexpr int kSmemMax = 232448;                 // 227 KB a block
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

// ---- host: tensor maps ----

// A map of the row-major bf16 matrix at base ([rows, cols], row_bytes apart)
// in boxes of 64 columns x kKc rows, 128-byte swizzled.  False where the
// driver has no encoder or refuses the shape.
bool encode_map(CUtensorMap* m, const void* base, uint64_t cols, uint64_t rows,
                uint64_t row_bytes) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {kTileCols, kKc};
  const cuuint32_t unit[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps by (pointer, shape, row stride), each encoded at its first
// use (every map here is of bf16, the one dtype that takes this path); when
// the cache is full the least recently used map is replaced.  A map holds
// only the address, shape and strides it was made from, so a new tensor at
// a freed address with the same key gets a map that is right for it.
template <int kEntries>
struct MapCache {
  struct Entry {
    const void* base;
    uint64_t cols, rows, row_bytes, used;
    CUtensorMap map;
  };
  Entry entries[kEntries];
  int n = 0;
  uint64_t tick = 0;
  long long encodes = 0;
  std::mutex mu;

  // the map of (base, cols, rows, row_bytes); false where it cannot be encoded
  bool get(CUtensorMap* out, const void* base, uint64_t cols, uint64_t rows,
           uint64_t row_bytes) {
    std::lock_guard<std::mutex> lock(mu);
    ++tick;
    Entry* lru = nullptr;
    for (int i = 0; i < n; ++i) {
      Entry& e = entries[i];
      if (e.base == base && e.cols == cols && e.rows == rows && e.row_bytes == row_bytes) {
        e.used = tick;
        *out = e.map;
        return true;
      }
      if (lru == nullptr || e.used < lru->used) lru = &e;
    }
    Entry& e = n < kEntries ? entries[n] : *lru;
    if (!encode_map(&e.map, base, cols, rows, row_bytes)) return false;
    if (n < kEntries) ++n;  // e was entries[n]
    e.base = base, e.cols = cols, e.rows = rows, e.row_bytes = row_bytes, e.used = tick;
    ++encodes;
    *out = e.map;
    return true;
  }
};

// The weights' maps (two a layer: a model of up to 128 layers keeps them
// all), and apart from them the activations' (new addresses as the caching
// allocator hands them out), so that activations never evict a weight.
MapCache<256>& weight_maps() {
  static MapCache<256> cache;
  return cache;
}
MapCache<16>& act_maps() {
  static MapCache<16> cache;
  return cache;
}

// ---- device ----

// the box of `map` at (column c0, row c1) into the L2 cache only
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
               : "memory");
}

// Programmatic dependent launch: a kernel launched right after this one with
// the programmatic-serialization attribute may start (and run up to its
// griddep_wait) once every block of this one has called
// griddep_launch_dependents; griddep_wait returns when the kernel before has
// finished and its writes are visible.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A shared-memory matrix descriptor: start address, leading byte offset
// (between 64-column atoms along MN), stride byte offset (between 8-row
// groups along K), 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x N f32, the warpgroup's fragment) += A (64 x 16, MN-major) *
// B (16 x N, MN-major), both by descriptor; scale-d 1, both transposed
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int kN>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (kN == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n64(d, da, db);
}

// Register r of a warpgroup thread's m64nN fragment holds C[row, col]:
// warp w of the group owns rows 16 w .. 16 w + 15, as in mma.sync's
// m16n8 C tile, one n8 tile per four registers.
__device__ __forceinline__ int frag_row(int r, int t) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int r, int t) {
  return 8 * (r >> 2) + 2 * (t & 3) + (r & 1);
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

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023);
  return reinterpret_cast<unsigned char*>(a);
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

// act[i, b] = act(g) * u for the block's 64 columns i of I and its kWG x kN
// batch columns: gate and up tiles of the same columns in one block, so the
// product is formed in registers
template <int kN, int kWG>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
    gate_up_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap h_map, bf16* __restrict__ act_out,
                         int H, int I, int B, int act) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t *full, *empty;
  init_ring<2, kN, kWG>(ring, full, empty);
  griddep_launch_dependents();  // the down pass may take the SMs this one leaves
  const int i0 = blockIdx.x * kTileCols, x_col = blockIdx.y * kWG * kN;
  const int n_chunks = (H + kKc - 1) / kKc;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_producer<kWG>();
    if (threadIdx.x == 0) {
      const int w_col[2] = {i0, I + i0};  // the gate and the up columns
      produce<2, kN, kWG>(ring, full, empty, &w_map, w_col, &h_map, x_col, 0, n_chunks);
    }
  } else {
    regs_consumer<kWG>();
    float acc[2][kN / 2];
#pragma unroll
    for (int r = 0; r < kN / 2; ++r) acc[0][r] = acc[1][r] = 0.f;
    consume<2, kN, kWG>(acc, ring, full, empty, wg - 1, n_chunks);
    const int t = threadIdx.x & 127, b0 = x_col + (wg - 1) * kN;
#pragma unroll
    for (int r = 0; r < kN / 2; r += 2) {
      const int i = i0 + frag_row(r, t), b = b0 + frag_col(r, t);
      if (i < I && b < B)
        *reinterpret_cast<__nv_bfloat162*>(act_out + (size_t)i * B + b) =
            __floats2bfloat162_rn(act_mul<bf16>(acc[0][r], acc[1][r], act),
                                  act_mul<bf16>(acc[0][r + 1], acc[1][r + 1], act));
    }
  }
}

// out[m, b] for the block's 64 columns m of H and its batch columns, over
// one split of the I axis (blockIdx.x).  Each block writes its f32 partial,
// in fragment order (coalesced), to `partial` and counts itself on its
// tile's counter; the last of the tile's splits to arrive adds every split's
// partial in split order (its own from registers), rounds once, writes out
// and sets the counter back to 0 for the next call.  The order of the sum
// does not depend on which block comes last, so two calls are bit-equal;
// there are no float atomics and no reduce launch.
template <int kN, int kWG>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
    down_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                      const __grid_constant__ CUtensorMap x_map, bf16* __restrict__ out,
                      float* __restrict__ partial, int* __restrict__ counters, int I, int H, int B,
                      int per_split) {
  constexpr int kTileFloats = kWG * 128 * kN / 2;  // one split's partial of the tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t *full, *empty;
  init_ring<1, kN, kWG>(ring, full, empty);
  __shared__ int last;
  const int split = blockIdx.x, splits = gridDim.x;
  const int m0 = blockIdx.y * kTileCols, x_col = blockIdx.z * kWG * kN;
  const int k0 = min(I, split * per_split), k1 = min(I, k0 + per_split);
  const int n_chunks = (k1 - k0 + kKc - 1) / kKc;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_producer<kWG>();
    if (threadIdx.x == 0) {
      // the first stages' weights into L2 while the gate-up pass finishes,
      // then, once it has, its activations
      for (int c = 0; c < n_chunks && c < Ring<1, kN, kWG>::kStages; ++c)
        tma_prefetch_2d(&w_map, m0, k0 + c * kKc);
      griddep_wait();
      const int w_col[1] = {m0};
      produce<1, kN, kWG>(ring, full, empty, &w_map, w_col, &x_map, x_col, k0, n_chunks);
    }
    return;
  }
  regs_consumer<kWG>();
  float acc[1][kN / 2];
#pragma unroll
  for (int r = 0; r < kN / 2; ++r) acc[0][r] = 0.f;
  consume<1, kN, kWG>(acc, ring, full, empty, wg - 1, n_chunks);

  const int tile = blockIdx.z * gridDim.y + blockIdx.y;
  const int tc = threadIdx.x - 128;  // consumer thread: warpgroup wg - 1, thread t of it
  float2* mine =
      reinterpret_cast<float2*>(partial + ((size_t)tile * splits + split) * kTileFloats);
#pragma unroll
  for (int r = 0; r < kN / 2; r += 2)
    __stcg(mine + (r / 2) * (128 * kWG) + tc, make_float2(acc[0][r], acc[0][r + 1]));
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"r"(128 * kWG) : "memory");  // the consumers only
  if (tc == 0) {
    last = atomicAdd(&counters[tile], 1) == splits - 1;
    if (last) counters[tile] = 0;  // every split has counted: ready for the next call
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(128 * kWG) : "memory");
  if (!last) return;
  __threadfence();
  const int t = tc & 127, c0 = x_col + (wg - 1) * kN;
  float sum[kN / 2];
#pragma unroll
  for (int r = 0; r < kN / 2; ++r) sum[r] = 0.f;
  for (int p = 0; p < splits; ++p) {  // the splits in order
    const float2* theirs =
        reinterpret_cast<const float2*>(partial + ((size_t)tile * splits + p) * kTileFloats);
#pragma unroll
    for (int r = 0; r < kN / 2; r += 2) {
      const float2 v = p == split ? make_float2(acc[0][r], acc[0][r + 1])
                                  : __ldcg(theirs + (r / 2) * (128 * kWG) + tc);
      sum[r] += v.x, sum[r + 1] += v.y;
    }
  }
#pragma unroll
  for (int r = 0; r < kN / 2; r += 2) {
    const int m = m0 + frag_row(r, t), b = c0 + frag_col(r, t);
    if (m < H && b < B)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * B + b) =
          __floats2bfloat162_rn(sum[r], sum[r + 1]);
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The plan's stages must be the rings' (ops/cuda/decode_mlp.py:plan chooses
// them by the same rule) and its splits none empty.
template <int kN, int kWG>
int launch_bf16(const void* w_gu, const void* w_down, const void* h, void* act_buf, void* partial,
                void* counters, void* out, int H, int I, int B, int stages, int down_stages,
                int splits, int per_split, int act, cudaStream_t stream) {
  using R1 = Ring<2, kN, kWG>;
  using R2 = Ring<1, kN, kWG>;
  const int bt = (B + kWG * kN - 1) / (kWG * kN);
  if (stages != R1::kStages || down_stages != R2::kStages ||
      (long long)(splits - 1) * per_split >= I || bt > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  // per call: the attribute belongs to the current device's context
  int e = set_smem(gate_up_wgmma_kernel<kN, kWG>, R1::kSmem);
  if (e == 0) e = set_smem(down_wgmma_kernel<kN, kWG>, R2::kSmem);
  if (e != 0) return e;
  CUtensorMap w_gu_map, h_map, w_down_map, act_map;
  const uint64_t hi = H, ii = I, bi = B;
  if (!weight_maps().get(&w_gu_map, w_gu, 2 * ii, hi, 4 * ii) ||
      !weight_maps().get(&w_down_map, w_down, hi, ii, 2 * hi) ||
      !act_maps().get(&h_map, h, bi, hi, 2 * bi) ||
      !act_maps().get(&act_map, act_buf, bi, ii, 2 * bi))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(128 * (kWG + 1));
  cfg.stream = stream;
  cfg.gridDim = dim3((I + kTileCols - 1) / kTileCols, bt);
  cfg.dynamicSmemBytes = R1::kSmem;
  e = (int)cudaLaunchKernelEx(&cfg, gate_up_wgmma_kernel<kN, kWG>, w_gu_map, h_map,
                              static_cast<bf16*>(act_buf), H, I, B, act);
  if (e != 0) return e;
  cfg.gridDim = dim3(splits, (H + kTileCols - 1) / kTileCols, bt);
  cfg.dynamicSmemBytes = R2::kSmem;
  cudaLaunchAttribute dependent;  // may start while the gate-up pass finishes
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &dependent;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, down_wgmma_kernel<kN, kWG>, w_down_map, act_map,
                                 static_cast<bf16*>(out), static_cast<float*>(partial),
                                 static_cast<int*>(counters), I, H, B, per_split);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// first failed launch, 0 on success.  B is a multiple of 16 in f32, of 8 in
// bf16.  act_buf [I, B] (the tensors' dtype) and partial (f32) are scratch
// the caller allocates; the down product's I axis falls into `splits`
// splits of per_split rows (a multiple of 64), none empty.  f32: partial
// [splits, H, B], added by a reduce launch; n, wgs, the stages and counters
// are not read.  bf16, the launch plan of ops/cuda/decode_mlp.py:plan: the
// wgmma tile's batch width n (64 or 128) and its consumer warpgroups wgs (1,
// or 2 at n 128), the rings' stages (checked against the kernels'); partial
// holds every split's f32 partial of every down tile in fragment order, and
// counters (int32, one per 64 columns of H and batch tile, zero before the
// call and after it) order the splits' sum: calls that share counters run on
// one stream.
extern "C" int dmi_decode_mlp(const void* w_gu, const void* w_down, const void* h, void* act_buf,
                              void* partial, void* counters, void* out, int H, int I, int B,
                              int n, int wgs, int stages, int down_stages, int splits,
                              int per_split, int act, int dtype, void* stream) {
  if (H < 8 || I < 8 || B < 8 || H % 8 || I % 8 || B % 8 || splits < 1 || per_split < 64 ||
      per_split % 64 || (long long)splits * per_split < I ||
      (act != kActSilu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(w_gu) || !aligned16(w_down) || !aligned16(h) || !aligned16(act_buf))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32) {
    if (B % 16 || splits > 64 || (B + kTileN - 1) / kTileN > 65535)
      return (int)cudaErrorInvalidValue;
    return launch_f32(static_cast<const float*>(w_gu), static_cast<const float*>(w_down),
                      static_cast<const float*>(h), static_cast<float*>(act_buf),
                      static_cast<float*>(partial), static_cast<float*>(out), H, I, B, splits,
                      per_split, act, s);
  }
  if (dtype == dmi::kBFloat16) {
    if (!aligned16(out) || !aligned16(partial) || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    if (n == 64 && wgs == 1)
      return launch_bf16<64, 1>(w_gu, w_down, h, act_buf, partial, counters, out, H, I, B,
                                stages, down_stages, splits, per_split, act, s);
    if (n == 128 && wgs == 1)
      return launch_bf16<128, 1>(w_gu, w_down, h, act_buf, partial, counters, out, H, I, B,
                                 stages, down_stages, splits, per_split, act, s);
    if (n == 128 && wgs == 2)
      return launch_bf16<128, 2>(w_gu, w_down, h, act_buf, partial, counters, out, H, I, B,
                                 stages, down_stages, splits, per_split, act, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Tensor maps encoded since the library was loaded (a cache hit encodes
// none): the weights' (acts 0) or the activations' (acts 1)
extern "C" long long dmi_decode_mlp_map_encodes(int acts) {
  return acts ? act_maps().encodes : weight_maps().encodes;
}
