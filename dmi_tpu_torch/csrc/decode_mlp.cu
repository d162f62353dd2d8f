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

#include "common.cuh"
#include "stream_ring.cuh"

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

// ---- bf16: a TMA ring and wgmma (stream_ring.cuh) ----

using namespace dmi::ring;  // the ring, its producer and consumers; tensor maps, wgmma

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
  if (!weight_maps().get(&w_gu_map, w_gu, bf16_boxes(2 * ii, hi, 4 * ii)) ||
      !weight_maps().get(&w_down_map, w_down, bf16_boxes(hi, ii, 2 * hi)) ||
      !act_maps().get(&h_map, h, bf16_boxes(bi, hi, 2 * bi)) ||
      !act_maps().get(&act_map, act_buf, bf16_boxes(bi, ii, 2 * bi)))
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
