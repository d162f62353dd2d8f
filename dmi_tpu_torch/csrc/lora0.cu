// Fused LoRA projector layer 0 for Hopper, over G adapter groups:
//   out[g] = gelu_tanh(x[g] @ W0 + b0 + (x[g] @ A[g]) @ Bm[g] + d[g]).
//
// Replaces the TPU kernel dmi_tpu/ops/pallas/projector.py:_lora0_pallas
// (body _lora0_kernel), behind fused_lora_layer0: the stage-2 hypernet
// step's soft-token forward (the reference runs only layer 0 of the
// projector on that path, dmi_tpu/models/projector.py:11-19).  The TPU's
// vmap over adapter groups (hypernet_trainer.py:252) is the grid's z axis
// here, and the TPU's padding of the rank to 128 lanes is not needed.
//
//   x [G, B, mm], A [G, mm, r], Bm [G, r, lm], d [G, lm]; W0 [mm, lm] and
//   b0 [lm] shared by the groups; out [G, B, lm]; all contiguous, one dtype.
//
// Math, as the Pallas body (projector.py:239-244): inter = x @ A accumulated
// in f32, then rounded to Bm's dtype; y = x @ W0 + inter @ Bm + b0 + d in
// f32; gelu_tanh in f32; output rounded to x's dtype.  Plain FMAs on the CUDA
// cores, no TF32, so an f32 call agrees with f32 math up to summation order.
//
// What bounds it on the H100: at stage 2's micro-batch (G 1, B 4, f32, mm
// 768, lm 2048, r 32) one call reads W0 (6.3 MB), A (98 KB) and Bm (262 KB)
// and does ~13 MFLOP, about one FLOP per byte: device memory bounds it
// (~2 us at 3.35 TB/s).  A block owns 16 columns of lm and a row tile of up
// to 16 rows (128 blocks at G 1, B 4, so W0's stream covers the card), in
// clusters of 8 blocks along lm; it
//   1. loads its rows of x into shared memory (f32),
//   2. computes an eighth of their inter [rows, r] (its cluster rank's
//      eighth of mm), summed over mm slices with warp shuffles and across
//      the 8 warps in shared memory; after a cluster barrier every block
//      sums the 8 eighths from its cluster's shared memory (distributed
//      shared memory), in rank order, so all 8 hold the same inter,
//   3. streams its 16 columns of W0 and Bm once for all its rows: thread
//      (4-column group, mm slice) accumulates rows x 4 columns, summed
//      across slices the same way, and the epilogue adds the biases and
//      applies the GELU.
// Loads are 16 bytes where the widths allow it (4 f32 or 4 bf16 along mm,
// lm or r), each thread issues kBatch of them before it uses them, and the
// row tile is a template bound (4, 8 or 16), so a 4-row call runs no
// instructions for absent rows.  Why the cluster: with every block
// computing all of x @ A, its re-reads of A (12.5 MB through L2 at stage
// 2's call) took longer than the W0 stream, and a 16-row bound doubled
// the time at B 4 (csrc/probes/lora0_phases.cu times both; PERF.md).
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using dmi::gelu_tanh;
using dmi::Num;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;      // output columns per block
constexpr int kMaxRows = 16;   // upper bound of the row tile
constexpr int kBatch = 8;      // loads each thread issues before it uses them
constexpr int kCluster = 8;    // blocks of a cluster, which share the x @ A product

// V consecutive elements at p, widened to f32; V = 4 needs p aligned to
// 4 elements (checked by the entry point)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&o)[V]) {
  if constexpr (V == 1) {
    o[0] = Num<T>::load(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = lo.x, o[1] = lo.y, o[2] = hi.x, o[3] = hi.y;
  }
}

// acc[i][v] += sum over k = s0, s0 + S, ... < n of src_s[i * ld + k] *
// M[k, col + v] (M row-major with row length m_ld), kBatch loads in flight
template <typename T, int V, int R>
__device__ __forceinline__ void accumulate(float (&acc)[R][V], const float* src_s,
                                           int ld, int rows, const T* __restrict__ m,
                                           int m_ld, int col, int s0, int S, int n) {
  for (int k0 = s0; k0 < n; k0 += kBatch * S) {
    float w[kBatch][V];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * S;
      if (k < n) load_vec<T, V>(m + (size_t)k * m_ld + col, w[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * S;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < rows && k < n) {
          const float xv = src_s[i * ld + k];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[i][v] = fmaf(xv, w[u][v], acc[i][v]);
        }
      }
    }
  }
}

// Sums acc over the lanes of a warp that share lane % group (group divides
// 32); lanes below `group` hold the sums afterwards
template <int V, int R>
__device__ __forceinline__ void warp_reduce(float (&acc)[R][V], int rows, int group) {
  for (int o = 16; o >= group; o >>= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < rows) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][v] += __shfl_xor_sync(0xffffffffu, acc[i][v], o);
      }
    }
  }
}

// VW: elements per load of x, W0 and Bm (4 when mm and lm allow it, else
// 1); VA: elements per load of A (4 when r is 4, 8, 16 or 32, else 1); R:
// the largest row tile, the rows each thread accumulates (4, 8 or 16: a tile
// of 4 rows runs a quarter of the instructions of 16)
template <typename T, int VW, int VA, int R>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    lora0_kernel(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
                 const T* __restrict__ a, const T* __restrict__ bm, const T* __restrict__ d,
                 T* __restrict__ out, int B, int mm, int lm, int r, int tb) {
  extern __shared__ float smem[];
  float* x_s = smem;                    // [tb, mm]
  float* part_s = x_s + tb * mm;        // [tb, r] this block's share of x @ A
  float* inter_s = part_s + tb * r;     // [tb, r] x @ A
  float* red_s = inter_s + tb * r;      // partial sums, at most kThreads * tb
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * tb;
  const int rows = min(tb, B - row0);  // the last row tile may be ragged
  const int c0 = blockIdx.x * kCols;   // past lm in the grid's padding to clusters
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  x += ((size_t)g * B + row0) * mm;
  a += (size_t)g * mm * r;
  bm += (size_t)g * r * lm;
  d += (size_t)g * lm;
  out += ((size_t)g * B + row0) * lm;

  if constexpr (VW == 4) {
#pragma unroll 4
    for (int i = 4 * t; i < rows * mm; i += 4 * kThreads) {
      float v[4];
      load_vec<T, 4>(x + i, v);
      *reinterpret_cast<float4*>(x_s + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll 4
    for (int i = t; i < rows * mm; i += kThreads) x_s[i] = Num<T>::load(x[i]);
  }
  __syncthreads();

  // 2. inter = x @ A: block q of the cluster sums rows k0..k1 of A into
  //    part_s; every block then sums the kCluster shares in rank order
  {
    const int k0 = mm * q / kCluster, k1 = mm * (q + 1) / kCluster;
    float acc[R][VA];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int v = 0; v < VA; ++v) acc[i][v] = 0.f;
    int slices;
    if constexpr (VA == 4) {
      // thread on rank columns 4j..4j+3 (j = t % (r / 4)), slice t / (r / 4);
      // r / 4 divides 32, so a warp's slices share its columns
      const int groups = r / 4, j = t % groups;
      accumulate<T, 4, R>(acc, x_s + k0, mm, rows, a + (size_t)k0 * r, r, 4 * j, t / groups,
                          kThreads / groups, k1 - k0);
      warp_reduce<4, R>(acc, rows, groups);
      if (lane < groups) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (i < rows)
#pragma unroll
            for (int v = 0; v < 4; ++v) red_s[(warp * tb + i) * r + 4 * j + v] = acc[i][v];
      }
      slices = kWarps;
    } else {
      // thread on rank column j = t % r, slice t / r (r <= kThreads)
      const int j = t % r, s = t / r;
      slices = kThreads / r;
      if (s < slices) {
        accumulate<T, 1, R>(acc, x_s + k0, mm, rows, a + (size_t)k0 * r, r, j, s, slices,
                            k1 - k0);
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (i < rows) red_s[(s * tb + i) * r + j] = acc[i][0];
      }
    }
    __syncthreads();
    for (int idx = t; idx < rows * r; idx += kThreads) {
      float sum = 0.f;
      for (int ss = 0; ss < slices; ++ss) sum += red_s[ss * tb * r + idx];
      part_s[idx] = sum;
    }
    cluster.sync();  // every block's share is in its shared memory
    for (int idx = t; idx < rows * r; idx += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < kCluster; ++p) sum += cluster.map_shared_rank(part_s, p)[idx];
      inter_s[idx] = Num<T>::load(Num<T>::store(sum));  // rounded to Bm's dtype
    }
    __syncthreads();
  }

  // 3. x @ W0[:, c0:c0+16] + inter @ Bm[:, c0:c0+16]: thread on columns
  //    c0 + VW*c .. + VW-1 (c = t % groups), reduction slice t / groups
  constexpr int groups = kCols / VW;
  const int c = t % groups, s = t / groups;
  constexpr int slices = kThreads / groups;
  const int col = c0 + VW * c;
  float acc[R][VW];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[i][v] = 0.f;
  if (col < lm) {  // with VW = 4, lm % 4 == 0: the whole group is in range
    accumulate<T, VW, R>(acc, x_s, mm, rows, w0, lm, col, s, slices, mm);
    accumulate<T, VW, R>(acc, inter_s, r, rows, bm, lm, col, s, slices, r);
  }
  warp_reduce<VW, R>(acc, rows, groups);
  if (lane < groups) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < rows)
#pragma unroll
        for (int v = 0; v < VW; ++v) red_s[(warp * tb + i) * kCols + VW * c + v] = acc[i][v];
  }
  __syncthreads();

  for (int idx = t; idx < rows * kCols; idx += kThreads) {
    const int i = idx / kCols, cc = idx % kCols;
    const int oc = c0 + cc;
    if (oc >= lm) continue;
    float sum = Num<T>::load(b0[oc]) + Num<T>::load(d[oc]);
    for (int w = 0; w < kWarps; ++w) sum += red_s[(w * tb + i) * kCols + cc];
    out[(size_t)i * lm + oc] = Num<T>::store(gelu_tanh(sum));
  }
  cluster.sync();  // no block leaves while another may still read its part_s
}

template <typename T, int VW, int VA, int R>
int launch(const void* x, const void* w0, const void* b0, const void* a, const void* bm,
           const void* d, void* out, int G, int B, int mm, int lm, int r, int tb,
           cudaStream_t stream) {
  const size_t smem = ((size_t)tb * (mm + 2 * r) + (size_t)kThreads * tb) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      lora0_kernel<T, VW, VA, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (lm + kCols - 1) / kCols;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, (B + tb - 1) / tb, G);
  lora0_kernel<T, VW, VA, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(b0),
      static_cast<const T*>(a), static_cast<const T*>(bm), static_cast<const T*>(d),
      static_cast<T*>(out), B, mm, lm, r, tb);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T>
int dispatch(const void* x, const void* w0, const void* b0, const void* a, const void* bm,
             const void* d, void* out, int G, int B, int mm, int lm, int r, int tb,
             cudaStream_t s) {
  const size_t v4 = 4 * sizeof(T);
  const bool vw = mm % 4 == 0 && lm % 4 == 0 && aligned(x, v4) && aligned(w0, v4) &&
                  aligned(bm, v4);
  const bool va = (r == 4 || r == 8 || r == 16 || r == 32) && aligned(a, v4);
  if (vw && va) {  // the projector's widths and ranks: row tiles of 4, 8 and 16
    if (tb <= 4) return launch<T, 4, 4, 4>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
    if (tb <= 8) return launch<T, 4, 4, 8>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
    return launch<T, 4, 4, 16>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
  }
  if (vw) return launch<T, 4, 1, kMaxRows>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
  if (va) return launch<T, 1, 4, kMaxRows>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
  return launch<T, 1, 1, kMaxRows>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of the
// launch, 0 on success.  All tensors are contiguous and of one dtype.
extern "C" int dmi_lora0(const void* x, const void* w0, const void* b0, const void* a,
                         const void* bm, const void* d, void* out, int G, int B, int mm,
                         int lm, int r, int tb, int dtype, void* stream) {
  if (tb < 1 || tb > kMaxRows || r < 1 || r > kThreads || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32)
    return dispatch<float>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
  if (dtype == dmi::kBFloat16)
    return dispatch<__nv_bfloat16>(x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, s);
  return (int)cudaErrorInvalidValue;
}
