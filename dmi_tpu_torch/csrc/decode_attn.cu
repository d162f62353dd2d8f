// Single-token grouped-query decode attention for Hopper.
//
// Replaces the TPU kernel dmi_tpu/ops/pallas/decode_attn.py:_decode_attn_pallas
// (body _kernel), behind fused_decode_attention, and adds the score scale and
// the attention softcap that its oracle llama._decode_attention takes.
//
//   q [B, nh, 1, hd], k/v [B, nkv, S, hd] (rows contiguous, batch and head
//   strides free, so a view of the first S positions of a longer cache is
//   read in place), bias row [S] f32  ->  out [B, nh, 1, hd] in v's dtype.
//
// Math, as the Pallas body (decode_attn.py:55-64): s = (q . k) * scale with
// exact products and f32 sums, s = cap * tanh(s / cap) when a softcap is
// set, then s += bias (the softcap before the bias, as in the twin), p =
// exp(s - max s) in f32, out = (p . v) / sum p, rounded once to v's dtype.
//
// What bounds it on the H100: per layer of a decode step it reads the K and
// V cache once, 2 * B * nkv * S * hd elements (3 MB in bf16 at B 128, nkv 8,
// S 23, hd 64: 0.9 us at 3.35 TB/s), and does 4 * B * nh * S * hd FLOPs, g
// FLOPs per bf16 byte (4 at Llama-3.2-1B): device memory bounds it, and at
// caption lengths the latency of one block's chain of loads, products,
// reductions and barriers.  The first kernel gave every key a 5-step warp
// reduction (a serial chain of S of them a warp: 17.3-17.5 us at B 128, S
// 23, against 8.1-8.2 us for SDPA) and ran only B x nkv blocks however long
// the cache (16 at B 2: 1178-1201 us at S 3073, against 11.5-11.7 us).
//
// Both kernels below share the frame:
//   - A block owns one (batch row, kv head) and one split of the keys.  It
//     stages its K and V rows, chunk by chunk, into a ring of shared memory
//     by 16-byte cp.async copies (two stages when the split has more than
//     one chunk: the next chunk lands while this one is used), with the
//     chunk's bias, and keeps the online softmax's running max m, sum l and
//     accumulators (rescaled by exp(m_old - m_new), 0 on the first chunk).
//   - S split over blocks: when B x nkv blocks cannot fill the card, the
//     wrapper's plan (ops/cuda/decode_attn.py:plan) splits S; each split
//     writes its f32 partial (m, l, acc[hd]) per query head and merge_kernel
//     adds the splits in split order, each weighted by exp(m_i - max m), so
//     two calls are bit-equal (no float atomics).  A split whose keys all
//     carry the JAX loops' finfo.min bias has m = finfo.min, far below a
//     split with a real key, and gets weight 0 (exp underflows; no NaN);
//     when every key is masked all weights are 1, the uniform average that
//     a single softmax gives.  A chunk or split with m = -inf (a -inf bias
//     on every key so far) contributes p = 0, not exp(-inf + inf).  At the
//     serving shapes (B 64-256 x 8 kv heads, S <= 38) there is one split:
//     one launch, no merge.
// bf16 at hd <= 128 and group <= 16 (Llama-3.2-1B's serving path):
// decode_attn_mma_kernel, the group's heads as the rows of mma.sync tiles
// (below).  f32 (no TF32: it stays on FMAs), and bf16 at wider heads or
// groups: decode_attn_kernel on the CUDA cores, keys split across lanes:
// up to 4 lanes a key, each with every 4th (or 2nd) 16-byte slice of the
// row, form partial dot products for four query heads at a time (the
// group's heads share each staged K row) and a xor shuffle of up to two
// steps finishes them; a warp
// then takes one head's softmax update over the chunk; p . v runs over
// (query head, pair of hd) threads.  In bf16 at B 128, S 23 that design
// and a first tensor-core version with four warps a block both stayed above
// SDPA; per-block timestamps showed the latter's end (the warps' states
// combined through shared memory) as its longest phase, hence one warp a
// block for a split of one chunk.
// Measured by chip_smoke.py (device time per call, three runs, NVIDIA H100
// 80GB HBM3, 700.00 W): bf16, 32/8 heads, hd 64, B 128, S 23 7.22-7.25 us
// against 8.06-8.12 us for SDPA (bound 2.11 us); B 256, S 23 9.64-9.78
// against 13.31-13.36; B 64, S 37 7.60-7.64 against 7.61-7.67; B 2 with a
// finfo.min tail, S 3073 14.63-14.83 against 11.15-11.20 (49 splits merged)
// and S 16384 36.98-37.35 against 30.43-30.77 (32 splits).
#include <cuda_pipeline.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

using dmi::Num;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 256;
constexpr int kMaxGroup = 32;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on the H100
constexpr int kHeads = 4;         // query heads whose scores a lane forms together

template <typename T>
struct Vec;  // elements of one 16-byte copy, widened to f32
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(float (&f)[8], const __nv_bfloat16* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(float (&f)[4], const float* p) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  }
  static __device__ __forceinline__ float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

struct Params {
  const void *q, *k, *v;
  const float* bias;
  void* out;
  float* part;  // splits > 1: m [B * nh, splits], l [B * nh, splits], acc [B * nh, splits, hd]
  int nkv, group, S, hd, chunk, keys_per_split, splits, stages;
  bool vec;  // hd a multiple of the 16-byte vector, every q, K and V row 16-byte aligned
  long long k_sb, k_sh, v_sb, v_sh;
  float scale, softcap;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Layout of the dynamic shared memory, in bytes from its start: the K and V
// stages ([stages][2][chunk][width] of T, width = hd rounded up to the
// 16-byte vector, zeros past hd), the bias stages ([stages][chunk] f32), q
// ([group][width] f32), the scores ([group][chunk] f32) and m, l, alpha
// ([group] f32 each).  Mirrored by ops/cuda/decode_attn.py:smem_bytes.
struct Layout {
  int width, bias, q, sc, stats, total;
  __host__ __device__ Layout(int itemsize, int group, int hd, int chunk, int stages) {
    width = round_up(hd, 16 / itemsize);
    bias = stages * 2 * chunk * width * itemsize;
    q = bias + round_up(stages * chunk, 4) * 4;
    sc = q + group * width * 4;
    stats = sc + group * chunk * 4;
    total = stats + 3 * group * 4;
  }
};

// Keys [c0, c0 + n) of this block's kv head into a stage of K and V, and
// their bias values into bs.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* ks, T* vs, float* bs, const T* kh, const T* vh,
                                            const float* bias, int c0, int n, int hd, int width,
                                            bool vec) {
  constexpr int kV = Vec<T>::kN;
  for (int j = threadIdx.x; j < n; j += kThreads)
    __pipeline_memcpy_async(bs + j, bias + c0 + j, 4);
  if (vec) {  // width == hd: a K and a V copy of 16 bytes per step
    const int per_row = hd / kV, shift = 31 - __clz(per_row);
    const bool pow2 = per_row == 1 << shift;  // hd 8, 16, .. 256 in bf16: no division
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int r = pow2 ? i >> shift : i / per_row;
      const int c = (pow2 ? i & (per_row - 1) : i % per_row) * kV;
      const size_t at = (size_t)(c0 + r) * hd + c;
      __pipeline_memcpy_async(ks + r * width + c, kh + at, 16);
      __pipeline_memcpy_async(vs + r * width + c, vh + at, 16);
    }
  } else {  // element by element, zeros past hd
    for (int i = threadIdx.x; i < n * width; i += kThreads) {
      const int r = i / width, c = i % width;
      const size_t at = (size_t)(c0 + r) * hd + c;
      ks[i] = c < hd ? kh[at] : Num<T>::store(0.f);
      vs[i] = c < hd ? vh[at] : Num<T>::store(0.f);
    }
  }
}

// One block per (batch row x kv head, split); kPP (query head, hd pair)
// accumulators per thread, kPP * kThreads >= group * ceil(hd / 2).  At most
// 64 registers a thread for kPP <= 4, so that 8 blocks fit an SM: the
// serving shape's 1024 blocks then run in one wave.
template <typename T, int kPP>
__global__ void __launch_bounds__(kThreads, kPP <= 4 ? 8 : 1) decode_attn_kernel(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kV = Vec<T>::kN;
  const int b = blockIdx.x / a.nkv, kvh = blockIdx.x % a.nkv, split = blockIdx.y;
  const int g = a.group, hd = a.hd, chunk = a.chunk;
  const Layout lay(sizeof(T), g, hd, chunk, a.stages);
  const int width = lay.width;
  T* kv_s = reinterpret_cast<T*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;
  const int nh = a.nkv * g;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int s0 = split * a.keys_per_split;
  const int s1 = min(a.S, s0 + a.keys_per_split);
  const int n_chunks = (s1 - s0 + chunk - 1) / chunk;  // >= 1: no split is empty
  auto k_buf = [&](int st) { return kv_s + (size_t)(2 * st) * chunk * width; };
  auto v_buf = [&](int st) { return kv_s + (size_t)(2 * st + 1) * chunk * width; };

  stage_chunk<T>(k_buf(0), v_buf(0), bias_s, kh, vh, a.bias, s0, min(chunk, s1 - s0), hd, width,
                 a.vec);
  __pipeline_commit();
  // q while the first chunk is in flight
  const T* qb = static_cast<const T*>(a.q) + ((size_t)b * nh + kvh * g) * hd;
  if (a.vec) {
    const int per_row = hd / kV;
    for (int i = threadIdx.x; i < g * per_row; i += kThreads) {
      const int h = i / per_row, d = (i % per_row) * kV;
      float f[kV];
      Vec<T>::load(f, qb + h * hd + d);
#pragma unroll
      for (int e = 0; e < kV; ++e) q_s[h * width + d + e] = f[e];
    }
  } else {
    for (int i = threadIdx.x; i < g * width; i += kThreads) {
      const int h = i / width, d = i % width;
      q_s[i] = d < hd ? Num<T>::load(qb[h * hd + d]) : 0.f;
    }
  }
  for (int h = threadIdx.x; h < g; h += kThreads) m_s[h] = -INFINITY, l_s[h] = 0.f;

  // lanes per key (lpk): up to 4, each with every lpk-th 16-byte slice of the row
  const int nv = width / kV;
  const int lpk_log = nv >= 4 ? 2 : nv >= 2 ? 1 : 0;
  const int lpk = 1 << lpk_log, slot = threadIdx.x & (lpk - 1);
  const int hp = (hd + 1) / 2;  // hd pairs
  float acc[kPP][2];
#pragma unroll
  for (int i = 0; i < kPP; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = s0 + c * chunk, n = min(chunk, s1 - c0);
    __pipeline_wait_prior(0);
    __syncthreads();  // chunk c has landed; every thread is done with chunk c - 1
    if (c + 1 < n_chunks) {
      const int st = (c + 1) & 1;
      stage_chunk<T>(k_buf(st), v_buf(st), bias_s + st * chunk, kh, vh, a.bias, c0 + chunk,
                     min(chunk, s1 - c0 - chunk), hd, width, a.vec);
    }
    __pipeline_commit();
    const int cur = a.stages == 2 ? c & 1 : 0;
    const T* ks = k_buf(cur);
    const T* vs = v_buf(cur);
    const float* bc = bias_s + cur * chunk;

    // scores: lpk lanes a key, kThreads / lpk keys a pass, kHeads heads at once
    for (int j0 = 0; j0 < n; j0 += kThreads >> lpk_log) {
      const int j = j0 + (threadIdx.x >> lpk_log);
      const T* kr = ks + (j < n ? j : 0) * width;  // lanes past n write nothing
      for (int h0 = 0; h0 < g; h0 += kHeads) {
        float part[kHeads];
#pragma unroll
        for (int i = 0; i < kHeads; ++i) part[i] = 0.f;
        for (int vv = slot; vv < nv; vv += lpk) {
          float kf[kV];
          Vec<T>::load(kf, kr + vv * kV);
#pragma unroll
          for (int i = 0; i < kHeads; ++i) {
            if (h0 + i < g) {
              const float* qv = q_s + (h0 + i) * width + vv * kV;
#pragma unroll
              for (int e = 0; e < kV; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qv + e);
                part[i] = fmaf(q4.x, kf[e], part[i]);
                part[i] = fmaf(q4.y, kf[e + 1], part[i]);
                part[i] = fmaf(q4.z, kf[e + 2], part[i]);
                part[i] = fmaf(q4.w, kf[e + 3], part[i]);
              }
            }
          }
        }
        for (int o = lpk >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < kHeads; ++i) part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
        if (slot == 0 && j < n) {
#pragma unroll
          for (int i = 0; i < kHeads; ++i) {
            if (h0 + i < g) {
              float sv = part[i] * a.scale;
              if (a.softcap > 0.f) sv = a.softcap * tanhf(sv / a.softcap);
              sc[(h0 + i) * chunk + j] = sv + bc[j];
            }
          }
        }
      }
    }
    __syncthreads();

    // the online softmax: one warp a query head
    for (int h = warp; h < g; h += kWarps) {
      float* row = sc + h * chunk;
      float mc = -INFINITY;
      for (int j = lane; j < n; j += 32) mc = fmaxf(mc, row[j]);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, dmi::warp_max(mc));
      float part = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = m_new == -INFINITY ? 0.f : expf(row[j] - m_new);
        row[j] = p;
        part += p;
      }
      part = dmi::warp_sum(part);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + part;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // p . v over (query head, hd pair)
#pragma unroll
    for (int i = 0; i < kPP; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int h = p / hp, d = 2 * (p % hp);
      if (h < g) {
        const float alpha = alpha_s[h];
        float a0 = acc[i][0] * alpha, a1 = acc[i][1] * alpha;
        const float* pr = sc + h * chunk;
        const T* vc = vs + d;
        int j = 0;
        for (; j + 4 <= n; j += 4) {  // four keys' p in one read (rows start 16-byte aligned)
          const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 vv = Vec<T>::pair(vc + (j + e) * width);
            a0 = fmaf(pj[e], vv.x, a0);
            a1 = fmaf(pj[e], vv.y, a1);
          }
        }
        for (; j < n; ++j) {
          const float2 vv = Vec<T>::pair(vc + j * width);
          a0 = fmaf(pr[j], vv.x, a0);
          a1 = fmaf(pr[j], vv.y, a1);
        }
        acc[i][0] = a0, acc[i][1] = a1;
      }
    }
  }
  // no barrier: m_s and l_s were last written before the last chunk's p . v

  const size_t row0 = (size_t)b * nh + kvh * g;  // this block's first query head
  const size_t rows = (size_t)gridDim.x / a.nkv * nh;
  float* part_m = a.part;
  float* part_l = part_m + rows * a.splits;
  float* part_acc = part_l + rows * a.splits;
#pragma unroll
  for (int i = 0; i < kPP; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int h = p / hp, d = 2 * (p % hp);
    if (h >= g) continue;
    if (a.splits == 1) {
      T* o = static_cast<T*>(a.out) + (row0 + h) * hd + d;
      const float l = l_s[h];
      o[0] = Num<T>::store(acc[i][0] / l);
      if (d + 1 < hd) o[1] = Num<T>::store(acc[i][1] / l);
    } else {
      float* o = part_acc + ((row0 + h) * a.splits + split) * hd + d;
      o[0] = acc[i][0];
      if (d + 1 < hd) o[1] = acc[i][1];
    }
  }
  if (a.splits > 1)
    for (int h = threadIdx.x; h < g; h += kThreads) {
      part_m[(row0 + h) * a.splits + split] = m_s[h];
      part_l[(row0 + h) * a.splits + split] = l_s[h];
    }
}

// ---- bf16 at hd <= 128 and group <= 16: the products on the tensor cores ----
//
// The group's query heads are the 16 rows of an mma.sync m16n8k16 tile
// (rows past the group are zeros, never written), so one warp's product
// with 16 staged keys is kD x 2 mmas for the scores and kD x 4 for p . v,
// with the fragment routines of the flash kernels (csrc/flash_mma.cuh): Q
// fragments in registers, K rows by ldmatrix, V rows by ldmatrix.trans, K
// and V tiles at a pitch of 16 kD + 8 elements. The 16-key tiles of a
// chunk are dealt to the block's warps (one warp when the split is one
// chunk, four over 64-key chunks); each warp keeps its own online softmax
// (m, l and the 16 x hd accumulators, as the C fragments) over its tiles,
// and at the end four warps' states are combined in warp order through
// shared memory, one warp's written from its registers: no barrier per
// chunk beyond the ring's. Scores and p stay f32 (exp2 on the SFU, 2^-22
// relative); p enters p . v as two bf16 terms, hi = bf16(p) and lo =
// bf16(p - hi), so that the product sees 16 significant bits of each
// weight (error below 2^-16 of it, far inside the output's bf16 rounding)
// where one bf16 rounding would keep 8: the TPU kernel multiplies V by f32
// p.
template <int kD>
__global__ void __launch_bounds__(kThreads) decode_attn_mma_kernel(const Params a) {
  using dmi::flash::bf16;
  constexpr int kLd = kD * 16 + 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, chunk = a.chunk;  // chunk: 16-key tiles, dealt to the warps
  const int b = blockIdx.x / a.nkv, kvh = blockIdx.x % a.nkv, split = blockIdx.y;
  const int g = a.group, hd = a.hd, nh = a.nkv * g;
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [16][kLd]
  bf16* sKV = sQ + 16 * kLd;                 // [stages][K, V][chunk][kLd]
  float* sB = reinterpret_cast<float*>(sKV + a.stages * 2 * chunk * kLd);  // [stages][chunk]
  const bf16* kh = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vh = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int s0 = split * a.keys_per_split;
  const int s1 = min(a.S, s0 + a.keys_per_split);
  const int n_chunks = (s1 - s0 + chunk - 1) / chunk;  // >= 1: no split is empty
  auto k_buf = [&](int st) { return sKV + (size_t)(2 * st) * chunk * kLd; };
  auto v_buf = [&](int st) { return sKV + (size_t)(2 * st + 1) * chunk * kLd; };
  // keys [c0, c0 + chunk) into stage st (rows at or past s1 are zeros) and
  // their bias values
  auto stage = [&](int st, int c0) {
    for (int t = 0; t < chunk / 16; ++t) {
      dmi::flash::stage_rows<kD, 16>(k_buf(st) + t * 16 * kLd, kh, hd, c0 + 16 * t, s1, hd,
                                     a.vec, threadIdx.x, blockDim.x);
      dmi::flash::stage_rows<kD, 16>(v_buf(st) + t * 16 * kLd, vh, hd, c0 + 16 * t, s1, hd,
                                     a.vec, threadIdx.x, blockDim.x);
    }
    for (int j = threadIdx.x; j < min(chunk, s1 - c0); j += blockDim.x)
      __pipeline_memcpy_async(sB + st * chunk + j, a.bias + c0 + j, 4);
  };
  const bf16* qb = static_cast<const bf16*>(a.q) + ((size_t)b * nh + kvh * g) * hd;
  dmi::flash::stage_rows<kD, 16>(sQ, qb, hd, 0, g, hd, a.vec, threadIdx.x, blockDim.x);
  stage(0, s0);
  __pipeline_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tig = lane & 3;
  uint32_t qf[kD][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[2 * kD][4];
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = s0 + c * chunk;
    __pipeline_wait_prior(0);
    __syncthreads();  // chunk c (and Q) have landed; every warp is done with chunk c - 1
    if (c + 1 < n_chunks) stage((c + 1) & 1, c0 + chunk);
    __pipeline_commit();
    if (c == 0) {
#pragma unroll
      for (int kd = 0; kd < kD; ++kd)
        dmi::flash::ldsm_x4(qf[kd], sQ + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + kd * 16 +
                                        (lane >> 4) * 8);
    }
    const int cur = a.stages == 2 ? c & 1 : 0;
    for (int t = warp; t < chunk / 16; t += nw) {  // the warp's 16-key tiles of the chunk
    const int nk = min(16, s1 - (c0 + 16 * t));    // keys of the tile
    if (nk <= 0) break;
    const bf16* ks = k_buf(cur) + 16 * t * kLd;
    const bf16* vs = v_buf(cur) + 16 * t * kLd;
    const float* bs = sB + cur * chunk + 16 * t;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kD; ++kd) {
      uint32_t kb[4];
      dmi::flash::ldsm_x4(kb, ks + ((lane & 7) + (lane >> 4) * 8) * kLd + kd * 16 +
                                  ((lane >> 3) & 1) * 8);
      dmi::flash::mma_bf16(s[0], qf[kd], kb[0], kb[1]);
      dmi::flash::mma_bf16(s[1], qf[kd], kb[2], kb[3]);
    }
    // element e of tile j: head row gq + 8 (e / 2), key j * 8 + 2 tig + e % 2;
    // keys past the split are -inf (p = 0 even where every key carries finfo.min)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + tig * 2 + (e & 1);
        float x = s[j][e] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        x = key < nk ? x + bs[key] : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0, not NaN
      const float alpha = dmi::flash::exp2_approx((m[r] - m_use[r]) * kLog2e);  // 0 at -inf
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 2 * kD; ++n) o[n][2 * r] *= alpha, o[n][2 * r + 1] *= alpha;
    }
    uint32_t ph[4], pl[4];  // p as A fragments, hi and lo
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = i >> 1, ee = (i & 1) * 2 + e;
        p2[e] = dmi::flash::exp2_approx((s[j][ee] - m_use[ee >> 1]) * kLog2e);
        l[ee >> 1] += p2[e];
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p2[0], p2[1]);
      const float2 hf = __bfloat1622float2(hi);
      ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[i] = dmi::flash::pack_bf16(p2[0] - hf.x, p2[1] - hf.y);
    }
#pragma unroll
    for (int dp = 0; dp < kD; ++dp) {
      uint32_t vb[4];
      dmi::flash::ldsm_x4_trans(vb, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dp * 16 +
                                        (lane >> 4) * 8);
      dmi::flash::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
      dmi::flash::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
      dmi::flash::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
      dmi::flash::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
    }
    }
  }

  // the rows' sums over the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t row0 = (size_t)b * nh + kvh * g;
  const size_t rows = (size_t)gridDim.x / a.nkv * nh;
  float* part_m = a.part;
  float* part_l = part_m + rows * a.splits;
  float* part_acc = part_l + rows * a.splits;
  if (nw == 1) {  // one warp: its fragments are the block's state
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = gq + 8 * r;
      if (row >= g) continue;
      const size_t at = (row0 + row) * a.splits + split;
#pragma unroll
      for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + tig * 2 + e;
          if (col >= hd) continue;
          if (a.splits == 1)
            static_cast<bf16*>(a.out)[(row0 + row) * hd + col] =
                __float2bfloat16(o[n][2 * r + e] / l[r]);
          else
            part_acc[at * hd + col] = o[n][2 * r + e];
        }
      if (a.splits > 1 && tig == 0) part_m[at] = m[r], part_l[at] = l[r];
    }
    return;
  }
  // Several warps: their states through shared memory (over the K/V
  // stages), weighted by w = exp(m_warp - max m) and added in warp order
  __syncthreads();  // every warp is done with the K/V stages
  float* sml = reinterpret_cast<float*>(sKV);  // [nw][m, l][16], then [nw][16] weights, [16] den
  float* so = sml + nw * 48 + 16;              // [nw][16][hd] o
  if (tig == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sml[warp * 32 + gq + 8 * r] = m[r];
      sml[warp * 32 + 16 + gq + 8 * r] = l[r];
    }
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + tig * 2 + (e & 1);
      if (col < hd) so[(warp * 16 + gq + 8 * (e >> 1)) * hd + col] = o[n][e];
    }
  __syncthreads();
  float* wts = sml + nw * 32;
  for (int h = threadIdx.x; h < g; h += blockDim.x) {
    float mx = -INFINITY, den = 0.f;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, sml[w * 32 + h]);
    for (int w = 0; w < nw; ++w) {
      const float mw = sml[w * 32 + h];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - mx);
      wts[w * 16 + h] = wt;
      den = fmaf(wt, sml[w * 32 + 16 + h], den);
    }
    wts[nw * 16 + h] = den;
    if (a.splits > 1) {
      const size_t at = (row0 + h) * a.splits + split;
      part_m[at] = mx, part_l[at] = den;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    const int h = i / hd, d = i - h * hd;
    float num = 0.f;
    for (int w = 0; w < nw; ++w) num = fmaf(wts[w * 16 + h], so[(w * 16 + h) * hd + d], num);
    if (a.splits == 1)
      static_cast<bf16*>(a.out)[(row0 + h) * hd + d] = __float2bfloat16(num / wts[nw * 16 + h]);
    else
      part_acc[((row0 + h) * a.splits + split) * hd + d] = num;
  }
}

constexpr int kMergeThreads = 256;
constexpr int kMaxSplits = 4096;  // the merge keeps every split's weight in shared memory

// out[r, d] = sum_i w_i acc_i[d] / sum_i w_i l_i over the splits i, w_i =
// exp(m_i - max m) (0 where m_i = -inf); one block per row r of the [B * nh]
// query heads.  The max over the splits is a block reduction and each
// split's weight is computed once; then G = 256 / hd groups of hd threads
// each add one contiguous range of splits in order, and the groups' sums
// are added in group order: a fixed order, so two calls are bit-equal.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const float* __restrict__ part, T* __restrict__ out, int rows, int splits,
                 int hd) {
  extern __shared__ float merge_s[];  // [splits] weights, [G][hd + 1] sums, [8] warp maxima
  const size_t r = blockIdx.x;
  const float* pm = part + r * splits;
  const float* pl = part + ((size_t)rows + r) * splits;
  const float* pa = part + (size_t)2 * rows * splits + r * splits * hd;
  const int groups = max(1, kMergeThreads / hd), per = (splits + groups - 1) / groups;
  float* w_s = merge_s;
  float* sums = w_s + splits;  // group g: hd numerators, then its denominator
  float* wmax = sums + groups * (hd + 1);
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < splits; i += kMergeThreads) mx = fmaxf(mx, pm[i]);
  mx = dmi::warp_max(mx);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = wmax[0];
  for (int w = 1; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, wmax[w]);
  for (int i = threadIdx.x; i < splits; i += kMergeThreads)
    w_s[i] = pm[i] == -INFINITY ? 0.f : expf(pm[i] - mx);
  __syncthreads();
  const int grp = threadIdx.x / hd, d = threadIdx.x % hd;
  if (grp < groups) {
    float num = 0.f, den = 0.f;
    const int i1 = min(splits, (grp + 1) * per);
#pragma unroll 8
    for (int i = grp * per; i < i1; ++i) {
      const float w = w_s[i];
      den = fmaf(w, pl[i], den);
      num = fmaf(w, pa[(size_t)i * hd + d], num);
    }
    sums[grp * (hd + 1) + d] = num;
    if (d == 0) sums[grp * (hd + 1) + hd] = den;
  }
  __syncthreads();
  for (int dd = threadIdx.x; dd < hd; dd += kMergeThreads) {
    float num = 0.f, den = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      num += sums[gi * (hd + 1) + dd];
      den += sums[gi * (hd + 1) + hd];
    }
    out[r * hd + dd] = Num<T>::store(num / den);
  }
}

template <typename T>
int launch_merge(const Params& a, int B, cudaStream_t stream) {
  const int rows = B * a.nkv * a.group;
  const int groups = std::max(1, kMergeThreads / a.hd);
  const size_t smem = (a.splits + groups * (a.hd + 1) + kMergeThreads / 32) * sizeof(float);
  merge_kernel<T><<<rows, kMergeThreads, smem, stream>>>(a.part, static_cast<T*>(a.out), rows,
                                                         a.splits, a.hd);
  return (int)cudaGetLastError();
}

template <typename K>
int launch_kernel(K kernel, const Params& a, int B, int threads, int smem, cudaStream_t stream) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B * a.nkv, a.splits), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The CUDA-core kernel: kPP (query head, hd pair) accumulators a thread
template <typename T>
int launch_fma(const Params& a, int B, cudaStream_t stream) {
  const int smem = Layout(sizeof(T), a.group, a.hd, a.chunk, a.stages).total;
  const int pairs = a.group * ((a.hd + 1) / 2);
  auto run = [&](auto kernel) { return launch_kernel(kernel, a, B, kThreads, smem, stream); };
  if (pairs <= kThreads) return run(decode_attn_kernel<T, 1>);
  if (pairs <= 2 * kThreads) return run(decode_attn_kernel<T, 2>);
  if (pairs <= 4 * kThreads) return run(decode_attn_kernel<T, 4>);
  if (pairs <= 8 * kThreads) return run(decode_attn_kernel<T, 8>);
  if (pairs <= 16 * kThreads) return run(decode_attn_kernel<T, 16>);
  return run(decode_attn_kernel<T, 32>);
}

// The tensor-core kernel at hd <= 16 kD: Q, the K and V stages, the bias
// stages (the warps' states reuse the K and V stages at the end)
template <int kD>
int launch_mma(const Params& a, int B, int warps, cudaStream_t stream) {
  const int smem = (16 + a.stages * 2 * a.chunk) * (kD * 16 + 8) * 2 + a.stages * a.chunk * 4;
  return launch_kernel(decode_attn_mma_kernel<kD>, a, B, 32 * warps, smem, stream);
}

int launch_bf16_mma(const Params& a, int B, int warps, cudaStream_t stream) {
  if (a.hd <= 16) return launch_mma<1>(a, B, warps, stream);
  if (a.hd <= 32) return launch_mma<2>(a, B, warps, stream);
  if (a.hd <= 48) return launch_mma<3>(a, B, warps, stream);
  if (a.hd <= 64) return launch_mma<4>(a, B, warps, stream);
  if (a.hd <= 96) return launch_mma<6>(a, B, warps, stream);
  return launch_mma<8>(a, B, warps, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). The plan (chunk, keys_per_split,
// splits, stages, warps) comes from ops/cuda/decode_attn.py:plan: splits of
// keys_per_split keys tile [0, S), none empty; chunk is a multiple of 16; one
// stage only where a split is one chunk. bf16 at hd <= 128 and group <= 16
// runs on the tensor cores with `warps` warps (at most one per 16-key tile of
// a chunk of at most 64 keys); every other call (f32 always) on the CUDA
// cores, with warps = 4. Strides are in elements; a softcap <= 0 means none.
// Rows move by 16-byte copies when hd is a multiple of the 16-byte vector and
// every q, K and V row is 16-byte aligned, else element by element. part
// (f32, splits > 1 only) is scratch of B * nh * splits * (hd + 2) floats the
// caller allocates. Returns the CUDA error code of the first failed launch.
extern "C" int dmi_decode_attn(const void* q, const void* k, const void* v, const void* bias,
                               void* out, void* part, int B, int nkv, int group, int S, int hd,
                               int chunk, int keys_per_split, int splits, int stages, int warps,
                               long long k_sb, long long k_sh, long long v_sb, long long v_sh,
                               float scale, float softcap, int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHd || group < 1 || group > kMaxGroup || S < 1 || chunk < 16 ||
      chunk % 16 || keys_per_split < 1 || splits < 1 || splits > kMaxSplits ||
      (long long)splits * keys_per_split < S || (long long)(splits - 1) * keys_per_split >= S ||
      stages < 1 || stages > 2 || (stages == 1 && std::min(keys_per_split, S) > chunk) ||
      (splits > 1 && part == nullptr) || (long long)B * nkv > 0x7fffffffLL ||
      (dtype != dmi::kFloat32 && dtype != dmi::kBFloat16))
    return (int)cudaErrorInvalidValue;
  const bool mma = dtype == dmi::kBFloat16 && hd <= 128 && group <= 16;
  if (mma ? warps < 1 || warps > kWarps || 16 * warps > chunk || chunk > 64 : warps != kWarps)
    return (int)cudaErrorInvalidValue;
  const int vn = dtype == dmi::kFloat32 ? 4 : 8;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hd % vn == 0 && aligned(q) && aligned(k) && aligned(v) && k_sb % vn == 0 &&
                   k_sh % vn == 0 && v_sb % vn == 0 && v_sh % vn == 0;
  Params a{q, k, v, static_cast<const float*>(bias), out, static_cast<float*>(part), nkv, group,
           S, hd, chunk, keys_per_split, splits, stages, vec, k_sb, k_sh, v_sb, v_sh, scale,
           softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (mma) e = launch_bf16_mma(a, B, warps, s);
  else if (dtype == dmi::kFloat32) e = launch_fma<float>(a, B, s);
  else e = launch_fma<__nv_bfloat16>(a, B, s);
  if (e != 0 || splits == 1) return e;
  return dtype == dmi::kFloat32 ? launch_merge<float>(a, B, s)
                                : launch_merge<__nv_bfloat16>(a, B, s);
}
