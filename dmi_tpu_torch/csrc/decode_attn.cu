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
// Math, all in f32 as the Pallas body (decode_attn.py:55-64): q and k are
// widened before the product, s = (q . k) * scale, s = cap * tanh(s / cap)
// when a softcap is set, s += bias, p = exp(s - max s), out = (p . v) / sum p.
//
// What bounds it on the H100: per layer of a decode step it reads the K and
// V cache once, 2 * B * nkv * S * hd elements (5 MB in bf16 at B = 128,
// nkv = 8, S = 38, hd = 64) and does 4 * B * nh * S * hd FLOPs, g FLOPs per
// bf16 byte (4 at 1B), below the card's f32 ridge of ~20 FLOP/byte (67
// TFLOP/s over 3.35 TB/s, NVIDIA's data sheet), so
// device memory bandwidth bounds it; at caption lengths it
// is so short that launch latency is its real cost.  On the TPU this kernel
// stayed unwired because the pallas_call boundary forced a layout conversion
// of the cache; here the kernel reads the batch-first cache as it lies.
// Design: one block per (batch row, kv head), one warp per query head of the
// group (g = 4 at Llama-3.2-1B); lanes span hd, so each key and value row is
// one coalesced read, shared by the group's warps through L1.  The keys go
// by chunks of `chunk` positions: a warp writes the chunk's scores into its
// own row of shared memory ([g, chunk] f32, at most 48 KB, so no launch
// needs to opt in to more), takes the chunk's max, rescales its running sum
// and [hd] accumulator by exp(m_old - m_new) and adds the chunk's
// exp(s - m_new) and p . v, as an online softmax does.  So S has no cap: a
// cache of any length streams through a fixed chunk.  When S fits one chunk
// (S <= 3072 at g = 4, every serving shape) the rescale multiplies zeros by
// alpha = 0 and the kernel computes what a single pass over the scores
// does.  A chunk whose keys all carry a finfo.min bias gives p = 0 against
// an earlier finite max, and an earlier such chunk is wiped by the later
// alpha = 0: no NaN either way.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dmi::Num;

constexpr int kMaxHdPerLane = 8;     // hd <= 256
constexpr int kScoreFloats = 12288;  // scores of a block's chunk: 48 KB of f32

template <typename T>
__global__ void decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const float* __restrict__ bias,
                                   T* __restrict__ out, int nkv, int group, int S, int hd,
                                   int chunk, long long k_sb, long long k_sh, long long v_sb,
                                   long long v_sh, float scale, float softcap) {
  extern __shared__ float scores[];  // [group, chunk]
  const int b = blockIdx.x / nkv;
  const int kvh = blockIdx.x % nkv;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nh = nkv * group;
  const int h = kvh * group + w;
  const T* qh = q + ((size_t)b * nh + h) * hd;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  float* sc = scores + (size_t)w * chunk;

  float qv[kMaxHdPerLane], acc[kMaxHdPerLane];
#pragma unroll
  for (int i = 0; i < kMaxHdPerLane; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < hd ? Num<T>::load(qh[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, denom = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int n = min(chunk, S - c0);
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const T* kr = kb + (size_t)(c0 + s) * hd;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxHdPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part = fmaf(qv[i], Num<T>::load(kr[d]), part);
      }
      part = dmi::warp_sum(part);
      if (lane == 0) {
        float sv = part * scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        sc[s] = sv + bias[c0 + s];
      }
    }
    __syncwarp();

    float mc = -INFINITY;
    for (int s = lane; s < n; s += 32) mc = fmaxf(mc, sc[s]);
    const float m_new = fmaxf(m, dmi::warp_max(mc));
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);  // 0 on the first chunk
    float part = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float p = expf(sc[s] - m_new);
      sc[s] = p;
      part += p;
    }
    denom = denom * alpha + dmi::warp_sum(part);
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < kMaxHdPerLane; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float p = sc[s];
      const T* vr = vb + (size_t)(c0 + s) * hd;
#pragma unroll
      for (int i = 0; i < kMaxHdPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc[i] = fmaf(p, Num<T>::load(vr[d]), acc[i]);
      }
    }
    __syncwarp();  // the next chunk's scores overwrite sc
  }
  T* oh = out + ((size_t)b * nh + h) * hd;
#pragma unroll
  for (int i = 0; i < kMaxHdPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) oh[d] = Num<T>::store(acc[i] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int nkv, int group, int S, int hd, int chunk, long long k_sb, long long k_sh,
           long long v_sb, long long v_sh, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = (size_t)group * chunk * sizeof(float);
  decode_attn_kernel<T><<<B * nkv, group * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), nkv, group, S, hd, chunk, k_sb,
      k_sh, v_sb, v_sh, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  `chunk` is the keys per
// chunk (ops/cuda/decode_attn.py:score_chunk); strides are in elements; a
// softcap <= 0 means none.  Returns the CUDA error code of the launch.
extern "C" int dmi_decode_attn(const void* q, const void* k, const void* v, const void* bias,
                               void* out, int B, int nkv, int group, int S, int hd, int chunk,
                               long long k_sb, long long k_sh, long long v_sb, long long v_sh,
                               float scale, float softcap, int dtype, void* stream) {
  if (hd > 32 * kMaxHdPerLane || group < 1 || group > 32 || chunk < 1 ||
      group * chunk > kScoreFloats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32)
    return launch<float>(q, k, v, bias, out, B, nkv, group, S, hd, chunk, k_sb, k_sh, v_sb,
                         v_sh, scale, softcap, s);
  if (dtype == dmi::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, bias, out, B, nkv, group, S, hd, chunk, k_sb, k_sh,
                                 v_sb, v_sh, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
