// Causal flash attention, forward, for Hopper.
//
// Replaces the TPU kernel `_flash_attention_impl` of jax's
// jax/experimental/pallas/ops/tpu/flash_attention.py (pallas_call at :758),
// which dmi_tpu/models/llama.py:_flash_attention (:1086) runs on every layer
// of the training forward, behind dmi_tpu_torch/ops/cuda/flash_attn.py.
//
//   out[b, h, i] = sum_j p_ij v[b, h / group, j] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i),  s_ij = scale * q_i . k_j,
//
// over the keys j <= i whose key-mask entry is 1 (the TPU wrapper's kv
// segment ids; queries are never masked).  Scores, the running max m, the
// running sum l and the output accumulator are f32; p is rounded to v's
// dtype before the p . v product, as the TPU kernel does.  lse = m + log l
// is saved for the backward.  A row with no key to attend writes zeros and
// lse = -inf.  Any T: the last tile is ragged and masked here, with no
// padding to a multiple of the tile and no copy.
//
// What bounds it on the H100: the stage-1 shapes (B 32, 32 heads, T 65,
// hd 64) do 4 B nh T^2 hd = 1.1 GFLOP per layer against 17 MB of q/k/v/o in
// bf16, and it runs on the CUDA cores, reading both operands of every FMA
// from shared memory: shared-memory bandwidth bounds it, far below the
// tensor cores (wgmma and TMA are later work).  Design: one block per
// (query tile of 64 rows, head, batch row); the block walks the key tiles at
// or before its query tile (causal), stages K and V in shared memory,
// computes its 64 x 64 score tile (4 x 4 per thread), updates each row's
// max and sum with 16-lane shuffles, stages p, and accumulates p . v into
// registers.  The 64 x 64 tile against a 128 x 128 one on the TPU keeps
// 2048 blocks in flight at the stage-1 shapes.
#include "flash_attn.cuh"

namespace {

using dmi::Num;
using namespace dmi::flash;

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int pitch = a.hd + 1;
  float* sQ = smem;                  // [64, hd + 1]
  float* sK = sQ + kTile * pitch;    // [64, hd + 1]
  float* sV = sK + kTile * pitch;    // [64, hd + 1]
  float* sP = sV + kTile * pitch;    // [64, 65]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;
  const T* qh = static_cast<const T*>(a.q) + b * a.q_s.b + h * a.q_s.h;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_s.b + kvh * a.k_s.h;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_s.b + kvh * a.v_s.h;
  const int* km = a.key_mask ? a.key_mask + (size_t)b * a.T : nullptr;

  load_tile<T>(sQ, qh, a.q_s.t, q0, a.T, a.hd);

  float m[4], l[4], acc[4][kMaxC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {  // causal: no key tile after the query tile
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK, sV and sP are read
    load_tile<T>(sK, kh, a.k_s.t, k0, a.T, a.hd);
    load_tile<T>(sV, vh, a.v_s.t, k0, a.T, a.hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < a.hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * pitch + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * pitch + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = attends(row, k0 + tx + 16 * c, a.T, km);
        s[i][c] = ok[c] ? s[i][c] * a.scale : kMaskValue;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += p;
        sP[(ty + 16 * i) * kPitchS + tx + 16 * c] = rounded<T>(p);
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int n_keys = min(kTile, a.T - k0);
    for (int j = 0; j < n_keys; ++j) {
      float vv[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < a.hd ? sV[j * pitch + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * kPitchS + j];
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* oh = static_cast<T*>(a.o) + b * a.o_s.b + h * a.o_s.h;
  float* lse = a.lse_out + ((size_t)b * a.nh + h) * a.T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.T) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no key: zeros, not NaN
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) oh[row * a.o_s.t + d] = Num<T>::store(acc[i][c] * inv);
    }
    if (tx == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int pitch = a.hd + 1;
  const size_t smem = (size_t)(3 * kTile * pitch + kTile * kPitchS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.nh, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  strides holds 12 element
// strides: (batch, head, row) of q, k, v and o.  Returns the CUDA error code
// of the launch.
extern "C" int dmi_flash_fwd(const void* q, const void* k, const void* v, const int* key_mask,
                             void* o, float* lse, int B, int nh, int nkv, int T, int hd,
                             const long long* strides, float scale, int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHd || nkv < 1 || nh % nkv != 0 || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.key_mask = key_mask;
  a.o = o;
  a.lse_out = lse;
  a.q_s = {strides[0], strides[1], strides[2]};
  a.k_s = {strides[3], strides[4], strides[5]};
  a.v_s = {strides[6], strides[7], strides[8]};
  a.o_s = {strides[9], strides[10], strides[11]};
  a.nh = nh;
  a.nkv = nkv;
  a.group = nh / nkv;
  a.T = T;
  a.hd = hd;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32) return launch<float>(a, B, s);
  if (dtype == dmi::kBFloat16) return launch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
