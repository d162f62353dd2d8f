// Causal flash attention, backward, for Hopper: dK/dV and dQ.
//
// Replace the TPU kernels `_flash_attention_bwd_dkv` (pallas_call at :1121)
// and `_flash_attention_bwd_dq` (pallas_call at :1456) of jax's
// jax/experimental/pallas/ops/tpu/flash_attention.py, the backward of the
// attention that dmi_tpu/models/llama.py:_flash_attention (:1086) runs on
// every layer, behind dmi_tpu_torch/ops/cuda/flash_attn.py.
//
// With p_ij = exp(s_ij - lse_i) recomputed from the forward's saved
// log-sum-exp (0 where query i does not attend key j), delta_i =
// rowsum(dO_i * O_i) (computed by the wrapper, as the TPU wrapper does):
//
//   dV_j = sum_i p_ij dO_i
//   ds_ij = scale * p_ij (dO_i . v_j - delta_i)
//   dK_j = sum_i ds_ij q_i,   dQ_i = sum_j ds_ij k_j
//
// all accumulated in f32; p and ds are rounded to the input dtype before
// their products and the gradients are written in it, as the TPU kernels do.
//
// What bounds it on the H100: as the forward, shared-memory bandwidth on the
// CUDA cores (about 2.5 times the forward's FLOPs).  Design:
//   * dK/dV: one block per (key tile, kv head, batch row).  It stages its K
//     and V tiles once, then walks the group's query heads and, for each, the
//     query tiles at or after its key tile (causal), recomputing p and ds
//     for the 64 x 64 tile and accumulating dK and dV in registers.  The sum
//     over the group (GQA) happens inside the block, with no atomics and no
//     repeated K/V (the TPU wrapper repeated K and V over the group).
//   * dQ: one block per (query tile, head, batch row), walking the key tiles
//     at or before its query tile.
#include "flash_attn.cuh"

namespace {

using dmi::Num;
using namespace dmi::flash;

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int pitch = a.hd + 1;
  float* sK = smem;                   // [64, hd + 1]
  float* sV = sK + kTile * pitch;     // [64, hd + 1]
  float* sQ = sV + kTile * pitch;     // [64, hd + 1]
  float* sdO = sQ + kTile * pitch;    // [64, hd + 1]
  float* sP = sdO + kTile * pitch;    // [64 keys, 65]
  float* sdS = sP + kTile * kPitchS;  // [64 keys, 65]
  float* sLse = sdS + kTile * kPitchS;  // [64]
  float* sD = sLse + kTile;             // [64]
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;
  const int n_qt = (a.T + kTile - 1) / kTile;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_s.b + kvh * a.k_s.h;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_s.b + kvh * a.v_s.h;
  const int* km = a.key_mask ? a.key_mask + (size_t)b * a.T : nullptr;

  load_tile<T>(sK, kh, a.k_s.t, k0, a.T, a.hd);
  load_tile<T>(sV, vh, a.v_s.t, k0, a.T, a.hd);

  float dk[4][kMaxC], dv[4][kMaxC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < a.group; ++g) {
    const int h = kvh * a.group + g;
    const T* qh = static_cast<const T*>(a.q) + b * a.q_s.b + h * a.q_s.h;
    const T* doh = static_cast<const T*>(a.dout) + b * a.do_s.b + h * a.do_s.h;
    const float* lse = a.lse + ((size_t)b * a.nh + h) * a.T;
    const float* delta = a.delta + ((size_t)b * a.nh + h) * a.T;
    for (int qt = kt; qt < n_qt; ++qt) {  // causal: no query tile before the key tile
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's sQ, sdO, sP and sdS are read
      load_tile<T>(sQ, qh, a.q_s.t, q0, a.T, a.hd);
      load_tile<T>(sdO, doh, a.do_s.t, q0, a.T, a.hd);
      load_row_vec(sLse, lse, q0, a.T);
      load_row_vec(sD, delta, q0, a.T);
      __syncthreads();

      // s^T and dp^T for this thread's keys (rows) and queries (columns)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
      for (int d = 0; d < a.hd; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kv[r] = sK[(ty + 16 * r) * pitch + d];
          vv[r] = sV[(ty + 16 * r) * pitch + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = sQ[(tx + 16 * c) * pitch + d];
          dov[c] = sdO[(tx + 16 * c) * pitch + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
            dp[r][c] = fmaf(vv[r], dov[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tx + 16 * c;
          const bool ok = attends(q0 + qi, k0 + key, a.T, km);
          const float p = ok ? expf(s[r][c] * a.scale - sLse[qi]) : 0.f;
          const float ds = p * (dp[r][c] - sD[qi]) * a.scale;
          sP[key * kPitchS + qi] = rounded<T>(p);
          sdS[key * kPitchS + qi] = rounded<T>(ds);
        }
      }
      __syncthreads();

      const int n_q = min(kTile, a.T - q0);
      for (int i = 0; i < n_q; ++i) {
        float qv[kMaxC], dov[kMaxC];
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          const int d = tx + 16 * c;
          qv[c] = d < a.hd ? sQ[i * pitch + d] : 0.f;
          dov[c] = d < a.hd ? sdO[i * pitch + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = sP[(ty + 16 * r) * kPitchS + i];
          const float ds = sdS[(ty + 16 * r) * kPitchS + i];
#pragma unroll
          for (int c = 0; c < kMaxC; ++c) {
            dv[r][c] = fmaf(p, dov[c], dv[r][c]);
            dk[r][c] = fmaf(ds, qv[c], dk[r][c]);
          }
        }
      }
    }
  }

  T* dkh = static_cast<T*>(a.dk) + b * a.dk_s.b + kvh * a.dk_s.h;
  T* dvh = static_cast<T*>(a.dv) + b * a.dv_s.b + kvh * a.dv_s.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= a.T) continue;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) {
        dkh[key * a.dk_s.t + d] = Num<T>::store(dk[r][c]);
        dvh[key * a.dv_s.t + d] = Num<T>::store(dv[r][c]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int pitch = a.hd + 1;
  float* sQ = smem;                   // [64, hd + 1]
  float* sdO = sQ + kTile * pitch;    // [64, hd + 1]
  float* sK = sdO + kTile * pitch;    // [64, hd + 1]
  float* sV = sK + kTile * pitch;     // [64, hd + 1]
  float* sdS = sV + kTile * pitch;    // [64 queries, 65]
  float* sLse = sdS + kTile * kPitchS;  // [64]
  float* sD = sLse + kTile;             // [64]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;
  const T* qh = static_cast<const T*>(a.q) + b * a.q_s.b + h * a.q_s.h;
  const T* doh = static_cast<const T*>(a.dout) + b * a.do_s.b + h * a.do_s.h;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_s.b + kvh * a.k_s.h;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_s.b + kvh * a.v_s.h;
  const int* km = a.key_mask ? a.key_mask + (size_t)b * a.T : nullptr;

  load_tile<T>(sQ, qh, a.q_s.t, q0, a.T, a.hd);
  load_tile<T>(sdO, doh, a.do_s.t, q0, a.T, a.hd);
  load_row_vec(sLse, a.lse + ((size_t)b * a.nh + h) * a.T, q0, a.T);
  load_row_vec(sD, a.delta + ((size_t)b * a.nh + h) * a.T, q0, a.T);

  float dq[4][kMaxC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) dq[r][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {  // causal: no key tile after the query tile
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK, sV and sdS are read
    load_tile<T>(sK, kh, a.k_s.t, k0, a.T, a.hd);
    load_tile<T>(sV, vh, a.v_s.t, k0, a.T, a.hd);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d = 0; d < a.hd; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = sQ[(ty + 16 * r) * pitch + d];
        dov[r] = sdO[(ty + 16 * r) * pitch + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = sK[(tx + 16 * c) * pitch + d];
        vv[c] = sV[(tx + 16 * c) * pitch + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 16 * c;
        const bool ok = attends(q0 + qi, k0 + key, a.T, km);
        const float p = ok ? expf(s[r][c] * a.scale - sLse[qi]) : 0.f;
        sdS[qi * kPitchS + key] = rounded<T>(p * (dp[r][c] - sD[qi]) * a.scale);
      }
    }
    __syncthreads();

    const int n_keys = min(kTile, a.T - k0);
    for (int j = 0; j < n_keys; ++j) {
      float kv[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int d = tx + 16 * c;
        kv[c] = d < a.hd ? sK[j * pitch + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = sdS[(ty + 16 * r) * kPitchS + j];
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) dq[r][c] = fmaf(ds, kv[c], dq[r][c]);
      }
    }
  }

  T* dqh = static_cast<T*>(a.dq) + b * a.dq_s.b + h * a.dq_s.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.T) continue;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) dqh[row * a.dq_s.t + d] = Num<T>::store(dq[r][c]);
    }
  }
}

template <typename T>
int launch_dkv(const Args& a, int B, cudaStream_t stream) {
  const int pitch = a.hd + 1;
  const size_t smem =
      (size_t)(4 * kTile * pitch + 2 * kTile * kPitchS + 2 * kTile) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.nkv, B);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const Args& a, int B, cudaStream_t stream) {
  const int pitch = a.hd + 1;
  const size_t smem =
      (size_t)(4 * kTile * pitch + kTile * kPitchS + 2 * kTile) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.nh, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int nh, int nkv, int T, int hd) {
  return hd >= 1 && hd <= kMaxHd && nkv >= 1 && nh % nkv == 0 && T >= 1 && B >= 1;
}

Args bwd_args(const void* q, const void* k, const void* v, const int* key_mask,
              const void* dout, const float* lse, const float* delta, int nh, int nkv, int T,
              int hd, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.key_mask = key_mask;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.nh = nh;
  a.nkv = nkv;
  a.group = nh / nkv;
  a.T = T;
  a.hd = hd;
  a.scale = scale;
  return a;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Strides are element strides
// (batch, head, row): 18 for dK/dV (q, k, v, dO, dK, dV), 15 for dQ (q, k,
// v, dO, dQ).  Each returns the CUDA error code of its launch.
extern "C" int dmi_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const int* key_mask, const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv, int B, int nh, int nkv,
                                 int T, int hd, const long long* strides, float scale,
                                 int dtype, void* stream) {
  if (!valid_shape(B, nh, nkv, T, hd)) return (int)cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, key_mask, dout, lse, delta, nh, nkv, T, hd, scale);
  a.dk = dk;
  a.dv = dv;
  a.q_s = {strides[0], strides[1], strides[2]};
  a.k_s = {strides[3], strides[4], strides[5]};
  a.v_s = {strides[6], strides[7], strides[8]};
  a.do_s = {strides[9], strides[10], strides[11]};
  a.dk_s = {strides[12], strides[13], strides[14]};
  a.dv_s = {strides[15], strides[16], strides[17]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32) return launch_dkv<float>(a, B, s);
  if (dtype == dmi::kBFloat16) return launch_dkv<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dmi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const int* key_mask, const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int nh, int nkv, int T,
                                int hd, const long long* strides, float scale, int dtype,
                                void* stream) {
  if (!valid_shape(B, nh, nkv, T, hd)) return (int)cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, key_mask, dout, lse, delta, nh, nkv, T, hd, scale);
  a.dq = dq;
  a.q_s = {strides[0], strides[1], strides[2]};
  a.k_s = {strides[3], strides[4], strides[5]};
  a.v_s = {strides[6], strides[7], strides[8]};
  a.do_s = {strides[9], strides[10], strides[11]};
  a.dq_s = {strides[12], strides[13], strides[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32) return launch_dq<float>(a, B, s);
  if (dtype == dmi::kBFloat16) return launch_dq<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
