// Shared pieces of the causal flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the tile shape, the argument block, the mask rule and
// the tile loader.
//
// Layout: q [B, nh, T, hd], k/v [B, nkv, T, hd], and every output and
// gradient alike, each with free batch, head and row strides (in elements)
// and a contiguous last dim, so the attention of a transformer block reads
// the [B, T, heads, hd] projections in place.  GQA is native: query head h
// reads kv head h / group.  lse and delta are contiguous [B, nh, T] f32; the
// key mask, when given, is contiguous [B, T] int32 (0 = key masked).
//
// Tiles are 64 query rows by 64 keys, staged in shared memory as f32 with a
// row pitch of hd + 1 floats, so that 16 threads reading one column of 16
// different rows hit 16 different banks.  A block has 256 threads as a
// 16 x 16 grid (ty, tx); a thread owns rows ty + 16 a (a < 4) of a 64-row
// tile, and either columns tx + 16 c (c < 4) of a 64 x 64 score tile or
// dims tx + 16 c (c < hd / 16) of a [64, hd] accumulator.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace dmi {
namespace flash {

constexpr int kTile = 64;               // query rows and keys per tile
constexpr int kThreads = 256;           // 16 x 16
constexpr int kMaxHd = 128;             // head dims of one accumulator row
constexpr int kMaxC = kMaxHd / 16;      // accumulator dims a thread owns
constexpr int kPitchS = kTile + 1;      // row pitch of a score tile
// flash_attention.py's DEFAULT_MASK_VALUE: -0.7 * float32 max
constexpr float kMaskValue = -0.7f * 3.40282347e38f;

struct Strides {
  long long b, h, t;  // elements between batches, heads and rows
};

// One argument block for all three kernels; each reads what it needs.
struct Args {
  const void *q, *k, *v, *dout;
  const int* key_mask;       // [B, T] or nullptr
  const float *lse, *delta;  // [B, nh, T]: saved by the forward; rowsum(dO * O)
  void *o, *dq, *dk, *dv;
  float* lse_out;
  Strides q_s, k_s, v_s, o_s, do_s, dq_s, dk_s, dv_s;
  int nh, nkv, group, T, hd;
  float scale;
};

// Query i attends key j: causal, inside the sequence, key not masked.
__device__ __forceinline__ bool attends(int i, int j, int T, const int* km) {
  return j <= i && i < T && (km == nullptr || km[j] != 0);
}

// The value x takes once stored in T and read back (the TPU kernel rounds p
// and ds to the input dtype before their products).
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return Num<T>::load(Num<T>::store(x));
}

// Stage rows [row0, row0 + 64) of one head into dst[64][hd + 1] as f32;
// rows at or past T are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* head, long long row_stride,
                                          int row0, int T_len, int hd) {
  const int pitch = hd + 1;
  for (int idx = threadIdx.x; idx < kTile * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int row = row0 + r;
    dst[r * pitch + d] = row < T_len ? Num<T>::load(head[row * row_stride + d]) : 0.f;
  }
}

// Stage rows [row0, row0 + 64) of a [B, nh, T] f32 vector; zeros past T.
__device__ __forceinline__ void load_row_vec(float* dst, const float* src, int row0,
                                             int T_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < T_len ? src[row0 + r] : 0.f;
}

// Sum and max over the 16 threads (one tx each) that share a ty: they are
// the two half-warps of a warp.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace flash
}  // namespace dmi
