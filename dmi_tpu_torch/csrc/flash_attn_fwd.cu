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
// hd 64) do 4 B nh T^2 hd / 2 = 0.6 GFLOP of causal work per layer against
// 17 MB of q/k/v/o in bf16: 6.4 us at 3.35 TB/s, bound by bytes, with the
// products far below the tensor cores' 989 TFLOP/s.  A first version ran
// both products as scalar FMAs on the CUDA cores with q, k and v widened to
// f32 in shared memory, and shared-memory bandwidth set its pace (240 us at
// stage 1, SDPA 25 us).
//
// Two instances, chosen by dtype in dmi_flash_fwd (not a fallback: each
// dtype has one kernel):
//
// * bf16 (every training path), on the tensor cores, the FlashAttention-2
//   pattern on mma.sync.m16n8k16 (bf16 in, f32 accumulators), 4 warps a
//   block.  Each warp owns 16 query rows, loads their Q fragments once with
//   ldmatrix and keeps them in registers.  GQA is packed: a block takes
//   16 rows of each of 4 query heads that read one kv head (2 heads x 32
//   rows, or 1 x 64, where the group is not a multiple of 4), so every K and
//   V tile it stages serves 64 query rows and the short sequences of the
//   training paths fill whole warps (T 65: 5 row slices of 16, not 2 of 64).
//   K and V tiles of 64 keys are staged in bf16 by 16-byte cp.async copies,
//   double-buffered (the next tile in flight while this one is multiplied),
//   only up to the block's last row, at a row pitch of hd + 8 elements (hd
//   padded with zeros to a multiple of 16), which keeps ldmatrix and
//   ldmatrix.trans free of bank conflicts.  S = Q K^T and O += P V run as
//   mma.sync with the scores, the running max and sum and O in registers; a
//   thread holds two rows of each 16 x 8 tile, so a row's max is two
//   xor-shuffles over its quad.  Scores go to log2 units and exp2 runs on
//   the SFU (ex2.approx).  P is rounded to bf16 in registers and fed
//   straight back as the A operand of P V: the TPU kernel's rounding of p,
//   with no trip through shared memory.  Masking is where it is needed: a
//   tile's key mask is two ballots, a tile below the diagonal whose keys are
//   all unmasked takes no mask, one whose keys are all masked is skipped,
//   masked scores are -inf (a row with no key yet exponentiates against 0,
//   so it gets p = 0, not NaN).  The diagonal tile skips the 16-key slices
//   after a warp's last row, a warp whose rows all lie at or past T skips
//   the math, the query tiles run longest first, and O leaves through the
//   warp's Q rows in shared memory as 16-byte stores.
// * f32 (the CUDA tests and the smoke's f32 cases), on the CUDA cores:
//   tensor cores in f32 mean TF32, which keeps ~10 mantissa bits and could
//   not hold the 1e-4 tolerance.  One block of 256 threads per (query tile,
//   head, batch row) walks the key tiles at or before its query tile, stages
//   K and V as f32 in shared memory (pitch hd + 1), computes its 64 x 64
//   score tile (4 x 4 per thread), updates each row's max and sum with
//   16-lane shuffles, stages p, and accumulates p . v into registers.
#include "flash_attn.cuh"
#include "flash_mma.cuh"

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

// ---- the bf16 instance: mma.sync on the tensor cores ----

constexpr int kWarps = 4;         // warps of a block, 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;

// One warp's 16 query rows in the bf16 kernel; a thread holds rows g and
// g + 8: the running max (log2 units), its share of the running sum, O as
// 2 kD tiles of 16 x 8, and the rows' Q fragments.
template <int kD>
struct WarpRows {
  float m[2], l[2], o[2 * kD][4];
  uint32_t qf[kD][4];
};

// The warp's rows [r0, r0 + 16) against the staged key tile [k0, k0 + 64)
// (k_s, v_s), of which the first n_keys may be attended; keys: the tile's
// key mask, bit i for key k0 + i.  full: no (row, key) of the tile is
// masked.
template <int kD>
__device__ __forceinline__ void attend_tile(WarpRows<kD>& w, const bf16* k_s, const bf16* v_s,
                                            int r0, int k0, int n_keys, uint64_t keys,
                                            bool full, int T, float scale2) {
  constexpr int kLd = kD * 16 + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2) {  // 16 keys: score tiles 2 j2 and 2 j2 + 1
    if (j2 * 16 >= n_keys) continue;
#pragma unroll
    for (int kd = 0; kd < kD; ++kd) {
      uint32_t kb[4];
      ldsm_x4(kb, k_s + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kd * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * j2], w.qf[kd], kb[0], kb[1]);
      mma_bf16(s[2 * j2 + 1], w.qf[kd], kb[2], kb[3]);
    }
  }

  // scale into log2 units and mask with -inf; element e of tile j is row
  // g + 8 (e / 2), key j * 8 + 2 tig + e % 2
  float mx[2] = {-INFINITY, -INFINITY};
  if (full) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e >> 1) * 8, key = j * 8 + tig * 2 + (e & 1);
        const bool att = k0 + key <= row && row < T && (keys >> key) & 1u;
        s[j][e] = att ? s[j][e] * scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
  }
  // a row with no key yet keeps m = -inf and takes 0 as the exponent's
  // offset, so its masked scores give p = 0 (no NaN) and alpha = 0
  float alpha[2], m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(w.m[r], mx[r]);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_approx(w.m[r] - m_use[r]);  // 0 on the first tile
    w.m[r] = m_new;
    w.l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(s[j][e] - m_use[e >> 1]);
      w.l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n) {
    w.o[n][0] *= alpha[0];
    w.o[n][1] *= alpha[0];
    w.o[n][2] *= alpha[1];
    w.o[n][3] *= alpha[1];
  }

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 keys: p from score tiles 2 kk, 2 kk + 1
    if (kk * 16 >= n_keys) continue;
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kD; ++dp) {  // 16 head dims: O tiles 2 dp, 2 dp + 1
      uint32_t vb[4];
      ldsm_x4_trans(vb, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                            dp * 16 + (lane >> 4) * 8);
      mma_bf16(w.o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(w.o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// kD: head dims in 16-wide slices (hd <= 16 kD).  hpb: query heads of one
// kv head that a block packs (4, 2 or 1, dividing the group); each warp
// owns 16 rows of one of them, so a block owns 16 kWarps / hpb rows of hpb
// heads, which share every K and V tile it stages.
template <int kD>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(Args a, int hpb, bool vec) {
  constexpr int kLd = kD * 16 + 8, kTileElems = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kWarps x 16 rows][kLd]
  bf16* sK = sQ + kWarps * 16 * kLd;             // two buffers of [64][kLd]
  bf16* sV = sK + 2 * kTileElems;                // two buffers of [64][kLd]
  const int spp = kWarps / hpb;                  // warps per head
  const int rows = 16 * spp;                     // query rows of the block, per head
  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest rows first
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y * hpb + warp / spp, kvh = h / a.group;
  const int q0 = qt * rows, r0 = q0 + (warp % spp) * 16;  // the warp's first row
  const int q_end = min(a.T, q0 + rows);  // no key at or past it is attended
  const int last = (q_end - 1) / kTile;   // the block's last key tile (causal)
  const bool live = r0 < a.T;             // the warp has a row before T
  const bf16* qh = static_cast<const bf16*>(a.q) + b * a.q_s.b + h * a.q_s.h;
  const bf16* kh = static_cast<const bf16*>(a.k) + b * a.k_s.b + kvh * a.k_s.h;
  const bf16* vh = static_cast<const bf16*>(a.v) + b * a.v_s.b + kvh * a.v_s.h;
  const int* km = a.key_mask ? a.key_mask + (size_t)b * a.T : nullptr;
  const float scale2 = a.scale * 1.4426950408889634f;  // scores in log2 units
  bf16* sq = sQ + warp * 16 * kLd;                      // the warp's Q rows, later its O

  auto stage_kv = [&](int kt) {
    const int buf = (kt & 1) * kTileElems;
    stage_rows<kD, kTile>(sK + buf, kh, a.k_s.t, kt * kTile, q_end, a.hd, vec, threadIdx.x,
                          kMmaThreads);
    stage_rows<kD, kTile>(sV + buf, vh, a.v_s.t, kt * kTile, q_end, a.hd, vec, threadIdx.x,
                          kMmaThreads);
  };
  stage_rows<kD, 16>(sq, qh, a.q_s.t, r0, a.T, a.hd, vec, lane, 32);
  stage_kv(0);
  __pipeline_commit();

  WarpRows<kD> w;
  w.m[0] = w.m[1] = -INFINITY;
  w.l[0] = w.l[1] = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) w.o[n][e] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) stage_kv(kt + 1);  // in flight while tile kt is multiplied
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of tile kt (and Q) have landed
    __syncthreads();           // and everyone's
    const int k0 = kt * kTile;
    const int n_keys = min(kTile, r0 + 16 - k0);  // keys a row of the warp may attend
    if (live && kt == 0) {
#pragma unroll
      for (int kd = 0; kd < kD; ++kd)
        ldsm_x4(w.qf[kd], sq + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + kd * 16 +
                              (lane >> 4) * 8);
    }
    if (live && n_keys > 0) {
      // the tile's key mask by two ballots; a tile whose 64 keys are all
      // unmasked and lie before the warp's first row needs no mask (rows
      // past T are never written), one whose keys are all masked adds
      // nothing
      uint64_t keys = ~0ull;
      if (km != nullptr) {
        const bool lo = k0 + lane < a.T && km[k0 + lane] != 0;
        const bool hi = k0 + 32 + lane < a.T && km[k0 + 32 + lane] != 0;
        keys = __ballot_sync(0xffffffffu, lo) | (uint64_t)__ballot_sync(0xffffffffu, hi) << 32;
      }
      if (keys != 0ull)
        attend_tile<kD>(w, sK + (kt & 1) * kTileElems, sV + (kt & 1) * kTileElems, r0, k0,
                        n_keys, keys,
                        k0 + kTile <= r0 && keys == ~0ull, a.T, scale2);
    }
    __syncthreads();  // tile kt is consumed before tile kt + 2 is staged over it
  }
  if (!live) return;

  // O through the warp's own rows of sQ (read only at kt = 0), so that the
  // rows go out as 16-byte stores; lse in natural-log units
  bf16* oh = static_cast<bf16*>(a.o) + b * a.o_s.b + h * a.o_s.h;
  float* lse = a.lse_out + ((size_t)b * a.nh + h) * a.T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = w.l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;  // no key: zeros, not NaN
    const int rr = g + 8 * r;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n)
      *reinterpret_cast<uint32_t*>(sq + rr * kLd + n * 8 + tig * 2) =
          pack_bf16(w.o[n][2 * r] * inv, w.o[n][2 * r + 1] * inv);
    if (tig == 0 && r0 + rr < a.T)
      lse[r0 + rr] = sum > 0.f ? (w.m[r] + log2f(sum)) * 0.6931471805599453f : -INFINITY;
  }
  __syncwarp();
  const int n_rows = min(16, a.T - r0);
  if (vec) {
    for (int v = lane; v < n_rows * kD * 2; v += 32) {
      const int r = v / (kD * 2), c = (v % (kD * 2)) * 8;
      if (c < a.hd)
        *reinterpret_cast<uint4*>(oh + (r0 + r) * a.o_s.t + c) =
            *reinterpret_cast<const uint4*>(sq + r * kLd + c);
    }
  } else {
    for (int v = lane; v < n_rows * a.hd; v += 32) {
      const int r = v / a.hd, c = v % a.hd;
      oh[(r0 + r) * a.o_s.t + c] = sq[r * kLd + c];
    }
  }
}

template <int kD>
int launch_mma(const Args& a, int B, int hpb, bool vec, cudaStream_t stream) {
  // the warps' Q rows, then two K and two V tiles
  const size_t smem = (size_t)(16 * kWarps + 4 * kTile) * (kD * 16 + 8) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<kD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = 16 * kWarps / hpb;
  const dim3 grid((a.T + rows - 1) / rows, a.nh / hpb, B);
  flash_fwd_mma_kernel<kD><<<grid, kMmaThreads, smem, stream>>>(a, hpb, vec);
  return (int)cudaGetLastError();
}

// ---- the f32 instance on the CUDA cores, and the dispatch ----

int launch_f32(const Args& a, int B, cudaStream_t stream) {
  const int pitch = a.hd + 1;
  const size_t smem = (size_t)(3 * kTile * pitch + kTile * kPitchS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.nh, B);
  flash_fwd_kernel<float><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores, hd padded to 16 kD (ops/cuda/flash_attn.py:fwd_plan)
int launch_bf16(const Args& a, int B, int kd, int hpb, bool vec, cudaStream_t stream) {
  if (16 * kd < a.hd || (hpb != 1 && hpb != 2 && hpb != 4) || a.group % hpb != 0)
    return (int)cudaErrorInvalidValue;
  switch (kd) {
    case 1: return launch_mma<1>(a, B, hpb, vec, stream);
    case 2: return launch_mma<2>(a, B, hpb, vec, stream);
    case 3: return launch_mma<3>(a, B, hpb, vec, stream);
    case 4: return launch_mma<4>(a, B, hpb, vec, stream);
    case 6: return launch_mma<6>(a, B, hpb, vec, stream);
    case 8: return launch_mma<8>(a, B, hpb, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  strides holds 12 element
// strides: (batch, head, row) of q, k, v and o.  bf16 only: kd, the head
// dims in 16-wide slices (1, 2, 3, 4, 6 or 8), hpb, the query heads a block
// packs (4, 2 or 1, dividing the group), and vec: hd and the q, k, v
// and o strides are multiples of 8 and their pointers 16-byte aligned, so
// tiles are staged and rows of o written by 16-byte copies.  Returns the
// CUDA error code of the launch.
extern "C" int dmi_flash_fwd(const void* q, const void* k, const void* v, const int* key_mask,
                             void* o, float* lse, int B, int nh, int nkv, int T, int hd,
                             const long long* strides, float scale, int kd, int hpb, int vec,
                             int dtype, void* stream) {
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
  if (dtype == dmi::kFloat32) return launch_f32(a, B, s);
  if (dtype == dmi::kBFloat16) return launch_bf16(a, B, kd, hpb, vec != 0, s);
  return (int)cudaErrorInvalidValue;
}
