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
// The sum over a GQA group happens inside a block, in a fixed order, with
// no atomics: two calls give bit-identical gradients.
//
// What bounds it on the H100: at the stage-1 call (B 32, 32/8 heads, T 65,
// hd 64, bf16) dK/dV reads q, k, v, dO, lse and delta and writes dK and dV,
// 26 MB (7.8 us at 3.35 TB/s), against 1.1 GFLOP of causal products (1.1 us
// on the tensor cores); dQ moves 30 MB (9.1 us) for 0.8 GFLOP.  Bytes bound
// both, once the products run on the tensor cores; a first version ran
// them as scalar FMAs from f32 tiles in shared memory, whose bandwidth set
// its pace (395 + 318 us at stage 1, SDPA's whole backward 95 us).
//
// Two instances of each kernel, chosen by dtype (not a fallback: each dtype
// has one kernel):
//
// * bf16 (every training path), on the tensor cores: FlashAttention-2's
//   backward on mma.sync.m16n8k16 (bf16 in, f32 accumulators) with the
//   forward's fragment routines (flash_mma.cuh), 4 warps a block, hd
//   padded with zeros to 16 kD (kD in 1, 2, 3, 4, 6, 8: fwd_plan).
//   - dK/dV: a warp owns 16 keys; a block packs hpb query heads of one kv
//     head (2 or 1, dividing the group: bwd_plan) on its 4 warps: 16 x 4 / hpb keys,
//     each key slice once per head slot, so that T 65 takes blocks of 32,
//     32 and 1 keys rather than a 64-key block beside a 1-key block with
//     three idle warps.  The block walks its group in steps of hpb heads
//     and, for each, the query rows from its first key to T in steps of
//     qrows, double-buffered: each step's Q and dO rows of the hpb heads
//     (with their lse and delta).  Per 16-query chunk a warp computes S^T =
//     K Q^T and dP^T = V dO^T (B operands: Q and dO rows by ldmatrix),
//     forms P^T and dS^T in registers and feeds them, rounded to bf16,
//     straight back as A operands of dV += P^T dO and dK += dS^T Q (dO and
//     Q by ldmatrix.trans): P and dS never touch shared memory.  K and V
//     fragments stay in registers for kD <= 4; above, the dK and dV
//     accumulators (8 kD registers each) leave no room, and they are read
//     from shared memory at each use.  At the end the head slots' partial
//     dK and dV are summed through shared memory, slot 0 + 1.
//   - dQ: one block per (query tile, packed query heads of one kv head), as
//     the forward's: a warp owns 16 rows of one head, keeps their Q and dO
//     fragments in registers, and walks the key tiles of 64 up to its last
//     row (K and V double-buffered); per 16 keys S = Q K^T, dP = dO V^T, dS
//     in registers, dQ += dS K (K by ldmatrix.trans).  dQ leaves through
//     the warp's Q rows in shared memory as 16-byte stores.
//   - Copies: at kD 4 (hd 49-64, every training path) the walked tiles (Q
//     and dO for dK/dV, K and V for dQ) come by TMA, one instruction a tile
//     from one thread, 128-byte swizzled, zero-filled past T and hd, onto
//     an mbarrier per buffer.  Issuing 16-byte cp.async copies from every
//     thread took about as long as a step's math; TMA cut dK/dV by a
//     quarter to a third at the training shapes.  Other head dims, and
//     rows that are not 16-byte aligned, keep cp.async (or element copies).
//   - Masks as in the forward: lse goes to log2 units; a chunk whose keys
//     are all unmasked and before all its queries takes no mask; a key
//     tile whose keys are all masked is skipped; chunks on the wrong side of
//     the diagonal are skipped; warps whose rows (dQ) or keys (dK/dV) all
//     lie at or past T, or whose keys are all masked, do no math.  Where a
//     mask applies p is selected to 0, so a row with no key (lse = -inf)
//     gets zero gradients, not NaN.  Rows past T are staged as zeros: their
//     dO and q vanish from every product.
// * f32 (the CUDA tests and the smoke's f32 cases), on the CUDA cores:
//   tensor cores in f32 mean TF32, which keeps ~10 mantissa bits and could
//   not hold the 1e-4 tolerance.  Tiles of 64 x 64 widened in shared memory
//   (pitch hd + 1), 256 threads, 4 x 4 scores a thread.
//   - dK/dV: one block per (key tile, kv head, batch row).  It stages its K
//     and V tiles once, then walks the group's query heads and, for each,
//     the query tiles at or after its key tile (causal), recomputing p and
//     ds for the 64 x 64 tile and accumulating dK and dV in registers.
//   - dQ: one block per (query tile, head, batch row), walking the key
//     tiles at or before its query tile.
#include "flash_attn.cuh"
#include "flash_mma.cuh"

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

// ---- the bf16 instance: mma.sync on the tensor cores ----

constexpr int kWarps = 4;  // warps of a block, 16 keys (dK/dV) or rows (dQ) each
constexpr int kMmaThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// kD: head dims in 16-wide slices (hd <= 16 kD).  kRegKV: the warp's K and
// V fragments live in registers (else they are read from shared memory at
// each use).  kTma (kD 4): Q and dO tiles come by TMA (tm_q, tm_do: boxes
// of 64 columns by qrows rows of one head; bit 0 / 1 of `order`: the box's
// rows are the map's second dimension, else its third), 128-byte swizzled,
// one copy a tile issued by one thread; else every thread stages rows by
// 16-byte cp.async.  hpb: query heads of one kv head that a block packs (4,
// 2 or 1, dividing the group; bwd_plan takes 2 or 1), warp w serving head
// slot w / (4 / hpb) for the 16-key slice w % (4 / hpb).  qrows: query rows staged per head a step, a
// multiple of 16.
template <int kD, bool kRegKV, bool kTma>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(Args a, int hpb, int qrows, bool vec,
                             const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do, int order) {
  constexpr int kLd = kD * 16 + 8;
  constexpr int kLdQ = kTma ? 64 : kLd;  // row pitch of the Q and dO tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (kTma)  // swizzled boxes land on 1024 bytes
    smem += (1024 - reinterpret_cast<uintptr_t>(smem_raw) % 1024) % 1024;
  const int spp = kWarps / hpb;   // key slices of the block
  const int n_keys = 16 * spp;    // keys of the block
  const int srows = hpb * qrows;  // Q (and dO) rows staged a step
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // two buffers of [srows][kLdQ]
  bf16* sdO = sQ + 2 * srows * kLdQ;         // two buffers of [srows][kLdQ]
  bf16* sK = sdO + 2 * srows * kLdQ;         // [n_keys][kLd]
  bf16* sV = sK + n_keys * kLd;              // [n_keys][kLd]
  float* sL = reinterpret_cast<float*>(sV + n_keys * kLd);  // two of [srows]: lse
  float* sDl = sL + 2 * srows;                              // two of [srows]: delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(sDl + 2 * srows);  // kTma: each buffer's copies
  const int kt = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int slot = warp / spp, ks = warp % spp;
  const int k0 = kt * n_keys, kw0 = k0 + 16 * ks;  // the block's and the warp's first key
  const int n_qs = (a.T - k0 + qrows - 1) / qrows;  // steps over the rows [k0, T) a head
  const int n_st = a.group / hpb * n_qs;
  const bf16* kh = static_cast<const bf16*>(a.k) + b * a.k_s.b + kvh * a.k_s.h;
  const bf16* vh = static_cast<const bf16*>(a.v) + b * a.v_s.b + kvh * a.v_s.h;
  const int* km = a.key_mask ? a.key_mask + (size_t)b * a.T : nullptr;
  const float scale2 = a.scale * kLog2e;  // scores in log2 units

  // step st: head slots of heads h0 + slot, query rows [q0, q0 + qrows)
  auto stage = [&](int st) {
    const int buf = st & 1, h0 = kvh * a.group + st / n_qs * hpb;
    const int q0 = k0 + st % n_qs * qrows;
    if constexpr (kTma) {  // rows past T and columns past hd come as zeros
      if (threadIdx.x == 0) {
        mbar_expect_tx(bars + buf, 2 * srows * kLdQ * sizeof(bf16));
        for (int s = 0; s < hpb; ++s) {
          const int h = h0 + s, off = (buf * srows + s * qrows) * kLdQ;
          tma_load_4d(sQ + off, &tm_q, 0, order & 1 ? q0 : h, order & 1 ? h : q0, b, bars + buf);
          tma_load_4d(sdO + off, &tm_do, 0, order & 2 ? q0 : h, order & 2 ? h : q0, b,
                      bars + buf);
        }
      }
    }
    for (int s = 0; s < hpb; ++s) {
      const int h = h0 + s, off = buf * srows + s * qrows;
      if constexpr (!kTma) {
        const bf16* qh = static_cast<const bf16*>(a.q) + b * a.q_s.b + h * a.q_s.h;
        const bf16* doh = static_cast<const bf16*>(a.dout) + b * a.do_s.b + h * a.do_s.h;
        for (int r = 0; r < qrows; r += 16) {
          stage_rows<kD, 16>(sQ + (off + r) * kLd, qh, a.q_s.t, q0 + r, a.T, a.hd, vec,
                             threadIdx.x, kMmaThreads);
          stage_rows<kD, 16>(sdO + (off + r) * kLd, doh, a.do_s.t, q0 + r, a.T, a.hd, vec,
                             threadIdx.x, kMmaThreads);
        }
      }
      const float* lse = a.lse + ((size_t)b * a.nh + h) * a.T;
      const float* delta = a.delta + ((size_t)b * a.nh + h) * a.T;
      for (int r = threadIdx.x; r < qrows; r += kMmaThreads) {
        const bool ok = q0 + r < a.T;  // rows past T: 0
        __pipeline_memcpy_async(sL + off + r, ok ? lse + q0 + r : lse, 4, ok ? 0 : 4);
        __pipeline_memcpy_async(sDl + off + r, ok ? delta + q0 + r : delta, 4, ok ? 0 : 4);
      }
    }
  };
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      mbar_init(bars, 1);
      mbar_init(bars + 1, 1);
    }
    __syncthreads();
  }
  for (int r = 0; r < n_keys; r += 16) {
    stage_rows<kD, 16>(sK + r * kLd, kh, a.k_s.t, k0 + r, a.T, a.hd, vec, threadIdx.x,
                       kMmaThreads);
    stage_rows<kD, 16>(sV + r * kLd, vh, a.v_s.t, k0 + r, a.T, a.hd, vec, threadIdx.x,
                       kMmaThreads);
  }
  stage(0);
  __pipeline_commit();

  // the warp's keys that any query may attend: before T and not masked
  const int key_l = kw0 + (lane & 15);
  const uint32_t kbits =
      __ballot_sync(0xffffffffu, key_l < a.T && (km == nullptr || km[key_l] != 0)) & 0xffffu;
  const bool live = kbits != 0u;
  const bool key_ok[2] = {((kbits >> g) & 1u) != 0u, ((kbits >> (g + 8)) & 1u) != 0u};
  const bf16* wk = sK + 16 * ks * kLd;  // the warp's K and V rows
  const bf16* wv = sV + 16 * ks * kLd;
  // ldmatrix offsets into a 16-row chunk of the Q and dO tiles: as B
  // operands with the rows as N (column slice kd), and transposed, with
  // the rows as K (column slice dd)
  auto nb_off = [&](int kd) {
    if constexpr (kTma) return swz_off((lane & 7) + (lane >> 4) * 8, kd * 16 + (lane & 8));
    else return b_off<kLd>(lane) + kd * 16;
  };
  auto kb_off = [&](int dd) {
    if constexpr (kTma) return swz_off((lane & 7) + (lane & 8), dd * 16 + (lane >> 4) * 8);
    else return a_off<kLd>(lane) + dd * 16;
  };

  float dk[2 * kD][4], dv[2 * kD][4];
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  uint32_t kf[kRegKV ? kD : 1][4], vf[kRegKV ? kD : 1][4];

  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) stage(st + 1);  // in flight while step st is multiplied
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of step st (and K, V) have landed
    if constexpr (kTma) mbar_wait(bars + (st & 1), st >> 1 & 1);  // and the TMA tiles
    __syncthreads();  // and everyone's
    if constexpr (kRegKV) {
      if (live && st == 0) {
#pragma unroll
        for (int kd = 0; kd < kD; ++kd) {
          ldsm_x4(kf[kd], wk + a_off<kLd>(lane) + kd * 16);
          ldsm_x4(vf[kd], wv + a_off<kLd>(lane) + kd * 16);
        }
      }
    }
    const int q0 = k0 + st % n_qs * qrows;
    const int n_c = min(qrows, a.T - q0 + 15) / 16;  // 16-row chunks with a row before T
    const int off = (st & 1) * srows + slot * qrows;
    for (int c = live ? 0 : n_c; c < n_c; ++c) {
      const int qc0 = q0 + 16 * c;
      if (qc0 + 15 < kw0) continue;  // every query of the chunk before every key
      const bf16* cq = sQ + (off + 16 * c) * kLdQ;
      const bf16* co = sdO + (off + 16 * c) * kLdQ;
      // S^T (16 keys x 16 queries) and dP^T as two C tiles of 8 queries each
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < kD; ++kd) {
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, cq + nb_off(kd));
        ldsm_x4(ob, co + nb_off(kd));
        if constexpr (kRegKV) {
          mma_bf16(s[0], kf[kd], qb[0], qb[1]);
          mma_bf16(s[1], kf[kd], qb[2], qb[3]);
          mma_bf16(dp[0], vf[kd], ob[0], ob[1]);
          mma_bf16(dp[1], vf[kd], ob[2], ob[3]);
        } else {
          uint32_t ka[4], va[4];
          ldsm_x4(ka, wk + a_off<kLd>(lane) + kd * 16);
          ldsm_x4(va, wv + a_off<kLd>(lane) + kd * 16);
          mma_bf16(s[0], ka, qb[0], qb[1]);
          mma_bf16(s[1], ka, qb[2], qb[3]);
          mma_bf16(dp[0], va, ob[0], ob[1]);
          mma_bf16(dp[1], va, ob[2], ob[3]);
        }
      }
      // P^T and dS^T in place; element e of tile j is key kw0 + g + 8 (e / 2),
      // query qc0 + 8 j + 2 tig + e % 2.  full: every key of the warp is
      // attended by every query of the chunk
      const bool full = kbits == 0xffffu && qc0 >= kw0 + 16;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = off + 16 * c + 8 * j + 2 * tig;
        const float2 lse = *reinterpret_cast<const float2*>(sL + col);
        const float2 delta = *reinterpret_cast<const float2*>(sDl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? lse.y : lse.x, d = (e & 1) ? delta.y : delta.x;
          float p = exp2_approx(fmaf(s[j][e], scale2, -l * kLog2e));
          if (!full) {
            const int key = kw0 + g + 8 * (e >> 1), q = qc0 + 8 * j + 2 * tig + (e & 1);
            p = key <= q && key_ok[e >> 1] ? p : 0.f;  // no key: lse = -inf, p = 0
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - d) * a.scale;
        }
      }
      uint32_t pa[4], da[4];
      pack_a(pa, s[0], s[1]);
      pack_a(da, dp[0], dp[1]);
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) {  // 16 head dims: dV, dK tiles 2 dd, 2 dd + 1
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, co + kb_off(dd));
        mma_bf16(dv[2 * dd], pa, ob[0], ob[1]);
        mma_bf16(dv[2 * dd + 1], pa, ob[2], ob[3]);
        ldsm_x4_trans(qb, cq + kb_off(dd));
        mma_bf16(dk[2 * dd], da, qb[0], qb[1]);
        mma_bf16(dk[2 * dd + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();  // step st is consumed before step st + 2 is staged over it
  }

  // the head slots' partial sums, slot 0 + 1 + ... + hpb - 1, through the
  // staging buffers (free now: the last copies landed before the last step)
  float* red = reinterpret_cast<float*>(sQ);
  constexpr int kPart = 2 * 2 * kD * 4 * 32;  // a warp's dK and dV, by lane
  if (slot > 0) {
    float* r = red + ((slot - 1) * spp + ks) * kPart;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[(n * 4 + e) * 32 + lane] = dk[n][e];
        r[((2 * kD + n) * 4 + e) * 32 + lane] = dv[n][e];
      }
  }
  __syncthreads();
  if (slot > 0 || kw0 >= a.T) return;
  for (int s = 1; s < hpb; ++s) {
    const float* r = red + ((s - 1) * spp + ks) * kPart;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] += r[(n * 4 + e) * 32 + lane];
        dv[n][e] += r[((2 * kD + n) * 4 + e) * 32 + lane];
      }
  }
  bf16* dkh = static_cast<bf16*>(a.dk) + b * a.dk_s.b + kvh * a.dk_s.h;
  bf16* dvh = static_cast<bf16*>(a.dv) + b * a.dv_s.b + kvh * a.dv_s.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= a.T) continue;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n) {
      const int d = 8 * n + 2 * tig;
      if (d >= a.hd) continue;
      bf16* pk = dkh + key * a.dk_s.t + d;
      bf16* pv = dvh + key * a.dv_s.t + d;
      if (vec) {  // hd a multiple of 8, rows 16-byte aligned: d + 1 < hd
        *reinterpret_cast<uint32_t*>(pk) = pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(pv) = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      } else {
        pk[0] = __float2bfloat16(dk[n][2 * r]);
        pv[0] = __float2bfloat16(dv[n][2 * r]);
        if (d + 1 < a.hd) {
          pk[1] = __float2bfloat16(dk[n][2 * r + 1]);
          pv[1] = __float2bfloat16(dv[n][2 * r + 1]);
        }
      }
    }
  }
}

// kD, hpb: as the forward's kernel (4 warps, 16 rows of one of hpb heads
// each, 16 x 4 / hpb rows a head).  kTma (kD 4): K and V tiles come by TMA
// (tm_k, tm_v: boxes of 64 columns by 64 rows of one kv head; `order` as
// the dK/dV kernel's), 128-byte swizzled; else by 16-byte cp.async.
template <int kD, bool kTma>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(Args a, int hpb, bool vec, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, int order) {
  constexpr int kLd = kD * 16 + 8;
  constexpr int kLdK = kTma ? 64 : kLd, kTileElems = kTile * kLdK;  // K and V tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (kTma)  // swizzled boxes land on 1024 bytes
    smem += (1024 - reinterpret_cast<uintptr_t>(smem_raw) % 1024) % 1024;
  bf16* sK = reinterpret_cast<bf16*>(smem);  // two buffers of [64][kLdK]
  bf16* sV = sK + 2 * kTileElems;            // two buffers of [64][kLdK]
  bf16* sQ = sV + 2 * kTileElems;            // [kWarps x 16 rows][kLd]
  bf16* sdO = sQ + kWarps * 16 * kLd;        // [kWarps x 16 rows][kLd]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sdO + kWarps * 16 * kLd);  // kTma
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
  const bf16* doh = static_cast<const bf16*>(a.dout) + b * a.do_s.b + h * a.do_s.h;
  const bf16* kh = static_cast<const bf16*>(a.k) + b * a.k_s.b + kvh * a.k_s.h;
  const bf16* vh = static_cast<const bf16*>(a.v) + b * a.v_s.b + kvh * a.v_s.h;
  const int* km = a.key_mask ? a.key_mask + (size_t)b * a.T : nullptr;
  const float scale2 = a.scale * kLog2e;  // scores in log2 units
  bf16* sq = sQ + warp * 16 * kLd;        // the warp's Q rows, later its dQ
  bf16* so = sdO + warp * 16 * kLd;       // the warp's dO rows

  auto stage_kv = [&](int kt) {
    const int buf = (kt & 1) * kTileElems, k0 = kt * kTile;
    if constexpr (kTma) {  // keys past T come as zeros
      if (threadIdx.x == 0) {
        mbar_expect_tx(bars + (kt & 1), 2 * kTileElems * sizeof(bf16));
        tma_load_4d(sK + buf, &tm_k, 0, order & 1 ? k0 : kvh, order & 1 ? kvh : k0, b,
                    bars + (kt & 1));
        tma_load_4d(sV + buf, &tm_v, 0, order & 2 ? k0 : kvh, order & 2 ? kvh : k0, b,
                    bars + (kt & 1));
      }
    } else {
      stage_rows<kD, kTile>(sK + buf, kh, a.k_s.t, k0, q_end, a.hd, vec, threadIdx.x,
                            kMmaThreads);
      stage_rows<kD, kTile>(sV + buf, vh, a.v_s.t, k0, q_end, a.hd, vec, threadIdx.x,
                            kMmaThreads);
    }
  };
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      mbar_init(bars, 1);
      mbar_init(bars + 1, 1);
    }
    __syncthreads();
  }
  // ldmatrix offsets into 16 keys of a K or V tile: as B operands with the
  // keys as N (column slice kd), and transposed, with the keys as K
  auto nb_off = [&](int kd) {
    if constexpr (kTma) return swz_off((lane & 7) + (lane >> 4) * 8, kd * 16 + (lane & 8));
    else return b_off<kLd>(lane) + kd * 16;
  };
  auto kb_off = [&](int dd) {
    if constexpr (kTma) return swz_off((lane & 7) + (lane & 8), dd * 16 + (lane >> 4) * 8);
    else return a_off<kLd>(lane) + dd * 16;
  };
  stage_rows<kD, 16>(sq, qh, a.q_s.t, r0, a.T, a.hd, vec, lane, 32);
  stage_rows<kD, 16>(so, doh, a.do_s.t, r0, a.T, a.hd, vec, lane, 32);
  stage_kv(0);
  __pipeline_commit();

  // the thread's rows g and g + 8: lse in log2 units and delta (rows past
  // T: 0, and their q and dO are zeros)
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const size_t i = ((size_t)b * a.nh + h) * a.T + row;
    l2[r] = row < a.T ? a.lse[i] * kLog2e : 0.f;
    dl[r] = row < a.T ? a.delta[i] : 0.f;
  }
  uint32_t qf[kD][4], of[kD][4];
  float dq[2 * kD][4];
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) stage_kv(kt + 1);  // in flight while tile kt is multiplied
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of tile kt (and Q, dO) have landed
    if constexpr (kTma) mbar_wait(bars + (kt & 1), kt >> 1 & 1);  // and the TMA tiles
    __syncthreads();  // and everyone's
    const int k0 = kt * kTile;
    const int n_keys = min(kTile, r0 + 16 - k0);  // keys a row of the warp may attend
    if (live && kt == 0) {
#pragma unroll
      for (int kd = 0; kd < kD; ++kd) {
        ldsm_x4(qf[kd], sq + a_off<kLd>(lane) + kd * 16);
        ldsm_x4(of[kd], so + a_off<kLd>(lane) + kd * 16);
      }
    }
    if (live && n_keys > 0) {
      // the tile's key mask by two ballots, as in the forward
      uint64_t keys = ~0ull;
      if (km != nullptr) {
        const bool lo = k0 + lane < a.T && km[k0 + lane] != 0;
        const bool hi = k0 + 32 + lane < a.T && km[k0 + 32 + lane] != 0;
        keys = __ballot_sync(0xffffffffu, lo) | (uint64_t)__ballot_sync(0xffffffffu, hi) << 32;
      }
      const bool full = k0 + kTile <= r0 && keys == ~0ull;
      const bf16* k_s = sK + (kt & 1) * kTileElems;
      const bf16* v_s = sV + (kt & 1) * kTileElems;
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {  // 16 keys: S and dP tiles of 8 keys
        if (j2 * 16 >= n_keys || ((keys >> (16 * j2)) & 0xffffull) == 0ull) continue;
        float s[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < kD; ++kd) {
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, k_s + 16 * j2 * kLdK + nb_off(kd));
          ldsm_x4(vb, v_s + 16 * j2 * kLdK + nb_off(kd));
          mma_bf16(s[0], qf[kd], kb[0], kb[1]);
          mma_bf16(s[1], qf[kd], kb[2], kb[3]);
          mma_bf16(dp[0], of[kd], vb[0], vb[1]);
          mma_bf16(dp[1], of[kd], vb[2], vb[3]);
        }
        // dS in place; element e of tile j is row r0 + g + 8 (e / 2), key
        // k0 + 16 j2 + 8 j + 2 tig + e % 2
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(s[j][e], scale2, -l2[e >> 1]));
            if (!full) {
              const int row = r0 + g + 8 * (e >> 1), key = 16 * j2 + 8 * j + 2 * tig + (e & 1);
              p = k0 + key <= row && ((keys >> key) & 1ull) ? p : 0.f;  // no key: p = 0
            }
            dp[j][e] = p * (dp[j][e] - dl[e >> 1]) * a.scale;
          }
        uint32_t da[4];
        pack_a(da, dp[0], dp[1]);
#pragma unroll
        for (int dd = 0; dd < kD; ++dd) {  // 16 head dims: dQ tiles 2 dd, 2 dd + 1
          uint32_t kb[4];
          ldsm_x4_trans(kb, k_s + 16 * j2 * kLdK + kb_off(dd));
          mma_bf16(dq[2 * dd], da, kb[0], kb[1]);
          mma_bf16(dq[2 * dd + 1], da, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // tile kt is consumed before tile kt + 2 is staged over it
  }
  if (!live) return;

  // dQ through the warp's own rows of sQ (read only at kt = 0), so that the
  // rows go out as 16-byte stores
  bf16* dqh = static_cast<bf16*>(a.dq) + b * a.dq_s.b + h * a.dq_s.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = g + 8 * r;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n)
      *reinterpret_cast<uint32_t*>(sq + rr * kLd + n * 8 + tig * 2) =
          pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
  }
  __syncwarp();
  const int n_rows = min(16, a.T - r0);
  if (vec) {
    for (int v = lane; v < n_rows * kD * 2; v += 32) {
      const int r = v / (kD * 2), c = (v % (kD * 2)) * 8;
      if (c < a.hd)
        *reinterpret_cast<uint4*>(dqh + (r0 + r) * a.dq_s.t + c) =
            *reinterpret_cast<const uint4*>(sq + r * kLd + c);
    }
  } else {
    for (int v = lane; v < n_rows * a.hd; v += 32) {
      const int r = v / a.hd, c = v % a.hd;
      dqh[(r0 + r) * a.dq_s.t + c] = sq[r * kLd + c];
    }
  }
}

// A TMA map of x [B, heads, T, hd] (element strides st) whose boxes are 64
// columns by `rows` rows of one head; *t_inner: the rows are the map's
// second dimension and the heads its third (else the reverse), so that the
// strides grow outward.  False where the driver has no encoder or the
// strides do not nest.
bool rows_map(CUtensorMap* m, bool* t_inner, const void* x, const Strides& st, int B,
              int heads, int T, int hd, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t sh = st.h * sizeof(bf16), stt = st.t * sizeof(bf16), sb = st.b * sizeof(bf16);
  *t_inner = stt <= sh;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)(*t_inner ? T : heads),
                              (cuuint64_t)(*t_inner ? heads : T), (cuuint64_t)B};
  const cuuint64_t strides[3] = {*t_inner ? stt : sh, *t_inner ? sh : stt, sb};
  if (strides[0] > strides[1] || strides[1] > strides[2]) return false;
  const cuuint32_t box[4] = {64, *t_inner ? (cuuint32_t)rows : 1u, *t_inner ? 1u : (cuuint32_t)rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, bool kTma>
int launch_dkv(const Args& a, int B, int hpb, int qrows, bool vec, const CUtensorMap& tm_q,
               const CUtensorMap& tm_do, int order, cudaStream_t stream) {
  constexpr int kLd = kD * 16 + 8, kLdQ = kTma ? 64 : kLd;
  const int n_keys = 16 * kWarps / hpb, srows = hpb * qrows;
  // two steps of Q and dO rows, K and V of the block's keys, two steps of
  // lse and delta, two mbarriers; TMA boxes start on 1024 bytes
  const size_t smem = (kTma ? 1024 : 0) + (size_t)4 * srows * kLdQ * sizeof(bf16) +
                      (size_t)2 * n_keys * kLd * sizeof(bf16) + 4 * srows * sizeof(float) +
                      2 * sizeof(uint64_t);
  auto kernel = flash_bwd_dkv_mma_kernel<kD, (kD <= 4), kTma>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + n_keys - 1) / n_keys, a.nkv, B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a, hpb, qrows, vec, tm_q, tm_do, order);
  return (int)cudaGetLastError();
}

// TMA tiles for Q and dO at kD 4 (hd 49-64: a 128-byte box row), where the
// rows are 16-byte aligned and the strides nest; else cp.async
template <int kD>
int launch_dkv_mma(const Args& a, int B, int hpb, int qrows, bool vec, cudaStream_t stream) {
  CUtensorMap tm_q{}, tm_do{};
  if constexpr (kD == 4) {
    bool q_in = false, do_in = false;
    if (vec && rows_map(&tm_q, &q_in, a.q, a.q_s, B, a.nh, a.T, a.hd, qrows) &&
        rows_map(&tm_do, &do_in, a.dout, a.do_s, B, a.nh, a.T, a.hd, qrows))
      return launch_dkv<kD, true>(a, B, hpb, qrows, vec, tm_q, tm_do, q_in | do_in << 1, stream);
  }
  return launch_dkv<kD, false>(a, B, hpb, qrows, vec, tm_q, tm_do, 0, stream);
}

template <int kD, bool kTma>
int launch_dq(const Args& a, int B, int hpb, bool vec, const CUtensorMap& tm_k,
              const CUtensorMap& tm_v, int order, cudaStream_t stream) {
  constexpr int kLd = kD * 16 + 8, kLdK = kTma ? 64 : kLd;
  // two K and two V tiles, the warps' Q and dO rows, two mbarriers; TMA
  // boxes start on 1024 bytes
  const size_t smem = (kTma ? 1024 : 0) + (size_t)4 * kTile * kLdK * sizeof(bf16) +
                      (size_t)2 * 16 * kWarps * kLd * sizeof(bf16) + 2 * sizeof(uint64_t);
  auto kernel = flash_bwd_dq_mma_kernel<kD, kTma>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = 16 * kWarps / hpb;
  const dim3 grid((a.T + rows - 1) / rows, a.nh / hpb, B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a, hpb, vec, tm_k, tm_v, order);
  return (int)cudaGetLastError();
}

// TMA tiles for K and V at kD 4, as launch_dkv_mma has them for Q and dO
template <int kD>
int launch_dq_mma(const Args& a, int B, int hpb, bool vec, cudaStream_t stream) {
  CUtensorMap tm_k{}, tm_v{};
  if constexpr (kD == 4) {
    bool k_in = false, v_in = false;
    if (vec && rows_map(&tm_k, &k_in, a.k, a.k_s, B, a.nkv, a.T, a.hd, kTile) &&
        rows_map(&tm_v, &v_in, a.v, a.v_s, B, a.nkv, a.T, a.hd, kTile))
      return launch_dq<kD, true>(a, B, hpb, vec, tm_k, tm_v, k_in | v_in << 1, stream);
  }
  return launch_dq<kD, false>(a, B, hpb, vec, tm_k, tm_v, 0, stream);
}

// ---- the f32 launches, and the dispatch ----

int launch_dkv_f32(const Args& a, int B, cudaStream_t stream) {
  const int pitch = a.hd + 1;
  const size_t smem =
      (size_t)(4 * kTile * pitch + 2 * kTile * kPitchS + 2 * kTile) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.nkv, B);
  flash_bwd_dkv_kernel<float><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_dq_f32(const Args& a, int B, cudaStream_t stream) {
  const int pitch = a.hd + 1;
  const size_t smem =
      (size_t)(4 * kTile * pitch + kTile * kPitchS + 2 * kTile) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + kTile - 1) / kTile, a.nh, B);
  flash_bwd_dq_kernel<float><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores, hd padded to 16 kD (ops/cuda/flash_attn.py:bwd_plan)
bool valid_mma(const Args& a, int kd, int hpb) {
  return 16 * kd >= a.hd && (hpb == 1 || hpb == 2 || hpb == 4) && a.group % hpb == 0;
}

int launch_dkv_bf16(const Args& a, int B, int kd, int hpb, int qrows, bool vec,
                    cudaStream_t stream) {
  if (!valid_mma(a, kd, hpb) || qrows < 16 || qrows % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (kd) {
    case 1: return launch_dkv_mma<1>(a, B, hpb, qrows, vec, stream);
    case 2: return launch_dkv_mma<2>(a, B, hpb, qrows, vec, stream);
    case 3: return launch_dkv_mma<3>(a, B, hpb, qrows, vec, stream);
    case 4: return launch_dkv_mma<4>(a, B, hpb, qrows, vec, stream);
    case 6: return launch_dkv_mma<6>(a, B, hpb, qrows, vec, stream);
    case 8: return launch_dkv_mma<8>(a, B, hpb, qrows, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_dq_bf16(const Args& a, int B, int kd, int hpb, bool vec, cudaStream_t stream) {
  if (!valid_mma(a, kd, hpb)) return (int)cudaErrorInvalidValue;
  switch (kd) {
    case 1: return launch_dq_mma<1>(a, B, hpb, vec, stream);
    case 2: return launch_dq_mma<2>(a, B, hpb, vec, stream);
    case 3: return launch_dq_mma<3>(a, B, hpb, vec, stream);
    case 4: return launch_dq_mma<4>(a, B, hpb, vec, stream);
    case 6: return launch_dq_mma<6>(a, B, hpb, vec, stream);
    case 8: return launch_dq_mma<8>(a, B, hpb, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
// v, dO, dQ).  bf16 only (ops/cuda/flash_attn.py:bwd_plan): kd, the head
// dims in 16-wide slices (1, 2, 3, 4, 6 or 8), hpb, the query heads a block
// packs (4, 2 or 1, dividing the group), qrows (dK/dV), the query rows a
// step stages per head (a multiple of 16), and vec: hd and every stride are
// multiples of 8 and every pointer 16-byte aligned, so rows move by 16-byte
// copies.  Each returns the CUDA error code of its launch.
extern "C" int dmi_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const int* key_mask, const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv, int B, int nh, int nkv,
                                 int T, int hd, const long long* strides, float scale, int kd,
                                 int hpb, int qrows, int vec, int dtype, void* stream) {
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
  if (dtype == dmi::kFloat32) return launch_dkv_f32(a, B, s);
  if (dtype == dmi::kBFloat16) return launch_dkv_bf16(a, B, kd, hpb, qrows, vec != 0, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dmi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const int* key_mask, const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int nh, int nkv, int T,
                                int hd, const long long* strides, float scale, int kd, int hpb,
                                int vec, int dtype, void* stream) {
  if (!valid_shape(B, nh, nkv, T, hd)) return (int)cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, key_mask, dout, lse, delta, nh, nkv, T, hd, scale);
  a.dq = dq;
  a.q_s = {strides[0], strides[1], strides[2]};
  a.k_s = {strides[3], strides[4], strides[5]};
  a.v_s = {strides[6], strides[7], strides[8]};
  a.do_s = {strides[9], strides[10], strides[11]};
  a.dq_s = {strides[12], strides[13], strides[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dmi::kFloat32) return launch_dq_f32(a, B, s);
  if (dtype == dmi::kBFloat16) return launch_dq_bf16(a, B, kd, hpb, vec != 0, s);
  return (int)cudaErrorInvalidValue;
}
