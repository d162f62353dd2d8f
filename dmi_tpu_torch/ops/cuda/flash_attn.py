"""Causal flash attention over the full sequence, forward and backward.

Counterpart of dmi_tpu/models/llama.py:_flash_attention, the training
attention of every layer, whose TPU kernels are the Pallas library's flash
attention: the forward (`_flash_attention_impl`) and the two backward
kernels (`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`) of jax's
jax/experimental/pallas/ops/tpu/flash_attention.py.  Here they are
csrc/flash_attn_fwd.cu and csrc/flash_attn_bwd.cu, wrapped in one
torch.autograd.Function.  Differences from the TPU path, none in the math:

  * GQA is native (query head h reads kv head h // group); the TPU wrapper
    repeated k and v over the group for the library's layout.  The bf16
    forward packs the query heads of a kv head into one block, so they
    share its staged K and V tiles.
  * The bf16 kernels run every product on the tensor cores (mma.sync);
    the f32 instances run on the CUDA cores.  The bf16 dK/dV kernel packs
    query heads of a kv head into one block too, each warp summing one
    head's share of its keys' gradients; the heads' shares are summed in the
    block in a fixed order (no atomics: identical calls give identical
    gradients).  At hd 49-64 the backward's walked tiles come by TMA.
  * Any T: the kernels mask the ragged last tile; the TPU wrapper padded T
    to a multiple of 128.
  * q, k, v, the output and the gradients keep free batch, head and row
    strides, so a transformer block passes its [B, T, heads, hd]
    projections in place.

Semantics (the TPU path's, llama.py:1089-1095): query i attends key j when
j <= i and key_mask[b, j] is 1 (None: all keys); queries are never masked.
Scores and softmax in f32, p rounded to v's dtype before p . v, output in
q's dtype.

`flash_attention` runs `_flash_attn_plain` (differentiated by autograd) for
tensors on the CPU and launches the kernels for tensors on a CUDA device;
there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dmi_tpu_torch.ops.cuda import _build

# launches of each CUDA kernel since the counts were last set to 0
fwd_launches = 0
dkv_launches = 0
dq_launches = 0

MAX_HEAD_DIM = 128  # kMaxHd of csrc/flash_attn.cuh
TILE = 64           # kTile: query rows and keys per tile
HEAD_SLICES = (1, 2, 3, 4, 6, 8)  # the bf16 forward's instances: hd padded to 16 kd


def fwd_plan(B: int, nh: int, nkv: int, T: int, hd: int, dtype) -> dict:
    """The forward kernel's launch.  bf16 runs on the tensor cores: 128
    threads, 4 warps of 16 query rows; a block packs hpb query heads of one
    kv head (4, 2 or 1, the most that divide the group), 64 / hpb rows of
    each, so the heads share every K and V tile it stages; hd is padded with
    zeros to 16 kd (kd the least of HEAD_SLICES that holds it); shared
    memory holds the warps' Q rows and two K and two V tiles of
    [64, 16 kd + 8] bf16.  f32 runs on the CUDA cores: one block of 256
    threads per (64-query tile, head), Q, K, V [64, hd + 1] and a [64, 65]
    p tile of f32."""
    if dtype == torch.bfloat16:
        kd = next(d for d in HEAD_SLICES if 16 * d >= hd)
        hpb = next(n for n in (4, 2, 1) if (nh // nkv) % n == 0)
        rows = TILE // hpb
        return {"grid": (-(-T // rows), nh // hpb, B), "threads": 128, "head_slices": kd,
                "heads_per_block": hpb, "rows": rows,
                "smem": 5 * TILE * (16 * kd + 8) * 2}
    return {"grid": (-(-T // TILE), nh, B), "threads": 256, "head_slices": 0,
            "heads_per_block": 1, "rows": TILE,
            "smem": (3 * TILE * (hd + 1) + TILE * (TILE + 1)) * 4}


def bwd_plan(B: int, nh: int, nkv: int, T: int, hd: int, dtype) -> dict:
    """The backward kernels' launches: {"dkv": ..., "dq": ...}, each with
    its grid, threads and shared memory, and "walk", the steps that the
    blocks of each grid column take one after another (dK/dV: staged query
    steps over the group's heads; dQ: key tiles); blocks of the longest
    walks start first.

    bf16 runs on the tensor cores, 128 threads, hd padded to 16 kd as
    `fwd_plan` pads it.  dK/dV: a warp owns 16 keys of one of hpb query
    heads, so a block owns 64 / hpb keys ("keys") and walks the group's
    heads hpb at a time and the query rows from its first key to T,
    staging "query_rows" rows of each of its heads a step (Q and dO, two
    buffers, with lse and delta), beside its keys' K and V.  hpb is 2 where
    the group is even and T passes one tile (T 65: three blocks of 32, 32
    and 1 keys, where 64-key blocks would leave three of four warps idle in
    every second block), else 1; steps of 32 rows up to T 128, else 64:
    the fastest or near it of hpb 1, 2, 4 by 16-64 rows at the training
    paths' shapes on the H100 (PERF.md).  dQ: the forward's grid and head
    packing; shared memory holds the warps' Q and dO rows and two K and
    two V tiles.  "smem" is the most a block takes (TMA tiles, at kd 4,
    take less: 64-column rows and 1 KB of alignment).

    f32 runs on the CUDA cores: blocks of 256 threads over 64-key (dK/dV,
    walking every head of the group) or 64-row (dQ) tiles of f32
    [64, hd + 1]."""
    group = nh // nkv
    n_t = -(-T // TILE)
    if dtype == torch.bfloat16:
        fwd = fwd_plan(B, nh, nkv, T, hd, dtype)
        kd, rows = fwd["head_slices"], fwd["rows"]
        ld = 16 * kd + 8
        hpb = 2 if group % 2 == 0 and T > TILE else 1
        keys, qrows = TILE // hpb, 32 if hpb == 2 and T <= 2 * TILE else 64
        n_kt = -(-T // keys)
        dkv = {"grid": (n_kt, nkv, B), "threads": 128, "head_slices": kd,
               "heads_per_block": hpb, "keys": keys, "query_rows": qrows,
               "smem": (2 * keys + 4 * hpb * qrows) * ld * 2 + 4 * hpb * qrows * 4 + 16,
               "walk": tuple(group // hpb * -(-(T - kt * keys) // qrows)
                             for kt in range(n_kt))}
        dq = {"grid": fwd["grid"], "threads": 128, "head_slices": kd,
              "heads_per_block": fwd["heads_per_block"], "rows": rows,
              "smem": (2 * 16 * 4 + 4 * TILE) * ld * 2 + 16,
              "walk": tuple((min(T, (qt + 1) * rows) - 1) // TILE + 1
                            for qt in range(fwd["grid"][0]))}
        return {"dkv": dkv, "dq": dq}
    pitch = hd + 1
    dkv = {"grid": (n_t, nkv, B), "threads": 256, "head_slices": 0, "heads_per_block": 1,
           "keys": TILE, "query_rows": TILE,
           "smem": (4 * TILE * pitch + 2 * TILE * (TILE + 1) + 2 * TILE) * 4,
           "walk": tuple(group * (n_t - kt) for kt in range(n_t))}
    dq = {"grid": (n_t, nh, B), "threads": 256, "head_slices": 0, "heads_per_block": 1,
          "rows": TILE, "smem": (4 * TILE * pitch + TILE * (TILE + 1) + 2 * TILE) * 4,
          "walk": tuple(qt + 1 for qt in range(n_t))}
    return {"dkv": dkv, "dq": dq}


def _flash_attn_plain(q, k, v, key_mask=None, scale=None):
    """The kernels' function in plain torch, the math of dmi_tpu's
    llama._attention: products in the input dtype, f32 softmax with the
    causal and key masks as an additive finfo.min bias, probabilities
    rounded to v's dtype.

    q [B, nh, T, hd], k/v [B, nkv, T, hd], key_mask [B, T] or None ->
    [B, nh, T, hd] in q's dtype."""
    B, nh, T, hd = q.shape
    nkv = k.shape[1]
    qg = q.reshape(B, nkv, nh // nkv, T, hd)
    scores = torch.einsum("bkgtd,bksd->bkgts", qg, k).float()
    scores = scores * (scale if scale is not None else 1.0 / math.sqrt(hd))
    pos = torch.arange(T, device=q.device)
    valid = (pos[None, :] <= pos[:, None])[None]  # [1, T, T]
    if key_mask is not None:
        valid = valid & (key_mask[:, None, :] != 0)
    bias = torch.where(valid, 0.0, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores + bias[:, None, None], dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, v)
    return out.reshape(B, nh, T, hd).to(q.dtype)


def _strides(*tensors):
    """(batch, head, row) element strides of each [B, heads, T, hd] tensor,
    as the int64 array the C entry points read."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _vec(hd, *tensors) -> int:
    """1 when rows move by 16-byte copies of 8 bf16: hd a multiple of 8 and
    every row of every tensor starting on 16 bytes."""
    return int(hd % 8 == 0 and all(t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                                                  for st in t.stride()[:3])
                                   for t in tensors))


def _fwd_kernel(q, k, v, key_mask, scale):
    """Launch csrc/flash_attn_fwd.cu on checked CUDA tensors (key_mask int32
    contiguous or None) -> (o in q's layout, lse [B, nh, T] f32)."""
    global fwd_launches
    B, nh, T, hd = q.shape
    o = torch.empty_like(q)  # q's layout: a block's reshape after it is free
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=q.device)
    plan = fwd_plan(B, nh, k.shape[1], T, hd, q.dtype)
    err = _build.lib().dmi_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask), o.data_ptr(),
        lse.data_ptr(), B, nh, k.shape[1], T, hd, _strides(q, k, v, o), scale,
        plan["head_slices"], plan["heads_per_block"], _vec(hd, q, k, v, o),
        _build.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash attention forward")
    fwd_launches += 1
    return o, lse


def _bwd_dkv_kernel(q, k, v, key_mask, do, lse, delta, scale, heads_per_block=None,
                    query_rows=None):
    """Launch the dK/dV kernel of csrc/flash_attn_bwd.cu -> (dk, dv).
    heads_per_block and query_rows replace bwd_plan's choice (bf16), to
    time the other plans."""
    global dkv_launches
    B, nh, T, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan = dict(bwd_plan(B, nh, k.shape[1], T, hd, q.dtype)["dkv"])
    if heads_per_block is not None:
        plan.update(heads_per_block=heads_per_block, query_rows=query_rows)
    err = _build.lib().dmi_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, nh, k.shape[1], T, hd, _strides(q, k, v, do, dk, dv), scale,
        plan["head_slices"], plan["heads_per_block"], plan["query_rows"],
        _vec(hd, q, k, v, do, dk, dv), _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash attention backward dK/dV")
    dkv_launches += 1
    return dk, dv


def _bwd_dq_kernel(q, k, v, key_mask, do, lse, delta, scale):
    """Launch the dQ kernel of csrc/flash_attn_bwd.cu -> dq."""
    global dq_launches
    B, nh, T, hd = q.shape
    dq = torch.empty_like(q)
    plan = bwd_plan(B, nh, k.shape[1], T, hd, q.dtype)["dq"]
    err = _build.lib().dmi_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, nh, k.shape[1], T, hd, _strides(q, k, v, do, dq), scale,
        plan["head_slices"], plan["heads_per_block"], _vec(hd, q, k, v, do, dq),
        _build.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash attention backward dQ")
    dq_launches += 1
    return dq


def _delta(do, o):
    """rowsum(dO * O) in f32, [B, nh, T] contiguous (the TPU wrapper's di);
    the product of two bf16 is exact in f32, and o is widened inside the
    multiply."""
    return (do.float() * o).sum(-1).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        o, lse = _fwd_kernel(q, k, v, key_mask, scale)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        if do.dtype != q.dtype:
            raise TypeError(f"flash attention backward: dO is {do.dtype}, q is {q.dtype}")
        if do.stride(-1) != 1:  # autograd may hand an expanded gradient
            do = do.contiguous()
        delta = _delta(do, o)
        dk, dv = _bwd_dkv_kernel(q, k, v, key_mask, do, lse, delta, ctx.scale)
        dq = _bwd_dq_kernel(q, k, v, key_mask, do, lse, delta, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, key_mask=None, scale=None):
    """q [B, nh, T, hd], k/v [B, nkv, T, hd] (last dim contiguous; batch,
    head and row strides free), key_mask [B, T] of 0/1 or None, scale
    (None: hd ** -0.5) -> [B, nh, T, hd] in q's dtype, differentiable in
    q, k and v."""
    B, nh, T, hd = q.shape
    nkv = k.shape[1]
    if (k.shape != (B, nkv, T, hd) or v.shape != k.shape or nkv == 0 or nh % nkv
            or (key_mask is not None and key_mask.shape != (B, T))):
        raise ValueError(
            f"flash attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, key_mask "
            f"{None if key_mask is None else tuple(key_mask.shape)}"
        )
    tensors = (q, k, v) if key_mask is None else (q, k, v, key_mask)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash attention: all tensors must be on one device")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return _flash_attn_plain(q, k, v, key_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash attention kernel: q, k and v must share one dtype")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel: hd {hd} > {MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel: q/k/v rows must be contiguous")
    if key_mask is not None:
        if key_mask.dtype.is_floating_point:
            raise TypeError("flash attention kernel: key_mask must be integer or bool")
        key_mask = key_mask.to(torch.int32).contiguous()
    if B == 0 or T == 0:
        return torch.empty_like(q)
    return _FlashAttention.apply(q, k, v, key_mask, scale)
