"""Single-token grouped-query decode attention.

Counterpart of dmi_tpu/ops/pallas/decode_attn.py:fused_decode_attention; its
TPU kernel (_decode_attn_pallas) is csrc/decode_attn.cu here, with the score
scale and attention softcap of the oracle llama._decode_attention added.  On
the TPU the kernel stayed unwired, because the pallas_call boundary forced a
layout conversion of the cache; on Hopper the kernel reads the batch-first
cache where it lies, so the port runs it on every layer of every decode
step.  It reads the K/V cache once per call, ~g FLOPs per bf16 byte: bound
by device memory bandwidth, and at caption lengths by launch latency.  The
kernel streams the keys in chunks with an online softmax, so the cache may
have any length, as dmi_tpu's loops allow.

`fused_decode_attention` runs `_decode_attn_plain` for tensors on the CPU
and launches the kernel for tensors on a CUDA device; there is no fallback
between the two.
"""

from __future__ import annotations

import math

import torch

from dmi_tpu_torch.ops.cuda import _build

# launches of the CUDA kernel since the count was last set to 0
launches = 0

MAX_HEAD_DIM = 256      # kMaxHdPerLane * 32 of csrc/decode_attn.cu
MAX_GROUP = 32          # one warp per query head: 32 warps per block
SCORE_FLOATS = 12288    # kScoreFloats: a block's [group, chunk] f32 scores, 48 KB


def score_chunk(S: int, group: int) -> int:
    """Keys per chunk of the kernel's online softmax: all S when their
    [group, S] f32 scores fit SCORE_FLOATS (S <= 3072 at group 4: one
    chunk, a plain softmax), else the most that fit."""
    return max(1, min(S, SCORE_FLOATS // group))


def _decode_attn_plain(q, k, v, bias, scale=None, softcap=None):
    """The kernel's math in plain torch, all in f32 (q and k widened before
    the product, as the Pallas body does); output in v's dtype.  At f32 it
    is dmi_tpu's llama._decode_attention and _decode_attn_xla.

    q [B, nh, 1, hd], k/v [B, nkv, S, hd], bias [S] f32 -> [B, nh, 1, hd]."""
    B, nh, _, hd = q.shape
    nkv = k.shape[1]
    qr = q.float().reshape(B, nkv, nh // nkv, 1, hd)
    s = (qr * k.float()[:, :, None]).sum(-1)  # [B, nkv, g, S]
    s = s * (scale if scale is not None else 1.0 / math.sqrt(hd))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p = torch.softmax(s + bias.float(), dim=-1)
    out = (p[..., None] * v.float()[:, :, None]).sum(3)  # [B, nkv, g, hd]
    return out.reshape(B, nh, 1, hd).to(v.dtype)


def fused_decode_attention(q, k, v, bias, scale=None, softcap=None):
    """q [B, nh, 1, hd], k/v [B, nkv, S, hd] (rows contiguous; a view of a
    longer cache's first S positions is read in place), bias [S] f32
    (batch-uniform: every row decodes at one position) -> [B, nh, 1, hd].

    The port's decode loop passes a view of the written positions and a
    zero bias.  The bias row is there for a step over a fixed-length cache,
    which masks the unwritten tail with it as the JAX loop does: a decode
    step captured in a CUDA graph has static shapes and needs that."""
    global launches
    B, nh, T, hd = q.shape
    _, nkv, S, _ = k.shape
    if (T != 1 or k.shape != (B, nkv, S, hd) or v.shape != k.shape
            or nh % nkv or bias.shape != (S,)):
        raise ValueError(
            f"decode attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias {tuple(bias.shape)}"
        )
    if len({t.device for t in (q, k, v, bias)}) != 1:
        raise ValueError("decode attention: all tensors must be on one device")
    if q.device.type == "cpu":
        return _decode_attn_plain(q, k, v, bias, scale, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: no kernel for device {q.device}")
    group = nh // nkv
    if q.dtype != k.dtype or v.dtype != k.dtype or bias.dtype != torch.float32:
        raise TypeError("decode attention kernel: q/k/v share one dtype, bias is f32")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("decode attention kernel is forward-only")
    if hd > MAX_HEAD_DIM or group > MAX_GROUP:
        raise ValueError(
            f"decode attention kernel: hd {hd} (<= {MAX_HEAD_DIM}), group "
            f"{group} (<= {MAX_GROUP})"
        )
    if not (q.is_contiguous() and bias.is_contiguous()):
        raise ValueError("decode attention kernel: q and bias must be contiguous")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError("decode attention kernel: k/v rows must be contiguous")
    code = _build.dtype_code(q.dtype)
    out = torch.empty((B, nh, 1, hd), dtype=v.dtype, device=q.device)
    if B == 0:
        return out
    err = _build.lib().dmi_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, nkv, group, S, hd, score_chunk(S, group), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1),
        float(scale if scale is not None else 1.0 / math.sqrt(hd)),
        float(softcap) if softcap is not None else 0.0,
        code, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode attention")
    launches += 1
    return out
