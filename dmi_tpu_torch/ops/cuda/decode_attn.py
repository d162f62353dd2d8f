"""Single-token grouped-query decode attention.

Counterpart of dmi_tpu/ops/pallas/decode_attn.py:fused_decode_attention; its
TPU kernel (_decode_attn_pallas) is csrc/decode_attn.cu here, with the score
scale and attention softcap of the oracle llama._decode_attention added.  On
the TPU the kernel stayed unwired, because the pallas_call boundary forced a
layout conversion of the cache; on Hopper the kernel reads the batch-first
cache where it lies, so the port runs it on every layer of every decode
step.  It reads the K/V cache once per call, ~g FLOPs per bf16 byte: bound
by device memory bandwidth, and at caption lengths by the latency of one
block's loads.  The kernel stages the keys in chunks with an online
softmax, so the cache may have any length, as dmi_tpu's loops allow; when
B x nkv blocks cannot fill the card, `plan` splits S over blocks and a
merge pass adds the splits' f32 partials in a fixed order (no float
atomics: two calls are bit-equal).  `_decode_attn_split_plain` is that
split and merge in plain torch.  bf16 at hd <= 128 and group <= 16 (the
serving path) forms the products on the tensor cores, f32 and wider bf16
heads or groups on the CUDA cores (`tensor_cores`); both are the one
function of the C entry, chosen by dtype and shape.

`fused_decode_attention` runs `_decode_attn_plain` for tensors on the CPU
and launches the kernel for tensors on a CUDA device; there is no fallback
between the two.
"""

from __future__ import annotations

import functools
import math

import torch

from dmi_tpu_torch.ops.cuda import _build

# launches of the CUDA kernels since the count was last set to 0 (a call
# that splits S launches the kernel and its merge and counts once)
launches = 0

MAX_HEAD_DIM = 256      # kMaxHd of csrc/decode_attn.cu
MAX_GROUP = 32          # kMaxGroup: query heads of a block
MMA_MAX_HEAD_DIM = 128  # bf16 up to this hd and MMA_MAX_GROUP runs on the tensor cores
MMA_MAX_GROUP = 16      # the group's heads are the 16 rows of an mma tile
MMA_KD = (1, 2, 3, 4, 6, 8)  # the tensor-core kernel's instances: hd padded to 16 kd
SMEM_LIMIT = 232448     # 227 KB: a block's shared memory on the H100
CHUNKS = (64, 32, 16)   # keys per staged chunk, the largest whose two stages fit first
SMS = 132               # streaming multiprocessors of the H100
TARGET_BLOCKS = 8 * SMS  # blocks a call should reach before S is split (half as many
                         # when each split needs several chunks)
MAX_SPLITS = 4096       # kMaxSplits: the merge keeps every split's weight in shared memory
MIN_SPLIT_KEYS = 64     # no split holds fewer keys: a cache this short is never split


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tensor_cores(itemsize: int, group: int, hd: int) -> bool:
    """Whether a call runs the tensor-core kernel (bf16, hd <= 128, group <=
    16) rather than the CUDA-core one (f32 always: no TF32)."""
    return itemsize == 2 and hd <= MMA_MAX_HEAD_DIM and group <= MMA_MAX_GROUP


def smem_bytes(itemsize: int, group: int, hd: int, chunk: int, stages: int) -> int:
    """Dynamic shared memory of a block.  The tensor-core kernel: 16 rows of
    Q and the K and V stages as bf16 at a pitch of 16 kd + 8, the bias
    stages.  The CUDA-core kernel (Layout of csrc/decode_attn.cu): the K and
    V stages at hd rounded up to the 16-byte vector, the bias stages, q and
    the scores in f32, and m, l, alpha per query head."""
    if tensor_cores(itemsize, group, hd):
        kd = next(d for d in MMA_KD if 16 * d >= hd)
        return (16 + stages * 2 * chunk) * (16 * kd + 8) * 2 + stages * chunk * 4
    width = _round_up(hd, 16 // itemsize)
    return (stages * 2 * chunk * width * itemsize + _round_up(stages * chunk, 4) * 4
            + group * width * 4 + group * chunk * 4 + 3 * group * 4)


@functools.lru_cache(maxsize=None)
def plan(B: int, nkv: int, group: int, S: int, hd: int, itemsize: int) -> dict:
    """The kernel's launch plan: keys per staged chunk, keys per split,
    splits of S over blocks, stages of the K/V ring and warps of a block.
    Cached per shape, so that a decode loop pays a dictionary lookup a call.

    S is split only when B x nkv blocks fall short of TARGET_BLOCKS and S
    exceeds MIN_SPLIT_KEYS, into splits of whole chunks, none empty: at the
    serving shapes (B 64-256 x 8 kv heads, S <= 38) one split, one launch
    and no merge.  Splits of one chunk aim at TARGET_BLOCKS blocks, longer
    ones at half as many (their two stages take more shared memory, so
    fewer fit an SM, and as many blocks would run in two waves).  The
    tensor-core kernel runs one warp over a split of one chunk (no combine
    of warps' states) and four warps over 64-key chunks; the CUDA-core
    kernel four warps over the largest of CHUNKS whose two stages fit a
    block's shared memory.  A chunk is no longer than the split rounded up
    to 16 keys; one stage when a split is one chunk."""
    mma = tensor_cores(itemsize, group, hd)
    cmax = 64 if mma else next(
        (c for c in CHUNKS if smem_bytes(itemsize, group, hd, c, 2) <= SMEM_LIMIT), CHUNKS[-1])
    def split_keys(target):
        want = -(-target // (B * nkv))
        return max(MIN_SPLIT_KEYS, _round_up(-(-S // want), cmax),
                   _round_up(-(-S // MAX_SPLITS), cmax))

    splits, keys = 1, S
    if B * nkv < TARGET_BLOCKS and S > MIN_SPLIT_KEYS:
        keys = split_keys(TARGET_BLOCKS)
        if keys > cmax:  # splits of several chunks: half as many blocks, each one wave
            keys = split_keys(TARGET_BLOCKS // 2)
        splits = -(-S // keys)
        if splits == 1:
            keys = S
    if mma:  # one warp for a split of one chunk, else four over chunks of 64
        warps = 1 if keys <= cmax else 4
        chunk = min(cmax, _round_up(keys, 16))
    else:
        warps, chunk = 4, min(cmax, _round_up(keys, 16))
    stages = 1 if keys <= chunk else 2
    return {"chunk": chunk, "keys_per_split": keys, "splits": splits, "stages": stages,
            "warps": warps, "tensor_cores": mma, "blocks": B * nkv * splits,
            "smem": smem_bytes(itemsize, group, hd, chunk, stages)}


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


def _decode_attn_split_plain(q, k, v, bias, p, scale=None, softcap=None):
    """The kernel's split and merge in plain torch, all in f32: each of
    p["splits"] splits of p["keys_per_split"] keys runs an online softmax
    over chunks of p["chunk"] keys (running max m, sum l and accumulator,
    rescaled by exp(m_old - m_new), 0 while m_old is -inf; p = 0 while
    m_new is -inf) and leaves (m, l, acc); the merge adds the splits in
    split order, each weighted by exp(m_i - max m), 0 for m_i = -inf.  The
    same function as `_decode_attn_plain` in another order of operations."""
    B, nh, _, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, nkv, nh // nkv, hd)
    kf, vf, bf = k.float(), v.float(), bias.float()
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    neg = float("-inf")
    parts = []
    for sp in range(p["splits"]):
        s0, s1 = sp * p["keys_per_split"], min(S, (sp + 1) * p["keys_per_split"])
        m = torch.full(qf.shape[:3], neg)
        l = torch.zeros(qf.shape[:3])
        acc = torch.zeros(qf.shape)
        for c0 in range(s0, s1, p["chunk"]):
            c1 = min(s1, c0 + p["chunk"])
            s = torch.einsum("bngd,bnsd->bngs", qf, kf[:, :, c0:c1]) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            s = s + bf[c0:c1]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.where(m == neg, 0.0, torch.exp(m - m_new))
            e = torch.where(m_new[..., None] == neg, 0.0, torch.exp(s - m_new[..., None]))
            l = l * alpha + e.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bngs,bnsd->bngd", e, vf[:, :, c0:c1])
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = torch.zeros(qf.shape), torch.zeros(qf.shape[:3])
    for m, l, acc in parts:
        w = torch.where(m == neg, 0.0, torch.exp(m - mx))
        num, den = num + w[..., None] * acc, den + w * l
    return (num / den[..., None]).reshape(B, nh, 1, hd).to(v.dtype)


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
    p = plan(B, nkv, group, S, hd, q.element_size())
    part = None
    if p["splits"] > 1:  # f32 partials (m, l, acc) of every split, merged in order
        part = torch.empty(B * nh * p["splits"] * (hd + 2), dtype=torch.float32,
                           device=q.device)
    err = _build.lib().dmi_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        B, nkv, group, S, hd, p["chunk"], p["keys_per_split"], p["splits"], p["stages"],
        p["warps"], k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale if scale is not None else 1.0 / math.sqrt(hd)),
        float(softcap) if softcap is not None else 0.0,
        code, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode attention")
    launches += 1
    return out
