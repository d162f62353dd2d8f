"""Grouped-query decode attention: one query position per cache row (a
decode step), or P of them (K3: a speculative verify forward).

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
function of the C entry, chosen by dtype and shape.  The bias is one [S]
row shared by the batch (the batch loops: every row decodes at one
position) or a [B, S] row per batch row (dmi_tpu's [B, 1, S]: the slots of
the continuous-batching engine, streaming.py, decode at different ages);
the kernel reads either through a row stride, 0 or S.  With P query
positions per cache row (the k + 1 positions of a speculative round,
models/speculative.py) the bias is [B, P, S], a row per (row, position),
and q and the output are [B, nh, P, hd] (K3).  A block then owns one
(cache row, kv head) and its g x P (head, position) query rows, q's own
contiguous run, and stages each chunk of the row's K and V once for all of
them: on the tensor cores they fill ceil(g P / 16) mma row tiles, a warp
each, at most MMA_MAX_TILES; on the CUDA cores at most MAX_GROUP rows.
Past that cap `plan` deals the positions to blocks in position chunks, so
it counts B x nkv x position chunks x splits blocks.  q and the output keep
q's layout: the wrapper copies only a q that is not contiguous (the
batch-last step's view, as at P = 1).

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
# that splits S launches the kernel and its merge and counts once), and of
# those, the launches with a [B, S] bias (a row per batch row) and the
# launches with P > 1 query positions per cache row (K3)
launches = 0
row_launches = 0
pos_launches = 0

MAX_HEAD_DIM = 256      # kMaxHd of csrc/decode_attn.cu
MAX_GROUP = 32          # kMaxGroup: query heads of a block
MMA_MAX_HEAD_DIM = 128  # bf16 up to this hd and MMA_MAX_GROUP runs on the tensor cores
MMA_MAX_GROUP = 16      # the group's heads are the 16 rows of an mma tile
MMA_KD = (1, 2, 3, 4, 6, 8)  # the tensor-core kernel's instances: hd padded to 16 kd
MMA_MAX_TILES = 4       # row tiles of 16 a block at most, a warp each (kMmaTiles)
SMEM_LIMIT = 232448     # 227 KB: a block's shared memory on the H100
CHUNKS = (64, 32, 16)   # keys per staged chunk, the largest whose two stages fit first
SMS = 132               # streaming multiprocessors of the H100
SM_SMEM = 233472        # shared memory of an SM (228 KB), of which a block also takes 1 KB
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


def _mma_kd(hd: int) -> int:
    return next(d for d in MMA_KD if 16 * d >= hd)


def block_rows(itemsize: int, group: int, hd: int) -> int:
    """The most query rows a block holds: MMA_MAX_TILES row tiles of 16 on
    the tensor cores (a warp each), MAX_GROUP on the CUDA cores."""
    return 16 * MMA_MAX_TILES if tensor_cores(itemsize, group, hd) else MAX_GROUP


def smem_bytes(itemsize: int, group: int, hd: int, chunk: int, stages: int, pos: int = 1,
               warps: int = 1) -> int:
    """Dynamic shared memory of a block holding the group's heads at pos
    query positions each (rows = group x pos).  The tensor-core kernel
    (mma_smem of csrc/decode_attn.cu): Q's rows in whole tiles of 16 and the
    K and V stages as bf16 at a pitch of 16 kd + 8, the bias stages (a row
    per position); where several warps share a row tile their states reuse
    the stages at the end.  The CUDA-core kernel (Layout of
    csrc/decode_attn.cu): the K and V stages at hd rounded up to the 16-byte
    vector, the bias stages, q and the scores in f32, and m, l, alpha per
    query row."""
    rows = group * pos
    if tensor_cores(itemsize, group, hd):
        qrows = 16 * -(-rows // 16)
        ld, nkw = 16 * _mma_kd(hd) + 8, warps // (qrows // 16)
        staged = stages * 2 * chunk * ld * 2 + stages * pos * chunk * 4
        states = (nkw * 3 * qrows + qrows + nkw * qrows * hd) * 4 if nkw > 1 else 0
        return qrows * ld * 2 + max(staged, states)
    width = _round_up(hd, 16 // itemsize)
    return (stages * 2 * chunk * width * itemsize + _round_up(stages * pos * chunk, 4) * 4
            + rows * width * 4 + rows * chunk * 4 + 3 * rows * 4)


@functools.lru_cache(maxsize=None)
def plan(B: int, nkv: int, group: int, S: int, hd: int, itemsize: int, P: int = 1) -> dict:
    """The kernel's launch plan: keys per staged chunk, keys per split,
    splits of S over blocks, stages of the K/V ring and warps of a block;
    with P > 1 query positions per cache row also the positions a block
    holds (`pos_chunk`) and their chunks (`pos_chunks`).  Cached per shape,
    so that a decode loop pays a dictionary lookup a call.

    P = 1: S is split only when B x nkv blocks fall short of TARGET_BLOCKS
    and S exceeds MIN_SPLIT_KEYS, into splits of whole chunks, none empty:
    at the serving shapes (B 64-256 x 8 kv heads, S <= 38) one split, one
    launch and no merge.  Splits of one chunk aim at TARGET_BLOCKS blocks,
    longer ones at half as many (their two stages take more shared memory,
    so fewer fit an SM, and as many blocks would run in two waves).  The
    tensor-core kernel runs one warp over a split of one chunk (no combine
    of warps' states) and four warps over 64-key chunks; the CUDA-core
    kernel four warps over the largest of CHUNKS whose two stages fit a
    block's shared memory.  A chunk is no longer than the split rounded up
    to 16 keys; one stage when a split is one chunk.

    P > 1 (K3): the positions of a (cache row, kv head) share its blocks,
    all P when group x P rows fit `block_rows`, else in as few even position
    chunks as fit.  The tensor-core kernel runs a warp on each row tile of
    16, over every key of the split.  S is split only when B x nkv x
    position chunks blocks fall short of the SMs: the merge takes a block
    per query row, and at the verify's shape (B 128, 1024 blocks) two
    splits and their merge took 71-74 us where one split took 21-27 us
    (scripts/torch_decode_attn_compare.py, NVIDIA H100 80GB HBM3).  A split
    longer than the P = 1 chunk streams in the largest of CHUNKS whose
    blocks all fit the card at once (by shared memory), else in chunks of
    16 keys: every block of the call starts at once and streams its K and
    V, and a block that waits for a slot starts its reads only when another
    has ended."""
    mma = tensor_cores(itemsize, group, hd)
    pos_chunks = -(-P // max(1, block_rows(itemsize, group, hd) // group))
    pc = -(-P // pos_chunks)  # even chunks: the last holds at most as many
    cmax = 64 if mma else next(
        (c for c in CHUNKS if smem_bytes(itemsize, group, hd, c, 2, pc) <= SMEM_LIMIT),
        CHUNKS[-1])
    blocks = B * nkv * pos_chunks

    def split_keys(target):
        want = -(-target // blocks)
        return max(MIN_SPLIT_KEYS, _round_up(-(-S // want), cmax),
                   _round_up(-(-S // MAX_SPLITS), cmax))

    splits, keys = 1, S
    if blocks < (TARGET_BLOCKS if P == 1 else SMS) and S > MIN_SPLIT_KEYS:
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
    if P > 1:
        if mma:  # a warp a row tile
            warps = -(-group * pc // 16)
        if keys > chunk:  # the largest chunk whose blocks all fit the card at once
            fits = [c for c in CHUNKS if c <= cmax and SMS * (SM_SMEM // (
                smem_bytes(itemsize, group, hd, c, 2, pc, warps) + 1024)) >= blocks * splits]
            chunk = fits[0] if fits else CHUNKS[-1]
    stages = 1 if keys <= chunk else 2
    out = {"chunk": chunk, "keys_per_split": keys, "splits": splits, "stages": stages,
           "warps": warps, "tensor_cores": mma, "blocks": blocks * splits,
           "smem": smem_bytes(itemsize, group, hd, chunk, stages, pc, warps)}
    if P > 1:
        out.update(pos_chunk=pc, pos_chunks=pos_chunks)
    return out


def _decode_attn_plain(q, k, v, bias, scale=None, softcap=None):
    """The kernel's math in plain torch, all in f32 (q and k widened before
    the product, as the Pallas body does); output in v's dtype.  At f32 it
    is dmi_tpu's llama._decode_attention and _decode_attn_xla.

    q [B, nh, P, hd], k/v [B, nkv, S, hd], bias [S], [B, S] (P = 1) or
    [B, P, S] f32 -> [B, nh, P, hd].  The P positions of a cache row are
    more query rows over the same K and V: the group's g x P rows, each
    with its position's bias row.  v may be narrower than q and k (MLA's
    v_head_dim, a call the kernel does not take); the output then has v's
    width."""
    B, nh, P, hd = q.shape
    nkv = k.shape[1]
    g = nh // nkv
    qr = q.float().reshape(B, nkv, g * P, 1, hd)
    s = (qr * k.float()[:, :, None]).sum(-1)  # [B, nkv, g * P, S]
    s = s * (scale if scale is not None else 1.0 / math.sqrt(hd))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p = torch.softmax(s + _bias_rows(bias, g), dim=-1)
    out = (p[..., None] * v.float()[:, :, None]).sum(3)  # [B, nkv, g * P, dv]
    return out.reshape(B, nh, P, v.shape[-1]).to(v.dtype)


def _decode_attn_split_plain(q, k, v, bias, p, scale=None, softcap=None):
    """The kernel's split and merge in plain torch, all in f32: each of
    p["splits"] splits of p["keys_per_split"] keys runs an online softmax
    over chunks of p["chunk"] keys (running max m, sum l and accumulator,
    rescaled by exp(m_old - m_new), 0 while m_old is -inf; p = 0 while
    m_new is -inf) and leaves (m, l, acc); the merge adds the splits in
    split order, each weighted by exp(m_i - max m), 0 for m_i = -inf.  The
    same function as `_decode_attn_plain` in another order of operations,
    P query positions per cache row as there."""
    B, nh, P, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    g = nh // nkv
    qf = q.float().reshape(B, nkv, g * P, hd)
    kf, vf, bf = k.float(), v.float(), _bias_rows(bias, g)
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
            s = s + bf[..., c0:c1]
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
    return (num / den[..., None]).reshape(B, nh, P, hd).to(v.dtype)


def _bias_rows(bias, g: int):
    """The bias in f32, shaped to broadcast against [B, nkv, g * P, S]
    scores (query row i * P + p of a group takes position p's row)."""
    b = bias.float()
    if b.ndim == 1:
        return b
    if b.ndim == 2:
        return b[:, None, None, :]
    B, P, S = b.shape
    return b[:, None, None].expand(B, 1, g, P, S).reshape(B, 1, g * P, S)


def fused_decode_attention(q, k, v, bias, scale=None, softcap=None):
    """q [B, nh, P, hd], k/v [B, nkv, S, hd] (rows contiguous; a view of a
    longer cache's first S positions is read in place), bias [S] f32
    (batch-uniform: every row decodes at one position), [B, S] f32 (a row
    per batch row) or, with P query positions per cache row, [B, P, S] f32
    (a row per position) -> [B, nh, P, hd] in v's dtype.

    The batch loops pass a view of the written positions and a zero [S]
    row.  The continuous-batching engine attends over its whole ring cache
    with a [B, S] row of 0 on each slot's own entries and finfo.min
    elsewhere; a row that is finfo.min everywhere (a slot never used) gives
    the average of its V rows, finite, as the twin does.  The speculative
    verify forward attends from the k + 1 positions of a round, P = k + 1,
    each with its own causal row (K3)."""
    B, nh, P, hd = q.shape
    _, nkv, S, _ = k.shape
    # P > 1 positions take a row each: a shared [S] or [B, S] row would let
    # every position of a cache row see the same keys
    biases = ((B, P, S),) + (((S,), (B, S)) if P == 1 else ())
    if (k.shape != (B, nkv, S, hd) or v.shape != k.shape or nh % nkv
            or tuple(bias.shape) not in biases):
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
    if P > 0xFFFF:
        raise ValueError(f"decode attention kernel: P {P} query positions (<= 65535)")
    if not bias.is_contiguous():
        raise ValueError("decode attention kernel: the bias must be contiguous")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError("decode attention kernel: k/v rows must be contiguous")
    q = q.contiguous()  # read in its own layout: no copy for a contiguous q
    out = torch.empty((B, nh, P, hd), dtype=v.dtype, device=q.device)
    if B == 0 or P == 0:
        return out
    _launch(q, k, v, bias, out, plan(B, nkv, group, S, hd, q.element_size(), P), scale,
            softcap)
    return out


def _launch(q, k, v, bias, out, p, scale=None, softcap=None):
    """One call of the kernel (and of its merge where p splits S) under the
    plan p, on tensors fused_decode_attention has checked; counted."""
    global launches, row_launches, pos_launches
    B, nh, P, hd = q.shape
    _, nkv, S, _ = k.shape
    part = None
    if p["splits"] > 1:  # f32 partials (m, l, acc) of every split, merged in order
        part = torch.empty(B * nh * P * p["splits"] * (hd + 2), dtype=torch.float32,
                           device=q.device)
    err = _build.lib().dmi_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        B, P, p.get("pos_chunk", 1), nkv, nh // nkv, S, hd, p["chunk"], p["keys_per_split"],
        p["splits"], p["stages"], p["warps"], k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), S if bias.ndim > 1 else 0,
        float(scale if scale is not None else 1.0 / math.sqrt(hd)),
        float(softcap) if softcap is not None else 0.0,
        _build.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode attention")
    launches += 1
    row_launches += int(bias.ndim == 2)
    pos_launches += int(P > 1)
