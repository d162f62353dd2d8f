"""Tied vocab-head product fused with the greedy argmax.

Counterpart of dmi_tpu/ops/pallas/head_argmax.py, whose TPU kernel
(_head_argmax_pallas) is csrc/head_argmax.cu here.  Greedy decode needs only
the argmax of the logits: the kernel streams the tied embedding's rows in
vocab slices, forms each slice's scores in shared memory and keeps a (best
score, first index) pair per batch column, so the [V, B] logits never reach
device memory.  Blocks own vocab slices in parallel; a second small kernel
merges their pairs by (score descending, index ascending), which is
deterministic and is argmax's first-occurrence rule.

Three weight modes (models/quant.py), each with the rounding order of the
logits path it replaces (decode._head_logits_bl), so the compare sees the
values the logits path would:

  bf16  embed [V, H] bf16: f32 accumulation, rounded to bf16
  q     int8 embed + row scales: bf16(embed) · h rounded to bf16, then times
        the bf16 scale, rounded to bf16
  q8    W8A8: int32 accumulation, (acc.f32 * s) * a rounded to bf16

The q8 mode is integer work and equals its twin bit for bit.  The bf16 and q
modes accumulate in another order than a library matmul, so a near-tie may
round to the other bf16 value and pick the other index.

`head_argmax` runs the twin for tensors on the CPU and launches the kernels
for tensors on a CUDA device; there is no fallback between the two.  dmi_tpu
gates its kernel by an environment variable and by the divisors of V; here
any V is taken (the last slice is guarded, the embed is not padded).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmi_tpu_torch.models.quant import int_matmul, quantize_act
from dmi_tpu_torch.ops.cuda import _build

# calls that launched the CUDA kernels since the count was last set to 0
launches = 0

MODES = {"bf16": 0, "q": 1, "q8": 2}
TILE_V = 128  # kTileV of csrc/head_argmax.cu: vocab rows per block


def head_logits_bl(embed, h) -> torch.Tensor:
    """Tied-head logits [V, B] of a batch-last state h [H, B], in the three
    weight modes, with the rounding order of dmi_tpu's decode step
    (dmi_tpu/models/decode.py:854-873)."""
    if isinstance(embed, dict) and "q8" in embed:
        hq, a = quantize_act(h, axis=0)
        return (int_matmul(embed["q8"], hq) * embed["s"][:, 0][:, None] * a).to(h.dtype)
    if isinstance(embed, dict):
        return (embed["q"].to(h.dtype) @ h) * embed["s"].to(h.dtype)[:, 0][:, None]
    return embed @ h


def _head_argmax_plain(embed, h) -> torch.Tensor:
    """The kernel's math in plain torch: the logits path followed by the
    argmax over the vocab axis (first occurrence on ties) -> [B] int64."""
    return head_logits_bl(embed, h).argmax(dim=0)


def _mode(embed) -> str:
    if not isinstance(embed, dict):
        return "bf16"
    if "q8" in embed:
        return "q8"
    if "q" in embed:
        return "q"
    raise ValueError(f"head argmax: unknown quantized embed keys {sorted(embed)}")


def head_argmax(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Greedy next-token ids straight from the final hidden state.

    params: the decode weight tree (tied embedding: bf16, "q" or "q8").
    h [H, B] bf16, the batch-last output of the final norm -> [B] int64.
    The kernel bakes in bf16 score rounding; an f32 model takes the logits
    path instead (decode.greedy_generate_bl)."""
    global launches
    embed = params["embed"]
    mode = _mode(embed)
    e = embed[mode] if mode != "bf16" else embed
    V, H = e.shape
    B = h.shape[1]
    if h.shape[0] != H:
        raise ValueError(f"head argmax shapes: embed {tuple(e.shape)}, h {tuple(h.shape)}")
    if h.dtype != torch.bfloat16 or (mode == "bf16" and e.dtype != torch.bfloat16):
        raise TypeError("head argmax rounds scores to bf16: it takes a bf16 state and a bf16 "
                        "or int8 embed")
    if mode != "bf16" and tuple(embed["s"].shape) != (V, 1):
        raise ValueError("head argmax: a quantized embed carries per-row scales [V, 1]")
    if e.device != h.device:
        raise ValueError("head argmax: all tensors must be on one device")
    if h.device.type == "cpu":
        return _head_argmax_plain(embed, h)
    if h.device.type != "cuda":
        raise ValueError(f"head argmax: no kernel for device {h.device}")
    if not e.is_contiguous():
        raise ValueError("head argmax kernel: the embed must be contiguous")
    if H % 16:
        raise ValueError(f"head argmax kernel: H {H} must be a multiple of 16 (16-byte loads)")
    dev = h.device
    scales = act_scales = None
    if mode == "q8":
        x, a = quantize_act(h, axis=0)
        act_scales = F.pad(a.reshape(-1), (0, -B % 16)).contiguous()
    else:
        x = h
    if mode != "bf16":
        scales = embed["s"].reshape(-1)
        if scales.dtype != torch.float32 or not scales.is_contiguous():
            raise TypeError("head argmax kernel: row scales are contiguous f32")
    # the kernels read rows of h 16 bytes at a time: pad the batch to a
    # multiple of 16 columns (their ids are dropped)
    Bp = B + (-B % 16)
    xp = x.contiguous() if Bp == B else F.pad(x, (0, Bp - B))
    blocks = -(-V // TILE_V)
    part_val = torch.empty((blocks, Bp), dtype=torch.float32, device=dev)
    part_idx = torch.empty((blocks, Bp), dtype=torch.int32, device=dev)
    ids = torch.empty((Bp,), dtype=torch.int32, device=dev)
    if B == 0:
        return ids[:0].long()
    err = _build.lib().dmi_head_argmax(
        e.data_ptr(), scales.data_ptr() if scales is not None else None, xp.data_ptr(),
        act_scales.data_ptr() if act_scales is not None else None,
        part_val.data_ptr(), part_idx.data_ptr(), ids.data_ptr(), V, H, Bp, MODES[mode],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "head argmax")
    launches += 1
    return ids[:B].long()
