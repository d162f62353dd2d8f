"""Vocab-head product fused with the greedy argmax.

Counterpart of dmi_tpu/ops/pallas/head_argmax.py, whose TPU kernel
(_head_argmax_pallas) is csrc/head_argmax.cu here.  Greedy decode needs only
the argmax of the logits: the kernel streams the head's rows [V, H] (the
tied embedding, or an untied bf16 lm_head transposed once a call:
decode.fused_head_weights) through a TMA ring into the tensor cores (wgmma),
256 vocab rows a tile against a staged chunk of the state, and keeps a (best
score, first index) pair per batch column in registers, so the [V, B] logits
never reach device memory.  Persistent blocks walk contiguous runs of vocab
tiles (launch plan: `plan`); a second small kernel merges their pairs by
(score descending, index ascending), which is deterministic and is argmax's
first-occurrence rule, and writes each column's winning score beside its id
where asked: a vocab-sharded head's ranks merge those pairs by the same rule
(parallel/collectives.py), as the TPU kernel's second output (best score
[1, B]) allows.

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
any V is taken (rows past V in the last tile are masked, the embed is not
padded).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from dmi_tpu_torch.models.quant import int_matmul, quantize_act
from dmi_tpu_torch.ops.cuda import _build

# calls that launched the CUDA kernels since the count was last set to 0
launches = 0

MODES = {"bf16": 0, "q": 1, "q8": 2}
TILE_V = 256  # kTileV of csrc/head_argmax.cu: vocab rows of a tile
TILE_B = 128  # kTileB: batch columns of a block
SMS = 132     # streaming multiprocessors of the H100


@functools.lru_cache(maxsize=None)
def plan(V: int, H: int, B: int, mode: str) -> dict:
    """Launch plan at a padded batch B.  Every batch tile of TILE_B columns
    gets `blocks` persistent blocks, as many as fill the SMs once and no more
    than there are vocab tiles; block i walks vocab tiles runs[i] = [first,
    end), contiguous and balanced (the kernel computes the same bounds from
    its index).  `part` is the scratch of the blocks' (best, index) pairs."""
    if mode not in MODES:
        raise ValueError(f"head argmax: unknown mode {mode!r}")
    tiles = -(-V // TILE_V)
    batch_tiles = -(-B // TILE_B)
    blocks = max(1, min(tiles, SMS // batch_tiles))
    runs = tuple((i * tiles // blocks, (i + 1) * tiles // blocks) for i in range(blocks))
    return {"tile_v": TILE_V, "tile_b": TILE_B, "vocab_tiles": tiles,
            "batch_tiles": batch_tiles, "blocks": blocks, "grid": (blocks, batch_tiles),
            "runs": runs, "part": blocks * B}


def map_encodes() -> dict:
    """Tensor maps the kernel has encoded since the library was loaded, the
    embeds' and the states' (cached apart)."""
    lib = _build.lib()
    return {"weights": lib.dmi_head_argmax_map_encodes(0),
            "activations": lib.dmi_head_argmax_map_encodes(1)}


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


def _head_argmax_plain(embed, h, scores: bool = False):
    """The kernel's math in plain torch: the logits path followed by the
    argmax over the vocab axis (first occurrence on ties) -> [B] int64, and
    with scores=True also each column's winning logit as f32 [B] (the
    bf16-rounded score the kernel compares)."""
    if not scores:
        return head_logits_bl(embed, h).argmax(dim=0)
    best, ids = head_logits_bl(embed, h).max(dim=0)
    return ids, best.float()


def _mode(embed) -> str:
    if not isinstance(embed, dict):
        return "bf16"
    if "q8" in embed:
        return "q8"
    if "q" in embed:
        return "q"
    raise ValueError(f"head argmax: unknown quantized embed keys {sorted(embed)}")


def head_argmax(params: dict, h: torch.Tensor, scores: bool = False):
    """Greedy next-token ids straight from the final hidden state.

    params: {"embed": the head's rows [V, H]}: the decode weight tree's tied
    embedding (bf16, "q" or "q8"), or decode.fused_head_weights' rows.
    h [H, B] bf16, the batch-last output of the final norm -> [B] int64.
    The kernel bakes in bf16 score rounding; an f32 model takes the logits
    path instead (decode.greedy_generate_bl).  scores=True returns (ids,
    scores [B] f32): the merge kernel also writes each column's winning
    bf16-rounded score, which a vocab-sharded head's ranks compare
    (parallel.collectives.Shard.argmax)."""
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
        return _head_argmax_plain(embed, h, scores)
    if h.device.type != "cuda":
        raise ValueError(f"head argmax: no kernel for device {h.device}")
    if not e.is_contiguous():
        raise ValueError("head argmax kernel: the embed must be contiguous")
    if H % 16:
        raise ValueError(f"head argmax kernel: H {H} must be a multiple of 16 (TMA rows of "
                         "16-byte multiples)")
    if B == 0:
        empty = torch.empty((0,), dtype=torch.long, device=h.device)
        return (empty, empty.float()) if scores else empty
    dev = h.device
    # the kernels take the batch in multiples of 16 columns (their ids are
    # dropped): 16-byte rows of h for TMA
    Bp = B + (-B % 16)
    scales = act_scales = None
    if mode == "q8":
        # wgmma's int8 form takes K-major operands only: the quantized state
        # goes over transposed, [Bp, H], one copy made where it is quantized
        x, a = quantize_act(h, axis=0)
        xp = F.pad(x, (0, Bp - B)).t().contiguous()
        act_scales = F.pad(a.reshape(-1), (0, Bp - B)).contiguous()
    else:
        xp = h.contiguous() if Bp == B else F.pad(h, (0, Bp - B))
    if mode != "bf16":
        scales = embed["s"].reshape(-1)
        if scales.dtype != torch.float32 or not scales.is_contiguous():
            raise TypeError("head argmax kernel: row scales are contiguous f32")
    p = plan(V, H, Bp, mode)
    part_val = torch.empty(p["part"], dtype=torch.float32, device=dev)
    part_idx = torch.empty(p["part"], dtype=torch.int32, device=dev)
    ids = torch.empty((Bp,), dtype=torch.int32, device=dev)
    best = torch.empty((Bp,), dtype=torch.float32, device=dev) if scores else None
    err = _build.lib().dmi_head_argmax(
        e.data_ptr(), scales.data_ptr() if scales is not None else None, xp.data_ptr(),
        act_scales.data_ptr() if act_scales is not None else None,
        part_val.data_ptr(), part_idx.data_ptr(), ids.data_ptr(),
        best.data_ptr() if scores else None, V, H, Bp, MODES[mode],
        p["blocks"], torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "head argmax")
    launches += 1
    return (ids[:B].long(), best[:B]) if scores else ids[:B].long()
