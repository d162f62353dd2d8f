"""Weight-stream matmul of the decode-MLP stream probe.

Counterpart of the TPU kernel pallas_mm of scripts/profile_mlp_stream.py:
67-78, which is csrc/stream_mm.cu here: out = wᵀ h for w [I, O] and h [I, B]
bf16, out [O, B] bf16, the f32 sum rounded once.  The probe
(dmi_tpu_torch.probes.profile_mlp_stream) times it at the decode MLP's
gate-up shape against the library's wᵀ @ h, at each output-tile width the
kernel is compiled for (the script's bo sweep).

`stream_mm_bl` runs `_stream_mm_plain` for tensors on the CPU and launches
the kernel for tensors on a CUDA device; there is no fallback between the
two.  `plan` is the launch plan: the TMA and wgmma kernel's tile, ring and
grid, or the wmma instance for shapes TMA cannot take.
"""

from __future__ import annotations

import functools

import torch

from dmi_tpu_torch.ops.cuda import _build

# calls that launched the kernel since the count was last set to 0
launches = 0

BLOCK_OUT = (64, 128, 256)  # output rows per block: the kernel's template instances
SMEM_LIMIT = 232448         # shared memory a block may use
BOX_BYTES = 64 * 64 * 2     # a TMA box: 64 rows of I by 64 columns, bf16
MAX_STAGES = 8
WMMA_TILE = (128, 128)      # the wmma instance's block tile (mm_tile.cuh at kBM 128)
# block_out -> (64-row weight tiles a block, batch columns a consumer
# warpgroup); two consumer warpgroups split the block's batch columns
TILES = {64: (1, 128), 128: (2, 128), 256: (4, 64)}


def _stream_mm_plain(w, h):
    """The kernel's function in plain torch: the f32 product, rounded once."""
    return (w.float().t() @ h.float()).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def plan(I: int, O: int, B: int, block_out: int = 128, aligned: bool = True) -> dict:
    """Launch plan of wᵀ h for w [I, O], h [I, B].  `aligned`: w, h and the
    output start on 16-byte boundaries.

    route "tma" (O and B multiples of 8): a block owns block_out rows of O
    (`weight_tiles` boxes of 64 columns of w) by `bn` batch columns (two
    consumer warpgroups of `wgmma_n`); I streams through `stages` stages of
    64 rows, as many as 227 KB hold, up to MAX_STAGES (the rule of
    stream_ring.cuh's Ring); `grid` is (the row tiles, the batch tiles).
    route "wmma": mm_tile.cuh's instance on a (B / 128, O / 128) grid."""
    if block_out not in BLOCK_OUT:
        raise ValueError(f"stream_mm: block_out must be one of {BLOCK_OUT}, got {block_out}")
    mt, n = TILES[block_out]
    bn = 2 * n
    h_boxes = bn // 64
    if not (aligned and O % 8 == 0 and B % 8 == 0):
        bm, bn = WMMA_TILE
        return {"route": "wmma", "bm": bm, "bn": bn, "grid": (-(-B // bn), -(-O // bm))}
    stage = BOX_BYTES * (mt + h_boxes)
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - 16 * MAX_STAGES) // stage)
    o_tiles = -(-O // block_out)
    return {"route": "tma", "bm": block_out, "bn": bn, "weight_tiles": mt, "wgmma_n": n,
            "h_boxes": h_boxes, "stage_bytes": stage, "stages": stages,
            "smem": 1024 + stages * stage + 16 * stages, "o_tiles": o_tiles,
            "batch_tiles": -(-B // bn), "grid": (o_tiles, -(-B // bn)), "chunks": -(-I // 64)}


def stream_mm_bl(w, h, block_out: int = 128):
    """w [I, O] bf16, h [I, B] bf16 -> wᵀ h [O, B] bf16.  block_out (64,
    128, 256) is the kernel's output rows per block; the twin ignores it."""
    if w.dim() != 2 or h.dim() != 2 or w.shape[0] != h.shape[0]:
        raise ValueError(f"stream_mm shapes: w {tuple(w.shape)}, h {tuple(h.shape)}")
    if w.dtype != torch.bfloat16 or h.dtype != torch.bfloat16:
        raise TypeError(f"stream_mm takes bf16 operands, got {w.dtype}, {h.dtype}")
    if w.device != h.device:
        raise ValueError("stream_mm: both operands must be on one device")
    if w.device.type == "cpu":
        return _stream_mm_plain(w, h)
    if w.device.type != "cuda":
        raise ValueError(f"stream_mm: no kernel for device {w.device}")
    if block_out not in BLOCK_OUT:
        raise ValueError(f"stream_mm: block_out must be one of {BLOCK_OUT}, got {block_out}")
    if not (w.is_contiguous() and h.is_contiguous()):
        raise ValueError("stream_mm kernel: operands must be contiguous")
    global launches
    I, O = w.shape
    B = h.shape[1]
    out = torch.empty((O, B), dtype=torch.bfloat16, device=w.device)
    if out.numel() == 0 or I == 0:
        return out.zero_()
    p = plan(I, O, B, block_out, aligned=w.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0)
    tma = p["route"] == "tma"
    gx, gy = p["grid"] if tma else (0, 0)
    err = _build.lib().dmi_stream_mm(w.data_ptr(), h.data_ptr(), out.data_ptr(), O, B, I,
                                     block_out, int(tma), gx, gy, p.get("stages", 0),
                                     torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "stream_mm")
    launches += 1
    return out
