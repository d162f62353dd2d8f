"""Weight-stream matmul of the decode-MLP stream probe.

Counterpart of the TPU kernel pallas_mm of scripts/profile_mlp_stream.py:
67-78, which is csrc/stream_mm.cu here: out = wᵀ h for w [I, O] and h [I, B]
bf16, out [O, B] bf16, the f32 sum rounded once.  The probe
(dmi_tpu_torch.probes.profile_mlp_stream) times it at the decode MLP's
gate-up shape against the library's wᵀ @ h, at each output-tile width the
kernel is compiled for (the script's bo sweep).

`stream_mm_bl` runs `_stream_mm_plain` for tensors on the CPU and launches
the kernel for tensors on a CUDA device; there is no fallback between the
two.
"""

from __future__ import annotations

import torch

from dmi_tpu_torch.ops.cuda import _build

# calls that launched the kernel since the count was last set to 0
launches = 0

BLOCK_OUT = (64, 128, 256)  # output rows per block: the kernel's template instances


def _stream_mm_plain(w, h):
    """The kernel's function in plain torch: the f32 product, rounded once."""
    return (w.float().t() @ h.float()).to(torch.bfloat16)


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
    err = _build.lib().dmi_stream_mm(w.data_ptr(), h.data_ptr(), out.data_ptr(), O, B, I,
                                     block_out, torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "stream_mm")
    launches += 1
    return out
