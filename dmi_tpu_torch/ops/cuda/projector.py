"""Fused projector MLP2: gelu_tanh(x @ w0 + b0) @ w1 + b1.

Counterpart of dmi_tpu/ops/pallas/projector.py:fused_mlp2, whose two TPU
kernels (_mlp2_pallas, single block; _mlp2_pallas_tiled, column-tiled) are
one hand-written CUDA kernel here, csrc/mlp2.cu.  The serving path runs it
in f32 at B = 64-256 rows, mm = 1024, lm = lm2 = 2048: about 1.6 GFLOP at
B = 128 against 24 MiB of weights, compute bound on the CUDA cores.  The
kernel keeps each row tile's hidden activation in shared memory (the TPU
kept both weights in VMEM, which does not fit an SM) and streams w1 against
it; see the source for the design.

`fused_mlp2` runs `_mlp2_plain` for tensors on the CPU and launches the
kernel for tensors on a CUDA device; there is no fallback between the two.
Forward only: the autograd.Function with the backward comes with the
training path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda import _build

# launches of the CUDA kernel since the count was last set to 0
launches = 0

MAX_ROWS = 16                 # kMaxRows of csrc/mlp2.cu
SMEM_BYTES = 227 * 1024       # dynamic shared memory one H100 block may use


def _mlp2_plain(x, w0, b0, w1, b1):
    """The kernel's math in plain torch: f32 accumulation, the hidden
    rounded to w1's dtype before the second product, output in x's dtype.
    At f32 it is dmi_tpu's _mlp2_xla."""
    h = F.gelu(x.float() @ w0.float() + b0.float(), approximate="tanh")
    y = h.to(w1.dtype).float() @ w1.float() + b1.float()
    return y.to(x.dtype)


def rows_per_block(mm: int, lm: int) -> int:
    """Rows of x one block owns: as many as fit the x tile and the f32
    hidden [rows, mm + lm] in shared memory, at most MAX_ROWS (16 at the
    1B projector, mm = 1024, lm = 2048; 11 at an 8B-wide lm = 4096)."""
    tb = min(MAX_ROWS, SMEM_BYTES // ((mm + lm) * 4))
    if tb < 1:
        raise ValueError(f"mlp2 kernel: mm + lm = {mm + lm} exceeds shared memory")
    return tb


def fused_mlp2(x, w0, b0, w1, b1):
    """x [B, mm], w0 [mm, lm], b0 [lm], w1 [lm, lm2], b1 [lm2] -> [B, lm2]."""
    global launches
    tensors = (x, w0, b0, w1, b1)
    B, mm = x.shape
    lm, lm2 = w1.shape
    if (w0.shape != (mm, lm) or b0.shape != (lm,) or b1.shape != (lm2,)):
        raise ValueError(
            f"mlp2 shapes: x {tuple(x.shape)}, w0 {tuple(w0.shape)}, b0 "
            f"{tuple(b0.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("mlp2: all tensors must be on one device")
    if x.device.type == "cpu":
        return _mlp2_plain(*tensors)
    if x.device.type != "cuda":
        raise ValueError(f"mlp2: no kernel for device {x.device}")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("mlp2 kernel: all tensors must share one dtype")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "mlp2 kernel is forward-only; its backward comes with the "
            "training path (ROADMAP.md A.2)"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlp2 kernel: tensors must be contiguous")
    code = _build.dtype_code(x.dtype)
    tb = rows_per_block(mm, lm)
    out = torch.empty((B, lm2), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    err = _build.lib().dmi_mlp2(
        *(t.data_ptr() for t in tensors), out.data_ptr(), B, mm, lm, lm2, tb,
        code, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "mlp2")
    launches += 1
    return out
