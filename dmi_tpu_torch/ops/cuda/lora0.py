"""Fused LoRA projector layer 0: gelu_tanh(x @ w0 + b0 + (x @ a) @ b + d).

Counterpart of dmi_tpu/ops/pallas/projector.py:fused_lora_layer0, whose TPU
kernel (_lora0_pallas) is the hand-written CUDA kernel csrc/lora0.cu here.
It is the stage-2 hypernet step's soft-token forward: the frozen projector's
first layer with the hypernet's adapter (a [mm, r], b [r, lm], d [lm]) on
every micro-step, eval loss and generate.  At stage 2's micro-batch (B 4,
f32, mm 768, lm 2048, r 32) it reads 6.3 MB of W0 for ~13 MFLOP, so the
device memory bounds it; the kernel spreads W0's stream over 128 blocks
(16 columns each) in clusters of 8 that share x @ a (see the source).

The coalesced stage-2 path stacks G micro-batches, each with its own
adapter: x [G, B, mm], a [G, mm, r], b [G, r, lm], d [G, lm] with w0 and b0
shared, the counterpart of the TPU path's jax.vmap over adapter groups, as
one launch with the groups on the grid.

`fused_lora_layer0` is a torch.autograd.Function.  Its forward runs
`_lora0_plain` for tensors on the CPU and launches the kernel for tensors on
a CUDA device; there is no fallback between the two.  Its backward is the
gradient of `_lora0_plain`, recomputed from the saved inputs: the
counterpart of dmi_tpu's `_lora0_bwd` (the vjp of `_lora0_xla`), which is
not a kernel either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda import _build

# launches of the CUDA kernel since the count was last set to 0
launches = 0

MAX_ROWS = 16                 # kMaxRows of csrc/lora0.cu
THREADS = 256                 # kThreads of csrc/lora0.cu: the largest rank it takes
SMEM_BYTES = 227 * 1024       # dynamic shared memory one H100 block may use


def _lora0_plain(x, w0, b0, a, b, d):
    """The kernel's math in plain torch, grouped or not: f32 accumulation,
    x @ a rounded to b's dtype before its product with b, output in x's
    dtype.  At f32 it is dmi_tpu's _lora0_xla."""
    xf = x.float()
    inter = (xf @ a.float()).to(b.dtype).float()
    y = xf @ w0.float() + inter @ b.float() + b0.float() + d.float().unsqueeze(-2)
    return F.gelu(y, approximate="tanh").to(x.dtype)


def rows_per_block(B: int, mm: int, r: int) -> int:
    """Rows of x one block owns: at most MAX_ROWS and B, and as many as fit
    the x tile, the two inter tiles (the block's share and the sum) and the
    partial sums in shared memory."""
    fit = SMEM_BYTES // ((mm + 2 * r + THREADS) * 4)
    if fit < 1:
        raise ValueError(f"lora0 kernel: mm = {mm} exceeds shared memory")
    return max(1, min(MAX_ROWS, B, fit))


def _lora0_kernel(x, w0, b0, a, b, d):
    """Launch csrc/lora0.cu on contiguous grouped CUDA tensors of one dtype."""
    global launches
    tensors = (x, w0, b0, a, b, d)
    G, B, mm = x.shape
    lm = w0.shape[1]
    r = a.shape[2]
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("lora0 kernel: all tensors must share one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lora0 kernel: tensors must be contiguous")
    if r > THREADS:
        raise ValueError(f"lora0 kernel: rank {r} above {THREADS}")
    code = _build.dtype_code(x.dtype)
    tb = rows_per_block(B, mm, r)
    out = torch.empty((G, B, lm), dtype=x.dtype, device=x.device)
    if B == 0 or G == 0:
        return out
    err = _build.lib().dmi_lora0(
        *(t.data_ptr() for t in tensors), out.data_ptr(), G, B, mm, lm, r, tb,
        code, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "lora0")
    launches += 1
    return out


class _Lora0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, b0, a, b, d):
        ctx.save_for_backward(x, w0, b0, a, b, d)
        if x.device.type == "cpu":
            return _lora0_plain(x, w0, b0, a, b, d)
        return _lora0_kernel(x, w0, b0, a, b, d)

    @staticmethod
    def backward(ctx, gy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = _lora0_plain(*inputs)
        grads = iter(torch.autograd.grad(y, wanted, gy))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_lora_layer0(x, w0, b0, a, b, d):
    """x [B, mm], w0 [mm, lm], b0 [lm], a [mm, r], b [r, lm], d [lm] -> [B, lm];
    or grouped: x [G, B, mm], a [G, mm, r], b [G, r, lm], d [G, lm] with w0
    and b0 shared -> [G, B, lm].  Differentiable in all six."""
    tensors = (x, w0, b0, a, b, d)
    if x.ndim == 2:
        return fused_lora_layer0(x[None], w0, b0, a[None], b[None], d[None])[0]
    G, B, mm = x.shape
    lm = w0.shape[1]
    r = a.shape[-1]
    if (w0.shape != (mm, lm) or b0.shape != (lm,) or a.shape != (G, mm, r)
            or b.shape != (G, r, lm) or d.shape != (G, lm)):
        raise ValueError(
            f"lora0 shapes: x {tuple(x.shape)}, w0 {tuple(w0.shape)}, b0 {tuple(b0.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, d {tuple(d.shape)}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("lora0: all tensors must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lora0: no kernel for device {x.device}")
    return _Lora0.apply(*tensors)
