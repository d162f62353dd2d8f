"""Fused projector MLP2: gelu_tanh(x @ w0 + b0) @ w1 + b1.

Counterpart of dmi_tpu/ops/pallas/projector.py:fused_mlp2, whose two TPU
kernels (_mlp2_pallas, single block; _mlp2_pallas_tiled, column-tiled) are
one hand-written CUDA kernel here, csrc/mlp2.cu.  The serving path runs it
in f32 at B = 64-256 rows, mm = 1024, lm = lm2 = 2048: about 1.6 GFLOP at
B = 128 against 24 MiB of weights, compute bound on the CUDA cores.  The
kernel runs as two register-tiled passes over many blocks (the TPU kept
both weights in VMEM, which does not fit an SM): the first writes the
hidden activation into an f32 scratch buffer that stays in L2, the second
multiplies it by w1; `mlp2_plan` picks each pass's tile and grid.  See the
source for the design.

`fused_mlp2` is a torch.autograd.Function.  Its forward runs `_mlp2_plain`
for tensors on the CPU and launches the kernel for tensors on a CUDA
device; there is no fallback between the two.  Its backward is the gradient
of `_mlp2_plain`, recomputed from the saved inputs: the counterpart of the
custom_vjp of dmi_tpu/ops/pallas/projector.py (`_mlp2_bwd`, :226-229),
whose backward is not a kernel either.  The trainer's eval loss and
generate run it with parameters that require grad, under torch.no_grad().
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda import _build

# calls of the kernel (one per fused_mlp2 on a CUDA device, whose two
# passes are two device launches) since the count was last set to 0
launches = 0

# the tiling of csrc/mlp2.cu
K_SPLIT = 4                   # kSplit: groups of 128 threads, each a part of every K chunk
BLOCK_COLS = 64               # kBN: output columns per block
CHUNK_K = 128                 # kBK: K per staged chunk
STAGES = 3                    # kStages: the cp.async ring
ROWS_PER_THREAD = (8, 4, 2)   # kTM instances; a block owns 8 * kTM rows
MIN_BLOCKS = 128              # blocks a pass should put on the 132 SMs
SMEM_BYTES = 227 * 1024       # dynamic shared memory one H100 block may use


def _mlp2_plain(x, w0, b0, w1, b1):
    """The kernel's math in plain torch: f32 accumulation, the hidden
    rounded to w1's dtype before the second product, output in x's dtype.
    At f32 it is dmi_tpu's _mlp2_xla."""
    h = F.gelu(x.float() @ w0.float() + b0.float(), approximate="tanh")
    y = h.to(w1.dtype).float() @ w1.float() + b1.float()
    return y.to(x.dtype)


def _pass_plan(B: int, K: int, N: int, a_size: int, w_size: int) -> dict:
    """One pass, [B, K] @ [K, N]: the most rows per thread that still put
    MIN_BLOCKS blocks in flight (the fewest, 2, when none does), the grid
    (column tiles, row tiles) and the shared memory it takes (the ring of
    A and w chunks, or the sums the other groups hand to the first,
    whichever is larger)."""
    cols = -(-N // BLOCK_COLS)
    for tm in ROWS_PER_THREAD:
        if -(-B // (8 * tm)) * cols >= MIN_BLOCKS:
            break
    rows = 8 * tm
    stage = rows * (CHUNK_K + 16 // a_size) * a_size + CHUNK_K * BLOCK_COLS * w_size
    smem = max(STAGES * stage, (K_SPLIT - 1) * 128 * tm * 4 * 4)
    return {"rows_per_thread": tm, "block_rows": rows, "block_cols": BLOCK_COLS,
            "k_split": K_SPLIT, "grid": (cols, -(-B // rows)), "smem": smem}


def mlp2_plan(B: int, mm: int, lm: int, lm2: int, itemsize: int) -> tuple:
    """The launch plans of the kernel's two passes for x [B, mm] @ w0
    [mm, lm] (elements of `itemsize` bytes), then the f32 hidden [B, lm] @
    w1 [lm, lm2].  At f32, lm = lm2 = 2048: B 64 takes 16-row tiles, B 128
    32-row tiles, B 256 64-row tiles, each 128 blocks."""
    return (_pass_plan(B, mm, lm, itemsize, itemsize),
            _pass_plan(B, lm, lm2, 4, itemsize))


def _mlp2_kernel(x, w0, b0, w1, b1):
    """Launch csrc/mlp2.cu's two passes on contiguous CUDA tensors of one
    dtype; `launches` counts the call once."""
    global launches
    tensors = (x, w0, b0, w1, b1)
    B, mm = x.shape
    lm, lm2 = w1.shape
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("mlp2 kernel: all tensors must share one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlp2 kernel: tensors must be contiguous")
    code = _build.dtype_code(x.dtype)
    out = torch.empty((B, lm2), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    hidden = torch.empty((B, lm), dtype=torch.float32, device=x.device)
    plan1, plan2 = mlp2_plan(B, mm, lm, lm2, x.element_size())
    err = _build.lib().dmi_mlp2(
        *(t.data_ptr() for t in tensors), out.data_ptr(), hidden.data_ptr(), B, mm, lm, lm2,
        plan1["rows_per_thread"], plan2["rows_per_thread"],
        code, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "mlp2")
    launches += 1
    return out


class _MLP2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        ctx.save_for_backward(x, w0, b0, w1, b1)
        if x.device.type == "cpu":
            return _mlp2_plain(x, w0, b0, w1, b1)
        return _mlp2_kernel(x, w0, b0, w1, b1)

    @staticmethod
    def backward(ctx, gy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = _mlp2_plain(*inputs)
        grads = iter(torch.autograd.grad(y, wanted, gy))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_mlp2(x, w0, b0, w1, b1):
    """x [B, mm], w0 [mm, lm], b0 [lm], w1 [lm, lm2], b1 [lm2] -> [B, lm2],
    differentiable in all five."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlp2: no kernel for device {x.device}")
    return _MLP2.apply(*tensors)
