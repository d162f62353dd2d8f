"""Blocked int8/bf16 matmul of the int8 tensor-core probe.

Counterpart of the TPU kernel pallas_mm of scripts/profile_int8_mxu.py:74-85,
which is csrc/block_mm.cu here: out = a @ b for a [M, K] and b [K, N], both
int8 (int32 out) or both bf16 (f32 out), on the tensor cores.  The probe
(dmi_tpu_torch.probes.profile_int8_mxu) times both types to read the
card's int8:bf16 rate.

`block_mm` runs `_block_mm_plain` for tensors on the CPU and launches the
kernel for tensors on a CUDA device; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from dmi_tpu_torch.ops.cuda import _build

# calls that launched the kernel since the count was last set to 0
launches = 0

BLOCK_M = (64, 128, 256)  # output rows per block: the kernel's template instances


def _block_mm_plain(a, b):
    """The kernel's function in plain torch.  int8: the product in f64 (exact:
    |sum| <= 127² K < 2⁵³), cast to int32; f32 would drop low bits once a sum
    passes 2²⁴ (K 4096 reaches 6.6e7).  bf16: the f32 product (TF32 stays
    off, torch's default for matmuls)."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def block_mm(a, b, block_m: int = 128):
    """a [M, K] @ b [K, N]: int8 -> int32 or bf16 -> f32.  block_m (64, 128,
    256) is the kernel's rows per block; the twin ignores it."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block_mm shapes: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"block_mm takes two int8 or two bf16 operands, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("block_mm: both operands must be on one device")
    if a.device.type == "cpu":
        return _block_mm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"block_mm: no kernel for device {a.device}")
    if block_m not in BLOCK_M:
        raise ValueError(f"block_mm: block_m must be one of {BLOCK_M}, got {block_m}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_mm kernel: operands must be contiguous")
    global launches
    M, K = a.shape
    N = b.shape[1]
    int8 = a.dtype == torch.int8
    out = torch.empty((M, N), dtype=torch.int32 if int8 else torch.float32, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    err = _build.lib().dmi_block_mm(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                                    block_m, int(int8),
                                    torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "block_mm")
    launches += 1
    return out
