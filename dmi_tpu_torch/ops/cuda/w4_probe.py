"""Packed-W4 matmuls of the W4 stream probe: int4 weights two to a byte
against int8 activations, int32 out.

Counterpart of the two TPU kernels of scripts/profile_w4_matmul.py, which
are csrc/w4_probe.cu here:

- split-OUT (`dot_w4_pallas`, :156-170): p_so [K, OUT/2] uint8, byte (k, j)
  holds W[k, j] in its low nibble and W[k, j + OUT/2] in its high one;
- split-K (`dot_w4_pallas_k`, :184-197): p_sk [K/2, OUT] uint8, byte (k, n)
  holds W[k, n] low and W[k + K/2, n] high (quant.pack_w4's layout).

Both give Wᵀ h [OUT, B] int32 for h [K, B] int8, exactly.  The probe
(dmi_tpu_torch.probes.profile_w4_matmul) times them against the int8
stream.  Each wrapper runs its twin for tensors on the CPU and launches the
kernel for tensors on a CUDA device; there is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from dmi_tpu_torch.ops.cuda import _build

# launches of the split-OUT and of the split-K kernel since each count was
# last set to 0
split_out_launches = 0
split_k_launches = 0


def pack_split_out(w8: np.ndarray) -> np.ndarray:
    """int8 weights [K, OUT] in [-8, 7] -> p_so [K, OUT/2] uint8
    (scripts/profile_w4_matmul.py:93-96)."""
    half = w8.shape[1] // 2
    return ((w8[:, :half] & 0xF) | ((w8[:, half:] & 0xF) << 4)).astype(np.uint8)


def pack_split_k(w8: np.ndarray) -> np.ndarray:
    """int8 weights [K, OUT] in [-8, 7] -> p_sk [K/2, OUT] uint8
    (scripts/profile_w4_matmul.py:110-113)."""
    kh = w8.shape[0] // 2
    return ((w8[:kh] & 0xF) | ((w8[kh:] & 0xF) << 4)).astype(np.uint8)


def nibbles(p):
    """The sign-extended low and high nibbles of packed uint8 bytes, as
    int8 tensors of p's shape."""
    p8 = p.view(torch.int8)
    return (p8 << 4) >> 4, p8 >> 4


def _w4_split_out_plain(p_so, h):
    """Exact integer product in f64 (|sum| <= 8 · 128 · K < 2⁵³), as int32:
    the low nibbles give rows [0, OUT/2), the high ones the rest."""
    lo, hi = nibbles(p_so)
    hd = h.double()
    return torch.cat([lo.double().t() @ hd, hi.double().t() @ hd]).to(torch.int32)


def _w4_split_k_plain(p_sk, h):
    """Exact integer product in f64, as int32: the low nibbles against the
    first half of h's rows, the high ones against the second."""
    lo, hi = nibbles(p_sk)
    kh = p_sk.shape[0]
    hd = h.double()
    return (lo.double().t() @ hd[:kh] + hi.double().t() @ hd[kh:]).to(torch.int32)


def _launch(p, h, out_dim: int, split_k: bool):
    global split_out_launches, split_k_launches
    if p.device != h.device:
        raise ValueError("w4 probe: both operands must be on one device")
    if h.device.type != "cuda":
        raise ValueError(f"w4 probe: no kernel for device {h.device}")
    if not (p.is_contiguous() and h.is_contiguous()):
        raise ValueError("w4 probe kernel: operands must be contiguous")
    K, B = h.shape
    out = torch.empty((out_dim, B), dtype=torch.int32, device=h.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    err = _build.lib().dmi_w4_probe(p.data_ptr(), h.data_ptr(), out.data_ptr(), out_dim, B, K,
                                    int(split_k), torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "w4 probe")
    if split_k:
        split_k_launches += 1
    else:
        split_out_launches += 1
    return out


def _check(p, h, rows: int):
    if p.dtype != torch.uint8 or h.dtype != torch.int8:
        raise TypeError(f"w4 probe takes uint8 packed weights and int8 h, got {p.dtype}, "
                        f"{h.dtype}")
    if p.dim() != 2 or h.dim() != 2 or rows != h.shape[0]:
        raise ValueError(f"w4 probe shapes: packed {tuple(p.shape)}, h {tuple(h.shape)}")


def w4_dot_split_out(p_so, h):
    """p_so [K, OUT/2] uint8, h [K, B] int8 -> Wᵀ h [OUT, B] int32."""
    _check(p_so, h, p_so.shape[0])
    if p_so.device.type == "cpu" and h.device.type == "cpu":
        return _w4_split_out_plain(p_so, h)
    return _launch(p_so, h, 2 * p_so.shape[1], split_k=False)


def w4_dot_split_k(p_sk, h):
    """p_sk [K/2, OUT] uint8, h [K, B] int8 -> Wᵀ h [OUT, B] int32."""
    _check(p_sk, h, 2 * p_sk.shape[0])
    if p_sk.device.type == "cpu" and h.device.type == "cpu":
        return _w4_split_k_plain(p_sk, h)
    return _launch(p_sk, h, p_sk.shape[1], split_k=True)
