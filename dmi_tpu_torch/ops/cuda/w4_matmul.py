"""Integer matmuls of the batch-last decode loop: W4A8 over nibble-packed
weights, and W8A8.

Counterpart of dmi_tpu/ops/pallas/w4_matmul.py:w4_mm_bl, whose TPU kernel is
csrc/w4_matmul.cu here.  The decode loop reads every layer weight once per
token step; int4 halves that stream against int8 only if the nibbles are
unpacked after the read from device memory.  The kernel streams the packed
bytes, sign-extends the nibbles in registers, contracts each half against
its contiguous slice of the int8 activations with `__dp4a` into int32, and
rescales to the output dtype, so neither the unpacked weights nor the int32
accumulator reach device memory.

Layout (quant.pack_w4): byte (k, n) of qp [K/2, out] holds contraction rows
k (low nibble) and k + K/2 (high nibble).  Scales are per output channel
(s [1, out] f32); activations are per-token int8 with scales a [1, B] f32.
Grouped ("s4g") weights take decode._mm_bl's partial-product form instead,
as in dmi_tpu.

The same source has the kernel without the unpack (`w8_mm_bl`, int8 weights
[K, out]): dmi_tpu leaves the W8A8 product of its decode loop to XLA
(dmi_tpu/models/decode.py:461-469), and torch has no int32 matmul on CUDA.

The accumulation is integer and the rescale order is fixed,
(acc.f32 * s) * a rounded once to the output dtype, so kernel and twin agree
bit for bit.  Each wrapper runs its twin for tensors on the CPU and launches
the kernel for tensors on a CUDA device, at any B; there is no fallback
between the two.
"""

from __future__ import annotations

import torch

from dmi_tpu_torch.models.quant import int_matmul
from dmi_tpu_torch.ops.cuda import _build

# launches of the packed (W4A8) kernel and of the int8 (W8A8) kernel since
# each count was last set to 0
launches = 0
w8_launches = 0


def _rescale(acc, s, a, out_dtype):
    return (acc * s.reshape(-1, 1).float() * a.float()).to(out_dtype)


def _w4_mm_plain(w: dict, hq, a, out_dtype):
    """The packed kernel's math in plain torch: two half products on the
    contiguous activation slices (dmi_tpu/models/decode.py:497-507), exact
    integer accumulation, (acc * s) * a rounded to out_dtype.

    w {"qp" [K/2, out] uint8, "s" [1, out] f32}, hq [K, B] int8, a [1, B]
    f32 -> [out, B]."""
    p8 = w["qp"].view(torch.int8)
    lo = (p8 << 4) >> 4
    hi = p8 >> 4
    kh = p8.shape[0]
    acc = int_matmul(lo.t(), hq[:kh]) + int_matmul(hi.t(), hq[kh:])
    return _rescale(acc, w["s"], a, out_dtype)


def _w8_mm_plain(w: dict, hq, a, out_dtype):
    """The int8 kernel's math in plain torch (dmi_tpu/models/decode.py:461-469).

    w {"q8" [K, out] int8, "s" [1, out] f32}, hq [K, B] int8, a [1, B] f32
    -> [out, B]."""
    return _rescale(int_matmul(w["q8"].t(), hq), w["s"], a, out_dtype)


def _launch(wq, s, hq, a, out_dtype, packed: bool):
    """Check the tensors, launch csrc/w4_matmul.cu and count the launch."""
    global launches, w8_launches
    K, B = hq.shape
    out_dim = wq.shape[1]
    tensors = (wq, s, hq, a)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("int8 matmul: all tensors must be on one device")
    if hq.device.type != "cuda":
        raise ValueError(f"int8 matmul: no kernel for device {hq.device}")
    if (wq.dtype != (torch.uint8 if packed else torch.int8) or hq.dtype != torch.int8
            or s.dtype != torch.float32 or a.dtype != torch.float32):
        raise TypeError("int8 matmul kernel: weights uint8 (packed) or int8, activations "
                        "int8, scales f32")
    if wq.shape[0] * (2 if packed else 1) != K or s.numel() != out_dim or a.numel() != B:
        raise ValueError(
            f"int8 matmul shapes: weights {tuple(wq.shape)}, scales {tuple(s.shape)}, "
            f"hq {tuple(hq.shape)}, a {tuple(a.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8 matmul kernel: tensors must be contiguous")
    out = torch.empty((out_dim, B), dtype=out_dtype, device=hq.device)
    if out.numel() == 0:
        return out
    err = _build.lib().dmi_w4_mm(
        wq.data_ptr(), hq.data_ptr(), a.data_ptr(), s.data_ptr(), out.data_ptr(),
        K, out_dim, B, int(packed), _build.dtype_code(out_dtype),
        torch.cuda.current_stream(hq.device).cuda_stream,
    )
    _build.check(err, "int8 matmul")
    if packed:
        launches += 1
    else:
        w8_launches += 1
    return out


def w4_mm_bl(w: dict, hq, a, out_dtype):
    """Packed W4 batch-last matmul: w {"qp" [K/2, out] uint8, "s" [1, out]
    f32}, hq [K, B] int8 (quantized per token), a [1, B] f32 -> [out, B]
    out_dtype (f32 or bf16)."""
    if "s" not in w or "s4g" in w:
        raise ValueError("w4_mm_bl takes per-channel scales (grouped weights: decode._mm_bl)")
    if hq.device.type == "cpu" and w["qp"].device.type == "cpu":
        return _w4_mm_plain(w, hq, a, out_dtype)
    return _launch(w["qp"], w["s"], hq, a, out_dtype, packed=True)


def w8_mm_bl(w: dict, hq, a, out_dtype):
    """W8A8 batch-last matmul: w {"q8" [K, out] int8, "s" [1, out] f32}, hq
    [K, B] int8, a [1, B] f32 -> [out, B] out_dtype (f32 or bf16)."""
    if hq.device.type == "cpu" and w["q8"].device.type == "cpu":
        return _w8_mm_plain(w, hq, a, out_dtype)
    return _launch(w["q8"], w["s"], hq, a, out_dtype, packed=False)
