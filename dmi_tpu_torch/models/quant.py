"""Weight quantization for the serving/decode path (counterpart of
dmi_tpu/models/quant.py).

Greedy decode at caption batch sizes reads every layer weight once per
token step, so the weight stream bounds it.  Symmetric per-output-channel
quantization shrinks that stream:

    w ≈ q * s,   q = round(w / s) ∈ [-127, 127],   s = absmax_col / 127
    h @ w == (h @ q) * s          (s is per output column)

quantize_llama returns the same tree with each matmul weight replaced by a
dict whose keys name the mode, and llama._mm / decode._mm_bl dispatch on
them:

  {"q", "s"}     int8 weights widened to the model dtype at the matmul
  {"q8", "s"}    W8A8: per-token int8 activations, int8 x int8 -> int32
  {"qp", "s"}    W4A8: int4 weights nibble-packed along the contraction
                 axis (pack_w4), per-token int8 activations
  {"qp", "s4g"}  W4A8 with scales per group of the contraction axis

Every division, rounding (half to even) and clip runs in f32 in dmi_tpu's
order, so the integer payloads are bit-equal to the JAX package's.  The
port's layers are a list of per-layer dicts, so dmi_tpu's layer-by-layer
chunking of stacked leaves has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

# weights quantized per layer dict key; norms, biases and the MoE router
# stay as they are (w_qkv/w_gu are the fused layouts of
# llama.fuse_projections).  The expert stacks [E, in, out] quantize per
# expert and output column and are dequantized into the expert products;
# MLA's projections and deepseek's shared experts go through the matmuls
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_qkv", "w_gu",
               "moe_w1", "moe_w3", "moe_w2", "wq_a", "wq_b", "wkv_a", "wkv_b",
               "w_shared_gate", "w_shared_up", "w_shared_down"}
# fuse_projections' gate and up stacks [E, I, H], [E, out, in]: quantized
# along their last axis (quantize_rows), and dequantized with axis=-1
EXPERT_ROWS = {"moe_w1t", "moe_w3t"}


def _scale(absmax: torch.Tensor, levels: float) -> torch.Tensor:
    return torch.clamp_min(absmax / levels, 1e-12)


def _round_clip(x: torch.Tensor, levels: int) -> torch.Tensor:
    return torch.clamp(torch.round(x), -levels, levels).to(torch.int8)


def quantize_tensor(w: torch.Tensor, native: bool = False) -> dict:
    """Symmetric per-output-channel int8 of w [..., in, out]: scales
    [..., 1, out] over the contraction (in) axis (an expert stack
    [E, in, out] keeps its expert axis in the scales).  native=False gives the
    "q" key (weights widened to the model dtype before the matmul),
    native=True the "q8" key (W8A8).  The key name is the mode marker."""
    wf = w.float()
    s = _scale(wf.abs().amax(dim=-2, keepdim=True), 127.0)
    return {("q8" if native else "q"): _round_clip(wf / s, 127), "s": s}


def pack_w4(q: torch.Tensor) -> torch.Tensor:
    """K-split nibble packing: int8 nibbles in [-7, 7] with an even
    contraction dim K (axis -2) -> uint8 [..., K/2, out] where byte (k, n)
    holds rows k (low nibble) and k + K/2 (high nibble), so each half of a
    product contracts a contiguous slice of the activations."""
    K = q.shape[-2]
    if K % 2:
        raise ValueError(f"contraction dim {K} must be even to nibble-pack")
    u = q.contiguous().view(torch.uint8)
    lo = u[..., : K // 2, :]
    hi = u[..., K // 2:, :]
    return (lo & 0xF) | ((hi & 0xF) << 4)


def unpack_w4(p: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of pack_w4: uint8 [..., K/2, out] -> int8 [..., K, out],
    sign-extending each nibble; axis=-1 for a stack packed along its last
    axis (quantize_rows): [..., out, K/2] -> [..., out, K]."""
    p8 = p.contiguous().view(torch.int8)
    lo = (p8 << 4) >> 4  # low nibble, sign-extended
    hi = p8 >> 4         # high nibble (the arithmetic shift sign-extends)
    return torch.cat([lo, hi], dim=axis)


def quantize_tensor_int4(w: torch.Tensor, group_size: Optional[int] = None) -> dict:
    """W4A8 weights: symmetric int4 in [-7, 7], nibble-packed along the
    contraction axis (pack_w4).

    group_size None: per-output-channel scales over the whole contraction
    axis ({"qp", "s"}, s [..., 1, out]): the form the packed CUDA kernel
    takes.  group_size k: scales per k-sized block of the contraction axis
    ({"qp", "s4g"}, s4g [..., G, out]); its matmul unpacks and runs G
    partial products weighted by s4g."""
    wf = w.float()
    if group_size is None:
        s = _scale(wf.abs().amax(dim=-2, keepdim=True), 7.0)
        return {"qp": pack_w4(_round_clip(wf / s, 7)), "s": s}
    K = wf.shape[-2]
    if K % group_size:
        raise ValueError(f"contraction dim {K} not divisible by group {group_size}")
    G = K // group_size
    wg = wf.reshape(*wf.shape[:-2], G, group_size, wf.shape[-1])
    s = _scale(wg.abs().amax(dim=-2, keepdim=True), 7.0)  # [..., G, 1, out]
    q = _round_clip(wg / s, 7).reshape(wf.shape)
    return {"qp": pack_w4(q), "s4g": s.squeeze(-2)}


def quantize_rows(w: torch.Tensor, quantize) -> dict:
    """A stack w [..., out, in] (fuse_projections' expert rows) quantized
    by `quantize` (quantize_tensor or quantize_tensor_int4) as its
    [..., in, out] transpose, each payload and scale transposed back: q
    [..., out, in], qp [..., out, in/2] packed along the last axis, s
    [..., out, 1], s4g [..., out, G].  The integers and scales are those of
    the transpose, bit for bit; dequantize(..., axis=-1) reads them."""
    return {k: v.transpose(-1, -2).contiguous() for k, v in quantize(w.transpose(-1, -2)).items()}


def quantize_act(h: torch.Tensor, axis: int, reduce=None) -> tuple:
    """Dynamic symmetric per-token int8 activations: the scale runs over the
    contraction axis.  Returns (h_q int8, scales f32 with the axis kept).
    reduce: the max over the model group (Shard.pmax) when h holds this
    rank's slice of the contraction axis (a row-parallel product's input),
    so that the scales, and so the int8 values, are the one-rank ones."""
    hf = h.float()
    amax = hf.abs().amax(dim=axis, keepdim=True)
    a = _scale(amax if reduce is None else reduce(amax), 127.0)
    return _round_clip(hf / a, 127), a


def quantize_embed_tensor(w: torch.Tensor, native: bool = False) -> dict:
    """Per-vocab-row scales [V, 1]: right for both the gather (rows *
    s[row]) and the tied head x @ embed.T (output channel == vocab row)."""
    wf = w.float()
    s = _scale(wf.abs().amax(dim=-1, keepdim=True), 127.0)
    return {("q8" if native else "q"): _round_clip(wf / s, 127), "s": s}


def dequantize(w, dtype, axis: int = -2) -> torch.Tensor:
    """A quantized weight dict back as a dense tensor of `dtype` (any other
    weight is returned as it is): the consumers without a quantized matmul,
    the MoE expert products and MLA's absorbed wkv_b.  axis: the
    contraction axis, along which int4 is packed and scales are grouped;
    -1 for the stacks of quantize_rows."""
    if not isinstance(w, dict):
        return w
    if "q8" in w or "q" in w:
        q = w["q8"] if "q8" in w else w["q"]
        return (q.float() * w["s"]).to(dtype)
    if "qp" in w:
        q = unpack_w4(w["qp"], axis).float()
        if "s4g" in w:
            s4g = w["s4g"]  # [..., G, out], or [..., out, G] at axis -1
            if axis == -1:
                G, K = s4g.shape[-1], q.shape[-1]
                return (q.reshape(*q.shape[:-1], G, K // G) * s4g[..., None]
                        ).reshape(q.shape).to(dtype)
            G, K = s4g.shape[-2], q.shape[-2]
            qg = q.reshape(*q.shape[:-2], G, K // G, q.shape[-1])
            return (qg * s4g[..., :, None, :]).reshape(q.shape).to(dtype)
        return (q * w["s"]).to(dtype)
    raise ValueError(f"unknown quantized dict keys {sorted(w)}")


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 accumulator of an int8 x int8 product a [..., m, k] @
    b [..., k, n], returned as f32 (what int32 -> f32 conversion gives).

    The product runs in f64: every partial sum is an integer below 2**53,
    so it is exact on any device and in any summation order (f32 is not:
    127 * 127 * 8192 exceeds 2**24; CUDA has no int32 matmul).  The one
    rounding is f64 -> f32, the rounding of int32 -> f32."""
    return (a.double() @ b.double()).float()


def quantize_llama(
    params: dict,
    quantize_embed: bool = True,
    native: bool = False,
    bits: int = 8,
    group_size: Optional[int] = None,
) -> dict:
    """Quantize the port's decoder tree for decode.  native=True selects
    W8A8.  bits=4 selects W4A8 for the LAYER weights (group_size optionally
    groups the scales along the contraction axis); the tied embed then
    stays native int8 ("q8"), as in dmi_tpu.  An untied lm_head [H, V] is
    quantized as a layer weight (per output column); norms, biases and the
    MoE router stay in their dtypes."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def leaf(v):
        return quantize_tensor_int4(v, group_size) if bits == 4 else quantize_tensor(v, native)

    def quantize(k, v):
        if k in EXPERT_ROWS:
            return quantize_rows(v, leaf)
        return leaf(v) if k in _QUANT_KEYS else v

    out: dict[str, Any] = {"final_norm": params["final_norm"]}
    out["layers"] = [{k: quantize(k, v) for k, v in lw.items()} for lw in params["layers"]]
    out["embed"] = (quantize_embed_tensor(params["embed"], native=native or bits == 4)
                    if quantize_embed else params["embed"])
    if "lm_head" in params:
        out["lm_head"] = leaf(params["lm_head"])
    return out


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q8" in w or "qp" in w)
