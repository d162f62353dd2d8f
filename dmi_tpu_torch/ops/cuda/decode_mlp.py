"""The gated MLP of one batch-last decode step in one weight stream.

Counterpart of dmi_tpu/ops/pallas/decode_mlp.py:fused_decode_mlp_bl, whose
TPU kernel (_mlp_pallas_bl) is csrc/decode_mlp.cu here:

    g = w_gu[:, :I]ᵀ @ h,  u = w_gu[:, I:]ᵀ @ h        [I, B]
    out = w_downᵀ @ (act(g) * u)                       [H, B]

The decode loop is bound by its per-step weight stream, and the MLP holds
most of a llama layer's bytes (3·H·I of them).  Every weight byte is read
once per call.  One TPU core walks the I tiles in order with one resident
f32 accumulator; on the card the I axis is spread over blocks, so the
[H, B] sum is formed from per-split partials added in a fixed order (no
float atomics: greedy tokens must not change from run to run).

Rounding points, as the Pallas body (decode_mlp.py:62-80): g and u
accumulate in f32 and are rounded to h's dtype; act(g) * u is formed in h's
dtype; the down product accumulates in f32 and is rounded once at the end.

`fused_decode_mlp_bl` runs `_decode_mlp_plain` for tensors on the CPU and
launches the kernels for tensors on a CUDA device; there is no fallback
between the two.  dmi_tpu gates its kernel by an environment variable and
by Mosaic's tile shapes; here every unquantized fused w_gu takes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda import _build

# calls that launched the CUDA kernels since the count was last set to 0
launches = 0

ACTS = {"silu": 0, "gelu_tanh": 1}
TILE_M = 64      # kTileM of csrc/decode_mlp.cu: weight columns per block
TILE_B = 128     # kTileN: batch columns per block
MAX_SPLITS = 16  # splits of the I axis in the down product
TARGET_BLOCKS = 128  # blocks the down product should reach on 132 SMs


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown mlp_act {name!r}")


def _decode_mlp_plain(w_gu, w_down, h, act="silu"):
    """The kernel's math in plain torch: dmi_tpu's _mlp_xla_bl (matmuls
    that accumulate in f32 and emit h's dtype, the activation applied in
    h's dtype).

    w_gu [H, 2I], w_down [I, H], h [H, B] -> [H, B]."""
    gate, up = (w_gu.t() @ h).chunk(2, dim=0)
    return w_down.t() @ (_act(act, gate) * up)


def down_splits(H: int, I: int, B: int) -> int:
    """Splits of the I axis in the down product: enough that its blocks
    cover the card, each split at least one tile of rows deep."""
    tiles = -(-H // TILE_M) * -(-B // TILE_B)
    return max(1, min(MAX_SPLITS, -(-TARGET_BLOCKS // tiles), I // TILE_M))


def fused_decode_mlp_bl(w_gu, w_down, h, act="silu"):
    """w_gu [H, 2I] (gate | up), w_down [I, H], h [H, B] -> [H, B], all of
    one dtype (f32 or bf16)."""
    global launches
    if act not in ACTS:
        raise ValueError(f"unknown mlp_act {act!r}")
    H, B = h.shape
    I = w_down.shape[0]
    if w_gu.shape != (H, 2 * I) or w_down.shape != (I, H):
        raise ValueError(
            f"decode MLP shapes: w_gu {tuple(w_gu.shape)}, w_down {tuple(w_down.shape)}, "
            f"h {tuple(h.shape)}"
        )
    tensors = (w_gu, w_down, h)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("decode MLP: all tensors must be on one device")
    if h.device.type == "cpu":
        return _decode_mlp_plain(w_gu, w_down, h, act)
    if h.device.type != "cuda":
        raise ValueError(f"decode MLP: no kernel for device {h.device}")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("decode MLP kernel: all tensors must share one dtype")
    code = _build.dtype_code(h.dtype)
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled():
        raise NotImplementedError("decode MLP kernel is forward-only")
    if not (w_gu.is_contiguous() and w_down.is_contiguous()):
        raise ValueError("decode MLP kernel: weights must be contiguous")
    if H % 8 or I % 8:
        raise ValueError(f"decode MLP kernel: H {H} and I {I} must be multiples of 8 "
                         "(16-byte loads of weight rows)")
    # the kernels read rows of h and of the activation 16 bytes at a time:
    # pad the batch to a multiple of 16 columns (zeros give zeros)
    Bp = -(-B // 16) * 16
    hp = h.contiguous() if Bp == B else F.pad(h, (0, Bp - B))
    splits = down_splits(H, I, Bp)
    act_buf = torch.empty((I, Bp), dtype=h.dtype, device=h.device)
    partial = torch.empty((splits, H, Bp), dtype=torch.float32, device=h.device)
    out = torch.empty((H, Bp), dtype=h.dtype, device=h.device)
    if B == 0:
        return out[:, :B]
    err = _build.lib().dmi_decode_mlp(
        w_gu.data_ptr(), w_down.data_ptr(), hp.data_ptr(), act_buf.data_ptr(),
        partial.data_ptr(), out.data_ptr(), H, I, Bp, splits, ACTS[act], code,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "decode MLP")
    launches += 1
    return out if Bp == B else out[:, :B].contiguous()
