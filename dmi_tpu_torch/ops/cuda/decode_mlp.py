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
float atomics: greedy tokens must not change from run to run).  bf16 runs
on a TMA ring and wgmma (launch plan: `plan`), the last split of each tile
adding the partials; f32 on the CUDA cores, with a reduce launch
(`down_splits`).

Rounding points, as the Pallas body (decode_mlp.py:62-80): g and u
accumulate in f32 and are rounded to h's dtype; act(g) * u is formed in h's
dtype; the down product accumulates in f32 and is rounded once at the end.

`fused_decode_mlp_bl` runs `_decode_mlp_plain` for tensors on the CPU and
launches the kernels for tensors on a CUDA device; there is no fallback
between the two.  dmi_tpu gates its kernel by an environment variable and
by Mosaic's tile shapes; here every unquantized fused w_gu takes it.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda import _build

# calls that launched the CUDA kernels since the count was last set to 0
launches = 0

ACTS = {"silu": 0, "gelu_tanh": 1}
TILE_M = 64      # kTileM of csrc/decode_mlp.cu (f32): weight columns per block
TILE_B = 128     # kTileN (f32): batch columns per block
MAX_SPLITS = 16  # f32: splits of the I axis in the down product
TARGET_BLOCKS = 128  # f32: blocks the down product should reach on 132 SMs
SMS = 132        # streaming multiprocessors of the H100
TILE_COLS = 64   # bf16 (kTileCols of csrc/decode_mlp.cu): weight columns of a wgmma tile
TILE_K = 64      # bf16 kKc: K rows of a ring stage
DOWN_COLS = 64   # bf16: columns of H of a down block
SMEM_LIMIT = 232448  # 227 KB: a block's shared memory on the H100
MAX_STAGES = 8


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


def _whole_chunks(rows: int) -> int:
    """rows rounded up to whole 64-row chunks of the contraction axis."""
    return -(-rows // TILE_K) * TILE_K


def down_splits(H: int, I: int, B: int) -> int:
    """f32: splits of the I axis in the down product: enough that its blocks
    cover the card, each split at least one tile of rows deep."""
    tiles = -(-H // TILE_M) * -(-B // TILE_B)
    return max(1, min(MAX_SPLITS, -(-TARGET_BLOCKS // tiles), I // TILE_M))


@functools.lru_cache(maxsize=None)
def plan(H: int, I: int, Bp: int) -> dict:
    """bf16 launch plan at a padded batch Bp.  The C entry dispatches on n
    and wgs, checks the stages against its rings (Ring in
    csrc/decode_mlp.cu) and splits the down product by splits and
    per_split; the rest is what the wrapper allocates and what the tests
    read.

    The wgmma tile takes n = 64 batch columns up to Bp 64, else 128, and
    `wgs` consumer warpgroups (2 past 128) of n columns each share a block's
    weight tiles; wider batches tile the grid (`batch_tiles`).  The gate-up
    pass gives every 64 columns of I a block; the down pass every 64 columns
    of H `splits` blocks over the I axis, whole K chunks each, as many as
    one wave of one block an SM holds (the ring takes most of an SM's shared
    memory), none empty.  The ring holds as many 64-row stages as 227 KB
    allow, up to MAX_STAGES."""
    n = 64 if Bp <= 64 else 128
    wgs = 1 if Bp <= 128 else 2
    batch_tiles = -(-Bp // (n * wgs))
    m_tiles = -(-H // DOWN_COLS)
    splits = max(1, min(SMS // (m_tiles * batch_tiles), -(-I // TILE_K)))
    per_split = _whole_chunks(-(-I // splits))
    splits = -(-I // per_split)

    def ring(tiles):
        stage = 8192 * (tiles + wgs * n // TILE_COLS)
        stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - 16 * MAX_STAGES) // stage)
        return stages, 1024 + stages * stage + 16 * stages

    stages, smem = ring(2)  # gate-up: the gate and the up tile
    down_stages, down_smem = ring(DOWN_COLS // TILE_COLS)
    return {"n": n, "wgs": wgs, "stages": stages, "down_stages": down_stages,
            "splits": splits, "per_split": per_split, "batch_tiles": batch_tiles,
            "m_tiles": m_tiles, "gate_up_blocks": -(-I // TILE_COLS) * batch_tiles,
            "down_blocks": m_tiles * splits * batch_tiles, "smem": smem, "down_smem": down_smem,
            "counters": m_tiles * batch_tiles,
            # f32 partials: every split's [DOWN_COLS, wgs * n] tile of every down tile
            "partial_floats": splits * m_tiles * batch_tiles * DOWN_COLS * wgs * n}


# (device, stream) -> int32 zeros, one per down tile: the last of a tile's
# splits sets its counter back to 0, so a call leaves them as it found them.
# One buffer per stream, so that calls that share one run in order.
_counters = {}


def _tile_counters(device, stream: int, n: int) -> torch.Tensor:
    c = _counters.get((device, stream))
    if c is None or c.numel() < n:
        c = _counters[(device, stream)] = torch.zeros(max(n, 256), dtype=torch.int32,
                                                      device=device)
    return c


def padded_batch(B: int) -> int:
    """The batch the kernels run at (zero columns give zero outputs): a
    multiple of 16 columns, so that f32 rows are read 16 bytes at a time
    and every bf16 TMA row stride is a multiple of 16 bytes."""
    return -(-B // 16) * 16


def map_encodes() -> dict:
    """Tensor maps the kernel library has encoded since it was loaded, the
    weights' and the activations' (cached apart)."""
    lib = _build.lib()
    return {"weights": lib.dmi_decode_mlp_map_encodes(0),
            "activations": lib.dmi_decode_mlp_map_encodes(1)}


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
    Bp = padded_batch(B)
    hp = h.contiguous() if Bp == B else F.pad(h, (0, Bp - B))
    out = torch.empty((H, Bp), dtype=h.dtype, device=h.device)
    if B == 0:
        return out[:, :B]
    act_buf = torch.empty((I, Bp), dtype=h.dtype, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if code == _build.DTYPE_CODES["bfloat16"]:
        p = plan(H, I, Bp)
        launch = (p["n"], p["wgs"], p["stages"], p["down_stages"], p["splits"], p["per_split"])
        counters = _tile_counters(h.device, stream, p["counters"]).data_ptr()
        partial = torch.empty(p["partial_floats"], dtype=torch.float32, device=h.device)
    else:
        splits = down_splits(H, I, Bp)
        launch = (0, 0, 0, 0, splits, _whole_chunks(-(-I // splits)))
        counters = None
        partial = torch.empty((splits, H, Bp), dtype=torch.float32, device=h.device)
    err = _build.lib().dmi_decode_mlp(
        w_gu.data_ptr(), w_down.data_ptr(), hp.data_ptr(), act_buf.data_ptr(),
        partial.data_ptr(), counters, out.data_ptr(), H, I, Bp, *launch, ACTS[act], code,
        stream,
    )
    _build.check(err, "decode MLP")
    launches += 1
    return out if Bp == B else out[:, :B].contiguous()
