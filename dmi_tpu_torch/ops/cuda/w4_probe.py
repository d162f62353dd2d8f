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
`plan` is the launch plan: the TMA ring into register-fed s8 wgmma after an
hᵀ pass, or the wmma tile of mm_tile.cuh for shapes TMA cannot take.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dmi_tpu_torch.ops.cuda import _build

# launches of the split-OUT and of the split-K kernel, and of either layout on
# the wgmma route and on the wmma tile, since each count was last set to 0
split_out_launches = 0
split_k_launches = 0
tma_launches = 0
wmma_launches = 0

BLOCK_B = 128              # batch columns a block of the wgmma route
SMS = 132                  # the H100's SMs: one persistent block each
SMEM_LIMIT = 232448        # shared memory a block may use
STAGE_ROWS = 128           # packed rows a ring stage
BOX_BYTES = 128 * 128      # a packed box: 128 rows of 128 packed columns
MAX_STAGES = 8
OUT_BYTES = 4 * 64 * 128   # the epilogue's buffers: two 64 x 32 pieces a consumer warpgroup
K_LIMIT = 131072           # the wgmma route takes K below it: 16 · 8 · 128 · K < 2³¹
WMMA_BM = 128              # the wmma tile's output rows (mm_tile.cuh at kBM 128)
WMMA_BN = 128


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


@functools.lru_cache(maxsize=None)
def plan(OUT: int, B: int, K: int, split_k: bool, aligned: bool = True) -> dict:
    """Launch plan of out [OUT, B] = Wᵀ h for h [K, B] and W packed split-K
    (p [K/2, OUT]) or split-OUT (p [K, OUT/2]).  `aligned`: the bases of p
    and h are 16-byte aligned.

    route "tma" where TMA takes every operand's rows and boxes (K a multiple
    of 16, so that hᵀ's rows are, and for split-K of 32, so that the box of
    hᵀ's second half starts on 16 bytes; B of 4, the int32 output's; OUT of
    32 for split-OUT, whose rows p's are, of 16 for split-K) and K < K_LIMIT
    (the kernel sums 16 x each nibble in int32; at K_LIMIT a row of -8
    against a column of -128 sums to 2³¹): a pass writes hᵀ into `ht_bytes`
    of scratch, then `grid` persistent blocks (one an SM at most) walk the
    `tiles` tiles of 256 output rows x BLOCK_B batch columns
    (tile_walk), K streaming through `stages` stages of 128 packed rows.
    route "wmma": mm_tile.cuh's tile on a (B / 128, row tiles) grid, 128
    output rows a block (64 packed columns for split-OUT)."""
    if not (aligned and K % (32 if split_k else 16) == 0 and B % 4 == 0
            and OUT % (16 if split_k else 32) == 0 and 0 < K < K_LIMIT):
        rows = -(-OUT // WMMA_BM) if split_k else -(-(OUT // 2) // (WMMA_BM // 2))
        return {"route": "wmma", "bm": WMMA_BM, "bn": WMMA_BN,
                "grid": (-(-B // WMMA_BN), rows), "ht_bytes": 0}
    packed = (2 if split_k else 1) * BOX_BYTES
    stage = packed + (2 if split_k else 1) * BLOCK_B * 128
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - OUT_BYTES - 16 * MAX_STAGES) // stage)
    m_tiles = -(-OUT // 256) if split_k else -(-(OUT // 2) // 128)
    n_tiles = -(-B // BLOCK_B)
    return {"route": "tma", "bm": 256, "bn": BLOCK_B, "stage_bytes": stage, "stages": stages,
            "smem": 1024 + stages * stage + OUT_BYTES + 16 * stages,
            "m_tiles": m_tiles, "n_tiles": n_tiles, "tiles": m_tiles * n_tiles,
            "grid": min(m_tiles * n_tiles, SMS),
            "chunks": -(-(K // 2 if split_k else K) // STAGE_ROWS), "ht_bytes": B * K}


def tile_walk(p: dict) -> list:
    """The (row tile, batch tile) pairs each persistent block computes, in
    order, as csrc/w4_probe.cu's walk computes them: tile u = block, block +
    grid, ..., batch tiles fastest."""
    n = p["n_tiles"]
    return [[(u // n, u % n) for u in range(cta, p["tiles"], p["grid"])]
            for cta in range(p["grid"])]


def _launch(p, h, out_dim: int, split_k: bool):
    global split_out_launches, split_k_launches, tma_launches, wmma_launches
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
    pl = plan(out_dim, B, K, split_k, p.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0)
    tma = pl["route"] == "tma"
    ht = torch.empty((B, K), dtype=torch.int8, device=h.device) if tma else None
    err = _build.lib().dmi_w4_probe(p.data_ptr(), h.data_ptr(),
                                    None if ht is None else ht.data_ptr(), out.data_ptr(),
                                    out_dim, B, K, int(split_k), int(tma),
                                    pl["grid"] if tma else 0, pl.get("stages", 0),
                                    torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "w4 probe")
    if split_k:
        split_k_launches += 1
    else:
        split_out_launches += 1
    if tma:
        tma_launches += 1
    else:
        wmma_launches += 1
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
    return _launch(p_so, h, 2 * p_so.shape[1], False)


def w4_dot_split_k(p_sk, h):
    """p_sk [K/2, OUT] uint8, h [K, B] int8 -> Wᵀ h [OUT, B] int32."""
    _check(p_sk, h, 2 * p_sk.shape[0])
    if p_sk.device.type == "cpu" and h.device.type == "cpu":
        return _w4_split_k_plain(p_sk, h)
    return _launch(p_sk, h, p_sk.shape[1], True)
