"""Blocked int8/bf16 matmul of the int8 tensor-core probe.

Counterpart of the TPU kernel pallas_mm of scripts/profile_int8_mxu.py:74-85,
which is csrc/block_mm.cu here: out = a @ b for a [M, K] and b [K, N], both
int8 (int32 out) or both bf16 (f32 out), on the tensor cores.  The probe
(dmi_tpu_torch.probes.profile_int8_mxu) times both types to read the
card's int8:bf16 rate.

`block_mm` runs `_block_mm_plain` for tensors on the CPU and launches the
kernel for tensors on a CUDA device; there is no fallback between the two.
`plan` is the launch plan: the TMA and wgmma kernel's tile, ring and
persistent grid, or the wmma instance for shapes TMA cannot take.
"""

from __future__ import annotations

import functools

import torch

from dmi_tpu_torch.ops.cuda import _build

# calls that launched the kernel since the count was last set to 0 (both
# types), and of those the bf16 ones
launches = 0
bf16_launches = 0

BLOCK_M = (64, 128, 256)  # output rows per block: the kernel's template instances
SMS = 132                 # the H100's SMs: one persistent block each
SMEM_LIMIT = 232448       # shared memory a block may use
STAGE_K_BYTES = 128       # bytes of K a ring stage: one 128-byte swizzled row
MAX_STAGES = 8
OUT_BYTES = 4 * 64 * 128  # the epilogue's buffers: two 64 x 32 pieces a consumer warpgroup
WMMA_TILE = (128, 128)    # the wmma instance's block tile (mm_tile.cuh at kBM 128)
WMMA_SMEM = 4 * (128 * 64 + 64 * 128)  # its four 64-byte chunks of A and B rows
# block_m -> (consumer warpgroups along M, m64 tiles a warpgroup, columns a
# warpgroup); the two warpgroups split N where they do not split M
TILES = {64: (1, 1, 128), 128: (2, 1, 256), 256: (2, 2, 128)}


def _block_mm_plain(a, b):
    """The kernel's function in plain torch.  int8: the product in f64 (exact:
    |sum| <= 128² K < 2⁵³), cast to int32; f32 would drop low bits once a sum
    passes 2²⁴ (K 4096 reaches 6.6e7).  bf16: the f32 product (TF32 stays
    off, torch's default for matmuls)."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, int8: bool, block_m: int = 128, aligned: bool = True) -> dict:
    """Launch plan of out = a [M, K] @ b [K, N].  `aligned`: every operand's
    base is 16-byte aligned.

    route "tma" where TMA takes the operands' rows, whole 16-byte units
    (int8: K and N multiples of 16, which b's transpose pass also reads and
    writes 16 bytes at a time; bf16: multiples of 8): a block owns a bm x bn
    output tile (block_m -> TILES), K streams through `stages` stages of
    128 bytes of K each (as many as 227 KB hold beside the epilogue's
    OUT_BYTES, up to MAX_STAGES); `grid` persistent blocks, one an SM at
    most, walk the `tiles` output tiles (tile_walk).  int8 needs `bt_bytes`
    of scratch for b^T.  route "wmma": mm_tile.cuh's instance on a
    (N / 128, M / 128) grid of 128 x 128 tiles."""
    if block_m not in BLOCK_M:
        raise ValueError(f"block_mm: block_m must be one of {BLOCK_M}, got {block_m}")
    unit = 16 if int8 else 8
    if not (aligned and K % unit == 0 and N % unit == 0):
        bm, bn = WMMA_TILE
        return {"route": "wmma", "bm": bm, "bn": bn, "grid": (-(-N // bn), -(-M // bm)),
                "smem": WMMA_SMEM, "bt_bytes": 0}
    wm, mt, n = TILES[block_m]
    bm, bn = 64 * mt * wm, n * (2 // wm)
    stage = (bm + bn) * STAGE_K_BYTES
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - OUT_BYTES - 16 * MAX_STAGES) // stage)
    m_tiles, n_tiles = -(-M // bm), -(-N // bn)
    return {"route": "tma", "bm": bm, "bn": bn, "warpgroups_m": wm, "m64_tiles": mt,
            "wgmma_n": n, "stage_bytes": stage, "stages": stages,
            "smem": 1024 + stages * stage + OUT_BYTES + 16 * stages,
            "m_tiles": m_tiles, "n_tiles": n_tiles, "tiles": m_tiles * n_tiles,
            "grid": min(m_tiles * n_tiles, SMS),
            "chunks": -(-K * (1 if int8 else 2) // STAGE_K_BYTES), "bt_bytes": N * K if int8 else 0}


def tile_walk(p: dict) -> list:
    """The (row tile, column tile) pairs each persistent block computes, in
    order, as csrc/block_mm.cu's walk computes them: tile u = block, block +
    grid, ..., rows fastest."""
    m = p["m_tiles"]
    return [[(u % m, u // m) for u in range(cta, p["tiles"], p["grid"])]
            for cta in range(p["grid"])]


def block_mm(a, b, block_m: int = 128):
    """a [M, K] @ b [K, N]: int8 -> int32 or bf16 -> f32.  block_m (64, 128,
    256) picks the kernel's tile; the twin ignores it."""
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
    global launches, bf16_launches
    M, K = a.shape
    N = b.shape[1]
    int8 = a.dtype == torch.int8
    out = torch.empty((M, N), dtype=torch.int32 if int8 else torch.float32, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    p = plan(M, N, K, int8, block_m, aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    tma = p["route"] == "tma"
    bt = torch.empty((N, K), dtype=torch.int8, device=a.device) if p["bt_bytes"] else None
    err = _build.lib().dmi_block_mm(a.data_ptr(), b.data_ptr(),
                                    None if bt is None else bt.data_ptr(), out.data_ptr(),
                                    M, N, K, block_m, int(int8), int(tma),
                                    p["grid"] if tma else 0, p.get("stages", 0),
                                    torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "block_mm")
    launches += 1
    bf16_launches += not int8
    return out
