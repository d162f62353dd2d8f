"""Does a hand-written int8 tensor-core matmul run at about twice the bf16
rate on the card?  (Port of scripts/profile_int8_mxu.py.)

At a compute-bound square shape (M = N = K = 4096), times:

  cuda_int8   block_mm on int8 operands -> int32 (csrc/block_mm.cu)
  cuda_bf16   block_mm on bf16 operands -> f32
  plain_*     their twins (int8: f64 product cast to int32; bf16: f32)
  torch_int8  torch._int_mm (cuBLAS) -> int32
  torch_bf16  torch.matmul (cuBLAS) -> bf16: it rounds its output to bf16
              where the kernel writes f32, so its output is reported, not
              held to the kernel's tolerance

The H100's dense peaks are 1979 int8 TOP/s and 989 bf16 TFLOP/s: a ratio
near 2 says the int8 tensor cores pay off.

Usage: python -m dmi_tpu_torch.probes.profile_int8_mxu [--n 4096] [--inner 30]
       [--bm 256] [--small] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dmi_tpu_torch.ops.cuda.block_mm import _block_mm_plain, block_mm
from dmi_tpu_torch.probes import bound, device_info, library_call, time_variant
from dmi_tpu_torch.training.model_utils import require_device
from dmi_tpu_torch.utils.profiling import nbytes

# bf16 gate: kernel and twin both sum in f32, in another order: relative to
# the largest |output|
BF16_TOL = 1e-5


def run(n: int = 4096, inner: int = 30, bm: int = 256, small: bool = False,
        device: str = "cuda") -> dict:
    dev = require_device(device)
    if small:
        n, inner, bm = 256, 2, 128
    rng = np.random.default_rng(0)
    a8, b8 = (torch.from_numpy(rng.integers(-127, 128, size=(n, n)).astype(np.int8)).to(dev)
              for _ in range(2))
    abf, bbf = (torch.from_numpy(rng.normal(size=(n, n))).to(dev, torch.bfloat16)
                for _ in range(2))
    results = {"N": n, "block_m": bm, "inner": inner, **device_info(dev)}

    # correctness gate, before any timing
    ref8 = _block_mm_plain(a8, b8)
    if not torch.equal(block_mm(a8, b8, bm), ref8):
        raise AssertionError("block_mm int8 differs from its twin")
    results["cuda_int8_max_abs_err"] = 0
    ref_bf = _block_mm_plain(abf, bbf)
    err = (block_mm(abf, bbf, bm) - ref_bf).abs().max().item()
    limit = BF16_TOL * ref_bf.abs().max().item()
    if not err <= limit:
        raise AssertionError(f"block_mm bf16: max |kernel - twin| {err} > {limit}")
    results["cuda_bf16_max_abs_err"] = err
    lib8 = library_call(results, dev, "torch_int8", lambda: torch._int_mm(a8, b8))
    if lib8 is not None and not torch.equal(lib8, ref8):
        raise AssertionError("torch._int_mm differs from the exact int8 product")
    results["torch_bf16_max_abs_err"] = (torch.matmul(abf, bbf).float()
                                         - ref_bf).abs().max().item()
    print("correctness: block_mm int8 exact, bf16 within "
          f"{BF16_TOL} of max |out| of its twin", flush=True)

    ops = 2 * n ** 3
    bound(results, "cuda_int8", nbytes(a8, b8) + n * n * 4, ops, "int8")
    bound(results, "cuda_bf16", nbytes(abf, bbf) + n * n * 4, ops, "bfloat16")
    variants = {"plain_int8": lambda: _block_mm_plain(a8, b8),
                "plain_bf16": lambda: _block_mm_plain(abf, bbf),
                "torch_bf16": lambda: torch.matmul(abf, bbf)}
    if lib8 is not None:
        variants["torch_int8"] = lambda: torch._int_mm(a8, b8)
    if dev.type == "cuda":
        variants = {"cuda_int8": lambda: block_mm(a8, b8, bm),
                    "cuda_bf16": lambda: block_mm(abf, bbf, bm), **variants}
    for name, fn in variants.items():
        time_variant(results, dev, inner, name, fn, ("tflops", ops / 1e12))
    for lib in ("cuda", "torch"):  # bf16 time over int8 time, on the card
        i8, bf = results.get(f"{lib}_int8_ms"), results.get(f"{lib}_bf16_ms")
        if i8 and bf:
            results[f"{lib}_int8_speedup"] = bf / i8
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--inner", type=int, default=30)
    ap.add_argument("--bm", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False  # the bf16 twin is an f32 product
    print(json.dumps(run(args.n, args.inner, args.bm, args.small, args.device), indent=2))


if __name__ == "__main__":
    main()
