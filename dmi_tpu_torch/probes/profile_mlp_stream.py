"""Can a hand-written matmul stream the decode MLP's weights faster than
the library?  (Port of scripts/profile_mlp_stream.py.)

Times the bandwidth-bound gate-up matmul of Llama-3.2-1B's decode step, w
[2048, 16384] bf16 against batch-last h [2048, 256] bf16 -> wᵀ h [16384,
256] bf16:

  cuda_bo<W>  stream_mm_bl at each output-tile width W the kernel is
              compiled for (csrc/stream_mm.cu; the script's bo sweep)
  plain       its twin (f32 product, rounded once)
  torch       w.t() @ h (cuBLAS)

and reports GB/s of the weight stream (I · O · 2 bytes per call).

Usage: python -m dmi_tpu_torch.probes.profile_mlp_stream [--inner 50] [--small]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dmi_tpu_torch.ops.cuda.stream_mm import BLOCK_OUT, _stream_mm_plain, stream_mm_bl
from dmi_tpu_torch.probes import (bf16_steps, bound, device_info, f32_sum_slack,
                                  time_variant)
from dmi_tpu_torch.training.model_utils import require_device
from dmi_tpu_torch.utils.profiling import nbytes


def run(inner: int = 50, small: bool = False, device: str = "cuda") -> dict:
    dev = require_device(device)
    if small:
        inner = 2
    I, O, B = (128, 256, 32) if small else (2048, 16384, 256)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(I, O)).astype(np.float32)).to(dev, torch.bfloat16)
    h = torch.from_numpy(rng.normal(size=(I, B)).astype(np.float32)).to(dev, torch.bfloat16)
    results = {"I": I, "O": O, "B": B, "inner": inner, **device_info(dev)}
    widths = BLOCK_OUT if dev.type == "cuda" else BLOCK_OUT[:1]  # the CPU runs the twin

    # correctness gate, before any timing: within one bf16 step of the twin,
    # beyond what two f32 summation orders may differ by
    ref = _stream_mm_plain(w, h)
    slack = f32_sum_slack(w.t(), h)
    for bo in widths:
        got = stream_mm_bl(w, h, bo)
        steps = bf16_steps(got, ref, slack)
        if not steps <= 1:
            raise AssertionError(f"stream_mm block_out {bo}: {steps} bf16 steps from its twin")
        results[f"cuda_bo{bo}_max_bf16_steps"] = steps
        results[f"cuda_bo{bo}_max_abs_err"] = (got.float() - ref.float()).abs().max().item()
    results["torch_max_bf16_steps"] = bf16_steps(w.t() @ h, ref, slack)
    print("correctness: stream_mm within one bf16 step of its twin at every width (beyond "
          "the f32 summation-order slack)", flush=True)

    bound(results, "cuda", nbytes(w, h) + O * B * 2, 2 * I * O * B, "bfloat16")
    variants = {"plain": lambda: _stream_mm_plain(w, h), "torch": lambda: w.t() @ h}
    if dev.type == "cuda":
        variants = {**{f"cuda_bo{bo}": (lambda bo=bo: stream_mm_bl(w, h, bo)) for bo in widths},
                    **variants}
    for name, fn in variants.items():
        time_variant(results, dev, inner, name, fn, ("gbps", I * O * 2 / 1e9))
    if dev.type == "cuda":
        best = min(widths, key=lambda bo: results[f"cuda_bo{bo}_ms"])
        results["cuda_best_bo"] = best
        results["cuda_best_speedup"] = results["torch_ms"] / results[f"cuda_bo{best}_ms"]
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inner", type=int, default=50)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin is an f32 product
    print(json.dumps(run(args.inner, args.small, args.device), indent=2))


if __name__ == "__main__":
    main()
