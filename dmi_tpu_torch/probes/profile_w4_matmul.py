"""Does streaming nibble-packed int4 weights beat streaming int8 weights?
(Port of scripts/profile_w4_matmul.py.)

At Llama-3.2-1B's gate-up shape (K 2048, OUT 16384, batch 256), int8
activations h [K, B] against weights in [-7, 7], -> int32 [OUT, B]:

  cuda_split_out          w4_dot_split_out (csrc/w4_probe.cu) on p_so [K, OUT/2]
  cuda_split_k            w4_dot_split_k on p_sk [K/2, OUT] (kernel 7's layout)
  plain_split_*           their twins (exact products in f64)
  torch_w8_int8_stream    torch._int_mm on the int8 weights
  torch_w4_packed_stream  unpack the interleaved bytes, stack, torch._int_mm
  torch_w4_split_out      unpack p_so, two torch._int_mm, concatenate
  torch_w4_split_k        unpack p_sk, two torch._int_mm, add

Every variant must equal the int8 product bit for bit before anything is
timed (the script's gate, :199-210).

Usage: python -m dmi_tpu_torch.probes.profile_w4_matmul [--batch 256] [--k 2048]
       [--out 16384] [--inner 100] [--small] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dmi_tpu_torch.ops.cuda.w4_probe import (_w4_split_k_plain, _w4_split_out_plain, nibbles,
                                             pack_split_k, pack_split_out, w4_dot_split_k,
                                             w4_dot_split_out)
from dmi_tpu_torch.probes import bound, device_info, library_call, time_variant
from dmi_tpu_torch.training.model_utils import require_device
from dmi_tpu_torch.utils.profiling import nbytes


def run(batch: int = 256, k: int = 2048, out: int = 16384, inner: int = 100,
        small: bool = False, device: str = "cuda") -> dict:
    dev = require_device(device)
    if small:
        batch, inner, k, out = 4, 3, 64, 128
    B, K, OUT = batch, k, out
    rng = np.random.default_rng(0)
    w8n = rng.integers(-7, 8, size=(K, OUT)).astype(np.int8)
    hn = rng.integers(-64, 64, size=(K, B)).astype(np.int8)
    # the script's three layouts (:67-70, :93-96, :110-113)
    packed = ((w8n[:, 0::2] & 0xF) | ((w8n[:, 1::2] & 0xF) << 4)).astype(np.uint8)
    w8, h, p, p_so, p_sk = (torch.from_numpy(x).to(dev) for x in
                            (w8n, hn, packed, pack_split_out(w8n), pack_split_k(w8n)))
    h_t = h.t().contiguous()  # torch._int_mm's row operand: batch-first activations
    h_lo, h_hi = h_t[:, :K // 2].contiguous(), h_t[:, K // 2:].contiguous()
    results = {"batch": B, "K": K, "OUT": OUT, "inner": inner, **device_info(dev)}

    def packed_stream():
        lo, hi = nibbles(p)
        return torch._int_mm(h_t, torch.stack([lo, hi], dim=-1).reshape(K, OUT)).t()

    def split_out():
        lo, hi = nibbles(p_so)
        return torch.cat([torch._int_mm(h_t, lo), torch._int_mm(h_t, hi)], dim=1).t()

    def split_k():
        lo, hi = nibbles(p_sk)
        return (torch._int_mm(h_lo, lo) + torch._int_mm(h_hi, hi)).t()

    kernels = {"cuda_split_out": lambda: w4_dot_split_out(p_so, h),
               "cuda_split_k": lambda: w4_dot_split_k(p_sk, h)}
    variants = {"plain_split_out": lambda: _w4_split_out_plain(p_so, h),
                "plain_split_k": lambda: _w4_split_k_plain(p_sk, h)}
    chains = {"torch_w8_int8_stream": lambda: torch._int_mm(h_t, w8).t(),
              "torch_w4_packed_stream": packed_stream, "torch_w4_split_out": split_out,
              "torch_w4_split_k": split_k}

    # correctness gate, before any timing: every variant equals the int8 product
    ref = (w8.double().t() @ h.double()).to(torch.int32)
    for name, fn in {**kernels, **variants, **chains}.items():
        got = library_call(results, dev, name, fn) if name in chains else fn()
        if got is None:
            continue
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} differs from the int8 product")
        if name not in chains:
            results[f"{name}_max_abs_err"] = 0
        else:
            variants[name] = fn
    print("correctness: every packed variant exact against int8", flush=True)

    ops = 2 * K * OUT * B
    bound(results, "cuda_split_out", nbytes(p_so, h) + OUT * B * 4, ops, "int8")
    bound(results, "cuda_split_k", nbytes(p_sk, h) + OUT * B * 4, ops, "int8")
    if dev.type == "cuda":
        variants = {**kernels, **variants}
    for name, fn in variants.items():
        time_variant(results, dev, inner, name, fn)
    t = {name: results.get(f"{name}_ms") for name in (*kernels, *chains)}  # on the card
    if t["torch_w8_int8_stream"] and t["torch_w4_packed_stream"]:
        results["w4_speedup"] = t["torch_w8_int8_stream"] / t["torch_w4_packed_stream"]
    for name in kernels:
        if t["torch_w8_int8_stream"] and t[name]:
            results[f"{name}_vs_int8_stream"] = t["torch_w8_int8_stream"] / t[name]
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--out", type=int, default=16384)
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.batch, args.k, args.out, args.inner, args.small, args.device),
                     indent=2))


if __name__ == "__main__":
    main()
