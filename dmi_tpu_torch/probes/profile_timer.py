"""Does summing torch.profiler's kernel spans time a call on the card?

The kernel timer of chip_smoke.py and the probes, utils.profiling.device_ms,
times CUDA events around calls enqueued behind a held stream.  This probe
shows why it does not sum the profiler's kernel spans: in one process that
idles between rounds, it times the same calls both ways and counts the
kernel spans a profiler session of `--iters` calls kept.  A session that
keeps every kernel keeps as many spans in each round as in the first.

Usage: python -m dmi_tpu_torch.probes.profile_timer [--rounds 5] [--idle 40]
       [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from dmi_tpu_torch.training.model_utils import require_device
from dmi_tpu_torch.utils.profiling import device_ms, device_spans, nvidia_smi


def profiler_ms(fn, iters: int) -> tuple[float, int]:
    """The summed kernel spans of one profiler session of `iters` calls,
    over iters, and the number of spans it kept."""
    for _ in range(3):
        fn()
    try:
        spans = device_spans(lambda: [fn() for _ in range(iters)])
    except AssertionError:  # the session kept no span at all
        return 0.0, 0
    return sum(e - s for s, e, _ in spans) / iters / 1e3, len(spans)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--idle", type=float, default=40.0, help="seconds between rounds")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(1024, 1024, generator=gen, device=dev).bfloat16()
    b = torch.randn(4096, 4096, generator=gen, device=dev).bfloat16()
    fns = {"mm1024": lambda: a @ a, "mm4096": lambda: b @ b}
    print(json.dumps({"device": nvidia_smi(), "iters": args.iters}), flush=True)
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        row = {"t_s": time.perf_counter() - t0}
        for name, fn in fns.items():
            ms, kept = profiler_ms(fn, args.iters)
            row[name] = {"spans_kept": kept, "spans_ms": ms, "device_ms": device_ms(fn, args.iters)}
        print(json.dumps(row), flush=True)
        time.sleep(args.idle)


if __name__ == "__main__":
    main()
