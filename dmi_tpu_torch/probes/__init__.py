"""Kernel probes: the port of scripts/profile_int8_mxu.py,
scripts/profile_mlp_stream.py and scripts/profile_w4_matmul.py.

    python -m dmi_tpu_torch.probes.profile_int8_mxu [--n 4096] [--inner 30] [--bm 256] [--small]
    python -m dmi_tpu_torch.probes.profile_mlp_stream [--inner 50] [--small]
    python -m dmi_tpu_torch.probes.profile_w4_matmul [--batch 256] [--k 2048] [--out 16384]
                                                     [--inner 100] [--small]

Each also takes --device (default cuda; without a card it raises unless
given --device cpu).  A probe builds its operands from
numpy.random.default_rng(0) as its script does; holds every variant (the
hand-written kernel, its plain twin, the library call) against the twin
and raises before any timing if one differs; times each variant; and
prints one JSON line per variant, then the whole result.  On the card a
time is device time per call (utils.profiling.device_ms over `inner`
calls, after 3 warm-ups), beside the kernel's bound and the card's
`nvidia-smi` name and power limit.  On the CPU no kernel runs (the
wrappers run their twins): the twins and library calls are timed by the
median wall clock of `inner` calls, under keys ending in `_cpu_wall_ms`.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from dmi_tpu_torch.utils.profiling import device_ms, least_time, nvidia_smi


def device_info(dev: torch.device) -> dict:
    """What ran the probe: the card's name and power limit, or the CPU."""
    if dev.type == "cuda":
        return {"device": nvidia_smi(), "timer": "device time per call (CUDA events, held stream)"}
    return {"device": "cpu", "timer": "median wall clock on the CPU (no device time)"}


def ms_key(dev: torch.device, name: str) -> str:
    return f"{name}_ms" if dev.type == "cuda" else f"{name}_cpu_wall_ms"


def time_variant(results: dict, dev: torch.device, inner: int, name: str, fn,
                 rate: tuple | None = None) -> None:
    """Times one call of fn into results[ms_key(dev, name)] and prints its
    line.  rate (unit, amount per call), e.g. ("tflops", 2 N³ / 1e12), adds
    results[f"{name}_{unit}"] on the card."""
    line = {}
    if dev.type == "cuda":
        ms = device_ms(fn, iters=inner)
        if rate is not None:
            results[f"{name}_{rate[0]}"] = line[rate[0]] = rate[1] / (ms * 1e-3)
    else:
        fn()
        walls = []
        for _ in range(inner):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(walls)
        line["timer"] = "cpu wall"
    results[ms_key(dev, name)] = ms
    print(json.dumps({name: ms, **line}), flush=True)


def library_call(results: dict, dev: torch.device, name: str, fn):
    """fn()'s output, or None when torch refuses the shape (torch._int_mm
    on a card takes more than 16 rows and multiples of 8): its time is then
    recorded as null beside the reason."""
    try:
        return fn()
    except RuntimeError as e:
        results[ms_key(dev, name)] = None
        results[f"{name}_refused"] = str(e).splitlines()[0][:200]
        print(json.dumps({name: None, "refused": results[f"{name}_refused"]}), flush=True)
        return None


def bound(results: dict, name: str, moved: int, ops: int, dtype: str) -> None:
    """results[f"{name}_bound_us"] and [f"{name}_bound_by"]: the least time
    the card could take to move `moved` bytes and do `ops` operations
    (utils.profiling.least_time)."""
    b = least_time(moved, ops, dtype)
    results[f"{name}_bound_us"] = b["bound_ms"] * 1e3
    results[f"{name}_bound_by"] = b["bound_by"]


def f32_sum_slack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element of a @ b (a [M, K], b [K, N]): 2 K 2⁻²⁴ Σₖ |a_mk b_kn|,
    the most by which two f32 sums of the same K products, taken in two
    orders, can differ (each lies within K 2⁻²⁴ Σ|terms| of the exact sum).
    Where the sum cancels, that difference is many bf16 steps of the
    result."""
    return 2 * a.shape[1] * 2.0 ** -24 * (a.float().abs() @ b.float().abs())


def bf16_steps(out: torch.Tensor, ref: torch.Tensor, slack=0.0) -> float:
    """The largest |out - ref| beyond `slack` (a number or a tensor of
    out's shape) in bf16 steps: each element's excess over the spacing of
    bf16 values at the larger of its two magnitudes."""
    o, r = out.float(), ref.float()
    _, exp = torch.frexp(torch.maximum(o.abs(), r.abs()))
    step = torch.ldexp(torch.ones_like(o), exp - 8)
    return (((o - r).abs() - slack).clamp(min=0) / step).max().item()
