"""Tracing hook (counterpart of dmi_tpu/utils/profiling.py:trace) and device
timing.

`trace(profile_dir)` wraps a training region in torch.profiler, CPU and CUDA
activity, and writes a Chrome/Perfetto trace into profile_dir when the
region ends; with no directory it does nothing.

`device_spans(run)` lists what the card ran during one run() (the smoke's
busy and idle shares), `device_ms(fn)` is the device time of one fn()
call, `least_time` a call's bound on the card and `nvidia_smi` the card's
name and power limit: the kernel timings of chip_smoke.py and of the
probes (dmi_tpu_torch.probes).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from typing import Optional

import torch

# the card's peak rates for a kernel's bound (NVIDIA's H100 SXM data sheet,
# dense): device memory, f32 on the CUDA cores (the kernels use no TF32),
# bf16 and int8 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace-{int(time.time())}.json"))


def device_spans(run) -> list:
    """(start us, end us, name) of every kernel, memcpy and memset that the
    device ran during one run() under torch.profiler, in order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    return spans


def device_ms(fn, iters=20) -> float:
    """Device time of one fn() call in ms: CUDA events around `iters` calls
    (after 3 warm-ups) that the host enqueued while a spin kernel held the
    stream, so that the device runs them back to back and never waits for
    the host to launch (a call whose bound is microseconds is shorter than
    its launch cost from Python).  A timing counts only if the device had
    not reached the first call when the host had enqueued the last one;
    else the hold grows, and past ~0.1 s the count of calls halves (the
    device's queue of pending launches is finite).  fn must not wait for
    the device.  torch.profiler's kernel spans, summed, are no such timer:
    a short session after the process has idled loses its kernels, the
    more the older the process."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold = 1 << 22  # spin-kernel cycles, ~2 ms at the card's clock
    while True:
        torch.cuda.synchronize()
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()  # the device had not reached the first call
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        if hold < 1 << 28:
            hold *= 4
        elif iters > 1:
            iters //= 2
        else:
            raise AssertionError("device_ms: the host cannot enqueue one call ahead of the "
                                 "device (does fn wait for it?)")


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    """The bytes the tensors hold."""
    return sum(t.numel() * t.element_size() for t in tensors)


def least_time(nbytes_moved, flops, dtype) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the peak rate of the inputs' type."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
