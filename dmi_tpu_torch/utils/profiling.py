"""Tracing hook (counterpart of dmi_tpu/utils/profiling.py:trace), the
program's own spans, and device timing.

`trace(profile_dir)` wraps a training region in torch.profiler, CPU and CUDA
activity, and writes a Chrome/Perfetto trace into profile_dir when the
region ends; with no directory it does nothing.

`span(name)` is the program's range around one piece of work (serving's
call, prefill, a decode step and its layers' attention, MLP and head; a
training micro-step and its phases): a torch.profiler.record_function
range while a profiler records, else one shared no-op context, so the
untraced path pays one check of the profiler's state.  The ranges are
`user_annotation` events of the same profiler session as the device's
kernels, so they share the trace's clock, and their nesting on a thread is
their parentage.  Every span's name is listed in PERF.md.

`region(name)` is a span around a differentiable region that also makes
the region's backward one range, `<name>.bwd`, which autograd's engine
runs on its own thread where no Python function of the program is on the
stack: `r.enter(x)` passes the region's input through an identity node
whose backward closes the range, `r.leave(y)` its output through one whose
backward opens it, so every backward node of the region runs inside.  Both
are applied only while grad is enabled and a profiler records at forward
time; the open checks again at backward time, and the close tolerates a
range that was never opened.  Untraced, the autograd graph is the same as
without the region (no extra nodes), and so are the gradients traced (the
nodes are identities).  Tensor hooks would not do: a hook runs inside the
engine's event for the node it precedes, so the range would cut across the
events of the region's first node and of the node after it, and a hook on
a leaf (the projector's parameters) stays registered after the step.

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


_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler records, else a shared
    no-op context (record_function costs its call even with no profiler)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


class _RangeOpen(torch.autograd.Function):
    """Identity at a region's output; its backward opens the range."""

    @staticmethod
    def forward(ctx, y, region):
        ctx.region = region
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        ctx.region.open_backward()
        return grad, None


class _RangeClose(torch.autograd.Function):
    """Identity at a region's input; its backward closes the range."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.region.close_backward()
        return grad, None


class _Region:
    """region(name) while a profiler records: the forward span and, with
    grad enabled, the backward range `<name>.bwd`, opened by the output's
    node and closed by the last of the inputs' nodes to run."""

    __slots__ = ("_span", "_bwd", "_grad", "_inputs", "_left", "_handle")

    def __init__(self, name: str):
        self._span = torch.profiler.record_function(name)
        self._bwd, self._grad = name + ".bwd", torch.is_grad_enabled()
        self._inputs = self._left = 0
        self._handle = None

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        return False

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if not self._grad or not x.requires_grad:
            return x
        self._inputs += 1
        return _RangeClose.apply(x, self)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        if not self._inputs or not y.requires_grad:
            return y
        return _RangeOpen.apply(y, self)

    def open_backward(self) -> None:
        if self._handle is None and torch.autograd._profiler_enabled():
            self._handle = torch.ops.profiler._record_function_enter_new(self._bwd, None)
            self._left = self._inputs

    def close_backward(self) -> None:
        self._left -= 1
        if self._left <= 0 and self._handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(self._handle)
            self._handle = None


class _NoRegion:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def enter(self, x):
        return x

    def leave(self, y):
        return y


_NO_REGION = _NoRegion()


def region(name: str):
    """span(name) around a differentiable region, whose backward is the
    range `<name>.bwd` (module docstring):

        with region("llama.moe") as r:
            h = r.enter(h)
            ...
            return r.leave(out)

    With no profiler recording it is one shared no-op whose enter and
    leave return their argument."""
    if not torch.autograd._profiler_enabled():
        return _NO_REGION
    return _Region(name)


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
