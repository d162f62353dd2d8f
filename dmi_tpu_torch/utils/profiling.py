"""Tracing hook (counterpart of dmi_tpu/utils/profiling.py:trace).

`trace(profile_dir)` wraps a training region in torch.profiler, CPU and CUDA
activity, and writes a Chrome/Perfetto trace into profile_dir when the
region ends; with no directory it does nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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
