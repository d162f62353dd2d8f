"""What every cell of the benchmark shares: finding a cell's files by the
names in BENCHMARK.json, the checks that come before and after a run, the
weights drawn from the seed, the trace of a window (torch.profiler) and its
reduction to device time, and the result line.

A cell (BENCHMARK.json `workloads`) names a configuration, whose file is
portbench/configs/<config>.json (the published config.json keys, plus
`source`, `reduced`, `assumed`), and a traffic mix, whose file is
portbench/traffic/<traffic>.json; the mix's `kind` names the driver
portbench/traffic/<kind>.py that runs it.  portbench/workloads/<cell>.json
holds the limits of the comparison that decides `correct`.  A per-layer
metric's reader is portbench/metrics/<metric>.py.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
from bisect import bisect_right
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "dmi_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic mix
    and limits read from their files, and the per-layer metrics it reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    w["config_json"] = load_json(PKG / "configs" / f"{w['config']}.json")
    w["traffic_json"] = load_json(PKG / "traffic" / f"{w['traffic']}.json")
    w["limits"] = load_json(PKG / "workloads" / f"{name}.json")["limits"]
    w["per_layer"] = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return w


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module(PKG / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")


def reader(metric: str):
    return load_module(PKG / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is jax, jaxlib, flax or the
    JAX package (dmi_tpu_torch begins with dmi_tpu and is not it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of run `seed`."""
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(2, np.uint32)
               .astype(np.uint64) @ np.array([1 << 31, 1], np.uint64)) & ((1 << 63) - 1)


# ---------------------------------------------------------------------------
# Model and weights
# ---------------------------------------------------------------------------

def port_config(config_json: dict, dtype=None):
    """The system's config for a published config.json, through its own
    loader, with EOS off so that every request decodes the whole budget."""
    import dataclasses

    import torch
    from dmi_tpu_torch.training.model_utils import _hf_to_config

    hf = {k: v for k, v in config_json.items()
          if k not in ("source", "reduced", "assumed", "deployment", "published")}
    cfg = _hf_to_config(hf, dtype or torch.bfloat16, None)
    return dataclasses.replace(cfg, eos_token_ids=())


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def draw_weights(cfg, seed: int, device, chunk: int = 1 << 28) -> dict:
    """The decoder's weights in the system's tree layout, drawn on `device`
    from `seed` in a few large calls into two flat buffers of the model's
    dtype: normal(0, 0.02) for every matrix and the embedding, 1 +
    normal(0, 0.1) for every RMSNorm scale.  The layout (names, shapes)
    comes from the system's own init run on the meta device."""
    import torch
    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.utils.rng import CounterRNG

    meta = llama.init(cfg, CounterRNG(0, device="meta"), "meta")
    leaves = list(flat_leaves(meta))
    norm = [(p, t) for p, t in leaves if p.rsplit(".", 1)[-1].endswith("norm")]
    mats = [(p, t) for p, t in leaves if not p.rsplit(".", 1)[-1].endswith("norm")]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    out = {}
    for group, mean, std in ((mats, 0.0, 0.02), (norm, 1.0, 0.1)):
        n = sum(t.numel() for _, t in group)
        buf = torch.empty(n, dtype=cfg.dtype, device=device)
        for s in range(0, n, chunk):
            buf[s:s + chunk].normal_(mean, std, generator=gen)
        off = 0
        for p, t in group:
            out[p] = buf[off:off + t.numel()].view(t.shape)
            off += t.numel()

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        return out[prefix[:-1]]

    return rebuild(meta)


def draw_projector(spec_dims, seed: int, device) -> dict:
    """torch nn.Linear's default init, U(-1/sqrt(in), 1/sqrt(in)), f32,
    (in, out) weights, from the seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    layers = []
    for d_in, d_out in spec_dims:
        bound = 1.0 / math.sqrt(d_in)
        w = torch.empty(d_in, d_out, device=device).uniform_(-bound, bound, generator=gen)
        b = torch.empty(d_out, device=device).uniform_(-bound, bound, generator=gen)
        layers.append({"w": w, "b": b})
    return {"layers": layers}


def free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


# ---------------------------------------------------------------------------
# Spans and the trace
# ---------------------------------------------------------------------------

class Spans:
    """Ranges the benchmark wraps around calls into the system while a
    traced window runs: each (module, function) of a metric reader's SPANS
    is replaced, wherever the system's modules hold it, by a wrapper that
    opens a torch.profiler range named after the span and records what the
    reader's shape function takes from the call's arguments."""

    def __init__(self, specs: dict):
        self.specs = specs  # span -> [(module, attr, shape_fn or None)]
        self.calls = {name: [] for name in specs}
        self._undo = []

    def __enter__(self):
        import torch

        for name, targets in self.specs.items():
            for mod_name, attr, shape_fn in targets:
                mod = importlib.import_module(mod_name)
                real = getattr(mod, attr)

                def wrapper(*args, _real=real, _name=name, _fn=shape_fn, **kw):
                    if _fn is not None:
                        self.calls[_name].append(_fn(*args, **kw))
                    with torch.profiler.record_function(_name):
                        return _real(*args, **kw)

                for m in list(sys.modules.values()):
                    if getattr(m, "__name__", "").startswith("dmi_tpu_torch") and \
                            getattr(m, attr, None) is real:
                        setattr(m, attr, wrapper)
                        self._undo.append((m, attr, real))
        return self

    def __exit__(self, *exc):
        for m, attr, real in reversed(self._undo):
            setattr(m, attr, real)
        self._undo.clear()


class Trace:
    """One traced window reduced to what the readers read: every device
    operation (kernel, memcpy, memset) with its launch time on the host,
    the benchmark's ranges, the calls' shapes and the work done."""

    def __init__(self, events: list, calls: dict, window_s: float, work: dict, ctx: dict):
        dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in
                  e.get("args", {})}
        self.ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"],
                           launch.get(e.get("args", {}).get("correlation"))) for e in dev)
        spans = {}
        for e in events:
            if e.get("cat") == "user_annotation":
                spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        self.ranges = {}  # name -> disjoint sorted intervals (nested ranges merged)
        for name, r in spans.items():
            merged = []
            for a, b in sorted(r):
                if merged and a <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], b))
                else:
                    merged.append((a, b))
            self.ranges[name] = merged
        self.calls, self.window_s, self.work, self.ctx = calls, window_s, work, ctx
        busy, end = 0.0, float("-inf")
        for s, e, _, _ in self.ops:
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        self.busy_s = busy / 1e6

    def _inside(self, name: str, t) -> bool:
        r = self.ranges.get(name, [])
        i = bisect_right(r, (t, float("inf"))) - 1
        return i >= 0 and r[i][0] <= t <= r[i][1]

    def span_seconds(self, *names: str) -> float:
        """Device seconds of the operations launched inside any range of
        these names."""
        return sum(e - s for s, e, _, t in self.ops
                   if t is not None and any(self._inside(n, t) for n in names)) / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle gaps
        between device operations summed by the innermost benchmark range
        the host was in when it launched the operation that ended the gap."""
        by_name = {}
        for s, e, name, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        gaps, end = {}, None
        names = sorted(self.ranges, key=lambda n: -sum(b - a for a, b in self.ranges[n]))
        for s, e, _, t in self.ops:
            if end is not None and s > end:
                label = "host"
                if t is not None:
                    inner = [n for n in names if self._inside(n, t)]
                    label = inner[-1] if inner else "host"
                gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}


def traced(run_calls, specs: dict, device) -> tuple:
    """Run run_calls() (returns the work it did) under torch.profiler with
    the spans installed; returns (events, calls, window seconds, work)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(device).type == "cuda" else [])
    with Spans(specs) as spans, profile(activities=acts) as prof:
        t0 = time.perf_counter()
        work = run_calls()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, spans.calls, window, work


def span_specs(metrics: list) -> dict:
    specs = {}
    for m in metrics:
        for name, targets in getattr(reader(m["name"]), "SPANS", {}).items():
            specs.setdefault(name, [])
            for t in targets:
                if t not in specs[name]:
                    specs[name].append(t)
    return specs


def per_layer_metrics(w: dict, trace: Trace) -> dict:
    out = {}
    for m in w["per_layer"]:
        v = reader(m["name"]).read(trace)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

def report(result: dict, checks: dict) -> None:
    """The checks' numbers beside their limits as the last lines on standard
    error, and the result as the last line on standard output, the checks
    under the key that comes last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}))
    sys.stdout.flush()


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number the limits name at or under its limit."""
    checks = {k: {"value": numbers[k], "limit": lim["limit"]} for k, lim in limits.items()}
    ok = all(isinstance(c["value"], float) and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
