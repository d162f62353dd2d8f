"""The port's own spans (utils.profiling.span and region) on the CPU, at tiny
OLMoE and DeepSeek-V2 widths: one caption call (batch engine, budget 22)
and one stage-1 micro-step.

(a) with no profiler recording, no range is ever entered and the stage-1
loss's graph holds no boundary node; (b) under a CPU torch.profiler each
span opens the expected number of times, nested as PERF.md's table says,
and each `.bwd` range holds its region's backward nodes; (c) ids, loss and
projector gradients are bit-equal with the profiler on and off; (d) the
benchmark's own wrappers (portbench.harness.Spans) still fire on every
target the tiny path runs; (e) the two readers of the new spans
(moe.roofline.train, decode.idle_ms_per_step) on hand-built traces."""

import dataclasses
import json
import os
import tempfile
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.serve import Captioner
from dmi_tpu_torch.training.embeddings import EmbeddingManager
from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer
from dmi_tpu_torch.utils import profiling
from portbench import harness as hx

torch.set_num_threads(1)

BUDGET, ROWS, MM, PREFIX = 22, 3, 16, [7, 8, 9]
FAMILIES = ("olmoe", "deepseek")


def _cfg(family: str):
    if family == "olmoe":  # untied, as OLMoE-1B-7B: the head's rows are copied a call
        return dataclasses.replace(
            llama.tiny_olmoe_config(n_experts=4, top_k=2, dtype=torch.bfloat16, eos=()),
            tie_word_embeddings=False)
    return llama.tiny_deepseek_config(n_experts=4, n_shared=1, dtype=torch.bfloat16, eos=())


def _model(family: str):
    cfg = _cfg(family)
    params = hx.draw_weights(cfg, 11, "cpu")
    spec = proj.ProjectorSpec(mm_dim=MM, lm_dim=cfg.hidden_size, n_layers=2)
    return cfg, params, spec, hx.draw_projector(spec.layer_dims(), 11, "cpu")


def _captioner(family: str):
    cfg, params, spec, pp = _model(family)
    return Captioner(cfg, params, spec, pp, max_new_tokens=BUDGET, batch_size=ROWS,
                     prefix_ids=PREFIX, pad_token_id=0)


def _embs():
    return np.random.default_rng(3).standard_normal((ROWS, MM), dtype=np.float32)


class _Rows:
    """A loader of fixed-length caption rows, a pure function of the step."""

    def __init__(self, V: int, B: int = 2, T: int = 6):
        self.V, self.B, self.T = V, B, T

    def total_train_steps(self):
        return 8

    def train_batch(self, step):
        rng = np.random.default_rng([5, step])
        ids = rng.integers(0, self.V, (self.B, self.T))
        labels = ids.copy()
        labels[:, :2] = -100
        return {"input_ids": ids, "attention_mask": np.ones((self.B, self.T), np.int32),
                "labels": labels, "embs": rng.standard_normal((self.B, MM), dtype=np.float32)}


def _trainer(family: str):
    cfg, params, spec, pp = _model(family)
    spec = dataclasses.replace(spec, dropout=0.1)
    args = types.SimpleNamespace(
        learning_rate=1e-3, adam_beta1=0.9, adam_beta2=0.95, adam_epsilon=1e-8,
        weight_decay=0.0, max_grad_norm=1.0, scheduler=None, gradient_accumulation_steps=1,
        warmup_steps=0, seed=3, mesh_shape=None, finetune_from_checkpoint=None,
        checkpoint_dir=tempfile.gettempdir())
    data = _Rows(cfg.vocab_size)
    trainer = ProjectorTrainer("spans", cfg, params, spec, pp, [data],
                               [EmbeddingManager("spans")], None, args)
    return trainer, data


def _profiled(fn):
    """fn() under a CPU torch.profiler -> (its result, the trace's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, events


def _ranges(events, ours=True) -> dict:
    """The trace's ranges by name; with `ours`, the program's spans alone
    (torch's optimizer opens its own)."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and (
                not ours or e["name"].split(".")[0] in ("serve", "decode", "llama", "train")):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return out


def _inside(inner, outer) -> bool:
    return all(any(a <= s and t <= b for a, b in outer) for s, t in inner)


def _step(trainer, data, step=0):
    return trainer.train_step(step, data.total_train_steps(), (0, data.train_batch(step)))


def _grads(trainer, data, step=0):
    """One micro-step's loss and projector gradients, before any update."""
    loss = trainer.micro_loss(step, (0, data.train_batch(step)))
    loss.backward()
    grads = [p.grad.clone() for p in trainer.leaves]
    for p in trainer.leaves:
        p.grad = None
    return loss.detach(), grads


def _node_names(root) -> set:
    seen, stack, names = set(), [root], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


BOUNDARY = {"_RangeOpenBackward", "_RangeCloseBackward"}


# ---------------------------------------------------------------------------
# (a) untraced: no range, no boundary node
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_untraced_enters_no_range_and_adds_no_node(family, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was entered with no profiler recording")

    cap = _captioner(family)
    trainer, data = _trainer(family)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    # torch's own AdamW.step enters a range through the same op, so the op
    # refuses while the program's code runs, the optimizer aside
    _step(trainer, data, 1)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    assert cap.caption_ids(_embs()).shape == (ROWS, BUDGET)
    loss = trainer.micro_loss(0, (0, data.train_batch(0)))
    assert not _node_names(loss.grad_fn) & BOUNDARY
    loss.backward()
    assert profiling.span("x") is profiling.span("y")
    assert profiling.region("x") is profiling.region("y")


# ---------------------------------------------------------------------------
# (b) traced: counts, nesting, backward ranges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_caption_call_spans(family):
    cap = _captioner(family)
    L, steps = cap.llm_cfg.num_hidden_layers, BUDGET - 1
    _, events = _profiled(lambda: cap.caption_ids(_embs()))
    r = _ranges(events)
    want = {"serve.call": 1, "serve.dispatch": 1, "serve.readback": 1, "decode.prefill": 1,
            "decode.step": steps, "decode.attn": L * steps, "decode.moe": L * steps,
            "decode.head": 2 * steps, "llama.attn": L, "llama.moe": L}
    if family == "olmoe":
        want["decode.head_rows"] = 1
    assert {k: len(v) for k, v in r.items()} == want
    assert _inside(r["serve.dispatch"] + r["serve.readback"], r["serve.call"])
    assert _inside(r["decode.prefill"] + r["decode.step"], r["serve.dispatch"])
    assert not _inside(r["serve.readback"], r["serve.dispatch"])
    assert _inside(r["llama.attn"] + r["llama.moe"], r["decode.prefill"])
    assert _inside(r["decode.attn"] + r["decode.moe"] + r["decode.head"], r["decode.step"])
    if family == "olmoe":
        assert _inside(r["decode.head_rows"], r["serve.dispatch"])
        assert not _inside(r["decode.head_rows"], r["decode.step"])


@pytest.mark.parametrize("family", FAMILIES)
def test_micro_step_spans_and_backward_ranges(family):
    trainer, data = _trainer(family)
    L = trainer.llm_cfg.num_hidden_layers
    _, events = _profiled(lambda: _step(trainer, data))
    r = _ranges(events)
    want = {"train.step": 1, "train.batch": 1, "train.projector": 1, "train.forward": 1,
            "train.backward": 1, "train.optimizer": 1, "llama.head": 1, "train.loss": 1,
            "llama.attn": L, "llama.moe": L}
    want.update({f"{k}.bwd": n for k, n in want.items()
                 if k.startswith("llama.") or k in ("train.loss", "train.projector")})
    assert {k: len(v) for k, v in r.items()} == want
    phases = ["train.batch", "train.projector", "train.forward", "train.backward",
              "train.optimizer"]
    assert _inside(sum((r[k] for k in phases), []), r["train.step"])
    assert _inside(_ranges(events, ours=False)["Optimizer.step#AdamW.step"],
                   r["train.optimizer"])
    fwd = ["llama.attn", "llama.moe", "llama.head", "train.loss"]
    assert _inside(sum((r[k] for k in fwd), []), r["train.forward"])
    assert _inside(sum((r[k + ".bwd"] for k in fwd + ["train.projector"]), []),
                   r["train.backward"])
    # each backward range holds its region's backward nodes: an op that only
    # some regions have (attention's and the router's softmax, the experts'
    # silu, the loss's log-softmax, the projector's gelu) runs inside their
    # ranges and nowhere else, and inside every range of each
    nodes = [(e["name"].rsplit(": ", 1)[-1], e["ts"], e["ts"] + e["dur"]) for e in events
             if "autograd::engine::evaluate_function" in e.get("name", "")]
    only = {"SoftmaxBackward0": ["llama.attn.bwd", "llama.moe.bwd"],
            "SiluBackward0": ["llama.moe.bwd"], "LogSoftmaxBackward0": ["train.loss.bwd"],
            "GeluBackward0": ["train.projector.bwd"]}
    for op, regions in only.items():
        spans = [(a, b) for name, a, b in nodes if name == op]
        assert spans and _inside(spans, sum((r[k] for k in regions), [])), op
        for a, b in sum((r[k] for k in regions), []):
            assert any(a <= s and t <= b for s, t in spans), op
    for rng in want:
        if rng.endswith(".bwd"):
            assert all(any(a <= s <= b for _, s, _ in nodes) for a, b in r[rng]), rng


# ---------------------------------------------------------------------------
# (c) bit-equal with the profiler on and off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_traced_outputs_are_bit_equal(family):
    cap = _captioner(family)
    off = cap.caption_ids(_embs())
    on, _ = _profiled(lambda: cap.caption_ids(_embs()))
    assert torch.equal(on, off)
    trainer, data = _trainer(family)
    loss_off, g_off = _grads(trainer, data)
    (loss_on, g_on), events = _profiled(lambda: _grads(trainer, data))
    assert "llama.moe.bwd" in _ranges(events)
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


# ---------------------------------------------------------------------------
# (d) the benchmark's wrappers still fire
# ---------------------------------------------------------------------------

def test_benchmark_wrappers_still_fire():
    bench = hx.load_json(hx.ROOT / "BENCHMARK.json")
    specs = hx.span_specs(bench["per_layer"])
    seen, calls = set(), {}
    for family in FAMILIES:
        cap = _captioner(family)
        trainer, data = _trainer(family)
        with hx.Spans(specs) as spans:
            _, events = _profiled(lambda: (cap.caption_ids(_embs()), _step(trainer, data)))
        seen |= set(_ranges(events, ours=False))
        for name, got in spans.calls.items():
            calls.setdefault(name, []).extend(got)
    # a dense model's decode step runs the decode MLP, which neither MoE family has
    cfg = llama.tiny_config(dtype=torch.bfloat16, eos=())
    params = hx.draw_weights(cfg, 11, "cpu")
    spec = proj.ProjectorSpec(mm_dim=MM, lm_dim=cfg.hidden_size, n_layers=2)
    dense = Captioner(cfg, params, spec, hx.draw_projector(spec.layer_dims(), 11, "cpu"),
                      max_new_tokens=BUDGET, batch_size=ROWS, prefix_ids=PREFIX, pad_token_id=0)
    with hx.Spans(specs) as spans:
        _, events = _profiled(lambda: dense.caption_ids(_embs()))
    seen |= set(_ranges(events, ours=False))
    for name, got in spans.calls.items():
        calls.setdefault(name, []).extend(got)
    # the CPU path runs every target but the flash kernels (their plain twin runs)
    ran = {"moe", "decode_attn", "mla_attn", "head_argmax", "prefill", "decode_step",
           "forward", "moe_ep", "mla_qlora", "decode_mlp"}
    assert ran <= seen and set(specs) - ran == {"flash.fwd", "flash.bwd"}
    for name, targets in specs.items():
        if name in ran and any(fn is not None for _, _, fn in targets):
            assert calls[name], name
    # the routed MLP's two targets: the decode step's B lanes, prefill's B x T
    assert {x["n"] for x in calls["moe"]} >= {ROWS, ROWS * (1 + len(PREFIX))}
    assert {"decode.moe", "llama.moe", "llama.moe.bwd", "decode.step"} <= seen


# ---------------------------------------------------------------------------
# (e) the readers of the new spans
# ---------------------------------------------------------------------------

def _trace(ops, ranges, work, ctx):
    """A Trace from (device start, end, launch) triples in µs and named
    host ranges."""
    events = []
    for i, (s, e, launch) in enumerate(ops):
        events.append({"cat": "kernel", "name": f"k{i}", "ts": s, "dur": e - s,
                       "args": {"correlation": i}})
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                       "dur": 1, "args": {"correlation": i}})
    for name, spans in ranges.items():
        events += [{"cat": "user_annotation", "name": name, "ts": a, "dur": b - a}
                   for a, b in spans]
    return hx.Trace(events, {}, 1.0, work, ctx)


OLMOE = hx.load_json(hx.PKG / "configs" / "olmoe-1b-7b.json")


def test_moe_roofline_train_reader():
    read = hx.reader("moe.roofline.train").read
    traffic = hx.load_json(hx.PKG / "traffic" / "stage1-b32.json")
    # two micro-steps: 5 ms of forward and 11 ms of backward a step inside the
    # ranges, 40 ms outside them
    ops = [(0, 5000, 10), (6000, 17000, 20), (20000, 60000, 30),
           (100000, 105000, 110), (106000, 117000, 120)]
    ranges = {"llama.moe": [(5, 15), (105, 115)], "llama.moe.bwd": [(18, 25), (118, 125)],
              "train.step": [(0, 200)]}
    t = _trace(ops, ranges, {"samples": 64, "units": 2}, {"config": OLMOE, "traffic": traffic})
    # one call over 32 x 65 tokens reads 2 x (64 experts' 3 x 2048 x 1024 weights,
    # the router, tokens in and out) bytes: bytes-bound on the card
    call = 2 * (3 * 2048 * 1024 * 64 + 2048 * 64 + 2 * 2080 * 2048) / 3.35e12
    assert read(t) == pytest.approx(100 * 2 * 16 * 2 * call / 0.032, rel=1e-12)
    assert 2 * 16 * call == pytest.approx(7.8577e-3, rel=1e-4)  # a micro-step's bound
    del ranges["llama.moe"], ranges["llama.moe.bwd"]  # the parent: no such ranges
    assert read(_trace(ops, ranges, {"units": 2}, {"config": OLMOE, "traffic": traffic})) is None


def test_decode_idle_ms_per_step_reader():
    read = hx.reader("decode.idle_ms_per_step").read
    traffic = hx.load_json(hx.PKG / "traffic" / "caption-b512.json")
    # one traced call, busy 8 ms; idle gaps of 1, 3 (closed by an op launched
    # inside decode.step) and 4 ms (launched outside it)
    ops = [(0, 2000, 1), (3000, 5000, 50), (8000, 10000, 60), (14000, 16000, 500)]
    ranges = {"decode.step": [(40, 100)], "serve.call": [(0, 1000)]}
    ctx = {"config": OLMOE, "traffic": traffic, "timed_s": 0.21, "timed_units": 10}
    t = _trace(ops, ranges, {"captions": 512, "units": 1}, ctx)
    assert t.busy_s == pytest.approx(0.008)
    # 21 ms a call untraced - 8 ms busy = 13 ms idle a call; 4 of its 8 ms of
    # gaps ended inside decode.step; 21 decode steps a call
    assert read(t) == pytest.approx(13.0 * 4 / 8 / 21, rel=1e-12)
    assert read(_trace(ops, {"serve.call": [(0, 1000)]}, {"units": 1}, ctx)) is None
