"""Stage-1 training traffic: `ProjectorTrainer.train_step` micro-steps back
to back through the frozen LLM, each on a new batch of distinct rows.

A row is a prompt of token ids shared by every row (from the seed), caption
tokens and an end token, right-padded to `text` tokens, in the collator's
schema (labels -100 over the prompt and the pad id on the pads), with an
encoder embedding [mm] (SyntheticCaptions of the card smoke, drawn from the
run's seed).  The loop keeps one micro-step in flight: after issuing step
s it reads step s - 1's loss on the host.

`correct`: set-up builds one trainer and drives it through the first
`check_steps` micro-steps with the window's own call and feed; the window
goes on with the same object.  Once the window has closed and the trainer
is freed, the plain f32 reference (portbench/reference) follows those steps
from the same inputs: each step's loss, the first gradient as AdamW got it
(its first moment after one step over 1 - beta1), and the projector's
change after the steps, each leaf's norm against the reference's.
"""

from __future__ import annotations

import sys
import tempfile
import time
import types

import numpy as np

from portbench import harness as hx


class Captions:
    """Batches of `batch` rows, a pure function of (seed, step)."""

    def __init__(self, w: dict, seed: int):
        c, t = w["config_json"], w["traffic_json"]
        self.seed, self.B, self.T, self.mm, self.V = seed, t["batch"], t["text"], t["mm_dim"], \
            c["vocab_size"]
        self.prompt = np.random.default_rng([seed, 1]).integers(0, self.V, 15)
        self.pad = c.get("pad_token_id", c.get("eos_token_id"))
        self.end = c["eos_token_id"]

    def total_train_steps(self):
        return 1 << 40

    def train_batch(self, step):
        rng = np.random.default_rng([self.seed, 5, step])
        B, T, P = self.B, self.T, len(self.prompt)
        lens = rng.integers(P + min(8, T - P - 1), T + 1, size=B)
        lens[0] = T
        ids = np.full((B, T), self.pad, np.int64)
        mask = np.zeros((B, T), np.int32)
        labels = np.full((B, T), self.pad, np.int64)
        for b, n in enumerate(lens):
            row = np.concatenate([self.prompt, rng.integers(0, self.V, n - P - 1), [self.end]])
            ids[b, :n] = row
            mask[b, :n] = 1
            labels[b, :n] = row
            labels[b, :P] = -100
        embs = rng.standard_normal((B, self.mm), dtype=np.float32)
        return {"input_ids": ids, "attention_mask": mask, "labels": labels, "embs": embs}


def leaves(tree) -> list:
    return [layer[k] for layer in tree["layers"] for k in ("w", "b")]


def build(w: dict, seed: int, device):
    """(config, weights, initial projector, data, trainer)."""
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer

    t = w["traffic_json"]
    cfg = hx.port_config(w["config_json"])
    params = hx.draw_weights(cfg, seed, device)
    spec = proj.ProjectorSpec(mm_dim=t["mm_dim"], lm_dim=cfg.hidden_size, dropout=t["dropout"])
    pp0 = hx.draw_projector(spec.layer_dims(), seed, device)
    args = types.SimpleNamespace(**t["optimizer"], warmup_steps=0, seed=seed, mesh_shape=None,
                                 finetune_from_checkpoint=None,
                                 checkpoint_dir=tempfile.gettempdir())
    data = Captions(w, seed)
    trainer = ProjectorTrainer("portbench", cfg, params, spec, pp0, [data],
                               [EmbeddingManager("portbench", device=device)], None, args)
    return cfg, params, pp0, data, trainer


def check_steps(w: dict, trainer, data) -> dict:
    """The first micro-steps, through the window's call: their losses, the
    first gradient as the optimizer got it and the projector after them."""
    import torch

    t = w["traffic_json"]
    beta1 = t["optimizer"]["adam_beta1"]
    losses, grad0 = [], None
    for step in range(t["check_steps"]):
        loss, _ = trainer.train_step(step, data.total_train_steps(), (0, data.train_batch(step)))
        losses.append(float(loss))
        if step == 0:
            # a leaf the optimizer has no state for took no step: no gradient
            grad0 = [trainer.opt.state[p]["exp_avg"].detach().clone() / (1 - beta1)
                     if trainer.opt.state.get(p) else torch.zeros_like(p.detach())
                     for p in leaves(trainer.params)]
    return {"losses": losses, "grad0": grad0,
            "after": [p.detach().clone() for p in leaves(trainer.params)]}


def reference_steps(w: dict, seed: int, params: dict, pp0: dict, data, device,
                    weight_fn=None) -> dict:
    """The same micro-steps in the plain f32 reference."""
    import torch

    from portbench.reference.decoder import Decoder
    from portbench.reference.projector import AdamW, dropout_keep, soft_token

    t, o = w["traffic_json"], w["traffic_json"]["optimizer"]
    ref = Decoder(w["config_json"], params, weight_fn)
    p = [x.detach().clone().float() for x in leaves(pp0)]
    opt = AdamW(p, o["learning_rate"], o["adam_beta1"], o["adam_beta2"], o["adam_epsilon"],
                o["weight_decay"], o["max_grad_norm"])
    losses, grad0 = [], None
    for step in range(t["check_steps"]):
        b = data.train_batch(step)
        ids = torch.as_tensor(b["input_ids"], device=device)
        labels = torch.as_tensor(b["labels"], device=device)
        labels = torch.cat([torch.full_like(labels[:, :1], -100), labels], dim=1)
        tree = {"layers": [{"w": p[2 * i], "b": p[2 * i + 1]} for i in range(len(p) // 2)]}
        var = [x.requires_grad_() for x in p]
        keep = dropout_keep(seed, step, (data.B, p[0].shape[1]), t["dropout"])
        soft = soft_token(tree, torch.as_tensor(b["embs"], device=device), keep, t["dropout"])
        x = torch.cat([soft[:, None].detach(), ref.embed(ids)], dim=1)
        loss, g = ref.loss_grad(x, labels)
        grads = torch.autograd.grad(soft, var, g[:, 0])
        for x_ in var:
            x_.requires_grad_(False)
        with torch.no_grad():
            clipped = opt.step(list(grads))
        losses.append(float(loss))
        if step == 0:
            grad0 = clipped
    return {"losses": losses, "grad0": grad0, "after": p}


def gaps(prog: dict, ref: dict, p0: list) -> dict:
    """Each reading's worst case: the relative loss gap over the steps, and
    over the leaves the gap between the system's norm and the reference's,
    against the larger of that leaf's and the median leaf's reference norm.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by rounding alone and are left out of the change."""
    import torch

    def worst(a, b, keep=None):
        nb = [float(torch.linalg.vector_norm(x.float())) for x in b]
        na = [float(torch.linalg.vector_norm(x.float())) for x in a]
        med = float(np.median(nb))
        idx = [i for i in range(len(nb)) if keep is None or keep[i]]
        return max(abs(na[i] - nb[i]) / max(nb[i], med) for i in idx)

    gn = [float(torch.linalg.vector_norm(g)) for g in ref["grad0"]]
    moved = [g >= 1e-3 * float(np.median(gn)) for g in gn]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": worst(prog["grad0"], ref["grad0"]),
        "change_gap": worst([a.float() - x.float() for a, x in zip(prog["after"], p0)],
                            [a - x.float() for a, x in zip(ref["after"], p0)], moved),
    }


def run(w: dict, seed: int, seconds: float, trace: bool, device, t_start: float, chips: int):
    import torch

    t = w["traffic_json"]
    cuda = torch.device(device).type == "cuda"
    t_built = time.perf_counter()
    cfg, params, pp0, data, trainer = build(w, seed, device)
    total = data.total_train_steps()
    t_warm = time.perf_counter()
    prog = check_steps(w, trainer, data)  # also the warm-up: the window's shapes
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"set-up: imports {t_built - t_start:.3f} s, weights and trainer "
          f"{t_warm - t_built:.3f} s, the check's micro-steps {setup_s - (t_warm - t_start):.3f} s",
          file=sys.stderr)

    def steps(first: int, n=None, until=None):
        """Micro-steps from `first`, one in flight; -> their losses on the host."""
        out, pending, step = [], None, first
        while (n is not None and step < first + n) or \
                (until is not None and time.perf_counter() < until):
            loss, _ = trainer.train_step(step, total, (0, data.train_batch(step)))
            if pending is not None:
                out.append(float(pending))
            pending, step = loss, step + 1
        out.append(float(pending))
        return out

    first = t["check_steps"]
    t0 = time.perf_counter()
    losses = steps(first, until=t0 + seconds)
    window = time.perf_counter() - t0
    if not trace:
        metrics = {"train_samples_per_s": {"value": len(losses) * data.B / window,
                                           "unit": "samples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        breakdown = None
    else:
        k, n = t["trace_steps"], len(losses)

        def traced_steps():
            losses.extend(steps(first + n, n=k))
            return {"samples": k * data.B, "units": k}

        events, calls, traced_s, work = hx.traced(traced_steps, hx.span_specs(w["per_layer"]),
                                                  device)
        tr = hx.Trace(events, calls, traced_s, work,
                      {"config": w["config_json"], "traffic": t, "timed_s": window,
                       "timed_units": n})
        del events
        metrics = hx.per_layer_metrics(w, tr)
        breakdown = tr.breakdown()
    all_losses = prog["losses"] + losses
    attempted = len(all_losses) * data.B
    failed = sum(not np.isfinite(x) for x in all_losses) * data.B
    info = hx.device_info(device, chips)
    if trace:
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    del trainer
    hx.free(device)
    ref = reference_steps(w, seed, params, pp0, data, device)
    correct, checks = hx.judge(gaps(prog, ref, leaves(pp0)), w["limits"])
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks
