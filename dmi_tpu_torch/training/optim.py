"""Optimizer and step-indexed LR schedules (counterpart of
dmi_tpu/training/optim.py, exact reference semantics).

The reference drives torch LambdaLR with explicit step indices,
``scheduler.step(step_idx)`` AFTER ``optimizer.step()``
(dmi/train_projector.py:72-73), so the LR used by the update at micro-step s
is lambda(s_prev), s_prev being the previous update's step index (lambda(0)
for the first update).  The trainer carries that index as `sched_step` and
installs lr = base * lambda(sched_step) with `set_lr` before each update.

The update is global-norm clipping (torch.nn.utils.clip_grad_norm_, as the
reference, dmi/train_projector.py:71) then torch.optim.AdamW (decoupled
weight decay scaled by lr), which dmi_tpu reproduces with optax.

`adamw_state` and `load_adamw_state` move the AdamW moments in and out of a
checkpoint's optimizer_state_dict.  The port writes its own format
(checkpoint.ADAMW_FORMAT); it also reads dmi_tpu's optax state, taking
(count, mu, nu) from its ScaleByAdamState: the other direction of
dmi_tpu.training.optim.set_adamw_moments.  `set_adamw_moments` installs the
AdamW moments of a reference torch checkpoint, as converted by
models.torch_import.optax_moments_from_checkpoint.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

from dmi_tpu_torch.training.checkpoint import ADAMW_FORMAT, ForeignObject
from dmi_tpu_torch.utils.grad_stats import named_leaves, tree_map


def cosine_warmup_lambda(num_warmup_steps: int, num_training_steps: int,
                         num_cycles: float = 0.5) -> Callable[[int], float]:
    """reference: dmi/utils/scheduler.py:10-33 (torchtune-derived)."""

    def lr_lambda(step: int) -> float:
        if step < num_warmup_steps:
            return step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return lr_lambda


def constant_warmup_lambda(num_warmup_steps: int) -> Callable[[int], float]:
    """reference: dmi/utils/scheduler.py:36-49."""

    def lr_lambda(step: int) -> float:
        return step / max(1, num_warmup_steps) if step < num_warmup_steps else 1.0

    return lr_lambda


def make_lr_fn(train_args, total_steps: int) -> Callable[[int], float]:
    """Scheduler selection (dmi/train_projector.py:263-277)."""
    base = train_args.learning_rate
    if train_args.scheduler == "linear_warmup":
        lam = constant_warmup_lambda(train_args.warmup_steps)
    elif train_args.scheduler == "cosine_warmup":
        lam = cosine_warmup_lambda(train_args.warmup_steps, total_steps)
    elif train_args.scheduler is None:
        return lambda step: base
    else:
        raise ValueError("Scheduler should be either linear_warmup or cosine_warmup")
    return lambda step: base * lam(step)


def make_optimizer(train_args, params: Iterable[torch.Tensor]) -> torch.optim.AdamW:
    """AdamW over `params` with TrainArgs' betas, eps and weight decay; its
    learning rate is installed per update by `set_lr`.  `clip_and_step`
    clips first."""
    return torch.optim.AdamW(
        list(params), lr=0.0, betas=(train_args.adam_beta1, train_args.adam_beta2),
        eps=train_args.adam_epsilon, weight_decay=train_args.weight_decay,
    )


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def clip_and_step(opt: torch.optim.Optimizer, max_grad_norm: float) -> None:
    """Clip the gradients of every parameter of `opt` to a global norm of
    max_grad_norm, then take the AdamW step.  torch's clip divides by
    norm + 1e-6 where optax's divides by the norm (a relative difference of
    1e-6 / norm on clipped steps).  A parameter the loss does not reach gets
    a zero gradient (the stage-2 hypernet's generator heads past layer 0):
    optax updates every leaf, so AdamW's weight decay applies there too."""
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
    opt.step()


def adamw_state(opt: torch.optim.AdamW, params) -> dict:
    """The AdamW moments and per-parameter step counts of `params` (a tree
    of the optimizer's leaves), shaped like the tree: a checkpoint's
    optimizer_state_dict in the port's format."""
    def per(key, empty):
        return tree_map(lambda t: opt.state[t][key] if opt.state[t] else empty(t), params)

    return {
        "format": ADAMW_FORMAT,
        "step": per("step", lambda t: torch.zeros(())),
        "exp_avg": per("exp_avg", torch.zeros_like),
        "exp_avg_sq": per("exp_avg_sq", torch.zeros_like),
    }


def _optax_adam_moments(state):
    """(count, mu, nu) of the one ScaleByAdamState in an unpickled optax
    state (ForeignObjects holding their constructor arguments)."""
    found = []

    def walk(node):
        if isinstance(node, ForeignObject):
            if node.cls_name.endswith(".ScaleByAdamState") and len(node.args) == 3:
                found.append(node.args)
                return
            node = node.args
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(state)
    if len(found) != 1:
        raise ValueError(f"expected one optax ScaleByAdamState, found {len(found)}")
    return found[0]


def load_adamw_state(opt: torch.optim.AdamW, params, state, device) -> None:
    """Install a checkpoint's optimizer_state_dict for `params` (a tree of
    the optimizer's leaves): the port's format, or dmi_tpu's optax state,
    whose mu and nu are trees shaped like the parameters and whose count is
    the number of updates taken (torch's per-parameter `step`)."""
    if isinstance(state, dict) and state.get("format") == ADAMW_FORMAT:
        flat = {key: [np.asarray(v) for _, v in named_leaves(state[key])]
                for key in ("step", "exp_avg", "exp_avg_sq")}
    else:
        count, mu, nu = _optax_adam_moments(state)
        mu = [np.asarray(v) for _, v in named_leaves(mu)]
        flat = {"step": [np.asarray(count)] * len(mu), "exp_avg": mu,
                "exp_avg_sq": [np.asarray(v) for _, v in named_leaves(nu)]}
    leaves = [t for _, t in named_leaves(params)]
    if any(len(v) != len(leaves) for v in flat.values()):
        raise ValueError(f"optimizer state for {len(flat['exp_avg'])} leaves, "
                         f"parameters have {len(leaves)}")
    for i, leaf in enumerate(leaves):
        if flat["exp_avg"][i].shape != tuple(leaf.shape):
            raise ValueError(f"optimizer moment {i}: shape {flat['exp_avg'][i].shape}, "
                             f"parameter {tuple(leaf.shape)}")
        opt.state[leaf] = {
            "step": torch.tensor(float(flat["step"][i]), dtype=torch.float32),
            "exp_avg": torch.as_tensor(flat["exp_avg"][i], device=device).clone(),
            "exp_avg_sq": torch.as_tensor(flat["exp_avg_sq"][i], device=device).clone(),
        }


def set_adamw_moments(opt: torch.optim.AdamW, params, moments: dict, device) -> None:
    """Install a reference torch checkpoint's AdamW moments, converted to the
    parameters' layout ({"mu", "nu", "count"}, torch_import
    .optax_moments_from_checkpoint), for `params` (a tree of the optimizer's
    leaves), as dmi_tpu's set_adamw_moments splices them into its optax
    state: every leaf's torch `step` is the count; a leaf the reference
    never updated has zero moments.  The trees must name the same leaves."""
    want = [n for n, _ in named_leaves(params)]
    for key in ("mu", "nu"):
        got = [n for n, _ in named_leaves(moments[key])]
        if got != want:
            raise ValueError(f"checkpoint moments {key} cover {got}, the parameters are {want}")
    count = np.asarray(moments["count"], np.float32)
    load_adamw_state(opt, params, {
        "format": ADAMW_FORMAT,
        "step": tree_map(lambda _: count, moments["mu"]),
        "exp_avg": moments["mu"],
        "exp_avg_sq": moments["nu"],
    }, device)
