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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


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
    1e-6 / norm on clipped steps)."""
    torch.nn.utils.clip_grad_norm_([p for g in opt.param_groups for p in g["params"]],
                                   max_grad_norm)
    opt.step()
