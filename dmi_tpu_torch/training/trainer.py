"""Trainer schedule (counterpart of dmi_tpu/training/trainer.py, whose
framework-free code this repeats so that a trainer on a card loads no
dmi_tpu module).

  * StepConditions: the reference's (step_idx, total_steps) boolean schedule
    for accumulation, eval, generate and save, periodic or from explicit
    step lists (dmi/train.py:128-167)
  * pick_loader: stateless per-step loader choice, weighted by loader length
    (dmi/train.py:76), so resume never replays iterators
  * strip_to_assistant: GT extraction from decoded eval rows
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _in_step_list(step_idx: int, steps: Sequence[int]) -> bool:
    return any(step_idx + 1 == s for s in steps)


class StepConditions:
    """Reads the TrainArgs fields it needs from any object that has them."""

    def __init__(self, train_args):
        self.a = train_args

    def grad_acc(self, step_idx: int, total_steps: int) -> bool:
        return (step_idx == total_steps - 1) or (
            (step_idx + 1) % self.a.gradient_accumulation_steps == 0
        )

    def _periodic_or_list(self, step_idx, total_steps, period, step_list, at_zero,
                          include_final=True):
        if step_list is None:
            periodic = (step_idx + 1) % period == 0 and (step_idx > 0 or at_zero)
            final = include_final and step_idx == total_steps - 1
            return final or periodic
        return _in_step_list(step_idx, step_list) or (step_idx == total_steps - 1)

    def evaluate(self, step_idx: int, total_steps: int) -> bool:
        return self._periodic_or_list(
            step_idx, total_steps, self.a.eval_steps, self.a.eval_steps_l,
            self.a.eval_at_step_zero,
        )

    def generate(self, step_idx: int, total_steps: int, include_final: bool = True) -> bool:
        return self._periodic_or_list(
            step_idx, total_steps, self.a.generate_steps, self.a.generate_steps_l,
            self.a.generate_at_step_zero, include_final=include_final,
        )

    def save(self, step_idx: int, total_steps: int) -> bool:
        if self.a.save_steps_l is None:
            return (step_idx == total_steps - 1) or (
                (step_idx + 1) % self.a.save_steps == 0 and step_idx > 0
            )
        return _in_step_list(step_idx, self.a.save_steps_l) or (
            step_idx == total_steps - 1
        )


def pick_loader(seed: int, step: int, n_loaders: int,
                weights: Optional[List[float]] = None) -> int:
    """Stateless per-step loader choice."""
    rng = np.random.default_rng((seed, 2, step))
    if weights is None:
        return int(rng.integers(n_loaders))
    return int(rng.choice(n_loaders, p=np.asarray(weights) / np.sum(weights)))


def strip_to_assistant(texts: List[str]) -> List[str]:
    """GT extraction from decoded eval rows (dmi/train.py:189-195)."""
    return [t.split("assistant\n\n\n")[-1].strip() for t in texts]
