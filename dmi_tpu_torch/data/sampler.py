# Copy of dmi_tpu/data/sampler.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Stateless infinite sampler.

The reference's InfiniteSampler (dmi/utils/sampler.py) yields an endless
stream of with-replacement indices from numpy's *global* RNG, and defines
``len = dataset_length * epochs`` — that product is what sets the total
number of training steps (consumed at dmi/train.py:75).

TPU-first redesign: indices are a pure function of (seed, step), so
resuming at step k needs no iterator replay (the reference fast-forwards by
re-drawing start_step batches, dmi/train.py:79-86) and data order is exactly
reproducible under preemption.
"""

from __future__ import annotations

import numpy as np


class InfiniteSampler:
    """Stateless with-replacement (or per-epoch permutation) index stream."""

    def __init__(self, length: int, epochs: int, seed: int, replacement: bool = True):
        if length <= 0:
            raise ValueError("empty dataset")
        self.length = length
        self.epochs = epochs
        self.seed = seed
        self.replacement = replacement

    def batch_indices(self, step: int, batch_size: int) -> np.ndarray:
        """Indices for batch `step` — pure function of (seed, step)."""
        if self.replacement:
            rng = np.random.default_rng((self.seed, 0, step))
            return rng.integers(0, self.length, size=batch_size, dtype=np.int64)
        # permutation mode: global position p enumerates shuffled epochs
        start = step * batch_size
        out = np.empty(batch_size, np.int64)
        for i in range(batch_size):
            p = start + i
            epoch, pos = divmod(p, self.length)
            perm = np.random.default_rng((self.seed, 1, epoch)).permutation(self.length)
            out[i] = perm[pos]
        return out

    def __len__(self) -> int:
        # reference: length * epochs == total train steps (sampler.py:35-36)
        return self.length * self.epochs
