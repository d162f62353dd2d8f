"""Random draws that give the same bits on the CPU and on the card.

torch's generators are per device (a Mersenne Twister on the CPU, Philox on
CUDA), so one seed gives other weights and dropout masks on each.  A
CounterRNG draws each tensor from a stateless, counter-based hash of its
key, the number of draws it made before, and each element's index, in
integer ops (MurmurHash3's finaliser, as decode.uniform_draws samples), so a
run's random initialisation, dropout masks and rotations do not depend on
where it runs, as jax.random's do not for dmi_tpu.  The entry points seed
their runs with one; uniform() and normal() below take either kind of
generator, and a torch.Generator keeps its own stream.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a constant c < 2**32,
    in 16-bit halves so that no int64 product overflows."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 values in [0, 2**32): a
    bijection in which every input bit flips each output bit with
    probability about 1/2."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


class CounterRNG:
    """A seeded stream of draws, each a pure function of (the seed words, the
    draw's ordinal, the element's index).  `device` is where draws land by
    default (as a torch.Generator's device)."""

    def __init__(self, *seed: int, device: Union[str, torch.device] = "cpu"):
        self.key = int(np.random.SeedSequence([int(s) for s in seed]).generate_state(
            1, np.uint32)[0])
        self.device = torch.device(device)
        self.draws = 0

    def _words(self, n: int, lanes: int, device) -> list:
        """`lanes` independent tensors of n 32-bit words (int64) for the next draw."""
        idx = fmix32(torch.arange(n, dtype=torch.int64, device=device) ^ 0x7F4A7C15)
        out = []
        for lane in range(lanes):
            k = _fmix32_int(self.key ^ _fmix32_int((self.draws * 4 + lane + 1) & M32))
            out.append(fmix32(idx ^ k))
        self.draws += 1
        return out

    def uniform(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """f32 in (0, 1): 23 random bits, (m + 1/2) / 2**23."""
        device = self.device if device is None else device
        (h,) = self._words(math.prod(shape), 1, device)
        return (((h >> 9).to(torch.float32) + 0.5) * 2.0 ** -23).reshape(shape)

    def normal(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """f32 standard normal: Box-Muller on two 32-bit uniforms, in f64."""
        device = self.device if device is None else device
        h1, h2 = self._words(math.prod(shape), 2, device)
        u1 = (h1.to(torch.float64) + 0.5) * 2.0 ** -32
        u2 = (h2.to(torch.float64) + 0.5) * 2.0 ** -32
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
        return z.to(torch.float32).reshape(shape)


Generator = Union[torch.Generator, CounterRNG]


def uniform(generator: Generator, shape: Sequence[int], device=None) -> torch.Tensor:
    """f32 uniform draws [0, 1) (torch) or (0, 1) (CounterRNG) on `device`
    (default: the generator's)."""
    if isinstance(generator, CounterRNG):
        return generator.uniform(shape, device)
    return torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                      device=generator.device if device is None else device)


def normal(generator: Generator, shape: Sequence[int], device=None) -> torch.Tensor:
    """f32 standard normal draws on `device` (default: the generator's)."""
    if isinstance(generator, CounterRNG):
        return generator.normal(shape, device)
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device if device is None else device)

