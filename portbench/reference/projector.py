"""Plain float32 PyTorch of what stage 1 trains: the 2-layer projector
(dmi/model/projector.py: Linear -> tanh-GELU -> Dropout -> Linear, weights
stored (in, out)), its dropout draw, global-norm clipping and AdamW
(torch.nn.utils.clip_grad_norm_ then torch.optim.AdamW, as
dmi/train_projector.py takes its steps), written out by hand.

The dropout mask of micro-step `step` is a pure function of (seed, step):
numpy's SeedSequence of the two gives a 32-bit key, and element i is kept
when the top 23 bits of MurmurHash3's finaliser over (fmix(i ^ 0x7F4A7C15)
^ fmix(key ^ fmix(1))), plus a half, over 2**23 fall below 1 - rate.  It is
worked out here in numpy from that definition.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

M32 = np.uint64(0xFFFFFFFF)


def _fmix(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & M32
    return h ^ (h >> np.uint64(16))


def dropout_keep(seed: int, step: int, shape, rate: float) -> torch.Tensor:
    """The keep mask (bool) of micro-step `step`'s one dropout draw."""
    key = np.uint64(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint32)[0])
    k = _fmix(np.array([key ^ _fmix(np.array([1], np.uint64))[0]], np.uint64))[0]
    n = int(np.prod(shape))
    h = _fmix(_fmix(np.arange(n, dtype=np.uint64) ^ np.uint64(0x7F4A7C15)) ^ k)
    u = ((h >> np.uint64(9)).astype(np.float64) + 0.5) * 2.0 ** -23
    return torch.from_numpy(u.astype(np.float32) < np.float32(1.0 - rate)).reshape(shape)


def soft_token(params: dict, embs: torch.Tensor, keep=None, rate: float = 0.0) -> torch.Tensor:
    """The projector over l2-normalised embeddings embs [B, mm] -> [B, lm];
    with `keep`, dropout after the hidden activation."""
    x = embs / torch.linalg.vector_norm(embs, dim=-1, keepdim=True)
    (w0, b0), (w1, b1) = ((layer["w"], layer["b"]) for layer in params["layers"])
    h = F.gelu(x @ w0 + b0, approximate="tanh")
    if keep is not None:
        h = torch.where(keep.to(h.device), h / (1.0 - rate), 0.0)
    return h @ w1 + b1


class AdamW:
    """Global-norm clip (coefficient max_norm / (norm + 1e-6), applied when
    under 1) and decoupled-weight-decay Adam with bias correction, over a
    list of f32 tensors updated in place."""

    def __init__(self, params, lr, beta1, beta2, eps, weight_decay, max_grad_norm):
        self.p = params
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.wd, self.max_norm = weight_decay, max_grad_norm
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def clip(self, grads):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        coef = self.max_norm / (norm + 1e-6)
        return [g * coef for g in grads] if coef < 1 else list(grads)

    def step(self, grads):
        """Clip, then one update; returns the clipped gradients."""
        grads = self.clip(grads)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.p, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(self.lr / c1 * m / (torch.sqrt(v) / c2 ** 0.5 + self.eps))
        return grads
