"""utils.rng: the counter-based draws the entry points seed their runs with.
Each draw is a pure function of integers (held to a pure-Python model of
the hash, so it cannot depend on the device), repeats for a seed, moves
with the seed and the draw's ordinal, and has the law it claims; a
torch.Generator keeps its own stream.  The card's case (the same bits on
CUDA) is marked `cuda`.
"""

import math

import numpy as np
import pytest
import torch

from dmi_tpu_torch.models import hypernet as hn
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.ops.linalg import random_orthogonal
from dmi_tpu_torch.training.projector_trainer import dropout_generator
from dmi_tpu_torch.utils import rng

torch.set_num_threads(1)
M = 0xFFFFFFFF


def _fmix(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    return h ^ (h >> 16)


def _model_words(g: rng.CounterRNG, n, lane):
    k = _fmix(g.key ^ _fmix((g.draws * 4 + lane + 1) & M))
    return [_fmix(_fmix(i ^ 0x7F4A7C15) ^ k) for i in range(n)]


def test_draws_are_a_function_of_integers():
    g = rng.CounterRNG(7, 3)
    (h,) = [_model_words(g, 50, 0)]
    u = g.uniform((5, 10))
    assert u.tolist() == torch.tensor([((x >> 9) + 0.5) * 2.0 ** -23 for x in h]).reshape(
        5, 10).tolist()
    h1, h2 = _model_words(g, 9, 0), _model_words(g, 9, 1)
    z = g.normal((9,))
    want = [math.sqrt(-2 * math.log((a + 0.5) * 2.0 ** -32)) * math.cos(
        2 * math.pi * (b + 0.5) * 2.0 ** -32) for a, b in zip(h1, h2)]
    np.testing.assert_allclose(z.numpy(), np.float32(want), rtol=0, atol=0)
    assert g.draws == 2


def test_streams_repeat_and_move():
    a, b = rng.CounterRNG(1, 2), rng.CounterRNG(1, 2)
    assert torch.equal(a.normal((4, 4)), b.normal((4, 4)))
    assert not torch.equal(a.normal((4, 4)), rng.CounterRNG(1, 2).normal((4, 4)))  # 2nd draw
    assert not torch.equal(rng.CounterRNG(1, 3).uniform((8,)), rng.CounterRNG(1, 2).uniform((8,)))
    assert torch.equal(dropout_generator(5, 9, "cpu").uniform((6,)),
                       rng.CounterRNG(5, 9).uniform((6,)))


def test_laws():
    u = rng.CounterRNG(0).uniform((200_000,)).double()
    assert 0 < u.min() and u.max() < 1
    counts = np.histogram(u.numpy(), bins=20, range=(0, 1))[0]
    chi2 = ((counts - 10_000) ** 2 / 10_000).sum()
    assert chi2 < 50  # 19 degrees of freedom: p about 1e-4
    z = rng.CounterRNG(1).normal((200_000,)).double()
    assert abs(z.mean()) < 5 / math.sqrt(2e5) and abs(z.std() - 1) < 0.01
    assert abs((z.abs() < 1).double().mean() - 0.6827) < 0.005


def test_torch_generators_keep_their_stream():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(rng.normal(g1, (3, 5)), torch.randn(3, 5, generator=g2))
    assert torch.equal(rng.uniform(g1, (7,)), torch.rand(7, generator=g2))
    cfg = llama.tiny_config(vocab_size=32, hidden_size=16, n_layers=1, n_heads=2, n_kv=1,
                            intermediate=32)
    a = llama.init(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(a["embed"], llama.init(cfg, torch.Generator().manual_seed(0))["embed"])
    assert not torch.equal(a["embed"], llama.init(cfg, rng.CounterRNG(0))["embed"])


def test_inits_dropout_and_rotation_take_either_generator():
    spec = proj.ProjectorSpec(mm_dim=8, lm_dim=16, n_layers=2, dropout=0.5)
    for make in (lambda: torch.Generator().manual_seed(0), lambda: rng.CounterRNG(0)):
        p1, p2 = proj.init(spec, make()), proj.init(spec, make())
        assert all(torch.equal(a["w"], b["w"]) for a, b in zip(p1["layers"], p2["layers"]))
        x = torch.ones(4, 8)
        y1 = proj.apply(spec, p1, x, train=True, generator=make())
        assert torch.equal(y1, proj.apply(spec, p1, x, train=True, generator=make()))
        q = random_orthogonal(12, make(), dtype=torch.float64)
        torch.testing.assert_close(q.T @ q, torch.eye(12, dtype=torch.float64), rtol=0,
                                   atol=1e-6)  # a QR in f32
    hspec = hn.HypnetSpec(lm_dim=16, mm_dim=8, n_tokens=4, hypnet_dim=8, rank=2)
    assert hn.init(hspec, rng.CounterRNG(0))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_draws_the_cpus_bits(cuda):
    for shape in ((1000,), (37, 129)):
        assert torch.equal(rng.CounterRNG(4, 2).uniform(shape, cuda).cpu(),
                           rng.CounterRNG(4, 2).uniform(shape))
        torch.testing.assert_close(rng.CounterRNG(4, 2).normal(shape, cuda).cpu(),
                                   rng.CounterRNG(4, 2).normal(shape), rtol=2e-7, atol=0)
