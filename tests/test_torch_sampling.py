"""dmi_tpu_torch's request-indexed sampling against dmi_tpu's.

The warp chain (_warp_bl: temperature, top-k, top-p) is held to dmi_tpu's
_warp_bl and to HF's logits warpers.  The draw is the port's own
counter-based function (JAX's threefry streams are not reproduced), so it
is held to its law: uniform and independent across streams and tokens
(chi-square at a fixed seed), picks with softmax(warped)'s frequencies, the
same draws for a request whatever its row or batch; and dmi_tpu's sampled
tokens are matched in law by a two-sample chi-square, and exactly where the
draw cannot matter (top_k 1, temperature 1e-4: greedy).  All at f32 on the
CPU, small sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec

torch.set_num_threads(1)

PAD = 1
# a chi-square statistic above its 0.999 quantile fails the test: a
# correct sampler does that once in a thousand seeds, and these are fixed
P_FAIL = 0.999


def _models(eos=(), vocab=96, seed=0):
    """Tiny f32 model, layer weights scaled to std 0.2 (varied, well
    separated greedy tokens), in both packages."""
    jcfg = jllama.tiny_config(vocab_size=vocab, hidden_size=64, n_layers=2, n_heads=4,
                              n_kv=2, intermediate=128, eos=eos)
    jparams = jllama.init(jax.random.key(seed), jcfg)
    jparams["layers"] = {k: v * 10.0 if k.startswith("w") else v
                         for k, v in jparams["layers"].items()}
    jparams = jllama.fuse_projections(jparams)
    tparams = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_jax(jcfg), tparams


def _planted(seed, V=40, B=6):
    """[V, B] logits with planted ties: column 0 has four tokens equal to its
    5th largest value (top_k 5 keeps all of them), column 1 three tokens
    equal at the value where the cumulative probability crosses 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(V, B)).astype(np.float32) * 2.0
    order = np.argsort(-x[:, 0])
    x[order[4:8], 0] = x[order[4], 0]
    col = np.sort(x[:, 1])[::-1].copy()
    col[3:6] = col[3]
    x[:, 1] = col[rng.permutation(V)]
    return x


def _cross_mass(x_col, temperature):
    """top_p values just below and above the cumulative probability at the
    tied block of column 1 (descending order, positions 3-5)."""
    desc = np.sort(x_col / temperature)[::-1].astype(np.float64)
    p = np.exp(desc - desc.max())
    c = np.cumsum(p / p.sum())
    return float((c[2] + c[3]) / 2)  # crosses at the first tied token


@pytest.mark.parametrize("temperature", [0.7, 1.0, 2.5])
@pytest.mark.parametrize("top_k", [0, 1, 5, 40])
@pytest.mark.parametrize("top_p", [1.0, 0.9, None])
def test_warp_chain_matches_dmi_tpu(temperature, top_k, top_p):
    """The same -inf pattern and finite values within 1e-6 relative, with
    ties planted at the k-th value and at the top-p cutoff (top_p None:
    the cutoff of column 1's tied block)."""
    x = _planted(seed=int(temperature * 10) + top_k)
    if top_p is None:
        top_p = _cross_mass(x[:, 1], temperature)
    ours = tdec._warp_bl(torch.from_numpy(x), temperature, top_k, top_p).numpy()
    ref = np.asarray(jdec._warp_bl(jnp.asarray(x), temperature, top_k, top_p))
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert np.isfinite(ours[fin]).all()
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=1e-6, atol=0)
    if top_k == 5:  # the tie at the k-th value keeps every tied token
        assert np.isfinite(ours[:, 0]).sum() >= 8 or top_p < 1.0


def test_warp_chain_keeps_ties_at_the_cutoffs():
    """top-k 5 over a column with four tokens tied at its 5th value keeps 8;
    top-p that crosses at a block of three tied tokens keeps the block."""
    x = _planted(seed=3)
    kept_k = np.isfinite(tdec._warp_bl(torch.from_numpy(x), 1.0, 5).numpy()[:, 0]).sum()
    assert kept_k == 8
    top_p = _cross_mass(x[:, 1], 1.0)
    kept_p = np.isfinite(tdec._warp_bl(torch.from_numpy(x), 1.0, 0, top_p).numpy()[:, 1]).sum()
    assert kept_p == 6


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 0.9), (1.3, 5, 0.8), (1.0, 0, 0.5), (0.9, 3, 1.0), (2.0, 10, 0.95)])
def test_warp_chain_matches_hf_warpers(temperature, top_k, top_p):
    """HF's TemperatureLogitsWarper -> TopKLogitsWarper -> TopPLogitsWarper
    (tests/test_streaming.py's check of dmi_tpu) keep the same tokens, with
    the same values, on tie-free logits."""
    from transformers.generation.logits_process import (TemperatureLogitsWarper,
                                                        TopKLogitsWarper, TopPLogitsWarper)

    logits = np.random.default_rng(7).normal(size=(4, 32)).astype(np.float32) * 2.0  # [B, V]
    t = TemperatureLogitsWarper(temperature)(None, torch.tensor(logits))
    if top_k > 0:
        t = TopKLogitsWarper(top_k)(None, t)
    if top_p < 1.0:
        t = TopPLogitsWarper(top_p)(None, t)
    ours = tdec._warp_bl(torch.tensor(logits.T), temperature, top_k, top_p).t()
    assert torch.equal(torch.isfinite(ours), torch.isfinite(t))
    fin = torch.isfinite(t)
    torch.testing.assert_close(ours[fin], t[fin], rtol=1e-6, atol=0)
    keys = tdec._req_keys(0, torch.arange(4), 8, 0)
    toks = tdec._sample_pick_bl(torch.tensor(logits.T), keys, temperature, top_k, top_p)
    assert all(bool(fin[b, toks[b]]) for b in range(4))


def test_mul32_and_fmix32_are_32_bit_arithmetic():
    vals = [0, 1, 12345, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF]
    x = torch.tensor(vals, dtype=torch.long)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        assert tdec._mul32(x, c).tolist() == [(v * c) % 2 ** 32 for v in vals]

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) % 2 ** 32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) % 2 ** 32
        return h ^ (h >> 16)

    assert tdec._fmix32(x).tolist() == [fmix(v) for v in vals]


def test_draws_lie_in_the_open_interval_with_24_bits():
    keys = tdec._req_keys(5, torch.arange(-3, 300), 22, torch.arange(303) % 22)
    u = tdec.uniform_draws(keys, 1000)
    assert u.dtype == torch.float64 and u.shape == (1000, 303)
    assert 0.0 < u.min().item() and u.max().item() < 1.0
    k = u * 2 ** 24 - 0.5
    assert torch.equal(k, k.round())


def test_draws_are_uniform_and_independent():
    """Chi-square at seed 0 over 2000 streams x 64 tokens: the uniforms in
    32 bins, and the 8 x 8 joint histograms of neighbouring streams (s,
    s + 1) and of neighbouring tokens (v, v + 1)."""
    keys = tdec._req_keys(0, torch.arange(2000), 22, 0)
    u = tdec.uniform_draws(keys, 64).numpy()  # [V, streams]
    counts = np.bincount((u * 32).astype(int).ravel(), minlength=32)
    stat = ((counts - u.size / 32) ** 2 / (u.size / 32)).sum()
    assert stat < stats.chi2.ppf(P_FAIL, 31), stat
    b = (u * 8).astype(int)
    for a, c in ((b[:, :-1], b[:, 1:]), (b[:-1], b[1:])):
        table = np.zeros((8, 8))
        np.add.at(table, (a.ravel(), c.ravel()), 1)
        stat = stats.chi2_contingency(table)[0]
        assert stat < stats.chi2.ppf(P_FAIL, 49), stat
    # streams that differ in the seed only are unrelated too
    u2 = tdec.uniform_draws(tdec._req_keys(1, torch.arange(2000), 22, 0), 64).numpy()
    table = np.zeros((8, 8))
    np.add.at(table, ((u * 8).astype(int).ravel(), (u2 * 8).astype(int).ravel()), 1)
    assert stats.chi2_contingency(table)[0] < stats.chi2.ppf(P_FAIL, 49)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (4, 1.0), (0, 0.8)])
def test_pick_frequencies_follow_softmax(top_k, top_p):
    """20000 requests' picks over one column of V 8 logits against
    softmax(warped): goodness of fit at seed 0; filtered tokens never."""
    logits = torch.tensor([1.5, 0.2, -0.7, 0.9, 2.1, -2.0, 0.0, 1.1])[:, None]
    n = 20000
    warped = tdec._warp_bl(logits, 0.8, top_k, top_p)
    keys = tdec._req_keys(0, torch.arange(n), 22, 3)
    picks = tdec._sample_pick_bl(logits.expand(-1, n), keys, 0.8, top_k, top_p)
    counts = np.bincount(picks.numpy(), minlength=8)
    p = torch.softmax(warped[:, 0], dim=0).numpy().astype(np.float64)
    kept = p > 0
    assert (counts[~kept] == 0).all()
    exp = n * p[kept]
    stat = ((counts[kept] - exp) ** 2 / exp).sum()
    assert stat < stats.chi2.ppf(P_FAIL, kept.sum() - 1), (stat, counts, exp)


def test_draws_depend_on_the_request_not_its_row():
    """A request's pick is the same alone, in a batch, at another row or
    beside other requests; the age and the seed move it."""
    V = 50
    rng = np.random.default_rng(0)
    col = torch.from_numpy(rng.normal(size=(V,)).astype(np.float32))

    def pick(reqs, n=2, seed=7, budget=22):
        reqs = torch.tensor(reqs)
        keys = tdec._req_keys(seed, reqs, budget, n)
        return tdec._sample_pick_bl(col[:, None].expand(-1, len(reqs)), keys, 1.5, 0, 1.0)

    alone = pick([17])[0]
    assert pick([3, 17, 40])[1] == alone
    assert pick([17, 0, 1, 2, 5, 9])[0] == alone
    assert (pick(list(range(100))) == pick(list(range(100))[::-1]).flip(0)).all()
    many = pick(list(range(200)))
    assert len(set(many.tolist())) > 10  # the requests' draws differ
    ages = torch.stack([pick(list(range(200)), n=a) for a in range(3)])
    assert not torch.equal(ages[0], ages[1]) and not torch.equal(ages[1], ages[2])
    assert not torch.equal(many, pick(list(range(200)), seed=8))
    # per-slot ages (the engine) give each slot its own age's draw
    keys = tdec._req_keys(7, torch.tensor([4, 4]), 22, torch.tensor([0, 2]))
    assert torch.equal(keys, torch.cat([tdec._req_keys(7, torch.tensor([4]), 22, 0),
                                        tdec._req_keys(7, torch.tensor([4]), 22, 2)]))


@pytest.mark.parametrize("kw", [dict(top_k=1, temperature=1.7), dict(temperature=1e-4)],
                         ids=["top_k-1", "temperature-1e-4"])
def test_sampled_loops_equal_dmi_tpu_greedy_where_the_draw_cannot_matter(kw):
    """top_k 1 keeps one token and temperature 1e-4 makes the draw's noise
    negligible against these logits' gaps: both sampled loops of the port
    emit dmi_tpu's greedy_generate_bl tokens (tests/test_llama.py pins the
    same for dmi_tpu's sampler), with EOS ending rows mid-budget."""
    jcfg, jparams, tcfg, tparams = _models(eos=())
    embeds = np.random.default_rng(1).normal(size=(6, 5, 64)).astype(np.float32)
    free = np.asarray(jdec.greedy_generate_bl(jcfg, jparams, jnp.asarray(embeds), 9, PAD))
    row = next(r for r in range(len(free)) if free[r, 3] not in free[r, :3])
    jcfg, jparams, tcfg, tparams = _models(eos=(int(free[row, 3]),))
    want = np.asarray(jdec.greedy_generate_bl(jcfg, jparams, jnp.asarray(embeds), 9, PAD))
    assert (want == PAD).any()
    x = torch.from_numpy(embeds)
    bl = tdec.sample_generate_bl(tcfg, tparams, x, 9, PAD, seed=3, **kw).numpy()
    bf = tdec.sample_generate(tcfg, tparams, x, 9, PAD, seed=4, **kw).numpy()
    np.testing.assert_array_equal(bl, want)
    np.testing.assert_array_equal(bf, want)


def test_sampled_loops_agree_inside_the_port():
    """The batch-first and batch-last sampled loops draw with the same
    request-indexed keys (req = row): the same tokens at f32; a request's
    tokens do not move with its row (req_ids) or its batch-mates."""
    _, _, tcfg, tparams = _models(eos=(7,))
    embeds = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 4, 64))
                              .astype(np.float32))
    kw = dict(seed=11, temperature=1.3, top_k=20)
    bl = tdec.sample_generate_bl(tcfg, tparams, embeds, 8, PAD, **kw)
    assert torch.equal(bl, tdec.sample_generate(tcfg, tparams, embeds, 8, PAD, **kw))
    perm = torch.tensor([3, 0, 4, 1, 2])
    moved = tdec.sample_generate_bl(tcfg, tparams, embeds[perm], 8, PAD, req_ids=perm, **kw)
    assert torch.equal(moved, bl[perm])
    alone = tdec.sample_generate_bl(tcfg, tparams, embeds[2:3], 8, PAD,
                                    req_ids=torch.tensor([2]), **kw)
    assert torch.equal(alone, bl[2:3])
    assert not torch.equal(bl, tdec.sample_generate_bl(tcfg, tparams, embeds, 8, PAD,
                                                       **{**kw, "seed": 12}))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.8, 6, 0.9)])
def test_sampled_tokens_follow_dmi_tpus_law(temperature, top_k, top_p):
    """600 rows of one prompt through dmi_tpu's sample_generate_bl and the
    port's, V 16: at each of 3 positions the two token histograms pass a
    two-sample chi-square (contingency) test at seed 0 / key 0."""
    jcfg, jparams, tcfg, tparams = _models(eos=(), vocab=16, seed=4)
    n = 600
    prompt = np.random.default_rng(5).normal(size=(1, 4, 64)).astype(np.float32)
    embeds = np.repeat(prompt, n, axis=0)
    ref = np.asarray(jdec.sample_generate_bl(
        jcfg, jparams, jnp.asarray(embeds), 3, PAD, jax.random.key(0),
        temperature=temperature, top_k=top_k, top_p=top_p))
    ours = tdec.sample_generate_bl(tcfg, tparams, torch.from_numpy(embeds), 3, PAD, seed=0,
                                   temperature=temperature, top_k=top_k, top_p=top_p).numpy()
    for pos in range(3):
        table = np.stack([np.bincount(ref[:, pos], minlength=16),
                          np.bincount(ours[:, pos], minlength=16)])
        table = table[:, table.sum(0) > 0]
        assert table.shape[1] > 2  # the draw has several outcomes here
        stat, _, dof, _ = stats.chi2_contingency(table)
        assert stat < stats.chi2.ppf(P_FAIL, dof), (pos, table)
