"""dmi_tpu_torch's stochastic speculative sampling
(speculative.speculative_sample_bl) at f32 on the CPU.

With the draft equal to the target every proposal is the plain sampler's
own draw and p == q, so the tokens are bit-identical to the port's
sample_generate_bl (the draws' keying invariant); with the W4A8 self-draft
(q != p) the tokens follow the plain sampler's law and dmi_tpu's
speculative_sample_bl's, by two-sample chi-square tests at fixed seeds (the
port's draws are its own counter-based hash, not JAX's threefry, as in
tests/test_torch_sampling.py).  Requests keep their draws at any row; EOS
pads as the plain sampler does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from dmi_tpu.models import llama as jllama
from dmi_tpu.models import quant as jq
from dmi_tpu.models import speculative as jspec
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import speculative as tspec
from dmi_tpu_torch.models.quant import quantize_llama

torch.set_num_threads(1)

PAD = 0
# a chi-square statistic above its 0.999 quantile fails the test: a correct
# sampler does that once in a thousand seeds, and these are fixed
P_FAIL = 0.999


def _models(seed=0, eos=(5,), vocab=96, hidden=64, inter=96):
    """Tiny f32 model in both packages, layer weights scaled to std 0.2."""
    jcfg = dataclasses.replace(
        jllama.tiny_config(vocab_size=vocab, hidden_size=hidden, n_layers=2, n_heads=4, n_kv=2,
                           intermediate=inter), eos_token_ids=tuple(eos))
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(seed), jcfg))
    tree["layers"] = {k: v * 10.0 if k.startswith("w") else v for k, v in tree["layers"].items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, bridge.config_from_jax(jcfg), bridge.llm_params_from_jax(tree)


def _prompt(B, T, H, seed):
    return (np.random.default_rng(seed).normal(size=(B, T, H)) / np.sqrt(H)).astype(np.float32)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (1.7, 5, 1.0),
                                                     (0.8, 0, 0.85)])
def test_self_draft_is_bit_identical_to_the_plain_sampler(temperature, top_k, top_p):
    """Draft == target: p == q at every proposal, all accepted, the tokens
    those of sample_generate_bl bit for bit, rounds at most ceil((budget -
    1) / (k + 1))."""
    _, _, tcfg, tparams = _models(seed=41)
    B, T, budget, k = 4, 5, 9, 3
    embeds = torch.from_numpy(_prompt(B, T, 64, seed=42))
    want = tdec.sample_generate_bl(tcfg, tparams, embeds, budget, PAD, seed=17,
                                   temperature=temperature, top_k=top_k, top_p=top_p)
    got, rounds = tspec.speculative_sample_bl(tcfg, tparams, tcfg, tparams, embeds, embeds,
                                              budget, PAD, seed=17, temperature=temperature,
                                              top_k=top_k, top_p=top_p, k=k)
    assert torch.equal(got, want)
    assert rounds <= -(-(budget - 1) // (k + 1))


def test_requests_keep_their_draws_at_any_row_and_eos_pads():
    """The same request draws the same caption at any row of the batch (the
    W4A8 draft's acceptances differ by row); after an EOS only pad."""
    _, _, tcfg, tparams = _models(seed=43, eos=(5,))
    draft = quantize_llama(tparams, bits=4)
    embeds = torch.from_numpy(_prompt(6, 4, 64, seed=44))
    req = torch.tensor([7, 3, 11, 0, 2, 9])
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    kw = dict(seed=3, temperature=1.3, k=2, draft_prefill_params=tparams, share_prefill=True)
    t1, _ = tspec.speculative_sample_bl(tcfg, tparams, tcfg, draft, embeds, embeds, 8, PAD,
                                        req_ids=req, **kw)
    t2, _ = tspec.speculative_sample_bl(tcfg, tparams, tcfg, draft, embeds[perm],
                                        embeds[perm], 8, PAD, req_ids=req[perm], **kw)
    assert torch.equal(t1[perm], t2)
    for row in t1.numpy():
        hits = np.nonzero(row == 5)[0]
        if hits.size:
            assert (row[hits[0] + 1:] == PAD).all()


def test_subkeys_are_streams_apart_from_their_key():
    """_subkeys(K, i) is a bijection of K for each i and its uniforms are
    independent of K's and of the other stream's (chi-square on 8 x 8
    bins of pairs over 20000 keys)."""
    keys = tdec._req_keys(0, torch.arange(20000), 1, 0)
    s1, s2 = tspec._subkeys(keys, 1), tspec._subkeys(keys, 2)
    assert len(set(s1.tolist())) == len(set(keys.tolist())) == 20000
    u = [tdec.uniform_draws(x, 1)[0].numpy() for x in (keys, s1, s2)]
    for a, b in ((0, 1), (0, 2), (1, 2)):
        table = np.histogram2d(u[a], u[b], bins=8, range=[[0, 1], [0, 1]])[0]
        assert stats.chi2_contingency(table)[0] < stats.chi2.ppf(P_FAIL, 49)


def _law(x, y, V, positions):
    """Two-sample chi-square (contingency) of token histograms at each
    position; pad folded into its own bin."""
    for pos in range(positions):
        table = np.stack([np.bincount(x[:, pos], minlength=V), np.bincount(y[:, pos],
                                                                           minlength=V)])
        table = table[:, table.sum(0) > 0]
        assert table.shape[1] > 2  # the draw has several outcomes here
        stat, _, dof, _ = stats.chi2_contingency(table)
        assert stat < stats.chi2.ppf(P_FAIL, dof), (pos, table)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.4, 0, 1.0), (0.9, 6, 0.9)])
def test_w4a8_draft_keeps_the_plain_samplers_law_and_dmi_tpus(temperature, top_k, top_p):
    """600 rows of one prompt, V 16, budget 3, k 2, the W4A8 self-draft
    (q != p: proposals rejected and resampled from the residual): at each
    position the speculative tokens pass a two-sample chi-square against
    the port's plain sampler and against dmi_tpu's speculative_sample_bl
    with its own W4A8 draft (seed 0 / key 0), and some proposals were
    rejected."""
    jcfg, jparams, tcfg, tparams = _models(seed=45, eos=(), vocab=16, hidden=32, inter=64)
    n, budget, k = 600, 3, 2
    embeds = np.repeat(_prompt(1, 3, 32, seed=46), n, axis=0)
    te = torch.from_numpy(embeds)
    tdraft = quantize_llama(tparams, bits=4)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    plain = tdec.sample_generate_bl(tcfg, tparams, te, budget, PAD, seed=0, **kw).numpy()
    ours, rounds = tspec.speculative_sample_bl(tcfg, tparams, tcfg, tdraft, te, te, budget, PAD,
                                               seed=0, k=k, draft_prefill_params=tparams,
                                               share_prefill=True, **kw)
    ours = ours.numpy()
    jdraft = jq.quantize_llama(jparams, bits=4)
    ref, _ = jspec.speculative_sample_bl(jcfg, jparams, jcfg, jdraft, jnp.asarray(embeds),
                                         jnp.asarray(embeds), budget, PAD, jax.random.key(0),
                                         k=k, draft_prefill_params=jparams, **kw)
    _law(ours, plain, 16, budget)
    _law(ours, np.asarray(ref), 16, budget)
    assert 1 <= rounds <= budget - 1
    # the draft disagreed somewhere: tokens differ from the plain sampler's
    # draws row for row though the law is the same
    assert (ours != plain).any()


def test_sampling_guards():
    _, _, tcfg, tparams = _models(seed=1)
    small = dataclasses.replace(tcfg, vocab_size=tcfg.vocab_size - 1)
    embeds = torch.from_numpy(_prompt(2, 3, 64, seed=2))
    with pytest.raises(ValueError, match="k >= 1"):
        tspec.speculative_sample_bl(tcfg, tparams, tcfg, tparams, embeds, embeds, 4, PAD, k=0)
    with pytest.raises(ValueError, match="one vocab"):
        tspec.speculative_sample_bl(tcfg, tparams, small, tparams, embeds, embeds, 4, PAD)
