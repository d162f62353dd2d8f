"""dmi_tpu_torch's speculative engines and serving surface at f32 on the
CPU: the slot engine (speculative_bulk_caption) and the online engine
(SpeculativeStreamingCaptioner) equal to the batch speculative path row for
row, greedy (and so to dmi_tpu's batch captioner) and sampled, at two
pool / chunk settings with the ring wrapping; their guards;
Captioner(speculative=2)'s captions against dmi_tpu's Captioner(speculative=2)
on the tokenizer fixture on both engines; the CLI's --speculative.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import mmmodel as jmm
from dmi_tpu.models import projector as jproj
from dmi_tpu.serve import Captioner as JaxCaptioner
from dmi_tpu.training.checkpoint import save_pytree
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import mmmodel as tmm
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.models import speculative as tspec
from dmi_tpu_torch.models.quant import quantize_llama
from dmi_tpu_torch.ops import l2_normalize
from dmi_tpu_torch.serve import Captioner

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PAD = 0
PREFIX = np.asarray([3, 7, 9])


def _setup(seed=0, eos=(5,), vocab=64):
    """A tiny f32 LM (layer weights scaled to std 0.2, so that greedy tokens
    vary and EOS fires at staggered ages) and a 2-layer projector, in both
    packages."""
    jcfg = dataclasses.replace(
        jllama.tiny_config(vocab_size=vocab, hidden_size=32, n_layers=2, n_heads=4, n_kv=2,
                           intermediate=64), eos_token_ids=tuple(eos))
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(seed), jcfg))
    tree["layers"] = {k: v * 10.0 if k.startswith("w") else v for k, v in tree["layers"].items()}
    jspec = jproj.ProjectorSpec(mm_dim=16, lm_dim=32, n_layers=2, dropout=0.0)
    jpp = jproj.init(jax.random.key(seed + 1), jspec)
    tcfg, tparams = bridge.config_from_jax(jcfg), bridge.llm_params_from_jax(tree)
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    return ((jcfg, jax.tree.map(jnp.asarray, tree), jspec, jpp),
            (tcfg, tparams, tproj.ProjectorSpec(mm_dim=16, lm_dim=32), tpp))


def _embs(n, seed):
    x = np.random.default_rng(seed).normal(size=(n, 16)).astype(np.float32)
    return l2_normalize(torch.from_numpy(x)).numpy()


def _batch_spec(t, embs, budget, k, draft, sample=None, seed=0):
    """The batch speculative path over the whole workload in one batch,
    request ids = workload rows (the keys the engines derive)."""
    tcfg, tparams, tspec_, tpp = t
    soft = tproj.apply(tspec_, tpp, torch.from_numpy(embs))
    prefix = torch.from_numpy(PREFIX)[None].expand(len(embs), -1)
    kw = dict(k=k, draft_prefill_params=tparams, share_prefill=True)
    if sample is None:
        return tmm.caption_generate_speculative(tcfg, tparams, tcfg, draft, soft, prefix, budget,
                                                PAD, **kw)[0]
    return tmm.caption_sample_speculative(tcfg, tparams, tcfg, draft, soft, prefix, budget, PAD,
                                          seed, *sample, **kw)[0]


def _bulk(t, embs, budget, chunk, pool, k, draft, **kw):
    tcfg, tparams, tspec_, tpp = t
    out, rounds, admissions = tspec.speculative_bulk_caption(
        tcfg, tparams, tcfg, draft, tspec_, tpp, torch.from_numpy(embs),
        torch.from_numpy(PREFIX)[None].expand(chunk, -1), 1 + len(PREFIX), budget, PAD, chunk,
        pool, k=k, draft_prefill_params=tparams, share_prefill=True, **kw)
    assert admissions == -(-len(embs) // chunk) and rounds >= budget - 1
    return out


@pytest.mark.parametrize("pool,chunk,k,budget", [
    (5, 2, 3, 7),   # refills, staggered EOS
    (9, 4, 2, 5),   # ring of 4 round slots: tenants wrap it again and again
])
def test_bulk_engine_equals_the_batch_paths_greedy(pool, chunk, k, budget):
    """The speculative slot engine with the self-draft and the W4A8
    self-draft: the ids of the batch speculative path and of dmi_tpu's
    batch captioner (plain greedy) for every request."""
    j, t = _setup(seed=21)
    embs = _embs(23, seed=22)
    jcfg, jparams, jspec_, jpp = j
    soft = jproj.apply(jspec_, jpp, jnp.asarray(embs), train=False)
    want = np.asarray(jmm.caption_generate(jcfg, jparams, soft,
                                           jnp.tile(jnp.asarray(PREFIX)[None], (23, 1)), budget,
                                           PAD))
    for draft in (t[1], quantize_llama(t[1], bits=4)):
        np.testing.assert_array_equal(_batch_spec(t, embs, budget, k, draft).numpy(), want)
        np.testing.assert_array_equal(_bulk(t, embs, budget, chunk, pool, k, draft).numpy(), want)


@pytest.mark.parametrize("pool,chunk,k,budget,sample", [
    (5, 3, 2, 7, (1.3, 0, 1.0)),
    (9, 4, 3, 6, (0.9, 6, 0.9)),
])
def test_bulk_engine_equals_the_batch_sampler(pool, chunk, k, budget, sample):
    """Sampled through the slot engine with the W4A8 draft (acceptances differ
    by slot): every draw keyed by (request, age), so the ids equal the batch
    speculative sampler's row for row."""
    _, t = _setup(seed=30)
    embs = _embs(13, seed=31)
    draft = quantize_llama(t[1], bits=4)
    want = _batch_spec(t, embs, budget, k, draft, sample, seed=9)
    got = _bulk(t, embs, budget, chunk, pool, k, draft, sample=sample, seed=9)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pool,admit,rounds,k,budget", [(5, 2, 2, 3, 7), (9, 4, 1, 2, 5)])
def test_online_engine_equals_the_batch_paths(pool, admit, rounds, k, budget):
    """The host-loop engine (admission and harvest around runs of rounds,
    the scratch slot taking padded rows): greedy with the W4A8 draft equals
    the batch speculative path, sampled equals the batch sampler."""
    _, t = _setup(seed=33)
    tcfg, tparams, tspec_, tpp = t
    embs = _embs(17, seed=34)
    draft = quantize_llama(tparams, bits=4)
    for sample in (None, (1.2, 8, 1.0)):
        eng = tspec.SpeculativeStreamingCaptioner(
            tcfg, tparams, tcfg, draft, tspec_, tpp, PREFIX, budget, PAD, pool=pool,
            admit=admit, rounds=rounds, k=k, draft_prefill_params=tparams, share_prefill=True,
            seed=13, **({} if sample is None else dict(zip(("temperature", "top_k", "top_p"),
                                                            sample))))
        got = eng.run(embs)
        assert torch.equal(got, _batch_spec(t, embs, budget, k, draft, sample, seed=13))
        assert not eng._occupied[: eng.scratch].any() and eng.dispatches > 0


def test_engine_guards():
    _, t = _setup(seed=27)
    tcfg, tparams, tspec_, tpp = t
    embs = _embs(4, seed=1)
    for kw, match in ((dict(chunk=5, pool=4, k=2, budget=6), "chunk"),
                      (dict(chunk=2, pool=4, k=2, budget=1), "budget"),
                      (dict(chunk=2, pool=4, k=0, budget=6), "k >= 1")):
        with pytest.raises(ValueError, match=match):
            _bulk(t, embs, kw["budget"], kw["chunk"], kw["pool"], kw["k"], tparams)
    with pytest.raises(ValueError, match="sharded"):  # a mesh takes sharded trees
        _bulk(t, embs, 6, 2, 4, 2, tparams, mesh=object())
    for kw, match in ((dict(pool=1), "pool"), (dict(pool=4, admit=4), "admit")):
        with pytest.raises(ValueError, match=match):
            tspec.SpeculativeStreamingCaptioner(tcfg, tparams, tcfg, tparams, tspec_, tpp, PREFIX,
                                                6, PAD, k=2, **kw)
    with pytest.raises(ValueError, match="sharded"):
        tspec.SpeculativeStreamingCaptioner(tcfg, tparams, tcfg, tparams, tspec_, tpp, PREFIX, 6,
                                            PAD, mesh=object())
    mla = dataclasses.replace(tcfg, kv_lora_rank=8)
    with pytest.raises(NotImplementedError, match="MLA"):
        tspec.SpeculativeStreamingCaptioner(mla, tparams, mla, tparams, tspec_, tpp, PREFIX, 6,
                                            PAD)


# --- serving ----------------------------------------------------------------

PROMPT = "Describe the satellite image"


@pytest.fixture(scope="module")
def captioners():
    """dmi_tpu's and the port's Captioner(speculative=2) on the tokenizer
    fixture: shared f32 weights (std 0.2 layers), batch 4, budget 10."""
    tok = build_test_tokenizer()
    jcfg = jllama.tiny_config(vocab_size=len(tok) + 8, hidden_size=64, n_layers=2, n_heads=4,
                              n_kv=2, intermediate=128, eos=(tok.eos_token_id,))
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(0), jcfg))
    tree["layers"] = {k: v * 10.0 if k.startswith("w") else v for k, v in tree["layers"].items()}
    spec = jproj.ProjectorSpec(mm_dim=32, lm_dim=64)
    jpp = jproj.init(jax.random.key(1), spec)
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    tcfg, tparams = bridge.config_from_jax(jcfg), bridge.llm_params_from_jax(tree)
    jcap = JaxCaptioner(jcfg, jax.tree.map(jnp.asarray, tree), spec, jpp, tok, PROMPT, 10,
                        batch_size=4, speculative=2)
    tcap = Captioner(tcfg, tparams, tproj.ProjectorSpec(mm_dim=32, lm_dim=64), tpp, tok, PROMPT,
                     10, batch_size=4, speculative=2)
    plain = Captioner(tcfg, tparams, tproj.ProjectorSpec(mm_dim=32, lm_dim=64), tpp, tok, PROMPT,
                      10, batch_size=4)
    return jcap, tcap, plain


def test_speculative_captioner_matches_dmi_tpu(captioners):
    """N = 10 through batch 4 (the tail padded): the port's speculative
    captions on the batch and bulk engines and its plain captions equal
    dmi_tpu's Captioner(speculative=2) on the batch engine; the rounds are
    counted and the engine decisions are dmi_tpu's."""
    jcap, tcap, plain = captioners
    embs = np.random.default_rng(3).normal(size=(10, 32)).astype(np.float32)
    ref = jcap.caption(embs, engine="batch")
    assert tcap.caption(embs, engine="batch") == ref
    assert 0 < tcap.spec_rounds <= 3 * 9
    assert tcap.caption(embs, engine="bulk") == ref
    assert tcap.engine_decision == ("bulk", "explicit (speculative)")
    assert tcap.caption(embs) == ref  # auto stays on the batch engine
    assert tcap.engine_decision == ("batch", "explicit")
    assert plain.caption(embs) == ref


def test_speculative_captioner_samples_on_both_engines(captioners):
    """Sampled: the batch and bulk engines give the same ids (request-keyed
    draws); they are the batch speculative sampler's, with the W4A8 draft."""
    _, tcap, _ = captioners
    embs = np.random.default_rng(4).normal(size=(7, 32)).astype(np.float32)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95, seed=4)
    batch = tcap.caption_ids(embs, engine="batch", **kw)
    assert torch.equal(tcap.caption_ids(embs, engine="bulk", **kw), batch)
    assert batch.shape == (7, 10)


def test_speculative_captioner_refuses_mla(captioners):
    """An MLA model is refused at its first batch, with dmi_tpu's reason."""
    _, tcap, _ = captioners
    mla = Captioner(dataclasses.replace(tcap.llm_cfg, kv_lora_rank=8), tcap.llm_params,
                    tcap.proj_spec, tcap.proj_params, tcap.tokenizer, PROMPT, 10, batch_size=4,
                    speculative=2)
    with pytest.raises(NotImplementedError, match="does not support MLA"):
        mla.caption_ids(np.zeros((2, 32), np.float32))


def test_serve_cli_takes_speculative(tmp_path):
    """--speculative 2 on the batch and bulk engines: every caption written,
    the engine decision printed."""
    pparams = jproj.init(jax.random.key(2), jproj.ProjectorSpec(mm_dim=32, lm_dim=64))
    path = str(tmp_path / "proj-checkpoint-projector-best.pt")
    save_pytree(path, {"step_idx": 3, "projector_state_dict": pparams})
    np.save(tmp_path / "embs.npy", np.random.default_rng(1).normal(size=(5, 32)).astype(
        np.float32))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for engine, decision in (("batch", "batch (explicit)"), ("bulk", "bulk (explicit (speculative))")):
        r = subprocess.run(
            [sys.executable, "-m", "dmi_tpu_torch.serve", "--lm", "test:tiny",
             "--projector-ckpt", path, "--dataset", "sydney", "--embs", "embs.npy",
             "--out", f"{engine}.json", "--batch-size", "4", "--device", "cpu",
             "--speculative", "2", "--engine", engine],
            cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert f"engine: {decision}" in r.stdout
        caps = json.loads((tmp_path / f"{engine}.json").read_text())
        assert sorted(caps) == ["0", "1", "2", "3", "4"]
