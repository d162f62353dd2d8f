"""dmi_tpu_torch's batch-last serving path against dmi_tpu's, on shared
weights carried over the bridge.

At f32 on the CPU: the batch-last helpers and one decode step's logits match
JAX's (1e-5 relative: summation order only); greedy_generate_bl emits the
tokens of dmi_tpu's greedy_generate_bl for unquantized, "q", "q8", W4A8 and
grouped-W4A8 trees (the integer payloads are bit-equal and the integer
products exact, so the logits differ by f32 summation order only); the
batch-last loop equals the batch-first loop inside the port; the fused head
equals logits + argmax; and Captioner(int8=...) returns the caption strings
dmi_tpu.serve.Captioner returns.
"""

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
from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import projector as jproj
from dmi_tpu.models import quant as jq
from dmi_tpu.serve import Captioner as JaxCaptioner
from dmi_tpu.training.checkpoint import save_pytree
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.models import mmmodel as tmm
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.models import quant as tq
from dmi_tpu_torch.ops.cuda import head_argmax as tha
from dmi_tpu_torch.serve import Captioner

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PREFIX = "Describe the satellite image"
# dmi_tpu.models.quant.quantize_llama arguments of each weight kind
TREES = {"dense": None, "q": {}, "q8": {"native": True}, "w4a8": {"bits": 4},
         "w4a8-grouped": {"bits": 4, "group_size": 16}}


def _models(eos=(), vocab=96, seed=0, fused=True, dtype=None):
    """Tiny model with the layers' weights scaled from init's std 0.02 to 0.2
    (varied greedy tokens), in both packages."""
    jcfg = jllama.tiny_config(vocab_size=vocab, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
                              intermediate=128, eos=eos,
                              **({} if dtype is None else {"dtype": dtype}))
    jparams = jllama.init(jax.random.key(seed), jcfg)
    jparams["layers"] = {k: (v * 10.0).astype(v.dtype) if k.startswith("w") else v
                         for k, v in jparams["layers"].items()}
    if fused:
        jparams = jllama.fuse_projections(jparams)
    return jcfg, jparams, bridge.config_from_jax(jcfg)


def _to_torch(jparams):
    return bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))


def _close(t, j, tol=1e-5):
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape
    assert np.abs(t.numpy() - j).max() <= tol * max(1.0, np.abs(j).max())


def test_batch_last_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 16, 5)).astype(np.float32)
    cos, sin = (rng.normal(size=(16,)).astype(np.float32) for _ in range(2))
    _close(tdec._rotate_half_rows(torch.from_numpy(x)), jdec._rotate_half_rows(jnp.asarray(x)), 0)
    _close(tdec._rope_bl(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin)),
           jdec._rope_bl(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)), 1e-6)
    cos2, sin2 = (rng.normal(size=(16, 5)).astype(np.float32) for _ in range(2))  # per slot
    _close(tdec._rope_bl(torch.from_numpy(x), torch.from_numpy(cos2), torch.from_numpy(sin2)),
           jdec._rope_bl(jnp.asarray(x), jnp.asarray(cos2), jnp.asarray(sin2)), 1e-6)
    h = rng.normal(size=(64, 7)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    _close(tdec._rms_norm_bl(torch.from_numpy(h), torch.from_numpy(scale), 1e-5),
           jdec._rms_norm_bl(jnp.asarray(h), jnp.asarray(scale), 1e-5), 1e-6)


@pytest.mark.parametrize("bias_kind", ["shared", "per-slot"])
@pytest.mark.parametrize("softcap", [None, 2.0])
def test_decode_attention_bl_matches_jax(bias_kind, softcap):
    rng = np.random.default_rng(1)
    nkv, g, hd, S, B = 2, 3, 16, 11, 5
    q = rng.normal(size=(nkv, g, hd, B)).astype(np.float32)
    kc, vc = (rng.normal(size=(nkv, S, hd, B)).astype(np.float32) for _ in range(2))
    neg = np.finfo(np.float32).min
    if bias_kind == "shared":
        bias = np.where(np.arange(S) <= 7, 0.0, neg).astype(np.float32)
    else:
        bias = np.where(np.arange(S)[:, None] <= rng.integers(3, S, size=B)[None], 0.0,
                        neg).astype(np.float32)
    want = jdec._decode_attention_bl(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(bias), 0.3, softcap)
    got = tdec._decode_attention_bl(*(torch.from_numpy(a) for a in (q, kc, vc, bias)), 0.3,
                                    softcap)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused-layout", "unfused-layout"])
@pytest.mark.parametrize("tree", ["dense", "q8", "w4a8-grouped"])
def test_decode_step_bl_logits_match_jax(tree, fused):
    """One step after a shared prefill: logits [V, B] with head=True, and the
    final norm's output [H, B] with head=False."""
    jcfg, jparams, tcfg = _models(fused=fused)
    if TREES[tree] is not None:
        jparams = jq.quantize_llama(jparams, **TREES[tree])
    tparams = _to_torch(jparams)
    B, T, total = 4, 5, 9
    embeds = np.random.default_rng(2).normal(size=(B, T, 64)).astype(np.float32)

    jcaches = jdec.init_cache(jcfg, B, total)
    jlogits0, jcaches = jdec.prefill(jcfg, jparams, jnp.asarray(embeds), jcaches)
    kv = jnp.stack([jcaches[0].transpose(0, 2, 3, 4, 1), jcaches[1].transpose(0, 2, 3, 4, 1)],
                   axis=1)
    tok = jnp.argmax(jlogits0, axis=-1)
    jh = jllama.embed_tokens(jcfg, jparams, tok).T.astype(jcfg.dtype)
    bias = jnp.where(jnp.arange(total) <= T, 0.0, jnp.finfo(jnp.float32).min)
    jlogits, _ = jdec._decode_step_bl(jcfg, jparams, jh, kv, jnp.asarray(T), bias)
    jfin, _ = jdec._decode_step_bl(jcfg, jparams, jh, kv, jnp.asarray(T), bias, head=False)

    with torch.no_grad():
        tcaches = tdec.init_cache(tcfg, B, total)
        tlogits0 = tdec.prefill(tcfg, tparams, torch.from_numpy(embeds), tcaches)
        _close(tlogits0, jlogits0)
        th = tllama.embed_tokens(tcfg, tparams, tlogits0.argmax(-1)).t().contiguous()
        _close(th, jh, 0)
        fresh = lambda: (tcaches[0].clone(), tcaches[1].clone())  # noqa: E731
        tlogits = tdec._decode_step_bl(tcfg, tparams, th, fresh(), T)
        tfin = tdec._decode_step_bl(tcfg, tparams, th, fresh(), T, head=False)
        tplain = tdec._decode_step_bl(tcfg, tparams, th, fresh(), T, plain=True)
    assert tuple(tlogits.shape) == (96, B) and tuple(tfin.shape) == (64, B)
    _close(tlogits, jlogits)
    _close(tfin, jfin)
    _close(tplain, jlogits)


def _greedy(jcfg, jparams, tcfg, embeds, max_new, j_prefill=None, **kw):
    tparams = _to_torch(jparams)
    t_prefill = None if j_prefill is None else _to_torch(j_prefill)
    want = np.asarray(jdec.greedy_generate_bl(jcfg, jparams, jnp.asarray(embeds), max_new, 1,
                                              prefill_params=j_prefill))
    got = tdec.greedy_generate_bl(tcfg, tparams, torch.from_numpy(embeds), max_new, 1,
                                  prefill_params=t_prefill, **kw)
    assert got.dtype == torch.long and tuple(got.shape) == (embeds.shape[0], max_new)
    return want, got.numpy(), tparams


@pytest.mark.parametrize("tree", list(TREES))
def test_greedy_generate_bl_tokens_identical_to_jax(tree):
    jcfg, jparams, tcfg = _models()
    if TREES[tree] is not None:
        jparams = jq.quantize_llama(jparams, **TREES[tree])
    embeds = np.random.default_rng(0).normal(size=(5, 6, 64)).astype(np.float32)
    want, got, tparams = _greedy(jcfg, jparams, tcfg, embeds, 9)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) > 1 and len(set(got[0])) > 2  # varied tokens
    # batch-last = batch-first inside the port, and the plain path
    emb = torch.from_numpy(embeds)
    np.testing.assert_array_equal(tdec.greedy_generate(tcfg, tparams, emb, 9, 1).numpy(), got)
    np.testing.assert_array_equal(
        tdec.greedy_generate_bl(tcfg, tparams, emb, 9, 1, plain=True).numpy(), got)


@pytest.mark.parametrize("tree", ["q8", "w4a8"])
def test_greedy_generate_bl_with_prefill_params_identical_to_jax(tree):
    """The serving layer's split: the prompt pass on the unquantized
    originals, the token loop on the quantized tree."""
    jcfg, jdense, tcfg = _models(seed=1)
    jquant = jq.quantize_llama(jdense, **TREES[tree])
    embeds = np.random.default_rng(1).normal(size=(4, 7, 64)).astype(np.float32)
    want, got, _ = _greedy(jcfg, jquant, tcfg, embeds, 8, j_prefill=jdense)
    np.testing.assert_array_equal(got, want)
    alone, _, _ = _greedy(jcfg, jquant, tcfg, embeds, 8)
    assert not np.array_equal(alone[:, 0], want[:, 0]) or not np.array_equal(alone, want)


def test_greedy_generate_bl_eos_mid_budget_and_small_budgets():
    jcfg, jparams, tcfg = _models()
    embeds = np.random.default_rng(1).normal(size=(6, 5, 64)).astype(np.float32)
    free = np.asarray(jdec.greedy_generate_bl(jcfg, jparams, jnp.asarray(embeds), 10, 1))
    row = next(r for r in range(len(free)) if free[r, 3] not in free[r, :3])
    eos = int(free[row, 3])
    assert eos != 1  # the pad id
    jcfg, jparams, tcfg = _models(eos=(eos,))
    want, got, _ = _greedy(jcfg, jparams, tcfg, embeds, 10)
    np.testing.assert_array_equal(got, want)
    assert got[row, 3] == eos and (got[row, 4:] == 1).all()
    for max_new in (0, 1, 2):
        want, got, _ = _greedy(jcfg, jparams, tcfg, embeds, max_new)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tree", ["dense", "q", "q8"])
def test_fused_head_on_equals_off_at_bf16(tree):
    """A bf16 model resolves fused_head to on; forced off it takes logits +
    argmax: the same tokens, the fused twin being those logits' argmax."""
    jcfg, jparams, tcfg = _models(dtype=jnp.bfloat16)
    assert tcfg.dtype == torch.bfloat16
    if TREES[tree] is not None:
        jparams = jq.quantize_llama(jparams, **TREES[tree])
    tparams = _to_torch(jparams)
    embeds = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 5, 64)).astype(np.float32))
    calls = []
    real = tha.head_argmax

    def spy(params, h):
        calls.append(tuple(h.shape))
        return real(params, h)

    try:
        tdec.head_argmax = spy
        auto = tdec.greedy_generate_bl(tcfg, tparams, embeds, 7, 1)
        assert calls == [(64, 4)] * 6
        off = tdec.greedy_generate_bl(tcfg, tparams, embeds, 7, 1, fused_head=False)
        assert len(calls) == 6
        on = tdec.greedy_generate_bl(tcfg, tparams, embeds, 7, 1, fused_head=True)
    finally:
        tdec.head_argmax = real
    assert torch.equal(auto, off) and torch.equal(auto, on)


def test_f32_model_takes_the_logits_path_and_refuses_a_forced_fused_head():
    jcfg, jparams, tcfg = _models()
    tparams = _to_torch(jparams)
    embeds = torch.zeros(2, 3, 64)
    with pytest.raises(TypeError, match="bf16"):
        tdec.greedy_generate_bl(tcfg, tparams, embeds, 3, 1, fused_head=True)
    assert tuple(tdec.greedy_generate_bl(tcfg, tparams, embeds, 3, 1).shape) == (2, 3)


def test_caption_generate_defaults_to_batch_last_and_splits_prefill(monkeypatch):
    jcfg, jdense, tcfg = _models(seed=2)
    tdense = _to_torch(jdense)
    tquant = tq.quantize_llama(tdense, bits=4)
    soft = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 64)).astype(np.float32))
    prefix = torch.tensor([[3, 9, 27]] * 3)
    seen = {}
    real_bl, real_bf = tdec.greedy_generate_bl, tdec.greedy_generate

    def spy_bl(cfg, params, embeds, *a, **kw):
        seen["bl"] = (params, embeds, kw.get("prefill_params"))
        return real_bl(cfg, params, embeds, *a, **kw)

    def spy_bf(cfg, params, embeds, *a, **kw):
        seen["bf"] = (params, embeds)
        return real_bf(cfg, params, embeds, *a, **kw)

    monkeypatch.setattr(tdec, "greedy_generate_bl", spy_bl)
    monkeypatch.setattr(tdec, "greedy_generate", spy_bf)
    out = tmm.caption_generate(tcfg, tquant, soft, prefix, 5, 1, prefill_params=tdense)
    assert "bf" not in seen and seen["bl"][0] is tquant and seen["bl"][2] is tdense
    # the prompt's embedding rows come from the prefill weights
    assert torch.equal(seen["bl"][1][:, 1:], tdense["embed"][prefix])
    want = jdec.greedy_generate_bl(
        jcfg, jq.quantize_llama(jdense, bits=4), jnp.asarray(seen["bl"][1].numpy()), 5, 1,
        prefill_params=jdense)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # batch_first pins the batch-first loop, wholly on llm_params
    tmm.caption_generate(tcfg, tquant, soft, prefix, 5, 1, prefill_params=tdense,
                         batch_first=True)
    assert seen["bf"][0] is tquant
    assert torch.equal(seen["bf"][1][:, 1:], tllama.embed_tokens(tcfg, tquant, prefix))


@pytest.fixture(scope="module")
def tokenizer():
    return build_test_tokenizer()


def _captioners(tokenizer, int8, max_new=10, batch_size=4, mm=32, **kw):
    jcfg = jllama.tiny_config(vocab_size=len(tokenizer) + 8, hidden_size=64, n_layers=2,
                              n_heads=4, n_kv=2, intermediate=128,
                              eos=(tokenizer.eos_token_id,))
    jparams = jllama.init(jax.random.key(0), jcfg)
    jparams["layers"] = {k: v * 10.0 if k.startswith("w") else v
                         for k, v in jparams["layers"].items()}
    tparams = _to_torch(jparams)
    spec = jproj.ProjectorSpec(mm_dim=mm, lm_dim=64)
    jpp = jproj.init(jax.random.key(1), spec)
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    jcap = JaxCaptioner(jcfg, jparams, spec, jpp, tokenizer, PREFIX, max_new,
                        batch_size=batch_size, int8=int8)
    tcap = Captioner(bridge.config_from_jax(jcfg), tparams, tproj.ProjectorSpec(mm_dim=mm,
                                                                                lm_dim=64),
                     tpp, tokenizer, PREFIX, max_new, batch_size=batch_size, int8=int8, **kw)
    return jcap, tcap


@pytest.mark.parametrize("int8", [False, True, "w8a8", "w4a8"], ids=["bf", "int8", "w8a8", "w4a8"])
def test_captioner_int8_matches_dmi_tpu_captioner(tokenizer, int8):
    """N = 10 through batch 4 (the tail batch is padded), every int8 mode:
    the caption strings of dmi_tpu.serve.Captioner."""
    jcap, tcap = _captioners(tokenizer, int8)
    embs = np.random.default_rng(3).normal(size=(10, 32)).astype(np.float32)
    ref = jcap.caption(embs, engine="batch")
    out = tcap.caption(embs)
    assert len(out) == 10 and out == ref
    # the trees: quantized as dmi_tpu's, the originals kept for w8a8/w4a8 only
    lw = tcap.llm_params["layers"][0]
    key = {False: None, True: "q", "w8a8": "q8", "w4a8": "qp"}[int8]
    assert all(isinstance(lw[n], dict) == (key is not None) for n in ("w_qkv", "wo", "w_gu",
                                                                      "w_down"))
    if key is not None:
        assert key in lw["w_gu"] and ("q8" if int8 != True else "q") in tcap.llm_params["embed"]  # noqa: E712
    assert (tcap.llm_params_prefill is not None) == (int8 in ("w8a8", "w4a8"))
    assert (jcap.llm_params_prefill is not None) == (tcap.llm_params_prefill is not None)
    # the batch-first loop gives the same ids
    first = _captioners(tokenizer, int8, batch_first=True)[1]
    if int8 in (False, True):  # one tree for prefill and loop: token-identical
        assert torch.equal(first.caption_ids(embs), tcap.caption_ids(embs))
    else:  # the batch-first loop prefills on the quantized tree: only shapes are held
        assert tuple(first.caption_ids(embs).shape) == (10, 10)


def test_captioner_refuses_an_unknown_int8_mode(tokenizer):
    with pytest.raises(ValueError, match="int8"):
        _captioners(tokenizer, "w2a8")


def test_serve_cli_int8_on_the_cpu(tmp_path):
    pparams = jproj.init(jax.random.key(2), jproj.ProjectorSpec(mm_dim=32, lm_dim=64))
    ckpt = str(tmp_path / "proj-checkpoint-projector-best.pt")
    save_pytree(ckpt, {"step_idx": 0, "projector_state_dict": pparams,
                       "optimizer_state_dict": None, "coco_cider": 0.0})
    np.save(tmp_path / "embs.npy",
            np.random.default_rng(1).normal(size=(5, 32)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    outs = {}
    for flag in (["--int8"], ["--int8", "w4a8"]):
        name = f"captions{len(outs)}.json"
        r = subprocess.run(
            [sys.executable, "-m", "dmi_tpu_torch.serve", "--lm", "test:tiny",
             "--projector-ckpt", ckpt, "--dataset", "sydney", "--embs", "embs.npy",
             "--out", name, "--batch-size", "4", "--device", "cpu", *flag],
            cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        outs[tuple(flag)] = json.loads((tmp_path / name).read_text())
    assert all(sorted(c) == ["0", "1", "2", "3", "4"] for c in outs.values())
    r = subprocess.run(
        [sys.executable, "-m", "dmi_tpu_torch.serve", "--lm", "test:tiny", "--projector-ckpt",
         ckpt, "--dataset", "sydney", "--embs", "embs.npy", "--int8", "w2a8", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode != 0 and "invalid choice" in r.stderr
