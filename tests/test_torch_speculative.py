"""dmi_tpu_torch's speculative decoding (models/speculative.py) against
dmi_tpu's, greedy, on shared weights at f32 on the CPU.

Held here: decode attention over P query positions per cache row (K3's
twins) against dmi_tpu's vmap of _decode_attention_bl over the k + 1
queries with an [S, P, B] bias; the verify forward's logits and written
cache rows against dmi_tpu's _verify_step_bl on the same caches, over every
family branch and a w8a8 and a w4a8 tree; the row bookkeeping's biases; the
greedy tokens and round counts against dmi_tpu's speculative_generate_bl and
speculative_generate_oracle_bl and against the port's plain greedy loop,
for oracle, random, self and W4A8 self-drafts (share_prefill), EOS at
staggered ages and budgets 0-2; the MLA refusal; the forced harness's
chain and closed-form rounds against dmi_tpu's, and the two faults of
dmi_tpu's harness the port does not copy.  Sampling is
tests/test_torch_speculative_sample.py, the engines and the Captioner
tests/test_torch_speculative_bulk.py, the kernel on the card
tests/test_torch_cuda.py.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import quant as jq
from dmi_tpu.models import speculative as jspec
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import speculative as tspec
from dmi_tpu_torch.ops.cuda import decode_attn as tda

torch.set_num_threads(1)

PAD = 0
NEG = float(np.finfo(np.float32).min)
TINY = dict(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4, n_kv=2, intermediate=64)


def _jcfg(family="llama", eos=(5,), tiny=None, **changes):
    kw = dict(TINY, eos=eos, **(tiny or {}))
    cfg = {
        "llama": lambda: jllama.tiny_config(**kw),
        "qwen3": lambda: jllama.tiny_qwen3_config(**kw),
        "olmo2": lambda: jllama.tiny_olmo2_config(**kw),
        "granite": lambda: jllama.tiny_granite_config(**kw),
        "gemma2": lambda: jllama.tiny_gemma2_config(sliding_window=4, **kw),
        "gemma3": lambda: jllama.tiny_gemma3_config(sliding_window=4, **kw),
        "mixtral": lambda: jllama.tiny_mixtral_config(**kw),
        "olmoe": lambda: jllama.tiny_olmoe_config(**kw),
        "deepseek": lambda: jllama.tiny_deepseek_config(**kw),
    }[family]()
    return dataclasses.replace(cfg, **changes)


def _models(family="llama", seed=0, eos=(5,), quant=None, tiny=None, **changes):
    """(jcfg, jparams, tcfg, tparams): dmi_tpu's init with the layer weights
    scaled from std 0.02 to 0.2 (varied greedy tokens) and the norms
    perturbed, in both packages; quant "w8a8" / "w4a8" quantizes the tree
    with dmi_tpu's quantize_llama before the bridge."""
    jcfg = _jcfg(family, eos, tiny, **changes)
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(name, a):
        if name.startswith(("w", "b", "moe")):
            return (a * 10.0).astype(a.dtype)
        if "norm" in name or name.startswith("ln"):
            return (a * (1 + 0.3 * rng.normal(size=a.shape))).astype(a.dtype)
        return a

    tree["layers"] = {k: perturb(k, v) for k, v in tree["layers"].items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    if quant is not None:
        jparams = jq.quantize_llama(jparams, native=True) if quant == "w8a8" else \
            jq.quantize_llama(jparams, bits=4)
    tparams = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_jax(jcfg), tparams


def _prompt(B, T, H=32, seed=0):
    return (np.random.default_rng(seed).normal(size=(B, T, H)) / np.sqrt(H)).astype(np.float32)


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


# --- K3: decode attention over P query positions per cache row -------------

def _k3_case(B, nh, nkv, P, S, hd=16, masked_row=False, seed=0):
    """q [B, nh, P, hd], caches, and a [B, P, S] causal-looking bias: each
    position sees a prefix of the keys that grows with p, some keys of each
    row masked; with masked_row, row 0 position 0 masked everywhere."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, nh, P, hd)).astype(np.float32)
    k = rng.normal(size=(B, nkv, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, nkv, S, hd)).astype(np.float32)
    bias = np.full((B, P, S), NEG, np.float32)
    for b in range(B):
        keep = rng.random(S) < 0.8
        for p in range(P):
            n = S - P + 1 + p
            bias[b, p, :n] = np.where(keep[:n], 0.0, NEG)
            bias[b, p, 0] = 0.0
    if masked_row:
        bias[0, 0] = NEG
    return q, k, v, bias


def _k3_ref(q, k, v, bias, softcap=None):
    """dmi_tpu's verify attention: a vmap of _decode_attention_bl over the P
    queries (dmi_tpu/models/speculative.py:142-145), batch-last."""
    B, nh, P, hd = q.shape
    nkv = k.shape[1]
    attend = jax.vmap(partial(jdec._decode_attention_bl, softcap=softcap),
                      in_axes=(3, None, None, 1), out_axes=3)
    qb = jnp.asarray(q).reshape(B, nkv, nh // nkv, P, hd).transpose(1, 2, 4, 3, 0)
    kb, vb = (jnp.asarray(a).transpose(1, 2, 3, 0) for a in (k, v))  # [nkv, S, hd, B]
    out = attend(qb, kb, vb, jnp.asarray(bias).transpose(2, 1, 0))  # [nkv, g, hd, P, B]
    return np.asarray(out).transpose(4, 0, 1, 3, 2).reshape(B, nh, P, hd)


@pytest.mark.parametrize("nh,nkv,P,softcap,masked_row", [
    (8, 2, 4, None, False),   # group 4
    (4, 4, 5, None, True),    # group 1, a fully masked position
    (8, 2, 2, 2.0, False),    # a softcap that binds
])
def test_k3_twin_matches_dmi_tpu_vmap(nh, nkv, P, softcap, masked_row):
    """_decode_attn_plain and the CPU wrapper with P positions against
    dmi_tpu's vmap of _decode_attention_bl with an [S, P, B] bias, 1e-6
    relative; a fully masked position gives the average of its V rows."""
    q, k, v, bias = _k3_case(3, nh, nkv, P, 19, masked_row=masked_row)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out = tda._decode_attn_plain(*args, None, softcap)
    _close(out, _k3_ref(q, k, v, bias, softcap), 1e-6)
    assert torch.equal(tda.fused_decode_attention(*args, None, softcap), out)
    if masked_row:
        mean_v = v[0].mean(axis=1)  # [nkv, hd]: group 1, head h reads kv head h
        _close(out[0, :, 0], mean_v, 1e-6)


@pytest.mark.parametrize("P", [1, 3])
def test_k3_split_twin_matches_dmi_tpu(P):
    """_decode_attn_split_plain (the kernel's splits and in-order merge) with
    P positions, one split of a row's positions all masked: the same
    function, finite; and P = 1 is the single-token twin's call as before."""
    q, k, v, bias = _k3_case(2, 8, 2, P, 100, seed=3)
    bias[1, :, 40:80] = NEG
    p = {**tda.plan(2 * P, 2, 4, 100, 16, 4), "keys_per_split": 40, "splits": 3, "chunk": 16}
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out = tda._decode_attn_split_plain(*args, p)
    assert bool(torch.isfinite(out).all())
    _close(out, _k3_ref(q, k, v, bias), 1e-6)
    _close(out, tda._decode_attn_plain(*args), 1e-6)
    if P == 1:  # [B, 1, S] and [B, S] are one call
        flat = [args[0], args[1], args[2], args[3][:, 0]]
        assert torch.equal(tda._decode_attn_plain(*flat), tda._decode_attn_plain(*args))


def test_k3_wrapper_refuses_a_shared_row_at_p_over_1():
    """P > 1 takes [B, P, S] only: a shared [S] row or a [B, S] row per
    cache row would let every position see the same keys."""
    q, k, v, bias = (torch.from_numpy(a) for a in _k3_case(2, 8, 2, 3, 10))
    for bad in (bias[0, 0], bias[:, 0], bias[:, :2]):
        with pytest.raises(ValueError, match="decode attention shapes"):
            tda.fused_decode_attention(q, k, v, bad)


# --- the verify forward -----------------------------------------------------

VERIFY = ["llama", "qwen3", "olmo2", "granite", "gemma2", "gemma3", "mixtral", "olmoe",
          "w8a8", "w4a8"]


def _verify_state(B, T, k, S, seed):
    """Round 1's bookkeeping after a round 0 that accepted n_acc0 [B]
    proposals, in dmi_tpu's [S, B] layout: (valid, row_pos, qpos [P, B],
    live)."""
    rng = np.random.default_rng(seed)
    P = k + 1
    n_acc0 = rng.integers(0, k + 1, size=B)
    valid = np.zeros((S, B), bool)
    valid[:T] = True
    row_pos = np.broadcast_to(np.minimum(np.arange(S), T - 1)[:, None], (S, B)).copy()
    for b in range(B):
        valid[T:T + 1 + n_acc0[b], b] = True
        row_pos[T:T + P, b] = T + np.arange(P)
    qpos = (T + n_acc0 + 1)[None, :] + np.arange(P)[:, None]
    live = np.ones(B, bool)
    live[-1] = False  # a finished slot
    return valid, row_pos, qpos.astype(np.int32), live


@pytest.mark.parametrize("case", VERIFY)
def test_verify_step_matches_dmi_tpu(case):
    """_verify_step_bl's logits [V, P, B] (1e-5 relative) and the cache rows
    it writes against dmi_tpu's on the same caches, the biases from both
    packages' _stamp_rows / _bias_from (gemma-2's window binds: 4 < S)."""
    family, quant = (("llama", case) if case in ("w8a8", "w4a8") else (case, None))
    jcfg, jparams, tcfg, tparams = _models(family, seed=7, quant=quant)
    B, T, k = 3, 4, 3
    P, S = k + 1, 4 + 4 * 3
    rt = T + P
    L, nkv, hd, H = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim, 32
    rng = np.random.default_rng(11)
    kc, vc = (rng.normal(size=(L, B, nkv, S, hd)).astype(np.float32) for _ in range(2))
    h = (rng.normal(size=(H, P, B)) / np.sqrt(H)).astype(np.float32)
    valid, row_pos, qpos, live = _verify_state(B, T, k, S, seed=12)
    sliding_on = jllama.sliding_effective(jcfg, S)
    assert sliding_on == (family in ("gemma2", "gemma3"))

    jv, jrp = jspec._stamp_rows(jnp.asarray(valid), jnp.asarray(row_pos), rt, P,
                                jnp.asarray(live), jnp.asarray(qpos))
    jb, jb_sw = jspec._bias_from(jv, jrp, jnp.asarray(qpos), jcfg, sliding_on)
    kv = jnp.stack([jnp.asarray(kc).transpose(0, 2, 3, 4, 1),
                    jnp.asarray(vc).transpose(0, 2, 3, 4, 1)], axis=1)
    jlogits, jkv = jspec._verify_step_bl(jcfg, jparams, jnp.asarray(h), kv, jnp.asarray(qpos),
                                         jb, rt, bias_sw=jb_sw)

    tv, trp = torch.from_numpy(valid.T.copy()), torch.from_numpy(row_pos.T.astype(np.int64))
    tq = torch.from_numpy(qpos.astype(np.int64))
    tspec._stamp_rows(tv, trp, rt, P, torch.from_numpy(live), tq.t())
    tb, tb_sw = tspec._bias_from(tv, trp, tq, tcfg, sliding_on)
    # the kernel reads the bias rows contiguously (its wrapper refuses others)
    assert tb.is_contiguous() and (tb_sw is None or tb_sw.is_contiguous())
    assert np.array_equal(tb.numpy(), np.asarray(jb).transpose(2, 1, 0))
    if sliding_on:
        assert np.array_equal(tb_sw.numpy(), np.asarray(jb_sw).transpose(2, 1, 0))
    caches = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    logits = tspec._verify_step_bl(tcfg, tparams, torch.from_numpy(h.reshape(H, P * B)), caches,
                                   tq, tb, rt, tb_sw)
    _close(logits.reshape(-1, P, B), jlogits, 1e-5)
    jkv = np.asarray(jkv)
    _close(caches[0].numpy(), jkv[:, 0].transpose(0, 4, 1, 2, 3), 1e-5)
    _close(caches[1].numpy(), jkv[:, 1].transpose(0, 4, 1, 2, 3), 1e-5)
    # the step at P = 1 is the engine's: the verify forward's lanes of one
    # position equal a single-token step with that position's bias row
    caches1 = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    one = tspec._verify_step_bl(tcfg, tparams, torch.from_numpy(h[:, 0].copy()), caches1,
                                tq[:1], tb[:, 0], rt, None if tb_sw is None else tb_sw[:, 0])
    _close(one, logits[:, :B], 1e-5)


def test_verify_step_refuses_a_bias_of_another_shape():
    _, _, tcfg, tparams = _models()
    B, P, S = 2, 3, 10
    caches = tdec.init_cache(tcfg, B, S)
    h = torch.zeros(32, P * B)
    qpos = torch.arange(P)[:, None].expand(P, B) + 4
    with pytest.raises(ValueError, match="per-slot bias"):
        tspec._verify_step_bl(tcfg, tparams, h, caches, qpos, torch.zeros(B, S), 4)


# --- greedy: tokens and rounds ---------------------------------------------

def _greedy(jcfg, jparams, tcfg, tparams, embeds, budget):
    """dmi_tpu's and the port's plain batch-last greedy ids."""
    j = np.asarray(jdec.greedy_generate_bl(jcfg, jparams, jnp.asarray(embeds), budget, PAD))
    t = tdec.greedy_generate_bl(tcfg, tparams, torch.from_numpy(embeds), budget, PAD).numpy()
    np.testing.assert_array_equal(t, j)
    return j


@pytest.mark.parametrize("wrong_period", [0, 1, 2, 3])
def test_oracle_tokens_and_rounds_equal_dmi_tpu(wrong_period):
    """The oracle draft at every acceptance: tokens equal to both greedy
    loops and dmi_tpu's oracle run, rounds equal to dmi_tpu's (EOS off:
    ceil((budget - 1) / (k + 1)) at full acceptance, budget - 1 at none)."""
    jcfg, jparams, tcfg, tparams = _models(seed=1, eos=())
    budget, k = 9, 3
    embeds = _prompt(4, 5, seed=2)
    want = _greedy(jcfg, jparams, tcfg, tparams, embeds, budget)
    jt, jr = jspec.speculative_generate_oracle_bl(jcfg, jparams, jnp.asarray(embeds),
                                                  jnp.asarray(want), budget, PAD, k=k,
                                                  wrong_period=wrong_period)
    tt, tr = tspec.speculative_generate_oracle_bl(tcfg, tparams, torch.from_numpy(embeds),
                                                  torch.tensor(want), budget, PAD, k=k,
                                                  wrong_period=wrong_period)
    np.testing.assert_array_equal(np.asarray(jt), want)
    np.testing.assert_array_equal(tt.numpy(), want)
    assert tr == int(jr)
    assert tr == {0: -(-(budget - 1) // (k + 1)), 1: budget - 1}.get(wrong_period, tr)


@pytest.mark.parametrize("draft", ["random", "self", "w4a8-shared"])
def test_model_draft_tokens_and_rounds_equal_dmi_tpu(draft):
    """A random unrelated draft (its own prompt), the target as its own
    draft (full acceptance) and the W4A8 self-draft with the unquantized
    prefill and share_prefill, as serve.Captioner(speculative=k) runs it:
    tokens equal to both greedy loops, rounds equal to dmi_tpu's; EOS on."""
    jcfg, jparams, tcfg, tparams = _models(seed=12, eos=(5,))
    budget, k = 8, 3
    embeds = _prompt(4, 5, seed=13)
    want = _greedy(jcfg, jparams, tcfg, tparams, embeds, budget)
    kw_j, kw_t = {}, {}
    if draft == "random":
        dj, djp, dt, dtp = _models(seed=99, tiny=dict(n_layers=1, n_heads=2, n_kv=1,
                                                      hidden_size=16, intermediate=32))
        dembeds = _prompt(4, 3, H=16, seed=14)
    elif draft == "self":
        dj, djp, dt, dtp, dembeds = jcfg, jparams, tcfg, tparams, embeds
    else:
        dj, dt, dembeds = jcfg, tcfg, embeds
        djp = jq.quantize_llama(jparams, bits=4)
        dtp = bridge.llm_params_from_jax(jax.tree.map(np.asarray, djp))
        kw_j = dict(draft_prefill_params=jparams, share_prefill=True)
        kw_t = dict(draft_prefill_params=tparams, share_prefill=True)
    jt, jr = jspec.speculative_generate_bl(jcfg, jparams, dj, djp, jnp.asarray(embeds),
                                           jnp.asarray(dembeds), budget, PAD, k=k, **kw_j)
    tt, tr = tspec.speculative_generate_bl(tcfg, tparams, dt, dtp, torch.from_numpy(embeds),
                                           torch.from_numpy(dembeds), budget, PAD, k=k, **kw_t)
    np.testing.assert_array_equal(np.asarray(jt), want)
    np.testing.assert_array_equal(tt.numpy(), want)
    assert tr == int(jr)
    if draft == "self":
        assert tr <= -(-(budget - 1) // (k + 1))


def test_share_prefill_gives_the_draft_a_copy():
    """share_prefill on the W4A8 self-draft gives the same tokens and rounds
    as the draft's own prefill (the two prompt caches are equal), and the
    target's caches are not the draft's: the port writes in place."""
    _, _, tcfg, tparams = _models(seed=50)
    from dmi_tpu_torch.models.quant import quantize_llama

    draft = quantize_llama(tparams, bits=4)
    embeds = torch.from_numpy(_prompt(4, 5, seed=51))
    runs = [tspec.speculative_generate_bl(tcfg, tparams, tcfg, draft, embeds, embeds, 8, PAD,
                                          k=3, draft_prefill_params=tparams, share_prefill=s)
            for s in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    core, _, _, max_rounds = tspec._spec_setup(tcfg, tparams, None, embeds, 8, PAD, 3)
    kv_d = tspec._draft_setup(tcfg, draft, tparams, embeds, 3, max_rounds,
                              from_target=core.caches)[0]
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(kv_d, core.caches))


def test_eos_staggering_and_hostile_oracle():
    """V 11 with two EOS ids: rows end at staggered ages, the EOS written
    and pad after it, with a perfect and a hostile oracle."""
    jcfg, jparams, tcfg, tparams = _models(seed=2, eos=(5, 7), tiny=dict(vocab_size=11))
    budget, k = 8, 3
    embeds = _prompt(6, 4, seed=102)
    want = _greedy(jcfg, jparams, tcfg, tparams, embeds, budget)
    ends = [int(np.isin(r, (5, 7)).argmax()) for r in want if np.isin(r, (5, 7)).any()]
    assert len(set(ends)) > 1, "the fixture should end rows at several ages"
    for wp in (0, 2):
        tt, tr = tspec.speculative_generate_oracle_bl(
            tcfg, tparams, torch.from_numpy(embeds), torch.tensor(want), budget, PAD, k=k,
            wrong_period=wp)
        np.testing.assert_array_equal(tt.numpy(), want)
        assert tr <= budget - 1


@pytest.mark.parametrize("budget", [0, 1, 2])
def test_tiny_budgets(budget):
    jcfg, jparams, tcfg, tparams = _models(seed=10)
    embeds = _prompt(2, 3, seed=11)
    want = _greedy(jcfg, jparams, tcfg, tparams, embeds, budget)
    tt, tr = tspec.speculative_generate_bl(tcfg, tparams, tcfg, tparams,
                                           torch.from_numpy(embeds), torch.from_numpy(embeds),
                                           budget, PAD, k=3)
    np.testing.assert_array_equal(tt.numpy(), want)
    assert tr == max(budget - 1, 0) and tt.shape == (2, budget)


def test_mla_is_refused_with_dmi_tpus_reason():
    jcfg, jparams, tcfg, tparams = _models("deepseek")
    embeds = _prompt(2, 3, seed=1)
    with pytest.raises(NotImplementedError) as jerr:
        jspec.speculative_generate_oracle_bl(jcfg, jparams, jnp.asarray(embeds),
                                             jnp.zeros((2, 4), jnp.int32), 4, PAD, k=2)
    with pytest.raises(NotImplementedError) as terr:
        tspec.speculative_generate_oracle_bl(tcfg, tparams, torch.from_numpy(embeds),
                                             torch.zeros((2, 4), dtype=torch.long), 4, PAD,
                                             k=2)
    assert str(terr.value) == str(jerr.value)


# --- the forced harness -----------------------------------------------------

def _sim_forced_rounds(budget, k, wp):
    """Closed-form round count of the forced harness (tests/test_speculative.py)."""
    out_pos, rounds = 1, 0
    while out_pos < budget:
        n_acc = 0
        for i in range(k):
            if wp > 0 and (out_pos + i) % wp == 0:
                break
            n_acc += 1
        out_pos = min(out_pos + n_acc + 1, budget)
        rounds += 1
    return rounds


@pytest.mark.parametrize("wp", [0, 1, 3])
def test_forced_harness_matches_dmi_tpu(wp):
    """Both real forwards run, the chain is emitted with the closed-form
    rounds: tokens and rounds equal to dmi_tpu's (V 64 < 271k, distinct eos
    ids), never an EOS id."""
    eos = (5, 7)
    jcfg, jparams, tcfg, tparams = _models(seed=11, eos=eos)
    dj, djp, dt, dtp = _models(seed=12, eos=eos)
    budget, k = 9, 3
    embeds, dembeds = _prompt(3, 4, seed=13), _prompt(3, 4, seed=14)
    jt, jr = jspec.speculative_generate_forced_bl(
        jcfg, jparams, dj, djp, jnp.asarray(embeds), jnp.asarray(dembeds), budget, PAD,
        jnp.int32(wp), k=k)
    tt, tr = tspec.speculative_generate_forced_bl(
        tcfg, tparams, dt, dtp, torch.from_numpy(embeds), torch.from_numpy(dembeds), budget,
        PAD, wp, k=k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tr == int(jr) == _sim_forced_rounds(budget, k, wp)
    got = tt.numpy()
    assert not np.isin(got, eos).any()
    nxt = tspec._chain_next(torch.from_numpy(got[:, :-1]), tcfg.vocab_size, eos).numpy()
    np.testing.assert_array_equal(got[:, 1:], nxt)


def test_chain_next_equals_dmi_tpu_below_271k():
    tok = np.arange(0, 270_000, 997)
    for wrong in (False, True):
        ref = np.asarray(jspec._chain_next(jnp.asarray(tok, jnp.int32), 270_001, (5, 9, 1000),
                                           wrong=wrong))
        out = tspec._chain_next(torch.from_numpy(tok), 270_001, (5, 9, 1000), wrong=wrong)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_chain_next_has_no_int32_overflow_at_v_300000():
    """dmi_tpu's int32 product wraps above a vocab of about 271k (its chain
    leaves [0, V) or repeats); the port's stays in range, skips the eos
    ids, and is the affine map's image."""
    V, eos = 300_000, (2, 299_999)
    tok = torch.arange(271_000, V, 7)
    out = tspec._chain_next(tok, V, eos)
    assert bool(((out >= 0) & (out < V)).all()) and not bool(torch.isin(out, torch.tensor(eos)).any())
    c = (tok * 7919 + 104729) % (V - 2)
    assert torch.equal(out, c + (c >= 2).long() + (c >= 299_998).long())
    wrong = tspec._chain_next(tok, V, eos, wrong=True)
    assert not bool((wrong == out).any())
    ref = np.asarray(jspec._chain_next(jnp.asarray(tok.numpy(), jnp.int32), V, eos))
    assert (ref != out.numpy()).any()  # the fault the port does not copy


def test_excl_shift_skips_duplicate_eos_ids_once():
    """dmi_tpu's _excl_shift counts a repeated eos id twice and maps onto an
    excluded id; the port's deduplicates: an injection of [0, V - 2) into
    [0, V) minus {3, 8} for eos (3, 3, 8)."""
    V, eos = 12, (3, 3, 8)
    c = torch.arange(V - 2)
    out = tspec._excl_shift(c, eos)
    assert sorted(out.tolist()) == [i for i in range(V) if i not in (3, 8)]
    ref = np.asarray(jspec._excl_shift(jnp.asarray(c.numpy()), eos))
    assert np.isin(ref, (3, 8)).any()  # the fault the port does not copy
    chain = tspec._chain_next(torch.arange(V), V, eos)
    assert not bool(torch.isin(chain, torch.tensor([3, 8])).any())
    assert bool(((chain >= 0) & (chain < V)).all())
