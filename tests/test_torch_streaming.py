"""dmi_tpu_torch's continuous-batching engine (streaming.py) and the per-row
bias of decode attention against dmi_tpu's, on shared weights.

At f32 on the CPU: the decode-attention twins with a [B, S] bias (a row per
slot) equal dmi_tpu's fused_decode_attention with [B, 1, S] and the port's
_decode_attention_bl with [S, B], split and merged per row; the engine's
greedy tokens equal dmi_tpu's StreamingCaptioner and the port's batch engine
at every pool shape tested, EOS firing at staggered ages, with run and
run_bulk; sampled tokens are the same on every engine and pool shape of the
port.  The CUDA side is tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import mmmodel as jmm
from dmi_tpu.models import projector as jproj
from dmi_tpu.models import quant as jq
from dmi_tpu.ops.pallas import decode_attn as jda
from dmi_tpu.streaming import StreamingCaptioner as JaxStreaming
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.ops import l2_normalize
from dmi_tpu_torch.ops.cuda import decode_attn as tda
from dmi_tpu_torch.serve import Captioner
from dmi_tpu_torch.streaming import StreamingCaptioner, init_state

torch.set_num_threads(1)

PAD = 0
PREFIX = np.asarray([3, 7, 9])
NEG = float(np.finfo(np.float32).min)


def _setup(seed=0, eos=(5,), vocab=64):
    """tests/test_streaming.py's make_setup in both packages: a tiny f32 LM
    and a 2-layer projector; the layer weights scaled from init's std 0.02
    to 0.2 so that greedy tokens vary and EOS (vocab 64) fires at staggered
    ages."""
    jcfg = dataclasses.replace(
        jllama.tiny_config(vocab_size=vocab, hidden_size=32, n_layers=2, n_heads=4, n_kv=2,
                           intermediate=64), eos_token_ids=tuple(eos))
    jparams = jllama.init(jax.random.key(seed), jcfg)
    jparams["layers"] = {k: v * 10.0 if k.startswith("w") else v
                         for k, v in jparams["layers"].items()}
    jspec = jproj.ProjectorSpec(mm_dim=16, lm_dim=32, n_layers=2, dropout=0.0)
    jpp = jproj.init(jax.random.key(seed + 1), jspec)
    tparams = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    return (jcfg, jparams, jspec, jpp), (bridge.config_from_jax(jcfg), tparams,
                                         tproj.ProjectorSpec(mm_dim=16, lm_dim=32), tpp)


def _staggered_eos(seed, embs, budget):
    """The EOS id that makes captions end at the most different ages: of the
    ids the EOS-free greedy run emits (dmi_tpu's batch path), the one whose
    first occurrences in the rows fall at the most distinct steps (the
    smallest such id; never the pad id)."""
    jcfg, jparams, jspec, jpp = _setup(seed, eos=())[0]
    soft = jproj.apply(jspec, jpp, jnp.asarray(embs), train=False)
    ids = jnp.tile(jnp.asarray(PREFIX)[None], (embs.shape[0], 1))
    free = np.asarray(jmm.caption_generate(jcfg, jparams, soft, ids, budget, PAD))
    ages = {}
    for row in free:
        for tok in set(row.tolist()) - {PAD}:
            ages.setdefault(tok, set()).add(row.tolist().index(tok))
    return max(sorted(ages), key=lambda tok: len(ages[tok]))


def _embs(n, seed):
    """Requests, l2-normalised as the serving layer hands them to the engine."""
    x = np.random.default_rng(seed).normal(size=(n, 16)).astype(np.float32)
    return l2_normalize(torch.from_numpy(x)).numpy()


def _batch_engine(t, budget, embs, **kw):
    tcfg, tparams, tspec, tpp = t
    cap = Captioner(tcfg, tparams, tspec, tpp, max_new_tokens=budget, batch_size=4,
                    prefix_ids=PREFIX, pad_token_id=PAD, **kw.pop("init", {}))
    return cap, cap.caption_ids(embs, engine="batch", **kw)


def _engine(t, budget, **kw):
    tcfg, tparams, tspec, tpp = t
    return StreamingCaptioner(tcfg, tparams, tspec, tpp, PREFIX, budget, PAD, **kw)


# --- K1: decode attention with a bias row per batch row --------------------

def _ring_case(B=5, nh=8, nkv=2, T=4, budget=7, hd=16, seed=0):
    """q, k, v over a T + budget ring cache and a [B, S] bias as the engine
    builds it: prompt rows and a wrapped run of ring rows valid, row 0 a
    slot never used (finfo.min everywhere)."""
    rng = np.random.default_rng(seed)
    S = T + budget
    q = rng.normal(size=(B, nh, 1, hd)).astype(np.float32)
    k = rng.normal(size=(B, nkv, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, nkv, S, hd)).astype(np.float32)
    bias = np.full((B, S), NEG, np.float32)
    for b in range(1, B):
        bias[b, :T] = 0.0
        start, n = rng.integers(budget), 1 + rng.integers(budget)
        bias[b, T + (start + np.arange(n)) % budget] = 0.0
    return q, k, v, bias


def test_per_row_bias_twin_matches_dmi_tpu():
    """_decode_attn_plain with [B, S] against dmi_tpu's fused_decode_attention
    with [B, 1, S] (its XLA path on the CPU) and llama._decode_attention, at
    f32 within 1e-5; the never-used row gives the average of its V rows."""
    q, k, v, bias = _ring_case()
    out = tda._decode_attn_plain(*map(torch.from_numpy, (q, k, v, bias))).numpy()
    jb = jnp.asarray(bias)[:, None, :]
    ref = np.asarray(jda.fused_decode_attention(*map(jnp.asarray, (q, k, v)), jb))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jllama._decode_attention(*map(jnp.asarray, (q, k, v)), jb))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert np.isfinite(out).all()
    mean_v = v[0].mean(axis=1)  # [nkv, hd]
    np.testing.assert_allclose(out[0, :, 0].reshape(2, 4, 16), mean_v[:, None].repeat(4, 1),
                               rtol=1e-5, atol=1e-5)
    # the CPU wrapper takes [B, S] and runs the twin
    assert np.array_equal(
        tda.fused_decode_attention(*map(torch.from_numpy, (q, k, v, bias))).numpy(), out)


def test_per_row_bias_twin_matches_batch_last_form():
    """The same function as the port's _decode_attention_bl over a
    batch-last cache with an [S, B] bias (dmi_tpu's engine form)."""
    q, k, v, bias = _ring_case(seed=1)
    B, nh, _, hd = q.shape
    out = tda._decode_attn_plain(*map(torch.from_numpy, (q, k, v, bias)))
    qb = torch.from_numpy(q).reshape(B, 2, 4, hd).permute(1, 2, 3, 0)  # [nkv, g, hd, B]
    kb, vb = (torch.from_numpy(a).permute(1, 2, 3, 0) for a in (k, v))  # [nkv, S, hd, B]
    ref = tdec._decode_attention_bl(qb, kb, vb, torch.from_numpy(bias).t())
    torch.testing.assert_close(out, ref.permute(3, 0, 1, 2).reshape(B, nh, 1, hd),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["one-split-only", "fully-masked", "ring"])
def test_per_row_bias_split_twin(case):
    """_decode_attn_split_plain (the kernel's splits and in-order merge) with
    per-row masks: row 0's valid keys all in one split (its other splits
    weigh 0 for that row only); a fully masked row (finite, the twin's
    output); ring masks."""
    B, S = 3, 100
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, 8, 1, 16), (B, 2, S, 16), (B, 2, S, 16)))
    bias = np.zeros((B, S), np.float32)
    if case == "one-split-only":
        bias[0] = NEG
        bias[0, 45:70] = 0.0  # inside split 1 of 40 keys
        bias[2, 90:] = NEG
    elif case == "fully-masked":
        bias[1] = NEG
    else:
        bias = _ring_case(B=B, T=20, budget=80, seed=5)[3]
    p = {**tda.plan(B, 2, 4, S, 16, 4), "keys_per_split": 40, "splits": 3, "chunk": 16}
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out = tda._decode_attn_split_plain(*args, p)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, tda._decode_attn_plain(*args), rtol=1e-5, atol=1e-5)
    ref = np.asarray(jllama._decode_attention(*map(jnp.asarray, (q, k, v)),
                                              jnp.asarray(bias)[:, None, :]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plan_is_a_function_of_the_shape():
    """The per-row bias changes no launch plan: plan takes no bias, and at
    the shapes tests/test_torch_kernels.py pins it gives what it gave."""
    import inspect

    assert "bias" not in inspect.signature(tda.plan).parameters
    assert tda.plan(128, 8, 4, 23, 64, 2)["chunk"] == 32
    assert tda.plan(64, 8, 4, 37, 64, 2)["chunk"] == 48
    p = tda.plan(128, 8, 4, 38, 64, 2)
    assert (p["splits"], p["warps"], p["stages"], p["keys_per_split"]) == (1, 1, 1, 38)
    assert tda.plan(2, 8, 4, 3073, 64, 2)["keys_per_split"] == 64
    assert tda.plan(2, 8, 4, 16384, 64, 2)["warps"] == 4


def test_wrapper_refuses_a_bias_of_another_shape():
    q, k, v, bias = (torch.from_numpy(a) for a in _ring_case())
    for bad in (bias[:, :-1], bias[:-1], bias[None]):
        with pytest.raises(ValueError, match="decode attention shapes"):
            tda.fused_decode_attention(q, k, v, bad)


def test_per_slot_step_equals_the_batch_step():
    """_decode_step_bl over the whole ring cache with per-slot rope, the
    write row and a [B, S] bias gives the batch step's logits when every
    slot sits at the position the batch step writes (the rows past it
    masked), and writes the same cache row."""
    _, (tcfg, tparams, _, _) = _setup(seed=3)
    rng = np.random.default_rng(3)
    B, T, S, H = 4, 5, 9, 32
    x = torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32))
    caches = tdec.init_cache(tcfg, B, S)
    tdec.prefill(tcfg, tparams, x, caches)
    h = torch.from_numpy(rng.normal(size=(H, B)).astype(np.float32))
    c2 = tuple(c.clone() for c in caches)
    want = tdec._decode_step_bl(tcfg, tparams, h, caches, T)
    cos, sin = tllama.rope_tables(tcfg, torch.full((B,), T))
    bias = torch.full((B, S), NEG)
    bias[:, :T + 1] = 0.0
    got = tdec._decode_step_bl(tcfg, tparams, h, c2, None, rope=(cos.t(), sin.t()),
                               write_row=T, bias=bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got_c, want_c in zip(c2, caches):  # layer 0's row bit for bit, later ones up to
        assert torch.equal(got_c[0], want_c[0])  # the order of the attention's sums
        torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="together"):
        tdec._decode_step_bl(tcfg, tparams, h, c2, None, bias=bias)


# --- the engine --------------------------------------------------------------

@pytest.mark.parametrize("pool,admit,k", [(5, 2, 3), (9, 4, 1), (17, 8, 4)])
def test_greedy_engine_matches_dmi_tpu_and_the_batch_engine(pool, admit, k):
    """23 requests through pools smaller than the workload (slots recycled),
    EOS 5 firing at staggered ages: run, run_bulk, the port's batch engine
    and dmi_tpu's StreamingCaptioner.run give identical tokens."""
    budget, embs = 7, _embs(23, 3)
    j, t = _setup(seed=2, eos=(_staggered_eos(2, embs, budget),))
    want = JaxStreaming(*j, PREFIX, budget, PAD, pool=pool, admit=admit, k_steps=k).run(embs)
    eng = _engine(t, budget, pool=pool, admit=admit, k_steps=k)
    run = eng.run(embs)
    assert run.dtype == torch.long and tuple(run.shape) == (23, budget)
    np.testing.assert_array_equal(run.numpy(), want)
    np.testing.assert_array_equal(eng.run_bulk(embs).numpy(), want)
    np.testing.assert_array_equal(_batch_engine(t, budget, embs)[1].numpy(), want)
    lens = (want != PAD).sum(axis=1)
    assert len(set(lens.tolist())) > 2 and (lens < budget).any()  # staggered EOS
    assert eng.steps > 0


def test_greedy_engine_without_eos():
    """EOS off: every request decodes the whole budget (no early refill)."""
    j, t = _setup(seed=4, eos=())
    budget, embs = 5, _embs(6, 5)
    want = JaxStreaming(*j, PREFIX, budget, PAD, pool=4, admit=3, k_steps=2).run(embs)
    eng = _engine(t, budget, pool=4, admit=3, k_steps=2)
    np.testing.assert_array_equal(eng.run(embs).numpy(), want)
    np.testing.assert_array_equal(eng.run_bulk(embs).numpy(), want)
    assert (want != PAD).all()


def test_greedy_engine_single_request_and_empty_workload():
    j, t = _setup(seed=8)
    one = _embs(1, 9)
    want = JaxStreaming(*j, PREFIX, 4, PAD, pool=3, admit=2, k_steps=2).run(one)
    eng = _engine(t, 4, pool=3, admit=2, k_steps=2)
    np.testing.assert_array_equal(eng.run(one).numpy(), want)
    np.testing.assert_array_equal(eng.run_bulk(one).numpy(), want)
    empty = _engine(t, 4, pool=3, admit=2, k_steps=2)
    assert tuple(empty.run(np.zeros((0, 16), np.float32)).shape) == (0, 4)
    assert tuple(empty.run_bulk(np.zeros((0, 16), np.float32)).shape) == (0, 4)
    assert empty.steps == 0


def test_greedy_engine_w4a8_tree():
    """W4A8 loop weights with the unquantized tree for the prompt pass:
    the engine's tokens equal dmi_tpu's batch path and the port's batch
    engine on the same quantized configuration."""
    j, t = _setup(seed=6)
    jcfg, jparams, jspec, jpp = j
    tcfg, tparams, tspec, tpp = t
    jq4 = jq.quantize_llama(jparams, bits=4)
    tq4 = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jq4))
    budget, embs = 6, _embs(9, 7)
    soft = jproj.apply(jspec, jpp, jnp.asarray(embs), train=False)
    ids = jnp.tile(jnp.asarray(PREFIX)[None], (9, 1))
    want = np.asarray(jmm.caption_generate(jcfg, jq4, soft, ids, budget, PAD,
                                           prefill_params=jparams))
    eng = StreamingCaptioner(tcfg, tq4, tspec, tpp, PREFIX, budget, PAD, pool=5, admit=2,
                             k_steps=3, prefill_params=tparams)
    np.testing.assert_array_equal(eng.run(embs).numpy(), want)
    np.testing.assert_array_equal(eng.run_bulk(embs).numpy(), want)
    cap, batch = _batch_engine(t, budget, embs, init={"int8": "w4a8"})
    assert "qp" in cap.llm_params["layers"][0]["w_gu"]
    np.testing.assert_array_equal(batch.numpy(), want)


@pytest.mark.parametrize("top_k,top_p", [(8, 1.0), (0, 0.85)])
def test_sampled_engine_is_engine_and_pool_invariant(top_k, top_p):
    """Request-indexed draws: the batch engine, run and run_bulk at two pool
    shapes, and the Captioner's bulk and auto engines give the same tokens
    for one (seed, workload); another seed gives others, and the draws did
    sample (not greedy)."""
    _, t = _setup(seed=24)
    budget, embs = 7, _embs(13, 25)
    kw = dict(temperature=0.8, top_k=top_k, top_p=top_p, seed=42)
    cap, want = _batch_engine(t, budget, embs, **kw)
    for pool, admit, k in ((4, 2, 3), (9, 4, 1)):
        eng = _engine(t, budget, pool=pool, admit=admit, k_steps=k, **kw)
        assert torch.equal(eng.run(embs), want)
        assert torch.equal(eng.run_bulk(embs), want)
    assert torch.equal(cap.caption_ids(embs, engine="bulk", **kw), want)
    assert torch.equal(cap.caption_ids(embs, engine="auto", **kw), want)
    assert not torch.equal(cap.caption_ids(embs, engine="batch", **{**kw, "seed": 43}), want)
    assert not torch.equal(_batch_engine(t, budget, embs)[1], want)


def test_engine_state_and_option_checks():
    _, t = _setup()
    tcfg = t[0]
    st = init_state(tcfg, 5, 4, 7, PAD)
    assert tuple(st.caches[0].shape) == (2, 5, 2, 11, 8) and tuple(st.valid.shape) == (5, 11)
    assert (st.req == -1).all() and not st.live.any() and (st.tokens == PAD).all()
    with pytest.raises(ValueError, match="pool"):
        _engine(t, 7, pool=1, admit=1)
    with pytest.raises(ValueError, match="admit"):
        _engine(t, 7, pool=4, admit=5)
    with pytest.raises(ValueError, match="sharded"):  # a mesh takes sharded trees
        _engine(t, 7, pool=4, admit=2, mesh=object())
