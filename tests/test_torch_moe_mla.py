"""The MoE gate, the routed MLP's quantized stacks, absorbed MLA and yarn rope
in dmi_tpu_torch, against dmi_tpu and HF.

The gate keeps the top-k experts by probability; among equal ones jax's
lax.top_k keeps the lower index, and torch.topk promises no order, so the
port selects by a stable descending sort: rows with exact bf16 ties at the
k-th place must keep dmi_tpu's experts.  The absorbed attention of the
batch-last step over one latent cache equals dmi_tpu's and the expanded
per-head oracle's.  Yarn's frequencies and attention factor at
DeepSeek-V2-Lite's published rope_scaling equal dmi_tpu's and transformers'
own.  Expert stacks quantize per expert and output column (int8 and int4)
as dmi_tpu's 4-D stacks do, and dequantize alike.  The routed MLP's 2-D
products over fuse_projections' [E, I, H] stacks equal dmi_tpu's and the
batched formulation's, forward and backward, and copy no activation-sized
tensor.  f32 on the CPU, 1e-5 relative unless stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import quant as jq
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.models import quant as tq

torch.set_num_threads(1)

TINY = dict(vocab_size=96, hidden_size=64, n_layers=2, n_heads=4, n_kv=2, intermediate=128,
            eos=(5,))
# DeepSeek-V2-Lite's published rope and MLA widths (config.json)
V2_LITE_ROPE = dict(rope_theta=10000.0, qk_rope_head_dim=64, qk_nope_head_dim=128,
                    rope_yarn_factor=40.0, rope_original_max_position=4096,
                    rope_yarn_beta_fast=32.0, rope_yarn_beta_slow=1.0, rope_yarn_mscale=0.707,
                    rope_yarn_mscale_all_dim=0.707)


def _close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _tied_logits(E, k, rows, seed):
    """bf16 router logits [rows, E] in which the k-th largest value of every
    row is shared by 2-4 experts, some inside the top k and some outside."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(rows, E)).astype(np.float32)
    for r in range(rows):
        order = np.argsort(-logits[r], kind="stable")
        n_tie = 2 + r % 3
        # experts from inside and from outside the top k take the k-th value
        members = np.concatenate([order[k - 1 - (n_tie // 2):k], order[k:k + (n_tie + 1) // 2]])
        logits[r, members] = logits[r, order[k - 1]]
    return torch.from_numpy(logits).bfloat16().float().numpy()


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,k", [(64, 8), (64, 6), (8, 2)], ids=["olmoe", "v2-lite", "mixtral"])
def test_gate_keeps_the_lower_index_on_exact_ties(E, k):
    """Rows of bf16 logits with exact ties across the k-th place: the
    experts the port keeps are lax.top_k's (the lower indices among
    equals), and their weights equal dmi_tpu's moe_gate_weights."""
    logits = _tied_logits(E, k, rows=48, seed=E + k)
    jcfg = jllama.tiny_olmoe_config(n_experts=E, top_k=k, **TINY)
    tcfg = bridge.config_from_jax(jcfg)
    want = np.asarray(jllama.moe_gate_weights(jcfg, jnp.asarray(logits)))
    got = tllama.moe_gate_weights(tcfg, torch.from_numpy(logits)).numpy()
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), k)
    kept = np.zeros_like(want, bool)
    np.put_along_axis(kept, np.asarray(idx), True, axis=-1)
    np.testing.assert_array_equal(got > 0, kept)
    np.testing.assert_array_equal(want > 0, kept)
    _close(got, want)
    # the ties bind: the rows' k-th place is shared with an expert not kept
    kth = np.sort(logits, axis=-1)[:, -k]
    assert all((logits[r] == kth[r])[~kept[r]].any() for r in range(len(logits)))


@pytest.mark.parametrize("norm,scale", [(True, 1.0), (False, 2.5), (True, 16.0)],
                         ids=["renormalised", "scaled", "both"])
def test_gate_weights_match_dmi_tpu(norm, scale):
    """moe_gate_weights with and without the top-k renormalisation and with
    a routed_scaling_factor, over [B, T, E] f32 logits: dmi_tpu's weights,
    rows summing to the scale when renormalised."""
    jcfg = dataclasses.replace(jllama.tiny_mixtral_config(n_experts=8, top_k=3, **TINY),
                               moe_norm_topk=norm, routed_scaling_factor=scale)
    tcfg = bridge.config_from_jax(jcfg)
    logits = np.random.default_rng(1).normal(size=(3, 5, 8)).astype(np.float32) * 3
    want = np.asarray(jllama.moe_gate_weights(jcfg, jnp.asarray(logits)))
    got = tllama.moe_gate_weights(tcfg, torch.from_numpy(logits)).numpy()
    _close(got, want)
    assert ((got > 0).sum(-1) == 3).all()
    if norm:
        _close(got.sum(-1), np.full((3, 5), scale))


# tiny MoE families: the router's renormalisation, olmoe's wide q/k norms,
# deepseek's f32 gate, routed_scaling_factor and a shared expert
MOE_FAMILIES = {
    "olmoe": lambda: jllama.tiny_olmoe_config(n_experts=4, **TINY),
    "mixtral": lambda: jllama.tiny_mixtral_config(n_experts=4, **TINY),
    "qwen3-moe": lambda: jllama.tiny_qwen3moe_config(n_experts=4, **TINY),
    "deepseek": lambda: jllama.tiny_deepseek_config(n_experts=4, n_shared=1, routed_scale=2.0,
                                                    **TINY),
}


def _moe_layer(family, fused, seed=3):
    """(dmi_tpu's config and layer 0, the port's config, the port's
    unfused layer 0 and the layer the routed MLP runs: fuse_projections'
    when fused).  Weights x10 so the gate and the experts' products are
    far from 0."""
    jcfg = MOE_FAMILIES[family]()
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(seed), jcfg))
    tree["layers"] = {k: a * 10.0 if k.startswith(("w", "moe")) else a
                      for k, a in tree["layers"].items()}
    jlw = {k: jnp.asarray(a[0]) for k, a in tree["layers"].items()}
    tparams = bridge.llm_params_from_jax(tree)
    plain = {k: v.clone() for k, v in tparams["layers"][0].items()}
    tlw = tllama.fuse_projections(tparams)["layers"][0] if fused else tparams["layers"][0]
    return jcfg, jlw, bridge.config_from_jax(jcfg), plain, tlw


def _moe_mlp_parent(cfg, lw, h):
    """The routed MLP as the port computed it before the 2-D formulation:
    batched expert products over [E, H, I] stacks, each expert's output
    [E, N, H] combined by an einsum with the gate weights."""
    B, T, H = h.shape
    if cfg.moe_gate_fp32:
        router = h.float() @ lw["w_router"].float()
    else:
        router = h @ lw["w_router"]
    w_e = tllama.moe_gate_weights(cfg, router).to(h.dtype).reshape(B * T, -1)
    x = h.reshape(1, B * T, H)
    g, u = x @ lw["moe_w1"], x @ lw["moe_w3"]
    y = (tllama.mlp_activation(cfg, g) * u) @ lw["moe_w2"]
    out = torch.einsum("enh,ne->nh", y, w_e).reshape(B, T, H)
    if cfg.n_shared_experts:
        gate = tllama.mlp_activation(cfg, h @ lw["w_shared_gate"])
        out = out + (gate * (h @ lw["w_shared_up"])) @ lw["w_shared_down"]
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("family", list(MOE_FAMILIES))
def test_routed_mlp_batch_last_equals_batch_first(family, fused):
    """_moe_mlp_bl over [H, B] equals llama._moe_mlp over [B, 1, H], and
    both equal dmi_tpu's _moe_mlp_bl and _moe_mlp, on the unfused tree
    (the stacks transposed per call) and on fuse_projections' (the
    prepared [E, I, H] stacks)."""
    jcfg, jlw, tcfg, _, tlw = _moe_layer(family, fused)
    h = np.random.default_rng(4).normal(size=(64, 6)).astype(np.float32)
    want = np.asarray(jdec._moe_mlp_bl(jcfg, jlw, jnp.asarray(h)))
    bl = tdec._moe_mlp_bl(tcfg, tlw, torch.from_numpy(h))
    _close(bl.numpy(), want)
    bf = tllama._moe_mlp(tcfg, tlw, torch.from_numpy(h.T.copy())[:, None, :])
    _close(bf[:, 0].t().numpy(), want)
    hb = h.T.copy().reshape(2, 3, 64)
    _close(tllama._moe_mlp(tcfg, tlw, torch.from_numpy(hb)).numpy(),
           np.asarray(jllama._moe_mlp(jcfg, jlw, jnp.asarray(hb))))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("family", list(MOE_FAMILIES))
def test_routed_mlp_output_and_input_gradient_equal_the_batched_formulation(family, fused):
    """Over [B, T, H] f32, the 2-D formulation's output and its gradient
    with respect to h (through the experts and through the router) equal
    the batched formulation's (the [E, N, H] combine) to 1e-5 relative."""
    _, _, tcfg, plain, tlw = _moe_layer(family, fused)
    gen = torch.Generator().manual_seed(7)
    h0 = torch.randn(3, 5, 64, generator=gen)
    up = torch.randn(3, 5, 64, generator=gen)  # a contiguous upstream gradient
    outs = []
    for fn, lw in ((tllama._moe_mlp, tlw), (_moe_mlp_parent, plain)):
        h = h0.clone().requires_grad_()
        out = fn(tcfg, lw, h)
        out.backward(up)
        outs.append((out.detach().numpy(), h.grad.numpy()))
    (got, got_dh), (want, want_dh) = outs
    _close(got, want)
    _close(got_dh, want_dh)


@pytest.mark.parametrize("family", ["olmoe", "deepseek"])
def test_fuse_projections_lays_the_expert_stacks_out_once(family):
    """fuse_projections replaces moe_w1/moe_w3 [E, H, I] by contiguous
    moe_w1t/moe_w3t [E, I, H] and keeps no original stack; the caller's
    tree keeps its tensors, values and strides; fusing the fused tree again
    moves nothing, and fusing the unfused tree again gives the same
    values."""
    params = bridge.llm_params_from_jax(
        jax.tree.map(np.asarray, jllama.init(jax.random.key(3), MOE_FAMILIES[family]())))
    before = {k: (v, v.clone(), v.stride()) for k, v in params["layers"][0].items()}
    fused = tllama.fuse_projections(params)
    lw = fused["layers"][0]
    E, H, I = before["moe_w1"][1].shape
    assert not {"moe_w1", "moe_w3"} & set(lw)
    for key in ("moe_w1", "moe_w3"):
        t = lw[key + "t"]
        assert t.shape == (E, I, H) and t.is_contiguous()
        assert torch.equal(t, before[key][1].transpose(1, 2))
    assert lw["moe_w2"] is before["moe_w2"][0]
    for key, (obj, values, stride) in before.items():  # the caller's tree, untouched
        got = params["layers"][0][key]
        assert got is obj and got.stride() == stride and torch.equal(got, values), key
    again = tllama.fuse_projections(fused)["layers"][0]
    twice = tllama.fuse_projections(params)["layers"][0]
    assert again.keys() == lw.keys() == twice.keys()
    assert all(again[key] is lw[key] and torch.equal(twice[key], lw[key]) for key in lw)


@pytest.mark.parametrize("kind", ["q", "q8", "w4", "w4-grouped"])
def test_prepared_stacks_quantize_and_shard_as_the_originals(kind):
    """quantize_llama on fuse_projections' tree quantizes moe_w1t/moe_w3t
    [E, I, H] along H: payloads and scales are the unfused tree's
    [E, H, I] ones transposed bit for bit (int4 packed along H, scales
    [E, I, 1] or [E, I, G]), and they dequantize (axis -1) to the
    transposed per-expert weights as contiguous stacks, so the products'
    [E * I, H] view copies nothing; each rank of two keeps its experts'
    prepared stacks, plain or quantized, and they dequantize to its slice
    of the originals."""
    from dmi_tpu_torch.parallel import sharding

    kw = {"q": {}, "q8": {"native": True}, "w4": {"bits": 4},
          "w4-grouped": {"bits": 4, "group_size": 16}}[kind]
    cfg = tllama.tiny_olmoe_config(n_experts=4)
    params = tllama.init(cfg, torch.Generator().manual_seed(0))
    unfused = {**params, "layers": [{k: v.clone() for k, v in lw.items()}
                                    for lw in params["layers"]]}
    fused = tllama.fuse_projections(params)
    qf, qu = tq.quantize_llama(fused, **kw), tq.quantize_llama(unfused, **kw)
    E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    for lf, lu in zip(qf["layers"], qu["layers"]):
        assert not {"moe_w1", "moe_w3"} & set(lf)
        for key in ("moe_w1", "moe_w3"):
            rows, cols = lf[key + "t"], lu[key]
            assert rows.keys() == cols.keys()
            for leaf in rows:
                assert rows[leaf].is_contiguous()
                assert torch.equal(rows[leaf], cols[leaf].transpose(1, 2)), (key, leaf)
            if "s" in rows:
                assert rows["s"].shape == (E, I, 1)
            got = tq.dequantize(rows, torch.float32, axis=-1)
            assert got.is_contiguous() and got.shape == (E, I, H)
            assert torch.equal(got, tq.dequantize(cols, torch.float32).transpose(1, 2)), key
        assert lf["moe_w2"].keys() == lu["moe_w2"].keys()
        assert all(torch.equal(lf["moe_w2"][k], lu["moe_w2"][k]) for k in lf["moe_w2"])
    vocab = sharding.vocab_of(fused)
    for r in range(2):
        sh = sharding.plan_shard(cfg, vocab, 2, r)
        lo, hi = sh.e0, sh.e1
        for tree in (fused, qf):
            lw = sharding.shard_tree(tree, cfg, sh)["layers"][0]
            w1, w3, w2 = tllama.expert_stacks(lw, torch.float32)
            for got, key in ((w1, "moe_w1"), (w3, "moe_w3")):
                want = unfused["layers"][0][key][lo:hi].transpose(1, 2)
                if tree is qf:
                    want = tq.dequantize({k: v[lo:hi] for k, v in qu["layers"][0][key].items()},
                                         torch.float32).transpose(1, 2)
                assert got.is_contiguous() and torch.equal(got, want), key


def test_routed_mlp_copies_no_activation_sized_tensor():
    """_moe_mlp forward and backward on a fused tiny OLMoE tree under a CPU
    profiler with record_shapes, its spans recording, the backward driven
    by a contiguous upstream gradient: no aten::copy_ inside llama.moe or
    llama.moe.bwd has N * H elements or more (the batched formulation's
    [E, N, H] permute and its [E, I, H] re-layouts of the stacks are such
    copies)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = tllama.tiny_olmoe_config(n_experts=8)
    lw = tllama.fuse_projections(tllama.init(cfg, torch.Generator().manual_seed(0)))["layers"][0]
    B, T, H = 4, 16, cfg.hidden_size
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(B, T, H, generator=gen).requires_grad_()
    up = torch.randn(B, T, H, generator=gen)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        tllama._moe_mlp(cfg, lw, h).backward(up)
    events = prof.events()
    spans = [(e.thread, e.time_range.start, e.time_range.end) for e in events
             if e.name in ("llama.moe", "llama.moe.bwd")]
    assert {e.name for e in events} >= {"llama.moe", "llama.moe.bwd"}
    copies = [e for e in events if e.name == "aten::copy_"
              and any(e.thread == t and a <= e.time_range.start and e.time_range.end <= b
                      for t, a, b in spans)]
    sizes = [int(np.prod(e.input_shapes[0])) for e in copies]
    assert all(n < B * T * H for n in sizes), sizes


# ---------------------------------------------------------------------------
# Absorbed MLA
# ---------------------------------------------------------------------------


def _mla_layer(q_lora_rank=None, seed=5):
    jcfg = jllama.tiny_deepseek_config(q_lora_rank=q_lora_rank, **TINY)
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    layers = {}
    for k, a in tree["layers"].items():
        if "norm" in k:
            a = (a * (1 + 0.3 * rng.normal(size=a.shape))).astype(a.dtype)
        elif k.startswith("w"):
            a = a * 10.0
        layers[k] = a
    tree["layers"] = layers
    return (jcfg, {k: jnp.asarray(a[0]) for k, a in layers.items()},
            bridge.config_from_jax(jcfg), bridge.llm_params_from_jax(tree)["layers"][0])


@pytest.mark.parametrize("q_lora_rank", [None, 8], ids=["lite", "q-lora"])
def test_absorbed_mla_matches_dmi_tpu_on_one_latent_cache(q_lora_rank):
    """One step of _mla_attn_bl over a random latent cache of 11 rows, the
    step writing row 7 and the rows past it masked (finfo.min): the output
    and the written row equal dmi_tpu's _mla_attn_bl over the same cache in
    its [L, 1, 1, S, r + dr, B] layout."""
    jcfg, jlw, tcfg, tlw = _mla_layer(q_lora_rank)
    B, S, row = 3, 11, 7
    C = tcfg.kv_lora_rank + tcfg.qk_rope_head_dim
    rng = np.random.default_rng(6)
    cache = rng.normal(size=(B, S, C)).astype(np.float32)
    hn = rng.normal(size=(64, B)).astype(np.float32)
    bias = np.where(np.arange(S) <= row, 0.0, np.finfo(np.float32).min).astype(np.float32)
    jc, js = jllama.rope_tables(jcfg, jnp.asarray(row))
    jkv = jnp.asarray(cache.transpose(1, 2, 0)[None, None, None])
    want, jkv = jdec._mla_attn_bl(jcfg, jlw, jnp.asarray(hn), jkv, 0, row, S,
                                  jnp.asarray(bias), jc, js)
    latent = torch.from_numpy(cache.copy())
    tc, ts = tllama.rope_tables(tcfg, torch.tensor(row))
    got = tdec._mla_attn_bl(tcfg, tlw, torch.from_numpy(hn), latent, row, S,
                            torch.from_numpy(bias), tc, ts)
    _close(got.numpy(), np.asarray(want))
    _close(latent[:, row].numpy(), np.asarray(jkv)[0, 0, 0, row].T)
    np.testing.assert_array_equal(np.delete(latent.numpy(), row, axis=1),
                                  np.delete(cache, row, axis=1))


def test_absorbed_mla_equals_the_expanded_oracle():
    """Over a sequence of 9 positions, the expanded per-head attention at the
    last position (llama._mla_qkv and _attention, causal) equals the
    absorbed step over the compressed rows _mla_qkv hands back for the 8
    positions before it, per-slot rope tables [dr, B] included."""
    _, _, tcfg, tlw = _mla_layer(seed=7)
    B, T = 2, 9
    h = torch.from_numpy(np.random.default_rng(8).normal(size=(B, T, 64)).astype(np.float32))
    pos = torch.arange(T)
    cos, sin = tllama.rope_tables(tcfg, pos)
    q, k, v, rows = tllama._mla_qkv(tcfg, tlw, h, cos, sin)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, tllama.NEG_INF)
    want = tllama._attention(q, k, v, causal, tllama.attn_score_scale(tcfg))[:, :, -1]
    latent = torch.zeros(B, T, rows.shape[-1])
    latent[:, :T - 1] = rows[:, :T - 1]
    c, s = (t.expand(B, -1).t() for t in tllama.rope_tables(tcfg, torch.tensor([T - 1])))
    got = tdec._mla_attn_bl(tcfg, tlw, h[:, -1].t().contiguous(), latent, T - 1, T,
                            torch.zeros(B, T), c, s)
    _close(got.t().reshape(B, tcfg.num_attention_heads, -1).numpy(), want.numpy())
    _close(latent[:, T - 1].numpy(), rows[:, T - 1].numpy())


# ---------------------------------------------------------------------------
# Yarn rope at DeepSeek-V2-Lite's parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mscale", [(0.707, 0.707), (1.0, 0.5), (None, None)],
                         ids=["v2-lite", "factor-binds", "no-mscale"])
def test_yarn_tables_match_dmi_tpu_and_transformers(mscale):
    """rope_inv_freq, rope_attention_factor and rope_tables over 64 rope
    dims at V2-Lite's yarn block (factor 40, original length 4096, beta
    32/1): dmi_tpu's values, and transformers' _compute_yarn_parameters'
    frequencies and attention factor (1.0 for V2-Lite's equal mscale pair;
    get_mscale(40) with none; their ratio otherwise)."""
    transformers = pytest.importorskip("transformers")
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    jcfg = dataclasses.replace(jllama.tiny_deepseek_config(**TINY), **{
        **V2_LITE_ROPE, "head_dim": 192, "rope_yarn_mscale": mscale[0],
        "rope_yarn_mscale_all_dim": mscale[1]})
    tcfg = bridge.config_from_jax(jcfg)
    assert tllama.rope_dim(tcfg) == 64
    pos = np.arange(0, 5000, 37)
    jc, js = jllama.rope_tables(jcfg, jnp.asarray(pos))
    tc, ts = tllama.rope_tables(tcfg, torch.from_numpy(pos))
    _close(tc.numpy(), np.asarray(jc))
    _close(ts.numpy(), np.asarray(js))
    assert tllama.rope_attention_factor(tcfg) == jllama.rope_attention_factor(jcfg)
    scaling = {"type": "yarn", "factor": 40.0, "original_max_position_embeddings": 4096,
               "beta_fast": 32.0, "beta_slow": 1.0}
    if mscale[0] is not None:
        scaling.update(mscale=mscale[0], mscale_all_dim=mscale[1])
    hf = transformers.DeepseekV2Config(qk_rope_head_dim=64, rope_theta=10000.0,
                                       max_position_embeddings=163840, rope_scaling=scaling)
    inv, factor = _compute_yarn_parameters(hf, "cpu")
    _close(tllama.rope_inv_freq(tcfg).numpy(), inv.numpy())
    assert tllama.rope_attention_factor(tcfg) == pytest.approx(factor, rel=1e-12)
    if mscale == (0.707, 0.707):
        assert tllama.rope_attention_factor(tcfg) == 1.0


def test_interleaved_rope_pairs_adjacent_dims():
    """apply_rope_interleaved rotates (x[2j], x[2j+1]) by the angle of
    frequency j, as a complex product (HF apply_rotary_emb), and its
    batch-last form agrees; both equal dmi_tpu's."""
    jcfg = dataclasses.replace(jllama.tiny_deepseek_config(**TINY), **V2_LITE_ROPE)
    tcfg = bridge.config_from_jax(jcfg)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3, 5, 64)).astype(np.float32)
    pos = np.array([0, 1, 7, 300, 4095])
    tc, ts = tllama.rope_tables(tcfg, torch.from_numpy(pos))
    got = tllama.apply_rope_interleaved(torch.from_numpy(x), tc, ts)
    jc, js = jllama.rope_tables(jcfg, jnp.asarray(pos))
    _close(got.numpy(), np.asarray(jllama.apply_rope_interleaved(jnp.asarray(x), jc, js)))
    z = torch.view_as_complex(torch.from_numpy(x).reshape(2, 3, 5, 32, 2).contiguous())
    ang = torch.polar(torch.ones(5, 32), torch.from_numpy(pos)[:, None].float()
                      * tllama.rope_inv_freq(tcfg))
    _close(got.numpy(), torch.view_as_real(z * ang).reshape(x.shape).numpy())
    bl = tdec._rope_interleaved_bl(torch.from_numpy(x[0, 0].T.copy()), tc.t(), ts.t())
    _close(bl.t().numpy(), got[0, 0].numpy())


# ---------------------------------------------------------------------------
# Quantized expert stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["q", "q8", "w4", "w4-grouped"])
def test_expert_stacks_quantize_and_dequantize_as_dmi_tpu(kind):
    """Expert stacks [L, E, H, I] quantized by dmi_tpu (a lax.map per layer
    and per expert) against the port's per-layer [E, H, I]: the integer
    payloads bit for bit, the scales [E, 1, I] (or [E, G, I]) within 1 ulp,
    and dequantize to the same dense stack."""
    w = (np.random.default_rng(10).normal(size=(2, 4, 32, 24)) * 0.05).astype(np.float32)
    if kind in ("q", "q8"):
        jfn = lambda a: jq.quantize_tensor(a, native=kind == "q8")  # noqa: E731
        tfn = lambda a: tq.quantize_tensor(a, native=kind == "q8")  # noqa: E731
    else:
        group = 8 if kind == "w4-grouped" else None
        jfn = lambda a: jq.quantize_tensor_int4(a, group)  # noqa: E731
        tfn = lambda a: tq.quantize_tensor_int4(a, group)  # noqa: E731
    jw = jfn(jnp.asarray(w))
    for layer in range(2):
        tw = tfn(torch.from_numpy(w[layer]))
        assert sorted(tw) == sorted(jw)
        for key, t in tw.items():
            ref = torch.from_numpy(np.asarray(jw[key])[layer])
            if key in ("s", "s4g"):
                assert t.shape[0] == 4 and t.shape == ref.shape
                assert (t - ref).abs().le(torch.from_numpy(np.spacing(ref.abs().numpy()))).all()
            else:
                assert t.dtype == ref.dtype and torch.equal(t, ref), key
        dense = tq.dequantize(tw, torch.float32)
        jdense = np.asarray(jq.dequantize({k: v[layer] for k, v in jw.items()}, jnp.float32))
        _close(dense.numpy(), jdense, 1e-6)
        _close(dense.numpy(), w[layer], 0.2 if kind.startswith("w4") else 0.02)
