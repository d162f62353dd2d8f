"""The decoder families in dmi_tpu_torch against dmi_tpu, on shared weights.

Twelve families and an untied llama, each on dmi_tpu's tiny config function
at f32: llama with tie_word_embeddings=False, mistral and phi-3 (every
layer sliding; phi-3 untied), qwen2 (q/k/v biases), qwen3 (per-head q/k
norms), olmo2 (whole-width q/k norms, post-norm blocks), granite (four
multipliers), gemma-2 and gemma-3 (interleaved sliding layers; gemma-3's
dual rope), the sparse-MoE families mixtral, qwen3-moe and olmoe (4
experts, top 2, dense-evaluated) and deepseek-v2's MLA in four layouts: the
Lite layout (a plain q projection), a q_lora_rank bottleneck, the deepseek
MoE (one shared expert, routed_scaling_factor 2.0) and the MoE with two
shared experts under yarn rope whose attention factor binds. Windows are 8
positions and every sequence here is longer, so they bind. Weights come
from dmi_tpu.models.llama.init through bridge.llm_params_from_jax, the
layer weights scaled to std 0.2 and every norm perturbed so that the norms'
places bind; inputs come from a numpy seed.

Held: the config bridge and the attention route (gemma takes `_attention`,
the rest the flash twin, exactly where dmi_tpu's use_flash holds);
full-sequence logits to 1e-5 relative; greedy ids of both port loops equal
to dmi_tpu's greedy_generate and greedy_generate_bl; the prefill + step
caches against the full forward (MLA's batch-last step over its latent
cache); the slot engine against the batch engine on sliding, dual-rope,
MoE and MLA families; sampled ids with the same injected Gumbel draws (a
fixed table in both packages), where a binding final softcap and
granite's logits scaling must reach the warp; the stage-1 loss and
projector gradients on each attention route; quantized untied heads and
w8a8/w4a8 MoE and MLA trees; the decode MLP's activation following the
config.
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
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.models import mmmodel as tmm
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.models import quant as tq
from dmi_tpu_torch.ops import l2_normalize
from dmi_tpu_torch.serve import Captioner
from dmi_tpu_torch.streaming import StreamingCaptioner

torch.set_num_threads(1)

WINDOW = 8
PAD = 0
TINY = dict(vocab_size=96, hidden_size=64, n_layers=2, n_heads=4, n_kv=2, intermediate=128,
            eos=(5,))
MOE_MLA = ["mixtral", "qwen3moe", "olmoe", "deepseek", "deepseek-q-lora", "deepseek-moe",
           "deepseek-yarn"]
FAMILIES = ["llama-untied", "mistral", "phi3", "qwen2", "qwen3", "olmo2", "granite", "gemma2",
            "gemma3"] + MOE_MLA
SLIDING = ["mistral", "phi3", "gemma2", "gemma3"]
# yarn with deepseek's mscale pair at a factor that binds (1.16 on cos and
# sin) and an original length of 16, so that the ramp spans the rope dims
YARN = dict(rope_yarn_factor=40.0, rope_original_max_position=16, rope_yarn_mscale=1.0,
            rope_yarn_mscale_all_dim=0.5)


def _jcfg(family: str, **changes):
    base = jllama.tiny_config(**TINY)
    every_layer = dict(sliding_window=WINDOW, layer_sliding=(True,) * base.num_hidden_layers)
    cfg = {
        "llama-untied": lambda: dataclasses.replace(base, tie_word_embeddings=False),
        "mistral": lambda: dataclasses.replace(base, **every_layer),
        "phi3": lambda: dataclasses.replace(base, tie_word_embeddings=False, **every_layer),
        "qwen2": lambda: jllama.tiny_qwen2_config(**TINY),
        "qwen3": lambda: jllama.tiny_qwen3_config(**TINY),
        "olmo2": lambda: jllama.tiny_olmo2_config(**TINY),
        "granite": lambda: jllama.tiny_granite_config(**TINY),
        "gemma2": lambda: jllama.tiny_gemma2_config(sliding_window=WINDOW, **TINY),
        "gemma3": lambda: jllama.tiny_gemma3_config(sliding_window=WINDOW, **TINY),
        "mixtral": lambda: jllama.tiny_mixtral_config(**TINY),
        "qwen3moe": lambda: jllama.tiny_qwen3moe_config(**TINY),
        "olmoe": lambda: jllama.tiny_olmoe_config(**TINY),
        "deepseek": lambda: jllama.tiny_deepseek_config(**TINY),
        "deepseek-q-lora": lambda: jllama.tiny_deepseek_config(q_lora_rank=8, **TINY),
        "deepseek-moe": lambda: jllama.tiny_deepseek_config(n_experts=4, n_shared=1,
                                                            routed_scale=2.0, **TINY),
        "deepseek-yarn": lambda: dataclasses.replace(
            jllama.tiny_deepseek_config(n_experts=4, n_shared=2, **TINY), **YARN),
    }[family]()
    return dataclasses.replace(cfg, **changes)


def _models(family: str, seed=0, embed_scale=1.0, **changes):
    """(jcfg, jparams, tcfg, tparams): dmi_tpu's init with the layer
    weights (and biases, and an untied head) scaled to std 0.2, the embed
    by embed_scale, and every norm perturbed by a factor 1 + 0.3 N(0, 1)
    from numpy, in both packages."""
    jcfg = _jcfg(family, **changes)
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(name, a):
        if name.startswith(("w", "b", "moe")) or name == "lm_head":
            return (a * 10.0).astype(a.dtype)
        if "norm" in name or name.startswith("ln"):
            return (a * (1 + 0.3 * rng.normal(size=a.shape))).astype(a.dtype)
        return a

    tree["layers"] = {k: perturb(k, v) for k, v in tree["layers"].items()}
    tree["final_norm"] = perturb("final_norm", tree["final_norm"])
    tree["embed"] = (tree["embed"] * embed_scale).astype(tree["embed"].dtype)
    if "lm_head" in tree:
        tree["lm_head"] = perturb("lm_head", tree["lm_head"])
    return (jcfg, jax.tree.map(jnp.asarray, tree), bridge.config_from_jax(jcfg),
            bridge.llm_params_from_jax(tree))


def _close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Config and the full-sequence forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_config_bridges_and_routes_as_dmi_tpu(family):
    """config_from_jax keeps every dense field, and the fields the port has
    beyond dmi_tpu's (deepseek-v3's routing, expert share and mixed stacks)
    stay at their defaults; the forward's attention route is dmi_tpu's
    use_flash condition (llama.py:1311-1322) at short and window-binding
    lengths, so gemma never reaches the flash kernels."""
    jcfg = _jcfg(family)
    tcfg = bridge.config_from_jax(jcfg)
    for f in dataclasses.fields(tcfg):
        if f.name == "dtype":
            continue
        want = getattr(jcfg, f.name) if hasattr(jcfg, f.name) else f.default
        assert getattr(tcfg, f.name) == want, f.name
    assert {f.name for f in dataclasses.fields(tcfg)} - {f.name for f in dataclasses.fields(jcfg)} \
        == {"moe_scoring", "moe_n_group", "moe_topk_group", "moe_expert_range", "moe_layers",
            "dense_intermediate_size"}
    for T in (4, 13):
        use_flash = (jcfg.attn_logit_softcap is None and not jllama.sliding_effective(jcfg, T)
                     and jcfg.rope_local_theta is None and jcfg.kv_lora_rank is None)
        assert tllama.flash_route(tcfg, T) == use_flash
    assert tllama.flash_route(tcfg, 4) == (family not in ("gemma2", "gemma3")
                                           and not family.startswith("deepseek"))
    assert not tllama.flash_route(tcfg, 13) or family not in SLIDING


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_on_both_routes(family, monkeypatch):
    """Full-sequence logits at T 13 with a ragged key mask against
    dmi_tpu's llama.forward, to 1e-5 relative: the flash wrapper (its twin
    on the CPU) runs on every layer where flash_route holds, and never
    elsewhere; on sliding families
    the window binds (dropping it moves the logits)."""
    jcfg, jparams, tcfg, tparams = _models(family)
    x = _x((3, 13, 64), 1)
    mask = np.ones((3, 13), np.int32)
    mask[1, 9:] = 0
    mask[2, 5:] = 0
    ref = np.asarray(jllama.forward(jcfg, jparams, jnp.asarray(x), jnp.asarray(mask)))
    calls = []
    flash = tllama.flash_attention
    monkeypatch.setattr(tllama, "flash_attention", lambda *a: calls.append(1) or flash(*a))
    out = tllama.forward(tcfg, tparams, torch.from_numpy(x), torch.from_numpy(mask))
    _close(out.numpy(), ref)
    assert len(calls) == (tcfg.num_hidden_layers if tllama.flash_route(tcfg, 13) else 0)
    if family in SLIDING:
        unbound = dataclasses.replace(tcfg, sliding_window=None)
        moved = tllama.forward(unbound, tparams, torch.from_numpy(x), torch.from_numpy(mask))
        assert np.abs(moved.numpy() - ref).max() > 1e-3


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_and_step_caches_match_the_forward(family):
    """Prefill of 5 positions, then a token step at each of 6 more, through
    the batch-first step and the batch-last one (fused layout; MLA over its
    latent cache): each step's logits (through final_softcap) equal the
    full forward's at its position, past the window included."""
    _, _, tcfg, tparams = _models(family, seed=1)
    x = torch.from_numpy(_x((2, 11, 64), 2))
    full = tllama.forward(tcfg, tparams, x)
    fused = tllama.fuse_projections(tparams)
    caches = tdec.init_cache(tcfg, 2, 11)
    _close(tdec.prefill(tcfg, tparams, x[:, :5], caches).numpy(), full[:, 4].numpy())
    caches_bl, logits = tdec._prefill_caches(tcfg, fused, x[:, :5], 11)
    _close(logits.numpy(), full[:, 4].numpy())
    for pos in range(5, 11):
        step = tdec.decode_step(tcfg, tparams, x[:, pos:pos + 1], caches, pos)
        _close(step.numpy(), full[:, pos].numpy())
        h = tllama.scale_embeds(tcfg, x[:, pos].t().contiguous())
        bl = tdec._decode_step_bl(tcfg, fused, h, caches_bl, pos)
        _close(tllama.final_softcap(tcfg, bl).t().numpy(), full[:, pos].numpy())


# ---------------------------------------------------------------------------
# Greedy decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_ids_match_dmi_tpu_on_both_loops(family):
    """A 10-position prompt and 6 new tokens (the window binds in the
    prompt pass and in every step): dmi_tpu's greedy_generate and
    greedy_generate_bl agree, and the port's batch-first loop (unfused) and
    batch-last loop (fused layout) give the same ids."""
    jcfg, jparams, tcfg, tparams = _models(family, seed=2)
    x = _x((4, 10, 64), 3)
    want = np.asarray(jdec.greedy_generate(jcfg, jparams, jnp.asarray(x), 6, PAD))
    bl = np.asarray(jdec.greedy_generate_bl(jcfg, jllama.fuse_projections(jparams),
                                            jnp.asarray(x), 6, PAD))
    np.testing.assert_array_equal(bl, want)
    assert len(np.unique(want)) > 3
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tdec.greedy_generate(tcfg, tparams, xt, 6, PAD).numpy(), want)
    np.testing.assert_array_equal(
        tdec.greedy_generate_bl(tcfg, tllama.fuse_projections(tparams), xt, 6, PAD).numpy(),
        want)


def test_fused_head_is_for_tied_heads_only(monkeypatch):
    """The fused head + argmax reads rows of the head: the tied embed, or an
    untied bf16 lm_head transposed into rows (decode.fused_head_weights), to
    which fused_head=None resolves; its ids equal the logits path's.  A
    quantized untied head (int8 per output column) takes _mm_bl(lm_head, h)
    + argmax, and asking for the fused head there is refused."""
    _, _, tcfg, tparams = _models("llama-untied")
    x = torch.from_numpy(_x((2, 4, 64), 4))
    bf = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    bparams = {k: ([{n: t.bfloat16() for n, t in lw.items()} for lw in v] if k == "layers"
                   else v.bfloat16()) for k, v in tparams.items()}
    read = []
    real = tdec.head_argmax
    monkeypatch.setattr(tdec, "head_argmax", lambda p, h: read.append(p["embed"]) or real(p, h))
    ids = tdec.greedy_generate_bl(bf, bparams, x.bfloat16(), 3, PAD)
    assert len(read) == 2 and all(torch.equal(e, bparams["lm_head"].t()) for e in read)
    off = tdec.greedy_generate_bl(bf, bparams, x.bfloat16(), 3, PAD, fused_head=False)
    assert torch.equal(ids, off) and tuple(ids.shape) == (2, 3)
    qparams = tq.quantize_llama(bparams, quantize_embed=False)
    read.clear()
    tdec.greedy_generate_bl(bf, qparams, x.bfloat16(), 3, PAD)
    assert not read
    with pytest.raises(ValueError, match="untied"):
        tdec.greedy_generate_bl(bf, qparams, x.bfloat16(), 3, PAD, fused_head=True)


def test_decode_mlp_follows_mlp_act(monkeypatch):
    """The batch-last step hands cfg.mlp_act to the decode-MLP kernel (its
    twin here), and llama.mlp_activation computes it: a llama body with
    gelu_tanh gives dmi_tpu's logits on the full forward and on the step."""
    jcfg, jparams, tcfg, tparams = _models("llama-untied", mlp_act="gelu_tanh")
    x = _x((2, 6, 64), 5)
    ref = np.asarray(jllama.forward(jcfg, jparams, jnp.asarray(x)))
    _close(tllama.forward(tcfg, tparams, torch.from_numpy(x)).numpy(), ref)
    acts = []
    mlp = tdec._decode_mlp_plain
    monkeypatch.setattr(tdec, "_decode_mlp_plain", lambda *a: acts.append(a[3]) or mlp(*a))
    fused = tllama.fuse_projections(tparams)
    caches = tdec.init_cache(tcfg, 2, 6)
    tdec.prefill(tcfg, fused, torch.from_numpy(x[:, :5]), caches)
    h = torch.from_numpy(x[:, 5]).t().contiguous()
    logits = tdec._decode_step_bl(tcfg, fused, h, caches, 5, plain=True)
    _close(logits.t().numpy(), ref[:, 5])
    assert acts == ["gelu_tanh"] * tcfg.num_hidden_layers
    g = torch.linspace(-4, 4, 33)
    _close(tllama.mlp_activation(tcfg, g).numpy(),
           np.asarray(jax.nn.gelu(jnp.asarray(g.numpy()), approximate=True)))


# ---------------------------------------------------------------------------
# The slot engine
# ---------------------------------------------------------------------------


def _serving(family, seed, eos=(5,)):
    """The port's tiny LM of `family` and a 2-layer projector (mm 16)."""
    _, _, tcfg, tparams = _models(family, seed=seed, eos_token_ids=eos)
    spec = tproj.ProjectorSpec(mm_dim=16, lm_dim=64)
    jpp = jproj.init(jax.random.key(seed + 1), jproj.ProjectorSpec(mm_dim=16, lm_dim=64))
    return tcfg, tparams, spec, bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))


@pytest.mark.parametrize("family", SLIDING + MOE_MLA)
def test_slot_engine_matches_the_batch_engine(family):
    """13 requests, a 4-position prompt and a budget of 9 (the window binds
    from position 8): the slot engine's ring rows carry their positions
    (row_pos), so run and run_bulk at a pool smaller than the workload give
    the batch engine's greedy ids, and its sampled ids under the same
    request-indexed draws (softcapped before the warp).  The MoE families
    route per slot as the batch engine routes per row, and MLA's slots
    hold latent rows roped at each slot's own position."""
    tcfg, tparams, spec, pp = _serving(family, seed=4)
    prefix, budget = np.asarray([3, 7, 9]), 9
    embs = l2_normalize(torch.from_numpy(_x((13, 16), 6))).numpy()
    cap = Captioner(tcfg, tparams, spec, pp, max_new_tokens=budget, batch_size=4,
                    prefix_ids=prefix, pad_token_id=PAD)
    for sample in (None, dict(temperature=0.8, top_k=10, top_p=0.9, seed=3)):
        kw = sample or {}
        want = cap.caption_ids(embs, engine="batch", **kw)
        assert len(np.unique(want.numpy())) > 3
        eng = StreamingCaptioner(tcfg, tparams, spec, pp, prefix, budget, PAD, pool=5, admit=2,
                                 k_steps=3, **kw)
        assert torch.equal(eng.run(embs), want)
        assert torch.equal(eng.run_bulk(embs), want)
        assert torch.equal(cap.caption_ids(embs, engine="bulk", **kw), want)
    if family not in SLIDING:
        return
    wide = dataclasses.replace(tcfg, sliding_window=64)  # a window that never binds
    wide_ids = Captioner(wide, tparams, spec, pp, max_new_tokens=budget, batch_size=4,
                         prefix_ids=prefix, pad_token_id=PAD).caption_ids(embs)
    assert not torch.equal(wide_ids, cap.caption_ids(embs))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_sampled_ids_match_with_injected_draws(family, monkeypatch):
    """Both packages draw with one fixed Gumbel table G [V, B] from numpy
    (argmax over tokens of warped + G, every step), so the draw is no
    longer the packages' own: dmi_tpu's sample_generate_bl and the port's
    give the same ids at temperature 0.7, top_k 8, top_p 0.9.  The embed is
    scaled to std 0.2 (logits of a few units), gemma-2's final cap is 2.0
    here and granite scales its logits by 1/16: dropping either moves the
    ids, so the transformed logits reach the warp.  The
    port's batch-first loop (no top_p) gives its batch-last loop's ids."""
    changes = {"final_logit_softcap": 2.0} if family == "gemma2" else {}
    jcfg, jparams, tcfg, tparams = _models(family, seed=3, embed_scale=10.0, eos_token_ids=(),
                                           **changes)
    V, B, n = tcfg.vocab_size, 5, 7
    g = np.random.default_rng(7).gumbel(size=(V, B)).astype(np.float32)
    monkeypatch.setattr(jdec, "_sample_pick_bl", lambda logits, keys, t, k, p=1.0: jnp.argmax(
        jdec._warp_bl(logits, t, k, p) + jnp.asarray(g), axis=0).astype(jnp.int32))
    monkeypatch.setattr(tdec, "_gumbel_pick",
                        lambda warped, keys: (warped + torch.from_numpy(g)).argmax(dim=0))
    x = _x((B, 6, 64), 8)
    kw = dict(temperature=0.7, top_k=8, top_p=0.9)
    jax.clear_caches()  # the jitted loop must trace the injected pick
    want = np.asarray(jdec.sample_generate_bl(jcfg, jparams, jnp.asarray(x), n, PAD,
                                              jax.random.key(0), **kw))
    jax.clear_caches()
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tdec.sample_generate_bl(tcfg, tparams, xt, n, PAD, **kw).numpy(), want)
    assert len(np.unique(want)) > 3
    greedy = np.asarray(tdec.greedy_generate_bl(tcfg, tparams, xt, n, PAD).numpy())
    assert (want != greedy).any()  # the draws moved tokens
    kw_bf = dict(temperature=0.7, top_k=8)
    np.testing.assert_array_equal(
        tdec.sample_generate(tcfg, tparams, xt, n, PAD, **kw_bf).numpy(),
        tdec.sample_generate_bl(tcfg, tparams, xt, n, PAD, **kw_bf).numpy())
    if family in ("gemma2", "granite"):
        plain = dataclasses.replace(tcfg, final_logit_softcap=None, logit_scale=None)
        moved = tdec.sample_generate_bl(plain, tparams, xt, n, PAD, **kw).numpy()
        assert (moved != want).any()


# ---------------------------------------------------------------------------
# Training and quantized serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["qwen2", "gemma2", "gemma3"] + MOE_MLA)
def test_stage1_loss_and_projector_gradients_match(family):
    """caption_loss over a ragged batch of 12 text tokens (the window binds)
    with the attention mask passed: the loss, its gradient with respect to
    the soft tokens and every projector gradient against dmi_tpu's
    value_and_grad, to 1e-5 relative; qwen2 and the MoE families through
    the flash twin, gemma and MLA through `_attention`; the routed MLP's
    gradient reaches the soft tokens through every expert."""
    jcfg, jparams, tcfg, tparams = _models(family, seed=5)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    jspec = jproj.ProjectorSpec(mm_dim=24, lm_dim=64)
    jpp = jproj.init(jax.random.key(1), jspec)
    rng = np.random.default_rng(9)
    embs = rng.normal(size=(3, 24)).astype(np.float32)
    ids = rng.integers(6, 96, size=(3, 12))
    mask = np.ones((3, 12), np.int32)
    mask[1, 8:] = mask[2, 5:] = 0
    labels = np.where(mask == 1, ids, 1)
    labels[:, :3] = -100
    jargs = tuple(map(jnp.asarray, (ids, mask, labels)))

    def jloss(pp, soft_delta):
        soft = jproj.apply(jspec, pp, jnp.asarray(embs)) + soft_delta
        return jmm.caption_loss(jcfg, jparams, soft, *jargs, mask_padding=True)

    ref, (jg_pp, jg_soft) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jpp, jnp.zeros((3, 64), jnp.float32))
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    leaves = [t.requires_grad_() for layer in tpp["layers"] for t in (layer["b"], layer["w"])]
    soft = tproj.apply(bridge.projector_spec_from_jax(jspec), tpp, torch.from_numpy(embs))
    soft.retain_grad()
    loss = tmm.caption_loss(tcfg, tparams, soft, *map(torch.from_numpy, (ids, mask, labels)),
                            mask_padding=True)
    loss.backward()
    _close(loss.item(), float(ref))
    _close(soft.grad.numpy(), np.asarray(jg_soft))
    want = [g for layer in jg_pp["layers"] for g in (layer["b"], layer["w"])]
    for t, g in zip(leaves, want):
        _close(t.grad.numpy(), np.asarray(g))


@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
def test_quantized_untied_head_matches_dmi_tpu(mode):
    """quantize_llama quantizes an untied lm_head as a layer weight, bit for
    bit with dmi_tpu's tree (phi-3: untied, every layer sliding); the
    batch-last loop over it (int8 kernels' twins for the head), with the
    unquantized tree for the prompt pass, gives dmi_tpu's ids."""
    jcfg, jparams, tcfg, tparams = _models("phi3", seed=6)
    jfused, tfused = jllama.fuse_projections(jparams), tllama.fuse_projections(tparams)
    kw = dict(native=True) if mode == "w8a8" else dict(bits=4)
    jtree = jq.quantize_llama(jfused, **kw)
    ttree = tq.quantize_llama(tfused, **kw)
    ref = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jtree))
    head = "q8" if mode == "w8a8" else "qp"
    assert head in ttree["lm_head"]
    for key in ttree["lm_head"]:
        assert torch.equal(ttree["lm_head"][key], ref["lm_head"][key]), key
    x = _x((4, 10, 64), 10)
    want = np.asarray(jdec.greedy_generate_bl(jcfg, jtree, jnp.asarray(x), 6, PAD,
                                              prefill_params=jfused))
    got = tdec.greedy_generate_bl(tcfg, ttree, torch.from_numpy(x), 6, PAD,
                                  prefill_params=tfused)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
@pytest.mark.parametrize("family", MOE_MLA)
def test_quantized_moe_and_mla_match_dmi_tpu(family, mode):
    """quantize_llama over the MoE and MLA leaves (expert stacks with
    per-expert scales, fuse_projections' gate and up stacks [E, I, H]
    quantized along H, MLA's projections, the shared experts; the
    router and the a-norms untouched) is dmi_tpu's tree (integer payloads
    bit for bit, scales within 1 ulp, as tests/test_torch_quant.py), and the
    batch-last loop over it (expert stacks dequantized into the expert
    products, the 2-D projections through the int8 kernels' twins), with the
    unquantized tree for the prompt pass, gives dmi_tpu's ids."""
    jcfg, jparams, tcfg, tparams = _models(family, seed=6)
    jfused, tfused = jllama.fuse_projections(jparams), tllama.fuse_projections(tparams)
    kw = dict(native=True) if mode == "w8a8" else dict(bits=4)
    jtree = jq.quantize_llama(jfused, **kw)
    ttree = tq.quantize_llama(tfused, **kw)
    ref = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jtree))
    for got, want in zip(ttree["layers"], ref["layers"]):
        # fuse_projections' gate and up stacks moe_w1t/moe_w3t [E, I, H]
        # hold dmi_tpu's [E, H, I] payloads and scales transposed
        rows = {k[:-1]: k for k in tq.EXPERT_ROWS if k in got}
        assert set(got) == {rows.get(k, k) for k in want}
        for name, leaf in want.items():
            mine = got[rows.get(name, name)]
            assert isinstance(mine, dict) == isinstance(leaf, dict), name
            for key, t in (leaf.items() if isinstance(leaf, dict) else [("", leaf)]):
                g = mine[key] if key else mine
                if name in rows:
                    g = g.transpose(1, 2)
                if key in ("s", "s4g"):
                    # dmi_tpu's lax.map over the stacked layers (and experts)
                    # may divide by 127 as a product with its reciprocal
                    ulp = torch.from_numpy(np.spacing(t.abs().numpy()))
                    assert (g - t).abs().le(ulp).all(), (name, key)
                else:
                    assert g.dtype == t.dtype and torch.equal(g, t), (name, key)
    assert not isinstance(ttree["layers"][0].get("w_router", 0), dict)
    x = _x((4, 10, 64), 10)
    want = np.asarray(jdec.greedy_generate_bl(jcfg, jtree, jnp.asarray(x), 6, PAD,
                                              prefill_params=jfused))
    got = tdec.greedy_generate_bl(tcfg, ttree, torch.from_numpy(x), 6, PAD,
                                  prefill_params=tfused)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 3
