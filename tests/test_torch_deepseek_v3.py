"""DeepSeek-V3 in the port, at tiny widths in f32 on the CPU, against the
benchmark's plain reference (portbench/reference/deepseek_v3.py) and
transformers' DeepseekV3ForCausalLM.

The tiny model: 1 dense + 3 MoE layers, 16 published experts in 4 groups
(the top 2 kept), 4 chosen a token, 4 held (an expert-parallel share: ep
4), 1 shared expert, q-LoRA MLA, yarn at factor 40 with mscale =
mscale_all_dim = 1, so the mscale ** 2 score scale binds.

(a) the loader on the catalog's published config; (b) llama.forward
against the reference; (c) the serving path's prefill and batch-last
decode over the latent cache against the reference's full forward, logits
at every decode position, and the Captioner's greedy ids; (d) the four
held shares, the shared expert counted once, add up to the uncut layer;
(e) the routing's group limit, correction bias and weights; (f) faults
the comparison of (b) catches; (g) every serving mode runs the stack or
refuses it by name; (h) the spans moe.route and decode.mlp.  Besides:
DeepSeek-V2-Lite's published 27-layer stack with its leading dense layer
(ROADMAP F.9) against the reference, and the HF loader on a transformers
DeepseekV3 state dict."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmi_tpu_torch.models import decode as dec
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.serve import Captioner
from dmi_tpu_torch.training import model_utils as tmu
from dmi_tpu_torch.utils import profiling
from portbench import harness as hx
from portbench.reference.deepseek_v3 import Decoder

torch.set_num_threads(1)

YARN = {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1, "mscale": 1,
        "mscale_all_dim": 1, "original_max_position_embeddings": 16}
TINY = {"model_type": "deepseek_v3", "vocab_size": 96, "hidden_size": 64,
        "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 4,
        "num_attention_heads": 4, "num_key_value_heads": 4, "first_k_dense_replace": 1,
        "moe_layer_freq": 1, "n_routed_experts": 4, "ep_size": 4, "n_group": 4,
        "topk_group": 2, "num_experts_per_tok": 4, "n_shared_experts": 1, "q_lora_rank": 24,
        "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8,
        "routed_scaling_factor": 2.5, "norm_topk_prob": True, "rms_norm_eps": 1e-6,
        "rope_theta": 10000, "max_position_embeddings": 640, "rope_scaling": YARN,
        "topk_method": "noaux_tc", "scoring_func": "sigmoid", "hidden_act": "silu",
        "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 1}
# the catalog's DeepSeek-V3 (deepseek-ai/DeepSeek-V3's config.json)
PUBLISHED = {"attention_bias": False, "ep_size": 1, "first_k_dense_replace": 3,
             "hidden_act": "silu", "hidden_size": 7168, "intermediate_size": 18432,
             "kv_lora_rank": 512, "max_position_embeddings": 163840, "model_type": "deepseek_v3",
             "moe_intermediate_size": 2048, "moe_layer_freq": 1, "n_group": 8,
             "n_routed_experts": 256, "n_shared_experts": 1, "norm_topk_prob": True,
             "num_attention_heads": 128, "num_experts_per_tok": 8, "num_hidden_layers": 61,
             "num_key_value_heads": 128, "num_nextn_predict_layers": 1, "q_lora_rank": 1536,
             "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
             "rope_scaling": {**YARN, "original_max_position_embeddings": 4096},
             "rope_theta": 10000, "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
             "tie_word_embeddings": False, "topk_group": 4, "topk_method": "noaux_tc",
             "v_head_dim": 128, "vocab_size": 129280, "bos_token_id": 0, "eos_token_id": 1}
TOL = 1e-4  # f32 on both sides: the port's and the reference's orders of summation


def _cfg(c=TINY, dtype=torch.float32, **change):
    return dataclasses.replace(tmu._hf_to_config(c, dtype, None), **change)


def _params(cfg, seed=3):
    """Weights from the seed, the layers' matrices x10 so that every layer
    moves the logits, the router's scaled so that the scores spread over
    (0, 1), and the correction bias (std 0.1) so that it binds."""
    params = llama.init(cfg, torch.Generator().manual_seed(seed))
    for lw in params["layers"]:
        for k, v in lw.items():
            if v.dim() > 1:
                lw[k] = v * (1.25 if k == "w_router" else 10.0)
        if "router_bias" in lw:
            lw["router_bias"] = lw["router_bias"] * 5.0
    return params


def _x(cfg, B=3, T=9, seed=1):
    return torch.randn(B, T, cfg.hidden_size, generator=torch.Generator().manual_seed(seed))


def _gap(a, b):
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# (a) the loader
# ---------------------------------------------------------------------------

def test_published_config_maps():
    cfg = tmu._hf_to_config(PUBLISHED, torch.bfloat16, None)
    assert cfg.moe_layers == (False,) * 3 + (True,) * 58
    assert (cfg.dense_intermediate_size, cfg.intermediate_size) == (18432, 2048)
    assert (cfg.num_experts, cfg.moe_expert_range, cfg.num_experts_per_tok) == (256, None, 8)
    assert (cfg.moe_scoring, cfg.moe_n_group, cfg.moe_topk_group) == ("sigmoid", 8, 4)
    assert cfg.moe_norm_topk and cfg.routed_scaling_factor == 2.5 and cfg.n_shared_experts == 1
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.head_dim, cfg.v_head_dim) == (1536, 512, 192,
                                                                                  128)
    mscale = 0.1 * np.log(40.0) + 1.0
    assert cfg.attn_scale == pytest.approx(192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert llama.rope_attention_factor(cfg) == 1.0
    assert (cfg.vocab_size, cfg.tie_word_embeddings, cfg.eos_token_ids) == (129280, False, (1,))
    # one EP32 rank's share: 8 held of the router's 256
    share = tmu._hf_to_config({**PUBLISHED, "n_routed_experts": 8, "ep_size": 32},
                              torch.bfloat16, None)
    assert (share.num_experts, share.moe_expert_range) == (256, (0, 8))


def test_share_tree_shapes():
    cfg = _cfg()
    lw = [{k: tuple(v.shape) for k, v in l.items()}
          for l in hx.draw_weights(cfg, 1, "cpu")["layers"]]
    assert lw[0]["w_gate"] == (64, 96) and "w_router" not in lw[0]
    assert lw[1]["w_router"] == (64, 16) and lw[1]["router_bias"] == (16,)
    assert lw[1]["moe_w1"] == (4, 64, 32) and lw[1]["moe_w2"] == (4, 32, 64)
    assert lw[1]["w_shared_gate"] == (64, 32) and "w_gate" not in lw[1]


# ---------------------------------------------------------------------------
# (b) forward against the reference
# ---------------------------------------------------------------------------

def test_forward_matches_the_reference():
    cfg = _cfg()
    params = _params(cfg)
    x = _x(cfg)
    want = Decoder(TINY, params).logits(x)
    assert _gap(llama.forward(cfg, params, x, plain=True), want) < TOL * want.abs().max()
    fused = llama.fuse_projections(params)
    assert _gap(llama.forward(cfg, fused, x, plain=True), want) < TOL * want.abs().max()


# ---------------------------------------------------------------------------
# (c) prefill and batch-last decode through the latent cache
# ---------------------------------------------------------------------------

def test_batch_last_decode_matches_the_reference_at_every_position():
    cfg = _cfg()
    params = llama.fuse_projections(_params(cfg))
    ref = Decoder(TINY, _params(cfg))
    B, T, steps = 3, 5, 6
    ids = torch.randint(0, cfg.vocab_size, (B, steps), generator=torch.Generator().manual_seed(2))
    prompt = _x(cfg, B, T)
    full = torch.cat([prompt, ref.embed(ids[:, :-1])], dim=1)
    want = ref.logits(full, first=T - 1)  # [B, steps, V]
    latent, logits = dec._prefill_caches(cfg, params, prompt, T + steps)
    got = [logits]
    for s in range(steps - 1):
        h = llama.embed_tokens(cfg, params, ids[:, s]).t().contiguous()
        got.append(dec._decode_step_bl(cfg, params, h, latent, T + s, plain=True).t())
    got = torch.stack(got, dim=1)
    assert _gap(got, want) < TOL * want.abs().max(), _gap(got, want)


def _captioner(cfg, params, **kw):
    spec = proj.ProjectorSpec(mm_dim=16, lm_dim=cfg.hidden_size, n_layers=2)
    pp = hx.draw_projector(spec.layer_dims(), 5, "cpu")
    cap = Captioner(dataclasses.replace(cfg, eos_token_ids=()), params, spec, pp,
                    max_new_tokens=6, batch_size=4, prefix_ids=[7, 8, 9], pad_token_id=2, **kw)
    return cap, spec, pp


def _embs(n=4):
    return np.random.default_rng(3).standard_normal((n, 16), dtype=np.float32)


def test_captioner_ids_are_the_reference_argmax():
    """Greedy ids of the Captioner (batch engine, batch-last loop): each is
    the reference's best token at its position, given the ids before it."""
    from portbench.reference.projector import soft_token

    cfg = _cfg()
    params = _params(cfg)
    cap, _, pp = _captioner(cfg, params)
    ids = cap.caption_ids(_embs(), engine="batch")
    ref = Decoder(TINY, params)
    from dmi_tpu_torch.ops import l2_normalize

    soft = soft_token(pp, l2_normalize(torch.as_tensor(_embs())))
    x = torch.cat([soft[:, None], ref.embed(torch.tensor([7, 8, 9])).expand(4, -1, -1),
                   ref.embed(ids[:, :-1])], dim=1)
    logits = ref.logits(x, first=3)
    gap = logits.max(-1).values - logits.gather(-1, ids[..., None])[..., 0]
    assert float(gap.max()) < TOL * float(logits.abs().max())


# ---------------------------------------------------------------------------
# (d) the shares add up to the uncut layer
# ---------------------------------------------------------------------------

def test_held_shares_add_up_to_the_uncut_layer():
    whole = _cfg({**TINY, "n_routed_experts": 16, "ep_size": 1})
    assert whole.moe_expert_range is None and whole.num_experts == 16
    params = _params(whole)
    lw = params["layers"][1]
    h = _x(whole, 4, 8)
    uncut = Decoder({**TINY, "n_routed_experts": 16, "ep_size": 1}, params).routed_mlp(lw, h)
    shared = Decoder(TINY, params).swiglu(h, lw["w_shared_gate"], lw["w_shared_up"],
                                          lw["w_shared_down"])
    parts = []
    for r in range(4):
        cfg = dataclasses.replace(whole, moe_expert_range=(4 * r, 4 * r + 4))
        share = {k: v[4 * r:4 * r + 4] if k.startswith("moe_w") else v for k, v in lw.items()}
        parts.append(llama._moe_mlp(cfg, share, h))
    total = sum(parts) - 3 * shared
    assert _gap(total, uncut) < TOL * uncut.abs().max()
    # each share alone is the reference's rank-0 share where that is rank 0
    ref0 = Decoder(TINY, params).routed_mlp(
        {k: v[:4] if k.startswith("moe_w") else v for k, v in lw.items()}, h)
    assert _gap(parts[0], ref0) < TOL * ref0.abs().max()
    # a share adds its experts' part where some token routed to them, else nothing
    hn = h.reshape(-1, whole.hidden_size)
    routed = llama.moe_gate_weights(whole, hn @ lw["w_router"], lw["router_bias"]) > 0
    used = routed.view(-1, 4, 4).any(-1).any(0).tolist()
    assert sum(used) >= 2
    for p, u in zip(parts, used):
        assert (_gap(p, shared) > 1e-3) == u


# ---------------------------------------------------------------------------
# (e) routing
# ---------------------------------------------------------------------------

def _route(cfg, logits, bias):
    return llama.moe_gate_weights(cfg, logits, bias)


def test_no_expert_outside_the_kept_groups():
    cfg = _cfg()
    g = torch.Generator().manual_seed(7)
    logits, bias = torch.randn(200, 16, generator=g) * 2, torch.randn(16, generator=g) * 0.3
    w = _route(cfg, logits, bias)
    choice = torch.sigmoid(logits) + bias
    score = choice.view(200, 4, 4).topk(2, dim=-1).values.sum(-1)
    kept = torch.zeros(200, 4, dtype=torch.bool).scatter(-1, score.topk(2, dim=-1).indices, True)
    chosen = (w > 0).view(200, 4, 4)
    assert not (chosen & ~kept[..., None]).any()
    assert ((w > 0).sum(-1) == 4).all()
    # without the limit some token chooses outside its best two groups
    free = _route(dataclasses.replace(cfg, moe_n_group=1, moe_topk_group=1), logits, bias)
    assert ((free > 0).view(200, 4, 4) & ~kept[..., None]).any()


def test_bias_moves_the_choice_not_the_weights():
    cfg = _cfg()
    logits = torch.linspace(-2, 2, 16)[None].flip(-1).clone()  # expert 0 best ... 15 worst
    zero = torch.zeros(16)
    assert (_route(cfg, logits, zero)[0] > 0).nonzero().flatten().tolist() == [0, 1, 2, 3]
    bias = zero.clone()
    bias[5] = 10.0  # expert 5 chosen for its bias, in place of expert 3
    w = _route(cfg, logits, bias)[0]
    assert (w > 0).nonzero().flatten().tolist() == [0, 1, 2, 5]
    s = torch.sigmoid(logits[0])
    want = s[[0, 1, 2, 5]] / s[[0, 1, 2, 5]].sum() * 2.5
    assert torch.allclose(w[[0, 1, 2, 5]], want, rtol=1e-6)
    bias[13] = 20.0  # groups 3 and 1 now score best: group 0 is left out
    assert (_route(cfg, logits, bias)[0] > 0).nonzero().flatten().tolist() == [4, 5, 6, 13]


def test_weights_renormalised_and_scaled():
    cfg = _cfg()
    g = torch.Generator().manual_seed(8)
    logits, bias = torch.randn(50, 16, generator=g), torch.randn(16, generator=g) * 0.3
    w = _route(cfg, logits, bias)
    assert torch.allclose(w.sum(-1), torch.full((50,), 2.5), rtol=1e-6)
    raw = _route(dataclasses.replace(cfg, moe_norm_topk=False, routed_scaling_factor=1.0),
                 logits, bias)
    s = torch.sigmoid(logits)
    assert torch.equal(raw > 0, w > 0) and torch.allclose(raw[raw > 0], s[raw > 0])
    # ties go to the lower expert index
    tie = _route(dataclasses.replace(cfg, moe_n_group=1), torch.zeros(1, 16), torch.zeros(16))
    assert (tie[0] > 0).nonzero().flatten().tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# (f) faults the comparison catches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["no_group_limit", "no_bias_in_the_choice", "no_mscale2"])
def test_faults_fail_the_comparison(fault):
    cfg = _cfg()
    params = _params(cfg)
    x = _x(cfg)
    want = Decoder(TINY, params).logits(x)
    if fault == "no_group_limit":
        cfg = dataclasses.replace(cfg, moe_n_group=1, moe_topk_group=1)
    elif fault == "no_mscale2":
        cfg = dataclasses.replace(cfg, attn_scale=None)
    else:
        params = {**params, "layers": [
            {**lw, "router_bias": torch.zeros_like(lw["router_bias"])} if "w_router" in lw
            else lw for lw in params["layers"]]}
    assert _gap(llama.forward(cfg, params, x, plain=True), want) > 100 * TOL * want.abs().max()


# ---------------------------------------------------------------------------
# (g) the serving modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [True, "w8a8", "w4a8"])
def test_quantized_modes_serve_the_stack(int8):
    """Each int8 mode quantizes the dense and the routed layers alike (the
    router and its bias stay as they are) and serves the stack; w8a8 and
    w4a8 prefill on the unquantized originals, so their first tokens are
    the plain path's."""
    cfg = _cfg()
    params = _params(cfg)
    plain = _captioner(cfg, params)[0].caption_ids(_embs())
    cap = _captioner(cfg, params, int8=int8)[0]
    dense, sparse = cap.llm_params["layers"][0], cap.llm_params["layers"][1]
    assert isinstance(dense["w_gu"], dict) and isinstance(sparse["moe_w2"], dict)
    assert isinstance(sparse["wq_b"], dict) and isinstance(sparse["w_shared_down"], dict)
    assert torch.is_tensor(sparse["w_router"]) and torch.is_tensor(sparse["router_bias"])
    ids = cap.caption_ids(_embs())
    assert ids.shape == plain.shape and ((ids >= 0) & (ids < cfg.vocab_size)).all()
    if int8 != True:  # noqa: E712
        assert torch.equal(ids[:, 0], plain[:, 0])


def test_sampled_loop_and_slot_engine_serve_the_stack():
    cfg = _cfg()
    cap = _captioner(cfg, _params(cfg))[0]
    greedy = cap.caption_ids(_embs(), engine="batch")
    assert torch.equal(cap.caption_ids(_embs(), engine="bulk"), greedy)
    a = cap.caption_ids(_embs(), temperature=0.7, top_k=20, seed=3, engine="batch")
    b = cap.caption_ids(_embs(), temperature=0.7, top_k=20, seed=3, engine="bulk")
    assert torch.equal(a, b) and ((a >= 0) & (a < cfg.vocab_size)).all()


def test_mesh_path_runs_a_whole_stack_and_refuses_a_share():
    from dmi_tpu_torch.parallel import sharding

    whole = _cfg({**TINY, "n_routed_experts": 16, "ep_size": 1})
    params = llama.fuse_projections(_params(whole))
    shard = sharding.plan_shard(whole, whole.vocab_size, 1, 0)
    local = sharding.shard_tree(params, whole, shard)
    x = _x(whole, 2, 4)
    assert torch.equal(dec.greedy_generate_bl(whole, local, x, 5, 2, plain=True),
                       dec.greedy_generate_bl(whole, params, x, 5, 2, plain=True))
    with pytest.raises(ValueError, match="expert-parallel rank's share"):
        sharding.plan_shard(_cfg(), 96, 1, 0)
    # two model ranks' partial outputs of a routed and a dense layer (each
    # rank's experts and shared-expert columns, its dense MLP's columns) sum
    # to the whole layer's: the psum the mesh adds
    h = _x(whole, 2, 5)
    for i, fn in ((1, llama._moe_mlp), (0, None)):
        lw = params["layers"][i]
        parts = []
        for r in range(2):
            sh = sharding.plan_shard(whole, whole.vocab_size, 2, r)
            part = sharding._shard_layer(lw, whole, sh)
            if fn is None:
                gate, up = llama._mm(h, part["w_gu"]).chunk(2, dim=-1)
                parts.append(llama._mm(llama.mlp_activation(whole, gate) * up, part["w_down"]))
            else:
                parts.append(fn(sh.local(whole), part, h, sh))
        if fn is None:
            gate, up = llama._mm(h, lw["w_gu"]).chunk(2, dim=-1)
            want = llama._mm(llama.mlp_activation(whole, gate) * up, lw["w_down"])
        else:
            want = fn(whole, lw, h)
        assert _gap(sum(parts), want) < TOL * want.abs().max()


def test_refusals_name_what_is_missing():
    cfg = _cfg()
    spec = proj.ProjectorSpec(mm_dim=16, lm_dim=64, n_layers=2)
    with pytest.raises(NotImplementedError, match="does not support MLA"):
        Captioner(cfg, _params(cfg), spec, hx.draw_projector(spec.layer_dims(), 5, "cpu"),
                  max_new_tokens=4, batch_size=2, prefix_ids=[7], pad_token_id=2,
                  speculative=2).caption_ids(_embs(2))
    fp8 = {"quant_method": "fp8", "fmt": "e4m3", "activation_scheme": "dynamic",
           "weight_block_size": [128, 128]}
    with pytest.raises(NotImplementedError, match="block-scaled FP8"):
        tmu._hf_to_config({**PUBLISHED, "quantization_config": fp8}, torch.bfloat16, None)
    with pytest.raises(NotImplementedError, match="noaux_tc over sigmoid"):
        tmu._hf_to_config({**PUBLISHED, "scoring_func": "softmax"}, torch.bfloat16, None)
    with pytest.raises(NotImplementedError, match="2 or more experts"):
        tmu._hf_to_config({**PUBLISHED, "n_group": 256}, torch.bfloat16, None)


# ---------------------------------------------------------------------------
# (h) spans
# ---------------------------------------------------------------------------

def test_route_and_dense_mlp_spans_only_under_a_profiler(monkeypatch):
    cfg = _cfg()
    cap = _captioner(cfg, _params(cfg))[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cap.caption_ids(_embs())
    counts = {}
    for e in prof.events():
        counts[e.name] = counts.get(e.name, 0) + 1
    steps, dense, sparse = 5, 1, 3
    assert counts["decode.mlp"] == dense * steps
    assert counts["decode.moe"] == sparse * steps and counts["llama.moe"] == sparse
    assert counts["moe.route"] == sparse * (steps + 1)
    assert counts["llama.mlp"] == dense

    def refuse(*a, **k):
        raise AssertionError("a range was entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    assert cap.caption_ids(_embs()).shape == (4, 6)
    assert profiling.span("moe.route") is profiling.span("decode.mlp")


# ---------------------------------------------------------------------------
# DeepSeek-V2-Lite's published mixed stack (ROADMAP F.9)
# ---------------------------------------------------------------------------

V2_LITE = {"model_type": "deepseek_v2", "vocab_size": 96, "hidden_size": 64,
           "intermediate_size": 96, "moe_intermediate_size": 24, "num_hidden_layers": 27,
           "num_attention_heads": 4, "num_key_value_heads": 4, "first_k_dense_replace": 1,
           "moe_layer_freq": 1, "n_routed_experts": 8, "n_shared_experts": 2,
           "num_experts_per_tok": 6, "n_group": 1, "topk_group": 1, "topk_method": "greedy",
           "scoring_func": "softmax", "norm_topk_prob": False, "routed_scaling_factor": 1.0,
           "q_lora_rank": None, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
           "qk_rope_head_dim": 8, "v_head_dim": 8, "rms_norm_eps": 1e-6, "rope_theta": 10000,
           "max_position_embeddings": 640,
           "rope_scaling": {**YARN, "mscale": 0.707, "mscale_all_dim": 0.707},
           "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 1}


def test_v2_lite_published_stack_loads_and_matches_the_reference():
    cfg = _cfg(V2_LITE)
    assert cfg.moe_layers == (False,) + (True,) * 26 and cfg.moe_scoring == "softmax"
    assert cfg.attn_scale is None and cfg.dense_intermediate_size == 96
    params = llama.init(cfg, torch.Generator().manual_seed(4))
    for lw in params["layers"]:
        if "w_router" in lw:
            lw["w_router"] = lw["w_router"] * 12.5
    x = _x(cfg, 2, 7)
    want = Decoder(V2_LITE, params).logits(x)
    assert _gap(llama.forward(cfg, params, x, plain=True), want) < TOL * want.abs().max()
    latent, logits = dec._prefill_caches(cfg, llama.fuse_projections(params), x, 9)
    assert _gap(logits, want[:, -1]) < TOL * want.abs().max()


# ---------------------------------------------------------------------------
# The HF loader
# ---------------------------------------------------------------------------

def _hf_model():
    transformers = pytest.importorskip("transformers")
    c = {**TINY, "n_routed_experts": 16, "ep_size": 1}
    hcfg = transformers.DeepseekV3Config(
        **{k: v for k, v in c.items() if k not in ("model_type", "topk_method",
                                                   "scoring_func", "ep_size")},
        attn_implementation="eager", initializer_range=0.2)
    torch.manual_seed(0)
    hf = transformers.DeepseekV3ForCausalLM(hcfg).eval()
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.copy_(1 + 0.3 * torch.randn(p.shape, generator=gen))
        for name, b in hf.named_buffers():
            if "e_score_correction_bias" in name:
                b.copy_(0.3 * torch.randn(b.shape, generator=gen))
    return c, hf


def test_hf_state_dict_loads_and_matches_transformers():
    c, hf = _hf_model()
    sd = hf.state_dict()
    cfg = _cfg(c)
    params = llama.from_hf_state_dict(sd, cfg)
    lw = params["layers"][1]
    assert lw["router_bias"].dtype == torch.float32 and "w_gate" in params["layers"][0]
    assert torch.equal(lw["router_bias"], sd["model.layers.1.mlp.gate.e_score_correction_bias"])
    ids = torch.randint(0, 96, (2, 12), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = hf(ids).logits
    x = llama.embed_tokens(cfg, params, ids)
    assert _gap(llama.forward(cfg, params, x, plain=True), want) < TOL * want.abs().max()
    assert _gap(Decoder(c, params).logits(x), want) < TOL * want.abs().max()
    # a share reads the experts it holds, and no key is left unused but the others'
    share = dataclasses.replace(cfg, moe_expert_range=(0, 4))
    with pytest.raises(ValueError, match="layout does not use"):
        llama.from_hf_state_dict(sd, share)
    held = {k: v for k, v in sd.items()
            if ".mlp.experts." not in k or int(k.split(".experts.")[1].split(".")[0]) < 4}
    assert llama.from_hf_state_dict(held, share)["layers"][1]["moe_w1"].shape == (4, 64, 32)


def test_build_lm_reads_a_v3_directory(tmp_path, monkeypatch):
    """build_lm on a config.json and safetensors in the HF layout: the MTP
    layer's keys after the stack are left out, as transformers leaves them."""
    from types import SimpleNamespace

    safetensors = pytest.importorskip("safetensors.torch")
    c, hf = _hf_model()
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    sd["model.layers.4.eh_proj.weight"] = torch.zeros(64, 128)
    safetensors.save_file(sd, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({**c, "ep_size": 1,
                                                      "num_nextn_predict_layers": 1}))
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    args = SimpleNamespace(lm_name_or_path=str(tmp_path), lm_dtype="float32")
    cfg, params = tmu.build_lm(args, None)
    assert cfg.moe_layers == (False, True, True, True)
    assert torch.equal(params["layers"][2]["moe_w2"][7],
                       sd["model.layers.2.mlp.experts.7.down_proj.weight"].t())
