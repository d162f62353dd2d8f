"""HF-layout weights of the decoder families in the port, against dmi_tpu
and HF.

For each model type (llama untied, mistral, qwen2, qwen3, phi3, olmo2,
granite, gemma2, gemma3_text, and the MoE and MLA types mixtral, qwen3_moe,
olmoe, deepseek_v2: 4 experts, top 2; deepseek's Lite layout with a shared
expert, routed_scaling_factor 2 and yarn rope whose attention factor binds)
a random tiny transformers model is built, its norms perturbed so that
their places and gemma's (1 + w) fold bind, and saved with save_pretrained
(config.json and safetensors). The port's build_lm, which reads both itself
without transformers, must give dmi_tpu's build_lm config (through
bridge.config_from_jax) and parameters bit for bit (phi-3's fused
projections split, gemma's norms folded in f32, an untied lm_head); at f32
the port's forward agrees with HF's own to 1e-4 relative over 12 positions,
past the 8-position windows. A config.json with each family's optional keys
left out maps as dmi_tpu maps the config object that transformers fills
with its class defaults: the port supplies those defaults itself. Every
refusal dmi_tpu keeps for the MoE and MLA types the port keeps too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.config import LMArgs
from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.training import model_utils as jmu
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.training import hf_weights
from dmi_tpu_torch.training import model_utils as tmu

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

BASE = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4)
SIZES = dict(num_key_value_heads=2, head_dim=16, initializer_range=0.2, bos_token_id=0,
             eos_token_id=3, pad_token_id=1, attn_implementation="eager",
             max_position_embeddings=256)
# model type: (transformers classes, the family's options in the saved config)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(tie_word_embeddings=False,
                                                      rope_theta=500000.0)),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(sliding_window=8)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(tie_word_embeddings=True)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(rms_norm_eps=1e-5)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(sliding_window=8)),
    "olmo2": ("Olmo2Config", "Olmo2ForCausalLM", dict()),
    "granite": ("GraniteConfig", "GraniteForCausalLM",
                dict(embedding_multiplier=12.0, attention_multiplier=0.03125,
                     residual_multiplier=0.22, logits_scaling=16.0)),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(sliding_window=8, query_pre_attn_scalar=16, final_logit_softcapping=3.0)),
    "gemma3_text": ("Gemma3TextConfig", "Gemma3ForCausalLM",
                    dict(sliding_window=8, query_pre_attn_scalar=16,
                         layer_types=["sliding_attention", "full_attention"],
                         rope_scaling={"rope_type": "linear", "factor": 8.0})),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(num_local_experts=4, num_experts_per_tok=2, sliding_window=8)),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
                       norm_topk_prob=True)),
    "olmoe": ("OlmoeConfig", "OlmoeForCausalLM", dict(num_experts=4, num_experts_per_tok=2)),
    "deepseek_v2": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                    dict(num_key_value_heads=4, q_lora_rank=None, kv_lora_rank=16,
                         qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
                         n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
                         moe_intermediate_size=48, routed_scaling_factor=2.0,
                         first_k_dense_replace=0,
                         rope_scaling={"type": "yarn", "factor": 40.0, "beta_fast": 32.0,
                                       "beta_slow": 1.0, "mscale": 1.0,
                                       "mscale_all_dim": 0.5,
                                       "original_max_position_embeddings": 16})),
}
# what a config.json of each type needs beyond BASE (the class default is None)
REQUIRED = {"deepseek_v2": {"num_experts_per_tok": 2}}
GEMMA = ("gemma2", "gemma3_text")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{model type: (the HF model, its directory)}."""
    root = tmp_path_factory.mktemp("hf_families")
    out = {}
    for i, (family, (cfg_cls, model_cls, opts)) in enumerate(FAMILIES.items()):
        cfg = getattr(transformers, cfg_cls)(**{**BASE, **SIZES, **opts})
        torch.manual_seed(i)
        hf = getattr(transformers, model_cls)(cfg).eval()
        gen = torch.Generator().manual_seed(100 + i)
        with torch.no_grad():
            for name, p in hf.named_parameters():
                if "norm" in name:  # gemma stores w of (1 + w); the rest w itself
                    base = 0.0 if family in GEMMA else 1.0
                    p.copy_(base + 0.3 * torch.randn(p.shape, generator=gen))
        hf.save_pretrained(root / family)
        out[family] = (hf, root / family)
    return out


@pytest.fixture()
def tok():
    return build_test_tokenizer()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_build_lm_equals_dmi_tpu(saved, family, dtype, tok, monkeypatch):
    """The port's build_lm (no transformers) against dmi_tpu's (which loads
    through AutoModelForCausalLM): the same config and every tensor bit for
    bit, in the same dtypes."""
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    _, path = saved[family]
    args = LMArgs(lm_name_or_path=str(path), lm_dtype=dtype)
    tcfg, tparams = tmu.build_lm(args, tok)
    jcfg, jparams = jmu.build_lm(args, tok)
    assert tcfg == bridge.config_from_jax(jcfg)
    want = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(tparams) == set(want)
    assert ("lm_head" in tparams) == (not tcfg.tie_word_embeddings)
    for key in set(want) - {"layers"}:
        assert tparams[key].dtype == want[key].dtype and torch.equal(tparams[key], want[key])
    for got, ref in zip(tparams["layers"], want["layers"]):
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
            assert got[k].is_contiguous()
    if family in GEMMA:  # the (1 + w) fold, stored in f32
        assert tparams["final_norm"].dtype == torch.float32


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_matches_hf(saved, family, tok, monkeypatch):
    """At f32 the port's forward over 12 token embeddings (the windows of 8
    bind) agrees with HF's own logits to 1e-4 relative."""
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    hf, path = saved[family]
    tcfg, tparams = tmu.build_lm(LMArgs(lm_name_or_path=str(path), lm_dtype="float32"), tok)
    ids = torch.from_numpy(np.random.default_rng(1).integers(4, 96, size=(2, 12)))
    with torch.no_grad():
        ref = hf(input_ids=ids).logits
    out = tllama.forward(tcfg, tparams, tllama.embed_tokens(tcfg, tparams, ids))
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_defaults_match_the_config_classes(family, tmp_path):
    """A config.json with only the required keys: the port's defaults give
    what dmi_tpu reads from the transformers config object built from the
    same keys."""
    import json
    import types

    minimal = {"model_type": family, **BASE, **REQUIRED.get(family, {})}
    (tmp_path / "config.json").write_text(json.dumps(minimal))
    tok = types.SimpleNamespace(eos_token_id=7)
    ours = tmu._hf_to_config(hf_weights.read_config(tmp_path), torch.float32, tok)
    obj = getattr(transformers, FAMILIES[family][0])(**minimal)
    assert ours == bridge.config_from_jax(jmu._hf_to_config(obj, jnp.float32, tok))


def test_refusals_name_a9_and_phi3_fused_layout(saved):
    """MoE and MLA keys beside a dense layout are refused, not ignored;
    phi-3's checkpoint holds only the fused projections, which the port
    splits."""
    _, path = saved["phi3"]
    sd = hf_weights.load_state_dict(path)
    assert "model.layers.0.self_attn.qkv_proj.weight" in sd
    assert "model.layers.0.self_attn.q_proj.weight" not in sd
    cfg = tmu._hf_to_config(hf_weights.read_config(path), torch.float32, None)
    params = tllama.from_hf_state_dict(sd, cfg)
    assert {"wq", "wk", "wv", "w_gate", "w_up"} <= set(params["layers"][0])
    for extra in ("model.layers.0.mlp.experts.0.gate_proj.weight",
                  "model.layers.0.self_attn.kv_b_proj.weight"):
        with pytest.raises(ValueError, match="layout does not use"):
            tllama.from_hf_state_dict({**sd, extra: torch.ones(4)}, cfg)


@pytest.mark.parametrize("family,change", [
    ("qwen3_moe", {"decoder_sparse_step": 2}),
    ("qwen3_moe", {"mlp_only_layers": [0]}),
    ("deepseek_v2", {"first_k_dense_replace": 1, "num_hidden_layers": 27}),
    ("deepseek_v2", {"first_k_dense_replace": 1}),
    ("deepseek_v2", {"topk_method": "group_limited_greedy", "n_group": 2, "topk_group": 1}),
    ("deepseek_v2", {"attention_bias": True}),
    ("olmoe", {"clip_qkv": 8.0}),
    ("olmoe", {"attention_bias": True}),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()))
def test_refusals_dmi_tpu_keeps(family, change):
    """What dmi_tpu refuses for the MoE and MLA types the port refuses too:
    qwen3-moe's mixed dense and sparse stacks (decoder_sparse_step and
    mlp_only_layers), group-limited routing, olmoe's clip_qkv and attention
    bias, deepseek's attention bias.  Deepseek's mixed stacks
    (first_k_dense_replace between 0 and the layer count, as in V2-Lite's 1
    of 27), which dmi_tpu refuses, the port computes: its leading layers
    dense, the rest routed (tests/test_torch_deepseek_v3.py holds them to
    the reference)."""
    import types

    cfg = {"model_type": family, **BASE, **REQUIRED.get(family, {}), **change}
    tok = types.SimpleNamespace(eos_token_id=7)
    obj = getattr(transformers, FAMILIES[family][0])(**cfg)
    with pytest.raises(ValueError):
        jmu._hf_to_config(obj, jnp.float32, tok)
    if family == "deepseek_v2" and "first_k_dense_replace" in change:
        dense = change["first_k_dense_replace"]
        got = tmu._hf_to_config(cfg, torch.float32, tok)
        assert got.moe_layers == tuple(i >= dense for i in range(cfg["num_hidden_layers"]))
        assert got.dense_intermediate_size == cfg["intermediate_size"]
        return
    with pytest.raises(NotImplementedError, match="outside the layouts"):
        tmu._hf_to_config(cfg, torch.float32, tok)
