"""Llama weights in the HF layout in the port, against dmi_tpu and HF.

A random tiny transformers.LlamaForCausalLM (tied head, a llama3
rope_scaling block) is saved with save_pretrained four ways: one
safetensors file, sharded safetensors, `.bin` (safe_serialization=False)
and inside an HF hub cache tree reached through HF_HUB_CACHE.  For each,
the port's build_lm (which reads config.json and the weights itself) must
give dmi_tpu's build_lm config (through bridge.config_from_jax) and its
parameters bit for bit at f32 and bf16; at f32 its logits agree with
dmi_tpu's to 1e-5 relative and with HF's own forward to 1e-3, and greedy
tokens are identical.  dmi_tpu always reads a local directory (the cache
case: the snapshot), so that nothing looks for the hub.  Also: the
weights load with transformers and safetensors unimportable, the MoE and
MLA model types map as dmi_tpu maps them and the options outside the
layouts stay refused, the tokenizer matches dmi_tpu's, the published
Llama-3.2-1B-Instruct config maps to llama.llama32_1b(), and the smoke's
safetensors writer agrees with the safetensors package and the port's
reader.
"""

import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dmi_tpu.config import LMArgs
from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu.training import model_utils as jmu
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.training import hf_weights
from dmi_tpu_torch.training import model_utils as tmu

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

HUB_ID = "smoke-org/tiny-llama"
EOS = (3, 5)
CASES = ["single", "sharded", "bin", "cache"]
DTYPES = ["float32", "bfloat16"]


def _hf_config(**kw):
    base = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                rope_theta=10000.0, max_position_embeddings=256, rms_norm_eps=1e-5,
                rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                              "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
                tie_word_embeddings=True, attn_implementation="eager", bos_token_id=0,
                eos_token_id=list(EOS), pad_token_id=1, initializer_range=0.2)
    return transformers.LlamaConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The HF model and {case: (directory or hub id, the local directory
    dmi_tpu reads, the HF cache root or None)}."""
    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(_hf_config()).eval()
    hf.save_pretrained(root / "single")
    hf.save_pretrained(root / "sharded", max_shard_size="40KB")
    hf.save_pretrained(root / "bin", safe_serialization=False)
    cache = root / "hub"
    repo = cache / ("models--" + HUB_ID.replace("/", "--"))
    snapshot = repo / "snapshots" / "0123abcd"
    shutil.copytree(root / "single", snapshot)
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abcd")
    assert len(list((root / "sharded").glob("model-*.safetensors"))) > 2
    assert (root / "bin" / "pytorch_model.bin").exists()
    cases = {name: (str(root / name), str(root / name), None)
             for name in ("single", "sharded", "bin")}
    cases["cache"] = (HUB_ID, str(snapshot), str(cache))
    return hf, cases


@pytest.fixture()
def tok():
    return build_test_tokenizer()


def _build_both(saved, case, dtype, tok, monkeypatch):
    _, cases = saved
    name, local, cache = cases[case]
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    if cache:
        monkeypatch.setenv("HF_HUB_CACHE", cache)
    tcfg, tparams = tmu.build_lm(LMArgs(lm_name_or_path=name, lm_dtype=dtype), tok)
    jcfg, jparams = jmu.build_lm(LMArgs(lm_name_or_path=local, lm_dtype=dtype), tok)
    return tcfg, tparams, jcfg, jparams


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_config_and_params_equal_dmi_tpu(saved, case, dtype, tok, monkeypatch):
    tcfg, tparams, jcfg, jparams = _build_both(saved, case, dtype, tok, monkeypatch)
    assert tcfg == bridge.config_from_jax(jcfg)
    assert tcfg.rope_scaling_factor == 8.0 and tcfg.rope_original_max_position == 64
    assert tcfg.eos_token_ids == EOS and tcfg.dtype == getattr(torch, dtype)
    want = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(tparams) == set(want) == {"embed", "layers", "final_norm"}
    for key in ("embed", "final_norm"):
        assert tparams[key].dtype == want[key].dtype and torch.equal(tparams[key], want[key])
    assert len(tparams["layers"]) == len(want["layers"]) == 2
    for got, ref in zip(tparams["layers"], want["layers"]):
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
            assert got[k].is_contiguous()


@pytest.mark.parametrize("case", CASES)
def test_logits_and_greedy_tokens_match(saved, case, tok, monkeypatch):
    """At f32: logits against dmi_tpu's forward (1e-5 relative) and HF's
    (1e-3, as tests/test_model_utils.py holds dmi_tpu), with a right-padded
    row; greedy tokens identical to dmi_tpu's."""
    hf, _ = saved
    tcfg, tparams, jcfg, jparams = _build_both(saved, case, "float32", tok, monkeypatch)
    rng = np.random.default_rng(0)
    embeds = rng.normal(size=(3, 9, 64)).astype(np.float32) * 0.1
    mask = np.ones((3, 9), np.int64)
    mask[1, -3:] = 0
    ours = tllama.forward(tcfg, tparams, torch.from_numpy(embeds), torch.from_numpy(mask))
    ref = np.asarray(jllama.forward(jcfg, jparams, jnp.asarray(embeds), jnp.asarray(mask)))
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(ours.detach().numpy() - ref).max() <= 1e-5 * scale
    with torch.no_grad():
        theirs = hf(inputs_embeds=torch.from_numpy(embeds),
                    attention_mask=torch.from_numpy(mask)).logits.numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(ours.detach().numpy()[valid], theirs[valid], atol=1e-3, rtol=1e-3)
    t = tdec.greedy_generate(tcfg, tparams, torch.from_numpy(embeds), 8, 1).numpy()
    j = np.asarray(jdec.greedy_generate(jcfg, jparams, jnp.asarray(embeds), 8, 1))
    np.testing.assert_array_equal(t, j)
    assert len(np.unique(t)) > 2


@pytest.mark.parametrize("case", ["single", "sharded", "bin", "cache"])
def test_weights_load_without_transformers_or_safetensors(saved, case, tok, monkeypatch):
    """The card's machine has neither package: with both unimportable the
    weights still load, bit-equal to the load with them; the real
    tokenizer is what needs transformers."""
    _, cases = saved
    name, _, cache = cases[case]
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    if cache:
        monkeypatch.setenv("HF_HUB_CACHE", cache)
    with_pkgs = tmu.build_lm(LMArgs(lm_name_or_path=name, lm_dtype="bfloat16"), tok)[1]
    for mod in [m for m in sys.modules if m.split(".")[0] in ("transformers", "safetensors")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    cfg, params = tmu.build_lm(LMArgs(lm_name_or_path=name, lm_dtype="bfloat16"), tok)
    assert cfg.num_hidden_layers == 2
    assert torch.equal(params["embed"], with_pkgs["embed"])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(params["layers"], with_pkgs["layers"])
               for k in a)
    with pytest.raises(ImportError):
        tmu.build_tokenizer(LMArgs(lm_name_or_path=name))


def test_hf_cache_resolution(saved, tmp_path, monkeypatch):
    """HF_HUB_CACHE, else HF_HOME/hub, else ~/.cache/huggingface/hub; an id
    the cache lacks raises and names the paths searched."""
    _, cases = saved
    _, snapshot, cache = cases["cache"]
    monkeypatch.setenv("HF_HUB_CACHE", cache)
    assert hf_weights.model_dir(HUB_ID) == Path(snapshot)
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    assert hf_weights.hub_cache() == tmp_path / "home" / "hub"
    monkeypatch.delenv("HF_HOME")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert hf_weights.hub_cache() == tmp_path / ".cache" / "huggingface" / "hub"
    with pytest.raises(FileNotFoundError, match="models--smoke-org--tiny-llama"):
        hf_weights.model_dir(HUB_ID)
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        hf_weights.load_state_dict(tmp_path)


def test_dmi_lm_override_substitutes_the_lm(monkeypatch, tok):
    """DMI_LM_OVERRIDE runs a config's LM name as a test model, as in dmi_tpu."""
    monkeypatch.setenv("DMI_LM_OVERRIDE", "test:tiny")
    cfg, _ = tmu.build_lm(LMArgs(lm_name_or_path="meta-llama/Llama-3.2-1B-Instruct",
                                 lm_dtype="float32"), tok)
    assert cfg.num_hidden_layers == 2 and cfg.hidden_size == 64
    assert tmu.build_tokenizer(LMArgs(lm_name_or_path="anything")).vocab_size == tok.vocab_size


def test_tokenizer_from_local_dir_matches_dmi_tpu(tmp_path, monkeypatch):
    """tests/test_model_utils.py::test_tokenizer_from_local_dir on both
    packages: pad set to eos, the same ids and text."""
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    src = build_test_tokenizer()
    src.save_pretrained(tmp_path / "tok")
    args = LMArgs(lm_name_or_path=str(tmp_path / "tok"))
    ours, ref = tmu.build_tokenizer(args), jmu.build_tokenizer(args)
    assert ours.pad_token == ours.eos_token == ref.pad_token
    text = "a dog runs"
    assert ours(text)["input_ids"] == ref(text)["input_ids"]
    assert ours.decode(ours(text)["input_ids"]) == src.decode(src(text)["input_ids"])
    assert ours.chat_template == ref.chat_template


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

MOE_CLASSES = {"mixtral": "MixtralConfig", "qwen3_moe": "Qwen3MoeConfig",
               "olmoe": "OlmoeConfig", "deepseek_v2": "DeepseekV2Config"}


@pytest.mark.parametrize("change", [
    {"model_type": "mixtral"}, {"model_type": "deepseek_v2"}, {"model_type": "qwen3_moe"},
    {"attention_bias": True}, {"mlp_bias": True}, {"hidden_act": "gelu"},
    {"model_type": "olmoe"},
    {"rope_scaling": {"type": "dynamic", "factor": 2.0}},
    {"rope_scaling": {"rope_type": "yarn", "factor": 4.0}},
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items())[:40])
def test_config_refusals_name_a9(saved, change):
    """The llama config.json with one change, which the port once refused
    naming A.9, held to what dmi_tpu does with it.  The mixtral, qwen3_moe
    and olmoe model types map as dmi_tpu maps the transformers config
    object built from the same keys; deepseek_v2 here has routed experts
    and no num_experts_per_tok, which both refuse (dmi_tpu with a
    TypeError).  An o_proj bias (llama's attention_bias), MLP biases,
    another activation, dynamic rope and yarn outside deepseek stay refused
    as outside the layouts."""
    _, cases = saved
    cfg = {**hf_weights.read_config(cases["single"][0]), **change}
    family = change.get("model_type")
    if family in MOE_CLASSES:
        obj = getattr(transformers, MOE_CLASSES[family])(**cfg)
    if family in MOE_CLASSES and family != "deepseek_v2":
        ours = tmu._hf_to_config(cfg, torch.float32, None)
        assert ours.num_experts > 0
        assert ours == bridge.config_from_jax(jmu._hf_to_config(obj, jnp.float32, None))
        return
    if family == "deepseek_v2":
        with pytest.raises(TypeError):
            jmu._hf_to_config(obj, jnp.float32, None)
    with pytest.raises(NotImplementedError, match="outside the layouts"):
        tmu._hf_to_config(cfg, torch.float32, None)


def test_config_defaults_and_eos_fallback():
    """Absent keys take transformers.LlamaConfig's defaults, as dmi_tpu's
    _hf_to_config sees them; a null eos falls back to the tokenizer's."""
    import types

    minimal = {"model_type": "llama", "vocab_size": 96, "hidden_size": 64,
               "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
               "tie_word_embeddings": True}
    tok = types.SimpleNamespace(eos_token_id=7)
    ours = tmu._hf_to_config(minimal, torch.float32, tok)
    ref = jmu._hf_to_config(transformers.LlamaConfig(**minimal), jnp.float32, tok)
    assert ours == bridge.config_from_jax(ref)
    ours = tmu._hf_to_config({**minimal, "eos_token_id": None}, torch.float32, tok)
    assert ours.eos_token_ids == (7,)


@pytest.mark.parametrize("extra", [
    "model.layers.0.self_attn.q_proj.bias", "model.layers.0.self_attn.q_norm.weight",
    "model.layers.1.pre_feedforward_layernorm.weight",
    "model.layers.0.block_sparse_moe.gate.weight",
    "model.layers.0.self_attn.kv_a_proj_with_mqa.weight", "lm_head.weight",
])
def test_state_dict_keys_of_other_families_are_refused(saved, extra):
    """Keys the llama-3.x layout does not have (other families' biases,
    norms, experts and MLA projections) are refused, not ignored; an
    lm_head.weight is refused unless it is the tied embedding itself (as
    .bin files of tied models carry it)."""
    _, cases = saved
    sd = hf_weights.load_state_dict(cases["single"][0])
    cfg = tmu._hf_to_config(hf_weights.read_config(cases["single"][0]), torch.float32, None)
    tllama.from_hf_state_dict({**sd, "lm_head.weight": sd["model.embed_tokens.weight"]}, cfg)
    with pytest.raises(ValueError, match="layout does not use"):
        tllama.from_hf_state_dict({**sd, extra: torch.ones(64)}, cfg)
    missing = dict(sd)
    del missing["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        tllama.from_hf_state_dict(missing, cfg)


def test_unported_test_models_name_a9(tok):
    """The test LMs of the MoE and MLA families build dmi_tpu's tiny configs
    (at the builder's sizes); a test name no builder has is refused."""
    sizes = dict(vocab_size=40, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
                 intermediate=128, eos=(tok.eos_token_id,))
    want = {"mixtral": jllama.tiny_mixtral_config(**sizes),
            "qwen3moe": jllama.tiny_qwen3moe_config(**sizes),
            "olmoe": jllama.tiny_olmoe_config(**sizes),
            "deepseek": jllama.tiny_deepseek_config(n_experts=4, n_shared=1, **sizes)}
    for family, jcfg in want.items():
        cfg, params = tmu.build_lm(LMArgs(lm_name_or_path=f"test:tiny-{family}:40",
                                          lm_dtype="float32"), tok)
        assert cfg == bridge.config_from_jax(jcfg)
        assert set(params["layers"][0]) == set(jllama.init(jax.random.key(0), jcfg)["layers"])
    with pytest.raises(NotImplementedError, match="outside the layouts"):
        tmu.build_lm(LMArgs(lm_name_or_path="test:tiny-nothing"), tok)


def test_published_llama32_1b_config_maps_to_the_preset():
    """A config.json with the published Llama-3.2-1B-Instruct fields, built
    from the preset's own values, maps to llama.llama32_1b() in the port,
    and dmi_tpu reads it alike."""
    want = tllama.llama32_1b()
    cfg = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "attention_bias": False, "attention_dropout": 0.0, "hidden_act": "silu",
        "mlp_bias": False, "tie_word_embeddings": True, "max_position_embeddings": 131072,
        "vocab_size": want.vocab_size, "hidden_size": want.hidden_size,
        "intermediate_size": want.intermediate_size,
        "num_hidden_layers": want.num_hidden_layers,
        "num_attention_heads": want.num_attention_heads,
        "num_key_value_heads": want.num_key_value_heads, "head_dim": want.head_dim,
        "rms_norm_eps": want.rms_norm_eps, "rope_theta": want.rope_theta,
        "rope_scaling": {"factor": want.rope_scaling_factor,
                         "low_freq_factor": want.rope_low_freq_factor,
                         "high_freq_factor": want.rope_high_freq_factor,
                         "original_max_position_embeddings": want.rope_original_max_position,
                         "rope_type": "llama3"},
        "bos_token_id": want.bos_token_id, "eos_token_id": list(want.eos_token_ids),
        "torch_dtype": "bfloat16",
    }
    ours = tmu._hf_to_config(json.loads(json.dumps(cfg)), torch.bfloat16, None)
    assert ours == want
    ref = jmu._hf_to_config(transformers.LlamaConfig(**cfg), jnp.bfloat16, None)
    assert bridge.config_from_jax(ref) == want


# ---------------------------------------------------------------------------
# The smoke's writers
# ---------------------------------------------------------------------------


def test_smoke_safetensors_writer_round_trips(tmp_path):
    """chip_smoke.write_safetensors writes a small tree that the safetensors
    package and the port's reader both read back: the same names, dtypes
    and bytes as the tree written.  A dtype the port does not read is
    refused by name."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(0)
    tree = {"a.weight": torch.randn(5, 3, generator=gen).to(torch.bfloat16),
            "b.bias": torch.randn(7, generator=gen).to(torch.float16),
            "c": torch.randn(2, 3, 4, generator=gen), "empty": torch.zeros(0, 4),
            "d.weight": torch.randn(4, 6, generator=gen).t()}
    path = tmp_path / "tree.safetensors"
    n = chip_smoke.write_safetensors(torch, str(path), tree)
    assert n == path.stat().st_size
    for back in (safetensors_torch.load_file(str(path)), hf_weights.read_safetensors(path)):
        assert list(back) == list(tree)
        for k, t in tree.items():
            assert back[k].dtype == t.dtype and back[k].shape == t.shape
            assert back[k].contiguous().view(torch.uint8).numpy().tobytes() == \
                t.contiguous().view(torch.uint8).numpy().tobytes()
    chip_smoke.write_safetensors(torch, str(path), {"x": torch.zeros(3, dtype=torch.float64)})
    assert safetensors_torch.load_file(str(path))["x"].dtype == torch.float64
    with pytest.raises(ValueError, match="F64"):
        hf_weights.read_safetensors(path)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_smoke_hf_writer_round_trips(tmp_path, tok, monkeypatch, fused):
    """chip_smoke.write_hf_llama's directory (config.json, two shards, their
    index) loads back through the port's build_lm bit for bit, and
    transformers reads it (through dmi_tpu's build_lm) into the same
    config and parameters."""
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    cfg = tllama.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             head_dim=16, rope_scaling_factor=8.0, rope_original_max_position=64,
                             dtype=torch.bfloat16, eos_token_ids=(), bos_token_id=0)
    params = tllama.init(cfg, torch.Generator().manual_seed(1))
    if fused:
        params = tllama.fuse_projections(params)
    n = chip_smoke.write_hf_llama(torch, str(tmp_path), cfg, params)
    shards = sorted(p.name for p in tmp_path.glob("model-*.safetensors"))
    assert shards == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    assert n == sum((tmp_path / s).stat().st_size for s in shards)
    got_cfg, got = tmu.build_lm(LMArgs(lm_name_or_path=str(tmp_path), lm_dtype="bfloat16"), None)
    assert got_cfg == cfg
    if fused:
        got = tllama.fuse_projections(got)
    assert chip_smoke._bit_equal(torch, got, params)
    jcfg, jparams = jmu.build_lm(LMArgs(lm_name_or_path=str(tmp_path), lm_dtype="bfloat16"),
                                 tok)
    assert bridge.config_from_jax(jcfg) == cfg
    want = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert chip_smoke._bit_equal(torch, tllama.fuse_projections(want) if fused else want,
                                 params)

