"""dmi_tpu_torch's llama-3.x decoder against dmi_tpu's, on shared weights.

The JAX package is the reference: the same tiny config (with llama3 rope
scaling, so every branch of the scaled frequencies is taken) and the same
weights (bridge.py) go through dmi_tpu.models.decode.prefill/decode_step
and the port's counterparts.  f32 on the CPU; logits agree to rtol 1e-5
(atol 1e-6: the logits are O(0.1), summation order is the only difference).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _jax_cfg(**kw):
    # llama3 scaling at the 1B model's factors: at head_dim 16 the
    # wavelengths span the unscaled, smoothed and fully scaled regions
    return dataclasses.replace(
        jllama.tiny_config(vocab_size=96, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
                           intermediate=128),
        rope_scaling_factor=32.0, **kw,
    )


def _setup(fused, B=3, T=7, seed=0):
    jcfg = _jax_cfg()
    jparams = jllama.init(jax.random.key(seed), jcfg)
    if fused:
        jparams = jllama.fuse_projections(jparams)
    tcfg = bridge.config_from_jax(jcfg)
    tparams = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    embeds = np.random.default_rng(seed).normal(size=(B, T, 64)).astype(np.float32) * 0.1
    return jcfg, jparams, tcfg, tparams, embeds


def test_config_bridge_keeps_llama3_fields():
    tcfg = bridge.config_from_jax(_jax_cfg())
    assert tcfg.rope_scaling_factor == 32.0 and tcfg.dtype == torch.float32
    assert tcfg.num_key_value_heads == 2 and tcfg.eos_token_ids == (5,)
    full = bridge.config_from_jax(jllama.llama32_1b())
    assert full == tllama.llama32_1b()


@pytest.mark.parametrize("maker", [
    jllama.tiny_gemma2_config, jllama.tiny_qwen2_config, jllama.tiny_qwen3_config,
    jllama.tiny_olmo2_config, jllama.tiny_mixtral_config, jllama.tiny_deepseek_config,
    jllama.tiny_gemma3_config, jllama.tiny_granite_config,
])
def test_config_bridge_refuses_other_families(maker):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.9"):
        bridge.config_from_jax(maker())


def test_rope_tables_match():
    jcfg = _jax_cfg()
    tcfg = bridge.config_from_jax(jcfg)
    pos = np.arange(40)
    jc, js = jllama.rope_tables(jcfg, jnp.asarray(pos))
    tc, ts = tllama.rope_tables(tcfg, torch.as_tensor(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fuse_projections"])
def test_prefill_and_decode_step_logits_match(fused):
    jcfg, jparams, tcfg, tparams, embeds = _setup(fused)
    B, T, _ = embeds.shape
    S = T + 4
    jlogits, jcaches = jdec.prefill(jcfg, jparams, jnp.asarray(embeds),
                                    jdec.init_cache(jcfg, B, S))
    tcaches = tdec.init_cache(tcfg, B, S)
    with torch.no_grad():
        tlogits = tdec.prefill(tcfg, tparams, torch.as_tensor(embeds), tcaches)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    for jc, tc in zip(jcaches, tcaches):
        np.testing.assert_allclose(tc.numpy()[:, :, :, :T], np.asarray(jc)[:, :, :, :T],
                                   rtol=RTOL, atol=ATOL)

    # two decode steps from the filled caches, on tokens both sides pick
    for pos in (T, T + 1):
        tok = np.argmax(np.asarray(jlogits), axis=-1)
        jemb = jllama.embed_tokens(jcfg, jparams, jnp.asarray(tok))[:, None, :]
        jlogits, jcaches = jdec.decode_step(jcfg, jparams, jemb, jcaches, jnp.asarray(pos))
        with torch.no_grad():
            temb = tllama.embed_tokens(tcfg, tparams, torch.as_tensor(tok))[:, None, :]
            tlogits = tdec.decode_step(tcfg, tparams, temb, tcaches, pos)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)


def test_fuse_projections_is_idempotent_and_exact():
    _, _, tcfg, tparams, embeds = _setup(fused=False, seed=1)
    fused = tllama.fuse_projections(tparams)
    assert set(fused["layers"][0]) == {"w_qkv", "wo", "w_gu", "w_down", "ln_attn", "ln_mlp"}
    assert tllama.fuse_projections(fused)["layers"][0].keys() == fused["layers"][0].keys()
    outs = []
    for p in (tparams, fused):
        caches = tdec.init_cache(tcfg, 3, 7)
        with torch.no_grad():
            outs.append(tdec.prefill(tcfg, p, torch.as_tensor(embeds), caches))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=RTOL, atol=ATOL)


def test_quantized_weights_refused():
    """Quantized weight dicts are served (tests/test_torch_quant.py holds them
    against dmi_tpu); what is refused is a dict of none of the known modes."""
    out = tllama._mm(torch.ones(1, 2), {"q": torch.full((2, 2), 3, dtype=torch.int8),
                                        "s": torch.full((1, 2), 0.5)})
    assert torch.equal(out, torch.full((1, 2), 3.0))
    with pytest.raises(ValueError, match="unknown quantized"):
        tllama._mm(torch.zeros(1, 2), {"fp8": torch.zeros(2, 2), "s": torch.ones(2)})
