"""The fused head + argmax twin of dmi_tpu_torch against the JAX package's
Pallas kernel _head_argmax_pallas run in interpret mode, in the three decode
weight modes, with EQUAL ids, and the tie cases of tests/test_head_argmax.py
(first occurrence within and across vocab blocks).  Inputs are bf16, made
with numpy; both sides accumulate in f32 and round scores to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import quant as jq
from dmi_tpu.ops.pallas.head_argmax import _head_argmax_pallas
from dmi_tpu.ops.pallas.head_argmax import head_argmax as j_head_argmax
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import quant as tq
from dmi_tpu_torch.ops.cuda import head_argmax as tha

torch.set_num_threads(1)


def _case(V, H, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(V, H)).astype(np.float32), rng.normal(size=(H, B)).astype(np.float32)


def _pallas_ids(mode, embed, h, bv):
    """ids from the Pallas kernel in interpret mode, called as
    dmi_tpu's head_argmax calls it."""
    hj = jnp.asarray(h, jnp.bfloat16)
    V, B = embed.shape[0], h.shape[1]
    ones = jnp.ones((1, B), jnp.float32)
    if mode == "bf16":
        return _head_argmax_pallas(jnp.asarray(embed, jnp.bfloat16), None, hj, ones, "bf16", bv,
                                   interpret=True)
    q = jq.quantize_embed_tensor(jnp.asarray(embed), native=(mode == "q8"))
    if mode == "q":
        return _head_argmax_pallas(q["q"], q["s"].reshape(1, V), hj, ones, "q", bv,
                                   interpret=True)
    hq, a = jq.quantize_act(hj, axis=0)
    return _head_argmax_pallas(q["q8"], q["s"].reshape(1, V), hq, a.astype(jnp.float32), "q8",
                               bv, interpret=True)


def _torch_params(mode, embed):
    e = torch.from_numpy(embed)
    if mode == "bf16":
        return {"embed": e.bfloat16()}
    return {"embed": tq.quantize_embed_tensor(e, native=(mode == "q8"))}


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
@pytest.mark.parametrize("V,H,B,bv", [(256, 64, 16, 64), (128, 64, 8, 32)])
def test_twin_ids_equal_pallas_interpret(mode, V, H, B, bv):
    embed, h = _case(V, H, B, seed=0)
    want = np.asarray(_pallas_ids(mode, embed, h, bv))
    params = _torch_params(mode, embed)
    hb = torch.from_numpy(h).bfloat16()
    n = tha.launches
    got = tha.head_argmax(params, hb)  # on the CPU the wrapper is the twin
    assert tha.launches == n
    assert got.dtype == torch.long and tuple(got.shape) == (B,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tha._head_argmax_plain(params["embed"], hb).numpy(), want)


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
def test_every_logit_ties_gives_row_zero(mode):
    """Every row identical: every logit ties, across blocks too."""
    V, H, B = 128, 32, 4
    embed = np.ones((V, H), np.float32)
    h = np.random.default_rng(3).normal(size=(H, B)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(_pallas_ids(mode, embed, h, 32)), np.zeros(B))
    got = tha.head_argmax(_torch_params(mode, embed), torch.from_numpy(h).bfloat16())
    np.testing.assert_array_equal(got.numpy(), np.zeros(B))


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
def test_planted_tie_across_blocks_goes_to_the_first(mode):
    V, H, B = 256, 32, 6
    embed, _ = _case(V, H, B, seed=4)
    u = np.random.default_rng(5).normal(size=(H,)).astype(np.float32)
    embed *= 0.1
    embed[200] = embed[40] = 4.0 * u  # rows of two different vocab blocks
    h = np.repeat(u[:, None], B, axis=1)
    np.testing.assert_array_equal(np.asarray(_pallas_ids(mode, embed, h, 64)), np.full(B, 40))
    got = tha.head_argmax(_torch_params(mode, embed), torch.from_numpy(h).bfloat16())
    np.testing.assert_array_equal(got.numpy(), np.full(B, 40))


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
def test_wrapper_matches_jax_wrapper_on_a_bridged_tree(mode):
    """head_argmax(params, h) of both packages on one decode tree, the JAX
    side quantized by dmi_tpu and carried over the bridge."""
    embed, h = _case(256, 64, 8, seed=6)
    jembed = jnp.asarray(embed, jnp.bfloat16)
    jparams = {"embed": jembed if mode == "bf16"
               else jq.quantize_embed_tensor(jembed, native=(mode == "q8"))}
    want = np.asarray(j_head_argmax(jparams, jnp.asarray(h, jnp.bfloat16), interpret=True))
    tparams = {"embed": bridge.llm_params_from_jax(
        {"embed": jparams["embed"], "layers": {"x": np.zeros((1, 1))}, "final_norm": np.zeros(1)}
    )["embed"]}
    got = tha.head_argmax(tparams, torch.from_numpy(h).bfloat16())
    np.testing.assert_array_equal(got.numpy(), want)


def test_logits_path_matches_jax_decode_step_expressions():
    """head_logits_bl at f32 against the three logits expressions of
    dmi_tpu's decode step (to 1e-6 relative)."""
    import jax

    embed, h = _case(96, 32, 5, seed=7)
    for mode in ("bf16", "q", "q8"):
        te = _torch_params(mode, embed)["embed"]
        if mode == "bf16":
            te = te.float()
            want = np.asarray(jnp.asarray(te.numpy()) @ jnp.asarray(h))
        else:
            q = jq.quantize_embed_tensor(jnp.asarray(embed), native=(mode == "q8"))
            if mode == "q8":
                hq, a = jq.quantize_act(jnp.asarray(h), axis=0)
                acc = jax.lax.dot_general(q["q8"], hq, (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32)
                want = np.asarray(acc * q["s"][:, 0][:, None] * a)
            else:
                want = np.asarray(jax.lax.dot_general(
                    q["q"].astype(jnp.float32), jnp.asarray(h), (((1,), (0,)), ((), ()))
                ) * q["s"][:, 0][:, None])
        got = tha.head_logits_bl(te, torch.from_numpy(h)).numpy()
        assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_wrapper_refuses_what_the_kernel_does_not_bake_in():
    embed, h = _case(64, 32, 4, seed=8)
    with pytest.raises(TypeError, match="bf16"):
        tha.head_argmax({"embed": torch.from_numpy(embed)}, torch.from_numpy(h))
    with pytest.raises(TypeError, match="bf16"):
        tha.head_argmax(_torch_params("q8", embed), torch.from_numpy(h))
    with pytest.raises(ValueError, match="shapes"):
        tha.head_argmax(_torch_params("bf16", embed), torch.from_numpy(h[:16]).bfloat16())
    with pytest.raises(ValueError, match="unknown"):
        tha.head_argmax({"embed": {"qp": torch.zeros(2, 2)}}, torch.from_numpy(h).bfloat16())
