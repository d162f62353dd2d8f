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


# ---------------------------------------------------------------------------
# The kernel's launch plan and a plain model of its reduction
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(128256, 128), (128256, 8), (128256, 256), (1001, 5), (1001, 130), (100, 16),
               (50000, 64), (256, 16), (257, 144)]


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
@pytest.mark.parametrize("V,B", PLAN_SHAPES)
def test_plan_covers_every_vocab_tile_once(mode, V, B):
    """Every vocab tile falls in exactly one block's run, in order, none
    empty; the tiles cover V and the batch tiles the padded batch; the
    blocks fill the card once."""
    Bp = B + (-B % 16)
    p = tha.plan(V, 2048, Bp, mode)
    assert [t for first, end in p["runs"] for t in range(first, end)] == list(
        range(p["vocab_tiles"]))
    assert len(p["runs"]) == p["blocks"] and all(end > first for first, end in p["runs"])
    assert (p["vocab_tiles"] - 1) * p["tile_v"] < V <= p["vocab_tiles"] * p["tile_v"]
    assert (p["batch_tiles"] - 1) * p["tile_b"] < Bp <= p["batch_tiles"] * p["tile_b"]
    assert p["grid"] == (p["blocks"], p["batch_tiles"])
    assert p["blocks"] * p["batch_tiles"] <= tha.SMS or p["blocks"] == 1
    assert p["part"] == p["blocks"] * Bp


def test_plan_takes_every_shape_the_wrapper_takes():
    """Any V and any padded batch get a plan whose runs cover the vocab."""
    for V in (1, 2, 255, 256, 257, 33791, 33792, 33793, 128256, 200000):
        for B in (1, 5, 16, 127, 128, 129, 256, 4000, 20000):
            Bp = B + (-B % 16)
            for mode in tha.MODES:
                p = tha.plan(V, 16, Bp, mode)
                assert p["blocks"] >= 1 and p["runs"][0][0] == 0
                assert p["runs"][-1][1] == p["vocab_tiles"] == -(-V // tha.TILE_V)


def _reduction_model(embed, h, mode):
    """csrc/head_argmax.cu's reduction in plain torch at its launch plan: the
    scores rounded as the mode rounds them (the logits path), each block's
    running (best, first index) over its run of vocab tiles, then the merge
    of the blocks' pairs (score descending, index ascending) -> [B]."""
    logits = tha.head_logits_bl(embed, h).float()
    V, B = logits.shape
    p = tha.plan(V, h.shape[0], B + (-B % 16), mode)
    pairs = []
    for first, end in p["runs"]:
        best = torch.full((B,), -float("inf"))
        idx = torch.full((B,), 2 ** 31 - 1, dtype=torch.long)
        for t in range(first, end):
            rows = logits[t * tha.TILE_V:(t + 1) * tha.TILE_V]
            i = rows.argmax(dim=0)  # the first of the tile's best rows
            v = rows.gather(0, i[None])[0]
            i = i + t * tha.TILE_V
            better = (v > best) | ((v == best) & (i < idx))
            best, idx = torch.where(better, v, best), torch.where(better, i, idx)
        pairs.append((best, idx))
    best, idx = pairs[0]
    for v, i in pairs[1:]:
        better = (v > best) | ((v == best) & (i < idx))
        best, idx = torch.where(better, v, best), torch.where(better, i, idx)
    return idx


@pytest.mark.parametrize("rows", [(255, 256), (767, 768), (3, 49999), (40000, 40001)],
                         ids=["block-edge", "tile-edge-in-a-run", "first-last", "same-tile"])
@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
def test_reduction_model_equals_twin_with_planted_ties(mode, rows):
    """V 50000 is 196 tiles over 132 blocks: rows 255 | 256 lie in two
    blocks, 767 | 768 in two tiles of one block's run; the first row wins."""
    V, H, B = 50000, 16, 16
    rng = np.random.default_rng(9)
    embed = (rng.normal(size=(V, H)) * 0.1).astype(np.float32)
    u = rng.normal(size=(H,)).astype(np.float32)
    embed[rows[0]] = embed[rows[1]] = 4.0 * u
    h = np.repeat(u[:, None], B, axis=1)
    h[:, B // 2:] = rng.normal(size=(H, B - B // 2))  # columns without the planted winner
    params = _torch_params(mode, embed)
    hb = torch.from_numpy(h).bfloat16()
    want = tha._head_argmax_plain(params["embed"], hb)
    got = _reduction_model(params["embed"], hb, mode)
    assert torch.equal(got, want)
    assert (got[:B // 2] == rows[0]).all()


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
def test_reduction_model_equals_twin_when_every_logit_ties(mode):
    embed = np.ones((2000, 16), np.float32)
    hb = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32))
    params = _torch_params(mode, embed)
    got = _reduction_model(params["embed"], hb.bfloat16(), mode)
    assert torch.equal(got, torch.zeros(8, dtype=torch.long))
