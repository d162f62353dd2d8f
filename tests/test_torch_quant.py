"""dmi_tpu_torch.models.quant against dmi_tpu.models.quant, on shared arrays.

Every quantizer runs its divisions, roundings (half to even) and clips in f32
in dmi_tpu's order, so the integer payloads must be EQUAL and the scales equal
to within 1 ulp (XLA may compile a division by 127 as a product).  The
quantized matmuls, batch-first (llama._mm) and batch-last (decode._mm_bl), are
held against JAX's at f32 to 1e-6 relative: the integer accumulation is exact
on both sides, the rescale differs at most by the last bit of a product.
"""

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


def _w(shape, seed=0, scale=0.05):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _same_ints(j, t):
    j = np.asarray(j)
    assert j.dtype == t.numpy().dtype
    np.testing.assert_array_equal(j, t.numpy())


def _scales_within_1ulp(j, t):
    j, t = np.asarray(j), t.numpy()
    assert j.shape == t.shape and t.dtype == np.float32
    assert np.all(np.abs(j - t) <= np.spacing(np.abs(j)))


@pytest.mark.parametrize("native", [False, True], ids=["q", "q8"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 20)], ids=["2d", "stacked"])
def test_quantize_tensor(shape, native):
    w = _w(shape)
    j, t = jq.quantize_tensor(jnp.asarray(w), native), tq.quantize_tensor(torch.from_numpy(w),
                                                                          native)
    key = "q8" if native else "q"
    assert sorted(t) == sorted(j) == sorted([key, "s"])
    _same_ints(j[key], t[key])
    _scales_within_1ulp(j["s"], t["s"])


def test_quantize_tensor_zero_column_and_bf16_input():
    w = _w((16, 8))
    w[:, 3] = 0.0  # absmax 0: the scale floors at 1e-12, q is 0
    j = jq.quantize_tensor(jnp.asarray(w, jnp.bfloat16))
    t = tq.quantize_tensor(torch.from_numpy(w).bfloat16())
    _same_ints(j["q"], t["q"])
    _scales_within_1ulp(j["s"], t["s"])
    assert t["s"][0, 3].item() == np.float32(1e-12) and not t["q"][:, 3].any()


@pytest.mark.parametrize("group", [None, 16], ids=["per-channel", "grouped"])
@pytest.mark.parametrize("shape", [(64, 48), (2, 32, 20)], ids=["2d", "stacked"])
def test_quantize_tensor_int4_and_packing(shape, group):
    w = _w(shape, seed=1)
    j = jq.quantize_tensor_int4(jnp.asarray(w), group)
    t = tq.quantize_tensor_int4(torch.from_numpy(w), group)
    skey = "s" if group is None else "s4g"
    assert sorted(t) == sorted(j) == sorted(["qp", skey])
    _same_ints(j["qp"], t["qp"])
    _scales_within_1ulp(j[skey], t[skey])
    _same_ints(jq.unpack_w4(j["qp"]), tq.unpack_w4(t["qp"]))


def test_pack_unpack_every_nibble_pair():
    """All 256 byte values, nibble -8 included (the quantizers never emit it)."""
    q = np.stack([np.repeat(np.arange(-8, 8), 16), np.tile(np.arange(-8, 8), 16)]).astype(np.int8)
    jp, tp = jq.pack_w4(jnp.asarray(q)), tq.pack_w4(torch.from_numpy(q))
    _same_ints(jp, tp)
    assert sorted(tp.flatten().tolist()) == list(range(256))
    _same_ints(jq.unpack_w4(jp), tq.unpack_w4(tp))
    np.testing.assert_array_equal(tq.unpack_w4(tp).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        tq.pack_w4(torch.zeros(3, 4, dtype=torch.int8))
    with pytest.raises(ValueError, match="divisible"):
        tq.quantize_tensor_int4(torch.zeros(10, 4), 4)


@pytest.mark.parametrize("axis", [0, -1])
def test_quantize_act(axis):
    h = _w((48, 7), seed=2, scale=3.0)
    h[:, 2] = 0.0
    jh, ja = jq.quantize_act(jnp.asarray(h), axis)
    th, ta = tq.quantize_act(torch.from_numpy(h), axis)
    _same_ints(jh, th)
    _scales_within_1ulp(ja, ta)


@pytest.mark.parametrize("native", [False, True], ids=["q", "q8"])
def test_quantize_embed_tensor(native):
    w = _w((40, 24), seed=3)
    j = jq.quantize_embed_tensor(jnp.asarray(w), native)
    t = tq.quantize_embed_tensor(torch.from_numpy(w), native)
    key = "q8" if native else "q"
    _same_ints(j[key], t[key])
    _scales_within_1ulp(j["s"], t["s"])
    assert tuple(t["s"].shape) == (40, 1)


QUANTIZERS = {
    "q": lambda m, w: m.quantize_tensor(w),
    "q8": lambda m, w: m.quantize_tensor(w, True),
    "w4": lambda m, w: m.quantize_tensor_int4(w),
    "w4-grouped": lambda m, w: m.quantize_tensor_int4(w, 16),
}


@pytest.mark.parametrize("kind", list(QUANTIZERS))
def test_dequantize(kind):
    w = _w((64, 24), seed=4)
    j = jq.dequantize(QUANTIZERS[kind](jq, jnp.asarray(w)), jnp.float32)
    t = tq.dequantize(QUANTIZERS[kind](tq, torch.from_numpy(w)), torch.float32)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert np.abs(t.numpy() - w).max() < (0.01 if kind in ("q", "q8") else 0.05)
    dense = torch.from_numpy(w)
    assert tq.dequantize(dense, torch.float32) is dense
    assert tq.is_quantized(QUANTIZERS[kind](tq, dense)) and not tq.is_quantized(dense)
    with pytest.raises(ValueError, match="unknown"):
        tq.dequantize({"x": dense}, torch.float32)


def _rel_close(t, j, tol=1e-6):
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= tol * max(1.0, np.abs(j).max())


@pytest.mark.parametrize("kind", ["dense", *QUANTIZERS])
def test_mm_and_mm_bl_match_jax_at_f32(kind):
    """llama._mm over h [B, T, in] and decode._mm_bl over h [in, B]."""
    w = _w((64, 40), seed=5)
    jw = jnp.asarray(w) if kind == "dense" else QUANTIZERS[kind](jq, jnp.asarray(w))
    tw = torch.from_numpy(w) if kind == "dense" else QUANTIZERS[kind](tq, torch.from_numpy(w))
    h = _w((3, 5, 64), seed=6, scale=1.0)
    _rel_close(tllama._mm(torch.from_numpy(h), tw).numpy(), jllama._mm(jnp.asarray(h), jw))
    hb = _w((64, 9), seed=7, scale=1.0)
    _rel_close(tdec._mm_bl(tw, torch.from_numpy(hb)).numpy(), jdec._mm_bl(jw, jnp.asarray(hb)))
    _rel_close(tdec._mm_bl(tw, torch.from_numpy(hb), plain=True).numpy(),
               jdec._mm_bl(jw, jnp.asarray(hb)))


def test_mm_refuses_unknown_dicts():
    with pytest.raises(ValueError, match="unknown"):
        tllama._mm(torch.zeros(2, 4), {"x": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="unknown"):
        tdec._mm_bl({"x": torch.zeros(4, 4)}, torch.zeros(4, 2))


def test_int_matmul_is_exact_past_f32():
    """127 * 127 * 8192 exceeds 2**24: an f32 product would round."""
    a = torch.full((1, 8192), 127, dtype=torch.int8)
    b = torch.full((8192, 1), 127, dtype=torch.int8)
    b[-1] = 126
    exact = 127 * 127 * 8191 + 127 * 126
    assert tq.int_matmul(a, b).item() == np.float32(exact)
    assert float(np.float32(exact)) != exact  # the one rounding is int32 -> f32's


@pytest.mark.parametrize("kw", [
    {}, {"native": True}, {"bits": 4}, {"bits": 4, "group_size": 16}, {"quantize_embed": False},
], ids=["q", "q8", "w4", "w4-grouped", "embed-kept"])
def test_quantize_llama_matches_jax_through_the_bridge(kw):
    """The port quantizes its list-of-layers tree to what the bridge makes of
    dmi_tpu's quantized stacked tree; embeddings gather the same rows and the
    quantized head gives the same logits."""
    jcfg = jllama.tiny_config(vocab_size=48, hidden_size=32, n_layers=2, n_heads=4, n_kv=2,
                              intermediate=64)
    jparams = jllama.fuse_projections(jllama.init(jax.random.key(0), jcfg))
    tparams = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    jqp = jq.quantize_llama(jparams, **kw)
    want = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jqp))
    got = tq.quantize_llama(tparams, **kw)

    def same(a, b, key=None):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                same(a[k], b[k], k)
        elif key in ("s", "s4g"):
            # XLA compiles dmi_tpu's layer-by-layer lax.map and may divide by
            # 127 as a product with its reciprocal: 1 ulp
            _scales_within_1ulp(b.numpy(), a)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    assert len(got["layers"]) == 2
    same(got["embed"], want["embed"])
    same(got["final_norm"], want["final_norm"])
    for lg, lw in zip(got["layers"], want["layers"]):
        same(lg, lw)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_llama(tparams, bits=2)

    tcfg = bridge.config_from_jax(jcfg)
    ids = np.array([[1, 5, 47], [0, 2, 9]])
    np.testing.assert_array_equal(
        tllama.embed_tokens(tcfg, got, torch.from_numpy(ids)).numpy(),
        np.asarray(jllama.embed_tokens(jcfg, jqp, jnp.asarray(ids))))
    x = _w((2, 3, 32), seed=8, scale=1.0)
    _rel_close(tllama._head_matmul(torch.from_numpy(x), got, tcfg).numpy(),
               jllama._head_matmul(jnp.asarray(x), jqp, jcfg))
