"""The W4A8 and W8A8 batch-last matmul twins of dmi_tpu_torch against the JAX
package: the packed twin equals dmi_tpu's Pallas kernel w4_mm_bl run in
interpret mode EXACTLY (integer accumulation, one fixed rescale order), at
any batch size, also the ones the TPU kernel's own gate refuses (B not a
multiple of 128); the int8 twin equals decode._mm_bl's q8 branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import decode as jdec
from dmi_tpu.models import quant as jq
from dmi_tpu.ops.pallas.w4_matmul import w4_mm_bl as j_w4_mm_bl
from dmi_tpu_torch.models import quant as tq
from dmi_tpu_torch.ops.cuda import w4_matmul as tw4

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(K, out, B, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, out)) * 0.05).astype(np.float32)
    h = rng.normal(size=(K, B)).astype(np.float32)
    return w, h


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,out,B", [(64, 128, 128), (64, 128, 8), (128, 256, 100), (64, 128, 1),
                                     (256, 384, 64)])
def test_w4_twin_equals_pallas_interpret_exactly(K, out, B, dtype):
    jd, td = DTYPES[dtype]
    w, h = _case(K, out, B)
    jw = jq.quantize_tensor_int4(jnp.asarray(w))
    jhq, ja = jq.quantize_act(jnp.asarray(h), axis=0)
    want = j_w4_mm_bl(jw, jhq, ja, jd, interpret=True)
    tw = tq.quantize_tensor_int4(torch.from_numpy(w))
    thq, ta = tq.quantize_act(torch.from_numpy(h), axis=0)
    for fn in (tw4._w4_mm_plain, tw4.w4_mm_bl):  # on the CPU the wrapper is the twin
        got = fn(tw, thq, ta, td)
        assert got.dtype == td and tuple(got.shape) == (out, B)
        np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


def test_w4_twin_is_the_unpacked_product():
    """Two half products on the packed bytes == one product on unpack_w4."""
    w, h = _case(96, 40, 7, seed=1)
    tw = tq.quantize_tensor_int4(torch.from_numpy(w))
    thq, ta = tq.quantize_act(torch.from_numpy(h), axis=0)
    dense = {"q8": tq.unpack_w4(tw["qp"]), "s": tw["s"]}
    assert torch.equal(tw4._w4_mm_plain(tw, thq, ta, torch.float32),
                       tw4._w8_mm_plain(dense, thq, ta, torch.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,out,B", [(64, 48, 9), (128, 40, 128)])
def test_w8_twin_equals_jax_q8_branch(K, out, B, dtype):
    jd, td = DTYPES[dtype]
    w, h = _case(K, out, B, seed=2)
    jw = jq.quantize_tensor(jnp.asarray(w), native=True)
    want = jdec._mm_bl(jw, jnp.asarray(h, jd))
    tw = tq.quantize_tensor(torch.from_numpy(w), native=True)
    thq, ta = tq.quantize_act(torch.from_numpy(h).to(td), axis=0)
    for fn in (tw4._w8_mm_plain, tw4.w8_mm_bl):
        np.testing.assert_array_equal(_np(fn(tw, thq, ta, td)),
                                      np.asarray(want.astype(jnp.float32)))


def test_cpu_calls_launch_nothing_and_grouped_weights_are_refused():
    w, h = _case(64, 32, 4)
    tw = tq.quantize_tensor_int4(torch.from_numpy(w))
    thq, ta = tq.quantize_act(torch.from_numpy(h), axis=0)
    n = (tw4.launches, tw4.w8_launches)
    tw4.w4_mm_bl(tw, thq, ta, torch.float32)
    tw4.w8_mm_bl(tq.quantize_tensor(torch.from_numpy(w), True), thq, ta, torch.float32)
    assert (tw4.launches, tw4.w8_launches) == n
    with pytest.raises(ValueError, match="per-channel"):
        tw4.w4_mm_bl(tq.quantize_tensor_int4(torch.from_numpy(w), 16), thq, ta, torch.float32)


# ---------------------------------------------------------------------------
# The kernel's launch plan and a plain model of its integer work
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(2048, 3072, 128), (2048, 2048, 128), (2048, 16384, 128), (8192, 2048, 128),
               (2048, 2048, 8), (2048, 3072, 100), (2048, 2048, 256), (4096, 256, 128),
               (70, 37, 5), (6, 33, 130), (1024, 40, 1), (2, 16, 1)]


@pytest.mark.parametrize("packed", [True, False], ids=["w4", "w8"])
@pytest.mark.parametrize("K,out,B", PLAN_SHAPES)
def test_plan_covers_every_tile_and_split_once(K, out, B, packed):
    """The splits cut the weight rows (K/2 packed rows, or K) into whole
    64-row chunks, each row in exactly one split, none empty; the tiles cover
    out and B; the blocks fill the card once where the rows are split."""
    p = tw4.plan(K, out, B, packed)
    rows = K // 2 if packed else K
    assert p["rows"] == rows and p["per_split"] % tw4.TILE_K == 0
    spans = [(s * p["per_split"], min(rows, (s + 1) * p["per_split"]))
             for s in range(p["splits"])]
    assert all(end > first for first, end in spans) and spans[-1][1] == rows
    assert (p["m_tiles"] - 1) * tw4.TILE_M < out <= p["m_tiles"] * tw4.TILE_M
    assert (p["batch_tiles"] - 1) * tw4.TILE_B < B <= p["batch_tiles"] * tw4.TILE_B
    assert p["grid"] == (p["splits"], p["m_tiles"], p["batch_tiles"])
    assert p["blocks"] == p["splits"] * p["m_tiles"] * p["batch_tiles"]
    assert p["blocks"] <= tw4.SMS or p["splits"] == 1
    tiles = p["m_tiles"] * p["batch_tiles"]
    assert p["counters"] == tiles
    assert p["partial_ints"] == (p["blocks"] * tw4.TILE_M * tw4.TILE_B if p["splits"] > 1 else 0)
    assert p["tma"] == (out % 16 == 0)


def test_serving_plans_span_one_and_many_splits():
    """Llama-3.2-1B's layer matmuls at B 128: w_gu fills the card with its
    128 channel tiles, the others split their rows."""
    splits = {n: tw4.plan(K, out, 128, True)["splits"]
              for n, K, out in (("w_qkv", 2048, 3072), ("wo", 2048, 2048),
                                ("w_gu", 2048, 16384), ("w_down", 8192, 2048))}
    assert splits == {"w_qkv": 4, "wo": 8, "w_gu": 1, "w_down": 8}
    assert tw4.plan(4096, 256, 128, True)["splits"] == 32


def test_plan_takes_every_shape_the_wrapper_takes():
    for K in (2, 6, 64, 70, 128, 130, 2048, 8192, 16384):
        for out in (1, 16, 37, 128, 129, 2048, 16384, 40000):
            for B in (1, 5, 128, 130, 300):
                for packed in (True, False):
                    p = tw4.plan(K, out, B, packed)
                    assert p["splits"] >= 1 and (p["splits"] - 1) * p["per_split"] < p["rows"]


def test_scaled_nibbles_are_sixteen_times_the_signed_nibbles():
    """The packed kernel's fragments: (byte << 4) & 0xF0 and byte & 0xF0, as
    int8, are 16 x the sign-extended low and high nibble of every byte."""
    b = torch.arange(256, dtype=torch.int32)
    lo, hi = b & 0xF, b >> 4
    sext = lambda n: n - 16 * (n >= 8).int()  # noqa: E731
    p8 = b.to(torch.uint8).view(torch.int8)
    assert torch.equal((p8 << 4).int(), 16 * sext(lo))
    assert torch.equal((p8 & -16).int(), 16 * sext(hi))


def _split_model(w, hq, a, out_dtype, packed):
    """csrc/w4_matmul.cu's integer work in plain torch at its launch plan: the
    weights as its fragments hold them (W4: both nibbles at 16 x their value),
    one int32 partial per split of the rows, the partials added, the factor
    16 shifted out, one rescale."""
    K, B = hq.shape
    if packed:
        p8 = w["qp"].view(torch.int8)
        halves = (p8 << 4, p8 & -16)  # against hq[:K/2] and hq[K/2:]
    else:
        halves = (w["q8"],)
    rows, out = halves[0].shape
    p = tw4.plan(K, out, B, packed)
    acc = torch.zeros((out, B), dtype=torch.int64)
    for s in range(p["splits"]):
        r0, r1 = s * p["per_split"], min(rows, (s + 1) * p["per_split"])
        for i, half in enumerate(halves):  # exact: integers below 2**53 in f64
            acc += (half[r0:r1].t().double() @ hq[i * rows + r0:i * rows + r1].double()).long()
    assert acc.abs().max() < 2 ** 31  # the kernel's int32 sums
    return tw4._rescale(acc >> 4 if packed else acc, w["s"], a, out_dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,out,B", [(2048, 2048, 5), (4096, 256, 16), (2048, 300, 3),
                                     (70, 37, 5), (1024, 40, 1)])
def test_split_model_equals_twins_bit_for_bit(K, out, B, dtype):
    """8, 32, 16 and 1 splits of the rows; W4 and W8 equal their twins."""
    td = DTYPES[dtype][1]
    w, h = _case(K, out, B, seed=4)
    tw, tw8 = tq.quantize_tensor_int4(torch.from_numpy(w)), tq.quantize_tensor(
        torch.from_numpy(w), native=True)
    thq, ta = tq.quantize_act(torch.from_numpy(h), axis=0)
    assert torch.equal(_split_model(tw, thq, ta, td, True), tw4._w4_mm_plain(tw, thq, ta, td))
    assert torch.equal(_split_model(tw8, thq, ta, td, False), tw4._w8_mm_plain(tw8, thq, ta, td))
