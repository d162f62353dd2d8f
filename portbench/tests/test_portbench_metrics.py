"""The per-layer metrics' operation and byte counts against hand counts at
one shape each: the routed MLP at top-k (not every expert), decode
attention, absorbed MLA, the head, flash attention, and the whole step's
model operations."""

import pytest

from portbench import counts, harness as hx

OLMOE = hx.load_json(hx.PKG / "configs" / "olmoe-1b-7b.json")
V2 = hx.load_json(hx.PKG / "configs" / "deepseek-v2-lite-26.json")


def metric(name):
    return hx.reader(name)


def test_moe_counts_top_k_experts():
    flops, nbytes = metric("moe.roofline.serve").work(OLMOE, 512)
    # router 2048 x 64, then 8 experts of 3 products 2048 x 1024 a token
    assert flops == 2 * 512 * (2048 * 64 + 8 * 3 * 2048 * 1024)
    # all 64 experts' weights read once, the router, tokens in and out (bf16)
    assert nbytes == 2 * (64 * 3 * 2048 * 1024 + 2048 * 64 + 2 * 512 * 2048)
    flops, nbytes = metric("moe.roofline.serve").work(V2, 512)
    assert flops == 2 * 512 * (2048 * 64 + (6 + 2) * 3 * 2048 * 1408)
    assert nbytes == 2 * ((64 + 2) * 3 * 2048 * 1408 + 2048 * 64 + 2 * 512 * 2048)


def test_decode_attention_counts():
    x = {"B": 512, "nh": 16, "P": 1, "hd": 128, "nkv": 16, "S": 20, "bias": 20}
    flops, nbytes = metric("decode_attn.roofline").work(x)
    assert flops == 4 * 512 * 16 * 20 * 128
    assert nbytes == 2 * 512 * 16 * 128 * 2 + 2 * 512 * 16 * 20 * 128 * 2 + 4 * 20


def test_mla_counts():
    flops, nbytes = metric("mla_attn.roofline").work(V2, 512, 20)
    q, kv_a, absorb, out = 2048 * 16 * 192, 2048 * 576, 16 * 128 * 512, 16 * 512 * 128
    assert flops == 2 * 512 * (q + kv_a + absorb + out + 20 * 16 * (2 * 512 + 64))
    weights = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256
    assert nbytes == 2 * (weights + 512 * 21 * 576 + 512 * 2048 + 512 * 16 * 128)


def test_head_counts():
    flops, nbytes = metric("head_argmax.roofline").work({"V": 50304, "H": 2048, "B": 512})
    assert flops == 2 * 50304 * 2048 * 512
    assert nbytes == 2 * 50304 * 2048 + 2 * 2048 * 512 + 8 * 512


def test_flash_counts():
    x = {"B": 32, "nh": 16, "T": 65, "hd": 128, "nkv": 16}
    pairs = 65 * 66 / 2
    t = 32 * 16 * 65 * 128 * 2
    assert metric("flash_attn.roofline").work(x, False) == (
        4 * 32 * 16 * pairs * 128, 4 * t + 4 * 32 * 16 * 65)
    assert metric("flash_attn.roofline").work(x, True) == (
        10 * 32 * 16 * pairs * 128, 8 * t + 4 * 32 * 16 * 65)


def test_model_flops():
    per_layer = 2 * (2048 * 48 * 128 + 2048 * 2048 + 2048 * 64 + 3 * 2048 * 1024 * 8)
    pairs_flops = 2 * 16 * (128 + 128)
    want = 16 * (37 * per_layer + 37 * 38 / 2 * pairs_flops) + 22 * 2 * 2048 * 50304
    assert counts.caption_flops(OLMOE, 16, 22) == pytest.approx(want, rel=1e-12)
    mla = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert counts.attn_proj_params(counts.sizes(V2)) == mla


def test_least_seconds():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
