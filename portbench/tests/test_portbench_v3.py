"""The DeepSeek-V3 cell (v3-caption-b2048 on deepseek-v3-ep32-30): its
configuration against the catalog's numbers, the reference against the
system at tiny widths of its own (every mechanism kept: 3 dense layers,
q-LoRA, groups, an expert share), the run on the CPU with the cell's own
limit, the new readers' counts, and (-m cuda, on the card at the cell's
own sizes) the control failing where the system passes.

    python3 -m pytest portbench/tests/test_portbench_v3.py [-m cuda]
"""

import json
import math
import time

import pytest
import torch

from portbench import counts_ep, harness as hx
from portbench.reference.decoder import int8_weights
from portbench.reference.deepseek_v3 import Decoder

CELL = "v3-caption-b2048"
CONFIG = hx.load_json(hx.PKG / "configs" / "deepseek-v3-ep32-30.json")
SHAPES = dict(vocab_size=512, hidden_size=256, intermediate_size=192, moe_intermediate_size=64,
              num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=4,
              n_routed_experts=4, ep_size=8, q_lora_rank=64, kv_lora_rank=32,
              qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
TRAFFIC = dict(batch=8, mm_dim=32, check_requests=6, trace_calls=1)


def tiny_cell() -> dict:
    w = hx.cell(CELL)
    w["config_json"] = {**w["config_json"], **SHAPES, "pad_token_id": 2}
    w["traffic_json"] = {**w["traffic_json"], **TRAFFIC}
    return w


def test_catalog_numbers_kept():
    """The file holds the catalog's DeepSeek-V3 numbers (its source's
    config.json), but for the keys in `reduced`, whose published values it
    states."""
    published = {"attention_bias": False, "ep_size": 1, "first_k_dense_replace": 3,
                 "hidden_act": "silu", "hidden_size": 7168, "intermediate_size": 18432,
                 "kv_lora_rank": 512, "max_position_embeddings": 163840,
                 "model_type": "deepseek_v3", "moe_intermediate_size": 2048,
                 "moe_layer_freq": 1, "n_group": 8, "n_routed_experts": 256,
                 "n_shared_experts": 1, "norm_topk_prob": True, "num_attention_heads": 128,
                 "num_experts_per_tok": 8, "num_hidden_layers": 61, "num_key_value_heads": 128,
                 "num_nextn_predict_layers": 1, "q_lora_rank": 1536, "qk_nope_head_dim": 128,
                 "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
                 "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1,
                                  "mscale_all_dim": 1,
                                  "original_max_position_embeddings": 4096, "type": "yarn"},
                 "rope_theta": 10000, "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
                 "tie_word_embeddings": False, "topk_group": 4, "topk_method": "noaux_tc",
                 "v_head_dim": 128, "vocab_size": 129280}
    c = CONFIG
    assert sorted(c["reduced"]) == ["ep_size", "n_routed_experts", "num_hidden_layers"]
    for k, v in published.items():
        if k in c["reduced"]:
            assert c["published"][k] == v, k
        else:
            assert c[k] == v, k
    # the router's width is the published count, the held share 8 of it
    assert c["n_routed_experts"] * c["ep_size"] == 256 and c["n_routed_experts"] >= 8
    # the floors: a whole period and 4 or more of the layers after the dense ones
    assert c["num_hidden_layers"] - c["first_k_dense_replace"] >= 4
    cfg = hx.port_config(c)
    assert (cfg.num_experts, cfg.moe_expert_range, cfg.moe_scoring) == (256, (0, 8), "sigmoid")
    assert cfg.moe_layers == (False,) * 3 + (True,) * 27


def _f32_model(seed=5):
    from dmi_tpu_torch.models import llama

    w = tiny_cell()
    cfg = hx.port_config(w["config_json"], torch.float32)
    params = hx.draw_weights(cfg, seed, "cpu")
    for lw in params["layers"]:  # scores spread over (0, 1), the bias binding
        if "w_router" in lw:
            lw["w_router"] = lw["w_router"] * 12.5
            lw["router_bias"] = lw["router_bias"] * 5.0
    return w, cfg, params, llama


def test_reference_matches_the_port():
    w, cfg, params, llama = _f32_model()
    x = torch.randn(3, 11, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    want = llama.forward(cfg, params, x)
    got = Decoder(w["config_json"], params).logits(x)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


def test_int8_weights_move_the_logits():
    w, cfg, params, _ = _f32_model()
    x = torch.randn(2, 7, cfg.hidden_size, generator=torch.Generator().manual_seed(2))
    exact = Decoder(w["config_json"], params).logits(x)
    low = Decoder(w["config_json"], params, int8_weights).logits(x)
    assert 0 < (low - exact).abs().max() < 0.1 * exact.abs().max()


def run(trace: bool = False):
    w = tiny_cell()
    return hx.driver(w["traffic_json"]["kind"]).run(w, 2**33 + 17, 0.5, trace, "cpu",
                                                    time.perf_counter(), 1)


@pytest.mark.parametrize("trace", [False, True])
def test_unbroken_is_correct(trace):
    result, checks = run(trace)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(checks) == ["gap_per_near_tie"]


def test_altered_token_is_caught(monkeypatch):
    from dmi_tpu_torch.models import decode

    real = decode.head_ids

    def altered(head_w, out, plain=False):
        ids = real(head_w, out, plain).clone()
        ids[-1] = (ids[-1] + head_w["embed"].shape[0] // 2) % head_w["embed"].shape[0]
        return ids

    monkeypatch.setattr(decode, "head_ids", altered)
    result, checks = run()
    assert not result["correct"], checks


def test_control_readings_on_the_cpu():
    """serve_readings at tiny sizes: the control's gaps (the int8
    reference's tokens) lie above the system's on the same sequences."""
    w = tiny_cell()
    drv = hx.driver("caption_v3")
    r = drv.serve_readings(w, 2**31 + 5, True, 1, device="cpu")
    assert set(r) == {"program", "control"}
    assert all(math.isfinite(v) for v in r["program"].values())
    assert r["control"]["gap_per_near_tie"] >= r["program"]["gap_per_near_tie"]


def test_counts_by_hand():
    c = CONFIG
    H, I, Id, V = 7168, 2048, 18432, 129280
    flops, nbytes = counts_ep.moe_work(c, 2048)
    # the router over 256, the 8 held experts' share of 8 a token (8 x 8 / 256), 1 shared
    assert flops == 2 * 2048 * (H * 256 + 3 * H * I * (8 * 8 / 256 + 1))
    assert nbytes == 2 * (3 * H * I * (8 + 1) + H * 256 + 256 + 2 * 2048 * H)
    flops, nbytes = counts_ep.mla_work(c, 2048, 20)
    q = H * 1536 + 1536 * 128 * 192
    kv_a, absorb, out = H * 576, 128 * 128 * 512, 128 * 512 * 128
    assert flops == 2 * 2048 * (q + kv_a + absorb + out + 20 * 128 * (2 * 512 + 64))
    weights = q + kv_a + 512 * 128 * 256
    assert nbytes == 2 * (weights + 2048 * 21 * 576 + 2048 * H + 2048 * 128 * 128)
    mlp = hx.reader("decode_mlp.roofline").work({"H": H, "I": Id, "B": 2048})
    assert mlp == (6 * H * Id * 2048, 2 * (3 * H * Id + 2 * H * 2048))
    attn = H * 1536 + 1536 * 128 * 192 + H * 576 + 512 * 128 * 256 + 128 * 128 * H
    moe = H * 256 + 3 * H * I * (0.25 + 1)
    per_token = 30 * attn + 3 * 3 * H * Id + 27 * moe
    pairs = 37 * 38 / 2
    want = 2 * 37 * per_token + 30 * pairs * 2 * 128 * (192 + 128) + 22 * 2 * H * V
    assert counts_ep.caption_flops(c, 16, 22) == pytest.approx(want, rel=1e-12)


class _Trace:
    def __init__(self, seconds: dict, ranges=("moe.route", "decode.moe", "llama.moe")):
        self.seconds, self.ranges = seconds, {r: [(0, 1)] for r in ranges}

    def span_seconds(self, *names):
        return sum(self.seconds.get(n, 0.0) for n in names)


def test_route_share_reader():
    r = hx.reader("moe.route_share")
    assert r.read(_Trace({"moe.route": 0.5, "decode.moe": 3.0, "llama.moe": 2.0})) == 10.0
    assert r.read(_Trace({"decode.moe": 3.0}, ranges=("decode.moe",))) is None


def test_cell_entries():
    bench = json.loads((hx.ROOT / "BENCHMARK.json").read_text())
    for m in ("moe.route_share", "moe_ep.roofline.serve", "mla_qlora.roofline",
              "decode_mlp.roofline", "mfu.serve.ep", "captions_per_s", "setup_s"):
        e = next(x for x in bench["per_layer"] + bench["end_to_end"] if x["name"] == m)
        assert CELL in e.get("workloads", [CELL])
    for m in ("moe.roofline.serve", "mla_attn.roofline", "mfu.serve", "decode_attn.roofline"):
        e = next(x for x in bench["per_layer"] if x["name"] == m)
        assert CELL not in e["workloads"]


@pytest.mark.cuda
def test_control_fails_where_the_system_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own sizes")
    w = hx.cell(CELL)
    r = hx.driver("caption_v3").serve_readings(w, 2**31 + 11, True, 1)
    assert hx.judge(r["program"], w["limits"])[0], r
    assert not hx.judge(r["control"], w["limits"])[0], r
