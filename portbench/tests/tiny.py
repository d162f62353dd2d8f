"""Tiny versions of the benchmark's cells for the CPU tests: the cell's own
files, its configuration cut to a few small layers (every mechanism kept)
and its traffic to a few rows, with the cell's real limits."""

from __future__ import annotations

from portbench import harness as hx

SHAPES = {
    "olmoe": dict(vocab_size=512, hidden_size=256, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=4, num_experts=8,
                  num_experts_per_tok=2),
    "deepseek_v2": dict(vocab_size=512, hidden_size=256, moe_intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
                        kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
                        v_head_dim=32),
}
TRAFFIC = {"caption": dict(batch=8, mm_dim=32, check_requests=6, trace_calls=1),
           "stage1": dict(batch=4, text=24, mm_dim=32, trace_steps=1)}


def tiny_config(c: dict) -> dict:
    return {**c, **SHAPES[c["model_type"]], "eos_token_id": 1, "pad_token_id": 2}


def tiny_cell(name: str) -> dict:
    w = hx.cell(name)
    w["config_json"] = tiny_config(w["config_json"])
    w["traffic_json"] = {**w["traffic_json"], **TRAFFIC[w["traffic_json"]["kind"]]}
    return w
