"""The yardstick's arithmetic for configurations that counts.py misreads:
a stack of leading dense layers and routed layers (first_k_dense_replace,
moe_layer_freq), q-LoRA attention (q_lora_rank), and one expert-parallel
rank's share of the experts (ep_size > 1: the router scores
n_routed_experts x ep_size experts, and this rank holds n_routed_experts
of them).  As in counts.py, the work is what the model needs, whatever
implements it: a token's routed work is its k experts' share that lies on
the experts held here, k x E_held / E_pub of an expert on average, plus
the shared experts; attention counts the causal pairs of real positions.
Multiply-adds count 2 operations."""

from __future__ import annotations

from portbench import counts


def sizes(c: dict) -> dict:
    H, nh = c["hidden_size"], c["num_attention_heads"]
    held = c["n_routed_experts"]
    L = c["num_hidden_layers"]
    fkd, freq = c.get("first_k_dense_replace") or 0, c.get("moe_layer_freq") or 1
    sparse = sum(1 for i in range(L) if held and i >= fkd and i % freq == 0)
    return {"H": H, "nh": nh, "V": c["vocab_size"], "L": L, "sparse": sparse,
            "dense": L - sparse, "E_held": held, "E_pub": held * (c.get("ep_size") or 1),
            "k": c["num_experts_per_tok"], "shared": c.get("n_shared_experts") or 0,
            "I": c["moe_intermediate_size"], "I_dense": c["intermediate_size"],
            "q": c.get("q_lora_rank"), "r": c["kv_lora_rank"], "dn": c["qk_nope_head_dim"],
            "dr": c["qk_rope_head_dim"], "dv": c["v_head_dim"]}


def q_params(s: dict) -> int:
    """The weights a token's query passes through: wq_a and wq_b, or wq."""
    width = s["nh"] * (s["dn"] + s["dr"])
    return s["H"] * width if s["q"] is None else s["H"] * s["q"] + s["q"] * width


def attn_proj_params(s: dict) -> int:
    H, nh = s["H"], s["nh"]
    return (q_params(s) + H * (s["r"] + s["dr"]) + s["r"] * nh * (s["dn"] + s["dv"])
            + nh * s["dv"] * H)


def moe_params_per_token(s: dict) -> float:
    """The router over every published expert, the held experts' share of a
    token's k, and the shared experts."""
    return s["H"] * s["E_pub"] + 3 * s["H"] * s["I"] * (s["k"] * s["E_held"] / s["E_pub"]
                                                        + s["shared"])


def moe_work(c: dict, n: int) -> tuple:
    """(operations, bytes) of one routed-MLP call over n tokens, bf16
    weights: the held experts, the shared experts, the router and the
    correction bias read once a call, the tokens in and out."""
    s = sizes(c)
    H, I = s["H"], s["I"]
    flops = 2.0 * n * moe_params_per_token(s)
    nbytes = 2.0 * (3 * H * I * (s["E_held"] + s["shared"]) + H * s["E_pub"] + s["E_pub"]
                    + 2 * n * H)
    return flops, nbytes


def mla_work(c: dict, B: int, S: int) -> tuple:
    """(operations, bytes) of one absorbed-MLA decode call (_mla_attn_bl)
    over B rows and S cached positions: the q projections (q-LoRA or wq),
    kv_a, wkv_b absorbed into q and the output, and the scores and context
    over the latent cache, all heads; bytes the weights, the cache's S rows
    read and the step's row written, the input in and the output out."""
    s = sizes(c)
    H, nh, r, dn, dr, dv = s["H"], s["nh"], s["r"], s["dn"], s["dr"], s["dv"]
    macs = B * (q_params(s) + H * (r + dr) + nh * dn * r + nh * r * dv + S * nh * (2 * r + dr))
    weights = q_params(s) + H * (r + dr) + r * nh * (dn + dv)
    nbytes = 2.0 * (weights + B * (S + 1) * (r + dr) + B * H + B * nh * dv)
    return 2.0 * macs, nbytes


def caption_flops(c: dict, prompt: int, new_tokens: int) -> float:
    """One request: the prompt's positions and new_tokens - 1 decode steps
    through every layer (the dense ones at intermediate_size, the routed
    ones by moe_params_per_token), causal attention over real positions,
    and the head once for each of the new_tokens tokens it emits."""
    s = sizes(c)
    positions = prompt + new_tokens - 1
    pairs = positions * (positions + 1) / 2
    attn = s["L"] * (2.0 * positions * attn_proj_params(s)
                     + pairs * 2.0 * s["nh"] * (s["dn"] + s["dr"] + s["dv"]))
    mlp = 2.0 * positions * (s["dense"] * 3 * s["H"] * s["I_dense"]
                             + s["sparse"] * moe_params_per_token(s))
    return attn + mlp + new_tokens * 2.0 * s["H"] * s["V"]


least_seconds = counts.least_seconds
PEAK_BF16_FLOPS = counts.PEAK_BF16_FLOPS
