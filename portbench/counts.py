"""The yardstick's arithmetic: the operations a configuration's work needs,
counted from its published sizes and the traffic's shapes, the same
whatever implements it.  A routed MLP counts the k experts each token is
routed to (and the shared experts), never every expert; attention counts
the causal pairs of real positions.  Multiply-adds count 2 operations."""

from __future__ import annotations


def sizes(c: dict) -> dict:
    H = c["hidden_size"]
    nh = c["num_attention_heads"]
    mla = c.get("kv_lora_rank") is not None
    out = {"H": H, "nh": nh, "V": c["vocab_size"], "L": c["num_hidden_layers"], "mla": mla,
           "E": c.get("num_experts") or c.get("n_routed_experts"), "k": c["num_experts_per_tok"],
           "shared": c.get("n_shared_experts") or 0}
    if mla:
        out.update(r=c["kv_lora_rank"], dn=c["qk_nope_head_dim"], dr=c["qk_rope_head_dim"],
                   dv=c["v_head_dim"], I=c["moe_intermediate_size"])
        out["qk"], out["v"] = out["dn"] + out["dr"], out["dv"]
    else:
        hd = H // nh
        out.update(nkv=c["num_key_value_heads"], hd=hd, I=c["intermediate_size"], qk=hd, v=hd)
    return out


def attn_proj_params(s: dict) -> int:
    """Weights a token passes through in one layer's attention."""
    H, nh = s["H"], s["nh"]
    if s["mla"]:
        return (H * nh * (s["dn"] + s["dr"]) + H * (s["r"] + s["dr"])
                + s["r"] * nh * (s["dn"] + s["dv"]) + nh * s["dv"] * H)
    return H * (nh + 2 * s["nkv"]) * s["hd"] + nh * s["hd"] * H


def moe_params_per_token(s: dict) -> int:
    """Router, the k routed experts and the shared experts a token passes through."""
    return s["H"] * s["E"] + 3 * s["H"] * s["I"] * (s["k"] + s["shared"])


def layer_flops_per_token(s: dict) -> float:
    """One layer's matrix operations for one token, without attention's
    products over positions."""
    return 2.0 * (attn_proj_params(s) + moe_params_per_token(s))


def attention_pair_flops(s: dict) -> float:
    """Scores and context of one (query, key) pair in one layer, all heads."""
    return 2.0 * s["nh"] * (s["qk"] + s["v"])


def head_flops(s: dict) -> float:
    return 2.0 * s["H"] * s["V"]


def caption_flops(c: dict, prompt: int, new_tokens: int) -> float:
    """One request: the prompt's positions and new_tokens - 1 decode steps
    through every layer, causal attention over real positions, and the head
    once for each of the new_tokens tokens it emits."""
    s = sizes(c)
    positions = prompt + new_tokens - 1
    pairs = positions * (positions + 1) / 2
    return (s["L"] * (positions * layer_flops_per_token(s) + pairs * attention_pair_flops(s))
            + new_tokens * head_flops(s))


def stage1_flops(c: dict, batch: int, T: int, mm: int) -> float:
    """One stage-1 micro-step: the frozen LLM's forward over batch x T
    positions and its backward to the activations only (the weights take no
    gradient: as many matrix operations again, and twice attention's pair
    products for dQ, dK and dV), the head's logits and their gradient at
    every position, and the 2-layer projector's forward and backward (both
    weights' gradients and the hidden activation's; the embeddings take
    none)."""
    s = sizes(c)
    pairs = batch * T * (T + 1) / 2
    matrix = batch * T * (s["L"] * layer_flops_per_token(s) + head_flops(s))
    attention = s["L"] * pairs * attention_pair_flops(s)
    projector = 2.0 * batch * (mm * s["H"] + s["H"] * s["H"])
    return 2 * matrix + 3 * attention + 2 * projector + 2.0 * batch * s["H"] * s["H"]


# NVIDIA H100 SXM data sheet, dense: the bf16 tensor-core rate and HBM3's bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the bf16 peak and the bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
