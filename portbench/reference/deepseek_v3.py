"""Plain float32 PyTorch DeepSeek-V3 decoder (deepseek-ai/DeepSeek-V3's
config.json; transformers' DeepseekV3ForCausalLM and DeepSeek's own
modeling_deepseek.py), for the comparison that decides `correct` in the
cells of the configurations whose model_type is deepseek_v3.  It also
runs DeepSeek-V2's published mixed stacks (model_type deepseek_v2: softmax
routing, its leading dense layer), which the V2 reference of decoder.py,
written for the all-sparse stacks, does not take.

Per layer, in f32:
- Multi-head latent attention in its expanded form: q through the q-LoRA
  bottleneck (wq_a, the normed rank-q_lora_rank latent, wq_b) or a plain wq
  (V2-Lite's layout); k and v per head from the normed kv latent through
  wkv_b; one shared roped key channel rotated as complex pairs; yarn rope
  (its inverse frequencies and its attention factor on cos and sin); the
  scores scaled by (qk_nope + qk_rope) ** -0.5, times yarn's
  mscale(factor, mscale_all_dim) ** 2 for deepseek_v3 (transformers'
  DeepseekV3Attention, DeepSeek's code).
- Layers i < first_k_dense_replace (and those off moe_layer_freq): a dense
  SwiGLU MLP intermediate_size wide.
- The others: a router over all the published experts E (the config's
  n_routed_experts times its ep_size), in f32.  deepseek_v3: s =
  sigmoid(logits), c = s + e_score_correction_bias; a group of E / n_group
  experts scores the sum of its two best c; the topk_group best groups are
  kept and the other groups' c set to 0 (transformers' masking; DeepSeek's
  code masks with -inf, which chooses alike while some kept c is positive);
  the top num_experts_per_tok of c are chosen and weighted by s over their
  sum when norm_topk_prob, times routed_scaling_factor.  deepseek_v2: the
  top-k of softmax(logits), renormalised when norm_topk_prob, times
  routed_scaling_factor.  Then sparse dispatch: each token through the
  chosen experts that the tree holds (experts [0, n_routed_experts) when
  ep_size > 1, one expert-parallel rank's share; all of them otherwise),
  plus the shared experts, which every rank computes.

Departures from the published model: an ep_size > 1 config is one rank's
share of an expert-parallel layer, computed without its exchange: the
experts the rank does not hold add nothing, here as in the system under
test.  The multi-token-prediction layer is left out, as transformers'
DeepseekV3ForCausalLM leaves it out.  Weights are the benchmark's random
bf16 draws; the published checkpoint's FP8 block scales are not modelled.

The weights are the system's tree layout (decoder.py's names): per layer
`wq_a` (H, q), `q_a_norm`, `wq_b` (q, nh (dn + dr)) or `wq`, `wkv_a` (H, r +
dr), `kv_a_norm`, `wkv_b` (r, nh (dn + dv)), `wo`, `ln_attn`, `ln_mlp`; a
sparse layer's `w_router` (H, E), `router_bias` [E] (deepseek_v3), the held
stacks `moe_w1`/`moe_w3` [E_held, H, I] and `moe_w2` [E_held, I, H] and
`w_shared_gate`/`w_shared_up`/`w_shared_down`; a dense layer's `w_gate`,
`w_up`, `w_down`; `embed`, `final_norm`, `lm_head`.  Each layer's weights
are widened to f32 when the layer runs.  Nothing here imports the system
under test.  `weight_fn` replaces each matrix as it is read (decoder.py's
`int8_weights` for the control).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from portbench.reference.decoder import complex_pair_rope, rms_norm, yarn_inv_freq


def layer_is_sparse(c: dict, i: int) -> bool:
    """HF's and DeepSeek's rule for layer i's MLP."""
    return (bool(c.get("n_routed_experts")) and i >= (c.get("first_k_dense_replace") or 0)
            and i % (c.get("moe_layer_freq") or 1) == 0)


class Decoder:
    """One deepseek_v3 (or mixed deepseek_v2) configuration, its published
    config.json as a dict, over one weight tree; every computation in f32."""

    def __init__(self, config: dict, tree: dict,
                 weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        # a float32 product must not run in TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.c = config
        self.tree, self.weight_fn = tree, weight_fn
        self.eps = c["rms_norm_eps"]
        self.sigmoid = c["model_type"] == "deepseek_v3"
        self.k = c["num_experts_per_tok"]
        dn, dr = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        self.scale = (dn + dr) ** -0.5
        rs = c.get("rope_scaling") or {}
        if self.sigmoid and rs.get("mscale_all_dim") and rs["factor"] > 1:
            self.scale *= (0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0) ** 2

    def w(self, t: torch.Tensor, matrix: bool = True) -> torch.Tensor:
        t = t.float()
        return self.weight_fn(t) if matrix and self.weight_fn is not None else t

    def rope(self, T: int, device):
        c = self.c
        inv, att = yarn_inv_freq(c["qk_rope_head_dim"], float(c["rope_theta"]),
                                 c["rope_scaling"])
        ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
        return tuple((f(ang) * att).float().to(device) for f in (torch.cos, torch.sin))

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.tree["embed"][ids].float()

    def attention(self, lw, h, cos, sin):
        c = self.c
        B, T, _ = h.shape
        nh, r = c["num_attention_heads"], c["kv_lora_rank"]
        dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        if "wq" in lw:
            q = h @ self.w(lw["wq"])
        else:
            q_lat = rms_norm(h @ self.w(lw["wq_a"]), self.w(lw["q_a_norm"], False), self.eps)
            q = q_lat @ self.w(lw["wq_b"])
        q = q.view(B, T, nh, dn + dr).transpose(1, 2)
        kv_a = h @ self.w(lw["wkv_a"])
        latent = rms_norm(kv_a[..., :r], self.w(lw["kv_a_norm"], False), self.eps)
        kv = (latent @ self.w(lw["wkv_b"])).view(B, T, nh, dn + dv).transpose(1, 2)
        q_pe = complex_pair_rope(q[..., dn:], cos, sin)
        k_pe = complex_pair_rope(kv_a[:, None, :, r:], cos, sin)
        scores = (q[..., :dn] @ kv[..., :dn].transpose(-1, -2) + q_pe @ k_pe.transpose(-1, -2))
        causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax((scores * self.scale).masked_fill(~causal, float("-inf")), dim=-1)
        out = (probs @ kv[..., dn:]).transpose(1, 2).reshape(B, T, nh * dv)
        return out @ self.w(lw["wo"])

    def route(self, lw, x):
        """(chosen experts [N, k], their weights [N, k]) of tokens x [N, H]."""
        c = self.c
        logits = x @ self.w(lw["w_router"])
        if self.sigmoid:
            s = torch.sigmoid(logits)
            choice = s + lw["router_bias"].float()
            G = c["n_group"]
            groups = choice.view(len(x), G, -1)
            best = groups.topk(2, dim=-1).values.sum(-1).topk(c["topk_group"], dim=-1).indices
            kept = torch.zeros(len(x), G, dtype=torch.bool, device=x.device)
            kept[torch.arange(len(x), device=x.device)[:, None], best] = True
            choice = torch.where(kept[..., None], groups, 0.0).view(len(x), -1)
            idx = choice.topk(self.k, dim=-1).indices
            top = s.gather(-1, idx)
            if c.get("norm_topk_prob"):
                top = top / (top.sum(-1, keepdim=True) + 1e-20)
        else:
            top, idx = torch.softmax(logits, dim=-1).topk(self.k, dim=-1)
            if c.get("norm_topk_prob"):
                top = top / top.sum(-1, keepdim=True)
        return idx, top * float(c.get("routed_scaling_factor") or 1.0)

    @staticmethod
    def swiglu(x, gate, up, down):
        return (F.silu(x @ gate) * (x @ up)) @ down

    def routed_mlp(self, lw, h):
        """Each token through the chosen experts this tree holds (sparse
        dispatch), plus the shared experts."""
        B, T, H = h.shape
        x = h.reshape(B * T, H)
        idx, top = self.route(lw, x)
        out = torch.zeros_like(x)
        for e in range(lw["moe_w2"].shape[0]):  # the held experts [0, E_held)
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel():
                y = self.swiglu(x[rows], self.w(lw["moe_w1"][e]), self.w(lw["moe_w3"][e]),
                                self.w(lw["moe_w2"][e]))
                out.index_add_(0, rows, y * top[rows, slot, None])
        if "w_shared_gate" in lw:
            out = out + self.swiglu(x, self.w(lw["w_shared_gate"]), self.w(lw["w_shared_up"]),
                                    self.w(lw["w_shared_down"]))
        return out.reshape(B, T, H)

    def layer(self, i: int, x: torch.Tensor, cos, sin) -> torch.Tensor:
        lw = self.tree["layers"][i]
        x = x + self.attention(lw, rms_norm(x, self.w(lw["ln_attn"], False), self.eps), cos, sin)
        h = rms_norm(x, self.w(lw["ln_mlp"], False), self.eps)
        if layer_is_sparse(self.c, i):
            return x + self.routed_mlp(lw, h)
        return x + self.swiglu(h, self.w(lw["w_gate"]), self.w(lw["w_up"]), self.w(lw["w_down"]))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.w(self.tree["final_norm"], False), self.eps)
        return x @ self.w(self.tree["lm_head"])

    @torch.no_grad()
    def logits(self, x: torch.Tensor, first: int = 0) -> torch.Tensor:
        """Causal forward over input embeddings x [B, T, H] -> logits [B, T -
        first, V] of the positions from `first` on."""
        cos, sin = self.rope(x.shape[1], x.device)
        x = x.float()
        for i in range(len(self.tree["layers"])):
            x = self.layer(i, x, cos, sin)
        return self.head(x[:, first:])
