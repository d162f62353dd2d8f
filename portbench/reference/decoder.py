"""Plain float32 PyTorch decoders of the benchmark's configurations, written
from the published architectures, for the comparison that decides
`correct`.

Families: OLMoE (allenai/OLMoE-1B-7B-0924, transformers' OlmoeForCausalLM:
RMSNorm over the whole q and k projections, rotate-half rope, a softmax
router whose top-k weights are not renormalised, SwiGLU experts) and
DeepSeek-V2 (deepseek-ai/DeepSeek-V2-Lite, transformers' DeepseekV2ForCausalLM:
multi-head latent attention with a plain q projection, a normed kv latent,
one shared roped key channel rotated as complex pairs, yarn rope; a softmax
router over routed experts plus always-on shared experts).  The score scale
is (qk_nope + qk_rope) ** -0.5, as transformers' DeepseekV2Attention has it;
DeepSeek's own modeling_deepseek.py multiplies it by yarn's mscale squared.

The weights are the benchmark's inputs, in the tree layout the system
under test takes: per layer `wq`/`wk`/`wv`/`wo` (in, out), `q_norm`,
`k_norm`, `ln_attn`, `ln_mlp`, `w_router` (H, E), expert stacks `moe_w1`
(gate) and `moe_w3` (up) [E, H, I] and `moe_w2` (down) [E, I, H],
`w_shared_gate`/`w_shared_up`/`w_shared_down`; MLA's `wq` (H, nh (dn + dr)),
`wkv_a` (H, r + dr), `kv_a_norm`, `wkv_b` (r, nh (dn + dv)); and `embed`
[V, H], `final_norm`, an untied `lm_head` [H, V].  Each layer's weights are
widened to f32 when the layer runs, so the model never sits in memory in
f32.  Nothing here imports the system under test: every routing choice and
every derived weight is worked out again.

`weight_fn` replaces each matrix as it is read (the control's lower
precision); `int8_weights` is the per-output-channel int8 rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def int8_weights(w: torch.Tensor, out_dim: int = -1) -> torch.Tensor:
    """w rounded to int8 with one absmax scale per output channel, back in f32."""
    reduce = [d for d in range(w.dim()) if d != out_dim % w.dim()]
    scale = w.abs().amax(dim=reduce, keepdim=True).clamp_min(1e-30) / 127.0
    return torch.round(w / scale).clamp(-127, 127) * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rotate_half_rope(x, cos, sin):
    """x [..., T, d] rotated in (front half, back half) pairs."""
    d = x.shape[-1] // 2
    rot = torch.cat([-x[..., d:], x[..., :d]], dim=-1)
    return x * torch.cat([cos, cos], -1) + rot * torch.cat([sin, sin], -1)


def complex_pair_rope(x, cos, sin):
    """x [..., T, d] rotated in adjacent (even, odd) pairs, as complex numbers."""
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos], -1).flatten(-2)


def yarn_inv_freq(dim, base, scaling):
    """Yarn's inverse frequencies (arXiv:2309.00071, transformers'
    _compute_yarn_parameters) and its cos/sin factor."""
    factor = scaling["factor"]
    orig = scaling.get("original_max_position_embeddings")

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(scaling.get("beta_fast") or 32)), 0)
    high = min(math.ceil(corr(scaling.get("beta_slow") or 1)), dim - 1)
    if low == high:
        high += 0.001
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    extra = 1 - ramp
    inv = (1 / (factor * pos)) * (1 - extra) + (1 / pos) * extra

    def mscale(s, m=1.0):
        return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0

    m, m_all = scaling.get("mscale"), scaling.get("mscale_all_dim")
    att = mscale(factor, m) / mscale(factor, m_all) if m and m_all else mscale(factor)
    return inv, att


class Decoder:
    """One configuration (its published config.json as a dict) over one
    weight tree; every computation in f32."""

    def __init__(self, config: dict, tree: dict,
                 weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        # a float32 product must not run in TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.c, self.tree = config, tree
        self.weight_fn = weight_fn
        self.mla = config.get("kv_lora_rank") is not None
        self.eps = config["rms_norm_eps"]
        self.E = config.get("num_experts") or config.get("n_routed_experts")
        self.k = config["num_experts_per_tok"]

    def w(self, t: torch.Tensor, matrix: bool = True) -> torch.Tensor:
        t = t.float()
        return self.weight_fn(t) if matrix and self.weight_fn is not None else t

    def rope(self, T: int, device):
        c = self.c
        if self.mla:
            dim = c["qk_rope_head_dim"]
            inv, att = yarn_inv_freq(dim, float(c["rope_theta"]), c["rope_scaling"])
        else:
            dim = c["hidden_size"] // c["num_attention_heads"]
            inv = 1.0 / (float(c["rope_theta"]) ** (torch.arange(0, dim, 2, dtype=torch.float64)
                                                     / dim))
            att = 1.0
        ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
        return ((torch.cos(ang) * att).float().to(device), (torch.sin(ang) * att).float().to(device))

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.tree["embed"][ids].float()

    def attention(self, lw, h, cos, sin):
        c = self.c
        B, T, H = h.shape
        nh = c["num_attention_heads"]
        if self.mla:
            r, dn, dr, dv = (c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                             c["v_head_dim"])
            q = (h @ self.w(lw["wq"])).view(B, T, nh, dn + dr).transpose(1, 2)
            kv_a = h @ self.w(lw["wkv_a"])
            latent = rms_norm(kv_a[..., :r], self.w(lw["kv_a_norm"], False), self.eps)
            kv = (latent @ self.w(lw["wkv_b"])).view(B, T, nh, dn + dv).transpose(1, 2)
            q_pe = complex_pair_rope(q[..., dn:], cos, sin)
            k_pe = complex_pair_rope(kv_a[:, None, :, r:], cos, sin)
            scores = (q[..., :dn] @ kv[..., :dn].transpose(-1, -2) + q_pe @ k_pe.transpose(-1, -2))
            scores = scores * (dn + dr) ** -0.5
            v = kv[..., dn:]
        else:
            nkv = c["num_key_value_heads"]
            hd = H // nh
            q = rms_norm(h @ self.w(lw["wq"]), self.w(lw["q_norm"], False), self.eps)
            k = rms_norm(h @ self.w(lw["wk"]), self.w(lw["k_norm"], False), self.eps)
            v = (h @ self.w(lw["wv"])).view(B, T, nkv, hd).transpose(1, 2)
            q = rotate_half_rope(q.view(B, T, nh, hd).transpose(1, 2), cos, sin)
            k = rotate_half_rope(k.view(B, T, nkv, hd).transpose(1, 2), cos, sin)
            k, v = (t.repeat_interleave(nh // nkv, dim=1) for t in (k, v))
            scores = (q @ k.transpose(-1, -2)) * hd ** -0.5
        causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = (probs @ v).transpose(1, 2).reshape(B, T, -1)
        return out @ self.w(lw["wo"])

    def routed_mlp(self, lw, h):
        """Each token through its top-k experts only (sparse dispatch), the
        weights softmax probabilities, not renormalised when the config says
        so; plus the shared experts."""
        c = self.c
        B, T, H = h.shape
        x = h.reshape(B * T, H)
        probs = torch.softmax(x @ self.w(lw["w_router"]), dim=-1)
        top, idx = torch.topk(probs, self.k, dim=-1)
        if c.get("norm_topk_prob"):
            top = top / top.sum(-1, keepdim=True)
        top = top * float(c.get("routed_scaling_factor") or 1.0)
        out = torch.zeros_like(x)
        for e in range(self.E):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            ye = (F.silu(xe @ self.w(lw["moe_w1"][e])) * (xe @ self.w(lw["moe_w3"][e]))
                  ) @ self.w(lw["moe_w2"][e])
            out.index_add_(0, rows, ye * top[rows, slot, None])
        if "w_shared_gate" in lw:
            out = out + (F.silu(x @ self.w(lw["w_shared_gate"])) * (x @ self.w(lw["w_shared_up"]))
                         ) @ self.w(lw["w_shared_down"])
        return out.reshape(B, T, H)

    def layer(self, i: int, x: torch.Tensor, cos, sin) -> torch.Tensor:
        lw = self.tree["layers"][i]
        x = x + self.attention(lw, rms_norm(x, self.w(lw["ln_attn"], False), self.eps), cos, sin)
        return x + self.routed_mlp(lw, rms_norm(x, self.w(lw["ln_mlp"], False), self.eps))

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

    def loss_grad(self, x: torch.Tensor, labels: torch.Tensor):
        """(loss, dloss/dx) of the shifted token-mean cross-entropy over input
        embeddings x [B, T, H] and labels [B, T] (-100 ignored): the forward
        layer by layer keeping each layer's input, then each layer recomputed
        with autograd on the way back."""
        cos, sin = self.rope(x.shape[1], x.device)
        xs = [x.detach().float()]
        with torch.no_grad():
            for i in range(len(self.tree["layers"])):
                xs.append(self.layer(i, xs[-1], cos, sin))
        top = xs.pop().requires_grad_()
        logits = self.head(top)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               labels[:, 1:].reshape(-1), ignore_index=-100)
        (g,) = torch.autograd.grad(loss, top)
        del logits
        for i in reversed(range(len(xs))):
            inp = xs.pop().requires_grad_()
            (g,) = torch.autograd.grad(self.layer(i, inp, cos, sin), inp, g)
        return loss.detach(), g
