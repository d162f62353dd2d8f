"""Hypernetwork emitting per-layer LoRA adapters over the shared projector
(counterpart of dmi_tpu/models/hypernet.py; reference HyperNetwork,
dmi/model/hypernet.py:84-204).

  * learnable prefix tokens, one per projector linear layer (:130)
  * the conditioning set z after the prefix tokens, zero-padded to the fixed
    context length 2*n_tokens + n_proj_layers + 1 with a key mask (:140-163)
  * optional sinusoidal positional encodings scaled 1/sqrt(d) (:26-43,132-135)
  * encoder archs: 'attention' (bare multi-head self-attention, scores over
    sqrt(d_model), attention-weight dropout, no output projection, :46-82),
    'att_w_nonlinear' (that attention + GELU, :101-105) and 'transformer'
    (post-norm torch TransformerEncoderLayers with GELU, :96-98)
  * per-layer linear generator heads emitting flat [a | b | bias] scaled by
    alpha/rank (:109-128, :180-195); layer 0's `a` is truncated to
    mm_dim*rank when hypnet_dim > mm_dim (:187-188)
  * xavier-uniform prefix and generator weights, zero generator bias (:199-204)

Parameters are a plain dict in the JAX package's layout (weights (in, out)),
so bridge.hypernet_params_from_jax converts them without a transpose.
Dropout draws from an explicit generator (utils.rng); its bits are not JAX's.
The whole module is plain torch: the hypernet runs on a context of ~259 rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.linalg import sinusoidal_positions
from dmi_tpu_torch.utils import rng

Adapters = Tuple[List[torch.Tensor], List[torch.Tensor], Optional[List[torch.Tensor]]]


@dataclass(frozen=True)
class HypnetSpec:
    lm_dim: int
    mm_dim: int
    n_tokens: int  # conditioning subset size (subset_batch_size or fewshot_n_tokens)
    arch: str = "transformer"
    n_layers: int = 1
    n_heads: int = 1
    hypnet_dim: int = 768
    rank: int = 32
    alpha: int = 32
    predict_bias: bool = True
    n_proj_layers: int = 2
    use_pos_encs: bool = False
    attn_dropout: float = 0.05  # MHSA weight dropout (dmi/model/hypernet.py:47)
    transformer_dropout: float = 0.1  # torch TransformerEncoderLayer default

    @property
    def context_len(self) -> int:
        # reference: 2*n_tokens + n_prefix + 1 (dmi/model/hypernet.py:134,142)
        return 2 * self.n_tokens + self.n_proj_layers + 1

    def a_dim(self, layer_idx: int) -> int:
        in_dim = self.hypnet_dim if layer_idx == 0 else self.lm_dim
        return in_dim * self.rank

    def b_dim(self, layer_idx: int) -> int:
        return self.rank * self.lm_dim

    def gen_out_dim(self, layer_idx: int) -> int:
        d = self.a_dim(layer_idx) + self.b_dim(layer_idx)
        return d + self.lm_dim if self.predict_bias else d


def _uniform(generator, shape, bound, dtype, device):
    return ((rng.uniform(generator, shape, device) * 2 - 1) * bound).to(dtype)


def _xavier_uniform(generator, shape, fan_in, fan_out, dtype, device):
    return _uniform(generator, shape, math.sqrt(6.0 / (fan_in + fan_out)), dtype, device)


def _linear_default(generator, in_dim, out_dim, dtype, device):
    """torch nn.Linear default init, stored (in, out)."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(generator, (in_dim, out_dim), bound, dtype, device),
            "b": _uniform(generator, (out_dim,), bound, dtype, device)}


def init(spec: HypnetSpec, generator: rng.Generator, dtype=torch.float32,
         device="cpu") -> dict:
    """The reference's init, drawn from `generator` (a torch.Generator on
    `device`, or a CounterRNG)."""
    d = spec.hypnet_dim
    # torch xavier on a (n_prefix, d) tensor: fan_out = dim0, fan_in = dim1
    params = {"prefix_tokens": _xavier_uniform(generator, (spec.n_proj_layers, d), d,
                                               spec.n_proj_layers, dtype, device)}
    gens = []
    for layer_idx in range(spec.n_proj_layers):
        out_dim = spec.gen_out_dim(layer_idx)
        gens.append({"w": _xavier_uniform(generator, (d, out_dim), d, out_dim, dtype, device),
                     "b": torch.zeros(out_dim, dtype=dtype, device=device)})
    params["generators"] = gens
    if spec.arch in ("attention", "att_w_nonlinear"):
        params["attn"] = {n: _linear_default(generator, d, d, dtype, device)
                          for n in ("q", "k", "v")}
    elif spec.arch == "transformer":
        def norm():
            return {"scale": torch.ones(d, dtype=dtype, device=device),
                    "bias": torch.zeros(d, dtype=dtype, device=device)}

        params["blocks"] = [
            {
                # torch MHA: xavier in_proj, zero in_proj bias and out_proj bias
                "in_proj_w": _xavier_uniform(generator, (d, 3 * d), d, 3 * d, dtype, device),
                "in_proj_b": torch.zeros(3 * d, dtype=dtype, device=device),
                "out_proj": {"w": _linear_default(generator, d, d, dtype, device)["w"],
                             "b": torch.zeros(d, dtype=dtype, device=device)},
                "ff1": _linear_default(generator, d, 4 * d, dtype, device),
                "ff2": _linear_default(generator, 4 * d, d, dtype, device),
                "ln1": norm(),
                "ln2": norm(),
            }
            for _ in range(spec.n_layers)
        ]
    else:
        raise ValueError(f"Unknown hypernetwork architecture: {spec.arch}")
    return params


def _dropout(x, rate, generator, train):
    """Keep each element with probability 1 - rate, scaled by 1 / (1 - rate);
    identity in eval mode, at rate 0 or without a generator."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = rng.uniform(generator, x.shape, x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _softmax_masked(scores, key_valid):
    return torch.softmax(scores.masked_fill(~key_valid[None, None, :], -math.inf), dim=-1)


def _heads(t, h):
    L, d = t.shape
    return t.reshape(L, h, d // h).transpose(0, 1)


def _mhsa(spec: HypnetSpec, p: dict, x, key_valid, train, generator):
    """The reference's MultiheadSelfAttention (dmi/model/hypernet.py:46-82):
    scores over sqrt(d_model) (not head_dim), no output projection."""
    L, d = x.shape
    h = spec.n_heads
    q, k, v = (_heads(x @ p[n]["w"] + p[n]["b"], h) for n in ("q", "k", "v"))
    w = _softmax_masked((q @ k.transpose(1, 2)) / math.sqrt(d), key_valid)
    w = _dropout(w, spec.attn_dropout, generator, train)
    return (w @ v).transpose(0, 1).reshape(L, d)


def _layer_norm(x, p, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def _torch_mha(spec: HypnetSpec, blk: dict, x, key_valid, train, generator):
    """torch nn.MultiheadAttention: joint qkv projection, scores over
    sqrt(head_dim), output projection."""
    L, d = x.shape
    h = spec.n_heads
    q, k, v = (_heads(t, h) for t in (x @ blk["in_proj_w"] + blk["in_proj_b"]).chunk(3, -1))
    w = _softmax_masked((q @ k.transpose(1, 2)) / math.sqrt(d // h), key_valid)
    w = _dropout(w, spec.transformer_dropout, generator, train)
    out = (w @ v).transpose(0, 1).reshape(L, d)
    return out @ blk["out_proj"]["w"] + blk["out_proj"]["b"]


def _transformer_block(spec, blk, x, key_valid, train, generator):
    """Post-norm torch TransformerEncoderLayer with an exact-GELU feed-forward."""
    rate = spec.transformer_dropout
    attn = _torch_mha(spec, blk, x, key_valid, train, generator)
    x = _layer_norm(x + _dropout(attn, rate, generator, train), blk["ln1"])
    ff = F.gelu(x @ blk["ff1"]["w"] + blk["ff1"]["b"])
    ff = _dropout(ff, rate, generator, train) @ blk["ff2"]["w"] + blk["ff2"]["b"]
    return _layer_norm(x + _dropout(ff, rate, generator, train), blk["ln2"])


def apply(spec: HypnetSpec, params: dict, z: torch.Tensor, z_len: Optional[int] = None,
          train: bool = False, generator: Optional[rng.Generator] = None) -> Adapters:
    """Flat (a_weights, b_weights, biases) from the conditioning set z
    [n_z, hypnet_dim].  When n_prefix + n_z is below the fixed context
    length, z is zero-padded and the extra keys masked (the reference's
    padding branch, dmi/model/hypernet.py:144-159); z_len (default n_z)
    marks trailing rows of an already padded z invalid.  Dropout (train
    only) draws from `generator`."""
    n_prefix = spec.n_proj_layers
    n_z = z.shape[0]
    if z_len is None:
        z_len = n_z
    seq = torch.cat([params["prefix_tokens"].to(z.dtype), z], dim=0)
    L = max(spec.context_len, n_prefix + n_z)
    if seq.shape[0] < L:
        seq = F.pad(seq, (0, 0, 0, L - seq.shape[0]))
    key_valid = torch.arange(L, device=z.device) < (n_prefix + z_len)
    if spec.use_pos_encs:
        pe = sinusoidal_positions(spec.hypnet_dim, L, device=z.device)
        seq = seq + (pe / math.sqrt(spec.hypnet_dim)).to(seq.dtype)

    if spec.arch in ("attention", "att_w_nonlinear"):
        enc = _mhsa(spec, params["attn"], seq, key_valid, train, generator)
        if spec.arch == "att_w_nonlinear":
            enc = F.gelu(enc)
    elif spec.arch == "transformer":
        enc = seq
        for blk in params["blocks"]:
            enc = _transformer_block(spec, blk, enc, key_valid, train, generator)
    else:
        raise ValueError(spec.arch)

    prefix_enc = enc[:n_prefix]
    scale = spec.alpha / spec.rank
    a_weights, b_weights = [], []
    biases = [] if spec.predict_bias else None
    for idx, gen in enumerate(params["generators"]):
        w = scale * (prefix_enc[idx] @ gen["w"] + gen["b"])
        a_dim, b_dim = spec.a_dim(idx), spec.b_dim(idx)
        a = w[:a_dim]
        if idx == 0 and spec.hypnet_dim > spec.mm_dim:
            a = a[: spec.mm_dim * spec.rank]
        a_weights.append(a)
        b_weights.append(w[a_dim:a_dim + b_dim])
        if spec.predict_bias:
            biases.append(w[a_dim + b_dim:])
    return a_weights, b_weights, biases


def average_adapters(adapter_list: List[Adapters]) -> Adapters:
    """The mean of adapters emitted from several conditioning subsets
    (reference: dmi/model/hypernet.py:234-266)."""
    def mean(k, i):
        return torch.stack([t[k][i] for t in adapter_list]).mean(0)

    n = len(adapter_list[0][0])
    biases = None
    if adapter_list[0][2] is not None:
        biases = [mean(2, i) for i in range(n)]
    return [mean(0, i) for i in range(n)], [mean(1, i) for i in range(n)], biases
