"""Shared encoder->LLM projector (counterpart of dmi_tpu/models/projector.py;
reference: dmi/model/projector.py).

  * arch 'mlp'   : Linear(mm,lm) -> GELU(tanh) -> Dropout -> [Linear(lm,lm)
                   -> GELU(tanh) -> Dropout]*(n-2) -> Linear(lm,lm)
  * arch 'linear': Linear(mm,lm) -> Dropout
  * prune        : keep only the first `keep` input features of layer 0
  * lora_apply   : hypernet-emitted low-rank deltas added to the linears
                   (dmi/model/projector.py:118-159).  The reference zips the
                   4-module net against 2 adapter tuples, so its loop stops
                   after [Linear0 + adapter, GELU]: the hypernet is trained
                   against gelu(L0(x) + x@A0@B0 + b0 + d0).  That is kept by
                   default (truncate_like_reference=True), on the fused CUDA
                   kernel fused_lora_layer0 (ops/cuda/lora0.py); False runs
                   the full net, every linear with its adapter, in plain torch.
  * module_lora_apply: the LoRA baseline, which runs the full net
                   (dmi/model/projector.py:61-74), adding (alpha/rank)·x@A@B
                   at each linear.
  * combine_lora : adapters baked into concrete weights
                   (dmi/model/projector.py:76-116): W' = W + A@B, b' = b + d.

Weights are stored (in_dim, out_dim), as in the JAX package, so a layer is
`x @ w + b`.  In eval mode the 2-layer mlp, the serving default, runs the
fused CUDA kernel (ops/cuda/projector.py); linear and deeper mlps, and
every projector in train mode, are plain torch, as in the JAX package.
Dropout draws from an explicit generator (utils.rng); its bits are not JAX's, so
the tests compare it statistically and by its determinism.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda.lora0 import _lora0_plain, fused_lora_layer0
from dmi_tpu_torch.ops.cuda.projector import _mlp2_plain, fused_mlp2
from dmi_tpu_torch.utils import rng


@dataclass(frozen=True)
class ProjectorSpec:
    mm_dim: int
    lm_dim: int
    arch: str = "mlp"
    act: str = "quick_gelu"
    n_layers: int = 2
    dropout: float = 0.1

    def layer_dims(self) -> List[Tuple[int, int]]:
        if self.arch == "linear":
            return [(self.mm_dim, self.lm_dim)]
        if self.arch == "mlp":
            if self.n_layers < 2:
                raise ValueError("mlp projector needs depth >= 2")
            return [(self.mm_dim, self.lm_dim)] + [(self.lm_dim, self.lm_dim)] * (
                self.n_layers - 1
            )
        raise NotImplementedError(self.arch)


def _act(spec: ProjectorSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.act == "quick_gelu":
        # reference instantiates nn.GELU(approximate='tanh')
        return F.gelu(x, approximate="tanh")
    raise NotImplementedError(spec.act)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[rng.Generator]):
    """Keep each element with probability 1 - rate, scaled by 1 / (1 - rate)
    (dmi_tpu's _dropout); identity at rate 0 or without a generator."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = rng.uniform(generator, x.shape, x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def init(spec: ProjectorSpec, generator: rng.Generator, dtype=torch.float32,
         device="cpu") -> dict:
    """torch nn.Linear default init: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from `generator` (a torch.Generator on `device`, or a CounterRNG)."""
    layers = []
    for in_dim, out_dim in spec.layer_dims():
        bound = 1.0 / math.sqrt(in_dim)

        def u(*shape):
            return ((rng.uniform(generator, shape, device) * 2 - 1) * bound).to(dtype)

        layers.append({"w": u(in_dim, out_dim), "b": u(out_dim)})
    return {"layers": layers}


def prune(params: dict, keep: int) -> dict:
    """Slice layer-0 input features to the first `keep` dims
    (reference: dmi/model/projector.py:49-54 prunes net.0.weight columns)."""
    layers = list(params["layers"])
    layers[0] = {**layers[0], "w": layers[0]["w"][:keep, :]}
    return {"layers": layers}


def apply(spec: ProjectorSpec, params: dict, x: torch.Tensor, plain: bool = False,
          train: bool = False, generator: Optional[rng.Generator] = None) -> torch.Tensor:
    """Projector forward (reference: dmi/model/projector.py:56-59).

    train=True applies dropout after the linear ('linear') or after each
    hidden activation ('mlp'), drawing from `generator`, and never takes the
    fused kernel.  In eval mode the 2-layer mlp runs fused_mlp2; plain=True
    runs its plain twin (a reference path)."""
    layers = params["layers"]
    if spec.arch == "linear":
        y = x @ layers[0]["w"] + layers[0]["b"]
        return _dropout(y, spec.dropout, generator) if train else y
    if spec.arch == "mlp" and spec.n_layers == 2 and not train:
        mlp2 = _mlp2_plain if plain else fused_mlp2
        return mlp2(x, layers[0]["w"], layers[0]["b"], layers[1]["w"], layers[1]["b"])
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = _act(spec, x)
            if train:
                x = _dropout(x, spec.dropout, generator)
    return x


def _reshape_ab(a_flat: torch.Tensor, b_flat: torch.Tensor, in_dim: int, out_dim: int):
    """Flat adapters [..., in*r], [..., r*out] -> a [..., in, r], b [..., r, out]."""
    lead = a_flat.shape[:-1]
    return a_flat.reshape(*lead, in_dim, -1), b_flat.reshape(*lead, -1, out_dim)


def lora_apply(spec: ProjectorSpec, params: dict, x: torch.Tensor,
               a_weights: Sequence[torch.Tensor], b_weights: Sequence[torch.Tensor],
               biases: Optional[Sequence[torch.Tensor]], truncate_like_reference: bool = True,
               plain: bool = False) -> torch.Tensor:
    """Projector forward with hypernet-emitted additive low-rank deltas (flat,
    already scaled by alpha/rank).  No dropout: the reference pins the
    pretrained projector to eval inside the hypernet wrapper.

    On the truncated branch x may carry a leading group axis, x [G, B, mm]
    with adapters [G, ...] (the coalesced stage-2 step): one grouped launch
    of fused_lora_layer0.  plain=True runs its plain twin."""
    layers = params["layers"]
    dims = [tuple(layer["w"].shape) for layer in layers]
    if biases is None:
        biases = [torch.zeros(a.shape[:-1] + (out,), dtype=x.dtype, device=x.device)
                  for a, (_, out) in zip(a_weights, dims)]
    if truncate_like_reference and spec.arch == "mlp":
        # the kernel takes contiguous tensors; a group's slice of the
        # generator's flat output is a strided view
        a, b = _reshape_ab(a_weights[0], b_weights[0], *dims[0])
        lora0 = _lora0_plain if plain else fused_lora_layer0
        return lora0(x.contiguous(), layers[0]["w"], layers[0]["b"], a.contiguous(),
                     b.contiguous(), biases[0].contiguous())
    n = len(layers)
    for i, layer in enumerate(layers):
        a, b = _reshape_ab(a_weights[i], b_weights[i], *dims[i])
        y = x @ layer["w"] + layer["b"] + (x @ a) @ b + biases[i]
        x = _act(spec, y) if (i < n - 1 and spec.arch == "mlp") else y
    return x


def module_lora_apply(spec: ProjectorSpec, params: dict, x: torch.Tensor,
                      lora_params: Sequence[dict], alpha: float, rank: int) -> torch.Tensor:
    """LoRA-baseline forward (dmi/model/projector.py:61-74 with
    dmi/model/lora.py:15-17): every linear, delta = (alpha/rank)·x@A@B.  The
    frozen projector stays in eval mode on this path, so no dropout."""
    layers = params["layers"]
    scale = alpha / rank
    n = len(layers)
    for i, layer in enumerate(layers):
        lp = lora_params[i]
        y = x @ layer["w"] + layer["b"] + scale * ((x @ lp["a"]) @ lp["b"])
        x = _act(spec, y) if (i < n - 1 and spec.arch == "mlp") else y
    return x


def combine_lora(spec: ProjectorSpec, params: dict, a_weights: Sequence[torch.Tensor],
                 b_weights: Sequence[torch.Tensor],
                 biases: Optional[Sequence[torch.Tensor]]) -> dict:
    """Adapters baked into a concrete "generated projector"
    (dmi/model/projector.py:76-116): W + A@B and b + d for every layer."""
    layers = params["layers"]
    if len(a_weights) != len(layers):
        raise ValueError(f"{len(a_weights)} adapters for {len(layers)} linear layers")
    if biases is None:
        biases = [torch.zeros_like(layer["b"]) for layer in layers]
    out = []
    for layer, af, bf, d in zip(layers, a_weights, b_weights, biases):
        a, b = _reshape_ab(af, bf, *layer["w"].shape)
        out.append({"w": layer["w"] + a @ b, "b": layer["b"] + d})
    return {"layers": out}
