"""Shared encoder->LLM projector, eval forward (counterpart of
dmi_tpu/models/projector.py; reference: dmi/model/projector.py).

  * arch 'mlp'   : Linear(mm,lm) -> GELU(tanh) -> [Linear(lm,lm) -> GELU(tanh)]
                   *(n-2) -> Linear(lm,lm)   (dropout is identity in eval)
  * arch 'linear': Linear(mm,lm)

Weights are stored (in_dim, out_dim), as in the JAX package, so a layer is
`x @ w + b`.  The 2-layer mlp, the serving default, runs the fused CUDA
kernel (ops/cuda/projector.py); linear and deeper mlps are plain torch.
Training (dropout, adapters) comes with the training path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F

from dmi_tpu_torch.ops.cuda.projector import _mlp2_plain, fused_mlp2


@dataclass(frozen=True)
class ProjectorSpec:
    mm_dim: int
    lm_dim: int
    arch: str = "mlp"
    n_layers: int = 2

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


def init(spec: ProjectorSpec, generator: torch.Generator, dtype=torch.float32,
         device="cpu") -> dict:
    """torch nn.Linear default init: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from `generator` (which must live on `device`)."""
    layers = []
    for in_dim, out_dim in spec.layer_dims():
        bound = 1.0 / math.sqrt(in_dim)

        def u(*shape):
            t = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
            return ((t * 2 - 1) * bound).to(dtype)

        layers.append({"w": u(in_dim, out_dim), "b": u(out_dim)})
    return {"layers": layers}


def apply(spec: ProjectorSpec, params: dict, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Eval projector forward (reference: dmi/model/projector.py:56-59).
    plain=True runs the fused kernel's plain twin (a reference path)."""
    layers = params["layers"]
    if spec.arch == "mlp" and spec.n_layers == 2:
        mlp2 = _mlp2_plain if plain else fused_mlp2
        return mlp2(x, layers[0]["w"], layers[0]["b"], layers[1]["w"], layers[1]["b"])
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if spec.arch == "mlp" and i < n - 1:
            # reference instantiates nn.GELU(approximate='tanh')
            x = F.gelu(x, approximate="tanh")
    return x
