"""Bridge from dmi_tpu's parameters to the port's.

dmi_tpu keeps an LLM as a pytree with per-layer weights stacked [L, ...]
and a projector as {"layers": [{"w", "b"}, ...]}, both in the (in, out)
layout the port keeps, so converting is a split along L and no transpose.
The functions take the arrays as numpy (np.asarray of a jax array gives
one) and a dmi_tpu LlamaConfig by its fields: nothing here imports JAX.
With the same weights both packages compute the same function, which is
how the tests hold the port against the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dmi_tpu_torch.models import llama

# dmi_tpu LlamaConfig fields with no meaning for serving on the card
_IGNORED = {"attention_impl"}


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy (or array-like) -> tensor (a copy); bfloat16 arrays go
    through f32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def config_from_jax(jcfg) -> llama.LlamaConfig:
    """The port's config for a dmi_tpu LlamaConfig.  Raises
    NotImplementedError when it sets a field of another decoder family."""
    ported = {f.name for f in dataclasses.fields(llama.LlamaConfig)}
    kw = {}
    for f in dataclasses.fields(jcfg):
        value = getattr(jcfg, f.name)
        if f.name in ported:
            kw[f.name] = value
        elif f.name not in _IGNORED and value != f.default:
            feature = llama.UNPORTED_FIELDS.get(f.name, "family")
            raise NotImplementedError(
                f"{f.name}={value!r}: {feature} are not ported yet "
                "(ROADMAP.md A.9, decoder families)"
            )
    kw["dtype"] = getattr(torch, np.dtype(jcfg.dtype).name)
    kw["eos_token_ids"] = tuple(kw["eos_token_ids"])
    return llama.LlamaConfig(**kw)


def llm_params_from_jax(jparams: dict, device="cpu") -> dict:
    """dmi_tpu LLM pytree (stacked [L, ...] layers) -> the port's params."""
    stacked = {k: np.asarray(v) for k, v in jparams["layers"].items()}
    n_layers = len(next(iter(stacked.values())))
    return {
        "embed": to_torch(jparams["embed"], device),
        "layers": [
            {k: to_torch(v[i], device) for k, v in stacked.items()}
            for i in range(n_layers)
        ],
        "final_norm": to_torch(jparams["final_norm"], device),
    }


def projector_params_from_jax(jparams: dict, device="cpu") -> dict:
    """dmi_tpu projector pytree -> the port's projector params."""
    return {"layers": [
        {"w": to_torch(layer["w"], device), "b": to_torch(layer["b"], device)}
        for layer in jparams["layers"]
    ]}
