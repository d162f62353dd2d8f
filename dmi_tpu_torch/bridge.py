"""Bridge between dmi_tpu's parameters and the port's.

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

from dmi_tpu_torch.models import hypernet as hn
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.utils.grad_stats import tree_map

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
    """The port's config for a dmi_tpu LlamaConfig of any family: the same
    fields, with a torch dtype and tuples where JAX code may hold lists."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name not in _IGNORED}
    kw["dtype"] = getattr(torch, np.dtype(jcfg.dtype).name)
    kw["eos_token_ids"] = tuple(kw["eos_token_ids"])
    if kw["layer_sliding"] is not None:
        kw["layer_sliding"] = tuple(bool(f) for f in kw["layer_sliding"])
    return llama.LlamaConfig(**kw)


def llm_params_from_jax(jparams: dict, device="cpu") -> dict:
    """dmi_tpu LLM pytree (stacked [L, ...] layers) -> the port's params
    (an expert stack [L, E, in, out] becomes [E, in, out] per layer).

    A tree quantized by dmi_tpu.models.quant.quantize_llama converts too: a
    leaf that is a dict of stacked arrays ({"q"|"q8"|"qp", "s"|"s4g"})
    becomes per-layer dicts of tensors, the int8 and uint8 payloads carried
    exactly."""
    def leaf(v, i=None):
        if isinstance(v, dict):
            return {k: leaf(a, i) for k, a in v.items()}
        a = np.asarray(v)
        return to_torch(a if i is None else a[i], device)

    stacked = first = jparams["layers"]
    while isinstance(first, dict):  # any stacked array: its length is the depth
        first = next(iter(first.values()))
    n_layers = len(np.asarray(first))
    out = {
        "embed": leaf(jparams["embed"]),
        "layers": [{k: leaf(v, i) for k, v in stacked.items()} for i in range(n_layers)],
        "final_norm": leaf(jparams["final_norm"]),
    }
    if "lm_head" in jparams:  # an untied head
        out["lm_head"] = leaf(jparams["lm_head"])
    return out


def projector_params_from_jax(jparams: dict, device="cpu") -> dict:
    """dmi_tpu projector pytree -> the port's projector params."""
    return {"layers": [
        {"w": to_torch(layer["w"], device), "b": to_torch(layer["b"], device)}
        for layer in jparams["layers"]
    ]}


def projector_params_from_train_state(state, device="cpu") -> dict:
    """A dmi_tpu projector trainer's TrainState -> the port's projector params."""
    return projector_params_from_jax(state.params, device)


def projector_spec_from_jax(jspec) -> proj.ProjectorSpec:
    """dmi_tpu ProjectorSpec -> the port's (the same fields)."""
    return proj.ProjectorSpec(**{f.name: getattr(jspec, f.name)
                                 for f in dataclasses.fields(proj.ProjectorSpec)})


def hypnet_spec_from_jax(jspec) -> hn.HypnetSpec:
    """dmi_tpu HypnetSpec -> the port's (the same fields)."""
    return hn.HypnetSpec(**{f.name: getattr(jspec, f.name)
                            for f in dataclasses.fields(hn.HypnetSpec)})


def hypernet_params_from_jax(jparams: dict, device="cpu") -> dict:
    """dmi_tpu hypernet pytree (any arch) -> the port's: the same tree of
    dicts and lists, with tensors for leaves."""
    return tree_map(lambda a: to_torch(a, device), jparams)


def lora_params_from_jax(jparams, device="cpu") -> list:
    """dmi_tpu LoRA-baseline adapters [{"a", "b"}, ...] -> the port's."""
    return tree_map(lambda a: to_torch(a, device), list(jparams))


def llm_params_to_numpy(params: dict) -> dict:
    """The port's LLM params -> dmi_tpu's pytree layout (layers stacked
    [L, ...]) as numpy; bfloat16 goes through f32, exactly."""
    def host(t):
        return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()

    out = {
        "embed": host(params["embed"]),
        "layers": {k: np.stack([host(lw[k]) for lw in params["layers"]])
                   for k in params["layers"][0]},
        "final_norm": host(params["final_norm"]),
    }
    if "lm_head" in params:
        out["lm_head"] = host(params["lm_head"])
    return out
