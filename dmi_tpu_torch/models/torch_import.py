"""Read the reference's torch ``.pt`` checkpoints into the port's parameter
trees (counterpart of dmi_tpu/models/torch_import.py).

The reference saves every artifact with ``torch.save`` as
``{'step_idx', '<type>_state_dict', 'optimizer_state_dict', <metric>}``
(dmi/train.py:229-238), where <type> is:

  * ``projector``   — ``Projector.state_dict()``: ``net.{i}.weight|bias``
    with i the nn.ModuleList index of each Linear (0, 3, 6, ... for mlp;
    0 for linear) (dmi/model/projector.py:25-44)
  * ``hypernet``    — ``HyperNetWrapper.state_dict()``: ``hypernet.*`` (the
    HyperNetwork) + ``projector.net.*`` (the frozen pretrained projector)
    (dmi/train_hypernet.py:30-31,404-415)
  * ``lora_model``  — ``LoraWrapper.state_dict()``:
    ``lora_adapters.loras.{i}.A|B`` + ``projector.net.*``
    (dmi/train_lora.py:28-29, dmi/model/lora.py:6-38)

torch ``nn.Linear.weight`` is (out, in); the port stores (in, out), as
dmi_tpu does, so every linear weight transposes on import.  LoRA ``A`` is a
raw Parameter already shaped (in, rank) and ``B`` (rank, out): no transpose
(dmi/model/lora.py:10-11).

The trees come out with f32 numpy leaves, as dmi_tpu's do, so that both
packages read one file into the same numbers.  Everything here is
dmi_tpu's code but for one thing: the ``pos_encs.pe`` buffer that the
exporter writes comes from the port's sinusoidal table, which differs from
the JAX package's in the last bits of some entries (the importer drops the
buffer and the hypernet recomputes it).
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from dmi_tpu_torch.ops.linalg import sinusoidal_positions


# ---------------------------------------------------------------------------
# Raw checkpoint loading
# ---------------------------------------------------------------------------

def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().to("cpu").float().numpy()
    return np.asarray(t, np.float32)


def load_torch_file(path: str) -> dict:
    """torch.load with CPU mapping; returns the raw checkpoint dict.  Not
    weights_only, as dmi_tpu reads these files: the reference's envelopes
    may hold numpy scalars (its metrics), so load only files you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _numpy_state_dict(sd: dict) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Per-model converters (state dict -> parameter tree)
# ---------------------------------------------------------------------------

_NET_KEY = re.compile(r"^net\.(\d+)\.(weight|bias)$")


def projector_from_state_dict(
    sd: Dict[str, np.ndarray], prune: Optional[int] = None
) -> dict:
    """``net.{i}.weight|bias`` -> ``{"layers": [{"w","b"}, ...]}``.

    Module indices are sparse (GELU/Dropout occupy slots); linears are
    ordered by index.  ``prune`` replicates the reference's column slice of
    ``net.0.weight`` at load time (dmi/model/projector.py:49-54): torch
    (out, in) columns = input features, i.e. rows of the (in, out) w.
    """
    by_idx: Dict[int, dict] = {}
    for key, val in sd.items():
        m = _NET_KEY.match(key)
        if not m:
            raise KeyError(f"unexpected projector key {key!r}")
        idx, kind = int(m.group(1)), m.group(2)
        entry = by_idx.setdefault(idx, {})
        entry["w" if kind == "weight" else "b"] = val
    layers = []
    for i in sorted(by_idx):
        entry = by_idx[i]
        w = entry["w"]
        if prune is not None and i == 0:
            w = w[:, :prune]
        layers.append({"w": np.ascontiguousarray(w.T), "b": entry["b"]})
    return {"layers": layers}


def lora_from_state_dict(sd: Dict[str, np.ndarray]) -> List[dict]:
    """``loras.{i}.A|B`` (optionally under ``lora_adapters.``) -> adapter list."""
    by_idx: Dict[int, dict] = {}
    pat = re.compile(r"(?:^|\.)loras\.(\d+)\.([AB])$")
    for key, val in sd.items():
        m = pat.search(key)
        if not m:
            raise KeyError(f"unexpected lora key {key!r}")
        idx, kind = int(m.group(1)), m.group(2)
        by_idx.setdefault(idx, {})["a" if kind == "A" else "b"] = val
    return [by_idx[i] for i in sorted(by_idx)]


def _lin(sd: Dict[str, np.ndarray], name: str) -> dict:
    return {
        "w": np.ascontiguousarray(sd[f"{name}.weight"].T),
        "b": sd[f"{name}.bias"],
    }


def detect_hypernet_arch(sd: Dict[str, np.ndarray]) -> str:
    """Infer the encoder arch from the key layout (see hypernet_from_state_dict)."""
    if any(k.startswith("hypnet.layers.") for k in sd):
        return "transformer"
    if any(k.startswith("hypnet.0.") for k in sd):
        return "att_w_nonlinear"
    return "attention"


def hypernet_from_state_dict(sd: Dict[str, np.ndarray], arch: str = "auto") -> dict:
    """HyperNetwork.state_dict() -> the hypernet tree of models.hypernet.

    Key layouts per arch (dmi/model/hypernet.py:96-135):
      attention:        ``hypnet.q|k|v.weight|bias``
      att_w_nonlinear:  ``hypnet.0.q|k|v.weight|bias`` (Sequential[MHSA, GELU])
      transformer:      ``hypnet.layers.{i}.self_attn.in_proj_weight|bias``,
                        ``...out_proj.weight|bias``, ``linear1|linear2.*``,
                        ``norm1|norm2.weight|bias``
    plus ``generators.{i}.weight|bias``, ``prefix_tokens``, and (when
    use_pos_encs) the deterministic ``pos_encs.pe`` buffer, which is
    recomputed rather than imported.
    """
    if arch == "auto":
        arch = detect_hypernet_arch(sd)
    params: dict = {"prefix_tokens": sd["prefix_tokens"]}

    gen_idx = sorted(
        {int(m.group(1)) for k in sd if (m := re.match(r"^generators\.(\d+)\.", k))}
    )
    params["generators"] = [_lin(sd, f"generators.{i}") for i in gen_idx]

    if arch in ("attention", "att_w_nonlinear"):
        base = "hypnet.0" if arch == "att_w_nonlinear" else "hypnet"
        params["attn"] = {
            "q": _lin(sd, f"{base}.q"),
            "k": _lin(sd, f"{base}.k"),
            "v": _lin(sd, f"{base}.v"),
        }
    elif arch == "transformer":
        layer_idx = sorted(
            {
                int(m.group(1))
                for k in sd
                if (m := re.match(r"^hypnet\.layers\.(\d+)\.", k))
            }
        )
        blocks = []
        for i in layer_idx:
            p = f"hypnet.layers.{i}"
            blocks.append(
                {
                    "in_proj_w": np.ascontiguousarray(
                        sd[f"{p}.self_attn.in_proj_weight"].T
                    ),
                    "in_proj_b": sd[f"{p}.self_attn.in_proj_bias"],
                    "out_proj": _lin(sd, f"{p}.self_attn.out_proj"),
                    "ff1": _lin(sd, f"{p}.linear1"),
                    "ff2": _lin(sd, f"{p}.linear2"),
                    "ln1": {"scale": sd[f"{p}.norm1.weight"], "bias": sd[f"{p}.norm1.bias"]},
                    "ln2": {"scale": sd[f"{p}.norm2.weight"], "bias": sd[f"{p}.norm2.bias"]},
                }
            )
        params["blocks"] = blocks
    else:
        raise ValueError(f"unknown hypernet arch {arch!r}")
    return params


def _split_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Checkpoint-level entry points
# ---------------------------------------------------------------------------

def load_torch_checkpoint(
    path: str,
    *,
    arch: str = "auto",
    prune: Optional[int] = None,
) -> dict:
    """Load a reference ``.pt`` checkpoint and convert every model state
    dict it holds into parameter trees.

    Returns a dict with (whichever apply):
      ``projector``          {"layers": [...]}          (projector ckpts, and
                             the frozen projector inside hypernet/lora ckpts)
      ``hypernet``           hypernet tree              (hypernet ckpts)
      ``lora_adapters``      [{"a","b"}, ...]           (lora ckpts)
      ``step_idx``           int                        (when present)
      ``metric``             float                      (when present)
      ``optimizer_state``    raw numpy moments by param index (when present):
                             {idx: {"step","exp_avg","exp_avg_sq"}}

    ``arch`` selects the hypernet encoder layout; ``prune`` replicates the
    load-time column slice of ``net.0.weight``
    (dmi/train_projector.py:166-176, dmi/train_hypernet.py:417-427).
    """
    ckpt = load_torch_file(path)
    out: dict = {}
    for meta in ("step_idx", "metric"):
        if meta in ckpt:
            out[meta] = ckpt[meta]

    if "projector_state_dict" in ckpt:
        sd = _numpy_state_dict(ckpt["projector_state_dict"])
        out["projector"] = projector_from_state_dict(sd, prune=prune)
    if "hypernet_state_dict" in ckpt:
        sd = _numpy_state_dict(ckpt["hypernet_state_dict"])
        hn_sd = _split_prefix(sd, "hypernet.")
        # drop the deterministic sinusoidal buffer; recomputed at apply time
        hn_sd.pop("pos_encs.pe", None)
        out["hypernet"] = hypernet_from_state_dict(hn_sd, arch=arch)
        proj_sd = _split_prefix(sd, "projector.")
        if proj_sd:
            out["projector"] = projector_from_state_dict(proj_sd, prune=prune)
    if "lora_model_state_dict" in ckpt:
        sd = _numpy_state_dict(ckpt["lora_model_state_dict"])
        lora_sd = {k: v for k, v in sd.items() if ".loras." in k or k.startswith("loras.")}
        out["lora_adapters"] = lora_from_state_dict(lora_sd)
        proj_sd = _split_prefix(sd, "projector.")
        if proj_sd:
            out["projector"] = projector_from_state_dict(proj_sd, prune=prune)

    if "optimizer_state_dict" in ckpt and isinstance(ckpt["optimizer_state_dict"], dict):
        state = ckpt["optimizer_state_dict"].get("state", {})
        out["optimizer_state"] = {
            int(i): {
                "step": int(_to_numpy(s["step"]).item()) if "step" in s else None,
                "exp_avg": _to_numpy(s["exp_avg"]) if "exp_avg" in s else None,
                "exp_avg_sq": _to_numpy(s["exp_avg_sq"]) if "exp_avg_sq" in s else None,
            }
            for i, s in state.items()
        }

    if not any(k in out for k in ("projector", "hypernet", "lora_adapters")):
        raise KeyError(
            f"no recognized *_state_dict in checkpoint {path!r}: {sorted(ckpt)}"
        )
    return out


def export_projector_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """Inverse of projector_from_state_dict for the mlp/linear layouts: emit
    reference ``net.{i}.weight|bias`` keys ((out, in) torch layout) so that
    projectors trained here can be consumed by the reference code."""
    layers = params["layers"]
    sd: Dict[str, np.ndarray] = {}
    for li, layer in enumerate(layers):
        # linears sit at module slots 0, 3, 6, ... (Linear, GELU, Dropout)*
        idx = 3 * li
        sd[f"net.{idx}.weight"] = np.ascontiguousarray(np.asarray(layer["w"]).T)
        sd[f"net.{idx}.bias"] = np.asarray(layer["b"])
    return sd


def export_lora_state_dict(adapters: List[dict]) -> Dict[str, np.ndarray]:
    """Inverse of lora_from_state_dict: ``loras.{i}.A|B`` keys
    (reference LoraAdapters layout, dmi/model/lora.py:20-38)."""
    sd: Dict[str, np.ndarray] = {}
    for i, ad in enumerate(adapters):
        sd[f"loras.{i}.A"] = np.asarray(ad["a"])
        sd[f"loras.{i}.B"] = np.asarray(ad["b"])
    return sd


def export_hypernet_state_dict(params: dict, spec) -> Dict[str, np.ndarray]:
    """Inverse of hypernet_from_state_dict: emit the reference
    ``HyperNetwork.state_dict()`` key layout (dmi/model/hypernet.py:96-135)
    for ``spec.arch``, including the persistent ``pos_encs.pe`` buffer
    (``[1, context_len, d]`` scaled sinusoidal table, :26-43,132-135) when
    ``spec.use_pos_encs``: torch's strict ``load_state_dict`` requires it.
    ``spec`` is a models.hypernet.HypnetSpec."""

    def lin(name: str, layer: dict, sd: Dict[str, np.ndarray]) -> None:
        sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(layer["w"]).T)
        sd[f"{name}.bias"] = np.asarray(layer["b"])

    sd: Dict[str, np.ndarray] = {"prefix_tokens": np.asarray(params["prefix_tokens"])}
    for i, gen in enumerate(params["generators"]):
        lin(f"generators.{i}", gen, sd)

    if spec.arch in ("attention", "att_w_nonlinear"):
        base = "hypnet.0" if spec.arch == "att_w_nonlinear" else "hypnet"
        for name in ("q", "k", "v"):
            lin(f"{base}.{name}", params["attn"][name], sd)
    elif spec.arch == "transformer":
        for i, blk in enumerate(params["blocks"]):
            p = f"hypnet.layers.{i}"
            sd[f"{p}.self_attn.in_proj_weight"] = np.ascontiguousarray(
                np.asarray(blk["in_proj_w"]).T
            )
            sd[f"{p}.self_attn.in_proj_bias"] = np.asarray(blk["in_proj_b"])
            lin(f"{p}.self_attn.out_proj", blk["out_proj"], sd)
            lin(f"{p}.linear1", blk["ff1"], sd)
            lin(f"{p}.linear2", blk["ff2"], sd)
            for ln_key, ref_name in (("ln1", "norm1"), ("ln2", "norm2")):
                sd[f"{p}.{ref_name}.weight"] = np.asarray(blk[ln_key]["scale"])
                sd[f"{p}.{ref_name}.bias"] = np.asarray(blk[ln_key]["bias"])
    else:
        raise ValueError(f"unknown hypernet arch {spec.arch!r}")

    if spec.use_pos_encs:
        pe = sinusoidal_positions(spec.hypnet_dim, spec.context_len).numpy()
        sd["pos_encs.pe"] = (pe / np.sqrt(np.float32(spec.hypnet_dim)))[None].astype(
            np.float32
        )
    return sd


def _prefixed(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {prefix + k: v for k, v in sd.items()}


def save_reference_checkpoint(
    path: str,
    *,
    save_type: str,
    state_dict: Dict[str, np.ndarray],
    step_idx: int = 0,
    metric_name: str = "loss",
    metric: float = 0.0,
) -> None:
    """Write a reference-loadable ``.pt`` checkpoint via ``torch.save``:
    ``{step_idx, f"{save_type}_state_dict", optimizer_state_dict, metric}``
    (envelope of dmi/train.py:230-234 / train_hypernet.py:408-412,451-456).

    The model-consumption paths (load_model_checkpoint,
    load_fewshot_model_checkpoint, load_hypernet_checkpoint) never read
    optimizer state, so it is written as ``None``.

    ``state_dict`` carries flat numpy arrays; compose wrapper layouts with
    ``_prefixed`` + the ``export_*_state_dict`` helpers:
      projector ckpt   export_projector_state_dict(params)
      hypernet/fewshot ckpt  {**_prefixed(export_hypernet_state_dict(h, spec),
                              "hypernet."),
                              **_prefixed(export_projector_state_dict(p),
                              "projector.")}   (HyperNetWrapper layout)
      lora ckpt        {**_prefixed(export_lora_state_dict(adapters),
                              "lora_adapters."),
                              **_prefixed(export_projector_state_dict(p),
                              "projector.")}   (LoraWrapper layout)
    """
    torch.save(
        {
            "step_idx": int(step_idx),
            f"{save_type}_state_dict": {
                k: torch.from_numpy(np.array(v))
                for k, v in state_dict.items()
            },
            "optimizer_state_dict": None,
            metric_name: metric,
        },
        path,
    )


# ---------------------------------------------------------------------------
# AdamW optimizer-moment interop
# ---------------------------------------------------------------------------

# the only non-parameter state_dict entry across the three model layouts
_BUFFER_KEYS = ("pos_encs.pe",)


def adamw_moments_to_pytrees(
    sd: Dict[str, np.ndarray],
    moments: Dict[int, dict],
    convert,
) -> dict:
    """Torch AdamW per-index moments -> (mu, nu) trees in the port's layout.

    ``sd`` is the model state dict the optimizer was built over (its key
    order equals ``parameters()`` order: both come from the same module
    traversal; buffers excluded).  ``moments`` is
    ``load_torch_checkpoint(...)["optimizer_state"]``:
    ``{param_idx: {step, exp_avg, exp_avg_sq}}``.  ``convert`` is the
    matching ``*_from_state_dict`` converter, reused so that the moments get
    the exact layout transforms (transposes) their parameters get.

    Returns ``{"mu": tree, "nu": tree, "count": int}``, dmi_tpu's optax
    form; training.optim.set_adamw_moments installs it into a
    torch.optim.AdamW.  torch's ``step`` and optax's ``count`` both hold
    the number of applied updates.
    """
    names = [k for k in sd if k not in _BUFFER_KEYS]
    if len(moments) > len(names):
        raise ValueError(
            f"optimizer has {len(moments)} param slots but the state dict "
            f"has only {len(names)} parameters: {names}"
        )
    # torch AdamW creates state slots LAZILY: params whose grad stayed None
    # have no entry.  Genuine reference stage-2 checkpoints hit this:
    # lora_forward's zip truncation (dmi/model/projector.py:124) never
    # consumes generator head 1's outputs, so its params have no moments.
    # A missing slot means "never updated": mu = nu = 0, exactly the init
    # state.  Indices still map positionally onto parameters() order.
    mu_sd = {
        n: (np.asarray(moments[i]["exp_avg"]) if i in moments
            else np.zeros_like(sd[n], dtype=np.float32))
        for i, n in enumerate(names)
    }
    nu_sd = {
        n: (np.asarray(moments[i]["exp_avg_sq"]) if i in moments
            else np.zeros_like(sd[n], dtype=np.float32))
        for i, n in enumerate(names)
    }
    steps = {m["step"] for m in moments.values()}
    if len(steps) != 1:
        raise ValueError(f"per-param torch steps differ: {sorted(steps)}")
    return {
        "mu": convert(mu_sd),
        "nu": convert(nu_sd),
        "count": int(steps.pop()),
    }


def export_adamw_state(
    names,
    mu_sd: Dict[str, np.ndarray],
    nu_sd: Dict[str, np.ndarray],
    step: int,
    *,
    lr: float,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> dict:
    """(mu, nu) state dicts (built with the ``export_*_state_dict``
    helpers) -> a ``torch.optim.AdamW.load_state_dict``-compatible dict.
    ``names`` fixes the param indexing: pass the target module's
    state-dict key order (== its ``parameters()`` order), e.g.
    ``[k for k in ref_module.state_dict() if k not in _BUFFER_KEYS]``."""
    missing = [n for n in names if n not in mu_sd or n not in nu_sd]
    if missing:
        raise KeyError(f"moment state dicts missing params: {missing}")
    state = {
        i: {
            "step": torch.tensor(float(step)),
            "exp_avg": torch.from_numpy(np.array(mu_sd[n])),
            "exp_avg_sq": torch.from_numpy(np.array(nu_sd[n])),
        }
        for i, n in enumerate(names)
    }
    param_groups = [{
        "lr": lr,
        "betas": tuple(betas),
        "eps": eps,
        "weight_decay": weight_decay,
        "amsgrad": False,
        "maximize": False,
        "foreach": None,
        "capturable": False,
        "differentiable": False,
        "fused": None,
        "params": list(range(len(names))),
    }]
    return {"state": state, "param_groups": param_groups}


def optax_moments_from_checkpoint(
    path: str, save_type: str, arch: str = "auto"
) -> Optional[dict]:
    """If ``path`` is a reference torch checkpoint whose envelope carries
    AdamW optimizer state, convert the moments of the TRAINED param set
    into the port's layout: ``{"mu", "nu", "count"}`` for
    training.optim.set_adamw_moments, else None.

    The reference optimizers cover (dmi/train_projector.py:235-236,
    train_hypernet.py:220-221,526, train_lora.py): projector ->
    Projector.parameters(); hypernet -> HyperNetwork.parameters() (the
    wrapper's frozen projector is excluded); lora_model ->
    LoraAdapters.parameters().
    """
    if not zipfile.is_zipfile(path):
        return None
    ckpt = load_torch_file(path)
    opt = ckpt.get("optimizer_state_dict")
    if not isinstance(opt, dict) or not opt.get("state"):
        return None
    sd_key = f"{save_type}_state_dict"
    if sd_key not in ckpt:
        return None
    sd = _numpy_state_dict(ckpt[sd_key])

    if save_type in ("projector", "ft_projector"):
        names_sd, convert = sd, projector_from_state_dict
    elif save_type in ("hypernet", "fewshot"):
        names_sd = _split_prefix(sd, "hypernet.") or sd
        names_sd = {k: v for k, v in names_sd.items() if k not in _BUFFER_KEYS}
        convert = lambda s: hypernet_from_state_dict(s, arch=arch)  # noqa: E731
    elif save_type in ("lora_model", "lora"):
        names_sd = {
            k: v for k, v in sd.items()
            if ".loras." in k or k.startswith("loras.")
        }
        convert = lora_from_state_dict
    else:
        raise ValueError(f"unknown save_type {save_type!r}")

    moments = {
        int(i): {
            "step": int(_to_numpy(s["step"]).item()),
            "exp_avg": _to_numpy(s["exp_avg"]),
            "exp_avg_sq": _to_numpy(s["exp_avg_sq"]),
        }
        for i, s in opt["state"].items()
    }
    return adamw_moments_to_pytrees(names_sd, moments, convert)
