"""Pytree checkpoints in dmi_tpu's envelope (counterpart of
dmi_tpu/training/checkpoint.py: save_pytree, load_pytree, BestCheckpointer).

dmi_tpu writes a pickle of {step_idx, <type>_state_dict, optimizer_state_dict,
<metric>} with numpy arrays as leaves; the port writes the same envelope
(tensors become numpy arrays), so each package reads the other's projector
checkpoints.  The optimizer states differ: dmi_tpu's holds optax named
tuples, whose classes live in a JAX package, and the port's holds its AdamW
moments and step counts as numpy arrays (ADAMW_FORMAT).  The port never
imports JAX, so its unpickler builds numpy and builtin objects only and
turns every other class into a `ForeignObject` that keeps its arguments;
optim.load_adamw_state reads the AdamW moments out of them.

`load_pytree` also reads the reference's torch `.pt` files (torch.save's zip,
or a legacy torch pickle that the restricted unpickler refuses) into the
same envelope, through models.torch_import, as dmi_tpu's load_pytree does:
their optimizer_state_dict is None there, and the resume paths read the
torch AdamW moments on their own (torch_import.optax_moments_from_checkpoint,
optim.set_adamw_moments).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import zipfile
from glob import glob
from typing import Any, Dict, Optional

import numpy as np
import torch

# optimizer_state_dict["format"] of the port's AdamW state
ADAMW_FORMAT = "dmi_tpu_torch.adamw"

# the first pickle of a file that torch.save wrote in its legacy format
_TORCH_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C

_ALLOWED_MODULES = ("builtins", "collections", "copyreg", "numpy", "_codecs")


class ForeignObject:
    """Stand-in for an object of a class outside numpy and the builtins;
    `cls_name` names the class, `args`/`kwargs`/`state` hold what the
    pickle passed to it."""

    cls_name = "?"

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"ForeignObject({self.cls_name})"


class _EnvelopeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _ALLOWED_MODULES:
            return super().find_class(module, name)
        return type(name, (ForeignObject,), {"cls_name": f"{module}.{name}"})


def load_pytree(path: str) -> Dict[str, Any]:
    """Load a checkpoint that dmi_tpu.training.checkpoint.save_pytree (or
    this module's save_pytree) wrote, or a reference torch `.pt` file."""
    if zipfile.is_zipfile(path):
        return _load_torch_envelope(path)
    with open(path, "rb") as f:
        try:
            obj = _EnvelopeUnpickler(f).load()
        except pickle.UnpicklingError:
            return _load_torch_envelope(path)
    if isinstance(obj, dict):
        return obj
    if isinstance(obj, int) and obj == _TORCH_LEGACY_MAGIC:
        # torch.save's legacy (pre-zip) format: a pickled magic number, then
        # the checkpoint in pickles of its own
        return _load_torch_envelope(path)
    raise ValueError(f"{path}: a pickle of {type(obj).__name__}, not a checkpoint envelope")


def _load_torch_envelope(path: str) -> Dict[str, Any]:
    """A reference torch checkpoint as the envelope save_pytree writes, its
    state dicts converted to parameter trees (dmi_tpu's
    checkpoint._load_torch_envelope)."""
    from dmi_tpu_torch.models import torch_import as ti

    out = ti.load_torch_checkpoint(path)
    env: Dict[str, Any] = {
        "step_idx": out.get("step_idx", 0),
        "optimizer_state_dict": None,
    }
    if "metric" in out:
        env["metric"] = out["metric"]
    if "projector" in out:
        env["projector_state_dict"] = out["projector"]
    if "hypernet" in out:
        env["hypernet_state_dict"] = out["hypernet"]
    if "lora_adapters" in out:
        env["lora_model_state_dict"] = out["lora_adapters"]
    return env


def to_numpy(tree):
    """Tensors -> numpy arrays (on the host) through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def to_tensor(value, device) -> torch.Tensor:
    """A checkpoint or parameter leaf (numpy array or tensor) as a detached
    tensor on `device`; a numpy array is copied."""
    if torch.is_tensor(value):
        return value.detach().to(device)
    return torch.as_tensor(np.array(value), device=device)


def save_pytree(path: str, obj: Dict[str, Any]) -> None:
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(to_numpy(obj), f)


class BestCheckpointer:
    """One rolling "best" checkpoint per (model name, save type), replaced
    only when the tracked metric improves (reference semantics,
    dmi/train.py:215-254); step checkpoints are cleaned up."""

    def __init__(self, ckpt_dir: str, model_name: str, save_type: str, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.model_name = model_name
        self.save_type = save_type
        self.mode = mode

    @property
    def best_path(self) -> str:
        return osp.join(
            self.ckpt_dir, f"{self.model_name}-checkpoint-{self.save_type}-best.pt"
        )

    def clear_step_checkpoints(self) -> None:
        for f in glob(
            osp.join(self.ckpt_dir, f"{self.model_name}-checkpoint-{self.save_type}-step*.pt")
        ):
            os.remove(f)

    def save(self, step_idx: int, metric: float, metric_name: str, state_dict,
             optimizer_state=None) -> bool:
        """Save if metric improves; returns True when the best was replaced.
        An old checkpoint without this metric name is replaced."""
        old = None
        if osp.exists(self.best_path):
            old = load_pytree(self.best_path).get(metric_name)
        self.clear_step_checkpoints()
        improved = (
            old is None
            or (self.mode == "max" and metric > old)
            or (self.mode == "min" and metric < old)
        )
        if improved:
            save_pytree(self.best_path, {
                "step_idx": step_idx,
                f"{self.save_type}_state_dict": state_dict,
                "optimizer_state_dict": optimizer_state,
                metric_name: metric,
            })
        return improved

    def load_best(self) -> Optional[Dict[str, Any]]:
        if not osp.exists(self.best_path):
            return None
        return load_pytree(self.best_path)
