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

`save_pytree_dcp` / `load_pytree_dcp` are the counterparts of dmi_tpu's
orbax backend (save_pytree_orbax / load_pytree_orbax, sharded_like) over
torch.distributed.checkpoint: on a mesh every rank writes and reads only
its own shards.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import pickle
import zipfile
from glob import glob
from typing import Any, Dict, Optional

import numpy as np
import torch

from dmi_tpu_torch.parallel.collectives import Shard

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


# ---------------------------------------------------------------------------
# Sharded checkpoints over torch.distributed.checkpoint
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A tensor leaf's shape, dtype and device, without its buffer: a
    restore target's leaf (sharded_like), allocated by load_pytree_dcp
    just before it is read."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _flatten(tree, prefix: str, out: dict) -> None:
    """{path: leaf} of a tree of dicts, lists and tuples; the tensors of a
    sharded tree (a dict holding a Shard under "shard") are keyed by their
    model rank, so each model rank's shards are its own entries and the
    data replicas of one model rank write them once.  The Shard itself is
    not written: the restore target carries it."""
    if isinstance(tree, dict):
        shard = tree.get("shard")
        if isinstance(shard, Shard):
            prefix = f"{prefix}model{shard.r}of{shard.m}/"
        for k, v in tree.items():
            if k == "shard" and isinstance(v, Shard):
                continue
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = tree


def _rebuild(tree, prefix: str, flat: dict):
    """tree with every leaf replaced by flat's value at its path."""
    if isinstance(tree, dict):
        shard = tree.get("shard")
        if isinstance(shard, Shard):
            prefix = f"{prefix}model{shard.r}of{shard.m}/"
        return {k: v if k == "shard" and isinstance(v, Shard)
                else _rebuild(v, f"{prefix}{k}/", flat) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, f"{prefix}{i}/", flat) for i, v in enumerate(tree))
    return flat[prefix[:-1]]


def save_pytree_dcp(path: str, obj: Dict[str, Any]) -> None:
    """Write a tree with torch.distributed.checkpoint (dmi_tpu's
    save_pytree_orbax).  Under a process group every rank calls it: the
    replicated leaves are written once, and each rank writes its own
    shards of a sharded LLM tree (parallel.shard_llm_params).  Leaves that
    are not tensors (ints, floats, None) are pickled beside them."""
    import torch.distributed.checkpoint as dcp

    flat: dict = {}
    _flatten(obj, "", flat)
    dcp.save(flat, checkpoint_id=osp.abspath(path))


def load_pytree_dcp(path: str, like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Read a tree that save_pytree_dcp wrote (dmi_tpu's load_pytree_orbax).
    like: the restore target, a tree of the same structure whose tensor
    leaves are READ INTO IN PLACE and whose LeafSpec leaves (sharded_like)
    are allocated here; a sharded tree's Shard places it, so each rank
    reads only its own shards.  Without like (one process), every entry is
    read whole into a nested dict (lists come back as dicts keyed "0",
    "1", ...)."""
    import torch.distributed.checkpoint as dcp

    path = osp.abspath(path)
    if like is None:
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        flat = {}
        for key, m in meta.items():
            if hasattr(m, "size"):
                flat[key] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
            else:
                flat[key] = None
        dcp.load(flat, checkpoint_id=path)
        out: dict = {}
        for key, value in flat.items():
            node, parts = out, key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        return out
    flat = {}
    _flatten(like, "", flat)
    for key, leaf in flat.items():
        if isinstance(leaf, LeafSpec):
            flat[key] = torch.empty(leaf.shape, dtype=leaf.dtype, device=leaf.device)
    dcp.load(flat, checkpoint_id=path)
    return _rebuild(like, "", flat)


def sharded_like(tree):
    """A restore target for load_pytree_dcp: `tree` with each tensor leaf
    replaced by its LeafSpec (shape, dtype, device) and everything else,
    its Shards included, kept; it holds none of tree's buffers, so a
    restore never keeps two copies of large sharded state."""
    if isinstance(tree, dict):
        return {k: sharded_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sharded_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return LeafSpec(tuple(tree.shape), tree.dtype, tree.device)
    return tree


class BestCheckpointer:
    """One rolling "best" checkpoint per (model name, save type), replaced
    only when the tracked metric improves (reference semantics,
    dmi/train.py:215-254); step checkpoints are cleaned up.  Under a
    process group global rank 0 alone reads and writes the file and sends
    its decision to every rank (all ranks call save)."""

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
        from dmi_tpu_torch.parallel.distributed import on_rank0

        return on_rank0(lambda: self._save(step_idx, metric, metric_name, state_dict,
                                           optimizer_state))

    def _save(self, step_idx, metric, metric_name, state_dict, optimizer_state) -> bool:
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
