"""Load dmi_tpu pytree checkpoints (counterpart of
dmi_tpu/training/checkpoint.py:load_pytree, read side only).

dmi_tpu writes a pickle of {step_idx, <type>_state_dict, optimizer_state_dict,
<metric>} with numpy arrays as leaves.  Its optimizer state holds optax
named tuples, whose classes live in a JAX package; the port never imports
JAX, so the unpickler here builds numpy and builtin objects only and turns
every other class into an opaque `ForeignObject` that keeps its arguments.
Serving reads only the projector arrays.  The reference's torch `.pt` (zip)
envelope comes with the training path.
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Any, Dict

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
    """Load a checkpoint that dmi_tpu.training.checkpoint.save_pytree wrote."""
    if zipfile.is_zipfile(path):
        raise NotImplementedError(
            f"{path} is a torch .pt (zip) checkpoint: the reference envelope "
            "comes with the training path (ROADMAP.md A.2)"
        )
    with open(path, "rb") as f:
        return _EnvelopeUnpickler(f).load()
