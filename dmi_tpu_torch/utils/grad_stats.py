"""On-device gradient summaries, the wandb.watch(log='gradients') analogue
(counterpart of dmi_tpu/utils/grad_stats.py).

Computed on the device from the fully accumulated gradient the optimizer
consumes, fetched to the host only at the trainer's logging cadence:

  * global l2 norm
  * per-parameter l2 norms, named by their path in the parameter tree
    ("layers.0.w"), leaves in dmi_tpu's (jax tree) order
  * a log10-|g| histogram over fixed decade buckets
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

# decade edges 1e-12 .. 1e2 (+ underflow/overflow buckets)
HIST_EDGES = [10.0**e for e in range(-12, 3)]


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, dict keys sorted as jax flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_map(fn, tree):
    """fn applied to every leaf of a tree of dicts, lists and tuples (lists
    and tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def grad_summary(grads, prefix: str = "grad") -> Dict[str, torch.Tensor]:
    """A flat dict of device scalars plus one histogram-count vector under
    '<prefix>_hist' (len(HIST_EDGES) + 1 buckets)."""
    out: Dict[str, torch.Tensor] = {}
    total_sq = None
    all_abs = []
    for name, leaf in named_leaves(grads):
        lf = leaf.float()
        sq = (lf * lf).sum()
        total_sq = sq if total_sq is None else total_sq + sq
        out[f"{prefix}_norm/{name}"] = sq.sqrt()
        all_abs.append(lf.abs().ravel())
    if total_sq is None:
        raise ValueError("grad_summary: no gradients")
    out[f"{prefix}_global_norm"] = total_sq.sqrt()
    flat = torch.cat(all_abs)
    edges = torch.tensor(HIST_EDGES, dtype=torch.float32, device=flat.device)
    idx = torch.searchsorted(edges, flat)  # 0 = underflow, len(edges) = overflow
    out[f"{prefix}_hist"] = torch.bincount(idx, minlength=len(HIST_EDGES) + 1)
    return out


def host_grad_summary(dev_stats: Dict[str, torch.Tensor]) -> Dict:
    """The device dict on the host, the histogram as a plain list."""
    return {k: (v.tolist() if v.ndim else float(v)) for k, v in dev_stats.items()}
