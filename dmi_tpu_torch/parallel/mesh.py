"""Device mesh construction (counterpart of dmi_tpu/parallel/mesh.py).

The port follows torch's SPMD idiom: one process a rank.  Each process
calls distributed.init_distributed(), then make_mesh() with the same shape;
every rank holds its shard of the weights (sharding.py) and calls the
collectives itself (collectives.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dmi_tpu_torch.parallel.distributed import rank_device


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("data", "model"),
    device=None,
) -> DeviceMesh:
    """A (data, model) DeviceMesh over the world's ranks.

    shape defaults to (world, 1), pure data parallelism; (d, m) puts m ranks
    in each tensor-parallel group and d groups side by side.  The ranks must
    fill the mesh exactly (dmi_tpu raises when the shape needs more devices
    than it has; here each rank is one process, so fewer is refused too).
    device: this rank's device (rank_device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "dmi_tpu_torch.parallel.init_distributed() first")
    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks, the world has "
                         f"{world}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names[: len(shape)]))
