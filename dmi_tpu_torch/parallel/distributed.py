"""Multi-process entry (counterpart of dmi_tpu/parallel/distributed.py).

dmi_tpu initialises jax.distributed and lays a (replica, data, model) mesh
over DCN and ICI.  Here each rank is one process of torch.distributed:
torchrun sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK
(and LOCAL_WORLD_SIZE, the ranks of one node), or the caller passes them.
The `replica` axis follows node boundaries, as dmi_tpu's follows slices or
processes: collectives on the `model` axis stay inside a node (NVLink), and
only data-parallel traffic crosses nodes.

Unlike dmi_tpu (distributed.py:74-79), a failed initialisation raises: the
port never carries on single-process after asking for more.  The
TPU_WORKER_HOSTNAMES autodetect is TPU plumbing and is not ported.  This is
the one module of the port that reads torchrun's environment.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: `device` when given, else
    cuda:LOCAL_RANK, wrapped to the cards the process sees (on a one-card
    machine every rank takes cuda:0).  Raises when no card is visible: the
    CPU runs only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device='cpu' to build a CPU mesh")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())



def init_distributed(init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Initialise torch.distributed's default process group.

    Returns True when a process group is up (made here, or already), False
    with nothing done when neither arguments nor torchrun's variables ask
    for one.  Explicit arguments override the environment: init_method (a
    "file://" store for tests, or "tcp://host:port"), rank and world_size.
    backend defaults to nccl where a card is visible and gloo on the CPU;
    several ranks on one card pass "gloo" (NCCL refuses two ranks on one
    device)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and not all(k in env for k in _TORCHRUN):
        return False
    if init_method is None:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    rank = int(env["RANK"]) if rank is None else int(rank)
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return True


def launch_device(device="cuda") -> torch.device:
    """An entry point's device, after init_distributed() (dmi_tpu's CLIs
    call it first): the device as asked for a single process (no launcher
    variables); under torchrun, gloo on the CPU and this rank's card
    (rank_device) with NCCL otherwise."""
    dev = torch.device(device)
    if not init_distributed(backend="gloo" if dev.type == "cpu" else None):
        return dev
    return dev if dev.type == "cpu" else rank_device()


def on_rank0(fn, share: bool = True):
    """fn() on the process that writes a run's shared files -- a single
    process, or global rank 0 of a process group -- and None on the other
    ranks.  share: rank 0's result goes to every rank, and no rank returns
    before rank 0's fn() has, so the others may read what it wrote (a
    collective: every rank calls it at the same point); share=False for
    state only rank 0 keeps, such as its metric logger."""
    if not dist.is_initialized():
        return fn()
    box = [fn() if dist.get_rank() == 0 else None]
    if share:
        dist.broadcast_object_list(box, 0)
    return box[0]


def rank0_first(fn):
    """fn() on global rank 0 first and on the other ranks after it (a
    barrier between): for set-up that writes a shared cache, such as the
    data loaders' columnar files, which the other ranks then read."""
    if not dist.is_initialized():
        return fn()
    if dist.get_rank() == 0:
        out = fn()
        dist.barrier()
        return out
    dist.barrier()
    return fn()


def require_mesh(mesh_shape) -> None:
    """Raise when several ranks run a trainer without a mesh: each would
    train its own copy and write the same files."""
    if dist.is_initialized() and dist.get_world_size() > 1 and not mesh_shape:
        raise ValueError(f"{dist.get_world_size()} ranks need mesh_shape in the config "
                         "(e.g. [world, 1] for data parallelism)")


def make_multihost_mesh(
    ici_shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("replica", "data", "model"),
    device=None,
) -> DeviceMesh:
    """(replica, data, model) mesh with the replica axis over nodes.

    A node's ranks are LOCAL_WORLD_SIZE consecutive global ranks (torchrun's
    layout; the whole world when unset): ici_shape is one node's (data,
    model) layout, by default (local world, 1), and the leading replica
    axis spans the nodes.  One node degenerates to (1, *ici_shape), so every
    spec works unchanged in both worlds."""
    if not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh needs a process group: call "
                           "init_distributed() first")
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the world of {world}")
    ici = (local, 1) if ici_shape is None else tuple(int(s) for s in ici_shape)
    if math.prod(ici) != local:
        raise ValueError(f"ici_shape {ici} needs {math.prod(ici)} ranks a node, a node has "
                         f"{local}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (world // local,) + ici,
                            mesh_dim_names=tuple(axis_names))


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The axes a global batch shards over: every data-parallel axis of the
    mesh (replica across nodes, data within one)."""
    return tuple(a for a in ("replica", "data") if a in mesh.mesh_dim_names)
