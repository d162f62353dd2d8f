"""Training on a (data, model) mesh: the pieces the three trainers share
(counterpart of the mesh_shape wiring of dmi_tpu's trainers,
dmi_tpu/training/projector_trainer.py:86-95,187-192 and
hypernet_trainer.py:146-152,318-323,396-400).

One process a rank (parallel/), every rank running the same trainer:

  * the frozen LLM is fused, then sharded over the model axis
    (shard_llm_params); its forward sums the ranks' partial products and
    their gradients through the autograd collectives of
    parallel/collectives.py, and the loss reads vocab-sharded logits;
  * the trainable tree (projector, adapters, hypernet) is replicated:
    rank 0's initial values are broadcast once, every rank takes the same
    AdamW step on the same global gradient;
  * each data rank takes its rows of the global batch (Shard.rows, the
    counterpart of batch_sharding); caption_loss returns the (sum, count)
    of its rows, and the rank backpropagates sum / count-summed-over-data-
    ranks, so that the gradients summed over the data ranks
    (Shard.reduce_grads, before clipping) are the global token mean's,
    exact for uneven label counts;
  * random draws stay replicated: the dropout of a projector in train mode
    is drawn over the global batch's rows and sliced, rotations and the
    hypernet's dropout act on replicated inputs, so a rank's rows get the
    one-rank run's draws;
  * files (checkpoints, results, metric logs) are written by global rank 0
    alone, and only rank 0 computes the caption metrics, over the rows
    gathered from every data rank (parallel.distributed.on_rank0).
"""

from __future__ import annotations

import torch

from dmi_tpu_torch.models.llama import fuse_projections


def mesh_llm(train_args, llm_cfg, llm_params: dict, device) -> tuple:
    """(the frozen LLM tree the trainer computes on, the mesh, its Shard):
    the fused tree, sharded over train_args.mesh_shape when it is set (the
    mesh and Shard are None otherwise)."""
    if not train_args.mesh_shape:
        return fuse_projections(llm_params), None, None
    from dmi_tpu_torch.parallel import make_mesh, shard_llm_params

    mesh = make_mesh(tuple(train_args.mesh_shape), device=device)
    fused = shard_llm_params(mesh, fuse_projections(llm_params), llm_cfg)
    return fused, mesh, fused["shard"]


def local_rows(shard, x, dim: int = 0):
    """This data rank's rows of x along dim (all of x without a mesh)."""
    if shard is None:
        return x
    lo, hi = shard.rows(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def token_mean_part(shard, out) -> torch.Tensor:
    """What this rank backpropagates of caption_loss's output: the loss
    itself without a mesh; on a mesh, its rows' summed NLL over the valid
    labels counted over every data rank (the parts sum to the global token
    mean; 0 when no label is valid)."""
    if shard is None:
        return out
    nll, count = out
    return nll / shard.psum_data(count).clamp(min=1)


def global_value(shard, part: torch.Tensor) -> torch.Tensor:
    """The global value of a loss part (its sum over the data ranks)."""
    return part if shard is None else shard.psum_data(part.detach())


def reduce_grads(shard, opt: torch.optim.Optimizer) -> None:
    """On a mesh, sum the gradients of every parameter of `opt` over the
    data ranks, in place, before they are read and clipped (a parameter
    the loss did not reach gets a zero gradient first, as clip_and_step
    gives it)."""
    if shard is None:
        return
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    shard.reduce_grads([p.grad for p in params])


def broadcast_leaves(shard, leaves) -> None:
    """Rank 0's initial values of the trainable leaves on every rank."""
    if shard is not None:
        shard.broadcast(list(leaves))
