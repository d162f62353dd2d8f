"""The collectives of tensor- and data-parallel serving, written out.

dmi_tpu writes no collective: shard_llm_params places the weights and GSPMD
inserts the psums and gathers (dmi_tpu/parallel/sharding.py:1-18).  The
port has no GSPMD, so each rank holds its shard of the tree
(sharding.shard_llm_params, which puts a `Shard` under the tree's "shard"
key) and the model code calls the Shard's collectives at the points XLA
would insert them:

  * psum over the model group after every row-parallel product (wo, w_down,
    the routed MLP's local experts, the shared experts' down), in the dtype
    the caller hands over (the int8 matmuls hand f32 partials);
  * pmax of a row-parallel input's per-token amax before quantize_act
    rounds it, so that the int8 activations and their scales are the
    one-rank ones;
  * the vocab-sharded embedding lookup: this rank's rows, zeros for the
    ids it does not hold, then a psum (exact: one non-zero term);
  * the all-gather of vocab-sharded logits, for the sampler and the logits
    path's argmax, in global vocab order;
  * the merge of per-shard (score, index) pairs of the fused head + argmax
    by the kernel's own rule (csrc/head_argmax.cu `beats`): the higher
    score, then the smaller global index;
  * the all-gather of rows over the data ranks, in row order.

Training differentiates three of them, each an autograd Function used when
grad is enabled and its input requires grad (the forward-only path stays
the raw collective):

  * `copy` (copy into the model group): the identity forward, a psum of the
    gradient backward, where a replicated activation enters sharded
    computation (the normed h before w_qkv, w_gu and the experts, the
    expert gate weights, MLA's latents and shared roped key, the final
    norm's output before the vocab-sharded head);
  * `psum` (reduce from the model group): a psum forward, the identity
    backward, after wo, w_down and the routed MLP, whose sum replicated
    computation consumes;
  * `psum_shared`: a psum both ways, for a sum that sharded computation
    consumes (olmo2's whole-width q/k norms: every rank's gradient of the
    shared variance is partial).

The vocab-parallel loss (`vocab_parallel_nll`) reads this rank's vocab
shard of the logits: pmax and psum of its max and exps and the target's
logit, with the local softmax minus the local one-hot as its backward.
Over the data ranks, `reduce_grads` sums the trainable leaves' gradients
and `psum_data` sums a loss's (sum, count); `broadcast` sends rank 0's
parameters once at set-up.  The gather of vocab-sharded logits and the
argmax merge stay forward only: they serve decoding.

Transport.  The ops run on the process group's backend, fixed when the
mesh is made: NCCL across cards, gloo on the CPU and for several ranks on
one card (NCCL refuses two ranks on one device).  gloo takes CUDA bf16 and
f32 tensors for all_reduce, all_gather and broadcast as they are
(chip_smoke.py's parallel phase checks it on the card), so no op is staged
through host memory here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """x reduced in place over `group` (x must be contiguous); returns x."""
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's x, in the group's rank order (equal shapes)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


class _Copy(torch.autograd.Function):
    """Identity forward, psum over `group` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group), None


class _Reduce(torch.autograd.Function):
    """psum over `group` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumShared(torch.autograd.Function):
    """psum over `group` both ways."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group), None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _VocabParallelNLL(torch.autograd.Function):
    """Per-row negative log-likelihood [N] of global targets [N] (-100:
    ignored, 0) from this rank's vocab shard [N, v1 - v0] of the logits
    (f32, or f64 in the tests), in their dtype."""

    @staticmethod
    def forward(ctx, logits, target, shard):
        def red(t, op):
            return t if shard.model_group is None else all_reduce(t, op, shard.model_group)

        top = red(logits.max(dim=-1).values.contiguous(), dist.ReduceOp.MAX)
        exps = (logits - top[:, None]).exp()
        total = red(exps.sum(dim=-1), dist.ReduceOp.SUM)
        mine = (target >= shard.v0) & (target < shard.v1)
        local = torch.where(mine, target - shard.v0, 0)
        picked = logits.gather(1, local[:, None])[:, 0] - top
        picked = red(torch.where(mine, picked, 0.0), dist.ReduceOp.SUM)
        valid = target != -100
        ctx.save_for_backward(exps, total, local, mine, valid)
        return torch.where(valid, total.log() - picked, 0.0)

    @staticmethod
    def backward(ctx, g):
        exps, total, local, mine, valid = ctx.saved_tensors
        grad = exps / total[:, None]
        grad.scatter_add_(1, local[:, None], -mine.to(grad.dtype)[:, None])
        return grad * torch.where(valid, g, 0.0)[:, None], None, None


def merge_argmax(scores: list, ids: list) -> torch.Tensor:
    """The best of per-shard pairs: scores and global ids, one [B] tensor a
    shard.  The higher score wins, and among equal scores the smaller
    global index, as the unsharded argmax's first occurrence -> [B] int64."""
    s = torch.stack([t.float() for t in scores])
    i = torch.stack([t.long() for t in ids])
    best = s.max(dim=0).values
    return torch.where(s == best, i, torch.iinfo(torch.long).max).amin(dim=0)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place in a (data, model) mesh and its slice of one model:
    what the model code needs to compute on a shard and to call the
    collectives.  Made by sharding.shard_llm_params, kept in the tree under
    "shard".

    m, r: model-group size and this rank's index in it (its weight slice);
    heads nh/m, kv heads nkv_l (one kv head, copied kv_rep times, when m >
    nkv); experts [e0, e0 + E/m); vocab rows [v0, v1) of blocks of
    ceil(V / m) (the last one shorter); data: this rank's index among
    n_data data-parallel replicas; data_ranks: the global rank of each
    replica's model rank 0, in data order; data_group: the n_data ranks
    that share this rank's model index (its gradients' all-reduce)."""

    model_group: object  # None: the mesh has no model axis (m == 1)
    m: int
    r: int
    n_data: int
    data: int
    data_ranks: tuple
    nh: int
    nkv: int
    nh_l: int
    nkv_l: int
    kv_rep: int
    experts: int
    e0: int
    e1: int
    vocab: int
    v0: int
    v1: int
    block: int
    data_group: object = None  # the ranks of this model index; None when n_data == 1

    # -- the shard's config ------------------------------------------------

    def local(self, cfg):
        """cfg with this rank's head counts (and a dense MLP's width), the
        config its tree computes under; a config already local is returned
        as it is."""
        if (cfg.num_attention_heads, cfg.num_key_value_heads) == (self.nh_l, self.nkv_l):
            return cfg
        if (cfg.num_attention_heads, cfg.num_key_value_heads) != (self.nh, self.nkv):
            raise ValueError(
                f"config heads {cfg.num_attention_heads}/{cfg.num_key_value_heads} fit neither "
                f"the sharded tree's {self.nh}/{self.nkv} nor its shard's "
                f"{self.nh_l}/{self.nkv_l}")
        inter = cfg.intermediate_size if cfg.num_experts else cfg.intermediate_size // self.m
        return dataclasses.replace(cfg, num_attention_heads=self.nh_l,
                                   num_key_value_heads=self.nkv_l, intermediate_size=inter)

    # -- model-group collectives -------------------------------------------

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every model rank's x (a new contiguous tensor); under
        autograd its backward is the identity (replicated computation
        consumes the sum)."""
        if self.model_group is None:
            return x
        if _tracked(x):
            return _Reduce.apply(x, self.model_group)
        return all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM, self.model_group)

    def psum_shared(self, x: torch.Tensor) -> torch.Tensor:
        """psum whose backward is a psum too: for a sum that each rank's
        sharded computation consumes."""
        if self.model_group is None:
            return x
        if _tracked(x):
            return _PsumShared.apply(x, self.model_group)
        return all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM, self.model_group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x as it is, entering sharded computation: under autograd the
        model ranks' partial gradients of x are summed."""
        if self.model_group is None or not _tracked(x):
            return x
        return _Copy.apply(x, self.model_group)

    def vocab_parallel_nll(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Per-row NLL [N] in f32 of global targets [N] (-100 rows: 0) from
        this rank's vocab shard of the logits [N, v1 - v0], which are never
        gathered."""
        return _VocabParallelNLL.apply(logits.float(), target, self)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every model rank's x."""
        if self.model_group is None:
            return x
        return all_reduce(x.contiguous().clone(), dist.ReduceOp.MAX, self.model_group)

    def gather_vocab(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Vocab-sharded x (this rank's v1 - v0 entries along dim) -> the
        whole vocab along dim, in global order.  Each shard is padded to the
        block for the gather and the padding dropped after."""
        if self.model_group is None:
            return x
        x = x.movedim(dim, 0)
        if x.shape[0] < self.block:
            pad = x.new_zeros((self.block - x.shape[0],) + tuple(x.shape[1:]))
            x = torch.cat([x, pad])
        full = torch.cat(all_gather(x, self.model_group))[: self.vocab]
        return full.movedim(0, dim)

    def embed(self, ids: torch.Tensor, lookup: Callable) -> torch.Tensor:
        """The embedding rows of global ids from the vocab-sharded table:
        lookup(local ids) on this rank's rows, zeros for ids it does not
        hold, summed over the model group."""
        mine = (ids >= self.v0) & (ids < self.v1)
        rows = lookup(torch.where(mine, ids - self.v0, 0))
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
        return self.psum(rows)

    def argmax(self, scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Global ids [B] from this shard's best (score, local id) pairs."""
        if self.model_group is None:
            return ids.long()
        s = all_gather(scores.float(), self.model_group)
        i = all_gather(ids.long() + self.v0, self.model_group)
        return merge_argmax(s, i)

    # -- data ranks ----------------------------------------------------------

    def _data_ranks_group(self):
        if self.data_group is None and self.n_data > 1:
            raise ValueError("the data-rank sums of training need a (data, model) mesh "
                             "(parallel.make_mesh), not a (replica, data, model) one")
        return self.data_group

    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the data ranks of this model index (no
        autograd: losses' sums and counts)."""
        group = self._data_ranks_group()
        if group is None:
            return x
        return all_reduce(x.detach().contiguous().clone(), dist.ReduceOp.SUM, group)

    def reduce_grads(self, grads: list) -> None:
        """Sum every tensor of `grads` over the data ranks, in place (one
        flat all-reduce a dtype and device)."""
        group = self._data_ranks_group()
        if group is None:
            return
        buckets: dict = {}
        for g in grads:
            buckets.setdefault((g.dtype, g.device), []).append(g)
        for bucket in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in bucket])
            all_reduce(flat, dist.ReduceOp.SUM, group)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))

    @staticmethod
    def broadcast(tensors: list) -> None:
        """Global rank 0's values of `tensors` on every rank, in place."""
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, 0)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data replica's rows of x (dim 0; the counts may differ), in
        data order: a collective over all ranks of the mesh."""
        n = torch.tensor([x.shape[0]], dtype=torch.long, device=x.device)
        counts = [int(c) for c in all_gather(n, None)]
        most = max(counts)
        if x.shape[0] < most:
            x = torch.cat([x, x.new_zeros((most - x.shape[0],) + tuple(x.shape[1:]))])
        parts = all_gather(x, None)
        return torch.cat([parts[g][: counts[g]] for g in self.data_ranks])

    def rows(self, n: int) -> tuple:
        """This data replica's contiguous share [start, end) of n rows (the
        first n % n_data replicas take one more)."""
        base, extra = divmod(n, self.n_data)
        start = self.data * base + min(self.data, extra)
        return start, start + base + (self.data < extra)


def model_of(params: dict) -> Optional[Shard]:
    """The Shard of a sharded tree, None for a whole one."""
    return params.get("shard") if isinstance(params, dict) else None


def engine_shard(mesh, *trees) -> Optional[Shard]:
    """The Shard an engine splits its workload by over the data ranks: None
    without a mesh.  A mesh takes trees sharded over it
    (sharding.shard_llm_params), and a sharded tree needs its mesh."""
    shards = [model_of(t) for t in trees if t is not None]
    if mesh is None:
        if any(s is not None for s in shards):
            raise ValueError("a sharded tree needs the mesh it was sharded over (mesh=)")
        return None
    if any(s is None for s in shards):
        raise ValueError("mesh= takes trees sharded over it (parallel.shard_llm_params)")
    return shards[0]
