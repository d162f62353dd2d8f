"""A dry run of sharded training and decoding (counterpart of
__graft_entry__.py's dryrun_multichip).

    python -m dmi_tpu_torch.training.dryrun --world N [--device cpu]

Spawns N processes joined through a file:// store in a temporary
directory, lays a (data, model) mesh over them -- (N // 2, 2) when N is
even and above 1, else (N, 1) -- and on a tiny llama (vocab 256, 2 layers,
4/2 heads, f32) runs, on every rank:

  * one projector dp x tp training step with AdamW: the LLM sharded over
    the model axis, the projector replicated, each data rank on its rows,
    the gradient summed over the data ranks before the clip;
  * one stage-2 hypernet step: the conditioning subset rotated by a
    Haar-orthogonal matrix, the hypernet's LoRA emission, the adapted
    projector's layer 0 (lora0) and the frozen LLM's loss, AdamW over the
    hypernet;
  * a greedy decode of 4 tokens on the same mesh, its rows gathered.

On the card (the default) the ranks join over NCCL, one card each, where
the machine has N cards, and otherwise over gloo, all on cuda:0; it raises
when no card is visible.  --device cpu runs the ranks over gloo on the CPU
(dryrun_multichip's CPU devices).  Rank 0 prints each loss; the ranks must
agree on every loss and token.  The exit code is non-zero when a rank
fails.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import types

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TINY = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv=2)
MM_DIM, T, BUDGET, PAD = 32, 16, 4, 0
OPT_ARGS = types.SimpleNamespace(learning_rate=1e-3, adam_beta1=0.9, adam_beta2=0.999,
                                 adam_epsilon=1e-8, weight_decay=1e-4)


def mesh_shape(world: int) -> tuple:
    """dryrun_multichip's layout: model groups of 2 where the world allows."""
    return (world // 2, 2) if world % 2 == 0 and world > 1 else (world, 1)


def rank_setup(rank: int, world: int, device: str) -> tuple:
    """(backend, this rank's device): gloo on the CPU; on the card NCCL with
    cuda:rank where there are `world` cards, else gloo with every rank on
    cuda:0 (NCCL refuses two ranks on one card)."""
    if torch.device(device).type == "cpu":
        return "gloo", torch.device("cpu")
    if torch.cuda.device_count() >= world:
        return "nccl", torch.device("cuda", rank)
    return "gloo", torch.device("cuda", 0)


def _batch(n_data: int, vocab: int, gen: torch.Generator, dev) -> dict:
    B = 2 * n_data  # rows divisible by the data axis
    batch = {"embs": torch.randn(B, MM_DIM, generator=gen),
             "input_ids": torch.randint(1, vocab, (B, T), generator=gen),
             "attention_mask": torch.ones(B, T, dtype=torch.long),
             "labels": torch.randint(1, vocab, (B, T), generator=gen)}
    return {k: v.to(dev) for k, v in batch.items()}


def _step(shard, leaves, out) -> float:
    """Backpropagate this data rank's part of the (sum, count) loss, sum the
    gradients over the data ranks and take one AdamW step; returns the
    global loss."""
    from dmi_tpu_torch.training import mesh as tm
    from dmi_tpu_torch.training.optim import clip_and_step, make_optimizer, set_lr

    part = tm.token_mean_part(shard, out)
    part.backward()
    opt = make_optimizer(OPT_ARGS, leaves)
    set_lr(opt, OPT_ARGS.learning_rate)
    tm.reduce_grads(shard, opt)
    clip_and_step(opt, 1.0)
    loss = float(shard.psum_data(part.detach()))
    if not math.isfinite(loss):
        raise AssertionError(f"loss {loss} is not finite")
    return loss


def run_rank(rank: int, world: int, store: str, device: str = "cuda") -> dict:
    """One rank's dry run on `device` (rank_setup); returns its losses and
    gathered tokens."""
    from dmi_tpu_torch import parallel
    from dmi_tpu_torch.models import hypernet as hn
    from dmi_tpu_torch.models import llama, mmmodel
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops.linalg import random_orthogonal
    from dmi_tpu_torch.training.hypernet_trainer import process_embeddings
    from dmi_tpu_torch.utils.grad_stats import named_leaves, tree_map
    from dmi_tpu_torch.utils.rng import CounterRNG

    torch.set_num_threads(1)
    backend, dev = rank_setup(rank, world, device)
    parallel.init_distributed(init_method=f"file://{store}", rank=rank, world_size=world,
                              backend=backend)
    shape = mesh_shape(world)
    mesh = parallel.make_mesh(shape, device=dev)
    cfg = llama.tiny_config(**TINY)
    llm = parallel.shard_llm_params(
        mesh, llama.fuse_projections(llama.init(cfg, CounterRNG(0, device=dev), dev)), cfg)
    shard = llm["shard"]
    pspec = proj.ProjectorSpec(mm_dim=MM_DIM, lm_dim=cfg.hidden_size, n_layers=2)
    pparams = proj.init(pspec, CounterRNG(1, device=dev), device=dev)
    batch = _batch(shard.n_data, cfg.vocab_size, torch.Generator().manual_seed(0), dev)
    lo, hi = shard.rows(batch["embs"].shape[0])
    ids, mask, labels = (batch[k][lo:hi] for k in ("input_ids", "attention_mask", "labels"))
    out = {"shape": shape, "backend": backend}

    # projector dp x tp step
    trained = tree_map(lambda t: t.clone().requires_grad_(), pparams)
    leaves = [t for _, t in named_leaves(trained)]
    shard.broadcast(leaves)
    soft = proj.apply(pspec, trained, batch["embs"])[lo:hi]
    out["projector_loss"] = _step(shard, leaves, mmmodel.caption_loss(
        cfg, llm, soft, ids, mask, labels))

    # stage-2 hypernet step: rotation + conditioning + LoRA emission
    hspec = hn.HypnetSpec(lm_dim=cfg.hidden_size, mm_dim=MM_DIM, n_tokens=4, arch="attention",
                          n_heads=1, hypnet_dim=MM_DIM, rank=4, alpha=4, predict_bias=True,
                          n_proj_layers=2, use_pos_encs=True)
    hn_tree = tree_map(lambda t: t.clone().requires_grad_(),
                       hn.init(hspec, CounterRNG(2, device=dev), device=dev))
    hleaves = [t for _, t in named_leaves(hn_tree)]
    shard.broadcast(hleaves)
    gen = torch.Generator().manual_seed(3)
    subset = tuple(torch.randn(n, MM_DIM, generator=gen).to(dev) for n in (4, 4, 1))
    mm, z = process_embeddings(batch["embs"][lo:hi], subset, feed_txt_embs=True,
                               rotation=random_orthogonal(MM_DIM, CounterRNG(4, device=dev)),
                               pad_to=None)
    a, b, d = hn.apply(hspec, hn_tree, z)
    soft = proj.lora_apply(pspec, pparams, mm, a, b, d)
    out["hypernet_loss"] = _step(shard, hleaves, mmmodel.caption_loss(
        cfg, llm, soft, ids, mask, labels))

    # sharded greedy decode
    with torch.no_grad():
        soft = proj.apply(pspec, pparams, batch["embs"][lo:hi])
        toks = shard.gather_rows(mmmodel.caption_generate(cfg, llm, soft, ids[:, :8], BUDGET,
                                                          PAD))
    if tuple(toks.shape) != (batch["embs"].shape[0], BUDGET):
        raise AssertionError(f"decoded tokens {tuple(toks.shape)}")
    out["tokens"] = toks.tolist()

    every = [None] * world
    dist.all_gather_object(every, out)
    if any(o != out for o in every):
        raise AssertionError(f"the ranks disagree: {every}")
    dist.barrier()
    dist.destroy_process_group()
    return out


def _worker(rank: int, world: int, store: str, device: str) -> None:
    out = run_rank(rank, world, store, device)
    if rank == 0:
        print(f"dryrun OK: mesh {out['shape']} (data, model) over {world} {out['backend']} "
              f"ranks on {device}; "
              f"projector dp x tp train step, loss={out['projector_loss']:.4f}")
        print(f"dryrun OK: hypernet dp x tp train step (rotation + conditioning + LoRA "
              f"emission), loss={out['hypernet_loss']:.4f}")
        print(f"dryrun OK: tp-sharded greedy decode, tokens shape "
              f"({len(out['tokens'])}, {BUDGET})", flush=True)


def main(argv=None) -> int:
    from dmi_tpu_torch.training.model_utils import require_device

    ap = argparse.ArgumentParser(prog="python -m dmi_tpu_torch.training.dryrun")
    ap.add_argument("--world", type=int, default=2, help="number of ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = str(require_device(args.device))
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(_worker, args=(args.world, f"{tmp}/store", device), nprocs=args.world)
        except mp.ProcessRaisedException as e:
            print(f"dryrun FAILED: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
