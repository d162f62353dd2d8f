"""One rank of tests/test_torch_parallel_train.py's gloo worlds.

    python tests/torch_spmd_train_worker.py RANK WORLD STORE INPUTS.pt MANIFEST.json OUT.pt

Every rank of a world runs this script in its own process (the test starts
them with subprocess, never by fork: the test process holds JAX).  It
imports torch and the port only: no jax, nothing of dmi_tpu.  It joins the
world through a file:// store and, for every mesh shape of its world, on
the CPU over gloo:

  * checks each autograd collective alone against the one-rank function
    (copy, psum, psum_shared through the whole-width norm, the
    vocab-parallel NLL, the last also in f64);
  * computes every family's stage-1 loss and projector gradients on the
    sharded tree (this data rank's rows, the gradients summed over the data
    ranks);
  * runs the three trainers with mesh_shape for 4 micro-steps on the
    fixture data in its working directory (the test's inputs name the
    cases: projector, LoRA, stage 2 sequential and coalesced, few-shot);
  * round-trips the sharded tree, the projector and a step count through a
    torch.distributed.checkpoint directory.

Rank 0 writes the results to OUT.pt; every rank checks that its results
equal rank 0's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dmi_tpu_torch import parallel  # noqa: E402
from dmi_tpu_torch.config import FewshotArgs, TrainArgs  # noqa: E402
from dmi_tpu_torch.data.loader import DatasetLoader  # noqa: E402
from dmi_tpu_torch.data.tok_fixture import build_test_tokenizer  # noqa: E402
from dmi_tpu_torch.models import llama, mmmodel  # noqa: E402
from dmi_tpu_torch.models import projector as proj  # noqa: E402
from dmi_tpu_torch.parallel import collectives, sharding  # noqa: E402
from dmi_tpu_torch.registry import dataset_spec  # noqa: E402
from dmi_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from dmi_tpu_torch.training import mesh as tm  # noqa: E402
from dmi_tpu_torch.training.embeddings import EmbeddingManager  # noqa: E402
from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer  # noqa: E402
from dmi_tpu_torch.training.lora_trainer import LoraTrainer  # noqa: E402
from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer  # noqa: E402
from dmi_tpu_torch.utils.grad_stats import named_leaves, tree_map  # noqa: E402

STEPS = 4  # micro-steps of every trainer case


def leaves_of(tree) -> list:
    return [t.detach().clone() for _, t in named_leaves(tree)]


# ---------------------------------------------------------------------------
# The collectives alone
# ---------------------------------------------------------------------------

def unit_checks(mesh, u: dict) -> dict:
    """Each autograd collective against the one-rank function on this
    rank's slice: max abs errors (0 where exact)."""
    cfg = u["cfg"]
    sh = sharding.make_shard(mesh, cfg, u["logits"].shape[1])
    out = {}
    x, w, g = u["x"], u["w"], u["g"]  # [N, K], [K, O], [N, O]
    K, O = w.shape
    # copy: a replicated x into this rank's columns of w
    lo, hi = sh.r * O // sh.m, (sh.r + 1) * O // sh.m
    xr = x.clone().requires_grad_()
    (sh.copy(xr) @ w[:, lo:hi] * g[:, lo:hi]).sum().backward()
    x1 = x.clone().requires_grad_()
    ((x1 @ w) * g).sum().backward()
    out["copy"] = (xr.grad - x1.grad).abs().max()
    # psum: this rank's contraction rows of w, the sum consumed replicated
    klo, khi = sh.r * K // sh.m, (sh.r + 1) * K // sh.m
    xr = x[:, klo:khi].clone().requires_grad_()
    y = sh.psum(xr @ w[klo:khi])
    (y * g).sum().backward()
    out["psum_value"] = (y.detach() - x1.detach() @ w).abs().max()
    out["psum_grad"] = (xr.grad - x1.grad[:, klo:khi]).abs().max()
    # psum_shared: the whole-width norm over this rank's q or k columns (a
    # kv head's copy where the model axis is wider than the kv heads)
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    for name, width, heads, kv in (("q", nh * hd, nh, False), ("k", nkv * hd, nkv, True)):
        xn, scale, gn = u[f"norm_{name}_x"], u[f"norm_{name}_s"], u[f"norm_{name}_g"]
        a, b = sharding._head_cols(width, heads, sh, kv)
        mine = xn[:, a:b].clone().requires_grad_()
        # the kv_rep ranks holding copies of one kv head each count its
        # loss term once, so each term is scaled by 1 / kv_rep and each
        # copy's gradient is 1 / kv_rep of the head's
        share = sh.kv_rep if kv else 1
        (llama.rms_norm(mine, scale[a:b], 1e-6, llama.row_parallel(sh)) * gn[:, a:b]
         ).sum().div(share).backward()
        whole = xn.clone().requires_grad_()
        (llama.rms_norm(whole, scale, 1e-6) * gn).sum().backward()
        out[f"norm_{name}"] = (mine.grad * share - whole.grad[:, a:b]).abs().max()
    # the vocab-parallel NLL against F.cross_entropy
    logits, target, weight = u["logits"], u["target"], u["weight"]
    mine = logits[:, sh.v0:sh.v1].clone().requires_grad_()
    nll = sh.vocab_parallel_nll(mine, target)
    (nll * weight).sum().backward()
    whole = logits.clone().requires_grad_()
    ref = F.cross_entropy(whole, target, ignore_index=-100, reduction="none")
    (ref * weight).sum().backward()
    out["nll_value"] = (nll.detach() - ref.detach()).abs().max()
    out["nll_grad"] = (mine.grad - whole.grad[:, sh.v0:sh.v1]).abs().max()
    # in f64 (the Function keeps the dtype): the backward to 1e-12
    mine = logits[:, sh.v0:sh.v1].double().requires_grad_()
    (collectives._VocabParallelNLL.apply(mine, target, sh) * weight.double()).sum().backward()
    whole = logits.double().requires_grad_()
    (F.cross_entropy(whole, target, ignore_index=-100, reduction="none")
     * weight.double()).sum().backward()
    out["nll_grad_f64"] = (mine.grad - whole.grad[:, sh.v0:sh.v1]).abs().max()
    return {k: float(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Stage-1 loss and projector gradients of every family
# ---------------------------------------------------------------------------

def family_grads(mesh, fam: dict) -> dict:
    """The global stage-1 loss and the projector's gradients (summed over
    the data ranks) on the sharded tree."""
    cfg = fam["cfg"]
    tree = parallel.shard_llm_params(mesh, llama.fuse_projections(fam["llm"]), cfg)
    shard = tree["shard"]
    pp = tree_map(lambda t: t.clone().requires_grad_(), fam["proj"])
    soft = proj.apply(fam["spec"], pp, fam["embs"])
    rows = [tm.local_rows(shard, fam[k]) for k in ("ids", "mask", "labels")]
    part = tm.token_mean_part(shard, mmmodel.caption_loss(
        cfg, tree, tm.local_rows(shard, soft), *rows))
    part.backward()
    grads = [t.grad for _, t in named_leaves(pp)]
    shard.reduce_grads(grads)
    return {"loss": float(tm.global_value(shard, part)), "grads": [g.clone() for g in grads]}


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------

class UnevenLabels:
    """A loader whose training batches keep no label past position 8 in
    their second half of rows, so that the data ranks of a mesh count
    different numbers of valid labels (the fixture's rows all count the
    same: their pads carry labels, as the reference's collator gives them)."""

    def __init__(self, loader):
        self._loader = loader

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def train_batch(self, step):
        batch = dict(self._loader.train_batch(step))
        labels = np.array(batch["labels"])
        labels[labels.shape[0] // 2:, 8:] = -100
        batch["labels"] = labels
        return batch


def _loaders(tok, args, pairs, cls=DatasetLoader, uneven=False):
    loaders = [cls(dataset_spec(ds), tok, args, enc.split("/")[-1], True, "data")
               for ds, enc in pairs]
    if uneven:
        loaders = [UnevenLabels(ld) for ld in loaders]
    return loaders, [EmbeddingManager(enc) for _, enc in pairs]


def make_trainer(case: dict, tok, mesh_shape):
    """The port's trainer of a case, on mesh_shape (None: one rank)."""
    kind = case["kind"]
    args = TrainArgs(**case["args"], mesh_shape=None if mesh_shape is None else
                     list(mesh_shape))
    if kind in ("projector", "lora"):
        loaders, mgrs = _loaders(tok, args, [tuple(case["data"])], uneven=case.get("uneven"))
        kw = dict(name="port", llm_cfg=case["cfg"], llm_params=case["llm"],
                  proj_spec=case["spec"], loaders=loaders, emb_mgrs=mgrs, tokenizer=tok,
                  train_args=args)
        if kind == "projector":
            return ProjectorTrainer(proj_params=case["proj"], **kw)
        return LoraTrainer(lora_spec=case["lora_spec"], lora_params=case["lora"],
                           frozen_proj_params=case["proj"], **kw)
    loaders, mgrs = _loaders(tok, args, [tuple(p) for p in case["data"]],
                             uneven=case.get("uneven"))
    floaders, fmgrs = _loaders(tok, args, [tuple(p) for p in case["fewshot_data"]])
    fargs = FewshotArgs(**case["fewshot_args"])
    tt = HypernetTrainer("port", case["cfg"], case["llm"], case["spec"], case["proj"],
                         case["hn_spec"], case["hn"], loaders, mgrs, floaders, fmgrs, tok,
                         args, fargs)
    if case.get("rotations") is not None:
        rot = case["rotations"]
        tt.rotation = lambda step: rot[step]
    return tt


def run_trainer(case: dict, tok, mesh_shape) -> dict:
    """STEPS micro-steps of a case: per-step losses, the trainable leaves
    after them, and what the case asks for besides (eval loss, captions
    decoded before training, the label counts of this rank's rows)."""
    tt = make_trainer(case, tok, mesh_shape)
    out = {}
    kind = case["kind"]
    if case.get("generate"):
        _, _, preds, _ = tt.generate("eval" if kind == "hypernet" else "test")
        out["preds"] = preds
    if kind in ("projector", "lora"):
        total = tt.total_steps
        labels = tt._device_batch(tt.fetch_batch(0)[1])[2]
        count = (labels != -100).sum()
        counts = [torch.zeros_like(count) for _ in range(dist.get_world_size())] \
            if mesh_shape else [count]
        if mesh_shape:
            dist.all_gather(counts, count)
        out["counts"] = [int(c) for c in counts]
        out["losses"] = [float(tt.train_step(s, total)[0]) for s in range(STEPS)]
        out["params"] = leaves_of(tt.params)
    elif kind == "hypernet":
        total = tt.total_steps
        if tt.coalesce > 1:
            accum = tt.train_args.gradient_accumulation_steps
            out["losses"] = []
            for start in range(0, STEPS, accum):
                window = [(s, *tt.fetch_batch(s)) for s in range(start, start + accum)]
                out["losses"].append(float(tt.run_window(window)))
                tt._update(window[-1][0])
        else:
            out["losses"] = [float(tt.train_step(s, total)[0]) for s in range(STEPS)]
        out["params"] = leaves_of(tt.params)
    else:  # few-shot: over the generated projector, or over the hypernet
        loader, mgr = tt.fewshot_loaders[0], tt.fewshot_emb_mgrs[0]
        tt.fewshot_generate_adapters(0)
        opt = tt.fewshot_optimizer()
        total = loader.total_train_steps()
        out["losses"] = [float(tt.fewshot_train_step(
            s, total, loader.train_batch(s), loader.subset_batch(s, "train"), mgr, opt)[0])
            for s in range(STEPS)]
        trained = tt.generated_projector if tt.generated_projector is not None else tt.params
        out["params"] = leaves_of(trained)
    if case.get("evaluate"):
        out["eval"] = tt.evaluate()
    return out


# ---------------------------------------------------------------------------
# A sharded checkpoint
# ---------------------------------------------------------------------------

def dcp_roundtrip(mesh, fam: dict, path: str) -> dict:
    """Save the sharded tree, a projector and a step count with
    save_pytree_dcp, read them back into sharded_like's target: whether
    every leaf is bit-equal, and the model ranks whose shards the checkpoint
    holds."""
    import torch.distributed.checkpoint as dcp

    tree = {"llm": parallel.shard_llm_params(mesh, llama.fuse_projections(fam["llm"]),
                                             fam["cfg"]),
            "proj": fam["proj"], "step": 7}
    ckpt.save_pytree_dcp(path, tree)
    back = ckpt.load_pytree_dcp(path, ckpt.sharded_like(tree))
    same = back["step"] == 7 and back["llm"]["shard"] is tree["llm"]["shard"]
    for (n, a), (m, b) in zip(named_leaves(tree["llm"]), named_leaves(back["llm"])):
        if torch.is_tensor(a):
            same = same and n == m and a.dtype == b.dtype and torch.equal(a, b)
    for (_, a), (_, b) in zip(named_leaves(tree["proj"]), named_leaves(back["proj"])):
        same = same and torch.equal(a, b)
    keys = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    ranks = sorted({k.split("/")[1] for k in keys if k.startswith("llm/model")})
    return {"bit_equal": bool(same), "model_ranks": ranks}


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    store, inputs, manifest, out_path = argv[3:7]
    torch.set_num_threads(1)
    parallel.init_distributed(init_method=f"file://{store}", rank=rank, world_size=world,
                              backend="gloo")
    with open(manifest) as f:
        spec = json.load(f)
    inp = torch.load(inputs, weights_only=False)
    tok = build_test_tokenizer()
    results = {}
    for shape in spec["meshes"][str(world)]:
        shape = tuple(shape)
        key = f"{shape[0]}x{shape[1]}"
        mesh = parallel.make_mesh(shape, device="cpu")
        results[f"{key}/unit"] = unit_checks(mesh, inp["unit"])
        for name, fam in inp["families"].items():
            results[f"{key}/family/{name}"] = family_grads(mesh, fam)
        for name, case in inp["trainers"].items():
            results[f"{key}/trainer/{name}"] = run_trainer(case, tok, shape)
        results[f"{key}/dcp"] = dcp_roundtrip(mesh, inp["families"]["llama"],
                                              str(Path(out_path).parent / f"dcp{world}_{key}"))
    every = [None] * world
    dist.all_gather_object(every, {k: v for k, v in results.items() if "/unit" not in k})
    for other in every:
        for k, v in other.items():
            if repr(v) != repr(every[0][k]):
                raise AssertionError(f"rank {rank}: {k} differs between ranks")
    if rank == 0:
        torch.save(results, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
