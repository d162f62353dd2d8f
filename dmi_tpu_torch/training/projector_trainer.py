"""Stage-1 projector trainer, with the from-scratch and fine-tuned baselines
(counterpart of dmi_tpu/training/projector_trainer.py; reference
dmi/train_projector.py:24-176).

  * weighted multi-loader sampling by loader length (dmi/train.py:76)
  * gradient accumulation with loss/accum scaling, global-norm clip, AdamW,
    step-indexed LR (the update uses the LR installed at the previous
    update's step index, optim.py)
  * periodic eval loss, generate -> CIDEr/BLEU, best checkpoint by
    coco_cider (fallback bleu) (dmi/train_projector.py:85-93)
  * final: reload the best, test generate, results JSON
    (dmi/train_projector.py:95-98)
  * finetune_from_checkpoint flips TRAINER_TYPE to 'ft_projector' and
    prunes layer-0 input features to the run's mm_dim
    (dmi/train_projector.py:36-38,166-176)

The LLM is frozen: its parameters never require grad, and the gradient
flows through every layer's attention (the flash kernels' backward on a
card) to the soft token and the projector.  Eval loss and generate run the
projector through fused_mlp2, with parameters that require grad, under
torch.no_grad().  Dropout draws from one stream per micro-step, seeded
from (seed, step): the counterpart of jax.random.fold_in(base_key, step),
so a resumed run draws what the uninterrupted run drew, and a counter-based
one (utils.rng.CounterRNG), so the CPU and the card draw the same masks.

mesh_shape (d, m) trains on a (data, model) mesh, one process a rank
(training/mesh.py): the LLM sharded over the model axis, the projector
replicated, each data rank on its rows of the global batch, the gradients
summed over the data ranks before the clip; every rank returns the global
loss, and global rank 0 alone writes files and computes caption metrics.

The data, eval, results and logging modules (the port's copies of
dmi_tpu's framework-free ones) are imported where they are used: a trainer
fed batches directly, as the card smoke feeds it, loads none of them.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from dmi_tpu_torch.models import mmmodel
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.models.llama import LlamaConfig
from dmi_tpu_torch.models.torch_import import optax_moments_from_checkpoint
from dmi_tpu_torch.parallel.distributed import on_rank0
from dmi_tpu_torch.training.checkpoint import BestCheckpointer, load_pytree, to_tensor
from dmi_tpu_torch.training import mesh as tm
from dmi_tpu_torch.training.generation import (
    comp_metric,
    metrics_for,
    pad_emb_rows,
    prefix_prompt_ids,
    safe_batch_decode,
)
from dmi_tpu_torch.training.optim import (
    adamw_state,
    clip_and_step,
    load_adamw_state,
    make_lr_fn,
    make_optimizer,
    set_adamw_moments,
    set_lr,
)
from dmi_tpu_torch.training.trainer import StepConditions, pick_loader, strip_to_assistant
from dmi_tpu_torch.utils.grad_stats import grad_summary, host_grad_summary, named_leaves, tree_map
from dmi_tpu_torch.utils.profiling import region, span, trace
from dmi_tpu_torch.utils.rng import CounterRNG

log = logging.getLogger("dmi_tpu_torch")


def dropout_generator(seed: int, step: int, device) -> CounterRNG:
    """The dropout stream of micro-step `step`: drawn on `device` from (seed,
    step) alone, with the same bits on every device."""
    return CounterRNG(seed, step, device=device)


def device_batch(batch, device):
    """(input_ids, attention_mask, labels) of a collated batch on `device`,
    ids and labels as int64."""
    return (
        torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long, device=device),
        torch.as_tensor(np.asarray(batch["attention_mask"]), device=device),
        torch.as_tensor(np.asarray(batch["labels"]), dtype=torch.long, device=device),
    )


def load_projector(path: str, spec: proj.ProjectorSpec) -> dict:
    """A pretrained projector from a checkpoint (dmi_tpu's envelope or a
    reference torch `.pt`: a projector's, or the frozen projector inside a
    hypernet or lora_model one), numpy leaves, its layer-0 input features
    pruned when the checkpoint is wider than spec.mm_dim
    (dmi/train_projector.py:166-176, dmi/model/projector.py:46-54): the
    fine-tune source of stage 1 and the frozen projector of stages 2-3 and
    the LoRA baseline."""
    params = load_pytree(path)["projector_state_dict"]
    if params["layers"][0]["w"].shape[0] > spec.mm_dim:
        params = proj.prune(params, spec.mm_dim)
    return tree_map(np.asarray, params)


def set_leaves(leaves_tree, values_tree) -> None:
    """Copy a tree of values (numpy or tensors) into a tree of leaves of the
    same structure, in place."""
    with torch.no_grad():
        for (_, leaf), (_, value) in zip(named_leaves(leaves_tree), named_leaves(values_tree)):
            leaf.copy_(to_tensor(value, leaf.device))


class ProjectorTrainer:
    TRAINER_TYPE = "projector"
    SAVE_TYPE = "projector"

    def __init__(
        self,
        name: str,
        llm_cfg: LlamaConfig,
        llm_params: dict,
        proj_spec: proj.ProjectorSpec,
        proj_params: dict,
        loaders: List,  # per encoder/dataset pair: total_train_steps, train_batch, eval_batches
        emb_mgrs: List,
        tokenizer,
        train_args,
        data_root: str = "data",
    ):
        self.name = name
        self.llm_cfg = llm_cfg
        self.device = llm_params["embed"].device
        self.llm_params, self.mesh, self.shard = tm.mesh_llm(train_args, llm_cfg, llm_params,
                                                             self.device)
        self.proj_spec = proj_spec
        self.loaders = loaders
        self.emb_mgrs = emb_mgrs
        self.tokenizer = tokenizer
        self.train_args = train_args
        self.data_root = data_root
        self.cond = StepConditions(train_args)
        self.ckpt = BestCheckpointer(train_args.checkpoint_dir, name, self.SAVE_TYPE, mode="max")

        if train_args.finetune_from_checkpoint:
            self.TRAINER_TYPE = "ft_projector"
            proj_params = load_projector(train_args.finetune_from_checkpoint, proj_spec)
        # the trainer's own leaves: the optimizer updates them in place
        self.params = tree_map(lambda t: to_tensor(t, self.device).clone().requires_grad_(),
                               proj_params)
        self.leaves = [t for _, t in named_leaves(self.params)]
        tm.broadcast_leaves(self.shard, self.leaves)
        self.opt = make_optimizer(train_args, self.leaves)
        self.total_steps = sum(ld.total_train_steps() for ld in loaders)
        self.lr_fn = make_lr_fn(train_args, self.total_steps)
        self.sched_step = 0  # last micro-step whose LR was installed
        self._last_grad_stats = None

    # ------------------------------------------------------------------

    def _set_params(self, tree) -> None:
        set_leaves(self.params, tree)

    def _soft_train(self, params, embs, generator):
        """The training projector's soft tokens: span train.projector, its
        backward to the parameters train.projector.bwd."""
        with region("train.projector") as r:
            params = tree_map(r.enter, params)
            return r.leave(proj.apply(self.proj_spec, params, embs, train=True,
                                      generator=generator))

    def _soft_eval(self, params, embs):
        return proj.apply(self.proj_spec, params, embs)

    def _device_batch(self, batch):
        """The batch's (ids, mask, labels) on the device: this data rank's
        rows on a mesh."""
        return tuple(tm.local_rows(self.shard, t) for t in device_batch(batch, self.device))

    # ------------------------------------------------------------------

    def fetch_batch(self, step: int):
        """Host-side batch assembly, a pure function of the step index, so it
        can be prefetched ahead."""
        weights = [ld.total_train_steps() for ld in self.loaders]
        idx = pick_loader(self.train_args.seed, step, len(self.loaders), weights)
        return idx, self.loaders[idx].train_batch(step)

    def micro_loss(self, step: int, prefetched=None, plain: bool = False) -> torch.Tensor:
        """Micro-step `step`'s loss on its batch and dropout draw, before the
        accumulation scaling; differentiable in the projector parameters.
        plain=True runs the attention's plain twin in place of the kernels.
        On a mesh it is this data rank's part (tm.token_mean_part): the
        projector runs over the global batch, so its dropout mask is the
        one-rank run's, and the rank keeps its rows' soft tokens."""
        idx, batch = prefetched if prefetched is not None else self.fetch_batch(step)
        with span("train.batch"):
            embs = self.emb_mgrs[idx].get_embeddings(batch["embs"])
            ids, mask, labels = self._device_batch(batch)
        gen = dropout_generator(self.train_args.seed, step, self.device)
        soft = tm.local_rows(self.shard, self._soft_train(self.params, embs, gen))
        return tm.token_mean_part(self.shard, mmmodel.caption_loss(
            self.llm_cfg, self.llm_params, soft, ids, mask, labels, plain=plain))

    def train_step(self, step: int, total_steps: int, prefetched=None):
        """Accumulate micro-step `step`'s gradient; on the accumulation
        boundary, clip, update and zero it.  Returns (loss / accum as a
        device scalar, the global loss on a mesh; whether it updated).
        Spans: train.step, over train.batch, train.projector,
        train.forward, train.backward (the host's wait for autograd's
        engine) and train.optimizer."""
        with span("train.step"):
            loss = self.micro_loss(step, prefetched) / self.train_args.gradient_accumulation_steps
            with span("train.backward"):
                loss.backward()
            do_update = self.cond.grad_acc(step, total_steps)
            if do_update:
                with span("train.optimizer"):
                    tm.reduce_grads(self.shard, self.opt)
                    # summary of the full accumulated gradient the optimizer consumes
                    self._last_grad_stats = grad_summary(tree_map(lambda t: t.grad, self.params))
                    set_lr(self.opt, self.lr_fn(self.sched_step))
                    clip_and_step(self.opt, self.train_args.max_grad_norm)
                    self.opt.zero_grad(set_to_none=True)
                self.sched_step = step
            return tm.global_value(self.shard, loss.detach()), do_update

    @torch.no_grad()
    def eval_loss(self, embs, ids, mask, labels) -> torch.Tensor:
        """Loss of one eval batch with the eval-mode projector (fused_mlp2);
        embs are the global batch's, ids, mask and labels this data rank's
        rows (_device_batch).  On a mesh: the global batch's loss."""
        soft = self._soft_eval(self.params, tm.local_rows(self.shard, embs))
        return tm.global_value(self.shard, tm.token_mean_part(self.shard, mmmodel.caption_loss(
            self.llm_cfg, self.llm_params, soft, ids, mask, labels)))

    def evaluate(self) -> float:
        """Mean of per-batch losses across all eval loaders
        (dmi/train_projector.py:100-129); one host sync at the end."""
        from dmi_tpu_torch.data.collator import pad_batch_dim

        bsz = self.train_args.eval_batch_size
        losses = []
        for emb_idx, loader in enumerate(self.loaders):
            for batch in loader.eval_batches("validation"):
                batch_p = pad_batch_dim(
                    {k: v for k, v in batch.items() if k not in ("ids", "embs")}, bsz
                )
                embs = self.emb_mgrs[emb_idx].get_embeddings(pad_emb_rows(batch["embs"], bsz))
                losses.append(self.eval_loss(embs, *self._device_batch(batch_p)))
        if not losses:  # empty eval split: nan, like the reference's mean([])
            return float("nan")
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, mode: str = "eval"):
        """Decode + metrics for every loader (dmi/train_projector.py:131-164);
        on a mesh each data rank decodes its rows on the sharded tree, the
        rows are gathered, and global rank 0 alone scores the captions."""
        if mode not in ("eval", "test"):
            raise ValueError(f"mode {mode!r}")
        split = "validation" if mode == "eval" else "test"
        all_metrics, all_gts, all_preds, all_ids = {}, {}, {}, {}
        bsz = self.train_args.eval_batch_size
        for emb_idx, loader in enumerate(self.loaders):
            mgr_name = self.emb_mgrs[emb_idx].short_name
            gts, preds, ids = [], [], []
            prefix = prefix_prompt_ids(self.tokenizer, loader, bsz, self.device)
            for batch in loader.eval_batches(split):
                real = batch["input_ids"].shape[0]
                gt_texts = safe_batch_decode(self.tokenizer, batch["input_ids"],
                                             skip_special_tokens=True)
                gts.extend(strip_to_assistant(gt_texts))
                ids.extend(batch["ids"])
                embs = tm.local_rows(self.shard, self.emb_mgrs[emb_idx].get_embeddings(
                    pad_emb_rows(batch["embs"], bsz)))
                tokens = mmmodel.caption_generate(
                    self.llm_cfg, self.llm_params, self._soft_eval(self.params, embs),
                    tm.local_rows(self.shard, prefix), loader.max_new_tokens,
                    self.tokenizer.pad_token_id,
                )
                if self.shard is not None:
                    tokens = self.shard.gather_rows(tokens)
                preds.extend(safe_batch_decode(self.tokenizer, tokens.cpu().numpy()[:real],
                                               skip_special_tokens=True))
            all_gts[mgr_name] = gts
            all_preds[mgr_name] = preds
            all_ids[mgr_name] = ids
            all_metrics[mgr_name] = on_rank0(lambda: metrics_for(
                loader, preds, ids, gts, self.name, mode, self.data_root))
        return all_metrics, all_gts, all_preds, all_ids

    # ------------------------------------------------------------------

    def param_tree(self) -> dict:
        return tree_map(torch.Tensor.detach, self.params)

    def optimizer_state(self) -> dict:
        """The checkpoint's optimizer_state_dict: the AdamW moments and
        per-parameter step counts, shaped like the parameters."""
        return adamw_state(self.opt, self.params)

    def comp_metric_value(self, all_metrics) -> tuple:
        return comp_metric(all_metrics)

    def resume(self, path: Optional[str] = None) -> int:
        """Restore params, optimizer state and step from an explicit
        checkpoint path or this run's best checkpoint; returns the step to
        start from.  Exact: batches and dropout are functions of the step.
        A reference torch checkpoint carries torch AdamW moments in place of
        an optimizer_state_dict; they are restored too when it has them
        (dmi_tpu/training/projector_trainer.py:300-328)."""
        best = load_pytree(path) if path else self.ckpt.load_best()
        if best is None:
            return 0
        self._set_params(best[f"{self.SAVE_TYPE}_state_dict"])
        if best.get("optimizer_state_dict") is not None:
            load_adamw_state(self.opt, self.params, best["optimizer_state_dict"],
                             self.device)
            self.sched_step = int(best["step_idx"])
        elif path:
            moments = optax_moments_from_checkpoint(path, self.SAVE_TYPE)
            if moments is not None:
                set_adamw_moments(self.opt, self.params, moments, self.device)
                self.sched_step = int(best["step_idx"])
        return int(best["step_idx"]) + 1

    def train(self, start_step: int = 0):
        from dmi_tpu_torch.data.prefetch import Prefetcher
        from dmi_tpu_torch.evals.environment import eval_environment
        from dmi_tpu_torch.training.results import save_run_results
        from dmi_tpu_torch.utils.logging import MetricLogger

        total = self.total_steps
        accum = self.train_args.gradient_accumulation_steps
        accumulated = 0.0
        cur_metric, comp_name = float("-inf"), "coco_cider"
        mlog = on_rank0(lambda: MetricLogger(self.name, f"dmi_{self.TRAINER_TYPE}"),
                        share=False)
        prefetcher = Prefetcher(self.fetch_batch, depth=2)
        last_log_t, last_log_step = time.perf_counter(), start_step
        with trace(self.train_args.profile_dir):
            for step, prefetched in prefetcher.run(start_step, total):
                if step % accum == 0:
                    accumulated = 0.0
                loss, did_update = self.train_step(step, total, prefetched)
                accumulated += loss
                if not did_update:
                    continue
                if (step + 1) % self.train_args.logging_steps == 0 and step > 0:
                    acc = float(accumulated)  # host sync only at log time
                    now = time.perf_counter()
                    sps = (step - last_log_step) / max(now - last_log_t, 1e-9)
                    last_log_t, last_log_step = now, step
                    log.info("Step: %d/%d Train Loss: %.3f", step, total, acc)
                    rec = {"train_loss": acc, "steps_per_s": sps}
                    if self._last_grad_stats is not None:
                        rec.update(host_grad_summary(self._last_grad_stats))
                    on_rank0(lambda: mlog.log(rec, step), share=False)
                if self.cond.evaluate(step, total):
                    ev = self.evaluate()
                    log.info("Step: %d Eval Loss: %.3f", step, ev)
                    on_rank0(lambda: mlog.log({"eval_loss": ev}, step), share=False)
                if self.cond.generate(step, total):
                    all_metrics, all_gts, all_preds, _ = self.generate("eval")
                    comp_name, cur_metric = self.comp_metric_value(all_metrics)
                    log.info("Step: %d Metrics: %s", step, all_metrics)
                    for mgr, ms in all_metrics.items():
                        on_rank0(lambda: mlog.log({f"{k} - {mgr}": v for k, v in ms.items()},
                                                  step), share=False)
                        on_rank0(lambda: mlog.log({f"samples - {mgr}": [
                            {"expected": g, "prediction": p}
                            for g, p in list(zip(all_gts[mgr], all_preds[mgr]))[:10]
                        ]}, step), share=False)
                if self.cond.save(step, total):
                    self.ckpt.save(
                        step, cur_metric, comp_name, self.param_tree(),
                        optimizer_state=self.optimizer_state()
                        if self.train_args.save_state else None,
                    )
        on_rank0(lambda: mlog.finish(), share=False)

        best = self.ckpt.load_best()
        if best is not None:
            self._set_params(best[f"{self.SAVE_TYPE}_state_dict"])
        test_metrics, test_gts, test_preds, test_ids = self.generate("test")
        on_rank0(lambda: save_run_results(
            self.train_args.output_root, self.TRAINER_TYPE, self.name,
            test_metrics, test_gts, test_preds, test_ids,
            eval_env=eval_environment(self.loaders[0].dataset_name),
        ))
        return test_metrics
