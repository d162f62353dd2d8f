"""Hypernetwork trainer: stage-2 training and stage-3 few-shot integration
(counterpart of dmi_tpu/training/hypernet_trainer.py; reference
HypernetTrainer, dmi/train_hypernet.py:26-462).

Train mode:
  * uniform loader choice per step (:125); each step draws a main batch and
    a conditioning subset batch (:130-136)
  * process_embeddings (:85-108): with augment_emb_space, a Haar-orthogonal
    matrix rotates the mm and subset embeddings, on the device, only inside
    the feed_txt_embs branch, as the reference does; pruned subsets are
    zero-padded back to finetune_mm_dim; text rows interleave with the
    subset rows after the prefix embedding
  * the hypernet emits adapters, the frozen projector's layer 0 runs with
    them through the fused CUDA kernel (projector.lora_apply ->
    fused_lora_layer0), and the frozen LLM's loss flows back through the
    flash kernels to the hypernet
  * gradient accumulation, clip, AdamW, step-indexed LR (optim.py); best
    checkpoint by eval loss, lower wins; no generate at the final step
  * micro_batch_coalesce k > 1 runs k same-loader micro-batches of an
    accumulation window as one [k*B]-row LLM forward, with one grouped
    lora0 launch for their k adapters: equal to the sequential path up to
    summation order

Fewshot mode (:168-295): adapters from 1 or len(train)//subset_bsz subset
draws, averaged and baked into a generated projector (combine_lora); a
fresh AdamW over it (or over the hypernet when finetune_generated_projector
is false); best by CIDEr; the final test generate and results JSON.

Random draws are explicit per micro-step, as ProjectorTrainer's dropout is:
micro-step s's rotation from (seed, 2s), its hypernet dropout from
(seed, 2s + 1), few-shot step s's dropout from (seed, 3s + 2), the indices
of dmi_tpu's fold_in (hypernet_trainer.py:432-433,718).  The bits are
the port's counter-based ones (the same on the CPU and the card), not
JAX's; `rotation(step)` is the one place the rotation is
drawn, so a test can hand in JAX's matrix.  The LLM and the frozen
projector never require grad.
"""

from __future__ import annotations

import logging
import types
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from dmi_tpu_torch.models import hypernet as hn
from dmi_tpu_torch.models import mmmodel
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.models.llama import LlamaConfig, fuse_projections
from dmi_tpu_torch.models.torch_import import optax_moments_from_checkpoint
from dmi_tpu_torch.ops.linalg import interleave_rows, pad_features, random_orthogonal
from dmi_tpu_torch.training.checkpoint import (
    BestCheckpointer,
    load_pytree,
    save_pytree,
    to_tensor,
)
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
from dmi_tpu_torch.training.projector_trainer import (
    device_batch,
    dropout_generator,
    set_leaves,
)
from dmi_tpu_torch.training.trainer import StepConditions, pick_loader, strip_to_assistant
from dmi_tpu_torch.utils.grad_stats import grad_summary, host_grad_summary, named_leaves, tree_map

log = logging.getLogger("dmi_tpu_torch")


def process_embeddings(mm_embs, subset, *, feed_txt_embs: bool,
                       rotation: Optional[torch.Tensor], pad_to: Optional[int]):
    """dmi/train_hypernet.py:85-108 -> (mm_embs, z).  `rotation` (or None)
    is the augmentation's orthogonal matrix; like the reference, it is
    applied only when feed_txt_embs."""
    if not feed_txt_embs:
        # the reference draws a rotation here but never applies it (:88-108)
        subm = subset
        if pad_to is not None and subm.shape[1] < pad_to:
            subm = pad_features(subm, pad_to)
        return mm_embs, subm
    # the coco-family subset collate has no prefix embedding (dmi/data/coco.py:166-182)
    subm, txt, pre = subset if len(subset) == 3 else (*subset, None)
    if rotation is not None:
        mm_embs = mm_embs @ rotation
        subm = subm @ rotation
    if pad_to is not None and subm.shape[1] < pad_to:
        subm = pad_features(subm, pad_to)
    z = interleave_rows(subm, txt)
    if pre is not None:
        z = torch.cat([pre, z], dim=0)
    return mm_embs, z


def _stack_adapters(adapters: List[hn.Adapters]) -> hn.Adapters:
    """Per-group adapters -> one adapter set with a leading group axis."""
    a, b, d = zip(*adapters)
    stack = [torch.stack(ts) for ts in zip(*a)], [torch.stack(ts) for ts in zip(*b)]
    return (*stack, None if d[0] is None else [torch.stack(ts) for ts in zip(*d)])


class HypernetTrainer:
    TRAINER_TYPE = "hypernet"
    SAVE_TYPE = "hypernet"

    def __init__(
        self,
        name: str,
        llm_cfg: LlamaConfig,
        llm_params: dict,
        proj_spec: proj.ProjectorSpec,
        frozen_proj_params: dict,
        hn_spec: hn.HypnetSpec,
        hn_params: dict,
        loaders: List,
        emb_mgrs: List,
        fewshot_loaders: List,
        fewshot_emb_mgrs: List,
        tokenizer,
        train_args,
        fewshot_args,
        data_root: str = "data",
    ):
        if train_args.mesh_shape:
            raise NotImplementedError(
                "mesh_shape (multi-card training) is not ported yet (ROADMAP.md A.10, "
                "parallelism)"
            )
        self.name = name
        self.llm_cfg = llm_cfg
        self.llm_params = fuse_projections(llm_params)
        self.device = self.llm_params["embed"].device
        self.proj_spec = proj_spec
        self.frozen_proj = tree_map(lambda t: to_tensor(t, self.device), frozen_proj_params)
        self.hn_spec = hn_spec
        self.loaders = loaders or []
        self.emb_mgrs = emb_mgrs or []
        self.fewshot_loaders = fewshot_loaders or []
        self.fewshot_emb_mgrs = fewshot_emb_mgrs or []
        self.tokenizer = tokenizer
        self.train_args = train_args
        self.fewshot_args = fewshot_args
        self.data_root = data_root
        self.cond = StepConditions(train_args)
        self.ckpt = BestCheckpointer(train_args.checkpoint_dir, name, self.SAVE_TYPE, mode="min")

        # the trainer's own leaves: the optimizer updates them in place
        self.params = tree_map(lambda t: to_tensor(t, self.device).clone().requires_grad_(),
                               hn_params)
        self.leaves = [t for _, t in named_leaves(self.params)]
        self.opt = make_optimizer(train_args, self.leaves)
        self.total_steps = sum(ld.total_train_steps() for ld in self.loaders)
        self.lr_fn = make_lr_fn(train_args, max(self.total_steps, 1))
        self.sched_step = 0  # last micro-step whose LR was installed
        self._last_grad_stats = None
        self.coalesce = max(1, int(getattr(train_args, "micro_batch_coalesce", 1)))
        self.generated_projector: Optional[dict] = None
        # the interface width z rows are padded to (the hypernet's input width)
        fmd = getattr(train_args, "finetune_mm_dim", None)
        self.pad_to = fmd if fmd is not None and proj_spec.mm_dim < fmd else None

    # ------------------------------------------------------------------
    # the step's pieces
    # ------------------------------------------------------------------

    def rotation(self, step: int) -> torch.Tensor:
        """Micro-step `step`'s augmentation rotation [mm_dim, mm_dim], drawn
        on the device from (seed, 2 * step)."""
        gen = dropout_generator(self.train_args.seed, 2 * step, self.device)
        return random_orthogonal(self.proj_spec.mm_dim, gen)

    def _augments(self) -> bool:
        return bool(self.train_args.feed_txt_embs and self.train_args.augment_emb_space)

    def _adapters(self, params, mm, subset, step: Optional[int]):
        """(mm after augmentation, adapters) of one micro-batch; step None is
        eval mode (no rotation, no dropout)."""
        train = step is not None
        mm2, z = process_embeddings(
            mm, subset, feed_txt_embs=self.train_args.feed_txt_embs,
            rotation=self.rotation(step) if train and self._augments() else None,
            pad_to=self.pad_to,
        )
        gen = (dropout_generator(self.train_args.seed, 2 * step + 1, self.device)
               if train else None)
        return mm2, hn.apply(self.hn_spec, params, z, train=train, generator=gen)

    def _soft(self, params, mm, subset, step: Optional[int], plain: bool = False):
        mm2, adapters = self._adapters(params, mm, subset, step)
        return proj.lora_apply(self.proj_spec, self.frozen_proj, mm2, *adapters, plain=plain)

    def _device_batch(self, batch):
        return device_batch(batch, self.device)

    def param_tree(self) -> dict:
        return tree_map(torch.Tensor.detach, self.params)

    def optimizer_state(self) -> dict:
        return adamw_state(self.opt, self.params)

    def load_checkpoint(self, path: str) -> dict:
        """Resume the hypernet (dmi/train_hypernet.py:417-427), with the
        optimizer state and the LR-schedule step when the checkpoint has
        them (the port's AdamW state, dmi_tpu's optax state, or a reference
        torch checkpoint's AdamW moments over the hypernet's parameters:
        the wrapper's frozen projector is not in that optimizer,
        dmi/train_hypernet.py:220-221): an exact mid-run resume."""
        ckpt = load_pytree(path)
        set_leaves(self.params, ckpt[f"{self.SAVE_TYPE}_state_dict"])
        if ckpt.get("optimizer_state_dict") is not None:
            load_adamw_state(self.opt, self.params, ckpt["optimizer_state_dict"], self.device)
            self.sched_step = int(ckpt["step_idx"])
        else:
            moments = optax_moments_from_checkpoint(path, self.SAVE_TYPE,
                                                    arch=self.hn_spec.arch)
            if moments is not None:
                set_adamw_moments(self.opt, self.params, moments, self.device)
                self.sched_step = int(ckpt["step_idx"])
        return {"step_idx": ckpt["step_idx"]}

    # ------------------------------------------------------------------
    # stage-2 training
    # ------------------------------------------------------------------

    def fetch_batch(self, step: int):
        """Host-side batch and conditioning-subset assembly, a pure function
        of the step index, so it can be prefetched ahead."""
        idx = pick_loader(self.train_args.seed, step, len(self.loaders))
        loader = self.loaders[idx]
        return idx, loader.train_batch(step), loader.subset_batch(step, "train")

    def micro_loss(self, step: int, prefetched=None, plain: bool = False) -> torch.Tensor:
        """Micro-step `step`'s loss on its batch, subset, rotation and dropout
        draw, before the accumulation scaling; differentiable in the hypernet
        parameters.  plain=True runs the plain twins of lora0 and of the
        flash attention in place of the kernels."""
        idx, batch, subset_raw = prefetched if prefetched is not None else self.fetch_batch(step)
        mgr = self.emb_mgrs[idx]
        soft = self._soft(self.params, mgr.get_embeddings(batch["embs"]),
                          mgr.get_embeddings(subset_raw), step, plain)
        return mmmodel.caption_loss(self.llm_cfg, self.llm_params, soft,
                                    *self._device_batch(batch), plain=plain)

    def _update(self, step: int) -> None:
        # summary of the full accumulated gradient the optimizer consumes
        self._last_grad_stats = grad_summary(tree_map(
            lambda t: torch.zeros_like(t) if t.grad is None else t.grad, self.params))
        set_lr(self.opt, self.lr_fn(self.sched_step))
        clip_and_step(self.opt, self.train_args.max_grad_norm)
        self.opt.zero_grad(set_to_none=True)
        self.sched_step = step

    def train_step(self, step: int, total_steps: int, prefetched=None):
        """Accumulate micro-step `step`'s gradient; on the accumulation
        boundary, clip, update and zero it.  Returns (loss / accum as a
        device scalar, whether it updated)."""
        loss = self.micro_loss(step, prefetched) / self.train_args.gradient_accumulation_steps
        loss.backward()
        do_update = self.cond.grad_acc(step, total_steps)
        if do_update:
            self._update(step)
        return loss.detach(), do_update

    def _stack_chunk(self, chunk, mgr):
        """k same-loader micro-batches (step, idx, batch, subset) packed for
        one dispatch: each padded to the chunk's longest T with labels -100
        and mask 0 (causally invisible and outside the loss), stacked
        [k, B, ...], mm and subset L2-normalized in one call each."""
        T = max(b["input_ids"].shape[1] for _, _, b, _ in chunk)

        def padded(b, key, fill):
            x = np.asarray(b[key])
            ext = np.full((x.shape[0], T - x.shape[1]), fill, x.dtype)
            return np.concatenate([x, ext], axis=1)

        stacked = {key: np.stack([padded(b, key, fill) for _, _, b, _ in chunk])
                   for key, fill in (("input_ids", 0), ("attention_mask", 0), ("labels", -100))}
        mm = mgr.get_embeddings(np.stack([b["embs"] for _, _, b, _ in chunk]))
        raw0 = chunk[0][3]
        if isinstance(raw0, (tuple, list)):
            subset = mgr.get_embeddings(tuple(np.stack([c[3][j] for c in chunk])
                                              for j in range(len(raw0))))
        else:
            subset = mgr.get_embeddings(np.stack([c[3] for c in chunk]))
        return mm, subset, device_batch(stacked, self.device), [s for s, _, _, _ in chunk]

    def coalesced_loss(self, mm_k, subset_k, ids_k, mask_k, labels_k, steps,
                       plain: bool = False) -> torch.Tensor:
        """The summed loss of k stacked micro-batches over the accumulation
        (the scale of k sequential micro-steps' losses): per-group rotation
        and dropout from each global step index, one grouped lora0 launch,
        one [k*B]-row LLM forward with per-group token-mean losses."""
        k, B = mm_k.shape[:2]
        mm2, adapters = [], []
        for g, step in enumerate(steps):
            subset = (tuple(t[g] for t in subset_k) if isinstance(subset_k, tuple)
                      else subset_k[g])
            m, ad = self._adapters(self.params, mm_k[g], subset, step)
            mm2.append(m)
            adapters.append(ad)
        soft = proj.lora_apply(self.proj_spec, self.frozen_proj, torch.stack(mm2),
                               *_stack_adapters(adapters), plain=plain)
        T = ids_k.shape[-1]
        losses = mmmodel.caption_loss_grouped(
            self.llm_cfg, self.llm_params, soft.reshape(k * B, -1), ids_k.reshape(k * B, T),
            mask_k.reshape(k * B, T), labels_k.reshape(k * B, T), k, plain=plain,
        )
        return losses.sum() / self.train_args.gradient_accumulation_steps

    def run_window(self, window):
        """Accumulate one accumulation window's micro-batches, [(step, idx,
        batch, subset)]: grouped by loader, full chunks of k coalesced, the
        rest one at a time (the order of a window's gradient sum is free).
        Returns the window's accumulated loss (device scalar)."""
        per = defaultdict(list)
        for item in window:
            per[item[1]].append(item)
        loss_sum = 0.0
        accum = self.train_args.gradient_accumulation_steps
        for idx, items in per.items():
            mgr = self.emb_mgrs[idx]
            pos = 0
            while pos < len(items):
                chunk = items[pos:pos + self.coalesce]
                if len(chunk) == self.coalesce and self.coalesce > 1:
                    mm, subset, (ids, mask, labels), steps = self._stack_chunk(chunk, mgr)
                    loss = self.coalesced_loss(mm, subset, ids, mask, labels, steps)
                    pos += len(chunk)
                else:
                    step, idx_, batch, subset_raw = items[pos]
                    loss = self.micro_loss(step, (idx_, batch, subset_raw)) / accum
                    pos += 1
                loss.backward()
                loss_sum = loss_sum + loss.detach()
        return loss_sum

    def _after_update(self, step, total, accumulated, mlog, cur_eval_loss):
        """Logging, eval, generate and checkpointing after an update at `step`;
        returns the current eval loss."""
        if (step + 1) % self.train_args.logging_steps == 0 and step > 0:
            acc = float(accumulated)  # host sync only at log time
            log.info("Step: %d/%d Train Loss: %.3f", step, total, acc)
            rec = {"train_loss": acc}
            if self._last_grad_stats is not None:
                rec.update(host_grad_summary(self._last_grad_stats))
            mlog.log(rec, step)
        if self.cond.evaluate(step, total):
            cur_eval_loss = self.evaluate()
            log.info("Step: %d Eval Loss: %.3f", step, cur_eval_loss)
            mlog.log({"eval_loss": cur_eval_loss}, step)
        if self.cond.generate(step, total, include_final=False):
            all_metrics, _, _, _ = self.generate(mode="eval")
            log.info("Step: %d Metrics: %s", step, all_metrics)
            for mname, ms in all_metrics.items():
                mlog.log({f"{k} - {mname}": v for k, v in ms.items()}, step)
        if self.cond.save(step, total):
            self.ckpt.save(step, cur_eval_loss, "loss", self.param_tree(),
                           optimizer_state=self.optimizer_state()
                           if self.train_args.save_state else None)
        return cur_eval_loss

    def train(self, start_step: int = 0):
        from dmi_tpu_torch.data.prefetch import Prefetcher
        from dmi_tpu_torch.utils.logging import MetricLogger

        total = self.total_steps
        cur_eval_loss = float("inf")
        mlog = MetricLogger(self.name, f"dmi_{self.TRAINER_TYPE}")
        prefetcher = Prefetcher(self.fetch_batch, depth=2 * self.coalesce)
        accumulated, window = 0.0, []
        for step, (idx, batch, subset_raw) in prefetcher.run(start_step, total):
            if self.coalesce > 1:
                window.append((step, idx, batch, subset_raw))
                if not self.cond.grad_acc(step, total):
                    continue
                accumulated = self.run_window(window)
                window = []
                self._update(step)
            else:
                if step % self.train_args.gradient_accumulation_steps == 0:
                    accumulated = 0.0
                loss, did_update = self.train_step(step, total, (idx, batch, subset_raw))
                accumulated = accumulated + loss
                if not did_update:
                    continue
            cur_eval_loss = self._after_update(step, total, accumulated, mlog, cur_eval_loss)
        return cur_eval_loss

    @torch.no_grad()
    def eval_loss(self, mm, subset, ids, mask, labels) -> torch.Tensor:
        """Loss of one eval batch: no rotation, no dropout."""
        soft = self._soft(self.params, mm, subset, None)
        return mmmodel.caption_loss(self.llm_cfg, self.llm_params, soft, ids, mask, labels)

    def evaluate(self, fewshot_idx: Optional[int] = None) -> float:
        """Per-batch mean loss (dmi/train_hypernet.py:310-352); one host sync
        at the end."""
        from dmi_tpu_torch.data.collator import pad_batch_dim

        if fewshot_idx is None:
            pairs = list(zip(self.loaders, self.emb_mgrs))
        else:
            pairs = [(self.fewshot_loaders[fewshot_idx], self.fewshot_emb_mgrs[fewshot_idx])]
        bsz = self.train_args.eval_batch_size
        losses = []
        for loader, mgr in pairs:
            for bi, batch in enumerate(loader.eval_batches("validation")):
                subset = mgr.get_embeddings(loader.subset_batch(bi, "validation"))
                batch_p = pad_batch_dim(
                    {k: v for k, v in batch.items() if k not in ("ids", "embs")}, bsz)
                mm = mgr.get_embeddings(pad_emb_rows(batch["embs"], bsz))
                losses.append(self.eval_loss(mm, subset, *self._device_batch(batch_p)))
        if not losses:  # empty eval split: nan, like the reference's mean([])
            return float("nan")
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    # generate (stage-2 eval and stage 3)
    # ------------------------------------------------------------------

    def _soft_for_generate(self, mm, subset):
        if self.generated_projector is not None:
            return proj.apply(self.proj_spec, self.generated_projector, mm)
        return self._soft(self.params, mm, subset, None)

    @torch.no_grad()
    def generate(self, mode: str = "eval", fewshot_idx: Optional[int] = None):
        if mode not in ("eval", "test"):
            raise ValueError(f"mode {mode!r}")
        split = "validation" if mode == "eval" else "test"
        if fewshot_idx is None:
            pairs = list(zip(self.loaders, self.emb_mgrs))
        else:
            pairs = [(self.fewshot_loaders[fewshot_idx], self.fewshot_emb_mgrs[fewshot_idx])]
        all_metrics, all_gts, all_preds, all_ids = {}, {}, {}, {}
        bsz = self.train_args.eval_batch_size
        for loader, mgr in pairs:
            gts, preds, ids = [], [], []
            prefix = prefix_prompt_ids(self.tokenizer, loader, bsz, self.device)
            for bi, batch in enumerate(loader.eval_batches(split)):
                real = batch["input_ids"].shape[0]
                gts.extend(strip_to_assistant(safe_batch_decode(
                    self.tokenizer, batch["input_ids"], skip_special_tokens=True)))
                ids.extend(batch["ids"])
                subset = mgr.get_embeddings(loader.subset_batch(bi, split))
                mm = mgr.get_embeddings(pad_emb_rows(batch["embs"], bsz))
                tokens = mmmodel.caption_generate(
                    self.llm_cfg, self.llm_params, self._soft_for_generate(mm, subset), prefix,
                    loader.max_new_tokens, self.tokenizer.pad_token_id,
                )
                preds.extend(safe_batch_decode(self.tokenizer, tokens.cpu().numpy()[:real],
                                               skip_special_tokens=True))
            name = mgr.short_name
            all_gts[name], all_preds[name], all_ids[name] = gts, preds, ids
            all_metrics[name] = metrics_for(loader, preds, ids, gts, self.name, mode,
                                            self.data_root)
        return all_metrics, all_gts, all_preds, all_ids

    # ------------------------------------------------------------------
    # stage 3: few-shot integration
    # ------------------------------------------------------------------

    @torch.no_grad()
    def fewshot_generate_adapters(self, emb_idx: int) -> None:
        """dmi/train_hypernet.py:168-200: the generated projector, from the
        mean of the adapters of one or of len(train) // subset_batch_size
        subset draws, as trainable leaves."""
        if not self.fewshot_args.finetune_generated_projector:
            return
        loader = self.fewshot_loaders[emb_idx]
        mgr = self.fewshot_emb_mgrs[emb_idx]
        if self.fewshot_args.fewshot_n_adapters == "one":
            n_subsets = 1
        elif self.fewshot_args.fewshot_n_adapters == "multiple":
            n_subsets = max(1, len(loader.train) // self.train_args.subset_batch_size)
        else:
            raise ValueError(self.fewshot_args.fewshot_n_adapters)
        log.info("Generating %d adapters for fewshot training", n_subsets)
        zeros = torch.zeros(1, self.proj_spec.mm_dim, device=self.device)
        draws = []
        for s in range(n_subsets):
            subset = mgr.get_embeddings(loader.subset_batch(s, "train"))
            _, z = process_embeddings(zeros, subset, feed_txt_embs=self.train_args.feed_txt_embs,
                                      rotation=None, pad_to=self.pad_to)
            draws.append(hn.apply(self.hn_spec, self.params, z))
        baked = proj.combine_lora(self.proj_spec, self.frozen_proj,
                                  *hn.average_adapters(draws))
        self.generated_projector = tree_map(lambda t: t.clone().requires_grad_(), baked)

    def fewshot_micro_loss(self, step: int, batch, subset_raw, mgr,
                           plain: bool = False) -> torch.Tensor:
        """Few-shot micro-step `step`'s loss, before the accumulation scaling:
        through the generated projector in train mode (dropout), or, with no
        generated projector, through the hypernet (dropout, no rotation) and
        the lora0 kernel.  Dropout draws from (seed, 3 * step + 2)."""
        gen = dropout_generator(self.train_args.seed, 3 * step + 2, self.device)
        mm = mgr.get_embeddings(batch["embs"])
        if self.generated_projector is not None:
            soft = proj.apply(self.proj_spec, self.generated_projector, mm, train=True,
                              generator=gen)
        else:
            mm2, z = process_embeddings(mm, mgr.get_embeddings(subset_raw),
                                        feed_txt_embs=self.train_args.feed_txt_embs,
                                        rotation=None, pad_to=self.pad_to)
            adapters = hn.apply(self.hn_spec, self.params, z, train=True, generator=gen)
            soft = proj.lora_apply(self.proj_spec, self.frozen_proj, mm2, *adapters, plain=plain)
        return mmmodel.caption_loss(self.llm_cfg, self.llm_params, soft,
                                    *self._device_batch(batch), plain=plain)

    def fewshot_optimizer(self):
        """A fresh AdamW over the few-shot trainable set (:220-224), with the
        few-shot LR and weight decay and torch's default betas."""
        fargs = self.fewshot_args
        trainable = (self.generated_projector if self.generated_projector is not None
                     else self.params)
        fs_args = types.SimpleNamespace(
            learning_rate=fargs.fewshot_learning_rate, weight_decay=fargs.fewshot_weight_decay,
            adam_beta1=0.9, adam_beta2=0.999, adam_epsilon=1e-8,
        )
        opt = make_optimizer(fs_args, [t for _, t in named_leaves(trainable)])
        set_lr(opt, fargs.fewshot_learning_rate)
        return opt

    def fewshot_train_step(self, step: int, total_steps: int, batch, subset_raw, mgr, opt):
        """Accumulate few-shot micro-step `step`'s gradient; on the
        accumulation boundary, clip and update with `opt` (the constant
        few-shot LR).  Returns (loss / accum as a device scalar, whether it
        updated)."""
        loss = (self.fewshot_micro_loss(step, batch, subset_raw, mgr)
                / self.train_args.gradient_accumulation_steps)
        loss.backward()
        do_update = self.cond.grad_acc(step, total_steps)
        if do_update:
            clip_and_step(opt, self.train_args.max_grad_norm)
            opt.zero_grad(set_to_none=True)
        return loss.detach(), do_update

    def fewshot_generate(self):
        """dmi/train_hypernet.py:202-295."""
        from dmi_tpu_torch.data.prefetch import Prefetcher
        from dmi_tpu_torch.evals.environment import eval_environment
        from dmi_tpu_torch.training.results import save_run_results
        from dmi_tpu_torch.utils.logging import MetricLogger

        args = self.train_args
        accum = args.gradient_accumulation_steps
        mlog = MetricLogger(self.name, f"dmi_{self.TRAINER_TYPE}")
        all_test = {"metrics": {}, "gts": {}, "preds": {}, "ids": {}}
        for emb_idx, (loader, mgr) in enumerate(zip(self.fewshot_loaders,
                                                    self.fewshot_emb_mgrs)):
            total = loader.total_train_steps()
            self.fewshot_generate_adapters(emb_idx)
            fs_opt = self.fewshot_optimizer()
            fs_ckpt = BestCheckpointer(args.checkpoint_dir, self.name, "fewshot", mode="max")
            best_metric = float("-inf")
            accumulated = 0.0
            prefetcher = Prefetcher(
                lambda s, _ld=loader: (_ld.train_batch(s), _ld.subset_batch(s, "train")),
                depth=2,
            )
            for step, (batch, subset_raw) in prefetcher.run(0, total):
                if step % accum == 0:
                    accumulated = 0.0
                loss, did_update = self.fewshot_train_step(step, total, batch, subset_raw,
                                                           mgr, fs_opt)
                accumulated = accumulated + loss
                if not did_update:
                    continue
                if (step + 1) % args.logging_steps == 0 and step > 0:
                    log.info("Fewshot step %d/%d loss %.3f", step, total, float(accumulated))
                    mlog.log({"train_loss": float(accumulated)}, step)
                if self.cond.evaluate(step, total):
                    all_metrics, _, _, _ = self.generate("eval", fewshot_idx=emb_idx)
                    metric_name, cur = comp_metric(all_metrics)
                    if best_metric < cur:
                        log.info("Best %s: %s < %s", metric_name, best_metric, cur)
                        best_metric = cur
                        save_pytree(fs_ckpt.best_path, {
                            "step_idx": step,
                            "hypernet_state_dict": self.param_tree(),
                            "generated_projector": None if self.generated_projector is None
                            else tree_map(torch.Tensor.detach, self.generated_projector),
                            metric_name: cur,
                        })

            best = fs_ckpt.load_best()
            if best is not None:
                set_leaves(self.params, best["hypernet_state_dict"])
                if best.get("generated_projector") is not None:
                    set_leaves(self.generated_projector, best["generated_projector"])
            tm, tg, tp, ti = self.generate("test", fewshot_idx=emb_idx)
            name = mgr.short_name
            all_test["metrics"][name] = tm[name]
            all_test["gts"][name] = tg[name]
            all_test["preds"][name] = tp[name]
            all_test["ids"][name] = ti[name]
            self.generated_projector = None  # (:294-295)

        save_run_results(
            args.output_root, self.TRAINER_TYPE, self.name,
            all_test["metrics"], all_test["gts"], all_test["preds"], all_test["ids"],
            eval_env=eval_environment(self.fewshot_loaders[0].dataset_name),
        )
        return all_test["metrics"]
