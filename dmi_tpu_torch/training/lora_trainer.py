"""LoRA-baseline trainer (counterpart of dmi_tpu/training/lora_trainer.py;
reference dmi/train_lora.py:24-160).

ProjectorTrainer's loop with the per-layer (A, B) adapters as the trainable
tree over a frozen pretrained projector; the forward is the full-net
module-LoRA path (projector.module_lora_apply, plain torch, as in the JAX
package).  Best checkpoint by coco_cider (fallback bleu).
"""

from __future__ import annotations

from typing import List

from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.models.lora import LoraSpec
from dmi_tpu_torch.training.checkpoint import to_tensor
from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer
from dmi_tpu_torch.utils.grad_stats import tree_map


class LoraTrainer(ProjectorTrainer):
    TRAINER_TYPE = "lora"
    SAVE_TYPE = "lora_model"  # checkpoint key parity (dmi/train_lora.py:28)

    def __init__(self, *, lora_spec: LoraSpec, lora_params: List[dict],
                 frozen_proj_params: dict, **kwargs):
        if kwargs["train_args"].finetune_from_checkpoint:
            raise NotImplementedError("the LoRA baseline does not fine-tune from checkpoints")
        self.lora_spec = lora_spec
        device = kwargs["llm_params"]["embed"].device
        # the frozen projector never requires grad; the parent trains the adapters
        self._frozen_proj = tree_map(lambda t: to_tensor(t, device), frozen_proj_params)
        super().__init__(proj_params=lora_params, **kwargs)

    def _soft_train(self, params, embs, generator):
        # the frozen projector stays in eval mode on this path (dmi/model/lora.py:49-57)
        return proj.module_lora_apply(self.proj_spec, self._frozen_proj, embs, params,
                                      self.lora_spec.alpha, self.lora_spec.rank)

    def _soft_eval(self, params, embs):
        return self._soft_train(params, embs, None)
