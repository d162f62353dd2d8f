"""The trainers on a gemma-2 LM end to end through the port's CLIs on the
CPU: stage 1 (train_projector), stage 2 (train_hypernet train, lora0's
twin), stage 3 (train_hypernet fewshot) and the LoRA baseline (train_lora),
with DMI_LM_OVERRIDE=test:tiny-gemma2 substituting the configs' LM.  The
trainers have no family-specific code: gemma's forward takes `_attention`
(softcapped scores) by its config, and each stage writes its results JSON
and checkpoint as it does on the llama body.
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from dmi_tpu.data.fixtures import generate_dataset
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.train_hypernet import run as run_hypernet
from dmi_tpu_torch.train_lora import run as run_lora
from dmi_tpu_torch.train_projector import run as run_projector
from dmi_tpu_torch.training.checkpoint import load_pytree
from tests.test_hypernet_e2e import hypernet_config
from tests.test_projector_e2e import make_config
from tests.test_torch_hypernet_e2e import MM, PROJ_CKPT, RESULT_KEYS, _lora_config

torch.set_num_threads(1)


@pytest.fixture()
def gemma_workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DMI_LM_OVERRIDE", "test:tiny-gemma2")
    generate_dataset("data", "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=MM,
                     n_train=4, n_eval=2, text_dim=MM, seed=0)
    generate_dataset("data", "sharegpt4v", "ViT-L-16-SigLIP2-384", mm_dim=MM,
                     n_train=12, n_eval=4, text_dim=MM, seed=1)
    generate_dataset("data", "candels", "zoobot-encoder-convnext_base", mm_dim=MM,
                     n_train=4, n_eval=2, text_dim=MM, seed=2)
    return tmp_path


def _finite_metrics(path):
    results = json.load(open(path))
    assert set(results) == RESULT_KEYS
    for per_encoder in results["metrics"].values():
        assert all(np.isfinite(v) for v in per_encoder.values() if isinstance(v, float))
    return results


def test_every_stage_runs_a_gemma2_lm(gemma_workdir, monkeypatch):
    """Stage 1, stage 2, stage 3 and the LoRA baseline on test:tiny-gemma2:
    each run writes its results and checkpoint; the forward never reaches
    the flash attention path."""
    from dmi_tpu_torch.config import LMArgs
    from dmi_tpu_torch.data.tok_fixture import build_test_tokenizer
    from dmi_tpu_torch.training.model_utils import build_lm

    cfg, _ = build_lm(LMArgs(lm_name_or_path="test:tiny"), build_test_tokenizer(),
                      device="cpu")
    assert cfg.attn_logit_softcap == 50.0 and cfg.mlp_act == "gelu_tanh"
    flash = []
    real = tllama.flash_attention
    monkeypatch.setattr(tllama, "flash_attention", lambda *a: flash.append(1) or real(*a))

    run_projector(make_config(gemma_workdir, mm_dim=MM, epochs_l=[1]), device="cpu")
    assert osp.exists(PROJ_CKPT)
    run_hypernet(hypernet_config(gemma_workdir, PROJ_CKPT, "train"), device="cpu")
    hn_ckpt = osp.join("checkpoints", "cfg_hypernet_train-checkpoint-hypernet-best.pt")
    assert set(load_pytree(hn_ckpt)) >= {"hypernet_state_dict", "optimizer_state_dict"}
    run_hypernet(hypernet_config(gemma_workdir, PROJ_CKPT, "fewshot", resume=hn_ckpt),
                 device="cpu")
    _finite_metrics(osp.join("outputs",
                             "hypernet:cfg_hypernet_fewshot-dsz10-seed7-results.json"))
    run_lora(_lora_config(gemma_workdir), device="cpu")
    _finite_metrics(osp.join("outputs", "lora:cfg_lora_smoke-dszfull-seed7-results.json"))
    assert not flash


@pytest.mark.parametrize("lm", ["test:tiny-olmoe", "test:tiny-deepseek"])
def test_every_stage_runs_a_moe_or_mla_lm(gemma_workdir, monkeypatch, lm):
    """Stage 1, stage 2, stage 3 and the LoRA baseline on the MoE and MLA
    test LMs: olmoe's forward takes the flash attention route (its twin on
    the CPU) with the routed MLP, deepseek's `_attention` (MLA) with the
    deepseek MoE; each run writes its results and checkpoint."""
    monkeypatch.setenv("DMI_LM_OVERRIDE", lm)
    flash, routed = [], []
    real_flash, real_moe = tllama.flash_attention, tllama._moe_mlp
    monkeypatch.setattr(tllama, "flash_attention", lambda *a: flash.append(1) or real_flash(*a))
    monkeypatch.setattr(tllama, "_moe_mlp", lambda *a: routed.append(1) or real_moe(*a))

    run_projector(make_config(gemma_workdir, mm_dim=MM, epochs_l=[1]), device="cpu")
    assert osp.exists(PROJ_CKPT)
    run_hypernet(hypernet_config(gemma_workdir, PROJ_CKPT, "train"), device="cpu")
    hn_ckpt = osp.join("checkpoints", "cfg_hypernet_train-checkpoint-hypernet-best.pt")
    run_hypernet(hypernet_config(gemma_workdir, PROJ_CKPT, "fewshot", resume=hn_ckpt),
                 device="cpu")
    _finite_metrics(osp.join("outputs",
                             "hypernet:cfg_hypernet_fewshot-dsz10-seed7-results.json"))
    run_lora(_lora_config(gemma_workdir), device="cpu")
    _finite_metrics(osp.join("outputs", "lora:cfg_lora_smoke-dszfull-seed7-results.json"))
    assert routed and bool(flash) == lm.endswith("olmoe")
