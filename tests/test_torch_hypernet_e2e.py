"""dmi_tpu_torch's stages 2-3 and the LoRA baseline end to end through the
port's CLIs on the CPU (--device cpu, the fixture data, test:tiny): the
ports of tests/test_hypernet_e2e.py and tests/test_lora_e2e.py.  The results
JSONs carry dmi_tpu's keys and the checkpoints are dmi_tpu's envelopes.
"""

import json
import os
import os.path as osp
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dmi_tpu.data.fixtures import generate_dataset
from dmi_tpu.training.checkpoint import load_pytree as jload
from dmi_tpu_torch.train_hypernet import run as run_hypernet
from dmi_tpu_torch.train_lora import run as run_lora
from dmi_tpu_torch.train_projector import run as run_projector
from dmi_tpu_torch.training.checkpoint import load_pytree
from dmi_tpu_torch.utils.grad_stats import named_leaves
from tests.test_hypernet_e2e import hypernet_config
from tests.test_projector_e2e import make_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MM = 32
PROJ_CKPT = osp.join("checkpoints",
                     "cfg_projector_smoke-dszfull-seed7-checkpoint-projector-best.pt")
RESULT_KEYS = {"metrics", "gts", "preds", "ids", "eval_env"}


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """tests/test_hypernet_e2e.py's data, and a stage-1 projector trained by
    the port (one epoch)."""
    monkeypatch.chdir(tmp_path)
    generate_dataset("data", "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=MM,
                     n_train=4, n_eval=2, text_dim=MM, seed=0)
    generate_dataset("data", "sharegpt4v", "ViT-L-16-SigLIP2-384", mm_dim=MM,
                     n_train=12, n_eval=4, text_dim=MM, seed=1)
    generate_dataset("data", "candels", "zoobot-encoder-convnext_base", mm_dim=MM,
                     n_train=4, n_eval=2, text_dim=MM, seed=2)
    run_projector(make_config(tmp_path, mm_dim=MM, epochs_l=[1]), device="cpu")
    assert osp.exists(PROJ_CKPT)
    return tmp_path


def test_three_stage_pipeline(workdir):
    """Stage 2 (rotation augmentation, text interleave) then stage 3 (few-shot
    integration of the unseen galaxy modality) through the port's run."""
    run_hypernet(hypernet_config(workdir, PROJ_CKPT, "train"), device="cpu")
    hn_ckpt = osp.join("checkpoints", "cfg_hypernet_train-checkpoint-hypernet-best.pt")
    env = jload(hn_ckpt)  # dmi_tpu reads the port's checkpoint
    assert set(env) == {"step_idx", "hypernet_state_dict", "optimizer_state_dict", "loss"}
    assert env["hypernet_state_dict"]["generators"][0]["w"].shape[0] == MM

    run_hypernet(hypernet_config(workdir, PROJ_CKPT, "fewshot", resume=hn_ckpt),
                 device="cpu")
    rf = osp.join("outputs", "hypernet:cfg_hypernet_fewshot-dsz10-seed7-results.json")
    results = json.load(open(rf))
    assert set(results) == RESULT_KEYS
    assert "coco_cider" in results["metrics"]["zoobot-encoder-convnext_base"]
    agg = json.load(open(osp.join("outputs", "candels-results.json")))
    assert "hypernet:cfg_hypernet_fewshot-dsz10" in agg
    fs = load_pytree(osp.join("checkpoints",
                              "cfg_hypernet_fewshot-dsz10-seed7-checkpoint-fewshot-best.pt"))
    assert fs["generated_projector"]["layers"][0]["w"].shape == (MM, 64)
    mtime = os.path.getmtime(rf)
    run_hypernet(hypernet_config(workdir, PROJ_CKPT, "fewshot", resume=hn_ckpt),
                 device="cpu")  # idempotent skip
    assert os.path.getmtime(rf) == mtime


def test_stage2_multi_dataset_and_coalesced(workdir):
    """Two high-resource datasets with the uniform per-step loader choice;
    then sequential accumulation against 2-way coalescing of the same
    configuration: the same trained hypernet within the JAX package's own
    coalescing bound (tests/test_hypernet_e2e.py:179-181)."""
    generate_dataset("data", "clothodetail", "Cacophony", mm_dim=MM, n_train=10, n_eval=4,
                     text_dim=MM, seed=5)
    multi = dict(menc_names_or_paths=["timm/ViT-L-16-SigLIP2-384", "Cacophony"],
                 load_extracted_features=[True, True],
                 dataset_names_or_paths=["sharegpt4v", "clothodetail"])
    paths = {}
    for name, coalesce in (("cfg_hn_seq", 1), ("cfg_hn_coal", 2)):
        cfg = hypernet_config(workdir, PROJ_CKPT, "train", gradient_accumulation_steps=4,
                              micro_batch_coalesce=coalesce, **multi)
        new = str(workdir / f"{name}.json")
        os.rename(cfg, new)
        run_hypernet(new, device="cpu")
        paths[name] = osp.join("checkpoints", f"{name}-checkpoint-hypernet-best.pt")
    seq = load_pytree(paths["cfg_hn_seq"])["hypernet_state_dict"]
    coal = load_pytree(paths["cfg_hn_coal"])["hypernet_state_dict"]
    leaves = [(a, b) for (_, a), (_, b) in zip(named_leaves(seq), named_leaves(coal))]
    assert len(leaves) == 11  # prefix, 2 generator heads, q k v
    for a, b in leaves:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-6)


def _lora_config(workdir):
    cfg = {
        "output_dir": "lora_1", "train_batch_size": 4, "eval_batch_size": 4,
        "learning_rate": 1e-3, "epochs_l": [1], "dataset_size_l": ["full"],
        "warmup_steps": 2, "scheduler": "cosine_warmup", "logging_steps": 8,
        "save_steps": 8, "eval_steps": 8, "generate_steps": 8, "seeds": [7],
        "pad_to_multiple_of": 8, "menc_names_or_paths": ["chendelong/RemoteCLIP-RN50-Unchanged"],
        "mm_dim": MM, "load_extracted_features": [True], "lm_name_or_path": "test:tiny",
        "lm_dtype": "float32", "dataset_names_or_paths": ["sydney"],
        "proj_name_or_path": PROJ_CKPT, "proj_arch": "mlp", "proj_n_layers": 2,
        "proj_dropout": 0.1, "lora_rank": 4, "lora_alpha": 4, "output_root": "outputs",
    }
    path = workdir / "cfg_lora_smoke.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_lora_end_to_end(workdir):
    """tests/test_lora_e2e.py through the port's train_lora.run."""
    run_lora(_lora_config(workdir), device="cpu")
    rf = osp.join("outputs", "lora:cfg_lora_smoke-dszfull-seed7-results.json")
    results = json.load(open(rf))
    assert set(results) == RESULT_KEYS
    assert "coco_cider" in results["metrics"]["RemoteCLIP-RN50-Unchanged"]
    ck = jload(osp.join("checkpoints", "cfg_lora_smoke-dszfull-seed7-checkpoint-lora_model-best.pt"))
    assert [tuple(np.shape(ad[k])) for ad in ck["lora_model_state_dict"] for k in ("a", "b")] == [
        (MM, 4), (4, 64), (64, 4), (4, 64)]


@pytest.mark.parametrize("module", ["train_hypernet", "train_lora"])
def test_cli_runs_on_the_cpu_when_asked(workdir, module):
    """python -m dmi_tpu_torch.<module> <config.json> --device cpu."""
    cfg = (hypernet_config(workdir, PROJ_CKPT, "train", epochs=1)
           if module == "train_hypernet" else _lora_config(workdir))
    env = dict(os.environ, PYTHONPATH=str(REPO), WANDB_MODE="disabled")
    r = subprocess.run([sys.executable, "-m", f"dmi_tpu_torch.{module}", cfg, "--device", "cpu"],
                       cwd=workdir, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert ("Starting hypernet training" if module == "train_hypernet"
            else "Starting LoRA training") in r.stderr
