"""The paper's LM name through both packages: dmi_tpu and the port resolve
meta-llama/Llama-3.2-1B-Instruct from one temporary hub cache
(HF_HUB_CACHE, HF_HUB_OFFLINE=1) that holds the Llama-3 fixture tokenizer
(hf_tokenizer.write_llama3_tokenizer_dir) and a tiny f32 Llama at Llama-3's
vocab of 128256 (2 layers, hidden 64, written by chip_smoke.write_hf_llama).
dmi_tpu reads them with transformers, the port with its own readers.

A worker process (tests/torch_llama3_slice_worker.py, started with the
cache in its environment, as huggingface_hub reads it at import) runs both:
the tokenizers' ids, masks, prompts and decodes are identical; the loaders'
first stage-1 batch is identical; the step-0 loss agrees to 1e-4 relative
(the tolerance tests/test_torch_train.py holds ProjectorTrainer's per-step
losses to); one greedy serve batch gives identical ids and captions.  And in
this process, with transformers and tokenizers unimportable, the port's
build_tokenizer still reads the cache.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from dmi_tpu_torch.config import LMArgs
from dmi_tpu_torch.data import hf_tokenizer
from dmi_tpu_torch.data.fixtures import generate_dataset
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.training import model_utils as tmu

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAME = "meta-llama/Llama-3.2-1B-Instruct"
LOSS_TOL = 1e-4


def write_hub_cache(root: Path) -> Path:
    """models--meta-llama--Llama-3.2-1B-Instruct/snapshots/<rev> with
    refs/main: the tiny Llama (weights x10 so that greedy decoding varies)
    and the fixture tokenizer; returns the snapshot."""
    repo = root / ("models--" + NAME.replace("/", "--"))
    snapshot = repo / "snapshots" / "0123abcd"
    snapshot.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abcd")
    cfg = dataclasses.replace(tllama.llama32_1b(torch.float32), hidden_size=64,
                              intermediate_size=128, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    params = tllama.init(cfg, torch.Generator().manual_seed(0))
    params["layers"] = [{k: v * 10 if k.startswith("w") else v for k, v in layer.items()}
                        for layer in params["layers"]]
    chip_smoke.write_hf_llama(torch, str(snapshot), cfg, params, n_shards=1)
    hf_tokenizer.write_llama3_tokenizer_dir(snapshot)
    return snapshot


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    root = tmp_path_factory.mktemp("hub")
    write_hub_cache(root)
    return root


@pytest.fixture(scope="module")
def run(hub, tmp_path_factory):
    """The worker's JSON."""
    work = tmp_path_factory.mktemp("slice")
    generate_dataset(str(work / "data"), "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=32,
                     n_train=8, n_eval=4, seed=0)
    env = dict(os.environ, HF_HUB_CACHE=str(hub), HF_HUB_OFFLINE="1", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), WANDB_MODE="disabled")
    env.pop("DMI_LM_OVERRIDE", None)
    out = work / "out.json"
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "torch_llama3_slice_worker.py"),
                           str(work), str(out)], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_both_packages_read_the_name_into_the_same_tokenizer(run):
    """dmi_tpu through AutoTokenizer, the port through its reader: the same
    special ids, chat ids, assistant masks, serving prompt, captions with
    bos and decodes, and the chat template set by the name."""
    jax_side, port = run["tokenizer"]["jax"], run["tokenizer"]["torch"]
    assert jax_side["class"] == "PreTrainedTokenizerFast" and port["class"] == "Llama3Tokenizer"
    for key in jax_side:
        if key != "class":
            assert port[key] == jax_side[key], key
    assert (port["bos"], port["eos"], port["pad"]) == (128000, 128009, 128009)
    assert all(ids[0] == 128000 for ids in port["plain"])
    assert all(sum(m) > 0 for m in port["assistant_masks"])


def test_models_and_loaders_agree(run):
    assert run["config_equal"] and run["params_equal"] and run["vocab_size"] == 128256
    assert run["is_instruct"] == [True, True]
    jax_batch, port_batch = run["batch"]["jax"], run["batch"]["torch"]
    assert sorted(port_batch) == sorted(jax_batch)
    for key in jax_batch:
        assert port_batch[key] == jax_batch[key], key
    assert any(i >= 128000 for row in port_batch["input_ids"] for i in row)


def test_step0_loss_agrees(run):
    j, t = run["loss"]["jax"], run["loss"]["torch"]
    assert np.isfinite(t) and abs(t - j) <= LOSS_TOL * max(1.0, abs(j)), (t, j)


def test_greedy_serve_batch_identical(run):
    jax_side, port = run["serve"]["jax"], run["serve"]["torch"]
    assert port["prefix"] == jax_side["prefix"]
    assert port["ids"] == jax_side["ids"]
    assert port["captions"] == jax_side["captions"]
    assert len({i for row in port["ids"] for i in row}) > 2


def test_port_reads_the_cache_without_transformers_or_tokenizers(hub, run, monkeypatch):
    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    for mod in [m for m in sys.modules if m.split(".")[0] in ("transformers", "tokenizers")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    tok = tmu.build_tokenizer(LMArgs(lm_name_or_path=NAME))
    assert isinstance(tok, hf_tokenizer.Llama3Tokenizer)
    from dmi_tpu_torch.data.fixtures import CAPTION_BANK

    assert tok(CAPTION_BANK)["input_ids"] == run["tokenizer"]["torch"]["plain"]
    assert sys.modules["transformers"] is None and sys.modules["tokenizers"] is None
