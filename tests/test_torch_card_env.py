"""The card's package set suffices for the paper's entry points: in a fresh
process where tokenizers, transformers, nltk, rouge_score, safetensors, jax
and regex cannot be imported (the card's machine has none of them), the
CLI chain of chip_smoke.py (train_projector, train_hypernet in train and
fewshot mode, train_lora, then the serving CLI, at test:tiny with --device
cpu on fixture data from the port's generate_dataset) writes the same
results JSONs, logged losses and captions as the same chain in a process
where all of them can be imported; and `python -m dmi_tpu_torch.data.stats`
counts dmi_tpu's max_token_length there.  (The stats CLI runs only where
transformers is absent: with it, it would ask the hub for Llama's
tokenizer.)
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("tokenizers", "transformers", "nltk", "rouge_score", "safetensors", "jax", "regex")
DRIVER = """
import importlib, json, sys
blocked = json.loads(sys.argv[2])
for name in blocked:
    sys.modules[name] = None  # import raises ImportError
import torch
torch.set_num_threads(1)
import chip_smoke
chip_smoke.cli_chain(torch, sys.argv[1], "test:tiny", "float32", "cpu")
if blocked:  # stats' CLI: without transformers it counts with the fixture tokenizer
    import os, runpy
    os.chdir(sys.argv[1])
    sys.argv = ["stats", "candels", "zoobot-encoder-convnext_base", "data"]
    runpy.run_module("dmi_tpu_torch.data.stats", run_name="__main__")
for name in blocked:
    try:
        importlib.import_module(name)
        raise SystemExit(f"{name} imported")
    except ImportError:
        pass
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
                        & set(blocked))))
"""

torch.set_num_threads(1)


def test_cli_chain_needs_no_package_the_card_lacks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), WANDB_MODE="disabled", OMP_NUM_THREADS="1")
    procs = {}
    for label, blocked in (("blocked", BLOCKED), ("free", ())):
        procs[label] = subprocess.Popen(
            [sys.executable, "-c", DRIVER, str(tmp_path / label), json.dumps(blocked)],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {label: p.communicate(timeout=600) for label, p in procs.items()}
    for label, p in procs.items():
        assert p.returncode == 0, (label, out[label][1][-3000:])
    *_, max_len, loaded = out["blocked"][0].strip().splitlines()
    assert loaded == "[]"
    from dmi_tpu.data.stats import max_token_length
    from dmi_tpu.data.tok_fixture import build_test_tokenizer

    assert int(max_len) == max_token_length("candels", "zoobot-encoder-convnext_base",
                                            build_test_tokenizer(),
                                            str(tmp_path / "blocked" / "data")) > 0

    import chip_smoke

    blocked, free = (chip_smoke.cli_record(tmp_path / label) for label in ("blocked", "free"))
    losses, results, captions = blocked
    assert set(results) == {"projector:v2:smoke_projector_sydney-dszfull-seed42-results.json",
                            "hypernet:v6:smoke_fewshot_candels-dsz32-seed42-results.json",
                            "lora:v3:smoke_lora_sydney-dszfull-seed42-results.json",
                            "sydney-results.json", "candels-results.json"}
    assert len(losses) > 10 and set(captions) == {"captions.json"}
    per_run = [r for name, r in results.items() if "-seed" in name]
    assert all(set(r) == chip_smoke.RESULT_KEYS for r in per_run)
    assert blocked == free
