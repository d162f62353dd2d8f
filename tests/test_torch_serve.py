"""dmi_tpu_torch's greedy serving path against dmi_tpu's, on shared weights.

At f32 on the CPU the port must emit the same greedy tokens as both of the
JAX package's loops (greedy_generate, batch-first; greedy_generate_bl,
batch-last) and the same caption strings as dmi_tpu.serve.Captioner.  Also
covered: checkpoint loading from a pickle dmi_tpu wrote, the CLI, the
surface the port refuses for now, and that the port never imports JAX.
The Captioner serves on the batch-last loop by default; that loop and the
int8 modes are held against dmi_tpu in tests/test_torch_decode_bl.py.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import decode as jdec
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import projector as jproj
from dmi_tpu.registry import dataset_spec
from dmi_tpu.serve import Captioner as JaxCaptioner
from dmi_tpu.training.checkpoint import save_pytree
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import decode as tdec
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.serve import Captioner
from dmi_tpu_torch.training.checkpoint import ForeignObject, load_pytree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PREFIX = "Describe the satellite image"


def _models(eos=(5,), vocab=96, seed=0):
    """Tiny f32 model; the layers' weights are scaled from init's std 0.02
    to 0.2, which makes greedy decode emit varied tokens (at 0.02 every row
    repeats one token, and token identity would test little)."""
    jcfg = jllama.tiny_config(vocab_size=vocab, hidden_size=64, n_layers=2, n_heads=4,
                              n_kv=2, intermediate=128, eos=eos)
    jparams = jllama.init(jax.random.key(seed), jcfg)
    jparams["layers"] = {k: v * 10.0 if k.startswith("w") else v
                         for k, v in jparams["layers"].items()}
    tparams = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_jax(jcfg), tparams


def _greedy_both(jcfg, jparams, tcfg, tparams, embeds, max_new, pad=1):
    j_bf = np.asarray(jdec.greedy_generate(jcfg, jparams, jnp.asarray(embeds), max_new, pad))
    j_bl = np.asarray(jdec.greedy_generate_bl(jcfg, jparams, jnp.asarray(embeds), max_new,
                                              pad))
    t = tdec.greedy_generate(tcfg, tparams, torch.as_tensor(embeds), max_new, pad).numpy()
    return j_bf, j_bl, t


def test_greedy_tokens_identical_to_both_jax_loops():
    jcfg, jparams, tcfg, tparams = _models(eos=())
    embeds = np.random.default_rng(0).normal(size=(5, 6, 64)).astype(np.float32)
    j_bf, j_bl, t = _greedy_both(jcfg, jparams, tcfg, tparams, embeds, max_new=9)
    np.testing.assert_array_equal(j_bf, j_bl)
    np.testing.assert_array_equal(t, j_bf)
    assert t.shape == (5, 9) and t.dtype == np.int64


def test_greedy_eos_mid_budget_identical():
    """EOS is a token the JAX run emits at step >= 2: rows that emit it stop
    there and pad the rest, identically in both packages."""
    jcfg, jparams, tcfg, tparams = _models(eos=())
    embeds = np.random.default_rng(1).normal(size=(6, 5, 64)).astype(np.float32)
    free = np.asarray(jdec.greedy_generate(jcfg, jparams, jnp.asarray(embeds), 10, 1))
    row = next(r for r in range(len(free)) if free[r, 3] not in free[r, :3])
    eos = int(free[row, 3])
    assert eos != 1  # the pad id
    jcfg, jparams, tcfg, tparams = _models(eos=(eos,))
    j_bf, j_bl, t = _greedy_both(jcfg, jparams, tcfg, tparams, embeds, max_new=10)
    np.testing.assert_array_equal(j_bf, j_bl)
    np.testing.assert_array_equal(t, j_bf)
    assert t[row, 3] == eos and (t[row, 4:] == 1).all()


def test_greedy_zero_and_one_token_budgets():
    jcfg, jparams, tcfg, tparams = _models()
    embeds = np.random.default_rng(2).normal(size=(2, 4, 64)).astype(np.float32)
    for max_new in (0, 1):
        j_bf, _, t = _greedy_both(jcfg, jparams, tcfg, tparams, embeds, max_new)
        np.testing.assert_array_equal(t, j_bf)


@pytest.fixture(scope="module")
def tokenizer():
    return build_test_tokenizer()


def _captioners(tokenizer, max_new=10, batch_size=4, mm=32):
    jcfg, jparams, tcfg, tparams = _models(eos=(tokenizer.eos_token_id,),
                                           vocab=len(tokenizer) + 8)
    spec = jproj.ProjectorSpec(mm_dim=mm, lm_dim=64)
    jpp = jproj.init(jax.random.key(1), spec)
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    jcap = JaxCaptioner(jcfg, jparams, spec, jpp, tokenizer, PREFIX, max_new,
                        batch_size=batch_size)
    tcap = Captioner(tcfg, tparams, tproj.ProjectorSpec(mm_dim=mm, lm_dim=64), tpp,
                     tokenizer, PREFIX, max_new, batch_size=batch_size)
    return jcap, tcap


def test_captioner_matches_dmi_tpu_captioner(tokenizer):
    """N = 10 through batch 4: the tail batch is padded."""
    jcap, tcap = _captioners(tokenizer)
    embs = np.random.default_rng(3).normal(size=(10, 32)).astype(np.float32)
    ref = jcap.caption(embs, engine="batch")
    out = tcap.caption(embs)
    assert len(out) == 10 and all(isinstance(c, str) for c in out)
    assert out == ref


def test_captioner_prefix_ids_without_tokenizer(tokenizer):
    _, tcap = _captioners(tokenizer)
    ids = tokenizer.apply_chat_template([{"role": "user", "content": PREFIX}],
                                        tokenize=True, add_generation_prompt=True)
    bare = Captioner(tcap.llm_cfg, tcap.llm_params, tcap.proj_spec, tcap.proj_params,
                     max_new_tokens=10, batch_size=4, prefix_ids=ids,
                     pad_token_id=tokenizer.pad_token_id)
    embs = np.random.default_rng(4).normal(size=(6, 32)).astype(np.float32)
    out = bare.caption_ids(embs)
    assert out.shape == (6, 10) and out.dtype == torch.long
    assert torch.equal(out, tcap.caption_ids(embs))
    with pytest.raises(ValueError, match="tokenizer"):
        bare.caption(embs)


@pytest.mark.parametrize("kwargs,item", [
    ({"int8": "fp8"}, "int8 must be"), ({"mesh_shape": (1, 1)}, "A.10"),
    ({"speculative": 2}, "A.8"),
])
def test_captioner_refuses_unported_options(tokenizer, kwargs, item):
    """int8 serving is ported (tests/test_torch_decode_bl.py): of int8 only a
    mode dmi_tpu does not have is refused."""
    _, tcap = _captioners(tokenizer)
    with pytest.raises(ValueError if "int8" in kwargs else NotImplementedError, match=item):
        Captioner(tcap.llm_cfg, tcap.llm_params, tcap.proj_spec, tcap.proj_params,
                  tokenizer, PREFIX, 10, **kwargs)


@pytest.mark.parametrize("kwargs,item", [
    ({"engine": "auto"}, "A.7"), ({"engine": "bulk"}, "A.7"), ({"temperature": 0.7}, "A.6"),
])
def test_caption_refuses_unported_modes(tokenizer, kwargs, item):
    _, tcap = _captioners(tokenizer)
    with pytest.raises(NotImplementedError, match=item):
        tcap.caption(np.ones((2, 32), np.float32), **kwargs)


@pytest.fixture()
def projector_ckpt(tmp_path):
    """A projector checkpoint as dmi_tpu's trainer writes it, optax state included."""
    import optax

    pparams = jproj.init(jax.random.key(2), jproj.ProjectorSpec(mm_dim=32, lm_dim=64))
    path = str(tmp_path / "proj-checkpoint-projector-best.pt")
    save_pytree(path, {
        "step_idx": 3,
        "projector_state_dict": pparams,
        "optimizer_state_dict": optax.adamw(1e-3).init(pparams),
        "coco_cider": 0.25,
    })
    return path, jax.tree.map(np.asarray, pparams)


def test_load_pytree_reads_dmi_tpu_pickle(projector_ckpt):
    path, pparams = projector_ckpt
    ckpt = load_pytree(path)
    assert ckpt["step_idx"] == 3 and ckpt["coco_cider"] == 0.25
    for got, want in zip(ckpt["projector_state_dict"]["layers"], pparams["layers"]):
        np.testing.assert_array_equal(got["w"], want["w"])
        np.testing.assert_array_equal(got["b"], want["b"])
    assert isinstance(ckpt["optimizer_state_dict"][0], ForeignObject)


def test_load_pytree_refuses_torch_zip(tmp_path):
    path = str(tmp_path / "ref.pt")
    torch.save({"projector_state_dict": {}}, path)
    with pytest.raises(NotImplementedError, match="A.12"):
        load_pytree(path)


def test_captioner_from_checkpoint(projector_ckpt):
    path, pparams = projector_ckpt
    cap = Captioner.from_checkpoint("test:tiny", path, "sydney", lm_dtype="float32",
                                    device="cpu", batch_size=4)
    assert cap.max_new_tokens == 22 and cap.proj_spec.mm_dim == 32
    np.testing.assert_array_equal(cap.proj_params["layers"][1]["w"].numpy(),
                                  pparams["layers"][1]["w"])
    captions = cap.caption(np.random.default_rng(0).normal(size=(10, 32)).astype(np.float32))
    assert len(captions) == 10 and all(isinstance(c, str) for c in captions)


def test_captioner_from_fewshot_checkpoint_serves_generated_projector(tmp_path):
    """A few-shot checkpoint carries the baked projector under
    generated_projector (dmi_tpu.serve.Captioner.from_checkpoint)."""
    spec = jproj.ProjectorSpec(mm_dim=16, lm_dim=64, n_layers=3)
    baked = jproj.init(jax.random.key(4), spec)
    path = str(tmp_path / "fewshot-checkpoint-fewshot-best.pt")
    save_pytree(path, {"step_idx": 1, "hypernet_state_dict": {"w": np.zeros(3)},
                       "generated_projector": baked})
    cap = Captioner.from_checkpoint("test:tiny", path, "sydney", lm_dtype="float32",
                                    device="cpu", batch_size=2)
    assert (cap.proj_spec.mm_dim, cap.proj_spec.n_layers) == (16, 3)
    np.testing.assert_array_equal(cap.proj_params["layers"][2]["b"].numpy(),
                                  np.asarray(baked["layers"][2]["b"]))
    assert len(cap.caption(np.ones((3, 16), np.float32))) == 3


def test_serve_cli_writes_captions(projector_ckpt, tmp_path):
    path, _ = projector_ckpt
    np.save(tmp_path / "embs.npy", np.random.default_rng(1).normal(size=(5, 32)).astype(
        np.float32))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "dmi_tpu_torch.serve", "--lm", "test:tiny",
         "--projector-ckpt", path, "--dataset", "sydney", "--embs", "embs.npy",
         "--out", "captions.json", "--batch-size", "4", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    caps = json.loads((tmp_path / "captions.json").read_text())
    assert sorted(caps) == ["0", "1", "2", "3", "4"]


def test_port_imports_no_jax():
    """In a fresh process: conftest.py has imported jax into this one."""
    code = (
        "import sys, dmi_tpu_torch, dmi_tpu_torch.serve, dmi_tpu_torch.bridge, "
        "dmi_tpu_torch.ops.cuda, dmi_tpu_torch.ops.cuda._build, "
        "dmi_tpu_torch.ops.cuda.flash_attn, dmi_tpu_torch.train_projector, "
        "dmi_tpu_torch.training.projector_trainer, dmi_tpu_torch.training.optim, "
        "dmi_tpu_torch.training.embeddings, dmi_tpu_torch.training.generation, "
        "dmi_tpu_torch.training.trainer, dmi_tpu_torch.utils.grad_stats, "
        "dmi_tpu_torch.utils.profiling, chip_smoke; "
        "print(sorted({m.split('.')[0] for m in sys.modules} "
        "& {'jax', 'jaxlib', 'transformers', 'tokenizers', 'optax', 'dmi_tpu'}))"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_chip_smoke_imports_load_no_dmi_tpu_module():
    """Every import statement of chip_smoke.py, those inside its functions
    included, run in a fresh process: none loads a module of the JAX package
    (the card's machine has no JAX).  The smoke's caption budget is
    sydney's, which it states as a constant for that reason."""
    nodes = [n for n in ast.walk(ast.parse((REPO / "chip_smoke.py").read_text()))
             if isinstance(n, (ast.Import, ast.ImportFrom))]
    for module in ("dmi_tpu_torch.serve", "dmi_tpu_torch.training.projector_trainer",
                   "dmi_tpu_torch.ops.cuda"):
        assert any(isinstance(n, ast.ImportFrom) and n.module == module for n in nodes), module
    code = "\n".join([ast.unparse(n) for n in nodes] + [
        "import sys, chip_smoke",
        "print(chip_smoke.MAX_NEW)",
        "print(sorted({m.split('.')[0] for m in sys.modules} "
        "& {'dmi_tpu', 'jax', 'jaxlib', 'transformers', 'tokenizers'}))",
    ])
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-2000:]
    max_new, loaded = r.stdout.strip().splitlines()
    assert loaded == "[]"
    assert int(max_new) == dataset_spec("sydney").max_new_tokens


def test_no_jax_import_in_port_sources():
    files = list((REPO / "dmi_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            assert not (words[:1] == ["import"] and words[1].startswith("jax")), (f, line)
            assert not (words[:1] == ["from"] and words[1].startswith("jax")), (f, line)
