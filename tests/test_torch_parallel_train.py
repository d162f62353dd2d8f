"""Training on a (data, model) mesh held against dmi_tpu on the CPU, over
gloo (ROADMAP A.10b).

Each world (2 and 4 ranks) is spawned once, in a module-scoped fixture:
every rank is a `python tests/torch_spmd_train_worker.py` process
(subprocess, never fork: this process holds JAX), joined through a file://
store, one CPU thread each, under a timeout, so that a hang fails these
tests and not the suite.  The worker runs every case at every mesh of its
world -- (2, 1) and (1, 2) at world 2, (2, 2) and (1, 4) at world 4 -- and
writes its results; meanwhile this process computes the references:

  * each autograd collective alone against the one-rank function (the
    worker computes both: max errors, the vocab NLL's also in f64);
  * the stage-1 loss and projector gradients of llama and the nine
    families of tests/test_torch_parallel_spmd.py (olmo2's psum-backward
    norms, MLA with a shared expert; (1, 4) copies the 2 kv heads) against
    dmi_tpu's unsharded value_and_grad on the same bridged weights, over a
    batch whose data ranks hold uneven label counts: 1e-5 relative, the
    gradients to 1e-5 of the largest;
  * the three trainers with mesh_shape over 4 micro-steps on the fixture
    data: against dmi_tpu's single-device trainers where no draws enter
    (dropout 0, JAX's rotations injected), and against the port's own
    one-rank trainer with dropout, rotations and micro_batch_coalesce 2 on
    (losses to 1e-5 relative before the first update and 1e-4 after,
    parameters within the parity tests' rtol 5e-4, atol 5e-6); captions
    decoded on the mesh equal dmi_tpu's;
  * a torch.distributed.checkpoint round trip of the sharded tree, bit for
    bit, each model rank's shards its own entries;
  * `python -m dmi_tpu_torch.training.dryrun --world 2 --device cpu`.
"""

import dataclasses
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

from dmi_tpu.config import FewshotArgs as JaxFewshotArgs
from dmi_tpu.config import TrainArgs as JaxTrainArgs
from dmi_tpu.data.fixtures import generate_dataset
from dmi_tpu.data.loader import DatasetLoader as JaxLoader
from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import hypernet as jhn
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import lora as jlora
from dmi_tpu.models import mmmodel as jmm
from dmi_tpu.models import projector as jproj
from dmi_tpu.ops import random_orthogonal as jrandom_orthogonal
from dmi_tpu.registry import dataset_spec
from dmi_tpu.training.embeddings import EmbeddingManager as JaxEmbeddingManager
from dmi_tpu.training.hypernet_trainer import HypernetTrainer as JaxHypernetTrainer
from dmi_tpu.training.lora_trainer import LoraTrainer as JaxLoraTrainer
from dmi_tpu.training.projector_trainer import ProjectorTrainer as JaxTrainer
from dmi_tpu_torch import bridge
from dmi_tpu_torch.data.tok_fixture import build_test_tokenizer as port_tokenizer
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.models import lora as tlora
from dmi_tpu_torch.training import checkpoint as tckpt
from tests.test_torch_hypernet_train import _jax_step
from tests.test_torch_parallel_spmd import FAMILIES, TINY, _fields
from tests.test_torch_train import _llms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_spmd_train_worker.py"
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
SHAPES = [s for shapes in MESHES.values() for s in shapes]
TIMEOUT = 600  # seconds a world may take
MM = 32
STEPS = 4
PARAM_TOL = dict(rtol=5e-4, atol=5e-6)
SYDNEY = ("sydney", "chendelong/RemoteCLIP-RN50-Unchanged")
SHAREGPT = ("sharegpt4v", "timm/ViT-L-16-SigLIP2-384")
CANDELS = ("candels", "mwalmsley/zoobot-encoder-convnext_base")
ARGS = dict(output_dir="x", train_batch_size=4, eval_batch_size=4, epochs=2,
            dataset_size="full", seed=3, learning_rate=1e-3, warmup_steps=1,
            gradient_accumulation_steps=2, save_steps=1000, eval_steps=1000,
            generate_steps=1000, checkpoint_dir="ck", output_root="outputs")
HN_ARGS = dict(ARGS, subset_batch_size=4, scheduler="cosine_warmup", feed_txt_embs=True,
               augment_emb_space=True, weight_decay=0.05)

sys.path.insert(0, str(REPO / "tests"))
import torch_spmd_train_worker as worker  # noqa: E402


def key(shape):
    return f"{shape[0]}x{shape[1]}"


def _close(out, ref, tol, scale=None):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    bound = tol * (np.abs(ref).max() if scale is None else scale)
    assert err <= bound, (err, bound)


# ---------------------------------------------------------------------------
# Inputs and references
# ---------------------------------------------------------------------------

def _unit_inputs() -> dict:
    rng = np.random.default_rng(17)
    cfg = tllama.LlamaConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in _fields(jllama.tiny_config(**TINY)).items()},
                             dtype=torch.float32)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    u = {"cfg": cfg, "x": f(3, 8), "w": f(8, 12), "g": f(3, 12)}
    for name, width in (("q", 4 * 16), ("k", 2 * 16)):
        u[f"norm_{name}_x"], u[f"norm_{name}_g"] = f(3, width), f(3, width)
        u[f"norm_{name}_s"] = 1 + 0.3 * f(width)
    u["logits"] = 3 * f(6, 253)
    # targets in every vocab block of m = 2 and 4, the last row, and ignored rows
    u["target"] = torch.tensor([0, 70, -100, 140, 252, 200])
    u["weight"] = f(6)
    return u


def _family(name, seed):
    """dmi_tpu's tiny family, its projector (mm 16) and a batch of 4 rows
    whose halves hold 13 and 6 valid labels (one row has none); the
    bridged copies for the worker; dmi_tpu's loss and projector
    gradients."""
    jcfg = dataclasses.replace(FAMILIES[name](), attention_impl="xla")
    jtree = jllama.init(jax.random.key(seed), jcfg)
    jspec = jproj.ProjectorSpec(mm_dim=16, lm_dim=jcfg.hidden_size, n_layers=2, dropout=0.0)
    jpp = jproj.init(jax.random.key(seed + 1), jspec)
    rng = np.random.default_rng(seed)
    B, T = 4, 10
    embs = rng.normal(size=(B, 16)).astype(np.float32)
    ids = rng.integers(6, jcfg.vocab_size, size=(B, T))
    mask = np.ones((B, T), np.int32)
    labels = ids.copy()
    labels[:, :3] = -100
    labels[1, 7:] = -100
    labels[2, 6:] = -100
    labels[3, :] = -100
    jargs = tuple(map(jnp.asarray, (ids, mask, labels)))

    def jloss(pp):
        soft = jproj.apply(jspec, pp, jnp.asarray(embs))
        return jmm.caption_loss(jcfg, jtree, soft, *jargs)

    ref, grads = jax.value_and_grad(jloss)(jpp)
    port = {"cfg": bridge.config_from_jax(jcfg),
            "llm": bridge.llm_params_from_jax(jax.tree.map(np.asarray, jtree)),
            "spec": bridge.projector_spec_from_jax(jspec),
            "proj": bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp)),
            "embs": torch.from_numpy(embs), "ids": torch.from_numpy(ids),
            "mask": torch.from_numpy(mask), "labels": torch.from_numpy(labels)}
    want = [np.asarray(g) for layer in grads["layers"] for g in (layer["b"], layer["w"])]
    return port, (float(ref), want)


def _projector_cases(tok):
    """The stage-1 cases (dropout 0 against dmi_tpu, 0.1 against the port)
    and the LoRA baseline; returns (cases, dmi_tpu's trainers)."""
    jcfg, jllm, tcfg, tllm = _llms(vocab=tok.vocab_size + 8, weight_scale=10.0)
    cases, jax_trainers = {}, {}
    for name, dropout in (("projector", 0.0), ("projector_dropout", 0.1)):
        jspec = jproj.ProjectorSpec(mm_dim=MM, lm_dim=64, dropout=dropout)
        jpp = jproj.init(jax.random.key(1), jspec)
        cases[name] = {"kind": "projector", "args": ARGS, "data": SYDNEY, "cfg": tcfg,
                       "llm": tllm, "spec": bridge.projector_spec_from_jax(jspec),
                       "proj": bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp)),
                       "generate": dropout == 0.0, "evaluate": dropout == 0.0,
                       "uneven": dropout == 0.0}
    jspec = jproj.ProjectorSpec(mm_dim=MM, lm_dim=64, dropout=0.0)
    jpp = jproj.init(jax.random.key(1), jspec)
    loader = worker.UnevenLabels(JaxLoader(dataset_spec(SYDNEY[0]), tok, JaxTrainArgs(**ARGS),
                                           SYDNEY[1].split("/")[-1], True, "data"))
    jax_trainers["projector"] = JaxTrainer(
        name="jax", llm_cfg=jcfg, llm_params=jllm, proj_spec=jspec, proj_params=jpp,
        loaders=[loader], emb_mgrs=[JaxEmbeddingManager(SYDNEY[1])], tokenizer=tok,
        train_args=JaxTrainArgs(**ARGS))
    lspec = jlora.LoraSpec(rank=4, alpha=8)
    jad = jlora.init(jax.random.key(2), lspec, jspec)
    cases["lora"] = {"kind": "lora", "args": ARGS, "data": SYDNEY, "cfg": tcfg, "llm": tllm,
                     "spec": bridge.projector_spec_from_jax(jspec),
                     "proj": bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp)),
                     "lora_spec": tlora.LoraSpec(rank=4, alpha=8), "uneven": True,
                     "lora": bridge.lora_params_from_jax(jax.tree.map(np.asarray, jad))}
    jax_trainers["lora"] = JaxLoraTrainer(
        lora_spec=lspec, lora_params=jad, frozen_proj_params=jpp, name="jax", llm_cfg=jcfg,
        llm_params=jllm, proj_spec=jspec, loaders=[loader],
        emb_mgrs=[JaxEmbeddingManager(SYDNEY[1])], tokenizer=tok,
        train_args=JaxTrainArgs(**ARGS))
    return cases, jax_trainers


def _hypernet_cases(tok):
    """Stage 2 without draws (JAX's rotations) against dmi_tpu, stage 2 with
    attention dropout, the port's rotations and micro_batch_coalesce 2, and
    stage 3 over the generated projector (dropout 0.1) and over the
    hypernet, the last three against the port's one-rank trainer."""
    jcfg, jllm, tcfg, tllm = _llms(vocab=tok.vocab_size + 8)
    cases, jax_trainers = {}, {}

    def case(name, mode="train", attn_dropout=0.0, proj_dropout=0.0, fewshot=None, **extra):
        args = dict(HN_ARGS, mode=mode, **extra)
        pspec = jproj.ProjectorSpec(mm_dim=MM, lm_dim=64, dropout=proj_dropout)
        jpp = jproj.init(jax.random.key(1), pspec)
        hspec = jhn.HypnetSpec(lm_dim=64, mm_dim=MM, n_tokens=4, arch="attention",
                               hypnet_dim=MM, rank=4, alpha=4, use_pos_encs=True,
                               attn_dropout=attn_dropout)
        jhp = jhn.init(jax.random.key(2), hspec)
        cases[name] = {"kind": "hypernet" if mode == "train" else "fewshot", "args": args,
                       "data": [SHAREGPT] if mode == "train" else [],
                       "fewshot_data": [CANDELS],
                       "fewshot_args": fewshot or {"finetune_generated_projector": True},
                       "cfg": tcfg, "llm": tllm, "spec": bridge.projector_spec_from_jax(pspec),
                       "proj": jax.tree.map(np.asarray, jpp),
                       "hn_spec": bridge.hypnet_spec_from_jax(hspec),
                       "hn": bridge.hypernet_params_from_jax(jax.tree.map(np.asarray, jhp))}
        return pspec, jpp, hspec, jhp, JaxTrainArgs(**args)

    pspec, jpp, hspec, jhp, jargs = case("hypernet")
    jl = [worker.UnevenLabels(JaxLoader(dataset_spec(SHAREGPT[0]), tok, jargs,
                                        SHAREGPT[1].split("/")[-1], True, "data"))]
    jt = JaxHypernetTrainer("jax", jcfg, jllm, pspec, jpp, hspec, jhp, jl,
                            [JaxEmbeddingManager(SHAREGPT[1])], [], [], tok, jargs,
                            JaxFewshotArgs(finetune_generated_projector=True))
    cases["hypernet"]["rotations"] = [torch.from_numpy(np.array(jrandom_orthogonal(
        jax.random.fold_in(jt._base_key, 2 * s), MM))) for s in range(STEPS)]
    cases["hypernet"].update(evaluate=True, uneven=True, generate=True)
    jax_trainers["hypernet"] = jt
    case("hypernet_coalesced", attn_dropout=0.05, micro_batch_coalesce=2)
    case("fewshot_generated", mode="fewshot", proj_dropout=0.1,
         fewshot={"finetune_generated_projector": True})
    case("fewshot_hypernet", mode="fewshot", attn_dropout=0.05,
         fewshot={"finetune_generated_projector": False})
    return cases, jax_trainers


def _jax_run(name, jt) -> dict:
    """dmi_tpu's trainer over the same micro-steps (its captions decoded
    first where the case asks)."""
    out = {}
    if name in ("projector", "hypernet"):
        _, _, out["preds"], _ = jt.generate("test" if name == "projector" else "eval")
    total = jt.total_steps
    if name == "hypernet":
        out["losses"] = [_jax_step(jt, s, total)[0] for s in range(STEPS)]
    else:
        out["losses"] = [float(jt.train_step(s, total)[0]) for s in range(STEPS)]
    out["params"] = [np.asarray(x) for x in jax.tree.leaves(jt.state.params)]
    if name in ("projector", "hypernet"):
        out["eval"] = jt.evaluate()
    return out


def _spawn_world(world, workdir, inputs, manifest):
    store = workdir / f"store{world}"
    out = workdir / f"world{world}.pt"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(store),
                               str(inputs), str(manifest), str(out)],
                              cwd=str(workdir), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, out


def _wait(procs, deadline_s):
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=deadline_s)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"a gloo world did not finish within {deadline_s} s")
        logs.append(out)
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), "\n".join(f"rank {r} exit {c}:\n{log[-3000:]}"
                                                for r, (c, log) in
                                                enumerate(zip(codes, logs)))


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Both worlds' results and the references."""
    workdir = tmp_path_factory.mktemp("spmd_train")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        generate_dataset("data", "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=MM, n_train=8,
                         n_eval=4, seed=0)
        generate_dataset("data", "sharegpt4v", "ViT-L-16-SigLIP2-384", mm_dim=MM, n_train=8,
                         n_eval=4, text_dim=MM, seed=1)
        generate_dataset("data", "candels", "zoobot-encoder-convnext_base", mm_dim=MM,
                         n_train=8, n_eval=4, text_dim=MM, seed=2)
        tok = build_test_tokenizer()
        # write the loaders' columnar caches before the ranks read them
        ptok = port_tokenizer()
        for ds, enc in (SYDNEY, SHAREGPT, CANDELS):
            worker._loaders(ptok, worker.TrainArgs(**HN_ARGS), [(ds, enc)])
        families, fam_ref = {}, {}
        for i, name in enumerate(FAMILIES):
            families[name], fam_ref[name] = _family(name, seed=40 + i)
        pcases, pjax = _projector_cases(tok)
        hcases, hjax = _hypernet_cases(tok)
        cases = {**pcases, **hcases}
        inputs, manifest = workdir / "inputs.pt", workdir / "manifest.json"
        torch.save({"unit": _unit_inputs(), "families": families, "trainers": cases}, inputs)
        manifest.write_text(json.dumps(
            {"meshes": {str(w): [list(s) for s in shapes] for w, shapes in MESHES.items()}}))
        worlds = {w: _spawn_world(w, workdir, inputs, manifest) for w in MESHES}

        # meanwhile: dmi_tpu's trainers and the port's one-rank ones
        refs = {name: _jax_run(name, jt) for name, jt in {**pjax, **hjax}.items()}
        for name, case in cases.items():
            if name not in refs:
                refs[name] = worker.run_trainer(case, ptok, None)
        results = {}
        for procs, out in worlds.values():
            _wait(procs, TIMEOUT)
            results.update(torch.load(out, weights_only=False))
    finally:
        os.chdir(cwd)
    return results, fam_ref, refs


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

UNIT_EXACT = ("copy", "psum_value", "psum_grad", "norm_q", "norm_k", "nll_value", "nll_grad")


@pytest.mark.parametrize("shape", SHAPES, ids=key)
@pytest.mark.parametrize("what", UNIT_EXACT + ("nll_grad_f64",))
def test_each_collective_alone_matches_the_one_rank_function(spmd, shape, what):
    """copy (identity, psum backward) before column products, psum (identity
    backward) after row products, psum_shared through olmo2's whole-width
    norm (a copied kv head at m = 4), and the vocab-parallel NLL: values and
    gradients on this rank's slice equal the one-rank function's (autograd
    through F.cross_entropy for the NLL) to f32 rounding, and the NLL's
    backward to 1e-12 in f64."""
    unit = spmd[0][f"{key(shape)}/unit"]
    assert unit[what] <= (1e-12 if what == "nll_grad_f64" else 2e-5), (what, unit[what])


FAMILY_CASES = [(s, name) for s in SHAPES for name in FAMILIES]


@pytest.mark.parametrize("shape,name", FAMILY_CASES, ids=[f"{key(s)}-{n}" for s, n in
                                                          FAMILY_CASES])
def test_stage1_loss_and_projector_gradients_match_dmi_tpu(spmd, shape, name):
    """The global loss (this data rank's summed NLL over the labels counted
    on every data rank) and the projector gradients summed over the data
    ranks equal dmi_tpu's unsharded value_and_grad."""
    results, fam_ref, _ = spmd
    got = results[f"{key(shape)}/family/{name}"]
    loss, grads = fam_ref[name]
    _close(got["loss"], loss, 1e-5)
    assert len(got["grads"]) == len(grads)
    top = max(np.abs(g).max() for g in grads)
    assert top > 0
    for g, want in zip(got["grads"], grads):
        _close(g.numpy(), want, 1e-5, scale=top)


TRAINERS = ["projector", "projector_dropout", "lora", "hypernet", "hypernet_coalesced",
            "fewshot_generated", "fewshot_hypernet"]
TRAINER_CASES = [(s, name) for s in SHAPES for name in TRAINERS]


@pytest.mark.parametrize("shape,name", TRAINER_CASES, ids=[f"{key(s)}-{n}" for s, n in
                                                           TRAINER_CASES])
def test_trainer_on_a_mesh_follows_the_reference(spmd, shape, name):
    """4 micro-steps of each trainer with mesh_shape: per-step (or
    per-window) losses and the trainable leaves after them against dmi_tpu's
    single-device trainer (projector and LoRA at dropout 0, stage 2 with
    JAX's rotations) or the port's one-rank trainer (dropout, the port's
    rotations, coalesced windows, few-shot); the eval loss where asked."""
    results, _, refs = spmd
    got, ref = results[f"{key(shape)}/trainer/{name}"], refs[name]
    assert len(got["losses"]) == len(ref["losses"])
    for i, (a, b) in enumerate(zip(got["losses"], ref["losses"])):
        _close(a, b, 1e-5 if i < 2 else 1e-4)
    want = ref["params"]
    assert len(got["params"]) == len(want)
    for a, b in zip(got["params"], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PARAM_TOL)
    if "eval" in ref:
        _close(got["eval"], ref["eval"], 1e-4)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] > 1], ids=key)
def test_data_ranks_hold_uneven_label_counts(spmd, shape):
    """The stage-1 step's data ranks count different numbers of valid labels
    (the (sum, count) reduction is what keeps the trainers exact)."""
    counts = spmd[0][f"{key(shape)}/trainer/projector"]["counts"]
    m = shape[1]
    per_data = counts[::m]
    assert len(set(per_data)) > 1, per_data


GENERATE_CASES = [(s, name) for s in SHAPES for name in ("projector", "hypernet")]


@pytest.mark.parametrize("shape,name", GENERATE_CASES, ids=[f"{key(s)}-{n}" for s, n in
                                                            GENERATE_CASES])
def test_mesh_generate_decodes_dmi_tpu_captions(spmd, shape, name):
    """generate on the mesh (each data rank's rows on the sharded tree,
    gathered; rank 0 scores them) decodes dmi_tpu's greedy captions: the
    projector's test split (LM weights x10, so tokens vary) and the stage-2
    hypernet's eval split."""
    results, _, refs = spmd
    got = results[f"{key(shape)}/trainer/{name}"]["preds"]
    assert got == refs[name]["preds"]
    if name == "projector":
        assert len({p for ps in got.values() for p in ps}) > 1


@pytest.mark.parametrize("shape", SHAPES, ids=key)
def test_dcp_checkpoint_round_trips_on_the_mesh(spmd, shape):
    """save_pytree_dcp / load_pytree_dcp into sharded_like's target: every
    leaf of the sharded tree, the projector and the step come back bit for
    bit, and the checkpoint holds each model rank's shards as its own
    entries (tests/test_resume.py:81-127's orbax cases)."""
    got = spmd[0][f"{key(shape)}/dcp"]
    assert got["bit_equal"]
    assert got["model_ranks"] == [f"model{r}of{shape[1]}" for r in range(shape[1])]


def test_dcp_round_trip_in_one_process(tmp_path):
    """Without a process group: a projector and a step count written and
    read back whole, with and without a restore target."""
    params = {"layers": [{"w": torch.randn(4, 3), "b": torch.randn(3)}], "step": 7}
    path = str(tmp_path / "ck")
    tckpt.save_pytree_dcp(path, params)
    back = tckpt.load_pytree_dcp(path, tckpt.sharded_like(params))
    assert back["step"] == 7
    assert torch.equal(back["layers"][0]["w"], params["layers"][0]["w"])
    whole = tckpt.load_pytree_dcp(path)
    assert torch.equal(whole["layers"]["0"]["b"], params["layers"][0]["b"])
    assert whole["step"] == 7


def test_dryrun_at_world_2(tmp_path):
    """python -m dmi_tpu_torch.training.dryrun --world 2 --device cpu: the
    projector and hypernet steps and the sharded decode on two gloo ranks."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    run = subprocess.run([sys.executable, "-m", "dmi_tpu_torch.training.dryrun", "--world",
                          "2", "--device", "cpu"], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [line for line in run.stdout.splitlines() if line.startswith("dryrun OK")]
    assert len(lines) == 3, run.stdout
    assert "mesh (1, 2)" in lines[0] and "gloo ranks on cpu" in lines[0]


def test_dryrun_refuses_to_run_without_a_card(monkeypatch):
    """The dry run's default device is the card: without one it raises
    before it starts a rank, and never falls back to the CPU."""
    from dmi_tpu_torch.training import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--world", "2"])
    assert dryrun.rank_setup(1, 2, "cpu") == ("gloo", torch.device("cpu"))


def test_train_projector_cli_under_a_launcher(tmp_path):
    """`python -m dmi_tpu_torch.train_projector cfg --device cpu` in two
    processes with torchrun's variables (MASTER_ADDR localhost, a free port,
    RANK, WORLD_SIZE) and mesh_shape [2, 1] in the config: both join one
    gloo group through init_distributed and exit 0; rank 0 alone writes the
    results JSON and the best checkpoint, and its test captions are a
    single-process run's; without mesh_shape the two ranks are refused."""
    import socket

    from tests.test_torch_train import _e2e_config

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        generate_dataset("data", "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=32, n_train=4,
                         n_eval=2, seed=0)
    finally:
        os.chdir(cwd)
    results = {}
    for name, mesh in (("single", None), ("mesh", [2, 1]), ("refused", None)):
        work = tmp_path / name
        work.mkdir()
        os.symlink(tmp_path / "data", work / "data")
        cfg = _e2e_config(work, epochs_l=[1], save_steps=4, eval_steps=4, generate_steps=4,
                          **({"mesh_shape": mesh} if mesh else {}))
        world = 1 if name == "single" else 2
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "PYTHONPATH": str(REPO), "WANDB_MODE": "disabled",
               "OMP_NUM_THREADS": "1"}
        if world > 1:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                       LOCAL_WORLD_SIZE="2")
        procs = [subprocess.Popen([sys.executable, "-m", "dmi_tpu_torch.train_projector", cfg,
                                   "--device", "cpu"], cwd=work,
                                  env={**env, **({"RANK": str(r), "LOCAL_RANK": str(r)}
                                                 if world > 1 else {})},
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        codes = [p.returncode for p in procs]
        if name == "refused":
            assert codes == [1, 1] and all("need mesh_shape" in o for o in outs), outs
            continue
        assert codes == [0] * world, "\n".join(o[-3000:] for o in outs)
        out_files = sorted(os.listdir(work / "outputs"))
        assert len([f for f in out_files if f.endswith("-seed7-results.json")]) == 1
        assert len(os.listdir(work / "checkpoints")) == 1
        run_file = work / "outputs" / "projector:cfg_projector_smoke-dszfull-seed7-results.json"
        results[name] = json.loads(run_file.read_text())
    assert results["mesh"]["preds"] == results["single"]["preds"]
    assert results["mesh"]["ids"] == results["single"]["ids"]
