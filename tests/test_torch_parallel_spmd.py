"""Tensor- and data-parallel serving of the port held against dmi_tpu on
the CPU, over gloo (ROADMAP A.10a).

Each world (2 and 4 ranks) is spawned once, in a module-scoped fixture:
every rank is a `python tests/torch_spmd_worker.py` process (subprocess,
never fork: this process holds JAX), joined through a file:// store in
tmp_path, one CPU thread each, under a timeout, so that a hang fails these
tests and not the suite.  The worker serves every case at every mesh of its
world -- (2, 1) and (1, 2) at world 2, (2, 2) and (1, 4) at world 4 -- and
writes the ids to an npz.  Meanwhile this process computes dmi_tpu's ids for
the same seeded weights and requests (dmi_tpu's sharded runs equal its
unsharded ones by its own tests, tests/test_parallel.py).

The cases: the eight families of tests/test_parallel.py:126 and
deepseek-v2 (MLA, the deepseek MoE, a shared expert), plus llama, at f32
with a vocab of 253 rows (blocks of 127/126 at m = 2, 64/64/64/61 at
m = 4) and 4/2 heads (m = 4 copies each kv head to two ranks).  Greedy
tokens on the batch-last and batch-first loops and the bulk engine, and,
on llama, W8A8, W4A8 at group_size None and 16, int8=True and greedy
speculation (batch and bulk), must equal dmi_tpu's exactly.  Sampled tokens
are the port's request-indexed draws, which never equal dmi_tpu's threefry
draws (tests/test_torch_sampling.py holds them by law): they must equal the
port's one-rank ids exactly.
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

from dmi_tpu.models import llama as jllama
from dmi_tpu.models import mmmodel as jmm
from dmi_tpu.models import projector as jproj
from dmi_tpu.models import quant as jq
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.ops import l2_normalize
from dmi_tpu_torch.serve import Captioner

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_spmd_worker.py"
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
TIMEOUT = 600  # seconds a world may take
PAD, BUDGET, BATCH = 0, 10, 8
PREFIX = np.asarray([3, 7, 9])
N_REQUESTS = 6  # one batch of 8, its last two rows padding
TINY = dict(vocab_size=253, hidden_size=64, n_layers=2, n_heads=4, n_kv=2, intermediate=128,
            eos=(5,))
WINDOW = 8  # binds from position 8 of a prompt of 4 and 10 new tokens
FAMILIES = {
    "llama": lambda: jllama.tiny_config(**TINY),
    "qwen2": lambda: jllama.tiny_qwen2_config(**TINY),
    "gemma2": lambda: jllama.tiny_gemma2_config(sliding_window=WINDOW, **TINY),
    "qwen3": lambda: jllama.tiny_qwen3_config(**TINY),
    "olmo2": lambda: jllama.tiny_olmo2_config(**TINY),
    "granite": lambda: jllama.tiny_granite_config(**TINY),
    "gemma3": lambda: jllama.tiny_gemma3_config(sliding_window=WINDOW, **TINY),
    "mixtral": lambda: jllama.tiny_mixtral_config(**TINY),
    "olmoe": lambda: jllama.tiny_olmoe_config(**TINY),
    "deepseek": lambda: jllama.tiny_deepseek_config(n_experts=4, n_shared=1, routed_scale=2.0,
                                                    **TINY),
}
FAMILY_MODES = ["greedy", "batch_first", "bulk"]
LLAMA_MODES = FAMILY_MODES + ["int8", "w8a8", "w4a8", "w4a8_g16", "sampled", "bulk_sampled",
                              "spec", "spec_bulk", "spec_sampled"]
QUANT = {"int8": dict(), "w8a8": dict(native=True), "w4a8": dict(bits=4),
         "w4a8_g16": dict(bits=4, group_size=16)}
SAMPLE = dict(temperature=0.8, top_k=10, top_p=0.9, seed=3)
# modes whose reference is the port's one-rank run (the port's own draws)
ONE_RANK = {"sampled": ({}, SAMPLE), "bulk_sampled": ({}, {"engine": "bulk", **SAMPLE}),
            "spec_sampled": ({"speculative": 2}, SAMPLE)}


def _modes(name):
    return LLAMA_MODES if name == "llama" else FAMILY_MODES


def _models(name, seed):
    """dmi_tpu's init of the family with the layer weights (and biases, and
    an untied head) scaled to std 0.2 and the norms perturbed from numpy,
    so that greedy tokens vary; a 2-layer projector (mm 16)."""
    jcfg = FAMILIES[name]()
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(key, a):
        if key.startswith(("w", "b", "moe")) or key == "lm_head":
            return (a * 10.0).astype(a.dtype)
        if "norm" in key or key.startswith("ln"):
            return (a * (1 + 0.3 * rng.normal(size=a.shape))).astype(a.dtype)
        return a

    tree["layers"] = {k: perturb(k, v) for k, v in tree["layers"].items()}
    tree["final_norm"] = perturb("final_norm", tree["final_norm"])
    jspec = jproj.ProjectorSpec(mm_dim=16, lm_dim=jcfg.hidden_size, n_layers=2, dropout=0.0)
    jpp = jax.tree.map(np.asarray, jproj.init(jax.random.key(seed + 1), jspec))
    return jcfg, tree, jspec, jpp


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = np.asarray(tree)


def _fields(jcfg) -> dict:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name not in ("dtype", "attention_impl")}
    return {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}


def _dmi_tpu_ids(jcfg, tree, jspec, jpp, embs, quant=None):
    """dmi_tpu's greedy caption ids: projector, then caption_generate over
    the fused tree (quantized whole where asked, as dmi_tpu's Captioner
    quantizes it)."""
    params = jllama.fuse_projections(jax.tree.map(jnp.asarray, tree))
    prefill = None
    if quant is not None:
        # int8=True widens its int8 weights in the prompt pass too; W8A8 and
        # W4A8 prefill on the unquantized tree
        prefill = params if quant else None
        params = jq.quantize_llama(params, **quant)
    soft = jproj.apply(jspec, jax.tree.map(jnp.asarray, jpp), jnp.asarray(embs), train=False)
    prefix = jnp.asarray(np.tile(PREFIX[None], (embs.shape[0], 1)).astype(np.int32))
    return np.asarray(jmm.caption_generate(jcfg, params, soft, prefix, BUDGET, PAD,
                                           prefill_params=prefill))


def _unit_inputs(out):
    """Inputs of the worker's trap checks: whole-width norm rows, a w_down
    and its activations, an embedding, ids and logits over 253 rows."""
    rng = np.random.default_rng(7)
    cfg = jllama.tiny_config(**TINY)
    out["unit/cfg"] = np.asarray(json.dumps(_fields(cfg)))
    for name, width in (("q", 4 * 16), ("k", 2 * 16)):
        out[f"unit/norm_{name}_x"] = rng.normal(size=(3, width)).astype(np.float32)
        out[f"unit/norm_{name}_s"] = (1 + 0.3 * rng.normal(size=width)).astype(np.float32)
    out["unit/w_down"] = (rng.normal(size=(128, 64)) * 0.1).astype(np.float32)
    # per-row amax varying along K, so that a rank's own amax is not the row's
    h = rng.normal(size=(128, 5)) * np.linspace(0.2, 3.0, 128)[:, None]
    out["unit/h"] = h.astype(np.float32)
    out["unit/embed"] = rng.normal(size=(253, 8)).astype(np.float32)
    out["unit/ids"] = np.asarray([0, 63, 64, 126, 127, 128, 191, 192, 252, 5], np.int64)
    out["unit/logits"] = rng.normal(size=(253, 5)).astype(np.float32)


def _spawn_world(world, workdir, inputs, manifest):
    """Start the `world` ranks; returns (processes, out path)."""
    store = workdir / f"store{world}"
    out = workdir / f"world{world}.npz"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    if world == 4:
        env["LOCAL_WORLD_SIZE"] = "2"
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(key, None)
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
    """Both worlds' results, dmi_tpu's ids and the port's one-rank ids."""
    workdir = tmp_path_factory.mktemp("spmd")
    embs = l2_normalize(torch.from_numpy(
        np.random.default_rng(11).normal(size=(N_REQUESTS, 16)).astype(np.float32))).numpy()
    arrays = {"embs": embs, "prefix": PREFIX}
    models, cases = {}, {}
    for i, name in enumerate(FAMILIES):
        models[name] = _models(name, seed=20 + i)
        jcfg, tree, _, jpp = models[name]
        _flat(f"{name}/llm", tree, arrays)
        _flat(f"{name}/proj", jpp, arrays)
        cases[name] = _fields(jcfg)
    _unit_inputs(arrays)
    inputs, manifest = workdir / "inputs.npz", workdir / "manifest.json"
    np.savez(inputs, **arrays)
    manifest.write_text(json.dumps({
        "meshes": {str(w): [list(s) for s in shapes] for w, shapes in MESHES.items()},
        "cases": cases, "modes": {name: _modes(name) for name in FAMILIES},
        "budget": BUDGET, "pad": PAD, "batch_size": BATCH}))
    worlds = {w: _spawn_world(w, workdir, inputs, manifest) for w in MESHES}

    # meanwhile: the references
    want = {}
    for name, (jcfg, tree, jspec, jpp) in models.items():
        want[(name, None)] = _dmi_tpu_ids(jcfg, tree, jspec, jpp, embs)
        if name == "llama":
            for mode, quant in QUANT.items():
                want[(name, mode)] = _dmi_tpu_ids(jcfg, tree, jspec, jpp, embs, quant)
            tcfg, tparams = bridge.config_from_jax(jcfg), bridge.llm_params_from_jax(tree)
            tpp = bridge.projector_params_from_jax(jpp)
            tspec = tproj.ProjectorSpec(mm_dim=16, lm_dim=jcfg.hidden_size)
            for mode, (kw, ckw) in ONE_RANK.items():
                cap = Captioner(tcfg, tparams, tspec, tpp, max_new_tokens=BUDGET,
                                batch_size=BATCH, prefix_ids=PREFIX, pad_token_id=PAD, **kw)
                want[(name, mode)] = cap.caption_ids(embs, **ckw).numpy()
    results = {}
    for world, (procs, out) in worlds.items():
        _wait(procs, TIMEOUT)
        results.update(dict(np.load(out)))
    return results, want


def _want(want, name, mode):
    if mode in ONE_RANK:
        return want[(name, mode)]
    return want[(name, mode if mode in QUANT else None)]


CASES = [(shape, name, mode) for shapes in MESHES.values() for shape in shapes
         for name in FAMILIES for mode in _modes(name)]


@pytest.mark.parametrize("shape,name,mode", CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}-{m}" for s, n, m in CASES])
def test_sharded_ids_equal_the_reference(spmd, shape, name, mode):
    """Every rank of the mesh returns the reference's ids for every request,
    in row order (the worker checks that the ranks agree)."""
    results, want = spmd
    ref = _want(want, name, mode)
    got = results[f"{shape}/{name}/{mode}"]
    assert got.shape == (N_REQUESTS, BUDGET)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(ref)) > 3  # tokens vary: the comparison has teeth


UNIT = ["norm_q", "norm_k", "w8_row", "w4_row", "w4g_row", "embed", "gather", "gather_last"]
FLAGS = ["w8_act_equal", "w4_act_equal", "w4g_act_equal", "tie_lowest", "argmax"]
SHAPES = [s for shapes in MESHES.values() for s in shapes]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[0]}x{s[1]}" for s in SHAPES])
def test_collectives_hold_the_traps(spmd, shape):
    """Trap 3: the whole-width norm over this rank's q or k columns (a kv
    head's copy at m > nkv) equals the one-rank norm's columns (the sum of
    squares is psummed).  Trap 1: a row-parallel int8 product over a tree
    quantized whole, then sharded, equals the one-rank product to f32
    rounding, and its int8 activations and scales are the one-rank ones
    (the amax is the max over the model group).  The vocab-sharded lookup
    and gathers are exact; trap 5: equal best scores in every shard merge
    to the smallest global id, and the merged argmax is the whole one."""
    results, _ = spmd
    unit = {k: float(results[f"{shape}/unit/{k}"]) for k in UNIT + FLAGS}
    for key in ("norm_q", "norm_k", "w8_row", "w4_row", "w4g_row"):
        assert unit[key] <= 1e-5, (key, unit[key])
    for key in ("embed", "gather", "gather_last"):
        assert unit[key] == 0.0, (key, unit[key])
    for key in FLAGS:
        assert unit[key] == 1.0, key


def test_replica_axis_follows_the_node_groups(spmd):
    """World 4 with LOCAL_WORLD_SIZE=2 and ici_shape (1, 2): a (2, 1, 2)
    (replica, data, model) mesh whose replica coordinate is rank // 2, as
    the nodes' ranks run (dmi_tpu's tests/dist_worker.py:109-113 groups by
    process); the batch axes are replica and data, and a batch of 8 rows
    splits into the two replicas' halves, the same on a replica's two
    model ranks."""
    results, _ = spmd
    every = json.loads(str(results["multihost"]))
    for rank, info in enumerate(every):
        assert info["shape"] == [2, 1, 2]
        assert info["coord"] == [rank // 2, 0, rank % 2]
        assert info["axes"] == ["replica", "data"]
        assert info["rows"] == list(range(4 * (rank // 2), 4 * (rank // 2) + 4))
