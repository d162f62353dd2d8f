"""One rank of tests/test_torch_parallel_spmd.py's gloo worlds.

    python tests/torch_spmd_worker.py RANK WORLD STORE INPUTS.npz MANIFEST.json OUT.npz

Every rank of a world runs this script in its own process (the test starts
them with subprocess, never by fork: the test process holds JAX).  It
imports torch and the port only: no jax, no tests.conftest, nothing of
dmi_tpu.  It joins the world through a file:// store, and for every mesh
shape of its world serves every case of the manifest on the CPU over gloo:
the port's Captioner (and, for grouped W4A8 scales, mmmodel.caption_generate
over trees it shards itself) on the test's seeded weights and requests.  It
also runs the collectives' unit checks of the traps (global quantization
scales, whole-width norms, vocab gathers, the embedding lookup, cross-shard
ties) and, at world 4, the (replica, data, model) mesh with
LOCAL_WORLD_SIZE=2.  Rank 0 writes every result to OUT.npz; every rank
checks that its ids equal rank 0's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dmi_tpu_torch import bridge, parallel  # noqa: E402
from dmi_tpu_torch.models import decode as dec  # noqa: E402
from dmi_tpu_torch.models import llama, mmmodel  # noqa: E402
from dmi_tpu_torch.models import projector as proj  # noqa: E402
from dmi_tpu_torch.models.quant import quantize_act, quantize_llama  # noqa: E402
from dmi_tpu_torch.ops import l2_normalize  # noqa: E402
from dmi_tpu_torch.parallel import sharding  # noqa: E402
from dmi_tpu_torch.serve import Captioner  # noqa: E402

# mode -> (Captioner kwargs, caption_ids kwargs); "w4a8_g16" runs the model
# functions over a tree quantized with group_size 16
SAMPLE = dict(temperature=0.8, top_k=10, top_p=0.9, seed=3)
MODES = {
    "greedy": ({}, {}),
    "batch_first": ({"batch_first": True}, {}),
    "bulk": ({}, {"engine": "bulk"}),
    "int8": ({"int8": True}, {}),
    "w8a8": ({"int8": "w8a8"}, {}),
    "w4a8": ({"int8": "w4a8"}, {}),
    "sampled": ({}, SAMPLE),
    "bulk_sampled": ({}, {"engine": "bulk", **SAMPLE}),
    "spec": ({"speculative": 2}, {}),
    "spec_bulk": ({"speculative": 2}, {"engine": "bulk"}),
    "spec_sampled": ({"speculative": 2}, SAMPLE),
}


def _tree(arrays, prefix: str) -> dict:
    """The nested numpy tree saved under `prefix/` (keys joined by '/')."""
    out: dict = {}
    for key in arrays.files:
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arrays[key]
    return out


def _config(fields: dict) -> llama.LlamaConfig:
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    return llama.LlamaConfig(**kw, dtype=torch.float32)


def _case(arrays, name: str, fields: dict):
    cfg = _config(fields)
    params = bridge.llm_params_from_jax(_tree(arrays, f"{name}/llm"))
    pp = _tree(arrays, f"{name}/proj")
    pparams = {"layers": [{k: torch.from_numpy(np.array(v)) for k, v in pp["layers"][str(i)].items()}
                          for i in range(len(pp["layers"]))]}
    spec = proj.ProjectorSpec(mm_dim=pparams["layers"][0]["w"].shape[0], lm_dim=cfg.hidden_size)
    return cfg, params, spec, pparams


def _grouped_ids(mesh, cfg, params, spec, pparams, embs, prefix, budget, pad):
    """Greedy ids of a W4A8 tree with scales per 16 contraction rows: the
    whole tree quantized, then sharded; each data rank decodes its rows."""
    fused = llama.fuse_projections(params)
    tree = parallel.shard_llm_params(mesh, quantize_llama(fused, bits=4, group_size=16), cfg)
    pre = parallel.shard_llm_params(mesh, fused, cfg)
    shard = tree["shard"]
    lo, hi = shard.rows(embs.shape[0])
    soft = proj.apply(spec, pparams, l2_normalize(torch.from_numpy(embs[lo:hi])))
    ids = torch.as_tensor(prefix)[None].expand(hi - lo, -1)
    out = mmmodel.caption_generate(cfg, tree, soft, ids, budget, pad, prefill_params=pre)
    return shard.gather_rows(out)


def _unit_checks(mesh, arrays) -> dict:
    """The traps' numeric checks at this mesh: each value is a max abs
    error against the one-rank computation (or a match flag)."""
    cfg = _config(json.loads(str(arrays["unit/cfg"])))
    vocab = int(arrays["unit/embed"].shape[0])
    sh = sharding.make_shard(mesh, cfg, vocab)
    out = {}
    # trap 3: a whole-width norm over this rank's q columns and its k columns
    # (a copy of one kv head where the model axis is wider than the kv heads)
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    for name, width, heads, kv in (("q", nh * hd, nh, False), ("k", nkv * hd, nkv, True)):
        x = torch.from_numpy(arrays[f"unit/norm_{name}_x"])
        scale = torch.from_numpy(arrays[f"unit/norm_{name}_s"])
        lo, hi = sharding._head_cols(width, heads, sh, kv)
        mine = llama.rms_norm(x[:, lo:hi], scale[lo:hi], 1e-6, sh)
        out[f"norm_{name}"] = (mine - llama.rms_norm(x, scale, 1e-6)[:, lo:hi]).abs().max()
    # trap 1: row-parallel int8 products with one-rank scales, from a tree
    # quantized whole and then sharded
    w = torch.from_numpy(arrays["unit/w_down"])  # [K, H]
    h = torch.from_numpy(arrays["unit/h"])  # [K, B]
    K = w.shape[0]
    lo, hi = sh.r * K // sh.m, (sh.r + 1) * K // sh.m
    for label, kw in (("w8", dict(native=True)), ("w4", dict(bits=4)),
                      ("w4g", dict(bits=4, group_size=16))):
        whole = quantize_llama({"embed": torch.zeros(1, 1), "final_norm": torch.ones(1),
                                "layers": [{"w_down": w}]}, quantize_embed=False,
                               **kw)["layers"][0]["w_down"]
        mine = sharding._shard_rows(whole, sh, "w_down")
        got = dec._mm_bl(mine, h[lo:hi], plain=True, shard=sh)
        out[f"{label}_row"] = (got - dec._mm_bl(whole, h, plain=True)).abs().max()
        # the int8 activations themselves are the one-rank ones
        hq, a = quantize_act(h[lo:hi], axis=0, reduce=sh.pmax)
        hq1, a1 = quantize_act(h, axis=0)
        out[f"{label}_act_equal"] = torch.tensor(float(torch.equal(hq, hq1[lo:hi])
                                                       and torch.equal(a, a1)))
    # the vocab-sharded lookup, gather and head merge
    embed = torch.from_numpy(arrays["unit/embed"])
    ids = torch.from_numpy(arrays["unit/ids"])
    rows = sh.embed(ids, lambda i: embed[sh.v0:sh.v1][i])
    out["embed"] = (rows - embed[ids]).abs().max()
    logits = torch.from_numpy(arrays["unit/logits"])  # [V, B]
    out["gather"] = (sh.gather_vocab(logits[sh.v0:sh.v1], 0) - logits).abs().max()
    out["gather_last"] = (sh.gather_vocab(logits.t()[:, sh.v0:sh.v1], -1) - logits.t()).abs().max()
    # trap 5: equal best scores in every shard -> the smallest global id
    B = logits.shape[1]
    tie = sh.argmax(torch.ones(B), torch.zeros(B, dtype=torch.long))
    out["tie_lowest"] = torch.tensor(float(bool((tie == 0).all())))
    best, idx = logits[sh.v0:sh.v1].max(dim=0)
    out["argmax"] = torch.tensor(float(torch.equal(sh.argmax(best, idx), logits.argmax(dim=0))))
    return {k: float(v) for k, v in out.items()}


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    store, inputs, manifest, out_path = argv[3:7]
    torch.set_num_threads(1)
    parallel.init_distributed(init_method=f"file://{store}", rank=rank, world_size=world,
                              backend="gloo")
    with open(manifest) as f:
        spec_ = json.load(f)
    arrays = np.load(inputs)
    embs, prefix = arrays["embs"], arrays["prefix"]
    budget, pad, bs = spec_["budget"], spec_["pad"], spec_["batch_size"]
    results = {}
    for shape in spec_["meshes"][str(world)]:
        shape = tuple(shape)
        mesh = parallel.make_mesh(shape, device="cpu")
        for name, fields in spec_["cases"].items():
            cfg, params, spec, pparams = _case(arrays, name, fields)
            for mode in spec_["modes"][name]:
                if mode == "w4a8_g16":
                    ids = _grouped_ids(mesh, cfg, params, spec, pparams, embs, prefix, budget,
                                       pad)
                else:
                    kw, ckw = MODES[mode]
                    cap = Captioner(cfg, params, spec, pparams, max_new_tokens=budget,
                                    batch_size=bs, mesh_shape=shape, prefix_ids=prefix,
                                    pad_token_id=pad, **kw)
                    ids = cap.caption_ids(embs, **ckw)
                results[f"{shape}/{name}/{mode}"] = ids.numpy()
        for key, err in _unit_checks(mesh, arrays).items():
            results[f"{shape}/unit/{key}"] = np.float64(err)
    if world == 4:  # LOCAL_WORLD_SIZE=2: two "nodes" of two ranks
        mm = parallel.make_multihost_mesh(ici_shape=(1, 2), device="cpu")
        rows = parallel.shard_batch(mm, {"x": torch.arange(8)})["x"]
        mine = {"coord": mm.get_coordinate(), "axes": list(parallel.batch_axes(mm)),
                "shape": list(mm.mesh.shape), "rows": rows.tolist()}
        every = [None] * world
        dist.all_gather_object(every, mine)
        results["multihost"] = np.asarray(json.dumps(every))
    # every rank holds every row's ids: they must be rank 0's
    mine = {k: v for k, v in results.items() if "/unit/" not in k and k != "multihost"}
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    for other in gathered:
        for k, v in other.items():
            if not np.array_equal(v, mine[k]):
                raise AssertionError(f"rank {rank}: {k} differs from another rank's")
    if rank == 0:
        np.savez(out_path, **results)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
