"""The port's parallel package in one process: meshes, the distributed
entry, dmi_tpu's sharding table, the slicing of every leaf kind and the
merge of the fused head's per-shard (score, index) pairs.  The collectives
across ranks run in tests/test_torch_parallel_spmd.py."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmi_tpu.parallel.sharding import llm_param_specs as jax_specs
from dmi_tpu_torch import parallel
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models.quant import quantize_llama, unpack_w4
from dmi_tpu_torch.ops.cuda import decode_mlp as dm
from dmi_tpu_torch.ops.cuda.head_argmax import _head_argmax_plain
from dmi_tpu_torch.parallel import collectives, sharding

torch.set_num_threads(1)


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo process group, torn down after the test."""
    assert parallel.init_distributed(init_method=f"file://{tmp_path / 'store'}", rank=0,
                                     world_size=1, backend="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        parallel.make_mesh((1, 1), device="cpu")


def test_make_mesh_shapes_and_errors(world_of_one):
    mesh = parallel.make_mesh(device="cpu")  # (world, 1): pure data parallelism
    assert tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    assert parallel.make_mesh((1,), device="cpu").mesh_dim_names == ("data",)
    assert parallel.batch_axes(mesh) == ("data",)
    for shape in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="ranks"):
            parallel.make_mesh(shape, device="cpu")
    if not torch.cuda.is_available():  # no device given: this rank's card, or an error
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh((1, 1))


def test_init_distributed_is_a_no_op_without_env(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.init_distributed() is False
    assert not dist.is_initialized()


def test_one_rank_mesh_shards_nothing(world_of_one):
    """A (1, 1) mesh: the local tree holds every weight, and greedy ids
    through it equal the whole tree's; shard_batch and replicate keep every
    row."""
    cfg = llama.tiny_config()
    params = llama.fuse_projections(llama.init(cfg, torch.Generator().manual_seed(0)))
    mesh = parallel.make_mesh((1, 1), device="cpu")
    local = parallel.shard_llm_params(mesh, params, cfg)
    assert local["shard"].m == 1 and local["shard"].local(cfg) == cfg
    for a, b in zip(local["layers"], params["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in b)
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1))
    from dmi_tpu_torch.models import decode as dec
    assert torch.equal(dec.greedy_generate_bl(cfg, local, x, 4, 0),
                       dec.greedy_generate_bl(cfg, params, x, 4, 0))
    batch = {"x": torch.arange(6)}
    assert torch.equal(parallel.shard_batch(mesh, batch)["x"], batch["x"])
    assert torch.equal(parallel.replicate(mesh, batch)["x"], batch["x"])
    assert parallel.batch_sharding(mesh, 3) == (("data",), None, None)
    with pytest.raises(ValueError, match="already sharded"):
        parallel.shard_llm_params(mesh, local, cfg)


@pytest.mark.parametrize("expert_axis", ["model", "expert"])
def test_llm_param_specs_equal_dmi_tpus_table(expert_axis):
    """Key for key, the port's table is dmi_tpu's PartitionSpecs as tuples."""
    want, got = jax_specs(expert_axis=expert_axis), sharding.llm_param_specs(expert_axis)
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for key in ("embed", "final_norm", "lm_head"):
        assert got[key] == tuple(want[key]), key
    for key, spec in want["layers"].items():
        assert got["layers"][key] == tuple(spec), key


# ---------------------------------------------------------------------------
# Slicing per leaf kind (plan_shard: the Shard of rank r of m, no group)
# ---------------------------------------------------------------------------

def _tree(cfg, seed=0):
    params = llama.init(cfg, torch.Generator().manual_seed(seed))
    return llama.fuse_projections(params)


def _shards(cfg, tree, m):
    V = sharding.vocab_of(tree)
    return [sharding.shard_tree(tree, cfg, sharding.plan_shard(cfg, V, m, r))
            for r in range(m)]


def _cat(parts, dim):
    return torch.cat(parts, dim=dim)


@pytest.mark.parametrize("m", [2, 4])
def test_bf16_tree_slices_and_rebuilds(m):
    """Columns (w_qkv's q part by heads, w_gu's gate and up halves) and rows
    (wo, w_down) of every rank put back together give the whole tree; the
    fused w_qkv of a shard is [q_r | k_r | v_r]; at m = 4 > nkv = 2 each rank
    holds a copy of the kv head its query heads read."""
    cfg = llama.tiny_config(vocab_size=253)
    tree = _tree(cfg)
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    shards = _shards(cfg, tree, m)
    whole = tree["layers"][0]
    q, k, v = whole["w_qkv"].split([nh * hd, nkv * hd, nkv * hd], dim=-1)
    gate, up = whole["w_gu"].chunk(2, dim=-1)
    local_q, local_k = [], []
    for r, sh in enumerate(shards):
        lw, s = sh["layers"][0], sh["shard"]
        lc = s.local(cfg)
        qr, kr, vr = lw["w_qkv"].split([lc.num_attention_heads * hd,
                                        lc.num_key_value_heads * hd,
                                        lc.num_key_value_heads * hd], dim=-1)
        local_q.append(qr)
        local_k.append(kr)
        kv_head = r * nkv // m if m <= nkv else r // (m // nkv)
        if m > nkv:
            assert s.kv_rep == m // nkv and lc.num_key_value_heads == 1
            assert torch.equal(kr, k[:, kv_head * hd:(kv_head + 1) * hd])
            assert torch.equal(vr, v[:, kv_head * hd:(kv_head + 1) * hd])
        g, u = lw["w_gu"].chunk(2, dim=-1)
        assert torch.equal(g, gate.chunk(m, dim=-1)[r]) and torch.equal(u, up.chunk(m, dim=-1)[r])
        assert lw["w_qkv"].is_contiguous() and lw["wo"].is_contiguous()
        assert torch.equal(lw["ln_attn"], whole["ln_attn"])
    assert torch.equal(_cat(local_q, -1), q)
    if m <= nkv:
        assert torch.equal(_cat(local_k, -1), k)
    assert torch.equal(_cat([sh["layers"][0]["wo"] for sh in shards], 0), whole["wo"])
    assert torch.equal(_cat([sh["layers"][0]["w_down"] for sh in shards], 0), whole["w_down"])


@pytest.mark.parametrize("m", [2, 4])
def test_ragged_vocab_blocks_are_never_padded(m):
    """V 253: blocks of ceil(V / m) rows, the last one shorter; embed rows
    and an untied lm_head's columns of every rank rebuild the whole."""
    cfg = dataclasses.replace(llama.tiny_config(vocab_size=253), tie_word_embeddings=False)
    tree = _tree(cfg)
    shards = _shards(cfg, tree, m)
    block = -(-253 // m)
    sizes = [sh["embed"].shape[0] for sh in shards]
    assert sizes == [block] * (m - 1) + [253 - block * (m - 1)]
    assert torch.equal(_cat([sh["embed"] for sh in shards], 0), tree["embed"])
    assert torch.equal(_cat([sh["lm_head"] for sh in shards], 1), tree["lm_head"])
    assert [(sh["shard"].v0, sh["shard"].v1) for sh in shards] == [
        (r * block, min(253, (r + 1) * block)) for r in range(m)]


@pytest.mark.parametrize("mode", ["q", "q8"])
def test_int8_leaves_keep_one_rank_scales(mode):
    """int8=True ("q") and W8A8 ("q8") trees quantized whole: a row-sharded
    weight keeps its per-output-column scales whole, a column-sharded one
    takes its columns' scales; the embed's row scales follow its rows."""
    cfg = llama.tiny_config(vocab_size=253)
    tree = quantize_llama(_tree(cfg), native=mode == "q8")
    whole = tree["layers"][0]
    for r, sh in enumerate(_shards(cfg, tree, 2)):
        lw = sh["layers"][0]
        assert torch.equal(lw["w_down"]["s"], whole["w_down"]["s"])
        assert torch.equal(lw["w_down"][mode], whole["w_down"][mode].chunk(2, dim=0)[r])
        assert torch.equal(lw["wo"]["s"], whole["wo"]["s"])
        g, _ = lw["w_gu"]["s"].chunk(2, dim=-1)
        assert torch.equal(g, whole["w_gu"]["s"].chunk(2, dim=-1)[0].chunk(2, dim=-1)[r])
        v0, v1 = sh["shard"].v0, sh["shard"].v1
        assert torch.equal(sh["embed"]["s"], tree["embed"]["s"][v0:v1])


@pytest.mark.parametrize("group_size", [None, 16])
def test_packed_int4_rows_repack_to_contiguous_blocks(group_size):
    """W4A8: pack_w4 puts rows k and k + K/2 in one byte, so a rank's rows
    are unpacked, sliced and packed again: its unpacked rows are the whole
    weight's contiguous block (slicing the packed K/2 axis would give two
    half blocks).  Columns slice their bytes as they are.  Grouped scales
    keep the rank's G/m groups; a group size that does not divide each
    shard's rows is refused."""
    cfg = llama.tiny_config(vocab_size=253)
    tree = quantize_llama(_tree(cfg), bits=4, group_size=group_size)
    whole = tree["layers"][0]
    down = unpack_w4(whole["w_down"]["qp"])
    for m in (2, 4):
        for r, sh in enumerate(_shards(cfg, tree, m)):
            lw = sh["layers"][0]
            mine = unpack_w4(lw["w_down"]["qp"])
            assert torch.equal(mine, down.chunk(m, dim=0)[r])
            assert not torch.equal(lw["w_down"]["qp"], whole["w_down"]["qp"].chunk(m, dim=0)[r])
            g = unpack_w4(lw["w_gu"]["qp"]).chunk(2, dim=-1)[0]
            assert torch.equal(g, unpack_w4(whole["w_gu"]["qp"]).chunk(2, dim=-1)[0]
                               .chunk(m, dim=-1)[r])
            if group_size is None:
                assert torch.equal(lw["w_down"]["s"], whole["w_down"]["s"])
            else:
                assert torch.equal(lw["w_down"]["s4g"], whole["w_down"]["s4g"].chunk(m, dim=0)[r])
    coarse = quantize_llama(_tree(cfg), bits=4, group_size=64)  # wo: K 64, one group
    with pytest.raises(ValueError, match="group size"):
        _shards(cfg, coarse, 2)


def test_experts_and_wide_norms_slice():
    """MoE: E/m experts a rank (the router whole); olmo2's whole-width q/k
    norms take their projections' columns; a model axis that divides
    neither the heads nor the experts is refused."""
    cfg = llama.tiny_olmoe_config(vocab_size=253)
    tree = _tree(cfg)
    whole = tree["layers"][0]
    shards = _shards(cfg, tree, 2)
    for key in ("moe_w1t", "moe_w3t", "moe_w2"):
        assert torch.equal(_cat([sh["layers"][0][key] for sh in shards], 0), whole[key])
    assert torch.equal(shards[1]["layers"][0]["w_router"], whole["w_router"])
    assert torch.equal(_cat([sh["layers"][0]["q_norm"] for sh in shards], 0), whole["q_norm"])
    assert torch.equal(_cat([sh["layers"][0]["k_norm"] for sh in shards], 0), whole["k_norm"])
    assert [sh["shard"].e0 for sh in shards] == [0, 2]
    for bad, m, match in ((dataclasses.replace(cfg, num_attention_heads=6), 4, "query heads"),
                          (dataclasses.replace(cfg, num_experts=3), 2, "experts"),
                          (dataclasses.replace(cfg, num_key_value_heads=3,
                                               num_attention_heads=6), 2, "kv heads")):
        with pytest.raises(ValueError, match=match):
            sharding.plan_shard(bad, 253, m, 0)
    with pytest.raises(ValueError, match="no row"):
        sharding.plan_shard(cfg, 3, 4, 0)


def test_local_config_is_idempotent():
    cfg = llama.tiny_config(vocab_size=253)
    sh = sharding.plan_shard(cfg, 253, 2, 1)
    lc = sh.local(cfg)
    assert (lc.num_attention_heads, lc.num_key_value_heads, lc.intermediate_size) == (2, 1, 64)
    assert sh.local(lc) is lc
    with pytest.raises(ValueError, match="fit neither"):
        sh.local(dataclasses.replace(cfg, num_attention_heads=8))


def test_data_rows_split_contiguously():
    for n_data in (1, 2, 3, 4):
        for n in (0, 5, 8, 13):
            spans = [collectives.Shard.rows(dataclasses.replace(
                sharding.plan_shard(llama.tiny_config(), 256, 1, 0), n_data=n_data, data=d), n)
                for d in range(n_data)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert max(b - a for a, b in spans) - min(b - a for a, b in spans) <= 1


# ---------------------------------------------------------------------------
# The fused head's (score, index) pairs across shards
# ---------------------------------------------------------------------------

def test_head_twin_returns_the_winning_score():
    rng = np.random.default_rng(3)
    embed = torch.from_numpy(rng.normal(size=(40, 16))).bfloat16()
    h = torch.from_numpy(rng.normal(size=(16, 6))).bfloat16()
    ids, scores = _head_argmax_plain(embed, h, scores=True)
    logits = (embed @ h).float()
    assert torch.equal(ids, _head_argmax_plain(embed, h))
    assert torch.equal(scores, logits.gather(0, ids[None])[0])


def test_merge_breaks_cross_shard_ties_to_the_lower_global_index():
    """Trap 5: row 3 of shard 0 and row 2 of shard 1 (global 3 and 7) score
    the same in column 0: the merge gives 3, as the whole head's argmax; a
    higher score in shard 1 wins column 1; a tie inside shard 1 keeps its
    first row in column 2."""
    V, H, block = 10, 3, 5
    embed = torch.zeros(V, H, dtype=torch.bfloat16)
    h = torch.eye(H, dtype=torch.bfloat16)  # column c scores embed[:, c]
    embed[3, 0], embed[block + 2, 0] = 2.0, 2.0  # column 0: a tie across shards
    embed[3, 1], embed[block + 4, 1] = 1.0, 3.0  # column 1: shard 1 wins
    embed[block + 1, 2], embed[block + 3, 2] = 5.0, 5.0  # column 2: a tie inside shard 1
    pairs = [_head_argmax_plain(embed[r * block:(r + 1) * block], h, scores=True)
             for r in range(2)]
    merged = collectives.merge_argmax([s for _, s in pairs],
                                      [i + r * block for r, (i, _) in enumerate(pairs)])
    whole = _head_argmax_plain(embed, h)
    assert merged.tolist() == whole.tolist() == [3, block + 4, block + 1]
    # the same pairs in the other shard order merge the same
    swapped = collectives.merge_argmax([pairs[1][1], pairs[0][1]],
                                       [pairs[1][0] + block, pairs[0][0]])
    assert torch.equal(swapped, merged)


def test_decode_mlp_plan_takes_the_shard_widths():
    """The decode MLP at a model rank's I (Llama-3.2-1B's 8192 / 2 and
    Gemma-2-2B's 9216 / 2): whole 64-row chunks of each split cover the I
    axis, none empty."""
    for H, I in ((2048, 4096), (2304, 4608), (2048, 2048)):
        p = dm.plan(H, I, 128)
        assert p["per_split"] % dm.TILE_K == 0
        assert (p["splits"] - 1) * p["per_split"] < I <= p["splits"] * p["per_split"]
        assert p["gate_up_blocks"] == -(-I // dm.TILE_COLS)
