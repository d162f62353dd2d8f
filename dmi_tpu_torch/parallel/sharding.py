"""Sharding rules: tensor-parallel LLM weights, data-parallel batches
(counterpart of dmi_tpu/parallel/sharding.py).

dmi_tpu annotates global arrays with PartitionSpecs and lets XLA insert the
collectives.  Here every rank holds only its LOCAL tensors: the functions
below slice a whole tree or batch to this rank's part, and the model code
calls the collectives of collectives.Shard where XLA would insert them.

  * mesh axes ("data", "model"); batch rows are split over every data axis
  * attention: wq/wk/wv (and their biases) keep this rank's heads' columns,
    wo its heads' rows -> one psum per attention block; when the model axis
    is wider than the kv heads, a rank keeps a copy of the one kv head its
    query heads read
  * MLP: w_gate/w_up keep columns, w_down rows -> one psum; the MoE expert
    axis keeps E/m experts (the router is replicated; the combine psums)
  * MLA: wq/wq_b/wkv_b keep their heads' columns, wo their rows; the
    compressed latent path (wq_a, wkv_a, their norms) is replicated
  * embed keeps a block of ceil(V/m) vocab rows, an untied lm_head the same
    block of columns; the last block is shorter and never padded (a padded
    row of zeros would score 0 and could win the argmax)
  * norms replicated, except olmo2's whole-width q/k norms, which keep
    their projection's columns (the variance's sum is psummed)

Quantized trees (models/quant.py) are sharded AFTER quantizing the whole
tree, so every scale is the one-rank scale: a row-sharded weight keeps its
per-output-column scales whole, and packed int4 bytes, whose byte k holds
contraction rows k and k + K/2 (quant.pack_w4), are unpacked, sliced to this
rank's contiguous rows and packed again.  The fused w_qkv and w_gu of
llama.fuse_projections are rebuilt per shard, [q_r | k_r | v_r] and
[gate_r | up_r], so the fused kernels run on the shard (dmi_tpu leaves the
tree unfused under a mesh, dmi_tpu/serve.py:105-110: the same math in
another layout).

All weights are per-layer here (the port's layers are a list), so the
stacked layer axis of dmi_tpu's specs is never sharded.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dmi_tpu_torch.models.quant import pack_w4, unpack_w4
from dmi_tpu_torch.parallel.collectives import Shard
from dmi_tpu_torch.parallel.distributed import batch_axes

# per-layer keys by the axis that shards them: columns (the output axis),
# rows (the contraction axis) or the expert stack's leading axis
_COLUMNS = {"wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "w_qkv", "b_qkv", "w_gu",
            "wq_b", "wkv_b", "w_shared_gate", "w_shared_up"}
_ROWS = {"wo", "w_down", "w_shared_down"}
_EXPERTS = {"moe_w1", "moe_w3", "moe_w2", "moe_w1t", "moe_w3t"}
_REPLICATED = {"ln_attn", "ln_mlp", "ln_post_attn", "ln_post_mlp", "w_router", "wq_a",
               "q_a_norm", "wkv_a", "kv_a_norm", "router_bias"}


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of `tree` as global rank 0 holds it, on every rank (a
    copy; the collective runs over all ranks of the mesh)."""
    def put(x):
        x = x.clone().contiguous()
        dist.broadcast(x, 0)
        return x

    return _tree_map(put, tree)


def batch_sharding(mesh: DeviceMesh, ndim: int) -> tuple:
    """The spec of a batch array: dim 0 over every data axis, the rest
    replicated."""
    return (batch_axes(mesh),) + (None,) * (ndim - 1)


def llm_param_specs(expert_axis: str = "model") -> Dict[str, Any]:
    """dmi_tpu's PartitionSpecs of the stacked-layer Llama tree, as tuples
    (an entry per array axis: a mesh axis, or None for replicated).  The
    port applies the layer specs per layer, without the leading layer axis.
    expert_axis: the mesh axis of the MoE expert dimension."""
    col, row, vec = (None, None, "model"), (None, "model", None), (None, None)
    experts = (None, expert_axis, None, None)
    layers = {"wq": col, "wk": col, "wv": col, "wo": row,
              "w_gate": col, "w_up": col, "w_down": row,
              "ln_attn": vec, "ln_mlp": vec,
              "bq": (None, "model"), "bk": (None, "model"), "bv": (None, "model"),
              "ln_post_attn": vec, "ln_post_mlp": vec, "q_norm": vec, "k_norm": vec,
              "w_router": (None, None, None), "moe_w1": experts, "moe_w3": experts,
              "moe_w2": experts,
              "wq_a": (None, None, None), "wq_b": col, "q_a_norm": vec,
              "wkv_a": (None, None, None), "kv_a_norm": vec, "wkv_b": col,
              "w_shared_gate": col, "w_shared_up": col, "w_shared_down": row}
    return {"embed": ("model", None), "layers": layers, "final_norm": (None,),
            "lm_head": (None, "model")}


# ---------------------------------------------------------------------------
# The mesh's shard of one model
# ---------------------------------------------------------------------------

def make_shard(mesh: DeviceMesh, cfg, vocab: int) -> Shard:
    """This rank's Shard of a model of config cfg and `vocab` rows on mesh
    (plan_shard at the mesh's model size and this rank's place)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "model" in names and names[-1] != "model":
        raise ValueError(f"the model axis must be the mesh's last, got {names}")
    grid = mesh.mesh
    m = int(grid.shape[-1]) if "model" in names else 1
    group = mesh.get_group("model") if "model" in names else None
    r = dist.get_rank(group) if group is not None else 0
    coord = mesh.get_coordinate()
    data, n_data = 0, 1
    for name in batch_axes(mesh):
        i = names.index(name)
        data, n_data = data * grid.shape[i] + coord[i], n_data * int(grid.shape[i])
    data_ranks = tuple(int(g) for g in grid.reshape(-1, m)[:, 0])
    return plan_shard(cfg, vocab, m, r, model_group=group, n_data=n_data, data=data,
                      data_ranks=data_ranks, data_group=_data_group(mesh))


def _data_group(mesh: DeviceMesh):
    """The process group of this rank's data replicas (the ranks that share
    its model index): the mesh's one batch axis.  None with one replica,
    and on a (replica, data, model) mesh, whose batch spans two axes: it
    serves, and its Shard refuses the data-rank sums of training (the
    trainers lay a (data, model) mesh)."""
    axes = batch_axes(mesh)
    if len(axes) != 1 or mesh.mesh.shape[mesh.mesh_dim_names.index(axes[0])] == 1:
        return None
    return mesh.get_group(axes[0])


def plan_shard(cfg, vocab: int, m: int, r: int, model_group=None, n_data: int = 1,
               data: int = 0, data_ranks: tuple = (0,), data_group=None) -> Shard:
    """Model rank r's Shard of m of a model of config cfg and `vocab` rows.
    Raises where the model does not split evenly: m must divide the query
    heads and the experts, and divide the kv heads or be a multiple of
    them; every rank must hold at least one vocab row.  model_group None
    gives a Shard whose collectives are the identity (slicing only)."""
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if nh % m:
        raise ValueError(f"the model axis ({m}) must divide the {nh} query heads")
    if nkv % m == 0:
        nkv_l, kv_rep = nkv // m, 1
    elif m % nkv == 0:
        nkv_l, kv_rep = 1, m // nkv
    else:
        raise ValueError(f"the model axis ({m}) must divide the {nkv} kv heads or be a "
                         "multiple of them")
    E = cfg.num_experts
    if cfg.moe_expert_range is not None:
        raise ValueError(f"a tree holding one expert-parallel rank's share of the experts "
                         f"({cfg.moe_expert_range} of {E}, moe_expert_range) cannot be sharded "
                         "again over a model axis; serve it unsharded")
    if E % m:
        raise ValueError(f"the model axis ({m}) must divide the {E} experts")
    block = -(-vocab // m)
    if (m - 1) * block >= vocab:
        raise ValueError(f"a vocab of {vocab} leaves a rank of the {m} model ranks no row")
    return Shard(model_group=model_group, m=m, r=r, n_data=n_data, data=data,
                 data_ranks=data_ranks, nh=nh, nkv=nkv, nh_l=nh // m, nkv_l=nkv_l, kv_rep=kv_rep, experts=E,
                 e0=r * E // m, e1=(r + 1) * E // m, vocab=vocab, v0=r * block,
                 v1=min(vocab, (r + 1) * block), block=block, data_group=data_group)


def _block_of(n: int, sh: Shard, what: str) -> tuple:
    if n % sh.m:
        raise ValueError(f"{what}: the model axis ({sh.m}) must divide its {n} columns or rows")
    b = n // sh.m
    return sh.r * b, (sh.r + 1) * b


def _head_cols(width: int, heads: int, sh: Shard, kv: bool) -> tuple:
    """This rank's column range of `width` columns holding `heads` heads:
    its query heads, or (kv) its kv heads, a single copied one when the
    model axis is wider than the kv heads."""
    c = width // heads
    if not kv:
        h0, h1 = sh.r * sh.nh_l, (sh.r + 1) * sh.nh_l
    elif sh.kv_rep == 1:
        h0, h1 = sh.r * sh.nkv_l, (sh.r + 1) * sh.nkv_l
    else:
        h0 = sh.r // sh.kv_rep
        h1 = h0 + 1
    return h0 * c, h1 * c


def _col_ranges(key: str, width: int, sh: Shard) -> list:
    """The column ranges [start, stop) of a column-sharded leaf that this
    rank keeps, concatenated in order."""
    nh, nkv = sh.nh, sh.nkv
    if key in ("w_qkv", "b_qkv"):
        hd = width // (nh + 2 * nkv)
        q = _head_cols(nh * hd, nh, sh, kv=False)
        k = _head_cols(nkv * hd, nkv, sh, kv=True)
        off_k, off_v = nh * hd, (nh + nkv) * hd
        return [q, (off_k + k[0], off_k + k[1]), (off_v + k[0], off_v + k[1])]
    if key == "w_gu":
        lo, hi = _block_of(width // 2, sh, key)
        return [(lo, hi), (width // 2 + lo, width // 2 + hi)]
    if key in ("wk", "wv", "bk", "bv", "k_norm"):
        return [_head_cols(width, nkv, sh, kv=True)]
    if key in ("wq", "bq", "q_norm", "wq_b", "wkv_b"):
        return [_head_cols(width, nh, sh, kv=False)]
    return [_block_of(width, sh, key)]


def _cols(t: torch.Tensor, ranges: list) -> torch.Tensor:
    return torch.cat([t[..., a:b] for a, b in ranges], dim=-1).contiguous()


def _rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return t[..., lo:hi, :].contiguous()


def _shard_columns(w, ranges: list):
    """A column-sharded weight, bias or norm, or a quantized dict of one:
    every payload and scale keeps the same columns (packed int4 bytes hold
    two contraction rows of ONE column, so columns slice as they are)."""
    if isinstance(w, dict):
        return {k: _cols(v, ranges) for k, v in w.items()}
    return _cols(w, ranges)


def _shard_rows(w, sh: Shard, key: str):
    """A row-sharded (contraction-sharded) weight: this rank's contiguous
    rows.  Per-output-column scales ("s") stay whole: they were taken over
    all of K.  Packed int4 is unpacked, sliced and packed again; grouped
    scales ("s4g") keep their rank's G/m groups."""
    if not isinstance(w, dict):
        return _rows(w, *_block_of(w.shape[-2], sh, key))
    out = {}
    for k, v in w.items():
        if k in ("q", "q8"):
            out[k] = _rows(v, *_block_of(v.shape[-2], sh, key))
        elif k == "qp":
            q = unpack_w4(v)
            lo, hi = _block_of(q.shape[-2], sh, key)
            if (hi - lo) % 2:
                raise ValueError(f"{key}: a shard of {hi - lo} rows cannot be nibble-packed")
            out[k] = pack_w4(_rows(q, lo, hi))
        elif k == "s4g":
            if v.shape[-2] % sh.m:
                raise ValueError(f"{key}: the group size must divide each shard's rows "
                                 f"({v.shape[-2]} groups over {sh.m} ranks)")
            out[k] = _rows(v, *_block_of(v.shape[-2], sh, key))
        elif k == "s":
            out[k] = v
        else:
            raise KeyError(f"unknown quantized leaf key {k!r}")
    return out


def _shard_layer(lw: dict, cfg, sh: Shard) -> dict:
    out = {}
    for key, w in lw.items():
        if key in _COLUMNS or (key in ("q_norm", "k_norm") and cfg.qk_norm_wide):
            width = (w[next(iter(w))] if isinstance(w, dict) else w).shape[-1]
            out[key] = _shard_columns(w, _col_ranges(key, width, sh))
        elif key in _ROWS:
            out[key] = _shard_rows(w, sh, key)
        elif key in _EXPERTS:
            def take(t):
                return t[sh.e0:sh.e1].contiguous()
            out[key] = {k: take(v) for k, v in w.items()} if isinstance(w, dict) else take(w)
        elif key in _REPLICATED or key in ("q_norm", "k_norm"):
            out[key] = w
        else:
            raise KeyError(f"no sharding rule for layer key {key!r}")
    return out


def shard_llm_params(mesh: DeviceMesh, params: dict, cfg, expert_axis: str = "model") -> dict:
    """This rank's local tree of the whole LLM tree `params` (config cfg,
    unfused or fused, unquantized or quantized), with its Shard under the
    key "shard": the tree the model code computes on under
    Shard.local(cfg).  Quantize the whole tree before sharding it, so that
    every scale is the one-rank scale.

    expert_axis: dmi_tpu's switch for a dedicated expert axis; serving's
    collectives run over the model axis, which is the only one taken."""
    if expert_axis != "model":
        raise ValueError("the port shards experts over the model axis only")
    if "shard" in params:
        raise ValueError("the tree is already sharded")
    return shard_tree(params, cfg, make_shard(mesh, cfg, vocab_of(params)))


def vocab_of(params: dict) -> int:
    """The vocab rows of a whole tree's embed."""
    embed = params["embed"]
    return (embed[next(iter(embed))] if isinstance(embed, dict) else embed).shape[0]


def shard_tree(params: dict, cfg, sh: Shard) -> dict:
    """The slice of the whole tree `params` that Shard sh holds, with sh
    under "shard" (shard_llm_params' work, for any Shard)."""
    embed = params["embed"]
    out = {"layers": [_shard_layer(lw, cfg, sh) for lw in params["layers"]],
           "final_norm": params["final_norm"], "shard": sh}
    if isinstance(embed, dict):
        out["embed"] = {k: v[sh.v0:sh.v1].contiguous() for k, v in embed.items()}
    else:
        out["embed"] = embed[sh.v0:sh.v1].contiguous()
    if "lm_head" in params:
        out["lm_head"] = _shard_columns(params["lm_head"], [(sh.v0, sh.v1)])
    return out


# ---------------------------------------------------------------------------
# Generic specs: trainable trees and batches
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _slice_spec(mesh: DeviceMesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """x cut to this rank's block of every axis that spec names: an entry
    is None (whole), a mesh axis name or a tuple of them (their blocks in
    row-major order of the mesh)."""
    names = tuple(mesh.mesh_dim_names or ())
    coord = mesh.get_coordinate()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx, n = 0, 1
        for a in axes:
            i = names.index(a)
            idx, n = idx * mesh.mesh.shape[i] + coord[i], n * int(mesh.mesh.shape[i])
        if x.shape[dim] % n:
            raise ValueError(f"axis {dim} of length {x.shape[dim]} does not split over {n} "
                             f"ranks of {axes}")
        b = x.shape[dim] // n
        x = x.narrow(dim, idx * b, b)
    return x.contiguous()


def shard_params(mesh: DeviceMesh, params, spec: Optional[tuple] = None):
    """Every leaf of a trainable tree cut to this rank's block of `spec`
    (None or (): replicated, the leaves as they are)."""
    if not spec:
        return params
    return _tree_map(lambda x: _slice_spec(mesh, x, spec), params)


def shard_batch(mesh: DeviceMesh, batch):
    """A tree of batch arrays cut to this rank's rows: dim 0 split over
    every data axis of the mesh (the product of their sizes must divide
    it)."""
    def cut(x):
        x = torch.as_tensor(x)
        return _slice_spec(mesh, x, batch_sharding(mesh, x.ndim))

    return _tree_map(cut, batch)


