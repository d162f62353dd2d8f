"""dmi_tpu_torch's flash-attention twin against dmi_tpu's flash attention.

On the CPU `flash_attention` runs its plain twin, `_flash_attn_plain`, which
autograd differentiates.  Here the twin's output and its dQ, dK and dV are
held against dmi_tpu's llama._flash_attention, the Pallas library kernel
run in interpret mode (DMI_FORCE_FLASH=1, as tests/test_llama.py runs it),
forward and custom-vjp backward, and against dmi_tpu's additive-bias oracle
llama._attention.  Same inputs from numpy seeds, f32, tolerance 1e-5
relative to max(1, max |reference|): the math is the same and only the
summation order differs.  The CUDA kernels are held against the twin in
tests/test_torch_cuda.py, on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import llama as jllama
from dmi_tpu_torch.ops.cuda import flash_attn as tfa

torch.set_num_threads(1)

TOL = 1e-5


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _data(B, T, masked, nh=4, nkv=2, hd=64, seed=0):
    """q, k, v, a cotangent for the output, and a key mask that zeroes a
    ragged tail of every row but the first (key 0 is the soft token)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, nh, T, hd)).astype(np.float32)
    k = rng.normal(size=(B, nkv, T, hd)).astype(np.float32)
    v = rng.normal(size=(B, nkv, T, hd)).astype(np.float32)
    do = rng.normal(size=(B, nh, T, hd)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.int32)
        for b in range(B):
            mask[b, T - 5 - 9 * b:] = 0
    return q, k, v, do, mask


def _twin(q, k, v, do, mask, scale):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = tfa.flash_attention(tq, tk, tv, tm, scale)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("B,T,masked", [(1, 57, True), (2, 57, False), (1, 128, False),
                                        (2, 128, True)])
def test_twin_matches_pallas_flash_interpret(monkeypatch, B, T, masked):
    """Values and dQ/dK/dV against the Pallas kernels (forward, dK/dV and dQ
    pallas_calls) that dmi_tpu runs on every training layer on a TPU."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("DMI_FORCE_FLASH", "1")
    cfg = jllama.tiny_config(vocab_size=64, hidden_size=256, n_layers=1, n_heads=4, n_kv=2,
                             intermediate=64)
    assert (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim) == (4, 2, 64)
    q, k, v, do, mask = _data(B, T, masked)
    seg = None if mask is None else (jnp.ones((B, T), jnp.int32), jnp.asarray(mask))
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda q, k, v: jllama._flash_attention(cfg, q, k, v, seg),
                           *map(jnp.asarray, (q, k, v)))
        ref_grads = vjp(jnp.asarray(do))
    out, grads = _twin(q, k, v, do, mask, jllama.attn_score_scale(cfg))
    _close(out, ref)
    for g, r in zip(grads, ref_grads):
        _close(g, r)


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "key-mask"])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_twin_matches_additive_bias_oracle(masked, scale):
    """dmi_tpu's llama._attention with the [B, T, T] causal (and key) bias
    forward.py builds off the flash path, at group 3 and T 23."""
    q, k, v, do, mask = _data(3, 23, masked, nh=6, nkv=2, hd=16, seed=1)
    valid = np.tril(np.ones((23, 23), bool))[None]
    if mask is not None:
        valid = valid & mask[:, None, :].astype(bool)
    bias = jnp.where(jnp.asarray(np.broadcast_to(valid, (3, 23, 23))), 0.0,
                     jnp.finfo(jnp.float32).min)
    ref, vjp = jax.vjp(lambda q, k, v: jllama._attention(q, k, v, bias, scale),
                       *map(jnp.asarray, (q, k, v)))
    out, grads = _twin(q, k, v, do, mask, scale)
    _close(out, ref)
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        _close(g, r)


def test_twin_rounds_probabilities_to_v_dtype():
    """bf16: the twin's output is the f32 softmax rounded to bf16 times bf16
    v, as the kernels round p before p . v."""
    q, k, v, _, mask = _data(2, 9, True, nh=2, nkv=1, hd=8, seed=2)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = tfa._flash_attn_plain(tq, tk, tv, torch.from_numpy(mask), 0.25)
    s = torch.einsum("bhtd,bhsd->bhts", tq, tk.expand(-1, 2, -1, -1)).float() * 0.25
    keys = torch.from_numpy(mask).bool()[:, None, None]
    valid = torch.tril(torch.ones(9, 9, dtype=torch.bool)) & keys
    p = torch.softmax(s + torch.where(valid, 0.0, torch.finfo(torch.float32).min), -1)
    ref = torch.einsum("bhts,bhsd->bhtd", p.bfloat16(), tv.expand(-1, 2, -1, -1))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref)


def test_cpu_tensors_run_the_twin_and_count_no_launch():
    tfa.fwd_launches = tfa.dkv_launches = tfa.dq_launches = 0
    q, k, v, do, mask = _data(2, 11, True, hd=16)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(mask), 0.2)
    assert torch.equal(out, tfa._flash_attn_plain(tq, tk, tv, torch.from_numpy(mask), 0.2))
    out.backward(torch.from_numpy(do))
    assert (tfa.fwd_launches, tfa.dkv_launches, tfa.dq_launches) == (0, 0, 0)


def test_wrapper_rejects_bad_shapes():
    q, k, v, _, mask = (None if a is None else torch.from_numpy(a)
                        for a in _data(2, 11, True, hd=16))
    with pytest.raises(ValueError, match="flash attention shapes"):
        tfa.flash_attention(q, k[:, :, :10], v, mask)
    with pytest.raises(ValueError, match="flash attention shapes"):
        tfa.flash_attention(q, k, v, mask[:1])
    with pytest.raises(ValueError, match="flash attention shapes"):
        tfa.flash_attention(q[:, :3], k, v, mask)  # 3 query heads over 2 kv heads



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_forward_plan_covers_every_row_in_shared_memory(dtype):
    """The forward's grid covers every query row of every head and batch
    row once: bf16 blocks pack 4, 2 or 1 query heads of one kv head (the
    most that divide the group), 64 rows across their warps; bf16 pads hd
    to the least of its instances' 16-wide multiples (fewer than 32
    columns past hd); every block fits the H100's 227 KB of shared memory
    at every hd up to 128."""
    for nh, nkv, hpb in ((32, 8, 4), (24, 8, 1), (12, 2, 2), (8, 8, 1), (8, 1, 4)):
        for hd in range(1, tfa.MAX_HEAD_DIM + 1):
            for T in (1, 15, 16, 17, 63, 64, 65, 329, 2048):
                plan = tfa.fwd_plan(3, nh, nkv, T, hd, dtype)
                n_qt, n_hb, B = plan["grid"]
                rows, per = plan["rows"], plan["heads_per_block"]
                assert B == 3 and n_hb * per == nh and (nh // nkv) % per == 0
                assert n_qt * rows >= T > (n_qt - 1) * rows
                assert plan["smem"] <= 227 * 1024
                if dtype == torch.bfloat16:
                    kd = plan["head_slices"]
                    assert kd in tfa.HEAD_SLICES and hd <= 16 * kd < hd + 32
                    assert (per, rows, plan["threads"]) == (hpb, 64 // hpb, 128)
                else:
                    assert (per, rows) == (1, tfa.TILE)
    plan = tfa.fwd_plan(32, 32, 8, 65, 64, torch.bfloat16)  # stage 1's call
    assert (plan["grid"], plan["head_slices"]) == ((5, 8, 32), 4)


@pytest.mark.parametrize("T", [1, 39, 65, 329, 2048])
@pytest.mark.parametrize("kd", tfa.HEAD_SLICES)
def test_backward_plan_covers_every_tile_once_in_shared_memory(kd, T):
    """The bf16 backward's grids at each head-slice instance: the dK/dV
    blocks cover every key of every kv head once and walk each head of its
    group once (hpb heads a step, 64 / hpb keys a block); the dQ blocks,
    the forward's grid, cover every (query row, head) once; every block
    fits the H100's 227 KB of shared memory."""
    for nh, nkv in ((32, 8), (24, 8), (12, 2), (8, 8), (8, 1)):
        for hd in (16 * kd - 15, 16 * kd):
            plan = tfa.bwd_plan(2, nh, nkv, T, hd, torch.bfloat16)
            dkv, dq = plan["dkv"], plan["dq"]
            group = nh // nkv
            for p in (dkv, dq):
                assert p["head_slices"] == kd and p["threads"] == 128
                assert p["smem"] <= 227 * 1024
            hpb, keys = dkv["heads_per_block"], dkv["keys"]
            assert group % hpb == 0 and keys == 64 // hpb and dkv["query_rows"] % 16 == 0
            n_kt, n_kv, B = dkv["grid"]
            assert (n_kv, B) == (nkv, 2) and len(dkv["walk"]) == n_kt
            cover = np.zeros((B, nkv, n_kt * keys), np.int64)
            for kt in range(n_kt):
                cover[:, :, kt * keys:(kt + 1) * keys] += 1
                # hpb head slots over group // hpb steps: each head of the group once
                heads = sorted(step * hpb + s for step in range(group // hpb) for s in range(hpb))
                assert heads == list(range(group))
                n_qs = -(-(T - kt * keys) // dkv["query_rows"])  # rows [first key, T)
                assert dkv["walk"][kt] == group // hpb * n_qs
            assert (cover[:, :, :T] == 1).all() and n_kt * keys - T < keys
            n_qt, n_hb, B = dq["grid"]
            rows, per = dq["rows"], dq["heads_per_block"]
            fwd = tfa.fwd_plan(2, nh, nkv, T, hd, torch.bfloat16)
            assert (dq["grid"], per, rows) == (fwd["grid"], fwd["heads_per_block"], fwd["rows"])
            assert rows == 64 // per and n_hb * per == nh and group % per == 0 and B == 2
            cover = np.zeros((B, nh, n_qt * rows), np.int64)
            for qt in range(n_qt):
                for hb in range(n_hb):
                    cover[:, hb * per:(hb + 1) * per, qt * rows:(qt + 1) * rows] += 1
                assert dq["walk"][qt] == (min(T, (qt + 1) * rows) - 1) // tfa.TILE + 1
            assert (cover[:, :, :T] == 1).all() and n_qt * rows - T < rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_plan_fills_the_card_at_stage_2(dtype):
    """Stage 2's call (B 4, 32/8 heads, T 329, hd 64): each backward kernel
    puts at least one block on each of the H100's 132 SMs, and no block's
    walk is more than twice the mean (the causal triangle's longest column
    against its average), so the longest blocks, started first, end near
    the rest."""
    plan = tfa.bwd_plan(4, 32, 8, 329, 64, dtype)
    for name, p in plan.items():
        blocks = int(np.prod(p["grid"]))
        walk = np.asarray(p["walk"], np.float64)  # the same for every (head, batch) column
        print(f"{name}: {blocks} blocks, longest walk {float(walk.max())!r}, "
              f"mean {float(walk.mean())!r}")
        assert blocks >= 132
        assert walk.max() <= 2 * walk.mean()
