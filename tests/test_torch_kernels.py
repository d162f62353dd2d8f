"""dmi_tpu_torch's kernel twins against dmi_tpu's kernels.

On the CPU the port's wrappers run their plain twins (_mlp2_plain,
_decode_attn_plain); here the twins are held against the JAX package's XLA
twins and Pallas kernels (in interpret mode, as tests/test_pallas.py runs
them) at f32 with rtol = atol = 1e-5: the math is the same and only the
summation order differs.  The CUDA kernels are compared with the twins in
tests/test_torch_cuda.py, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import llama as jllama
from dmi_tpu.ops.pallas import decode_attn as jda
from dmi_tpu.ops.pallas import projector as jpk
from dmi_tpu_torch.ops.cuda import decode_attn as tda
from dmi_tpu_torch.ops.cuda import projector as tpk

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
NEG = float(np.finfo(np.float32).min)


def _mlp2_data(B, mm, lm, lm2=None, seed=0):
    rng = np.random.default_rng(seed)
    lm2 = lm2 or lm
    return (
        rng.normal(size=(B, mm)).astype(np.float32),
        rng.normal(size=(mm, lm)).astype(np.float32) * 0.05,
        rng.normal(size=(lm,)).astype(np.float32) * 0.05,
        rng.normal(size=(lm, lm2)).astype(np.float32) * 0.05,
        rng.normal(size=(lm2,)).astype(np.float32) * 0.05,
    )


def _attn_data(B=3, nh=8, nkv=2, S=11, hd=16, valid=None, seed=0):
    """q, k, v and a bias row masking positions >= valid (a decode step
    reading a cache that is longer than what was written)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, nh, 1, hd)).astype(np.float32)
    k = rng.normal(size=(B, nkv, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, nkv, S, hd)).astype(np.float32)
    bias = np.zeros(S, np.float32)
    if valid is not None:
        bias[valid:] = NEG
    return q, k, v, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_mlp2_twin_matches_xla_twin():
    data = _mlp2_data(B=50, mm=96, lm=160, lm2=72)
    ref = np.asarray(jpk._mlp2_xla(*map(jnp.asarray, data)))
    out = tpk._mlp2_plain(*_t(*data)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_mlp2_twin_matches_pallas_kernel_interpret():
    from jax.experimental.pallas import tpu as pltpu

    data = _mlp2_data(B=200, mm=256, lm=256)  # batch 200 padded to 256 inside
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpk._mlp2_pallas(*map(jnp.asarray, data)))
    np.testing.assert_allclose(tpk._mlp2_plain(*_t(*data)).numpy(), ref,
                               rtol=RTOL, atol=ATOL)


def test_mlp2_twin_matches_tiled_pallas_kernel_interpret():
    from jax.experimental.pallas import tpu as pltpu

    data = _mlp2_data(B=130, mm=256, lm=512, seed=3)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpk._mlp2_pallas_tiled(*map(jnp.asarray, data), tile_n=128))
    np.testing.assert_allclose(tpk._mlp2_plain(*_t(*data)).numpy(), ref,
                               rtol=RTOL, atol=ATOL)


def test_mlp2_twin_rounds_hidden_to_weight_dtype():
    """bf16: the hidden is rounded to w1's dtype before the second product,
    as the Pallas body does (projector.py:43-46)."""
    x, w0, b0, w1, b1 = (t.to(torch.bfloat16) for t in _t(*_mlp2_data(B=8, mm=32, lm=48)))
    h = torch.nn.functional.gelu(x.float() @ w0.float() + b0.float(), approximate="tanh")
    ref = (h.to(torch.bfloat16).float() @ w1.float() + b1.float()).to(torch.bfloat16)
    out = tpk._mlp2_plain(x, w0, b0, w1, b1)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref)


def test_mlp2_autograd_function_matches_xla_twin_gradient():
    """fused_mlp2's backward (the gradient of _mlp2_plain, recomputed) against
    the gradient of dmi_tpu's _mlp2_xla, with respect to x and all four
    weights, at f32 on the CPU, where the Function's forward is the twin."""
    import jax

    data = _mlp2_data(B=9, mm=40, lm=56, lm2=24, seed=4)
    gy = np.random.default_rng(9).normal(size=(9, 24)).astype(np.float32)
    _, vjp = jax.vjp(jpk._mlp2_xla, *map(jnp.asarray, data))
    ref = vjp(jnp.asarray(gy))
    args = [t.requires_grad_() for t in _t(*data)]
    out = tpk.fused_mlp2(*args)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_MLP2Backward"
    for got, want in zip(torch.autograd.grad(out, args, torch.from_numpy(gy)), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # only the inputs that require grad get one
    x = _t(data[0])[0].requires_grad_()
    (gx,) = torch.autograd.grad(tpk.fused_mlp2(x, *_t(*data[1:])), [x], torch.from_numpy(gy))
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mm,lm,lm2,itemsize", [
    (1024, 2048, 2048, 4),   # the serving projector, f32
    (768, 2048, 2048, 4),    # stage 3's generated projector
    (1024, 2048, 2048, 2),   # bf16
    (1024, 4096, 4096, 2),   # an 8B-wide projector
    (96, 160, 72, 4),        # widths off every tile
])
def test_mlp2_plan_covers_every_output_once_in_shared_memory(mm, lm, lm2, itemsize):
    """Each pass's grid covers every row of x and every output column
    exactly once (the last tiles may be ragged, never empty), in a block
    that fits the H100's shared memory, for every batch of 1-512."""
    for B in range(1, 513):
        for plan, N in zip(tpk.mlp2_plan(B, mm, lm, lm2, itemsize), (lm, lm2)):
            cols, rows = plan["grid"]
            assert plan["block_rows"] == 8 * plan["rows_per_thread"]
            assert plan["rows_per_thread"] in tpk.ROWS_PER_THREAD
            assert cols * plan["block_cols"] >= N > (cols - 1) * plan["block_cols"]
            assert rows * plan["block_rows"] >= B > (rows - 1) * plan["block_rows"]
            assert plan["smem"] <= tpk.SMEM_BYTES


@pytest.mark.parametrize("mm", [1024, 768])
def test_mlp2_plan_fills_the_card_at_serving_batches(mm):
    """B 64-256 at lm 2048 put at least 128 blocks on the 132 SMs in both
    passes; the rows per thread grow with B (16-row tiles at B 64, 32 at
    128, 64 at 256)."""
    for B in range(64, 257):
        for plan in tpk.mlp2_plan(B, mm, 2048, 2048, 4):
            assert plan["grid"][0] * plan["grid"][1] >= tpk.MIN_BLOCKS
    tiles = [tpk.mlp2_plan(B, mm, 2048, 2048, 4)[1]["block_rows"] for B in (64, 128, 256)]
    assert tiles == [16, 32, 64]


def test_decode_attn_score_chunk():
    """The plan's staged chunk (score_chunk's successor: the kernel no longer
    keeps a whole [group, S] row of scores): at serving lengths one chunk
    holds all of S, rounded up to 16 keys, so a call is one plain softmax;
    longer caches stream in chunks of at most 64 keys, a multiple of 16,
    whose stages fit a block's shared memory for any group and head width
    the kernel takes."""
    assert tda.plan(128, 8, 4, 23, 64, 2)["chunk"] == 32
    assert tda.plan(64, 8, 4, 37, 64, 2)["chunk"] == 48
    assert tda.plan(128, 8, 4, 1, 64, 2)["chunk"] == 16
    assert tda.plan(2, 8, 4, 16384, 64, 2)["chunk"] == 64
    for itemsize in (2, 4):
        for group in (1, 4, 32):
            for hd in (1, 64, 256):
                for S in (1, 5, 383, 3073, 20000):
                    p = tda.plan(1, 8, group, S, hd, itemsize)
                    assert p["chunk"] % 16 == 0 and 16 <= p["chunk"] <= 64
                    assert tda.smem_bytes(itemsize, group, hd, p["chunk"], 2) <= tda.SMEM_LIMIT
                    assert p["stages"] == 2 or min(S, p["keys_per_split"]) <= p["chunk"]


@pytest.mark.parametrize("B,S", [(1, 1), (2, 64), (2, 65), (2, 3073), (2, 16384), (1, 20000),
                                 (3, 70), (8, 5000), (64, 4000), (1, 10 ** 7)])
def test_decode_attn_plan_covers_every_key_once(B, S):
    """Splits of whole chunks tile [0, S): every key in exactly one split,
    none empty, the last one ragged where S is no multiple; within the
    C entry's limits."""
    for group in (1, 4, 32):
        p = tda.plan(B, 8, group, S, 64, 2)
        starts = [i * p["keys_per_split"] for i in range(p["splits"])]
        assert starts[-1] < S <= p["splits"] * p["keys_per_split"]
        assert p["splits"] == 1 or p["keys_per_split"] % p["chunk"] == 0
        assert 1 <= p["splits"] <= tda.MAX_SPLITS and p["blocks"] == B * 8 * p["splits"]
        assert p["stages"] == (1 if min(S, p["keys_per_split"]) <= p["chunk"] else 2)
        # the C entry's terms: tensor cores at bf16, hd <= 128, group <= 16,
        # with 16 keys a warp at least; else the CUDA cores' 4 warps
        if p["tensor_cores"]:
            assert group <= 16 and p["warps"] in (1, 4) and 16 * p["warps"] <= p["chunk"] <= 64
        else:
            assert group > 16 and p["warps"] == 4


def test_decode_attn_plan_one_split_at_serving_shapes():
    """B 64-256 x 8 kv heads at every step of a caption (S up to 38): one
    split, one launch, no merge; so is any cache of up to MIN_SPLIT_KEYS
    positions at any batch."""
    for B in range(64, 257):
        for S in range(1, 39):
            p = tda.plan(B, 8, 4, S, 64, 2)
            assert p["splits"] == 1 and p["keys_per_split"] == S and p["stages"] == 1
            assert p["tensor_cores"] and p["warps"] == 1  # one warp: no combine of warps
    for B in (1, 2, 7):
        assert tda.plan(B, 8, 4, tda.MIN_SPLIT_KEYS, 64, 2)["splits"] == 1


def test_decode_attn_plan_fills_the_card_for_long_caches():
    """B 2 x 8 kv heads past 3072 positions: S is split until the blocks
    come near TARGET_BLOCKS (half of it where splits need several chunks),
    at least 3 an SM, where the first kernel ran 16 blocks."""
    for S in (3073, 16384):
        p = tda.plan(2, 8, 4, S, 64, 2)
        assert p["splits"] > 1 and 3 * tda.SMS <= p["blocks"] <= tda.TARGET_BLOCKS, p
    assert tda.plan(2, 8, 4, 3073, 64, 2)["keys_per_split"] == 64  # one chunk, one warp
    assert tda.plan(2, 8, 4, 16384, 64, 2)["warps"] == 4


@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_attn_plan_fits_shared_memory(itemsize):
    for group in (1, 3, 4, 32):
        for hd in range(1, tda.MAX_HEAD_DIM + 1, 17):
            for S in (1, 100, 5000):
                p = tda.plan(1, 2, group, S, hd, itemsize)
                assert p["smem"] == tda.smem_bytes(itemsize, group, hd, p["chunk"], p["stages"])
                assert p["smem"] <= tda.SMEM_LIMIT


@pytest.mark.parametrize("S,keys,splits,chunk,masked,softcap", [
    (300, None, None, None, None, None),     # the plan's own splits
    (3100, None, None, None, (2050, 3100), None),  # a finfo.min tail over whole splits
    (100, 40, 4, 16, None, 2.0),             # a ragged third split and an empty fourth
    (100, 40, 3, 16, (40, 80), None),        # the middle split all finfo.min
    (100, 32, 4, 16, (0, 64), 50.0),         # the first two splits all finfo.min
    (100, 48, 3, 16, (37, 100), None),       # a tail that starts mid-chunk
    (100, 40, 3, 16, (0, 100), None),        # every key finfo.min: the uniform average
    (1, None, None, None, None, None),       # one key
])
def test_decode_attn_split_twin_matches_oracle(S, keys, splits, chunk, masked, softcap):
    """_decode_attn_split_plain (the kernel's per-split (m, l, acc) and its
    in-order merge) against dmi_tpu's llama._decode_attention and
    _decode_attn_xla and the port's _decode_attn_plain: the same function,
    with no NaN from an empty or fully masked split."""
    q, k, v, bias = _attn_data(B=2, nh=8, nkv=2, S=S, hd=16, seed=9)
    if masked:
        bias[masked[0]:masked[1]] = NEG
    p = tda.plan(2, 2, 4, S, 16, 4)
    if keys:
        p = {**p, "keys_per_split": keys, "splits": splits, "chunk": chunk}
    assert p["splits"] * p["keys_per_split"] >= S
    out = tda._decode_attn_split_plain(*_t(q, k, v, bias), p, None, softcap)
    assert bool(torch.isfinite(out).all())
    jb = jnp.broadcast_to(jnp.asarray(bias)[None, None], (2, 1, S))
    ref = np.asarray(jllama._decode_attention(*map(jnp.asarray, (q, k, v)), jb, None, softcap))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        out.numpy(), tda._decode_attn_plain(*_t(q, k, v, bias), None, softcap).numpy(),
        rtol=RTOL, atol=ATOL)
    if softcap is None:
        xla = np.asarray(jda._decode_attn_xla(*map(jnp.asarray, (q, k, v)), jb))
        np.testing.assert_allclose(out.numpy(), xla, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,S,valid", [(2, 4096, None), (2, 4096, 3001), (1, 5000, 4500)])
def test_decode_attn_twin_has_no_length_cap(B, S, valid):
    """fused_decode_attention (its twin, on the CPU) against dmi_tpu's
    llama._decode_attention at cache lengths past the 3072 positions a
    single shared-memory chunk holds at group 4, with and without a
    finfo.min tail: the port's function takes any S, as dmi_tpu's loops
    do."""
    q, k, v, bias = _attn_data(B=B, nh=8, nkv=2, S=S, hd=16, valid=valid, seed=7)
    jb = jnp.broadcast_to(jnp.asarray(bias)[None, None], (B, 1, S))
    ref = np.asarray(jllama._decode_attention(*map(jnp.asarray, (q, k, v)), jb))
    out = tda.fused_decode_attention(*_t(q, k, v, bias)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("valid", [None, 7], ids=["all-valid", "masked-tail"])
def test_decode_attn_twin_matches_xla_twin_and_pallas_interpret(valid):
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, bias = _attn_data(valid=valid)
    jb = jnp.broadcast_to(jnp.asarray(bias)[None, None], (q.shape[0], 1, bias.shape[0]))
    ref_xla = np.asarray(jda._decode_attn_xla(*map(jnp.asarray, (q, k, v)), jb))
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = np.asarray(jda._decode_attn_pallas(*map(jnp.asarray, (q, k, v)), jb, 2))
    out = tda._decode_attn_plain(*_t(q, k, v, bias)).numpy()
    np.testing.assert_allclose(out, ref_xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, ref_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale,softcap", [(None, None), (0.2, None), (None, 50.0),
                                           (0.5, 2.0)])
def test_decode_attn_twin_matches_llama_oracle(scale, softcap):
    q, k, v, bias = _attn_data(nh=12, nkv=4, S=9, hd=32, valid=6, seed=1)
    jb = jnp.broadcast_to(jnp.asarray(bias)[None, None], (q.shape[0], 1, bias.shape[0]))
    ref = np.asarray(jllama._decode_attention(*map(jnp.asarray, (q, k, v)), jb,
                                              scale, softcap))
    out = tda._decode_attn_plain(*_t(q, k, v, bias), scale, softcap).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_cpu_tensors_run_the_twins_and_count_no_launch():
    tpk.launches = tda.launches = 0
    data = _t(*_mlp2_data(B=5, mm=32, lm=48))
    assert torch.equal(tpk.fused_mlp2(*data), tpk._mlp2_plain(*data))
    q, k, v, bias = _t(*_attn_data(valid=5))
    assert torch.equal(tda.fused_decode_attention(q, k, v, bias, 0.3, 20.0),
                       tda._decode_attn_plain(q, k, v, bias, 0.3, 20.0))
    assert tpk.launches == 0 and tda.launches == 0


def test_wrappers_reject_bad_shapes():
    x, w0, b0, w1, b1 = _t(*_mlp2_data(B=5, mm=32, lm=48))
    with pytest.raises(ValueError, match="mlp2 shapes"):
        tpk.fused_mlp2(x, w0, b0[:-1], w1, b1)
    q, k, v, bias = _t(*_attn_data())
    with pytest.raises(ValueError, match="decode attention shapes"):
        tda.fused_decode_attention(q, k, v, bias[:-1])
    with pytest.raises(ValueError, match="decode attention shapes"):
        tda.fused_decode_attention(q.expand(-1, -1, 2, -1), k, v, bias)


@pytest.mark.parametrize("arch,n_layers", [("mlp", 2), ("mlp", 3), ("linear", 1)])
def test_projector_apply_matches_dmi_tpu(arch, n_layers):
    """The 2-layer mlp reaches fused_mlp2 in both packages; linear and
    deeper mlps are plain code in both."""
    import jax

    from dmi_tpu.models import projector as jproj
    from dmi_tpu_torch import bridge
    from dmi_tpu_torch.models import projector as tproj

    jspec = jproj.ProjectorSpec(mm_dim=48, lm_dim=64, arch=arch, n_layers=n_layers)
    jparams = jproj.init(jax.random.key(0), jspec)
    x = np.random.default_rng(5).normal(size=(7, 48)).astype(np.float32)
    ref = np.asarray(jproj.apply(jspec, jparams, jnp.asarray(x), train=False))
    tspec = tproj.ProjectorSpec(mm_dim=48, lm_dim=64, arch=arch, n_layers=n_layers)
    tparams = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jparams))
    out = tproj.apply(tspec, tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_projector_init_is_torch_linear_default():
    from dmi_tpu_torch.models import projector as tproj

    spec = tproj.ProjectorSpec(mm_dim=400, lm_dim=100, n_layers=3)
    params = tproj.init(spec, torch.Generator().manual_seed(0))
    assert [tuple(p["w"].shape) for p in params["layers"]] == spec.layer_dims()
    for (fan_in, _), p in zip(spec.layer_dims(), params["layers"]):
        bound = fan_in ** -0.5
        for t in (p["w"], p["b"]):
            assert t.dtype == torch.float32 and t.abs().max() <= bound
            assert t.abs().max() > 0.9 * bound  # uniform over the whole range


def test_linalg_matches_dmi_tpu():
    from dmi_tpu.ops import linalg as jlin
    from dmi_tpu_torch.ops import linalg as tlin

    x = np.random.default_rng(6).normal(size=(9, 24)).astype(np.float32)
    np.testing.assert_allclose(tlin.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jlin.l2_normalize(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tlin.pad_features(torch.from_numpy(x), 30).numpy(),
                                  np.asarray(jlin.pad_features(jnp.asarray(x), 30)))
    assert tlin.pad_features(torch.from_numpy(x), 24).shape == (9, 24)
    with pytest.raises(ValueError):
        tlin.pad_features(torch.from_numpy(x), 10)
