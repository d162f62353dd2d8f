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


def test_rows_per_block_fits_shared_memory():
    assert tpk.rows_per_block(1024, 2048) == 16      # the 1B projector
    assert tpk.rows_per_block(1024, 4096) == 11      # an 8B-wide projector
    for mm, lm in ((1024, 2048), (1024, 3072), (1024, 4096)):
        assert tpk.rows_per_block(mm, lm) * (mm + lm) * 4 <= tpk.SMEM_BYTES
    with pytest.raises(ValueError):
        tpk.rows_per_block(40000, 40000)


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
