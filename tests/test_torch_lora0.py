"""dmi_tpu_torch's fused_lora_layer0 (kernel B.4) against dmi_tpu's.

On the CPU the wrapper runs its plain twin _lora0_plain; here it is held
against the JAX package's Pallas kernel in interpret mode (as
tests/test_pallas.py runs it), its XLA twin, and the vmap of the interpret
kernel over adapter groups, at f32 with atol 2e-5 (test_pallas.py's bound:
the same math in another summation order); the gradients with respect to
x, A, B and d against jax.grad of dmi_tpu's fused_lora_layer0 at rtol 1e-5.
The CUDA kernel is held against the twin in tests/test_torch_cuda.py, on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.ops.pallas import projector as jpk
from dmi_tpu_torch.ops.cuda import lora0 as tl0

torch.set_num_threads(1)


def _data(B=200, mm=256, lm=256, r=32, seed=0, G=None):
    """x, w0, b0, a, b, d as in tests/test_pallas.py (a, b, d with a leading
    group axis when G is given)."""
    rng = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    return (
        rng.normal(size=lead + (B, mm)).astype(np.float32),
        rng.normal(size=(mm, lm)).astype(np.float32) * 0.05,
        rng.normal(size=(lm,)).astype(np.float32) * 0.05,
        rng.normal(size=lead + (mm, r)).astype(np.float32) * 0.05,
        rng.normal(size=lead + (r, lm)).astype(np.float32) * 0.05,
        rng.normal(size=lead + (lm,)).astype(np.float32) * 0.05,
    )


@pytest.mark.parametrize("B,mm,lm,r", [(200, 256, 256, 32), (4, 128, 256, 8), (7, 128, 384, 4)])
def test_lora0_matches_pallas_interpret_and_xla(B, mm, lm, r):
    from jax.experimental.pallas import tpu as pltpu

    data = _data(B, mm, lm, r, seed=1)
    jd = [jnp.asarray(a) for a in data]
    with pltpu.force_tpu_interpret_mode():
        ref_kernel = np.asarray(jpk._lora0_pallas(*jd))
    ref_xla = np.asarray(jpk._lora0_xla(*jd))
    out = tl0.fused_lora_layer0(*map(torch.from_numpy, data))
    assert out.shape == (B, lm) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_kernel, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), ref_xla, atol=2e-5)


def test_lora0_grouped_matches_vmapped_interpret_kernel():
    """The coalesced stage-2 path: G adapter groups in one call, against
    JAX's vmap of the interpret kernel (tests/test_pallas.py:91-110)."""
    from jax.experimental.pallas import tpu as pltpu

    x, w0, b0, a, b, d = _data(B=40, mm=128, lm=256, r=16, seed=2, G=3)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.vmap(lambda x_, a_, b_, d_: jpk._lora0_pallas(x_, jnp.asarray(w0),
                                                               jnp.asarray(b0), a_, b_, d_))(
            *map(jnp.asarray, (x, a, b, d)))
    out = tl0.fused_lora_layer0(*map(torch.from_numpy, (x, w0, b0, a, b, d)))
    assert out.shape == (3, 40, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    for g in range(3):  # each group is the ungrouped call on its own adapter
        one = tl0.fused_lora_layer0(*map(torch.from_numpy, (x[g], w0, b0, a[g], b[g], d[g])))
        torch.testing.assert_close(out[g], one, rtol=0, atol=0)


@pytest.mark.parametrize("grouped", [False, True], ids=["single", "grouped"])
def test_lora0_gradients_match_jax_grad(grouped):
    """d/dx, d/dA, d/dB and d/dd (and d/dW0, d/db0) of sum(out * cot)
    against jax.grad through dmi_tpu's custom_vjp."""
    data = _data(B=6, mm=64, lm=96, r=8, seed=3, G=2 if grouped else None)
    cot = np.random.default_rng(4).normal(size=(2, 6, 96) if grouped else (6, 96)).astype(
        np.float32)

    def jloss(x, w0, b0, a, b, d):
        if grouped:
            y = jax.vmap(lambda x_, a_, b_, d_: jpk.fused_lora_layer0(x_, w0, b0, a_, b_, d_))(
                x, a, b, d)
        else:
            y = jpk.fused_lora_layer0(x, w0, b0, a, b, d)
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, data))
    ts = [torch.from_numpy(a).requires_grad_() for a in data]
    (tl0.fused_lora_layer0(*ts) * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


def test_lora0_grad_follows_needs_input_grad():
    """Only the inputs that require grad get one (the stage-2 step: the
    frozen W0 and b0 never do)."""
    x, w0, b0, a, b, d = map(torch.from_numpy, _data(B=3, mm=16, lm=24, r=4))
    a.requires_grad_()
    d.requires_grad_()
    tl0.fused_lora_layer0(x, w0, b0, a, b, d).sum().backward()
    assert a.grad is not None and d.grad is not None
    assert x.grad is None and w0.grad is None and b.grad is None


def test_lora0_twin_rounds_the_rank_product_to_b_dtype():
    """At bf16 the twin rounds x @ a to bf16 before its product with b, as the
    Pallas body does (projector.py:241-242), and returns x's dtype."""
    data = [torch.from_numpy(a).to(torch.bfloat16) for a in _data(B=5, mm=32, lm=48, r=8)]
    out = tl0._lora0_plain(*data)
    assert out.dtype == torch.bfloat16
    x, w0, b0, a, b, d = (t.float() for t in data)
    inter = (x @ a).to(torch.bfloat16).float()
    want = torch.nn.functional.gelu(x @ w0 + inter @ b + b0 + d, approximate="tanh")
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)


def test_lora0_refuses_bad_shapes_and_devices():
    x, w0, b0, a, b, d = map(torch.from_numpy, _data(B=3, mm=16, lm=24, r=4))
    with pytest.raises(ValueError, match="shapes"):
        tl0.fused_lora_layer0(x, w0, b0, a.t(), b, d)
    with pytest.raises(ValueError, match="device"):
        tl0.fused_lora_layer0(x.to("meta"), w0.to("meta"), b0.to("meta"), a.to("meta"),
                              b.to("meta"), d.to("meta"))


def test_lora0_block_rows_fit_shared_memory():
    """The row tile: at most 16 rows and B, and what the x, inter and
    partial-sum tiles fit in a block's shared memory."""
    assert tl0.rows_per_block(4, 768, 32) == 4
    assert tl0.rows_per_block(64, 768, 32) == 16
    assert tl0.rows_per_block(64, 16384, 32) == 3
    with pytest.raises(ValueError, match="shared memory"):
        tl0.rows_per_block(4, 1 << 16, 32)
