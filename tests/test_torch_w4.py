"""The W4A8 and W8A8 batch-last matmul twins of dmi_tpu_torch against the JAX
package: the packed twin equals dmi_tpu's Pallas kernel w4_mm_bl run in
interpret mode EXACTLY (integer accumulation, one fixed rescale order), at
any batch size, also the ones the TPU kernel's own gate refuses (B not a
multiple of 128); the int8 twin equals decode._mm_bl's q8 branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import decode as jdec
from dmi_tpu.models import quant as jq
from dmi_tpu.ops.pallas.w4_matmul import w4_mm_bl as j_w4_mm_bl
from dmi_tpu_torch.models import quant as tq
from dmi_tpu_torch.ops.cuda import w4_matmul as tw4

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(K, out, B, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, out)) * 0.05).astype(np.float32)
    h = rng.normal(size=(K, B)).astype(np.float32)
    return w, h


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,out,B", [(64, 128, 128), (64, 128, 8), (128, 256, 100), (64, 128, 1),
                                     (256, 384, 64)])
def test_w4_twin_equals_pallas_interpret_exactly(K, out, B, dtype):
    jd, td = DTYPES[dtype]
    w, h = _case(K, out, B)
    jw = jq.quantize_tensor_int4(jnp.asarray(w))
    jhq, ja = jq.quantize_act(jnp.asarray(h), axis=0)
    want = j_w4_mm_bl(jw, jhq, ja, jd, interpret=True)
    tw = tq.quantize_tensor_int4(torch.from_numpy(w))
    thq, ta = tq.quantize_act(torch.from_numpy(h), axis=0)
    for fn in (tw4._w4_mm_plain, tw4.w4_mm_bl):  # on the CPU the wrapper is the twin
        got = fn(tw, thq, ta, td)
        assert got.dtype == td and tuple(got.shape) == (out, B)
        np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


def test_w4_twin_is_the_unpacked_product():
    """Two half products on the packed bytes == one product on unpack_w4."""
    w, h = _case(96, 40, 7, seed=1)
    tw = tq.quantize_tensor_int4(torch.from_numpy(w))
    thq, ta = tq.quantize_act(torch.from_numpy(h), axis=0)
    dense = {"q8": tq.unpack_w4(tw["qp"]), "s": tw["s"]}
    assert torch.equal(tw4._w4_mm_plain(tw, thq, ta, torch.float32),
                       tw4._w8_mm_plain(dense, thq, ta, torch.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,out,B", [(64, 48, 9), (128, 40, 128)])
def test_w8_twin_equals_jax_q8_branch(K, out, B, dtype):
    jd, td = DTYPES[dtype]
    w, h = _case(K, out, B, seed=2)
    jw = jq.quantize_tensor(jnp.asarray(w), native=True)
    want = jdec._mm_bl(jw, jnp.asarray(h, jd))
    tw = tq.quantize_tensor(torch.from_numpy(w), native=True)
    thq, ta = tq.quantize_act(torch.from_numpy(h).to(td), axis=0)
    for fn in (tw4._w8_mm_plain, tw4.w8_mm_bl):
        np.testing.assert_array_equal(_np(fn(tw, thq, ta, td)),
                                      np.asarray(want.astype(jnp.float32)))


def test_cpu_calls_launch_nothing_and_grouped_weights_are_refused():
    w, h = _case(64, 32, 4)
    tw = tq.quantize_tensor_int4(torch.from_numpy(w))
    thq, ta = tq.quantize_act(torch.from_numpy(h), axis=0)
    n = (tw4.launches, tw4.w8_launches)
    tw4.w4_mm_bl(tw, thq, ta, torch.float32)
    tw4.w8_mm_bl(tq.quantize_tensor(torch.from_numpy(w), True), thq, ta, torch.float32)
    assert (tw4.launches, tw4.w8_launches) == n
    with pytest.raises(ValueError, match="per-channel"):
        tw4.w4_mm_bl(tq.quantize_tensor_int4(torch.from_numpy(w), 16), thq, ta, torch.float32)
