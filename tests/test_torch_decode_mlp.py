"""The decode-MLP twin of dmi_tpu_torch against the JAX package: against the
XLA oracle _mlp_xla_bl and against the Pallas kernel _mlp_pallas_bl under
pltpu.force_tpu_interpret_mode() (as tests/test_pallas.py runs it), both
activations.  At f32 the three differ by summation order only (atol 2e-5,
rtol 1e-5, the JAX package's own bound for kernel against oracle).  At bf16
the twin keeps the kernel's rounding points: g and u rounded to bf16,
act(g) * u formed in bf16, one final rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmi_tpu.ops.pallas import decode_mlp as jdm
from dmi_tpu_torch.ops.cuda import decode_mlp as tdm

torch.set_num_threads(1)

ACTS = ["silu", "gelu_tanh"]


def _case(H, I, B, seed=3):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(H, 2 * I)) * 0.05).astype(np.float32),
            (rng.normal(size=(I, H)) * 0.05).astype(np.float32),
            rng.normal(size=(H, B)).astype(np.float32))


@pytest.mark.parametrize("act", ACTS)
def test_twin_matches_xla_oracle_and_pallas_interpret_f32(act):
    arrays = _case(256, 512, 16)  # multi-tile grid, resident f32 accumulator
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    out = tdm._decode_mlp_plain(*targs, act).numpy()
    np.testing.assert_allclose(out, np.asarray(jdm._mlp_xla_bl(*jargs, act)),
                               atol=2e-5, rtol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jdm._mlp_pallas_bl(*jargs, act))
    np.testing.assert_allclose(out, pallas, atol=2e-5, rtol=1e-5)
    # on the CPU the wrapper is the twin, and launches nothing
    n = tdm.launches
    assert torch.equal(tdm.fused_decode_mlp_bl(*targs, act), torch.from_numpy(out))
    assert tdm.launches == n


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("H,I,B", [(64, 96, 5), (128, 256, 8)])
def test_twin_matches_xla_oracle_bf16(H, I, B, act):
    """bf16 in both: the same rounding points, another summation order and
    another exp: within 2 bf16 steps (2**-7) of the largest output."""
    arrays = _case(H, I, B, seed=4)
    out = tdm._decode_mlp_plain(*[torch.from_numpy(a).bfloat16() for a in arrays], act)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jdm._mlp_xla_bl(*[jnp.asarray(a, jnp.bfloat16) for a in arrays], act)
                     .astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("act", ACTS)
def test_twin_rounding_points_at_bf16(act):
    """Written out step by step in f32 with explicit roundings: g and u
    rounded to bf16, the activation rounded, the product rounded, the down
    product accumulated in f32 and rounded once."""
    w_gu, w_down, h = [torch.from_numpy(a).bfloat16() for a in _case(64, 96, 6, seed=5)]

    def r(x):
        return x.bfloat16().float()

    gu = r(w_gu.float().t() @ h.float())
    g, u = gu[:96], gu[96:]
    a = r(torch.nn.functional.silu(g) if act == "silu"
          else torch.nn.functional.gelu(g, approximate="tanh"))
    want = r(w_down.float().t() @ r(a * u))
    got = tdm._decode_mlp_plain(w_gu, w_down, h, act).float()
    # the bf16 matmuls accumulate in f32 in another order: a sum that lands
    # on a rounding boundary may differ by one bf16 step
    assert (got - want).abs().max().item() <= 2.0 ** -7 * want.abs().max().item()
    assert (got == want).float().mean().item() > 0.9


def test_wrapper_checks_shapes_and_names():
    w_gu, w_down, h = [torch.from_numpy(a) for a in _case(64, 96, 4)]
    with pytest.raises(ValueError, match="shapes"):
        tdm.fused_decode_mlp_bl(w_gu, w_down[:48], h)
    with pytest.raises(ValueError, match="mlp_act"):
        tdm.fused_decode_mlp_bl(w_gu, w_down, h, "relu")
    assert tdm.down_splits(2048, 8192, 128) == 4   # 32 tiles x 4 splits: 128 blocks
    assert tdm.down_splits(2048, 8192, 256) == 2
    assert tdm.down_splits(64, 32, 16) == 1        # never deeper than the I axis


@pytest.mark.parametrize("H,I", [(2048, 8192), (72, 136), (64, 8), (3072, 8192), (128, 520),
                                 (64, 8192), (128, 4224)])
def test_bf16_plan_covers_every_output_once(H, I):
    """The bf16 launch plan, at any batch padded to 8 columns: gate-up
    blocks tile I by 64 columns and the padded batch by n x wgs columns;
    down blocks tile H by 64 columns and I by splits of whole 64-row chunks,
    none empty, within what the C entry takes (a narrow H gives the I axis
    up to 132 splits)."""
    for Bp in range(8, 513, 8):
        p = tdm.plan(H, I, Bp)
        cols = p["n"] * p["wgs"]
        assert (p["n"], p["wgs"]) in ((64, 1), (128, 1), (128, 2))
        assert (p["batch_tiles"] - 1) * cols < Bp <= p["batch_tiles"] * cols
        assert p["wgs"] == 1 or Bp > 128
        assert p["gate_up_blocks"] == -(-I // tdm.TILE_COLS) * p["batch_tiles"]
        assert (p["m_tiles"] - 1) * tdm.DOWN_COLS < H <= p["m_tiles"] * tdm.DOWN_COLS
        assert p["per_split"] >= tdm.TILE_K and p["per_split"] % tdm.TILE_K == 0
        assert (p["splits"] - 1) * p["per_split"] < I <= p["splits"] * p["per_split"]
        assert 1 <= p["splits"] <= tdm.SMS
        assert p["counters"] == p["m_tiles"] * p["batch_tiles"]
        assert p["partial_floats"] == p["splits"] * p["counters"] * tdm.DOWN_COLS * cols


def test_padded_batch():
    """The batch pads to 16 columns (16-byte f32 loads, 16-byte TMA row
    strides in bf16), never further."""
    assert [tdm.padded_batch(B) for B in (1, 8, 16, 44, 100, 128, 250)] == \
        [16, 16, 16, 48, 112, 128, 256]
    for B in range(1, 513):
        Bp = tdm.padded_batch(B)
        assert Bp % 16 == 0 and B <= Bp < B + 16


def test_bf16_plan_fits_shared_memory():
    """Each ring holds as many 64-row stages as a block's 227 KB allow (at
    least 4, at most MAX_STAGES), as Ring of csrc/decode_mlp.cu counts them."""
    for Bp in range(8, 513, 8):
        p = tdm.plan(2048, 8192, Bp)
        for stages, smem, tiles in ((p["stages"], p["smem"], 2),
                                    (p["down_stages"], p["down_smem"], 1)):
            stage = 8192 * (tiles + p["wgs"] * p["n"] // 64)
            assert 4 <= stages <= tdm.MAX_STAGES
            assert smem == 1024 + stages * (stage + 16) <= tdm.SMEM_LIMIT


def test_bf16_plan_fills_the_card_at_serving_batches():
    """The down-split plan at Llama-3.2-1B's MLP, B 8-256: every 64 columns
    of I has its own gate-up block (128, the finest wgmma split of I) and
    the down product splits I until it reaches as many blocks as one wave
    of the 132 SMs holds (one block an SM): 32 H tiles x 4 splits."""
    for B in range(8, 257):
        p = tdm.plan(2048, 8192, tdm.padded_batch(B))
        assert p["gate_up_blocks"] == 128
        assert 128 <= p["down_blocks"] <= tdm.SMS
        assert (p["splits"], p["per_split"]) == (4, 2048)


@pytest.mark.parametrize("act", ACTS)
def test_bf16_split_emulation_matches_xla_oracle(act):
    """The bf16 kernel's arithmetic in plain torch: g and u summed in f32
    and rounded, act(g) rounded, the product rounded, the down product as
    f32 partials over the plan's splits of I, added in split order and
    rounded once; against dmi_tpu's _mlp_xla_bl within 2 bf16 steps."""
    H, I, B = 64, 520, 16
    arrays = _case(H, I, B, seed=6)
    w_gu, w_down, h = [torch.from_numpy(a).bfloat16() for a in arrays]
    p = tdm.plan(H, I, B)
    assert p["splits"] > 1

    def r(x):
        return x.bfloat16().float()

    gu = w_gu.float().t() @ h.float()
    g, u = r(gu[:I]), r(gu[I:])
    a = r(torch.nn.functional.silu(g) if act == "silu"
          else torch.nn.functional.gelu(g, approximate="tanh"))
    x = r(a * u)
    out = torch.zeros(H, B)
    for sp in range(p["splits"]):
        rows = slice(sp * p["per_split"], (sp + 1) * p["per_split"])
        out = out + w_down.float()[rows].t() @ x[rows]
    ref = np.asarray(jdm._mlp_xla_bl(*[jnp.asarray(a, jnp.bfloat16) for a in arrays], act)
                     .astype(jnp.float32))
    assert np.abs(r(out).numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
