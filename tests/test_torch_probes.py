"""The probe kernels' twins and wrappers of dmi_tpu_torch against the probe
scripts' Pallas kernels.

The scripts define their kernels inside main(), so each test rebuilds the
script's pl.pallas_call (its kernel body and BlockSpecs, cited by line) and
runs it with interpret=True at the script's --small shapes, for the
script's seed and two more:

- scripts/profile_int8_mxu.py (pallas_mm): int8 exact, bf16 within 1e-5 of
  the largest |output| (both sum in f32, in another order);
- scripts/profile_mlp_stream.py (pallas_mm): within one bf16 step per
  element (both round one f32 sum);
- scripts/profile_w4_matmul.py (dot_w4_pallas, dot_w4_pallas_k): exact.

On the CPU each wrapper is its twin and launches nothing; the probes'
entry points run there only when asked (--device cpu).
"""

import json
from collections import Counter
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from dmi_tpu_torch.ops.cuda import block_mm as tbm
from dmi_tpu_torch.ops.cuda import stream_mm as tsm
from dmi_tpu_torch.ops.cuda import w4_probe as twp
from dmi_tpu_torch.probes import bf16_steps, f32_sum_slack, profile_int8_mxu, profile_mlp_stream
from dmi_tpu_torch.probes import profile_w4_matmul

torch.set_num_threads(1)

SEEDS = [0, 1, 2]  # the scripts' default_rng(0), and two more


def _torch(x):
    """A jax array as a torch tensor of the same values (bf16 bits kept)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(x))


# scripts/profile_int8_mxu.py:71-85, at --small's N 256, bm 128
def _pallas_block_mm(a, b, acc_t, N=256, bm=128):
    def mm_kernel(acc_t, a_ref, b_ref, o_ref):
        o_ref[:] = jnp.dot(a_ref[:], b_ref[:], preferred_element_type=acc_t)

    return pl.pallas_call(
        partial(mm_kernel, acc_t),
        out_shape=jax.ShapeDtypeStruct((N, N), acc_t),
        grid=(N // bm, N // bm),
        in_specs=[pl.BlockSpec((bm, N), lambda i, j: (i, 0)),
                  pl.BlockSpec((N, bm), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((bm, bm), lambda i, j: (i, j)),
        interpret=True,
    )(a, b)


def _int8_mxu_operands(seed, N=256):
    """The script's operands (:65-69), from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    a8 = jnp.asarray(rng.integers(-127, 128, size=(N, N)), jnp.int8)
    b8 = jnp.asarray(rng.integers(-127, 128, size=(N, N)), jnp.int8)
    abf = jnp.asarray(rng.normal(size=(N, N)), jnp.bfloat16)
    bbf = jnp.asarray(rng.normal(size=(N, N)), jnp.bfloat16)
    return a8, b8, abf, bbf


@pytest.mark.parametrize("seed", SEEDS)
def test_block_mm_int8_equals_pallas_exactly(seed):
    a8, b8, _, _ = _int8_mxu_operands(seed)
    want = np.asarray(_pallas_block_mm(a8, b8, jnp.int32))
    for fn in (tbm._block_mm_plain, tbm.block_mm):  # on the CPU the wrapper is the twin
        got = fn(_torch(a8), _torch(b8))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_block_mm_bf16_within_1e5_of_pallas(seed):
    _, _, abf, bbf = _int8_mxu_operands(seed)
    want = np.asarray(_pallas_block_mm(abf, bbf, jnp.float32))
    for fn in (tbm._block_mm_plain, tbm.block_mm):
        got = fn(_torch(abf), _torch(bbf))
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_block_mm_int8_twin_is_exact_past_f32():
    """Sums past 2**24 (K 4096 of +-127 products reach 6.6e7): an f32
    accumulator would round them."""
    a = torch.full((2, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 2), 127, dtype=torch.int8)
    b[0, 0] = 126
    got = tbm._block_mm_plain(a, b)
    assert got[0, 0].item() == 127 * 127 * 4095 + 127 * 126
    assert got[0, 1].item() == 127 * 127 * 4096


# scripts/profile_mlp_stream.py:61-78, at --small's I 128, O 256, B 32, bo O
def _pallas_stream_mm(w, h, bo):
    I, O = w.shape
    B = h.shape[1]

    def mm_kernel(w_ref, h_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(
            w_ref[...], h_ref[...], (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(jnp.bfloat16)

    return pl.pallas_call(
        mm_kernel,
        out_shape=jax.ShapeDtypeStruct((O, B), jnp.bfloat16),
        grid=(O // bo,),
        in_specs=[pl.BlockSpec((I, bo), lambda j: (0, j)),
                  pl.BlockSpec((I, B), lambda j: (0, 0))],
        out_specs=pl.BlockSpec((bo, B), lambda j: (j, 0)),
        interpret=True,
    )(w, h)


@pytest.mark.parametrize("bo", [256, 128])
@pytest.mark.parametrize("seed", SEEDS)
def test_stream_mm_within_one_bf16_step_of_pallas(seed, bo):
    I, O, B = 128, 256, 32
    rng = np.random.default_rng(seed)  # the script's operands (:57-59)
    w = jnp.asarray(rng.normal(size=(I, O)).astype(np.float32), jnp.bfloat16)
    h = jnp.asarray(rng.normal(size=(I, B)).astype(np.float32), jnp.bfloat16)
    want = _torch(_pallas_stream_mm(w, h, bo))
    for fn in (tsm._stream_mm_plain, tsm.stream_mm_bl):
        got = fn(_torch(w), _torch(h))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (O, B)
        assert bf16_steps(got, want) <= 1


def test_bf16_steps_counts_spacings():
    ref = torch.tensor([1.0, 1.0, -3.0, 0.0]).bfloat16()
    assert bf16_steps(ref, ref) == 0
    assert bf16_steps(torch.tensor([1.0078125, 1.0, -3.0, 0.0]), ref) == 1.0
    assert bf16_steps(torch.tensor([1.015625, 1.0, -3.0, 0.0]), ref) == 2.0
    assert bf16_steps(torch.tensor([0.0]), torch.tensor([0.0])) == 0
    assert bf16_steps(torch.tensor([1.015625]), torch.tensor([1.0]), slack=0.0078125) == 1.0


def test_f32_sum_slack_covers_a_cancelling_sum():
    """1 + 2**-24 - 1 summed in two orders: 0 and 2**-24 apart, within
    the slack, though many bf16 steps of the result."""
    a = torch.tensor([[1.0, 2.0 ** -24, -1.0]])
    b = torch.ones(3, 1)
    one = (a[0, 0] + a[0, 1]) + a[0, 2]
    other = (a[0, 0] + a[0, 2]) + a[0, 1]
    assert one.item() != other.item()
    slack = f32_sum_slack(a, b)
    assert abs(one - other) <= slack.item()
    assert bf16_steps(one.reshape(1, 1), other.reshape(1, 1)) > 1
    assert bf16_steps(one.reshape(1, 1), other.reshape(1, 1), slack) == 0


# scripts/profile_w4_matmul.py:145-197, at --small's K 64, OUT 128, B 4
def _pallas_w4_split_out(p, h):
    KK, half = p.shape
    B = h.shape[1]
    bo = min(512, half)

    def _w4_kernel(h_ref, p_ref, o_ref):
        p32 = p_ref[...].astype(jnp.int32)
        lo = ((p32 << 28) >> 28).astype(jnp.int8)
        hi = ((p32 << 24) >> 28).astype(jnp.int8)
        hh = h_ref[...]
        dn = (((0,), (0,)), ((), ()))
        o_ref[0] = lax.dot_general(lo, hh, dn, preferred_element_type=jnp.int32)
        o_ref[1] = lax.dot_general(hi, hh, dn, preferred_element_type=jnp.int32)

    acc = pl.pallas_call(
        _w4_kernel,
        out_shape=jax.ShapeDtypeStruct((2, half, B), jnp.int32),
        grid=(half // bo,),
        in_specs=[pl.BlockSpec((KK, B), lambda i: (0, 0)),
                  pl.BlockSpec((KK, bo), lambda i: (0, i))],
        out_specs=pl.BlockSpec((2, bo, B), lambda i: (0, i, 0)),
        interpret=True,
    )(h, p)
    return acc.reshape(2 * half, B)


def _pallas_w4_split_k(p, h):
    Kh, OO = p.shape
    K, B = h.shape
    bo = min(512, OO)

    def _w4k_kernel(h_ref, p_ref, o_ref):
        p32 = p_ref[...].astype(jnp.int32)
        lo = ((p32 << 28) >> 28).astype(jnp.int8)
        hi = ((p32 << 24) >> 28).astype(jnp.int8)
        hh = h_ref[...]
        dn = (((0,), (0,)), ((), ()))
        o_ref[...] = lax.dot_general(
            lo, hh[: K // 2], dn, preferred_element_type=jnp.int32
        ) + lax.dot_general(hi, hh[K // 2:], dn, preferred_element_type=jnp.int32)

    return pl.pallas_call(
        _w4k_kernel,
        out_shape=jax.ShapeDtypeStruct((OO, B), jnp.int32),
        grid=(OO // bo,),
        in_specs=[pl.BlockSpec((2 * Kh, B), lambda i: (0, 0)),
                  pl.BlockSpec((Kh, bo), lambda i: (0, i))],
        out_specs=pl.BlockSpec((bo, B), lambda i: (i, 0)),
        interpret=True,
    )(h, p)


def _w4_operands(seed, K=64, OUT=128, B=4):
    """The script's operands (:66, :72), from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    w8 = np.asarray(jnp.asarray(rng.integers(-7, 8, size=(K, OUT)), jnp.int8))
    h = np.asarray(jnp.asarray(rng.integers(-64, 64, size=(K, B)), jnp.int8))
    return w8, h


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_helpers_equal_the_scripts_packing(seed):
    w8, _ = _w4_operands(seed)
    K, OUT = w8.shape
    # scripts/profile_w4_matmul.py:93-96 and :110-113
    p_so = ((w8[:, : OUT // 2] & 0xF) | ((w8[:, OUT // 2:] & 0xF) << 4)).astype(np.uint8)
    p_sk = ((w8[: K // 2] & 0xF) | ((w8[K // 2:] & 0xF) << 4)).astype(np.uint8)
    for got, want in ((twp.pack_split_out(w8), p_so), (twp.pack_split_k(w8), p_sk)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["split_out", "split_k"])
@pytest.mark.parametrize("seed", SEEDS)
def test_w4_probe_equals_pallas_exactly(seed, layout):
    w8, h = _w4_operands(seed)
    pack, pallas, plain, wrapper = {
        "split_out": (twp.pack_split_out, _pallas_w4_split_out, twp._w4_split_out_plain,
                      twp.w4_dot_split_out),
        "split_k": (twp.pack_split_k, _pallas_w4_split_k, twp._w4_split_k_plain,
                    twp.w4_dot_split_k)}[layout]
    p = pack(w8)
    want = np.asarray(pallas(jnp.asarray(p), jnp.asarray(h)))
    np.testing.assert_array_equal(want, w8.astype(np.int64).T @ h.astype(np.int64))
    for fn in (plain, wrapper):
        got = fn(torch.from_numpy(p), torch.from_numpy(h))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_w4_twins_take_every_nibble():
    """-8 as well, which the script's weights (-7..7) never hold."""
    w8 = np.random.default_rng(3).integers(-8, 8, size=(32, 48)).astype(np.int8)
    h = np.random.default_rng(4).integers(-128, 128, size=(32, 5)).astype(np.int8)
    want = w8.astype(np.int64).T @ h.astype(np.int64)
    ht = torch.from_numpy(h)
    for pack, fn in ((twp.pack_split_out, twp.w4_dot_split_out),
                     (twp.pack_split_k, twp.w4_dot_split_k)):
        np.testing.assert_array_equal(fn(torch.from_numpy(pack(w8)), ht).numpy(), want)


def _counts():
    return (tbm.launches, tsm.launches, twp.split_out_launches, twp.split_k_launches)


def _final_dict(out: str) -> dict:
    lines = out.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):]))


PROBES = {
    "profile_int8_mxu": (profile_int8_mxu, [
        "N", "block_m", "device", "timer", "cuda_int8_max_abs_err", "cuda_bf16_max_abs_err",
        "torch_bf16_max_abs_err", "cuda_int8_bound_us", "cuda_int8_bound_by",
        "cuda_bf16_bound_us", "cuda_bf16_bound_by", "plain_int8_cpu_wall_ms",
        "plain_bf16_cpu_wall_ms", "torch_bf16_cpu_wall_ms"]),
    "profile_mlp_stream": (profile_mlp_stream, [
        "I", "O", "B", "device", "timer", "cuda_bo64_max_bf16_steps", "torch_max_bf16_steps",
        "cuda_bound_us", "cuda_bound_by", "plain_cpu_wall_ms", "torch_cpu_wall_ms"]),
    "profile_w4_matmul": (profile_w4_matmul, [
        "batch", "K", "OUT", "device", "timer", "cuda_split_out_max_abs_err",
        "cuda_split_k_max_abs_err", "plain_split_out_max_abs_err",
        "cuda_split_out_bound_us", "cuda_split_out_bound_by", "cuda_split_k_bound_us",
        "cuda_split_k_bound_by", "plain_split_out_cpu_wall_ms", "plain_split_k_cpu_wall_ms"]),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_main_on_the_cpu(name, capsys):
    """--small --device cpu: the gate passes, a line per variant, then the
    documented keys; no kernel launches and no device metric is written."""
    module, keys = PROBES[name]
    n0 = _counts()
    module.main(["--small", "--device", "cpu"])
    assert _counts() == n0
    out = capsys.readouterr().out
    assert "correctness:" in out
    res = _final_dict(out)
    assert set(keys) <= set(res), set(keys) - set(res)
    assert res["device"] == "cpu" and "CPU" in res["timer"]
    assert not [k for k in res if k.endswith(("_ms", "_tflops", "_gbps", "_speedup"))
                and not k.endswith("_cpu_wall_ms")]
    assert all(res[k] > 0 for k in keys if k.endswith(("_cpu_wall_ms", "_bound_us")))
    variant_lines = [json.loads(x) for x in out.splitlines() if x.startswith("{\"")]
    assert len(variant_lines) >= 2


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_needs_a_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--small"], ["--small", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            PROBES[name][0].main(argv)


def test_probe_gate_raises_before_timing(monkeypatch, capsys):
    """A twin that disagrees stops the probe before any variant is timed."""
    monkeypatch.setattr(profile_w4_matmul, "_w4_split_k_plain",
                        lambda p, h: twp._w4_split_k_plain(p, h) + 1)
    with pytest.raises(AssertionError, match="plain_split_k"):
        profile_w4_matmul.run(small=True, device="cpu")
    assert "_cpu_wall_ms" not in capsys.readouterr().out


def test_profile_timer_needs_a_card(monkeypatch):
    from dmi_tpu_torch.probes import profile_timer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_timer.main(["--rounds", "1", "--idle", "0"])


# ---------------------------------------------------------------------------
# Launch plans of kernels 9 and 10 (csrc/block_mm.cu, csrc/stream_mm.cu) and
# a model of the int8 transpose pass
# ---------------------------------------------------------------------------

CSRC = Path(tbm.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232448  # shared memory a block may use on the H100

# (M, N, K): the probe's --small and default squares; a persistent walk past
# the SMs with ragged last tiles and a partial last K box; a partial K box
# alone; the card tests' odd shapes (rows TMA cannot take: the wmma instance)
BLOCK_MM_PLAN_SHAPES = [(256, 256, 256), (4096, 4096, 4096), (2000, 2992, 336),
                        (384, 512, 208), (129, 136, 144), (130, 200, 70), (17, 5, 33)]


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("block_m", tbm.BLOCK_M)
@pytest.mark.parametrize("M,N,K", BLOCK_MM_PLAN_SHAPES)
def test_block_mm_plan_fits_and_walks_every_tile_once(M, N, K, block_m, int8):
    """The ring and the epilogue's buffers fit shared memory, the persistent
    blocks are one an SM at most, the accumulators 128 a thread at most,
    and the walk computes each output tile once."""
    p = tbm.plan(M, N, K, int8, block_m)
    assert p["smem"] <= SMEM_LIMIT
    if p["route"] == "wmma":
        gx, gy = p["grid"]
        assert (gx - 1) * p["bn"] < N <= gx * p["bn"] and (gy - 1) * p["bm"] < M <= gy * p["bm"]
        return
    assert p["bm"] == block_m and p["m64_tiles"] * p["wgmma_n"] // 2 <= 128
    assert 2 <= p["stages"] <= tbm.MAX_STAGES
    assert 1 <= p["grid"] <= tbm.SMS and p["grid"] <= p["tiles"]
    assert p["chunks"] * tbm.STAGE_K_BYTES >= K * (1 if int8 else 2)
    assert p["bt_bytes"] == (N * K if int8 else 0)
    assert (p["m_tiles"] - 1) * p["bm"] < M <= p["m_tiles"] * p["bm"]
    assert (p["n_tiles"] - 1) * p["bn"] < N <= p["n_tiles"] * p["bn"]
    walk = tbm.tile_walk(p)
    assert Counter(t for cta in walk for t in cta) == {
        (m, n): 1 for m in range(p["m_tiles"]) for n in range(p["n_tiles"])}
    assert max(map(len, walk)) - min(map(len, walk)) <= 1  # balanced


def test_block_mm_plan_routes_by_shape():
    """TMA where rows are whole 16-byte units and bases aligned; else the
    wmma instance, picked before any launch."""
    assert tbm.plan(4096, 4096, 4096, True)["route"] == "tma"
    assert tbm.plan(4096, 4096, 4096, True, 256)["grid"] == 132
    assert tbm.plan(4096, 4096, 4096, False, 128)["tiles"] == 512
    assert tbm.plan(130, 200, 70, True)["route"] == "wmma"     # K 70
    assert tbm.plan(130, 200, 70, False)["route"] == "wmma"
    assert tbm.plan(130, 200, 144, True)["route"] == "wmma"    # int8 N 200: 8 bytes over
    assert tbm.plan(130, 200, 144, False)["route"] == "tma"    # bf16 N 200: 400 bytes
    assert tbm.plan(256, 256, 256, False, aligned=False)["route"] == "wmma"
    with pytest.raises(ValueError, match="block_m"):
        tbm.plan(256, 256, 256, True, 96)


# (I, O, B): the probe's --small and default shapes; a partial last I box, O
# ragged; the card tests' odd shapes
STREAM_PLAN_SHAPES = [(128, 256, 32), (2048, 16384, 256), (2088, 1096, 104), (72, 136, 40),
                      (100, 200, 5)]


@pytest.mark.parametrize("block_out", tsm.BLOCK_OUT)
@pytest.mark.parametrize("I,O,B", STREAM_PLAN_SHAPES)
def test_stream_mm_plan_fits_and_covers_every_tile_once(I, O, B, block_out):
    """The ring (stream_ring.cuh's rule) fits shared memory, and the grid's
    blocks own each (row tile, batch tile) once."""
    mt, n = tsm.TILES[block_out]
    p = tsm.plan(I, O, B, block_out)
    gx, gy = p["grid"]
    if p["route"] == "wmma":
        assert (gx - 1) * p["bn"] < B <= gx * p["bn"] and (gy - 1) * p["bm"] < O <= gy * p["bm"]
        return
    assert p["smem"] <= SMEM_LIMIT and 2 <= p["stages"] <= tsm.MAX_STAGES
    assert p["stage_bytes"] == 8192 * (mt + 2 * n // 64) and p["bn"] == 2 * n
    assert p["stages"] == min(8, (SMEM_LIMIT - 1024 - 2 * 8 * 8) // p["stage_bytes"])
    assert (gx - 1) * block_out < O <= gx * block_out
    assert (gy - 1) * p["bn"] < B <= gy * p["bn"]
    assert p["chunks"] * 64 >= I


def test_stream_mm_plan_routes_by_shape():
    assert tsm.plan(2048, 16384, 256)["route"] == "tma"
    assert tsm.plan(2048, 16384, 256)["grid"] == (128, 1)
    assert tsm.plan(2048, 16384, 256, 64)["grid"] == (256, 1)
    assert tsm.plan(2048, 16384, 256, 256)["grid"] == (64, 2)
    assert tsm.plan(100, 200, 5)["route"] == "wmma"           # B 5
    assert tsm.plan(100, 204, 8)["route"] == "wmma"           # O 204
    assert tsm.plan(128, 256, 32, aligned=False)["route"] == "wmma"
    with pytest.raises(ValueError, match="block_out"):
        tsm.plan(2048, 16384, 256, 96)


def test_every_block_m_and_block_out_has_an_instance():
    """The C entries dispatch every value the wrappers take."""
    bm_src = (CSRC / "block_mm.cu").read_text()
    for bm in tbm.BLOCK_M:
        assert f"block_m == {bm}) return launch_tma<T, {bm}>" in bm_src
    sm_src = (CSRC / "stream_mm.cu").read_text()
    for bo in tsm.BLOCK_OUT:
        assert f"block_o == {bo}) return launch_tma<{bo}>" in sm_src


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4 i) & 7 of
    the eight bytes of (y, x).  x, y and s may be arrays (lanes)."""
    if np.ndim(s):
        b = np.stack([(x >> 8 * i) & 0xFF for i in range(4)] +
                     [(y >> 8 * i) & 0xFF for i in range(4)])
        lanes = np.arange(b.shape[1])
        return sum(b[(s >> 4 * i) & 7, lanes] << 8 * i for i in range(4))
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * i) & 7] << 8 * i for i in range(4))


def _transpose_s8_model(b):
    """csrc/transpose_s8.cuh's transpose_s8_kernel, block by block and thread
    by thread: the swizzled 128 x 128 tile in shared memory (16-byte units
    past N zero, as the byte-wise loads of a ragged N leave them), each
    thread's 16 words and its four 4 x 4 byte transposes."""
    K, N = b.shape
    bt = np.zeros((N, K), np.uint8)
    for k0 in range(0, K, 128):
        for n0 in range(0, N, 128):
            tile = np.zeros((128, 8, 16), np.uint8)
            for i in range(128 * 8):
                r, c = i >> 3, i & 7
                if k0 + r < K and n0 + 16 * c < N:
                    row = b[k0 + r, n0 + 16 * c:n0 + 16 * c + 16]
                    tile[r, c ^ ((r >> 4) & 7), :len(row)] = row
            words = tile.reshape(-1).view("<u4")
            for t in range(256):
                ks, n4 = t & 7, t >> 3
                o = np.zeros((4, 4), "<u4")
                for g in range(4):
                    r = [int(words[(16 * ks + 4 * g + q) * 32 + (((n4 >> 2) ^ ks) << 2) + (n4 & 3)])
                         for q in range(4)]
                    t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[0], r[1], 0x7362)
                    t2, t3 = _byte_perm(r[2], r[3], 0x5140), _byte_perm(r[2], r[3], 0x7362)
                    o[:, g] = [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                               _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]
                if k0 + 16 * ks >= K:
                    continue
                for j in range(4):
                    if n0 + 4 * n4 + j < N:
                        bt[n0 + 4 * n4 + j, k0 + 16 * ks:k0 + 16 * ks + 16] = o[j].view(np.uint8)
    return bt


@pytest.mark.parametrize("K,N", [(128, 128), (208, 144), (48, 272), (64, 100), (144, 8)])
def test_transpose_s8_model_writes_the_transpose(K, N):
    """The int8 call's b^T pass and the W4 probes' h^T pass, ragged tiles
    included: K a multiple of 16, as both TMA routes require; N a multiple
    of 16 (block_mm's route) or any width of whole int32 output rows (the
    W4 probes' B 100 and 8)."""
    b = np.random.default_rng(K + N).integers(0, 256, size=(K, N)).astype(np.uint8)
    np.testing.assert_array_equal(_transpose_s8_model(b), b.T)


# ---------------------------------------------------------------------------
# Launch plans of kernels 11a and 11b (csrc/w4_probe.cu) and a model of the
# wgmma route's fragment build
# ---------------------------------------------------------------------------

# (K, OUT, B): the probe's --small and default shapes; K past one ring; a
# ragged B (100, 8); row tiles past the SMs and fewer than them; the card
# tests' odd shapes (the wmma tile)
W4_PLAN_SHAPES = [(64, 128, 4), (2048, 16384, 256), (4096, 2048, 256), (2048, 16384, 100),
                  (2048, 16384, 8), (256, 65536, 128), (512, 512, 256), (70, 200, 5),
                  (130, 96, 33), (2, 2, 1)]


@pytest.mark.parametrize("split_k", [False, True])
@pytest.mark.parametrize("K,OUT,B", W4_PLAN_SHAPES)
def test_w4_probe_plan_fits_and_walks_every_tile_once(K, OUT, B, split_k):
    """The ring and the epilogue's buffers fit shared memory, the persistent
    blocks are one an SM at most, the stages cover the packed rows, and the
    walk computes each tile once."""
    p = twp.plan(OUT, B, K, split_k, True)
    if p["route"] == "wmma":
        gx, gy = p["grid"]
        rows = OUT if split_k else OUT // 2
        per = p["bm"] if split_k else p["bm"] // 2
        assert (gx - 1) * p["bn"] < B <= gx * p["bn"] and (gy - 1) * per < rows <= gy * per
        return
    assert p["smem"] <= SMEM_LIMIT and 2 <= p["stages"] <= twp.MAX_STAGES
    assert p["stage_bytes"] == (2 if split_k else 1) * (16384 + 128 * twp.BLOCK_B)
    assert p["bn"] == twp.BLOCK_B and p["ht_bytes"] == B * K
    assert 1 <= p["grid"] <= twp.SMS and p["grid"] <= p["tiles"]
    assert p["chunks"] * twp.STAGE_ROWS >= (K // 2 if split_k else K)
    rows_a_tile = 256 if split_k else 128  # output rows, or packed columns of split-OUT
    rows = OUT if split_k else OUT // 2
    assert (p["m_tiles"] - 1) * rows_a_tile < rows <= p["m_tiles"] * rows_a_tile
    assert (p["n_tiles"] - 1) * twp.BLOCK_B < B <= p["n_tiles"] * twp.BLOCK_B
    walk = twp.tile_walk(p)
    assert Counter(t for cta in walk for t in cta) == {
        (m, n): 1 for m in range(p["m_tiles"]) for n in range(p["n_tiles"])}
    assert max(map(len, walk)) - min(map(len, walk)) <= 1  # balanced
    # the blocks that share a row tile's packed boxes are neighbours
    assert walk[0][0] == (0, 0) and (p["n_tiles"] == 1 or walk[1][0] == (0, 1))


def test_w4_probe_plan_routes_by_shape():
    """The wgmma route where TMA takes every operand's rows and the sums fit
    int32 at 16 x; else the wmma tile, picked before any launch."""
    for split_k in (False, True):
        p = twp.plan(16384, 256, 2048, split_k)
        assert p["route"] == "tma" and p["tiles"] == 128 and p["grid"] == 128
        assert twp.plan(16384, 100, 2048, split_k)["route"] == "tma"   # B 100: 400-byte rows
        assert twp.plan(16384, 102, 2048, split_k)["route"] == "wmma"  # B 102: 408
        assert twp.plan(16384, 256, 2040, split_k)["route"] == "wmma"  # K 2040
        assert twp.plan(16384, 256, 2048, split_k, aligned=False)["route"] == "wmma"
        largest = twp.K_LIMIT - (32 if split_k else 16)
        assert twp.plan(16384, 256, largest, split_k)["route"] == "tma"
        assert twp.plan(16384, 256, twp.K_LIMIT, split_k)["route"] == "wmma"
        assert twp.plan(16384, 256, twp.K_LIMIT + 32, split_k)["route"] == "wmma"
    assert twp.plan(16400, 256, 2048, True)["route"] == "tma"      # 16-byte packed rows
    assert twp.plan(16400, 256, 2048, False)["route"] == "wmma"    # OUT/2 8200: 8 bytes over
    assert twp.plan(16384, 256, 2048, True)["stages"] == 3
    assert twp.plan(16384, 256, 2048, False)["stages"] == 6


@pytest.mark.parametrize("split_k", [False, True])
def test_w4_probe_route_sums_hold_in_int32_below_k_limit(split_k):
    """The wgmma route sums 16 x each nibble in int32: a row of W at -8
    (stored as -128) against a column of h at -128.  At the largest K the
    route takes the 16 x sum holds and shifts back to the true one; at
    K_LIMIT it wraps, which is why plan() sends that K to the wmma tile."""
    def sum_16x(K):  # the kernel's accumulation: int32 products and sums, which wrap
        return int(np.dot(np.full(K, -128, np.int32), np.full(K, -128, np.int32)) >> 4)

    largest = twp.K_LIMIT - (32 if split_k else 16)
    assert twp.plan(256, 8, largest, split_k)["route"] == "tma"
    assert sum_16x(largest) == 8 * 128 * largest
    assert twp.plan(256, 8, twp.K_LIMIT, split_k)["route"] == "wmma"
    assert sum_16x(twp.K_LIMIT) == -(2 ** 27)  # 2³¹ wrapped, where the sum is +2²⁷


def _swz128(row, col):
    """hopper.cuh's swz128: byte (row, col) of a box of 128-byte rows."""
    return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15)


def _tma_box(t, c0, r0, box_cols, box_rows):
    """A TMA box of the 2-D uint8 tensor t at (column c0, row r0) as it lands
    128-byte swizzled: a flat byte array, zeros past the tensor."""
    rows, cols = t.shape
    smem = np.zeros(box_rows * 128, np.uint8)
    for r in range(min(box_rows, rows - r0)):
        n = min(box_cols, cols - c0)
        if n <= 0:
            break
        for c in range(n):
            smem[_swz128(r, c)] = t[r0 + r, c0 + c]
    return smem


def _s8(words, byte):
    """Byte `byte` of each uint32 word as a signed value."""
    v = (words >> (8 * byte)) & 0xFF
    return np.where(v >= 128, v - 256, v)


def _transposed_words(box, off, sel, base, pairs):
    """One thread's words of packed rows 4 tig .. 4 tig + 3 (load q at
    offset off[q], the row order q ^ (tig & 2)) transposed by byte permutes,
    for each lane: split-K's load_words (4 words: columns 4 c + j) or, from
    halfwords (pairs), split-OUT's load_pairs (2 words: columns 2 c + h)."""
    if not pairs:
        wd = [box.view("<u4")[(base + off[q]) // 4].astype(np.int64) for q in range(4)]
        t0, t1 = _byte_perm(wd[0], wd[1], 0x5140), _byte_perm(wd[0], wd[1], 0x7362)
        t2, t3 = _byte_perm(wd[2], wd[3], 0x5140), _byte_perm(wd[2], wd[3], 0x7362)
        return [_byte_perm(t0, t2, sel[0]), _byte_perm(t0, t2, sel[1]),
                _byte_perm(t1, t3, sel[0]), _byte_perm(t1, t3, sel[1])]
    hw = [box.view("<u2")[(base + off[q]) // 2].astype(np.int64) for q in range(4)]
    x01, x23 = _byte_perm(hw[0], hw[1], 0x5410), _byte_perm(hw[2], hw[3], 0x5410)
    return [_byte_perm(x01, x23, sel[0]), _byte_perm(x01, x23, sel[1])]


def _w4_wgmma_model(p, h, split_k):
    """csrc/w4_probe.cu's wgmma route, tile by tile and thread by thread:
    h^T from the pass (_transpose_s8_model), the ring's boxes as TMA lands
    them, each consumer thread's swizzled loads (rows in the order q ^ (tig
    & 2)), its byte permutes (the last with the lane's selectors, which undo
    that order), the x16 nibbles scattered into the A fragment as wgmma reads
    it, B = h^T by the K-major descriptor, and the epilogue's rows through
    its buffers and maps."""
    K, B = h.shape
    OUT = p.shape[1] if split_k else 2 * p.shape[1]
    block_b = twp.BLOCK_B
    pl = twp.plan(OUT, B, K, split_k, True)
    assert pl["route"] == "tma"
    ht = _transpose_s8_model(h.view(np.uint8))  # [B, K]
    out = np.zeros((OUT, B), np.int64)
    t = np.arange(128)
    w, g, tig = t >> 5, (t & 31) >> 2, t & 3
    x = (tig & 2) != 0
    sel = ((np.where(x, 0x1054, 0x5410), np.where(x, 0x3276, 0x7632)) if split_k else
           (np.where(x, 0x2064, 0x6420), np.where(x, 0x3175, 0x7531)))
    rows_half = OUT if split_k else OUT // 2
    for cta in twp.tile_walk(pl):
        for m, n in cta:
            col0, b0 = m * (256 if split_k else 128), n * block_b
            acc = np.zeros((2, 2, 64, block_b), np.int64)  # [warpgroup][m64 tile][row][col]
            for c in range(pl["chunks"]):
                k = c * twp.STAGE_ROWS
                boxes = [_tma_box(p, col0 + 128 * j, k, 128, 128)
                         for j in range(2 if split_k else 1)]
                hts = [_tma_box(ht, k + kh, b0, 128, block_b)
                       for kh in ((0, K // 2) if split_k else (0,))]
                for cw in range(2):
                    col = 32 * w + 4 * g if split_k else 64 * cw + 16 * w + 2 * g
                    off = [_swz128(4 * tig + (q ^ (tig & 2)), col) for q in range(4)]
                    box = boxes[cw if split_k else 0]
                    for kk in range(4):
                        halves = [_transposed_words(box, off, sel, 4096 * kk + 2048 * half,
                                                    not split_k) for half in range(2)]
                        # (tile, nibble, h^T box, the tile's registers' words)
                        if split_k:
                            wgmmas = [(i, high, int(high), [halves[e >> 1][2 * i + (e & 1)]
                                                            for e in range(4)])
                                      for high in (False, True) for i in range(2)]
                        else:
                            v = [halves[e >> 1][e & 1] for e in range(4)]
                            wgmmas = [(0, False, 0, v), (1, True, 0, v)]
                        for i, high, hb, words in wgmmas:
                            bmat = np.array([[hts[hb][_swz128(nn, 32 * kk + kx)] for nn in range(
                                block_b)] for kx in range(32)], np.uint8).view(np.int8)
                            a = np.zeros((64, 32), np.int64)
                            for e in range(4):  # a[e]: row g + 8 (e & 1), k + 16 (e >> 1)
                                vv = (words[e] if high else words[e] << 4) & 0xF0F0F0F0
                                for byte in range(4):
                                    a[16 * w + g + 8 * (e & 1),
                                      4 * tig + byte + 16 * (e >> 1)] = _s8(vv, byte)
                            acc[cw, i] += a @ bmat.astype(np.int64)
            # the epilogue: register r of tile i holds (frag_row, frag_col)
            for cw in range(2):
                for i in range(2):
                    for r in range(block_b // 2):
                        hh = (r >> 1) & 1
                        frow, fcol = 16 * w + g + 8 * hh, 8 * (r >> 2) + 2 * tig + (r & 1)
                        if split_k:  # buffer w >> 1, row 32 (w & 1) + 4 g + 2 i + h
                            base = 0
                            orow = (col0 + 128 * cw + 64 * (w >> 1) + 32 * (w & 1) + 4 * g +
                                    2 * i + hh)
                        else:  # buffer i, row 16 w + 2 g + h, to the low or the high half
                            base = i * (OUT // 2)
                            orow = col0 + 64 * cw + 16 * w + 2 * g + hh
                        ocol = b0 + fcol
                        keep = (orow < rows_half) & (ocol < B)
                        out[base + orow[keep], ocol[keep]] = acc[cw, i][frow, fcol][keep] >> 4
    return out


@pytest.mark.parametrize("split_k", [False, True])
@pytest.mark.parametrize("K,OUT,B", [(160, 320, 36), (288, 512, 8), (32, 288, 68)])
def test_w4_wgmma_fragment_model_is_the_product(K, OUT, B, split_k):
    """The model of the wgmma route reproduces W^T h exactly: nibble -8 and
    h = -128 included, ragged K stages (split-K's K/2 of 80, 144, 16 rows),
    ragged row tiles (split-OUT's OUT/2 of 160 and 144) and ragged B."""
    rng = np.random.default_rng(K + OUT + B)
    w8 = rng.integers(-8, 8, size=(K, OUT)).astype(np.int8)
    h = rng.integers(-128, 128, size=(K, B)).astype(np.int8)
    w8[:, 1], h[:, 0] = -8, -128
    p = (twp.pack_split_k if split_k else twp.pack_split_out)(w8)
    want = w8.astype(np.int64).T @ h.astype(np.int64)
    got = _w4_wgmma_model(p, h, split_k)
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] == 8 * 128 * K


def test_ptxas_report_names_kernels_behind_a_namespace_hash():
    """The smoke's and the compare script's register line: a kernel in an
    anonymous namespace, whose hash may end in a digit before its name's
    length, is still named with its template arguments."""
    from dmi_tpu_torch.ops.cuda._build import _kernel_name, ptxas_usage

    mangled = ("_ZN44_GLOBAL__N__a6a287e7_11_w4_probe_cu_5dc5d0e715w4_wgmma_kernel"
               "ILb1EEEv14CUtensorMap_stS1_S1_S1_iii")
    assert _kernel_name(mangled) == "w4_wgmma_kernel<1>"
    assert _kernel_name("_ZN44_GLOBAL__N__a6a287e7_11_w4_probe_cu_5dc5d0e719transpose_s8_"
                        "kernelEPKhPhii") == "transpose_s8_kernel"
    log = (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert ptxas_usage(log) == [("w4_wgmma_kernel<1>", 168, 0, 0)]
