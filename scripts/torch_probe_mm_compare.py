"""The probes' matmul kernels on the card, from the root of the tree to time:
device time per call of kernel 9 (`block_mm`, int8 and bf16, at each
block_m), kernel 10 (`stream_mm_bl` at each block_out), kernels 11a and 11b
(`w4_probe`), beside their bounds and library calls, at the probes' default
shapes; and the kernels that share code with them (the head argmax's q8
mode shares the s8 wgmma, the decode MLP the ring of stream_ring.cuh) at
their serving shapes.  Every kernel is held to its twin first.  Outputs of
the kernels that must not change are saved under
outputs/probe_mm_compare/LABEL.pt (gitignored).

    python scripts/torch_probe_mm_compare.py LABEL
    python scripts/torch_probe_mm_compare.py --diff LABEL_A LABEL_B

To hold two commits against each other on one card, unpack the other one
with `git archive` under the gitignored _archive/ and run the trees in
turns in one call (other, this, this, other), from each tree's root, then
--diff the labels (from this tree's root):

    (cd _archive/other && python ../../scripts/torch_probe_mm_compare.py 1-other)
    python scripts/torch_probe_mm_compare.py 2-this
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the tree being timed
from dmi_tpu_torch.ops.cuda import _build  # noqa: E402
from dmi_tpu_torch.ops.cuda import block_mm as bm  # noqa: E402
from dmi_tpu_torch.ops.cuda import decode_mlp as dm  # noqa: E402
from dmi_tpu_torch.ops.cuda import head_argmax as ha  # noqa: E402
from dmi_tpu_torch.ops.cuda import stream_mm as sm  # noqa: E402
from dmi_tpu_torch.ops.cuda import w4_probe as wp  # noqa: E402
from dmi_tpu_torch.probes import bf16_steps, f32_sum_slack  # noqa: E402
from dmi_tpu_torch.utils.profiling import device_ms, least_time, nbytes, nvidia_smi  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "outputs",
                   "probe_mm_compare")
N9 = 4096                           # profile_int8_mxu's default square
I10, O10, B10 = 2048, 16384, 256    # profile_mlp_stream's default shape
K11, OUT11, B11 = 2048, 16384, 256  # profile_w4_matmul's defaults


def _line(name, ms, bound, lib_ms, card, extra=""):
    print(f"  {name}: {ms * 1e3!r} us, {ms / lib_ms!r}x the library "
          f"({lib_ms * 1e3!r} us), bound {bound['bound_ms'] * 1e3!r} us ({bound['bound_by']}), "
          f"{bound['bound_ms'] / ms!r} of it{extra} ({card})", flush=True)


def kernel9(dev, card):
    rng = np.random.default_rng(0)  # the probe's operands
    a8, b8 = (torch.from_numpy(rng.integers(-127, 128, size=(N9, N9)).astype(np.int8)).to(dev)
              for _ in range(2))
    abf, bbf = (torch.from_numpy(rng.normal(size=(N9, N9))).to(dev, torch.bfloat16)
                for _ in range(2))
    ref8, refbf = bm._block_mm_plain(a8, b8), bm._block_mm_plain(abf, bbf)
    lib8 = device_ms(lambda: torch._int_mm(a8, b8))
    libbf = device_ms(lambda: torch.matmul(abf, bbf))
    ops = 2 * N9 ** 3
    bound8 = least_time(nbytes(a8, b8) + N9 * N9 * 4, ops, "int8")
    boundbf = least_time(nbytes(abf, bbf) + N9 * N9 * 4, ops, "bfloat16")
    times = {}
    for block_m in bm.BLOCK_M:
        got8 = bm.block_mm(a8, b8, block_m)
        gotbf = bm.block_mm(abf, bbf, block_m)
        torch.cuda.synchronize()
        if not torch.equal(got8, ref8):
            raise AssertionError(f"block_mm int8 block_m {block_m}")
        err = (gotbf - refbf).abs().max().item()
        if not err <= 1e-5 * refbf.abs().max().item():
            raise AssertionError(f"block_mm bf16 block_m {block_m}: {err}")
        t8 = device_ms(lambda: bm.block_mm(a8, b8, block_m))
        tbf = device_ms(lambda: bm.block_mm(abf, bbf, block_m))
        times[block_m] = (t8, tbf)
        _line(f"9 int8 block_m {block_m}", t8, bound8, lib8, card, f", {ops / t8 / 1e9!r} TOP/s")
        _line(f"9bf bf16 block_m {block_m}", tbf, boundbf, libbf, card,
              f", {ops / tbf / 1e9!r} TFLOP/s, max |kernel - twin| {err!r}, int8 speedup "
              f"{tbf / t8!r}")
    # the int8 call's b^T pass alone: a copy of b's transpose as the library
    # writes it, for scale
    print(f"  b.t().contiguous() (library, int8 {N9}^2): "
          f"{device_ms(lambda: b8.t().contiguous()) * 1e3!r} us ({card})")
    return times


def kernel10(dev, card):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(I10, O10)).astype(np.float32)).to(dev, torch.bfloat16)
    h = torch.from_numpy(rng.normal(size=(I10, B10)).astype(np.float32)).to(dev, torch.bfloat16)
    ref, slack = sm._stream_mm_plain(w, h), f32_sum_slack(w.t(), h)
    lib = device_ms(lambda: w.t() @ h)
    bound = least_time(nbytes(w, h) + O10 * B10 * 2, 2 * I10 * O10 * B10, "bfloat16")
    times = {}
    for bo in sm.BLOCK_OUT:
        steps = bf16_steps(sm.stream_mm_bl(w, h, bo), ref, slack)
        if not steps <= 1:
            raise AssertionError(f"stream_mm block_out {bo}: {steps}")
        t = device_ms(lambda: sm.stream_mm_bl(w, h, bo))
        times[bo] = t
        _line(f"10 block_out {bo}", t, bound, lib, card,
              f", {I10 * O10 * 2 / t / 1e6!r} GB/s of weights")
    return times


def kernel11(dev, card):
    rng = np.random.default_rng(0)
    w8 = rng.integers(-7, 8, size=(K11, OUT11)).astype(np.int8)
    h = torch.from_numpy(rng.integers(-64, 64, size=(K11, B11)).astype(np.int8)).to(dev)
    outs = {}
    for name, pack, fn, plain in (("11a split-OUT", wp.pack_split_out, wp.w4_dot_split_out,
                                   wp._w4_split_out_plain),
                                  ("11b split-K", wp.pack_split_k, wp.w4_dot_split_k,
                                   wp._w4_split_k_plain)):
        p = torch.from_numpy(pack(w8)).to(dev)
        got = fn(p, h)
        if not torch.equal(got, plain(p, h)):
            raise AssertionError(f"{name} differs from its twin")
        outs[name] = got.cpu()
        bound = least_time(nbytes(p, h) + OUT11 * B11 * 4, 2 * K11 * OUT11 * B11, "int8")
        t = device_ms(lambda: fn(p, h))
        print(f"  {name}: {t * 1e3!r} us, bound {bound['bound_ms'] * 1e3!r} us ({card})",
              flush=True)
    return outs


def shared(dev, card):
    """The head argmax (q8: int8 embed and state) and the decode MLP at the
    serving shapes of Llama-3.2-1B, B 128."""
    gen = torch.Generator(device=dev).manual_seed(20)
    V, H, B, I = 128256, 2048, 128, 8192
    embed = torch.randn(V, H, generator=gen, device=dev).bfloat16()
    h = torch.randn(H, B, generator=gen, device=dev).bfloat16()
    from dmi_tpu_torch.models import quant
    params = {"embed": quant.quantize_embed_tensor(embed, native=True)}  # the q8 mode
    ids = ha.head_argmax(params, h)
    if not torch.equal(ids, ha._head_argmax_plain(params["embed"], h)):
        raise AssertionError("head argmax q8 differs from its twin")
    outs = {"head q8": ids.cpu()}
    t = device_ms(lambda: ha.head_argmax(params, h))
    print(f"  head argmax q8, V {V}, H {H}, B {B}: {t * 1e3!r} us ({card})", flush=True)
    w_gu = (torch.randn(H, 2 * I, generator=gen, device=dev) * H ** -0.5).bfloat16()
    w_down = (torch.randn(I, H, generator=gen, device=dev) * I ** -0.5).bfloat16()
    out = dm.fused_decode_mlp_bl(w_gu, w_down, h)
    outs["decode mlp"] = out.cpu()
    t = device_ms(lambda: dm.fused_decode_mlp_bl(w_gu, w_down, h))
    print(f"  decode MLP, H {H}, I {I}, B {B}: {t * 1e3!r} us ({card})", flush=True)
    return outs


def main(label: str) -> None:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi()
    t0 = time.perf_counter()
    _build.lib()
    print(f"[{label}] kernels ready in {time.perf_counter() - t0!r} s; {card}")
    print("  ptxas: " + "; ".join(f"{n}: {r}, {st}/{ld}" for n, r, st, ld in _build.ptxas_usage(
        _build.build_log) if any(k in n for k in (
            "block_mm", "stream_mm", "transpose", "mm_kernel", "head_argmax", "wgmma"))))
    kernel9(dev, card)
    kernel10(dev, card)
    saved = {**kernel11(dev, card), **shared(dev, card)}
    os.makedirs(OUT, exist_ok=True)
    torch.save(saved, os.path.join(OUT, f"{label}.pt"))
    print(f"[{label}] done; {card}")


def diff(a: str, b: str) -> None:
    la, lb = (torch.load(os.path.join(OUT, f"{x}.pt")) for x in (a, b))
    for name, x in la.items():
        y = lb[name]
        print(f"  {name}: bit-equal {torch.equal(x, y)}")


if __name__ == "__main__":
    if sys.argv[1] == "--diff":
        diff(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1])
