"""The probes' matmul kernels on the card, from the root of the tree to time:
device time per call of kernel 9 (`block_mm`, int8 and bf16, at each
block_m), kernel 10 (`stream_mm_bl` at each block_out), kernels 11a and 11b
(`w4_probe`, on the route its plan picks, and over K 1024, 2048, 4096 for
the K loop's rate), beside their bounds and library
calls, at the probes' default shapes; kernel 9 int8 on 11's unpacked
weights (M 16384, K 2048, N 256) as the int8 stream's hand-written
yardstick beside `torch._int_mm`; and the kernels that share code with
them (the head argmax's q8 mode shares the s8 wgmma, the decode MLP the
ring of stream_ring.cuh, kernel 7's W4A8 and W8A8 matmuls the helpers of
hopper.cuh and common.cuh) at their serving shapes.  Every kernel is held to
its twin first.  Outputs of the kernels that must not change are saved
under outputs/probe_mm_compare/LABEL.pt (gitignored; kernels 9 and 10 as
sha256 digests of their outputs).

    python scripts/torch_probe_mm_compare.py LABEL
    python scripts/torch_probe_mm_compare.py --diff LABEL_A LABEL_B

To hold two commits against each other on one card, unpack the other one
with `git archive` under the gitignored _archive/ and run the trees in
turns in one call (other, this, this, other), from each tree's root, then
--diff the labels (from this tree's root):

    (cd _archive/other && python ../../scripts/torch_probe_mm_compare.py 1-other)
    python scripts/torch_probe_mm_compare.py 2-this
"""

import hashlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the tree being timed
from dmi_tpu_torch.models import quant  # noqa: E402
from dmi_tpu_torch.ops.cuda import _build  # noqa: E402
from dmi_tpu_torch.ops.cuda import block_mm as bm  # noqa: E402
from dmi_tpu_torch.ops.cuda import decode_mlp as dm  # noqa: E402
from dmi_tpu_torch.ops.cuda import head_argmax as ha  # noqa: E402
from dmi_tpu_torch.ops.cuda import stream_mm as sm  # noqa: E402
from dmi_tpu_torch.ops.cuda import w4_matmul as w4  # noqa: E402
from dmi_tpu_torch.ops.cuda import w4_probe as wp  # noqa: E402
from dmi_tpu_torch.probes import bf16_steps, f32_sum_slack  # noqa: E402
from dmi_tpu_torch.utils.profiling import device_ms, least_time, nbytes, nvidia_smi  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "outputs",
                   "probe_mm_compare")
N9 = 4096                           # profile_int8_mxu's default square
I10, O10, B10 = 2048, 16384, 256    # profile_mlp_stream's default shape
K11, OUT11, B11 = 2048, 16384, 256  # profile_w4_matmul's defaults


def _digest(t):
    """sha256 of a tensor's bytes: what --diff compares for outputs too large
    to save"""
    return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()


def _by_kernel(fn, calls=20):
    """torch.profiler's device time per call of each kernel fn launches (us):
    a call's split between a pass and the kernel after it"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if total > 0:
            out[e.key.replace("(anonymous namespace)::", "").split("(")[0][-48:]] = total / calls
    return out


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
    digests = {}
    for block_m in bm.BLOCK_M:
        got8 = bm.block_mm(a8, b8, block_m)
        gotbf = bm.block_mm(abf, bbf, block_m)
        torch.cuda.synchronize()
        digests[f"9 int8 block_m {block_m}"] = _digest(got8)
        digests[f"9bf bf16 block_m {block_m}"] = _digest(gotbf)
        if not torch.equal(got8, ref8):
            raise AssertionError(f"block_mm int8 block_m {block_m}")
        err = (gotbf - refbf).abs().max().item()
        if not err <= 1e-5 * refbf.abs().max().item():
            raise AssertionError(f"block_mm bf16 block_m {block_m}: {err}")
        t8 = device_ms(lambda: bm.block_mm(a8, b8, block_m))
        tbf = device_ms(lambda: bm.block_mm(abf, bbf, block_m))
        _line(f"9 int8 block_m {block_m}", t8, bound8, lib8, card, f", {ops / t8 / 1e9!r} TOP/s")
        _line(f"9bf bf16 block_m {block_m}", tbf, boundbf, libbf, card,
              f", {ops / tbf / 1e9!r} TFLOP/s, max |kernel - twin| {err!r}, int8 speedup "
              f"{tbf / t8!r}")
    # the int8 call's b^T pass alone: a copy of b's transpose as the library
    # writes it, for scale
    print(f"  b.t().contiguous() (library, int8 {N9}^2): "
          f"{device_ms(lambda: b8.t().contiguous()) * 1e3!r} us ({card})")
    return digests


def kernel10(dev, card):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(I10, O10)).astype(np.float32)).to(dev, torch.bfloat16)
    h = torch.from_numpy(rng.normal(size=(I10, B10)).astype(np.float32)).to(dev, torch.bfloat16)
    ref, slack = sm._stream_mm_plain(w, h), f32_sum_slack(w.t(), h)
    lib = device_ms(lambda: w.t() @ h)
    bound = least_time(nbytes(w, h) + O10 * B10 * 2, 2 * I10 * O10 * B10, "bfloat16")
    digests = {}
    for bo in sm.BLOCK_OUT:
        got = sm.stream_mm_bl(w, h, bo)
        steps = bf16_steps(got, ref, slack)
        if not steps <= 1:
            raise AssertionError(f"stream_mm block_out {bo}: {steps}")
        digests[f"10 block_out {bo}"] = _digest(got)
        t = device_ms(lambda: sm.stream_mm_bl(w, h, bo))
        _line(f"10 block_out {bo}", t, bound, lib, card,
              f", {I10 * O10 * 2 / t / 1e6!r} GB/s of weights")
    return digests


def kernel11(dev, card):
    """11a and 11b, with the route their launch counted (the parent's tree
    has the wmma tile alone and no route counters), then over K: the slope
    between K 1024 and 4096 is the K loop's rate, without the pass, the fill
    and the last epilogue."""
    rng = np.random.default_rng(0)
    w8 = rng.integers(-7, 8, size=(K11, OUT11)).astype(np.int8)
    h = torch.from_numpy(rng.integers(-64, 64, size=(K11, B11)).astype(np.int8)).to(dev)
    layouts = (("11a split-OUT", wp.pack_split_out, wp.w4_dot_split_out, wp._w4_split_out_plain),
               ("11b split-K", wp.pack_split_k, wp.w4_dot_split_k, wp._w4_split_k_plain))
    outs = {}
    for name, pack, fn, plain in layouts:
        p = torch.from_numpy(pack(w8)).to(dev)
        bound = least_time(nbytes(p, h) + OUT11 * B11 * 4, 2 * K11 * OUT11 * B11, "int8")
        ref = plain(p, h)
        counted = getattr(wp, "tma_launches", 0)
        got = fn(p, h)
        route = "tma" if getattr(wp, "tma_launches", 0) > counted else "wmma"
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} ({route}) differs from its twin")
        outs[name] = got.cpu()
        t = device_ms(lambda: fn(p, h))
        print(f"  {name} ({route}): {t * 1e3!r} us, bound {bound['bound_ms'] * 1e3!r} us, "
              f"{bound['bound_ms'] / t!r} of it ({card})", flush=True)
        print(f"    profiler, device time per call by kernel: {_by_kernel(lambda: fn(p, h))!r}",
              flush=True)
        times = {}
        for K in (1024, 2048, 4096):
            wk = rng.integers(-8, 8, size=(K, OUT11)).astype(np.int8)
            hk = torch.from_numpy(rng.integers(-128, 128, size=(K, B11)).astype(np.int8)).to(dev)
            pk = torch.from_numpy(pack(wk)).to(dev)
            if not torch.equal(fn(pk, hk), plain(pk, hk)):
                raise AssertionError(f"{name} K {K} differs from its twin")
            times[K] = device_ms(lambda: fn(pk, hk))
        rate = 2 * OUT11 * B11 * (4096 - 1024) / ((times[4096] - times[1024]) * 1e-3) / 1e12
        print(f"  {name} over K (us): {({k: v * 1e3 for k, v in times.items()})!r}; the K loop "
              f"{rate!r} TOP/s between K 1024 and 4096 ({card})", flush=True)
    return outs


def int8_stream(dev, card):
    """Kernel 9 int8 on 11's weights unpacked (a = W^T [16384, 2048], b = h
    [2048, 256]) at each block_m, beside torch._int_mm on the same product:
    the int8 weight stream that the packed kernels are asked to beat."""
    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.integers(-7, 8, size=(OUT11, K11)).astype(np.int8)).to(dev)
    h = torch.from_numpy(rng.integers(-64, 64, size=(K11, B11)).astype(np.int8)).to(dev)
    ref = bm._block_mm_plain(wt, h)
    h_t = h.t().contiguous()
    w_kn = wt.t().contiguous()
    if not torch.equal(torch._int_mm(h_t, w_kn).t(), ref):
        raise AssertionError("_int_mm differs from the int8 product")
    lib = device_ms(lambda: torch._int_mm(h_t, w_kn))
    bound = least_time(nbytes(wt, h) + OUT11 * B11 * 4, 2 * K11 * OUT11 * B11, "int8")
    for block_m in bm.BLOCK_M:
        if not torch.equal(bm.block_mm(wt, h, block_m), ref):
            raise AssertionError(f"block_mm int8 block_m {block_m} on the int8 stream")
        t = device_ms(lambda: bm.block_mm(wt, h, block_m))
        _line(f"9 int8 stream M {OUT11}, K {K11}, N {B11}, block_m {block_m}", t, bound, lib,
              card)


def kernel7(dev, card):
    """Kernel 7's W4A8 and W8A8 matmuls at Llama-3.2-1B's four layer
    matmuls, B 128, bf16 out: held to their twins and saved for --diff."""
    gen = torch.Generator(device=dev).manual_seed(7)
    outs = {}
    B = 128
    for name, K, n in (("w_qkv", 2048, 3072), ("wo", 2048, 2048), ("w_gu", 2048, 16384),
                       ("w_down", 8192, 2048)):
        w = torch.randn(K, n, generator=gen, device=dev) * K ** -0.5
        hq, a = quant.quantize_act(torch.randn(K, B, generator=gen, device=dev), axis=0)
        for kind, wq, fn, plain in (("w4a8", quant.quantize_tensor_int4(w), w4.w4_mm_bl,
                                     w4._w4_mm_plain),
                                    ("w8a8", quant.quantize_tensor(w, native=True), w4.w8_mm_bl,
                                     w4._w8_mm_plain)):
            got = fn(wq, hq, a, torch.bfloat16)
            if not torch.equal(got, plain(wq, hq, a, torch.bfloat16)):
                raise AssertionError(f"kernel 7 {kind} {name} differs from its twin")
            outs[f"7 {kind} {name}"] = got.cpu()
            t = device_ms(lambda: fn(wq, hq, a, torch.bfloat16))
            print(f"  7 {kind} {name} (K {K}, out {n}, B {B}): {t * 1e3!r} us ({card})",
                  flush=True)
    return outs


def shared(dev, card):
    """The head argmax (q8: int8 embed and state) and the decode MLP at the
    serving shapes of Llama-3.2-1B, B 128."""
    gen = torch.Generator(device=dev).manual_seed(20)
    V, H, B, I = 128256, 2048, 128, 8192
    embed = torch.randn(V, H, generator=gen, device=dev).bfloat16()
    h = torch.randn(H, B, generator=gen, device=dev).bfloat16()
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
            "block_mm", "stream_mm", "transpose", "mm_kernel", "head_argmax", "wgmma",
            "int8_mm"))))
    saved = {**kernel9(dev, card), **kernel10(dev, card), **kernel11(dev, card),
             **shared(dev, card)}
    int8_stream(dev, card)
    saved.update(kernel7(dev, card))
    os.makedirs(OUT, exist_ok=True)
    torch.save(saved, os.path.join(OUT, f"{label}.pt"))
    print(f"[{label}] done; {card}")


def diff(a: str, b: str) -> None:
    la, lb = (torch.load(os.path.join(OUT, f"{x}.pt")) for x in (a, b))
    for name, x in la.items():
        y = lb[name]
        same = x == y if isinstance(x, str) else torch.equal(x, y)
        print(f"  {name}: bit-equal {same}")


if __name__ == "__main__":
    if sys.argv[1] == "--diff":
        diff(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1])
