"""Where one K3 call's time goes inside its blocks, on the card: builds a
copy of dmi_tpu_torch/csrc/decode_attn.cu with %globaltimer stamps added to
the tensor-core kernel (each block's start, each chunk's arrival, the end
of its key loop and of its output stores, and its SM), runs the plan's call
at the verify's shape, at P 2 and at OLMoE's heads, and prints per-block
phases: the spread of block starts (waves), the first chunk's arrival, the
gap between chunks with the rate at which the running blocks together
receive K and V, the stores, and the call's span.  The stamps go to the `part` pointer, which a call of
one split never touches.  The copy is built by nvcc alone (one source, a
plain C interface) in a temporary directory; the package's library is not
touched.

    python scripts/torch_decode_attn_timestamps.py
"""

import ctypes
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from dmi_tpu_torch.ops.cuda import _build  # noqa: E402
from dmi_tpu_torch.ops.cuda import decode_attn as da  # noqa: E402

sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
import torch_decode_attn_compare as cmp  # noqa: E402

STAMPS = 16  # a block's slots: start, chunks 0-9 arrived, loop end, stores end, .., SM
# (anchor in the tensor-core kernel, text put after it)
PATCH = (
    ("  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  const int nw = blockDim.x >> 5, chunk = a.chunk;",
     "\n  auto now = [] { unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));"
     " return t; };\n"
     "  unsigned long long* stamp = kPos && a.splits == 1 && a.part ?"
     " reinterpret_cast<unsigned long long*>(a.part) + 16 * ((size_t)blockIdx.z * gridDim.x +"
     " blockIdx.x) : nullptr;\n"
     "  const bool lead = threadIdx.x == 0;\n"
     "  if (stamp && lead) { stamp[0] = now(); unsigned sm;"
     " asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm)); stamp[15] = sm; }\n"),
    ("    __syncthreads();  // chunk c (and Q) have landed; every warp is done with chunk c - 1\n",
     "    if (stamp && lead && c < 10) stamp[1 + c] = now();\n"),
    ("  // the rows' sums over the quad\n", "  if (stamp && lead) stamp[11] = now();\n"),
    ("              *reinterpret_cast<const uint4*>(so + r * kLd + c);\n      }\n",
     "      if (stamp && lead) stamp[12] = now();\n"),
)


def build(tmp: Path) -> ctypes.CDLL:
    src = (_build.CSRC / "decode_attn.cu").read_text()
    kernel = src.index("decode_attn_mma_kernel(const Params a) {")
    head, body = src[:kernel], src[kernel:]
    for anchor, add in PATCH:
        if body.count(anchor) != 1:
            raise RuntimeError(f"the kernel has changed: anchor not found once: {anchor!r}")
        body = body.replace(anchor, anchor + add)
    (tmp / "decode_attn_stamped.cu").write_text(head + body)
    lib = tmp / "libstamped.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-I", str(_build.CSRC), "-o", str(lib),
                    str(tmp / "decode_attn_stamped.cu")], check=True)
    out = ctypes.CDLL(str(lib))
    out.dmi_decode_attn.argtypes = _build._SIGNATURES["dmi_decode_attn"]
    out.dmi_decode_attn.restype = ctypes.c_int
    return out


def phases(lib, name, dev, card):
    q, k, v, bias, scale, cap = cmp._args(name, dev)
    B, nh, P, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    p = da.plan(B, nkv, nh // nkv, S, hd, q.element_size(), P)
    if p["splits"] != 1 or not p["tensor_cores"]:
        raise RuntimeError(f"{name}: the stamps need a one-split tensor-core plan, got {p}")
    blocks = B * nkv * p["pos_chunks"]
    stamp = torch.zeros(blocks * STAMPS, dtype=torch.int64, device=dev)
    out = torch.empty_like(q)
    for _ in range(3):  # warm; the last call's stamps are read
        err = lib.dmi_decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            stamp.data_ptr(), B, P, p["pos_chunk"], nkv, nh // nkv, S, hd, p["chunk"],
            p["keys_per_split"], p["splits"], p["stages"], p["warps"], k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), S, float(1 / math.sqrt(hd)), 0.0,
            _build.dtype_code(q.dtype), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    torch.cuda.synchronize()
    if not torch.equal(out, da.fused_decode_attention(q, k, v, bias)):
        raise AssertionError(f"{name}: the stamped build's output differs from the package's")
    t = stamp.view(blocks, STAMPS).cpu().numpy()
    n_chunks = -(-S // p["chunk"])
    us = lambda x: float(np.median(x)) / 1e3  # noqa: E731
    start = t[:, 0] - t[:, 0].min()
    gaps = np.diff(t[:, 1:1 + n_chunks], axis=1)
    # blocks running at the middle of each block's key loop (one wave: all)
    mid = (t[:, 1] + t[:, 11]) // 2
    live = ((t[:, 0][None, :] <= mid[:, None]) & (mid[:, None] <= t[:, 12][None, :])).sum(1)
    chunk_bytes = 2 * p["chunk"] * hd * q.element_size()  # a block's K and V of one chunk
    rate = chunk_bytes * np.median(live) / (np.median(gaps) * 1e-9) / 1e12
    print(f"  {name} (B {B}, {nh}/{nkv} heads, hd {hd}, P {P}, S {S}; plan {p}): span "
          f"{(t[:, 12].max() - t[:, 0].min()) / 1e3!r} us; block starts p50 {us(start)!r}, max "
          f"{float(start.max()) / 1e3!r} us; first chunk after {us(t[:, 1] - t[:, 0])!r} us; "
          f"a chunk every {us(gaps)!r} us with {int(np.median(live))} blocks running (their K "
          f"and V at {rate!r} TB/s); key loop {us(t[:, 11] - t[:, 1])!r} us; stores "
          f"{us(t[:, 12] - t[:, 11])!r} us (medians over blocks; {card})")


def main() -> None:
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        for name in ("3s", "3s-P2", "3s-olmoe"):
            phases(lib, name, dev, card)


if __name__ == "__main__":
    main()
