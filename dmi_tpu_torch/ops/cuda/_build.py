"""Build and load the hand-written CUDA kernels of dmi_tpu_torch.

At first use, `lib()` compiles every `dmi_tpu_torch/csrc/*.cu` with nvcc for
Hopper (`sm_90a`) into one shared library with a plain C interface, and
loads it with ctypes.  The library lands in `dmi_tpu_torch/_build/` (listed
in .gitignore) under a name keyed by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses it.  Nothing is built at import
time: the CPU tests import every module on a machine without nvcc.

Each C entry point returns the CUDA error code of its launch; `check`
raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # x, w0, b0, w1, b1, out, hidden, B, mm, lm, lm2, tm1, tm2, dtype, stream
    "dmi_mlp2": [_P] * 7 + [_I] * 7 + [_P],
    # x, w0, b0, a, bm, d, out, G, B, mm, lm, r, tb, dtype, stream
    "dmi_lora0": [_P] * 7 + [_I] * 7 + [_P],
    # q, k, v, bias, out, part, B, pos, pos_chunk, nkv, group, S, hd, chunk,
    # keys_per_split, splits, stages, warps, k_sb, k_sh, v_sb, v_sh, bias_sb, scale,
    # softcap, dtype, stream
    "dmi_decode_attn": [_P] * 6 + [_I] * 12 + [_L] * 5 + [_F, _F, _I, _P],
    # q, k, v, key_mask, o, lse, B, nh, nkv, T, hd, strides[12], scale, kd, hpb,
    # vec, dtype, stream
    "dmi_flash_fwd": [_P] * 6 + [_I] * 5 + [_P, _F, _I, _I, _I, _I, _P],
    # q, k, v, key_mask, dout, lse, delta, dk, dv, B, nh, nkv, T, hd, strides[18],
    # scale, kd, hpb, qrows, vec, dtype, stream
    "dmi_flash_bwd_dkv": [_P] * 9 + [_I] * 5 + [_P, _F] + [_I] * 5 + [_P],
    # q, k, v, key_mask, dout, lse, delta, dq, B, nh, nkv, T, hd, strides[15],
    # scale, kd, hpb, vec, dtype, stream
    "dmi_flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_P, _F] + [_I] * 4 + [_P],
    # weights (packed uint8 or int8), hq, a, s, out, partial, counters, K, out_dim, B,
    # ldh, packed, dtype, splits, per_split, stream
    "dmi_w4_mm": [_P] * 7 + [_I] * 8 + [_P],
    # w_gu, w_down, h, act_buf, partial, counters, out, H, I, B, n, wgs, stages,
    # down_stages, splits, per_split, act, dtype, stream
    "dmi_decode_mlp": [_P] * 7 + [_I] * 11 + [_P],
    # embed, scales, h, act_scales, part_val, part_idx, ids, scores (or null), V, H, B,
    # mode, blocks, stream
    "dmi_head_argmax": [_P] * 8 + [_I] * 5 + [_P],
    # a, b, bt (int8 TMA: scratch for b^T), out, M, N, K, block_m, int8, tma, grid, stages,
    # stream
    "dmi_block_mm": [_P] * 4 + [_I] * 8 + [_P],
    # w, h, out, O, B, I, block_o, tma, grid_x, grid_y, stages, stream
    "dmi_stream_mm": [_P] * 3 + [_I] * 8 + [_P],
    # p, h, ht (TMA: scratch for h^T), out, OUT, B, K, split_k, tma, grid, stages, stream
    "dmi_w4_probe": [_P] * 4 + [_I] * 7 + [_P],
}

_lib = None
build_seconds = None  # wall time of the nvcc build, None when it was reused
build_log = ""        # nvcc's output (ptxas register and spill report), kept beside the library


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the dmi_tpu_torch CUDA kernels "
        "are compiled at first use and need the CUDA toolkit"
    )


def _build(out: Path) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    # one nvcc per source, all started together
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    objs, logs, failed = [], [], []
    for src, obj, proc in jobs:
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{text}")
        objs.append(obj)
    if failed:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    tmp = out.with_suffix(f".{tag}.tmp")
    r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                       capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
    build_log = "".join(logs)
    out.with_suffix(".log").write_text(build_log)
    os.replace(tmp, out)  # atomic: concurrent builders never load a torn file
    build_seconds = time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_log
    if _lib is None:
        h = hashlib.sha256(" ".join(FLAGS).encode())
        for src in _sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out = BUILD_DIR / f"libdmi_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            _build(out)
        elif out.with_suffix(".log").exists():  # the build that made it
            build_log = out.with_suffix(".log").read_text()
        loaded = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in ("dmi_decode_mlp_map_encodes", "dmi_head_argmax_map_encodes",
                     "dmi_w4_mm_map_encodes"):
            getattr(loaded, name).argtypes = [ctypes.c_int]
            getattr(loaded, name).restype = ctypes.c_longlong
        loaded.dmi_error_string.argtypes = [ctypes.c_int]
        loaded.dmi_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def _kernel_name(mangled: str) -> str:
    """`flash_bwd_dkv_mma_kernel<4, 1>` from an Itanium-mangled kernel name:
    the length-prefixed identifier that ends in `_kernel`, then its integer
    (and `float`) template arguments.  The length may follow other digits
    (an anonymous namespace's hash ends in one), so every tail of a run of
    digits is tried."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            if name.endswith("_kernel") and name.isidentifier():
                break
        if name.endswith("_kernel") and name.isidentifier():
            rest = mangled[m.end() + len(name):]
            if not rest.startswith("I"):
                return name
            body = rest[1:rest.find("Ev")]
            args = re.findall(r"L[a-z](\d+)E", body) or (["float"] if body[:1] == "f" else [])
            for code, ty in (("a", "int8"), ("13__nv_bfloat16", "bf16")):  # a leading type
                if body.startswith(code + "L"):
                    args.insert(0, ty)
            return f"{name}<{', '.join(args)}>"
    return mangled


def ptxas_usage(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel instance in nvcc's `-Xptxas -v` output."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().dmi_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def dtype_code(dtype) -> int:
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]
