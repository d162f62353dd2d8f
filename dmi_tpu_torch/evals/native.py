# Copy of dmi_tpu/evals/native.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""ctypes bindings for the C++ n-gram scorer (native/ngram_scorer.cpp).

Builds the shared library on first use (g++, cached next to the source);
falls back to the pure-Python scorers when a toolchain is unavailable.
Token strings are interned to uint32 ids on the Python side — the C++ core
only sees integer n-grams.
"""

from __future__ import annotations

import ctypes
import logging
import os
import os.path as osp
import subprocess
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("dmi_tpu")

_SRC = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), "native", "ngram_scorer.cpp")
_LIB = osp.join(osp.dirname(_SRC), "_ngram_scorer.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    if osp.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", _LIB, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        return _LIB
    except Exception as e:  # toolchain missing / read-only tree
        log.info("native scorer unavailable (%s); using python scorers", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:  # stale/foreign-arch .so — fall back to python
        log.info("native scorer .so unloadable (%s); using python scorers", e)
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.cider_d.restype = ctypes.c_double
    lib.cider_d.argtypes = [u32p, i32p, ctypes.c_int32, u32p, i32p, i32p, f64p]
    lib.coco_bleu.restype = None
    lib.coco_bleu.argtypes = [u32p, i32p, ctypes.c_int32, u32p, i32p, i32p, f64p]
    _lib = lib
    return _lib


def _encode(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> Tuple[np.ndarray, ...]:
    vocab: dict = {}

    def ids(tokens):
        out = np.empty(len(tokens), np.uint32)
        for i, t in enumerate(tokens):
            out[i] = vocab.setdefault(t, len(vocab))
        return out

    cand_arrs = [ids(c) for c in candidates]
    ref_arrs = [[ids(r) for r in refs] for refs in references]
    cand_tokens = np.concatenate(cand_arrs) if cand_arrs else np.empty(0, np.uint32)
    cand_lens = np.asarray([len(c) for c in candidates], np.int32)
    flat_refs = [r for refs in ref_arrs for r in refs]
    ref_tokens = np.concatenate(flat_refs) if flat_refs else np.empty(0, np.uint32)
    ref_lens = np.asarray([len(r) for refs in references for r in refs], np.int32)
    refs_per_img = np.asarray([len(refs) for refs in references], np.int32)
    return (
        np.ascontiguousarray(cand_tokens), cand_lens,
        np.ascontiguousarray(ref_tokens), ref_lens, refs_per_img,
    )


def cider_d_native(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> Optional[Tuple[float, List[float]]]:
    lib = get_lib()
    if lib is None:
        return None
    ct, cl, rt, rl, rpi = _encode(candidates, references)
    per_img = np.zeros(len(candidates), np.float64)
    score = lib.cider_d(ct, cl, len(candidates), rt, rl, rpi, per_img)
    return float(score), per_img.tolist()


def coco_bleu_native(
    candidates: List[List[str]], references: List[List[List[str]]]
) -> Optional[List[float]]:
    lib = get_lib()
    if lib is None:
        return None
    ct, cl, rt, rl, rpi = _encode(candidates, references)
    out = np.zeros(4, np.float64)
    lib.coco_bleu(ct, cl, len(candidates), rt, rl, rpi, out)
    return out.tolist()
