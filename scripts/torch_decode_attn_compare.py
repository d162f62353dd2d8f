"""Decode attention's kernel instances and the speculative run on the card,
from the root of the tree to time: device time per call of the P = 1 rows
(3, 3r, 3o, 3g of PERF.md) and of K3 (P query positions per cache row) at
the verify's shape, at P 2 and 4, at OLMoE's and at Gemma-2-2B's heads,
beside SDPA and the bound; K3 under other launch plans than `plan`'s (two
splits of S and their merge, other chunks, position chunks, two warps a
row tile), each held to its twin; then 300 requests through
Captioner(speculative=4) on Llama-3.2-1B at full width beside the plain
batch-last run (captions/s, and one batch's device busy time from
chip_smoke.py's profile_run).  Every output is saved under
outputs/decode_attn_compare/LABEL.pt (gitignored).

    python scripts/torch_decode_attn_compare.py LABEL [--kernels-only]
    python scripts/torch_decode_attn_compare.py --diff LABEL_A LABEL_B

To hold two commits against each other on one card, unpack the other one
with `git archive` under the gitignored _archive/ and run the trees in
turns in one call (other, this, this, other), from each tree's root, then
--diff the labels (from this tree's root):

    (cd _archive/other && python ../../scripts/torch_decode_attn_compare.py 1-other)
    python scripts/torch_decode_attn_compare.py 2-this
"""

import dataclasses
import inspect
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the tree being timed
import chip_smoke as cs  # noqa: E402
from dmi_tpu_torch.ops.cuda import _build  # noqa: E402
from dmi_tpu_torch.ops.cuda import decode_attn as da  # noqa: E402
from dmi_tpu_torch.utils.profiling import device_ms, least_time, nbytes  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "outputs",
                   "decode_attn_compare")
FMIN = torch.finfo(torch.float32).min
CHUNKS = (16, 32, 64)
T, BUDGET, P = len(cs.PREFIX_IDS) + 1, cs.MAX_NEW, cs.SPEC_K + 1


def _bias_p1(kind, B, S, rng, dev):
    """A zero [S] row (the batch loops) or [B, S] ring rows (the slot
    engine: the prompt and a random run of its own rows; row 0 a slot never
    used)."""
    if kind == "shared":
        return torch.zeros(S, device=dev)
    keep = torch.from_numpy(rng.random((B, S)) < 0.6)
    keep[:, :T] = True
    keep[0] = False
    return torch.where(keep, 0.0, FMIN).to(dev)


def _bias_k3(B, S, npos, rng, dev):
    """[B, P, S] rows as the verify's bookkeeping builds them at round 10:
    the prompt, each earlier round's accepted rows, this round's rows up to
    each position; row 0 a finished slot."""
    rnd, rt = 10, T + P * 10
    valid = torch.zeros(B, S, dtype=torch.bool)
    valid[:, :T] = True
    for r in range(rnd):
        keep = 1 + torch.from_numpy(rng.integers(0, P, size=B))
        valid[:, T + P * r:T + P * (r + 1)] = torch.arange(P)[None, :] < keep[:, None]
    valid[:, rt:rt + P] = True
    valid[0, rt:] = False
    sees = torch.arange(S)[None, :] <= (rt + torch.arange(npos))[:, None]
    return torch.where(valid[:, None, :] & sees[None], 0.0, FMIN).to(dev)


# name: (B, query heads, kv heads, hd, P, S, bias, scale, softcap)
CASES = {
    "3": (128, 32, 8, 64, 1, 23, "shared", None, None),
    "3r": (128, 32, 8, 64, 1, T + BUDGET, "rows", None, None),
    "3o": (128, 16, 16, 128, 1, T + BUDGET, "shared", None, None),
    "3g": (128, 8, 4, 256, 1, T + BUDGET, "shared", 256 ** -0.5, 50.0),
    "3s": (128, 32, 8, 64, P, T + P * (BUDGET - 1), "k3", None, None),
    "3s-P2": (128, 32, 8, 64, 2, T + P * (BUDGET - 1), "k3", None, None),
    "3s-P4": (128, 32, 8, 64, 4, T + P * (BUDGET - 1), "k3", None, None),
    "3s-olmoe": (128, 16, 16, 128, P, T + P * (BUDGET - 1), "k3", None, None),
    "3s-gemma": (128, 8, 4, 256, P, T + P * (BUDGET - 1), "k3", 256 ** -0.5, 50.0),
}


def _plan(B, nkv, group, S, hd, npos):
    """This tree's plan of the call (a tree before K3's redesign planned the
    B x P query rows as B x P cache rows)."""
    if "P" in inspect.signature(da.plan).parameters:
        return da.plan(B, nkv, group, S, hd, 2, npos)
    return da.plan(B * npos, nkv, group, S, hd, 2)


def _args(name, dev):
    B, nh, nkv, hd, npos, S, kind, scale, cap = CASES[name]
    gen = torch.Generator(device=dev).manual_seed(19)
    rng = np.random.default_rng(19)
    q = torch.randn(B, nh, npos, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, nkv, S, hd, generator=gen, device=dev).bfloat16() for _ in range(2))
    bias = _bias_k3(B, S, npos, rng, dev) if kind == "k3" else _bias_p1(kind, B, S, rng, dev)
    return q, k, v, bias, scale, cap


def kernels(dev, card):
    outs = {}
    for name, (B, nh, nkv, hd, npos, S, kind, scale, cap) in CASES.items():
        q, k, v, bias, _, _ = args = _args(name, dev)
        outs[name] = da.fused_decode_attention(*args).cpu()
        err = (outs[name].float() - da._decode_attn_plain(*args).cpu().float()).abs().max()
        ms = device_ms(lambda: da.fused_decode_attention(*args))
        mask = bias.view(B if bias.ndim > 1 else 1, 1, npos if kind == "k3" else 1, S).bfloat16()
        lib = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True))
        bound = least_time(nbytes(q, k, v, bias, q), 4 * B * nh * npos * S * hd, q.dtype)
        print(f"  {name}: B {B}, {nh}/{nkv} heads, hd {hd}, P {npos}, S {S}: kernel "
              f"{ms * 1e3!r} us, SDPA {lib * 1e3!r} us, bound {bound['bound_ms'] * 1e3!r} us "
              f"({bound['bound_by']}); max |kernel - twin| {err.item()!r}; plan "
              f"{_plan(B, nkv, nh // nkv, S, hd, npos)} ({card})")
    if not hasattr(da, "_launch"):
        return outs
    print("  K3 under other plans (device time per call; each held to its twin):")
    for name in ("3s", "3s-P2", "3s-P4", "3s-olmoe", "3s-gemma"):
        B, nh, nkv, hd, npos, S, _, scale, cap = CASES[name]
        q, k, v, bias, _, _ = args = _args(name, dev)
        ref = da._decode_attn_plain(*args).float()
        base = _plan(B, nkv, nh // nkv, S, hd, npos)
        # the P = 1 rule's two splits of 64 keys and their merge
        plans = {"plan's": base, "two splits of 64 keys": {
            **base, "chunk": 64, "keys_per_split": 64, "splits": -(-S // 64), "stages": 1}}
        g = nh // nkv
        for pc in sorted({base["pos_chunk"], -(-npos // 2)}, reverse=True):
            tiles = -(-g * pc // 16)
            for nkw in (1, 2) if base["tensor_cores"] else (None,):
                for chunk in CHUNKS:
                    warps = tiles * nkw if nkw else 4
                    if nkw and (16 * nkw > chunk or warps > 4):
                        continue
                    plans[f"pos_chunk {pc}, chunk {chunk}, {warps} warp(s)"] = {
                        **base, "chunk": chunk, "keys_per_split": S, "splits": 1,
                        "stages": 1 if S <= chunk else 2, "warps": warps, "pos_chunk": pc,
                        "pos_chunks": -(-npos // pc)}
        for label, p in plans.items():
            out = torch.empty_like(q)

            def call():
                da._launch(q, k, v, bias, out, p, scale, cap)

            call()
            err = (out.float() - ref).abs().max().item()
            if not err <= 1e-2 * max(1.0, ref.abs().max().item()):
                raise AssertionError(f"{name} under {label}: {err!r} from the twin")
            print(f"    {name} {label}: {device_ms(call) * 1e3!r} us, max |kernel - twin| "
                  f"{err!r}")
    return outs


def serving(dev, card):
    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.serve import Captioner

    cfg = dataclasses.replace(llama.llama32_1b(), eos_token_ids=())
    params = llama.fuse_projections(
        llama.init(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev))
    spec = proj.ProjectorSpec(mm_dim=cs.MM_DIM, lm_dim=cfg.hidden_size)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(cs.SEED + 2),
                   dtype=torch.float32, device=dev)
    embs = np.random.default_rng(cs.SEED).normal(size=(cs.N_REQUESTS, cs.MM_DIM)).astype(
        np.float32)
    ids = {}
    for label, kw in (("plain batch-last bf16", {}), ("speculative k=4", {"speculative": 4})):
        cap = Captioner(cfg, params, spec, pp, max_new_tokens=cs.MAX_NEW, batch_size=128,
                        prefix_ids=cs.PREFIX_IDS, pad_token_id=cs.PAD_ID, **kw)
        cap.caption_ids(embs[:128])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids[label] = cap.caption_ids(embs).cpu()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"  {label}: {cs.N_REQUESTS} requests at batch 128, {secs!r} s, "
              f"{cs.N_REQUESTS / secs!r} captions/s ({card})")
        cs.profile_run(torch, f"batch 128, {label}", lambda: cap.caption_ids(embs[:128]))
    return ids


def main(label: str, kernels_only: bool) -> None:
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    _build.lib()
    print(f"[{label}] kernels ready in {time.perf_counter() - t0!r} s; {card}")
    print("  ptxas: " + "; ".join(f"{n}: {r}, {st}/{ld}" for n, r, st, ld in _build.ptxas_usage(
        _build.build_log) if "decode_attn" in n))
    saved = {"kernels": kernels(dev, card)}
    if not kernels_only:
        saved["ids"] = serving(dev, card)
    os.makedirs(OUT, exist_ok=True)
    torch.save(saved, os.path.join(OUT, f"{label}.pt"))
    print(f"[{label}] done; {card}")


def diff(a: str, b: str) -> None:
    la, lb = (torch.load(os.path.join(OUT, f"{x}.pt")) for x in (a, b))
    for name, x in la["kernels"].items():
        y = lb["kernels"][name]
        print(f"  {name}: bit-equal {torch.equal(x, y)}, max |{a} - {b}| "
              f"{(x.float() - y.float()).abs().max().item()!r}")
    for name, x in la.get("ids", {}).items():
        if name in lb.get("ids", {}):
            print(f"  ids of {name}: equal {torch.equal(x, lb['ids'][name])}")


if __name__ == "__main__":
    if sys.argv[1] == "--diff":
        diff(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1], "--kernels-only" in sys.argv[2:])
