#!/usr/bin/env python3
"""Smoke run of dmi_tpu_torch's greedy serving path on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

1. Builds the CUDA kernels from dmi_tpu_torch/csrc with nvcc (sm_90a).
2. Holds each kernel against its plain PyTorch twin at the serving shapes
   and times both (CUDA events).
3. Runs one decode step of a full-width Llama-3.2-1B from a common cache
   through the kernel path and through the plain path, and compares logits.
4. Serves 300 requests through dmi_tpu_torch.serve.Captioner: Llama-3.2-1B
   at full width (16 layers, bf16 weights from a seeded init, EOS off so
   every request decodes sydney's 22-token budget), a 2-layer f32 projector
   (mm 1024) loaded from a dmi_tpu-format checkpoint, a fixed 15-token chat
   prefix, batch 128 (3 batches, the last one padded).  The kernels' launch
   counters, set to 0 just before, must show that the run went through them.
   Then captions/s at batch 128 and 256 on the same 300 requests, the
   greedy-token agreement of the kernel and plain paths (information only),
   and one batch of each size under torch.profiler: device busy time and
   idle share.

Any mismatch raises and the script exits non-zero.  Output ends with a JSON
line of per-kernel results, the card's `nvidia-smi` name and power limit,
and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
N_REQUESTS = 300
MM_DIM = 1024            # projector input width (bench.py's mm_dim)
MAX_NEW = 22             # sydney's caption budget (dmi_tpu/registry.py:139-141)
# <|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\n, five text
# ids, <|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n: the
# shape of a Llama-3 chat prompt (the text ids are arbitrary)
PREFIX_IDS = [128000, 128006, 882, 128007, 271, 75885, 279, 24088, 2217, 13,
              128009, 128006, 78191, 128007, 271]
PAD_ID = 128009
# tolerances, relative to max(1, max |plain|): f32 differs by summation
# order only; bf16 also by last-bit rounding of outputs (one bf16 ulp is
# 2**-8 relative); logits after 16 bf16 layers by a few such roundings
TOL = {"float32": 1e-4, "bfloat16": 1e-2, "logits": 5e-2}


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, name, out, ref, tol) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    bound = tol * max(1.0, ref.float().abs().max().item())
    ok = bool(torch.isfinite(out.float()).all()) and err <= bound
    print(f"  {name}: max_abs_err {err!r} (bound {bound!r}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    return err


def kernel_phase(torch, dev):
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops import l2_normalize
    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import projector as pk

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    print("kernel fused_mlp2 vs _mlp2_plain (mm 1024, lm 2048):")
    spec = proj.ProjectorSpec(mm_dim=MM_DIM, lm_dim=2048)
    errs, times = [], None
    for B, dtype in ((128, torch.float32), (44, torch.float32), (256, torch.float32),
                     (128, torch.bfloat16)):
        p = proj.init(spec, gen, dtype=dtype, device=dev)["layers"]
        x = l2_normalize(torch.randn(B, MM_DIM, generator=gen, device=dev)).to(dtype)
        args = (x, p[0]["w"], p[0]["b"], p[1]["w"], p[1]["b"])
        name = f"B={B} {str(dtype)[6:]}"
        errs.append(compare(torch, name, pk.fused_mlp2(*args), pk._mlp2_plain(*args),
                            TOL[str(dtype)[6:]]))
        k_ms = time_ms(torch, lambda: pk.fused_mlp2(*args))
        p_ms = time_ms(torch, lambda: pk._mlp2_plain(*args))
        print(f"    kernel {k_ms * 1e3!r} us/call, plain {p_ms * 1e3!r} us/call")
        if times is None:
            times = (k_ms, p_ms)  # the serving case: f32, B = 128
    results["mlp2"] = (max(errs), *times)

    print("kernel fused_decode_attention vs _decode_attn_plain "
          "(32/8 heads, hd 64, k/v views of a 38-slot cache):")
    errs, times, cap_moves = [], None, []
    cases = [(128, 16, torch.bfloat16, None), (128, 23, torch.bfloat16, None),
             (128, 38, torch.bfloat16, None), (128, 38, torch.bfloat16, 50.0),
             (128, 38, torch.bfloat16, 2.0), (128, 38, torch.float32, None),
             (256, 23, torch.bfloat16, None)]
    for B, S, dtype, cap in cases:
        q = torch.randn(B, 32, 1, 64, generator=gen, device=dev).to(dtype)
        kc = torch.randn(B, 8, 38, 64, generator=gen, device=dev).to(dtype)
        vc = torch.randn(B, 8, 38, 64, generator=gen, device=dev).to(dtype)
        args = (q, kc[:, :, :S], vc[:, :, :S], torch.zeros(S, device=dev), None, cap)
        name = f"B={B} S={S} {str(dtype)[6:]}" + (f" softcap={cap}" if cap else "")
        ref = da._decode_attn_plain(*args)
        errs.append(compare(torch, name, da.fused_decode_attention(*args), ref,
                            TOL[str(dtype)[6:]]))
        if cap is not None:
            # how far the cap moves the twin's output, against the bound of
            # the comparison: a cap that moves it less cannot be checked
            move = (ref.float() - da._decode_attn_plain(*args[:5]).float()).abs().max().item()
            bound = TOL[str(dtype)[6:]] * max(1.0, ref.float().abs().max().item())
            print(f"    softcap moves the twin's output by {move!r} (bound {bound!r})")
            cap_moves.append(move > bound)
        k_ms = time_ms(torch, lambda: da.fused_decode_attention(*args), iters=100)
        p_ms = time_ms(torch, lambda: da._decode_attn_plain(*args), iters=100)
        print(f"    kernel {k_ms * 1e3!r} us/call, plain {p_ms * 1e3!r} us/call")
        if (B, S, dtype, cap) == (128, 23, torch.bfloat16, None):
            times = (k_ms, p_ms)  # mid-decode on the serving path
    if not any(cap_moves):
        raise AssertionError("no softcap case binds: the kernel's softcap is unchecked")
    results["decode_attention"] = (max(errs), *times)
    return results


def decode_step_phase(torch, dev, cfg, params):
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import llama

    B, T = 128, 16
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    with torch.no_grad():
        caches = dec.init_cache(cfg, B, T + 22, dev)
        logits = dec.prefill(cfg, params, llama.embed_tokens(cfg, params, ids), caches)
        emb = llama.embed_tokens(cfg, params, logits.argmax(-1))[:, None, :]
        out = {}
        for plain in (False, True):
            c = (caches[0].clone(), caches[1].clone())
            out[plain] = dec.decode_step(cfg, params, emb, c, T, plain=plain)
    print("decode step (B 128, position 16) kernel path vs plain path:")
    compare(torch, "logits bf16", out[False], out[True], TOL["logits"])
    agree = (out[False].argmax(-1) == out[True].argmax(-1)).float().mean().item()
    print(f"  next-token agreement {agree!r}")


def profile_batch(torch, cap, embs) -> None:
    """Where one batch's time goes: its wall time unprofiled (median of 3),
    then one run under torch.profiler.  Device busy time is the union of the
    trace's kernel, memcpy and memset intervals; the idle share is
    1 - busy / unprofiled wall.  Prints the five kernels that take most."""
    from torch.profiler import ProfilerActivity, profile

    batch = embs[:cap.batch_size]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        cap.caption_ids(batch)  # returns on the host: synchronised
        walls.append(time.perf_counter() - t0)
    wall_ms = sorted(walls)[1] * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cap.caption_ids(batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy_ms = busy_us / 1e3
    print(f"  batch {cap.batch_size}: wall {wall_ms!r} ms unprofiled, device busy "
          f"{busy_ms!r} ms ({len(spans)} device ops), idle share "
          f"{1 - busy_ms / wall_ms!r}, profiled wall {(end - spans[0][0]) / 1e3!r} "
          f"ms from first to last device op")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {us / 1e3!r} ms {name[:100]}")


def slice_phase(torch, dev, cfg, params, max_new, n_requests=N_REQUESTS, mm_dim=MM_DIM):
    """Serve n_requests through the Captioner at batch 128 with the launch
    counters set to 0 just before; check ids and counts; then the plain
    path and batch 256 on the same requests.  Returns the launch counts."""
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import projector as pk
    from dmi_tpu_torch.serve import Captioner
    from dmi_tpu_torch.training.checkpoint import load_pytree

    spec = proj.ProjectorSpec(mm_dim=mm_dim, lm_dim=cfg.hidden_size)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(SEED + 2),
                   dtype=torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke-checkpoint-projector-best.pt")
        with open(path, "wb") as f:  # dmi_tpu's save_pytree envelope
            pickle.dump({
                "step_idx": 0,
                "projector_state_dict": {"layers": [
                    {n: t.cpu().numpy() for n, t in layer.items()} for layer in pp["layers"]
                ]},
                "optimizer_state_dict": None,
                "coco_cider": 0.0,
            }, f)
        tree = load_pytree(path)["projector_state_dict"]
    pparams = {"layers": [{n: torch.as_tensor(a, device=dev) for n, a in layer.items()}
                          for layer in tree["layers"]]}

    def captioner(batch_size):
        return Captioner(cfg, params, spec, pparams, max_new_tokens=max_new,
                         batch_size=batch_size, prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID)

    embs = np.random.default_rng(SEED).normal(size=(n_requests, mm_dim)).astype(np.float32)
    cap = captioner(128)
    cap.caption_ids(embs[:128])  # warm-up (cuBLAS handles, allocator)

    pk.launches = da.launches = 0
    t0 = time.perf_counter()
    ids = cap.caption_ids(embs)
    secs = time.perf_counter() - t0
    launches = {"mlp2": pk.launches, "decode_attention": da.launches}
    n_batches = -(-n_requests // 128)
    want = {"mlp2": n_batches,
            "decode_attention": cfg.num_hidden_layers * (max_new - 1) * n_batches}
    print(f"slice run: {n_requests} requests at batch 128, {secs!r} s, "
          f"{n_requests / secs!r} captions/s; launches {launches} (expected {want})")
    if tuple(ids.shape) != (n_requests, max_new):
        raise AssertionError(f"caption ids shape {tuple(ids.shape)}")
    if not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError("caption ids outside [0, vocab)")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")

    t0 = time.perf_counter()
    ids_plain = cap.caption_ids(embs, plain=True)
    plain_secs = time.perf_counter() - t0
    print(f"plain path: {plain_secs!r} s, {n_requests / plain_secs!r} captions/s; "
          f"token agreement with the kernel path "
          f"{(ids == ids_plain).float().mean().item()!r}, rows identical "
          f"{(ids == ids_plain).all(dim=1).float().mean().item()!r}")

    cap256 = captioner(256)
    cap256.caption_ids(embs[:256])  # warm-up
    t0 = time.perf_counter()
    ids256 = cap256.caption_ids(embs)
    secs256 = time.perf_counter() - t0
    print(f"batch 256: {n_requests} requests, {secs256!r} s, "
          f"{n_requests / secs256!r} captions/s; token agreement with batch 128 "
          f"{(ids256 == ids).float().mean().item()!r}")

    print("where one batch's time goes:")
    for c in (cap, cap256):
        profile_batch(torch, c, embs)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.lib()
    built = (f"nvcc build {_build.build_seconds!r} s" if _build.build_seconds is not None
             else "library reused from dmi_tpu_torch/_build")
    print(f"kernels: {built}, loaded in {time.perf_counter() - t0!r} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    kernels = kernel_phase(torch, dev)

    # Llama-3.2-1B at full width, EOS off as bench.py:252 has it
    cfg = dataclasses.replace(llama.llama32_1b(), eos_token_ids=())
    params = llama.fuse_projections(
        llama.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    decode_step_phase(torch, dev, cfg, params)
    launches = slice_phase(torch, dev, cfg, params, MAX_NEW)

    sources = {"mlp2": ("fused_mlp2", "dmi_tpu_torch/csrc/mlp2.cu",
                        "dmi_tpu/ops/pallas/projector.py:167"),
               "decode_attention": ("fused_decode_attention",
                                    "dmi_tpu_torch/csrc/decode_attn.cu",
                                    "dmi_tpu/ops/pallas/decode_attn.py:121")}
    report = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[key], "max_abs_err": kernels[key][0],
               "ms": kernels[key][1], "plain_ms": kernels[key][2]}
              for key, (name, src, rep) in sources.items()]
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
