#!/usr/bin/env python3
"""Smoke run of dmi_tpu_torch's serving and stage-1 training paths on one
CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

1. Builds the CUDA kernels from dmi_tpu_torch/csrc with nvcc (sm_90a).
2. Holds each kernel against its plain PyTorch twin and times both (CUDA
   events): the projector MLP2 and the decode attention at the serving
   shapes; the flash attention forward and both backward kernels (dK/dV,
   dQ) at Llama-3.2-1B's heads, B 32, T 65 (stage 1), 128 and 606
   (sharegpt4video's budget), bf16 and f32, with and without a key mask.
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
5. Trains: dmi_tpu_torch.training.projector_trainer.ProjectorTrainer on the
   same Llama-3.2-1B with a 2-layer f32 projector (mm 768, dropout 0.1) and
   the optimizer of configs/experiments/projector/v1:llama1b_inst_all_
   extracted.json (warmup cut to 2), on synthetic batches of 32 captions
   (64 text tokens and the soft token).  Step 0's loss and projector
   gradients through the kernels against the plain path; 10 micro-steps
   with the launch counters set to 0 just before (each flash kernel must
   run 16 x 10 times), finite losses, a projector that moves and an LLM
   that does not; one eval-loss call through fused_mlp2 with parameters
   that require grad; micro-steps/s, tokens/s, peak memory and one step
   under torch.profiler.

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
# flash gradients at bf16: p and dS are rounded to bf16 before their
# products in the kernels, as on the TPU
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_HEADS = (32, 8, 64)  # Llama-3.2-1B: query heads, kv heads, head dim
TRAIN_STEPS = 10
TRAIN_BATCH, TRAIN_TEXT = 32, 64  # the v1 config's train_batch_size; text tokens
TRAIN_MM_DIM, TRAIN_DROPOUT = 768, 0.1  # the v1 config's mm_dim and proj_dropout
# the TrainArgs fields the trainer's step reads, from
# configs/experiments/projector/v1:llama1b_inst_all_extracted.json, with the
# warmup cut from 1000 to 2 steps so that the LR is nonzero within the run
TRAIN_ARGS = dict(
    learning_rate=1e-4, adam_beta1=0.9, adam_beta2=0.95, adam_epsilon=1e-8,
    weight_decay=5e-6, max_grad_norm=1.0, scheduler="cosine_warmup", warmup_steps=2,
    gradient_accumulation_steps=1, seed=SEED, mesh_shape=None,
    finetune_from_checkpoint=None,
)


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


def profile_run(torch, label, run) -> dict:
    """Where one call of run() goes: its wall time unprofiled (median of 3,
    synchronised), then one call under torch.profiler.  Device busy time is
    the union of the trace's kernel, memcpy and memset intervals; the idle
    share is 1 - busy / unprofiled wall.  Prints the five kernels that take
    most."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = sorted(walls)[1] * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
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
    idle = 1 - busy_ms / wall_ms
    print(f"  {label}: wall {wall_ms!r} ms unprofiled, device busy "
          f"{busy_ms!r} ms ({len(spans)} device ops), idle share "
          f"{idle!r}, profiled wall {(end - spans[0][0]) / 1e3!r} "
          f"ms from first to last device op")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {us / 1e3!r} ms {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle}


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
        profile_run(torch, f"batch {c.batch_size}",
                    lambda c=c: c.caption_ids(embs[:c.batch_size]))
    return launches


def flash_phase(torch, dev):
    """The flash attention kernels against their twin's autograd: output,
    dQ, dK and dV, at Llama-3.2-1B's heads, B 32; then the times of each
    kernel and of the twin at bf16 without a mask (the training path's
    call)."""
    from dmi_tpu_torch.ops.cuda import flash_attn as fa

    nh, nkv, hd = FLASH_HEADS
    B = TRAIN_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = {"fwd": [], "dkv": [], "dq": []}
    times = {}
    print(f"kernels flash attention vs _flash_attn_plain ({nh}/{nkv} heads, hd {hd}, B {B}, "
          "q/k/v in a block's [B, T, heads, hd] layout):")
    for T in (TRAIN_TEXT + 1, 128, 606):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            for masked in (False, True):
                q, k, v = (torch.randn(B, T, n, hd, generator=gen, device=dev).to(dtype)
                           .transpose(1, 2).requires_grad_() for n in (nh, nkv, nkv))
                mask = None
                if masked:  # a ragged tail per row; key 0 (the soft token) stays
                    lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
                    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).to(torch.int32)
                do = torch.randn(B, nh, T, hd, generator=gen, device=dev).to(dtype)
                name = f"T={T} {dname}" + (" key-mask" if masked else "")
                out = fa.flash_attention(q, k, v, mask, 0.125)
                ref = fa._flash_attn_plain(q, k, v, mask, 0.125)
                got = torch.autograd.grad(out, (q, k, v), do)
                want = torch.autograd.grad(ref, (q, k, v), do)
                errs["fwd"].append(compare(torch, f"{name} out", out.detach(), ref.detach(),
                                           TOL[dname]))
                errs["dq"].append(compare(torch, f"{name} dq", got[0], want[0],
                                          GRAD_TOL[dname]))
                errs["dkv"].append(max(
                    compare(torch, f"{name} dk", got[1], want[1], GRAD_TOL[dname]),
                    compare(torch, f"{name} dv", got[2], want[2], GRAD_TOL[dname])))
                if masked or dtype != torch.bfloat16:
                    continue
                q, k, v = (t.detach() for t in (q, k, v))
                o, lse = fa._fwd_kernel(q, k, v, None, 0.125)
                delta = fa._delta(do, o)
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

                def plain_fwd_bwd():
                    torch.autograd.grad(fa._flash_attn_plain(qg, kg, vg, None, 0.125),
                                        (qg, kg, vg), do)

                t = {
                    "fwd": time_ms(torch, lambda: fa._fwd_kernel(q, k, v, None, 0.125)),
                    "dkv": time_ms(torch, lambda: fa._bwd_dkv_kernel(q, k, v, None, do, lse,
                                                                     delta, 0.125)),
                    "dq": time_ms(torch, lambda: fa._bwd_dq_kernel(q, k, v, None, do, lse,
                                                                   delta, 0.125)),
                    "plain_fwd": time_ms(torch, lambda: fa._flash_attn_plain(q, k, v, None,
                                                                             0.125)),
                    "plain_fwd_bwd": time_ms(torch, plain_fwd_bwd),
                }
                print(f"    T={T} bf16: kernels forward {t['fwd'] * 1e3!r} us, backward dK/dV "
                      f"{t['dkv'] * 1e3!r} us, dQ {t['dq'] * 1e3!r} us; twin forward "
                      f"{t['plain_fwd'] * 1e3!r} us, forward+backward "
                      f"{t['plain_fwd_bwd'] * 1e3!r} us")
                if T == TRAIN_TEXT + 1:
                    times = t  # the training path's call
    plain_bwd = times["plain_fwd_bwd"] - times["plain_fwd"]
    return {"flash_fwd": (max(errs["fwd"]), times["fwd"], times["plain_fwd"]),
            "flash_bwd_dkv": (max(errs["dkv"]), times["dkv"], plain_bwd),
            "flash_bwd_dq": (max(errs["dq"]), times["dq"], plain_bwd)}


class SyntheticCaptions:
    """A stage-1 data source: TRAIN_BATCH rows of a chat prompt (PREFIX_IDS),
    caption tokens and an end token, right-padded to TRAIN_TEXT, in the
    collator's schema (input_ids, attention_mask, labels with -100 over the
    prompt and the pad id on right pads) with embs [TRAIN_BATCH, mm].  Made
    with numpy from (SEED, step)."""

    def __init__(self, steps, vocab):
        self.steps, self.vocab = steps, vocab

    def total_train_steps(self):
        return self.steps

    def train_batch(self, step):
        rng = np.random.default_rng((SEED, 5, step))
        B, T, P = TRAIN_BATCH, TRAIN_TEXT, len(PREFIX_IDS)
        lens = rng.integers(P + 8, T + 1, size=B)
        lens[0] = T
        ids = np.full((B, T), PAD_ID, np.int32)
        mask = np.zeros((B, T), np.int32)
        labels = np.full((B, T), PAD_ID, np.int64)
        for b, n in enumerate(lens):
            row = PREFIX_IDS + list(rng.integers(0, 128000, size=n - P - 1)) + [PAD_ID]
            ids[b, :n] = row
            mask[b, :n] = 1
            labels[b, :n] = row
            labels[b, :P] = -100
        embs = rng.normal(size=(B, TRAIN_MM_DIM)).astype(np.float32)
        return {"input_ids": ids, "attention_mask": mask, "labels": labels, "embs": embs}


def train_phase(torch, dev, cfg, params):
    """Stage-1 training through ProjectorTrainer at full width; returns the
    flash kernels' launch counts of the 10 micro-steps."""
    import types

    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops.cuda import flash_attn as fa
    from dmi_tpu_torch.ops.cuda import projector as pk
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer

    spec = proj.ProjectorSpec(mm_dim=TRAIN_MM_DIM, lm_dim=cfg.hidden_size,
                              dropout=TRAIN_DROPOUT)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(SEED + 4), device=dev)
    data = SyntheticCaptions(TRAIN_STEPS, cfg.vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(**TRAIN_ARGS, checkpoint_dir=tmp)
        trainer = ProjectorTrainer("smoke", cfg, params, spec, pp, [data],
                                   [EmbeddingManager("smoke-encoder", device=dev)], None, args)
        batches = [(0, data.train_batch(step)) for step in range(TRAIN_STEPS)]

        print("training step 0, kernel path vs plain path (loss and projector gradients):")
        step0 = {}
        for plain in (False, True):
            loss = trainer.micro_loss(0, batches[0], plain=plain)
            step0[plain] = (loss.detach(), torch.autograd.grad(loss, trainer.leaves))
        compare(torch, "loss", step0[False][0], step0[True][0], TOL["logits"])
        for i, (g, gp) in enumerate(zip(step0[False][1], step0[True][1])):
            err = compare(torch, f"grad leaf {i} {tuple(g.shape)}", g, gp, TOL["logits"])
            print(f"    max |plain grad| {gp.abs().max().item()!r}, relative error "
                  f"{err / max(gp.abs().max().item(), 1e-30)!r}")

        llm_before = [t.clone() for lw in trainer.llm_params["layers"] for t in lw.values()]
        llm_before += [trainer.llm_params["embed"].clone(),
                       trainer.llm_params["final_norm"].clone()]
        proj_before = [t.detach().clone() for t in trainer.leaves]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pk.launches = fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
        t0 = time.perf_counter()
        losses = [trainer.train_step(step, TRAIN_STEPS, batches[step])[0]
                  for step in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"flash_fwd": fa.fwd_launches, "flash_bwd_dkv": fa.dkv_launches,
                    "flash_bwd_dq": fa.dq_launches}
        mlp2_in_training = pk.launches
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).float().cpu()
        positions = TRAIN_STEPS * TRAIN_BATCH * (TRAIN_TEXT + 1)
        print(f"training run: {TRAIN_STEPS} micro-steps at batch {TRAIN_BATCH}, T "
              f"{TRAIN_TEXT + 1}: {secs!r} s, {TRAIN_STEPS / secs!r} micro-steps/s, "
              f"{positions / secs!r} tokens/s (sequence positions); peak device memory "
              f"{peak / 2**30!r} GiB; losses {losses.tolist()}; launches {launches}")
        want = cfg.num_hidden_layers * TRAIN_STEPS
        if launches != dict.fromkeys(launches, want) or mlp2_in_training:
            raise AssertionError(f"training launches {launches}, mlp2 {mlp2_in_training}: "
                                 f"expected {want} of each flash kernel and no mlp2")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("a training loss is not finite")
        moved = [not torch.equal(a, b.detach()) for a, b in zip(proj_before, trainer.leaves)]
        llm_after = [t for lw in trainer.llm_params["layers"] for t in lw.values()]
        llm_after += [trainer.llm_params["embed"], trainer.llm_params["final_norm"]]
        unchanged = all(torch.equal(a, b) for a, b in zip(llm_before, llm_after))
        print(f"  projector leaves moved {moved}; every LLM parameter bit-unchanged {unchanged}")
        if not all(moved) or not unchanged:
            raise AssertionError("the projector must move and the LLM must not")
        del llm_before

        batch = batches[0][1]
        pk.launches = fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
        ev = trainer.eval_loss(trainer.emb_mgrs[0].get_embeddings(batch["embs"]),
                               *trainer._device_batch(batch))
        ev_launches = (pk.launches, fa.fwd_launches, fa.dkv_launches, fa.dq_launches)
        print(f"eval loss {ev.item()!r} with parameters that require grad "
              f"({all(t.requires_grad for t in trainer.leaves)}); launches mlp2, flash "
              f"forward, dK/dV, dQ: {ev_launches}")
        if not (bool(torch.isfinite(ev)) and ev_launches == (1, cfg.num_hidden_layers, 0, 0)):
            raise AssertionError(f"eval loss {ev.item()} with launches {ev_launches}")

        print("where one training micro-step's time goes:")
        extra = iter(range(TRAIN_STEPS, TRAIN_STEPS + 10))
        profile_run(torch, f"micro-step, batch {TRAIN_BATCH}",
                    lambda: trainer.train_step(next(extra), TRAIN_STEPS, batches[1]))
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
    kernels.update(flash_phase(torch, dev))

    # Llama-3.2-1B at full width, EOS off as bench.py:252 has it
    cfg = dataclasses.replace(llama.llama32_1b(), eos_token_ids=())
    params = llama.fuse_projections(
        llama.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    decode_step_phase(torch, dev, cfg, params)
    launches = slice_phase(torch, dev, cfg, params, MAX_NEW)
    launches.update(train_phase(torch, dev, cfg, params))
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in ("dmi_tpu", "jax"))
    if jax_side:
        raise AssertionError(f"the smoke loaded modules of the JAX side: {jax_side}")

    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    sources = {"mlp2": ("fused_mlp2", "dmi_tpu_torch/csrc/mlp2.cu",
                        "dmi_tpu/ops/pallas/projector.py:167"),
               "decode_attention": ("fused_decode_attention",
                                    "dmi_tpu_torch/csrc/decode_attn.cu",
                                    "dmi_tpu/ops/pallas/decode_attn.py:121"),
               "flash_fwd": ("flash_attention forward", "dmi_tpu_torch/csrc/flash_attn_fwd.cu",
                             f"dmi_tpu/models/llama.py:1086 ({flash}:758 "
                             "_flash_attention_impl)"),
               "flash_bwd_dkv": ("flash_attention backward dK/dV",
                                 "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                 f"dmi_tpu/models/llama.py:1086 ({flash}:1121 "
                                 "_flash_attention_bwd_dkv)"),
               "flash_bwd_dq": ("flash_attention backward dQ",
                                "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                f"dmi_tpu/models/llama.py:1086 ({flash}:1456 "
                                "_flash_attention_bwd_dq)")}
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
