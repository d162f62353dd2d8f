#!/usr/bin/env python3
"""Smoke run of dmi_tpu_torch's serving paths (batch-first, batch-last,
quantized) and its three training stages (with the LoRA baseline) on one
CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

1. Builds the CUDA kernels from dmi_tpu_torch/csrc with nvcc (sm_90a) and
   prints ptxas's register and spill counts of every kernel instance.
2. Holds each kernel against its plain PyTorch twin at the shapes of every
   path that runs it, and times it, the twin and one PyTorch library call of
   the same function (device time per call: CUDA events around calls queued
   behind a spin kernel, utils.profiling.device_ms) beside its bound (the
   bytes it must move over the memory rate or its operations over the peak
   rate, whichever is larger) and its ratio to the library call: the
   projector MLP2 at serving's and stage 3's shapes (timed at batch 64, 128
   and 256); the decode attention at serving's and stage 3's (S 1 to 38;
   timed at B 128 and 256, S 23 and at B 64, S 37, with each call's launch
   plan and, at B 128, the wrapper's host time per call), and over caches of
   3073 and 16384 positions (S split over blocks and merged; a finfo.min
   tail, and finfo.min over whole splits; both timed), two calls held
   bit-equal at B 128, S 23 and at B 2, S 16384; the flash attention forward
   and both backward kernels (dK/dV, dQ) at Llama-3.2-1B's heads and the
   (B, T) of stage 1, stage 2, stage 3 and the LoRA baseline (each path's
   call timed, and the whole backward as training runs it, _delta with both
   kernels, against SDPA's backward), of T 128 and of T 606
   (sharegpt4video's budget), bf16 and f32, with and without a key mask; the
   LoRA layer-0 kernel at stage 2's and stage 3's shapes, f32 and bf16, one
   and four adapter groups; the packed W4A8 matmul (and its W8A8 variant) at
   Llama-3.2-1B's four layer matmuls, bit for bit, at batch 128, 8, 64, 100
   and at shapes off every vector width; the decode MLP (silu, tanh-GELU) at
   H 2048, I 8192, batch 128, 8, 16, 64, 100, 256, bf16 and f32 (bf16 silu
   timed at batch 8, 64, 100, 128 and 256 with each call's launch plan, and
   at 128 the wrapper's host time per call); the fused head + argmax in its
   three weight modes at V 128256 and at a V no slice divides, with ties
   planted across vocab slices (q8 bit for bit; bf16 and q by the share of
   equal ids and, for every other column, the twin's two logits within one
   bf16 step per rounding).
3. The kernel probes (dmi_tpu_torch.probes), each through its run() at its
   default shapes with the launch counters set to 0 just before: the
   blocked int8/bf16 matmul at N 4096, the weight-stream matmul at the
   decode MLP's gate-up shape at each output-tile width, the packed-W4
   matmuls (split-OUT, split-K) at K 2048, OUT 16384, batch 256.  Each
   probe's gate holds its kernels against their twins (int outputs bit for
   bit) before it times kernel, twin and library call.
4. Runs one decode step of a full-width Llama-3.2-1B from a common cache
   through the kernel path and through the plain path, batch-first and
   batch-last, and compares logits.
5. Serves 300 requests through dmi_tpu_torch.serve.Captioner on the
   batch-first loop: Llama-3.2-1B at full width (16 layers, bf16 weights
   from a seeded init, EOS off so every request decodes sydney's 22-token
   budget), a 2-layer f32 projector (mm 1024) loaded from a dmi_tpu-format
   checkpoint, a fixed 15-token chat prefix, batch 128 (3 batches, the last
   one padded).  The kernels' launch counters, set to 0 just before, must
   show that the run went through them.  Then captions/s at batch 128 and
   256 on the same 300 requests, the greedy-token agreement of the kernel
   and plain paths (information only), and one batch of each size under
   torch.profiler: device busy time and idle share.
6. Serves the same 300 requests on the batch-last loop, the Captioner's
   default, in four configurations with the counters set to 0 before each:
   (a) the bf16 tree (per batch: 16 x 21 decode-MLP and decode-attention
   launches, 21 head + argmax launches, 1 mlp2), also against the plain
   path and against batch_first=True by token agreement; (b) int8="w4a8" (4
   x 16 x 21 packed-matmul launches per batch), also against its plain path;
   and one batch each of (c) int8=True and (d) int8="w8a8".  Captions/s of
   each, and one bf16 and one w4a8 batch under torch.profiler.  No weight's
   TMA descriptor is encoded again after each run's warm-up batch.
7. Stage 1: ProjectorTrainer on the same Llama-3.2-1B with a 2-layer f32
   projector (mm 768, dropout 0.1) and the optimizer of configs/experiments/
   projector/v1:llama1b_inst_all_extracted.json (warmup cut to 2), on
   synthetic batches of 32 captions (64 text tokens and the soft token).
   Step 0's loss and projector gradients through the kernels against the
   plain path; 10 micro-steps with the launch counters set to 0 just before
   (each flash kernel must run 16 x 10 times), finite losses, a projector
   that moves and an LLM that does not; one eval-loss call through
   fused_mlp2; micro-steps/s, tokens/s, peak memory and one step under
   torch.profiler.
8. Stage 2: HypernetTrainer at the v4 hypernet config's shapes (attention
   hypernet, positional encodings, width 768, rank 32, subsets of 128,
   rotation augmentation and text interleave, AdamW and accumulation 40,
   warmup cut to 2) over a frozen f32 projector (mm 768), micro-batches of
   4 captions of 328 text tokens.  Step 0 kernel vs plain path; 80
   micro-steps (lora0 exactly 80 launches, each flash kernel 16 x 80), a
   hypernet that moves, a frozen projector and LLM that do not; one eval
   loss; one coalesced window of 40 at micro_batch_coalesce 4 (10 grouped
   lora0 launches); the card's time of one 768 x 768 random_orthogonal;
   throughput, peak memory and one micro-step under torch.profiler.
9. Stage 3: the generated projector from one subset of the stage-2
   hypernet; step 0 kernel vs plain path; 5 few-shot micro-steps over it at
   batch 64 on sydney-length captions, then one generate batch of 64 through
   it on the batch-last loop (1 mlp2 launch, 16 x 21 decode-attention and
   decode-MLP launches, 21 head + argmax launches); then 2 few-shot
   micro-steps that tune the hypernet itself (finetune_generated_projector
   false: 1 lora0 launch each).
10. The LoRA baseline: LoraTrainer at the v3 config's shapes (batch 64, rank
   32, alpha 32): step 0 kernel vs plain path, then 5 micro-steps (each
   flash kernel 16 x 5).

Step 0 of every training path compares the loss within TOL["loss"] of the
plain path's and each trainable leaf's gradient within TOL["logits"] of
that leaf's own largest plain gradient.

Any mismatch raises and the script exits non-zero.  Output ends with a JSON
line of per-kernel results, the card's `nvidia-smi` name and power limit,
and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

from dmi_tpu_torch.utils.profiling import (device_ms, device_spans, least_time, nbytes,
                                           nvidia_smi)

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
# 2**-8 relative); logits after 16 bf16 layers by a few such roundings; a
# training loss, the mean of the log-softmax over thousands of positions,
# averages those roundings out
TOL = {"float32": 1e-4, "bfloat16": 1e-2, "logits": 5e-2, "loss": 1e-3}
# flash gradients at bf16: p and dS are rounded to bf16 before their
# products in the kernels, as on the TPU
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_HEADS = (32, 8, 64)  # Llama-3.2-1B: query heads, kv heads, head dim
# greedy tokens of two paths over random bf16 weights: the logits are nearly
# flat, a near-tie argmax flips under another summation order and the row's
# continuation then differs, so agreement is held to a share of the tokens.
# Two paths that computed different functions would agree on about none of
# the 128256-way choices
TOKEN_AGREEMENT = 0.3
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
# stage 2 at configs/experiments/hypernet/v4:llama1b_inst_all.json's shapes:
# micro-batches of 4 captions of sharegpt4v's 328-token budget
# (dmi_tpu/registry.py:110-112), conditioning subsets of 128, the attention
# hypernet (positional encodings, width 768, rank 32, alpha 32, biases);
# 80 micro-steps are 2 updates at its accumulation of 40
HN_STEPS, HN_ACCUM, HN_COALESCE = 80, 40, 4
HN_BATCH, HN_TEXT, HN_SUBSET, HN_RANK = 4, 328, 128, 32
HN_ARGS = dict(TRAIN_ARGS, gradient_accumulation_steps=HN_ACCUM,
               feed_txt_embs=True, augment_emb_space=True, finetune_mm_dim=None,
               micro_batch_coalesce=1, subset_batch_size=HN_SUBSET)
HN_SPEC = dict(lm_dim=2048, mm_dim=768, n_tokens=HN_SUBSET, arch="attention", hypnet_dim=768,
               rank=HN_RANK, alpha=32, predict_bias=True, n_proj_layers=2, use_pos_encs=True)
# stage 3 and the LoRA baseline: batch 64 (the v6 few-shot and v3 LoRA
# configs) of sydney-length captions: the prompt, 22 caption tokens, an end
# token; v6's accumulation of 1 and few-shot defaults; v3's optimizer
FS_STEPS, FS_BATCH, FS_TEXT = 5, 64, len(PREFIX_IDS) + MAX_NEW + 1
FS_ARGS = dict(HN_ARGS, gradient_accumulation_steps=1)
FEWSHOT = dict(finetune_generated_projector=True, fewshot_n_adapters="one",
               fewshot_learning_rate=1e-4, fewshot_weight_decay=5e-6)
LORA_ARGS = dict(TRAIN_ARGS, adam_beta2=0.999, scheduler=None, gradient_accumulation_steps=1)
FS_HN_STEPS = 2  # few-shot micro-steps that tune the hypernet itself
# the flash kernels' (B, T): stage 1, stage 2, stage 3 and the LoRA baseline
# (the paths' own calls, timed), then longer sequences at stage 1's batch
FLASH_PATHS = ((TRAIN_BATCH, TRAIN_TEXT + 1), (HN_BATCH, HN_TEXT + 1), (FS_BATCH, FS_TEXT + 1))
FLASH_CASES = FLASH_PATHS + ((TRAIN_BATCH, 128), (TRAIN_BATCH, 606))
PROBE_INNER = 5  # timed calls per probe variant (the scripts' --inner is 30-100)


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean time of one fn() in ms, from CUDA events around `iters` calls,
    host launches and host waits included: for a call that is more than
    kernels (the rotation's QR)."""
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


def host_us(torch, fn, n=200) -> float:
    """Host time of one fn() in us: a host clock around n calls that are
    enqueued, read before the synchronise (what a loop whose host sets its
    pace pays a call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def compare(torch, name, out, ref, tol, scale=None) -> float:
    """Max |out - ref| against tol * scale, where scale defaults to
    max(1, max |ref|)."""
    err = (out.float() - ref.float()).abs().max().item()
    if scale is None:
        scale = max(1.0, ref.float().abs().max().item())
    bound = tol * scale
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

    print("kernel fused_mlp2 vs _mlp2_plain (lm 2048):")
    errs, times = [], {}
    # serving (mm 1024: B 128, a ragged 44, 1 row, 64, one row past a tile
    # multiple, 256, bf16), then stage 3's generate through the generated
    # projector (mm 768, B 64); the f32 serving batches are timed
    for B, mm, dtype in ((128, MM_DIM, torch.float32), (44, MM_DIM, torch.float32),
                         (1, MM_DIM, torch.float32), (64, MM_DIM, torch.float32),
                         (132, MM_DIM, torch.float32), (256, MM_DIM, torch.float32),
                         (128, MM_DIM, torch.bfloat16), (FS_BATCH, TRAIN_MM_DIM, torch.float32)):
        spec = proj.ProjectorSpec(mm_dim=mm, lm_dim=2048)
        p = proj.init(spec, gen, dtype=dtype, device=dev)["layers"]
        x = l2_normalize(torch.randn(B, mm, generator=gen, device=dev)).to(dtype)
        args = (x, p[0]["w"], p[0]["b"], p[1]["w"], p[1]["b"])
        name = f"B={B} mm={mm} {str(dtype)[6:]}"
        errs.append(compare(torch, name, pk.fused_mlp2(*args), pk._mlp2_plain(*args),
                            TOL[str(dtype)[6:]]))
        if mm == MM_DIM and dtype == torch.float32 and B in (64, 128, 256):
            x, w0, b0, w1, b1 = args
            times[B] = {**device_times(
                torch, lambda: pk.fused_mlp2(*args), lambda: pk._mlp2_plain(*args),
                lambda: torch.addmm(b1, torch.nn.functional.gelu(torch.addmm(b0, x, w0),
                                                                 approximate="tanh"), w1)),
                     **least_time(nbytes(*args) + B * w1.shape[1] * x.element_size(),
                                  2 * B * (w0.numel() + w1.numel()), dtype)}
            print(f"    {report_times(times[B])}; library: addmm, gelu, addmm")
    times = times[128]  # the serving batch: the kernels line
    results["mlp2"] = {"max_abs_err": max(errs), **times}

    print("kernel fused_decode_attention vs _decode_attn_plain "
          "(32/8 heads, hd 64, k/v views of a 38-slot cache):")
    errs, times, cap_moves = [], None, []

    def attn_times(B, S, args, mask=None):
        q, k, v, bias = args[:4]
        t = {**device_times(
            torch, lambda: da.fused_decode_attention(*args), lambda: da._decode_attn_plain(*args),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)),
             **least_time(nbytes(q, k, v, bias, q), 4 * B * 32 * S * 64, q.dtype)}
        print(f"    B={B} S={S}: {report_times(t)}; library: scaled_dot_product_attention, GQA"
              f"{', with the mask' if mask is not None else ''}; plan "
              f"{da.plan(B, 8, 4, S, 64, q.element_size())}")
        return t

    def bit_equal(name, fn):
        if not torch.equal(fn(), fn()):
            raise AssertionError(f"{name}: two calls on the same inputs differ")
        print(f"    {name}: two calls bit-equal")

    # serving at B 128 and 256; stage 3's generate at B 64 (a prompt of 16
    # positions, so S 17 at its first decode step and 37 at its last)
    cases = [(128, 1, torch.bfloat16, None), (128, 16, torch.bfloat16, None),
             (128, 23, torch.bfloat16, None),
             (128, 38, torch.bfloat16, None), (128, 38, torch.bfloat16, 50.0),
             (128, 38, torch.bfloat16, 2.0), (128, 38, torch.float32, None),
             (256, 23, torch.bfloat16, None), (FS_BATCH, 17, torch.bfloat16, None),
             (FS_BATCH, 37, torch.bfloat16, None)]
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
        if (S, dtype, cap) in ((23, torch.bfloat16, None), (37, torch.bfloat16, None)):
            # mid-decode at serving's batches, stage 3's last step
            t = attn_times(B, S, args)
            if da.plan(B, 8, 4, S, 64, 2)["splits"] != 1:
                raise AssertionError(f"decode attention at B {B}, S {S}: S was split")
            if B == 128:  # the serving batch: the kernels line
                times = t
                us = host_us(torch, lambda: da.fused_decode_attention(*args))
                print(f"    host time per call: {us!r} us (perf_counter around enqueued calls)")
                bit_equal(f"B={B} S={S}", lambda: da.fused_decode_attention(*args))
    if not any(cap_moves):
        raise AssertionError("no softcap case binds: the kernel's softcap is unchecked")
    # caches longer than one chunk, split over blocks and merged: a
    # finfo.min tail (the JAX loops' mask of a fixed-length cache) that
    # starts mid-split, and finfo.min over whole splits
    fmin = torch.finfo(torch.float32).min
    for S in (3073, 16384):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(2, 32, 1, 64, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(2, 8, S, 64, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            p = da.plan(2, 8, 4, S, 64, q.element_size())
            for label, start, stop in (("finfo.min tail", S - 1000, S),
                                       ("finfo.min over whole splits", p["keys_per_split"],
                                        3 * p["keys_per_split"])):
                bias = torch.zeros(S, device=dev)
                bias[start:stop] = fmin
                args = (q, k, v, bias)
                errs.append(compare(torch, f"B=2 S={S} {str(dtype)[6:]} ({label})",
                                    da.fused_decode_attention(*args),
                                    da._decode_attn_plain(*args), TOL[str(dtype)[6:]]))
                if dtype == torch.bfloat16 and stop == S:
                    attn_times(2, S, args, bias.view(1, 1, 1, S))
                    if S == 16384:
                        bit_equal(f"B=2 S={S}", lambda: da.fused_decode_attention(*args))
    results["decode_attention"] = {"max_abs_err": max(errs), **times}
    return results


def lora0_phase(torch, dev):
    """fused_lora_layer0 against its twin at stage 2's shapes (mm 768, lm
    2048, r 32): f32 at B 4 (a micro-batch), 44 (a ragged row tile) and 64
    (stage 3's few-shot step over the hypernet), 4 adapter groups of 4 rows
    (the coalesced step), bf16 at B 64; the wiring of the Function's
    backward; the times of the micro-batch call."""
    from dmi_tpu_torch.ops.cuda import lora0 as l0

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    mm, lm, r = TRAIN_MM_DIM, 2048, HN_RANK

    def args(G, B, dtype):
        shapes = [(G, B, mm), (mm, lm), (lm,), (G, mm, r), (G, r, lm), (G, lm)]
        scales = [1.0, mm ** -0.5, 0.1, mm ** -0.5, r ** -0.5, 0.1]
        return [(torch.randn(sh, generator=gen, device=dev) * c).to(dtype)
                for sh, c in zip(shapes, scales)]

    print(f"kernel fused_lora_layer0 vs _lora0_plain (mm {mm}, lm {lm}, r {r}):")
    errs = []
    for G, B, dtype in ((1, 4, torch.float32), (1, 44, torch.float32), (1, 64, torch.float32),
                        (4, 4, torch.float32), (1, 64, torch.bfloat16)):
        a = args(G, B, dtype)
        dname = str(dtype)[6:]
        errs.append(compare(torch, f"G={G} B={B} {dname}", l0.fused_lora_layer0(*a),
                            l0._lora0_plain(*a), TOL[dname]))
    # the backward is the twin's gradient, recomputed (no kernel): this
    # checks only that the Function hands each input its own gradient on
    # the card and none to the frozen w0 and b0
    a = [t.requires_grad_(i in (0, 3, 4, 5)) for i, t in enumerate(args(2, 4, torch.float32))]
    cot = torch.randn(2, 4, lm, generator=gen, device=dev)
    wanted = [a[i] for i in (0, 3, 4, 5)]
    got = torch.autograd.grad((l0.fused_lora_layer0(*a) * cot).sum(), wanted)
    want = torch.autograd.grad((l0._lora0_plain(*a) * cot).sum(), wanted)
    for name, g, w in zip(("x", "a", "b", "d"), got, want):
        compare(torch, f"backward wiring d/d{name}", g, w, TOL["float32"])

    x, w0, b0, A, Bm, d = args(1, HN_BATCH, torch.float32)
    x, A, Bm, d = x[0], A[0], Bm[0], d[0]  # the sequential step's ungrouped call
    call = (x, w0, b0, A, Bm, d)
    B = x.shape[0]
    times = {**device_times(torch, lambda: l0.fused_lora_layer0(*call),
                            lambda: l0._lora0_plain(*call),
                            lambda: torch.nn.functional.gelu(
                                torch.addmm(torch.addmm(b0 + d, x, w0), x @ A, Bm),
                                approximate="tanh")),
             **least_time(nbytes(*call) + B * lm * 4, 2 * B * (mm * lm + mm * r + r * lm),
                          torch.float32)}
    print(f"    B={B} f32: {report_times(times)}; library: add, addmm, matmul, addmm, gelu "
          f"(at f32 the plain twin is this chain)")
    return {"lora0": {"max_abs_err": max(errs), **times}}


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
        bl = {}
        h = emb[:, 0, :].t().contiguous()
        for plain in (False, True):
            c = (caches[0].clone(), caches[1].clone())
            bl[plain] = dec._decode_step_bl(cfg, params, h, c, T, plain=plain)
    print("decode step (B 128, position 16) kernel path vs plain path:")
    compare(torch, "logits bf16", out[False], out[True], TOL["logits"])
    agree = (out[False].argmax(-1) == out[True].argmax(-1)).float().mean().item()
    print(f"  next-token agreement {agree!r}")
    print("batch-last decode step (decode-attention and decode-MLP kernels) vs its plain path, "
          "and vs the batch-first step:")
    compare(torch, "logits bf16 [V, B]", bl[False], bl[True], TOL["logits"])
    compare(torch, "batch-last vs batch-first logits", bl[False].t(), out[False], TOL["logits"])


def _normal(torch, dev, gen, shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev) * scale


def head_check(torch, tha, name, params, h, mode) -> float:
    """head_argmax against its twin.  q8 is integer work: the ids are equal.
    bf16 and q accumulate in another order than the library matmul, so a
    near-tie may round to the other bf16 value: at least 0.9 of the ids are
    equal and, in every other column, the twin's two logits lie within one
    bf16 step (2**-7 relative) per rounding of the mode (q rounds twice).
    Returns the largest such gap (0.0 when all ids are equal)."""
    ids = tha.head_argmax(params, h)
    torch.cuda.synchronize()
    logits = tha.head_logits_bl(params["embed"], h).float()
    want = logits.argmax(dim=0)
    share = (ids == want).float().mean().item()
    cols = torch.nonzero(ids != want).flatten()
    top, got = logits[want[cols], cols], logits[ids[cols], cols]
    gap = (top - got).abs().max().item() if cols.numel() else 0.0
    rel = ((top - got).abs() / top.abs()).max().item() if cols.numel() else 0.0
    steps = {"bf16": 1, "q": 2, "q8": 0}[mode]
    ok = share >= (1.0 if mode == "q8" else 0.9) and rel <= steps * 2.0 ** -7
    print(f"  {name}: ids equal {share!r}, largest logit gap of the others {gap!r} "
          f"(relative {rel!r}, bound {steps * 2.0 ** -7!r}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: the fused head disagrees with its plain twin")
    return gap


def bl_kernel_phase(torch, dev):
    """The batch-last serving kernels against their twins at Llama-3.2-1B's
    shapes and at odd ones, with the times of the serving call of each."""
    import torch.nn.functional as F

    from dmi_tpu_torch.models import quant
    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.ops.cuda import head_argmax as tha
    from dmi_tpu_torch.ops.cuda import w4_matmul as w4

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    results = {}
    H, I, V, B = 2048, 8192, 128256, 128

    def equal(name, out, ref):
        torch.cuda.synchronize()
        ok = out.dtype == ref.dtype and torch.equal(out, ref)
        print(f"  {name}: bit-equal {ok}")
        if not ok:
            raise AssertionError(f"{name}: kernel differs from its plain twin")

    print("kernels w4_mm_bl (packed W4A8) and w8_mm_bl (W8A8) vs their twins, bit for bit:")
    # the four layer matmuls of a w4a8 step (w_qkv, wo, w_gu, w_down) at the
    # serving batch; batches the TPU kernel's gate kept out; odd shapes
    times = None
    for K, out_dim, b in ((H, 3072, B), (H, H, B), (H, 2 * I, B), (I, H, B), (H, H, 8),
                          (H, H, 64), (H, 3072, 100), (H, H, 256), (70, 37, 5), (6, 33, 130)):
        wf = _normal(torch, dev, gen, (K, out_dim), 0.02)
        hq, a = quant.quantize_act(_normal(torch, dev, gen, (K, b)), axis=0)
        w4w, w8w = quant.quantize_tensor_int4(wf), quant.quantize_tensor(wf, native=True)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            equal(f"w4 K={K} out={out_dim} B={b} {dname}", w4.w4_mm_bl(w4w, hq, a, dtype),
                  w4._w4_mm_plain(w4w, hq, a, dtype))
            equal(f"w8 K={K} out={out_dim} B={b} {dname}", w4.w8_mm_bl(w8w, hq, a, dtype),
                  w4._w8_mm_plain(w8w, hq, a, dtype))
        if b != B:
            continue
        # the library chain: unpack, torch._int_mm (batch-first: its row count
        # must exceed 16), rescale
        hq_t = hq.t().contiguous()

        def chain():
            acc = torch._int_mm(hq_t, quant.unpack_w4(w4w["qp"]))
            return (acc.t().float() * w4w["s"].reshape(-1, 1) * a).to(torch.bfloat16)

        try:
            lib_ms = device_ms(chain)
            equal(f"   library chain K={K} out={out_dim}", chain(),
                  w4._w4_mm_plain(w4w, hq, a, torch.bfloat16))
        except RuntimeError as e:  # a yardstick only: the port never calls it
            print(f"    torch._int_mm refused the shape: {str(e)[:200]}")
            lib_ms = None
        t = {"ms": device_ms(lambda: w4.w4_mm_bl(w4w, hq, a, torch.bfloat16)),
             "plain_ms": device_ms(lambda: w4._w4_mm_plain(w4w, hq, a, torch.bfloat16)),
             "library_ms": lib_ms,
             **least_time(nbytes(w4w["qp"], w4w["s"], hq, a) + out_dim * b * 2,
                          2 * K * out_dim * b, "int8")}
        w8_ms = device_ms(lambda: w4.w8_mm_bl(w8w, hq, a, torch.bfloat16))
        print(f"    K={K} out={out_dim} B={b} bf16: kernel {t['ms'] * 1e3!r} us, plain "
              f"{t['plain_ms'] * 1e3!r} us, library "
              f"{None if lib_ms is None else lib_ms * 1e3!r} us (unpack, _int_mm, rescale); "
              f"bound {t['bound_ms'] * 1e3!r} us ({t['bound_by']}); the W8A8 variant "
              f"{w8_ms * 1e3!r} us")
        if out_dim == 2 * I:  # w_gu, the largest of a step's four: the kernels line
            times = t
    results["w4_mm"] = {"max_abs_err": 0.0, **times}

    print(f"kernel fused_decode_mlp_bl vs _decode_mlp_plain (H {H}, I {I}):")
    errs, times = [], None
    for h_dim, i_dim, b, dtype, act in (
            (H, I, B, torch.bfloat16, "silu"), (H, I, B, torch.bfloat16, "gelu_tanh"),
            (H, I, 8, torch.bfloat16, "silu"), (H, I, 16, torch.bfloat16, "silu"),
            (H, I, 64, torch.bfloat16, "silu"),
            (H, I, 100, torch.bfloat16, "silu"), (H, I, 256, torch.bfloat16, "silu"),
            (H, I, B, torch.float32, "silu"), (72, 136, 5, torch.float32, "gelu_tanh"),
            (72, 136, 5, torch.bfloat16, "silu")):
        w_gu = _normal(torch, dev, gen, (h_dim, 2 * i_dim), h_dim ** -0.5).to(dtype)
        w_down = _normal(torch, dev, gen, (i_dim, h_dim), i_dim ** -0.5).to(dtype)
        h = _normal(torch, dev, gen, (h_dim, b)).to(dtype)
        args = (w_gu, w_down, h, act)
        dname = str(dtype)[6:]
        errs.append(compare(torch, f"H={h_dim} I={i_dim} B={b} {dname} {act}",
                            dm.fused_decode_mlp_bl(*args), dm._decode_mlp_plain(*args),
                            TOL[dname]))
        if (h_dim, i_dim, dtype, act) == (H, I, torch.bfloat16, "silu") and b != 16:
            def chain():
                g, u = (w_gu.t() @ h).chunk(2, dim=0)
                return w_down.t() @ (F.silu(g) * u)

            t = {**device_times(torch, lambda: dm.fused_decode_mlp_bl(*args),
                                lambda: dm._decode_mlp_plain(*args), chain),
                 **least_time(nbytes(w_gu, w_down, h, h), 2 * b * 3 * h_dim * i_dim, dtype)}
            print(f"    B={b}: {report_times(t)}; library: matmul, silu * mul, matmul (the twin "
                  f"is this chain); plan {dm.plan(h_dim, i_dim, dm.padded_batch(b))}")
            if b == B:  # the serving call: the kernels line
                times = t
                us = host_us(torch, lambda: dm.fused_decode_mlp_bl(*args))
                print(f"    host time per call: {us!r} us (perf_counter around enqueued "
                      f"calls); tensor maps encoded so far {dm.map_encodes()}")
            if b in (8, B, 256):
                again = dm.fused_decode_mlp_bl(*args)
                if not torch.equal(again, dm.fused_decode_mlp_bl(*args)):
                    raise AssertionError(f"decode MLP at B {b}: two calls on the same inputs "
                                         "differ")
                print(f"    B={b}: two calls bit-equal")
    again = dm.fused_decode_mlp_bl(*args)
    if not torch.equal(again, dm.fused_decode_mlp_bl(*args)):
        raise AssertionError("decode MLP: two calls on the same inputs differ")
    results["decode_mlp"] = {"max_abs_err": max(errs), **times}

    print(f"kernel head_argmax vs its twin (logits + argmax), V {V}, H {H}:")
    embed = _normal(torch, dev, gen, (V, H))
    trees = {"bf16": {"embed": embed.bfloat16()},
             "q": {"embed": quant.quantize_embed_tensor(embed)},
             "q8": {"embed": quant.quantize_embed_tensor(embed, native=True)}}
    gaps = []
    for mode, params in trees.items():
        for b in (B, 8, 64, 100):
            h = _normal(torch, dev, gen, (H, b)).bfloat16()
            gaps.append(head_check(torch, tha, f"{mode} V={V} B={b}", params, h, mode))
            if b != B:
                continue
            e = params["embed"] if mode == "bf16" else params["embed"][mode]

            def library():
                return (e.to(torch.bfloat16) @ h).argmax(dim=0)

            extra = () if mode == "bf16" else (params["embed"]["s"],)
            t = {**device_times(torch, lambda: tha.head_argmax(params, h),
                                lambda: tha._head_argmax_plain(params["embed"], h), library),
                 **least_time(nbytes(e, h, *extra) + 4 * b, 2 * V * H * b,
                              "int8" if mode == "q8" else "bfloat16")}
            print(f"    {mode}: {report_times(t)}; library: matmul (the int8 embed widened "
                  f"to bf16 first), argmax")
            if mode == "bf16":  # the mode of the bf16 tree's serving run: the kernels line
                times = t
    # a V that no slice size divides, and ties planted across vocab slices
    small = _normal(torch, dev, gen, (1001, H))
    u = _normal(torch, dev, gen, (H,))
    tied = _normal(torch, dev, gen, (9000, H), 0.1)
    tied[7000] = tied[300] = 4.0 * u
    for mode in trees:
        def tree(x):
            return {"embed": x.bfloat16() if mode == "bf16"
                    else quant.quantize_embed_tensor(x, native=(mode == "q8"))}

        gaps.append(head_check(torch, tha, f"{mode} V=1001 B=64", tree(small),
                               _normal(torch, dev, gen, (H, 64)).bfloat16(), mode))
        ids = tha.head_argmax(tree(tied), u[:, None].repeat(1, 32).bfloat16().contiguous())
        first = bool((ids == 300).all())
        print(f"  {mode}: one winning row planted in vocab slices 2 and 54: first wins {first}")
        if not first:
            raise AssertionError(f"head argmax {mode}: a tie across slices went to {ids.tolist()}")
    del trees, embed
    results["head_argmax"] = {"max_abs_err": max(gaps), **times}
    return results


def bl_serving_phase(torch, dev, cfg, params, projector, embs):
    """The batch-last loop, the Captioner's default, at full width and depth:
    the same requests as slice_phase at batch 128 over (a) the bf16 tree and
    (b) int8="w4a8", then one batch each of (c) int8=True and (d)
    int8="w8a8"; launch counts set to 0 before each run and checked after;
    (a) and (b) against their plain paths, (a) also against the batch-first
    loop.  Returns the launch counts of (a) and (b)."""
    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.serve import Captioner

    spec, pparams = projector
    n, L, steps = embs.shape[0], cfg.num_hidden_layers, MAX_NEW - 1
    card = nvidia_smi()

    def captioner(**kw):
        return Captioner(cfg, params, spec, pparams, max_new_tokens=MAX_NEW, batch_size=128,
                         prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID, **kw)

    def serve(label, cap, requests, want):
        cap.caption_ids(requests[:128])  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        maps = dm.map_encodes()
        t0 = time.perf_counter()
        ids = cap.caption_ids(requests)
        secs = time.perf_counter() - t0
        counts = _counts()
        maps = {k: v - maps[k] for k, v in dm.map_encodes().items()}
        print(f"{label}: {len(requests)} requests at batch 128, {secs!r} s, "
              f"{len(requests) / secs!r} captions/s ({card}); decode-MLP tensor maps "
              f"encoded after the warm-up batch: {maps}")
        if maps["weights"]:
            raise AssertionError(f"{label}: weight tensor maps encoded again after the warm-up")
        batches = -(-len(requests) // 128)
        _expect(label, counts, {k: v * batches for k, v in want.items()})
        if tuple(ids.shape) != (len(requests), MAX_NEW) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: caption ids {tuple(ids.shape)} outside [0, vocab)")
        return ids, counts

    def agreement(label, ids, other):
        share = (ids == other).float().mean().item()
        first = (ids[:, 0] == other[:, 0]).float().mean().item()
        rows = (ids == other).all(dim=1).float().mean().item()
        ok = share >= TOKEN_AGREEMENT
        print(f"  token agreement with {label}: {share!r} (limit {TOKEN_AGREEMENT}), rows "
              f"identical {rows!r}, first tokens equal {first!r} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"tokens disagree with {label}")

    print("batch-last serving (the Captioner's default loop):")
    per_batch = {"mlp2": 1, "decode_attention": L * steps, "head_argmax": steps}
    cap = captioner()
    ids, counts_a = serve("(a) bf16 tree", cap, embs, {**per_batch, "decode_mlp": L * steps})
    t0 = time.perf_counter()
    plain = cap.caption_ids(embs, plain=True)
    print(f"  plain path: {len(embs) / (time.perf_counter() - t0)!r} captions/s")
    agreement("its plain path", ids, plain)
    agreement("the batch-first loop", ids, captioner(batch_first=True).caption_ids(embs))
    print("where one batch-last bf16 batch's time goes:")
    profile_run(torch, "batch 128, bf16 tree", lambda: cap.caption_ids(embs[:128]))

    cap = captioner(int8="w4a8")
    ids, counts_b = serve('(b) int8="w4a8"', cap, embs, {**per_batch, "w4_mm": 4 * L * steps})
    t0 = time.perf_counter()
    plain = cap.caption_ids(embs, plain=True)
    print(f"  plain path: {len(embs) / (time.perf_counter() - t0)!r} captions/s")
    agreement("its plain path", ids, plain)
    print("where one batch-last w4a8 batch's time goes:")
    profile_run(torch, "batch 128, w4a8 tree", lambda: cap.caption_ids(embs[:128]))

    serve("(c) int8=True (int8 weights widened at each matmul)", captioner(int8=True),
          embs[:128], per_batch)
    serve('(d) int8="w8a8"', captioner(int8="w8a8"), embs[:128],
          {**per_batch, "w8_mm": 4 * L * steps})
    del cap
    torch.cuda.empty_cache()
    return {"serving batch-last": counts_a, "serving w4a8": counts_b}


def device_times(torch, kernel, plain, library) -> dict:
    """ms, plain_ms and library_ms of one call each (device_ms)."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library)}


def report_times(t: dict) -> str:
    return (f"device time per call: kernel {t['ms'] * 1e3!r} us, plain {t['plain_ms'] * 1e3!r} "
            f"us, library {t['library_ms'] * 1e3!r} us (kernel / library "
            f"{t['ms'] / t['library_ms']!r}); bound {t['bound_ms'] * 1e3!r} us ({t['bound_by']})")


def profile_run(torch, label, run) -> dict:
    """Where one call of run() goes: its wall time unprofiled (median of 3,
    synchronised), then one call under torch.profiler.  Device busy time is
    the union of the trace's kernel, memcpy and memset intervals; the idle
    share is 1 - busy / unprofiled wall.  Prints the five kernels that take
    most."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = sorted(walls)[1] * 1e3
    spans = device_spans(run)
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
    """Serve n_requests through the Captioner on the batch-first loop at
    batch 128 with the launch counters set to 0 just before; check ids and
    counts; then the plain path and batch 256 on the same requests.  Returns
    the launch counts, the projector and the requests."""
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
                         batch_size=batch_size, batch_first=True, prefix_ids=PREFIX_IDS,
                         pad_token_id=PAD_ID)

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
    print(f"slice run (batch-first loop): {n_requests} requests at batch 128, {secs!r} s, "
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
    return launches, (spec, pparams), embs


def flash_timings(torch, fa, q, k, v, do) -> dict:
    """Device times (device_ms) of one bf16 call without a mask: each kernel,
    the whole backward as training runs it (_delta, dK/dV, dQ), the twin's
    forward and backward, and scaled_dot_product_attention's; with each
    kernel's bound.  Prints the backward against SDPA's."""
    nh, hd = q.shape[1], q.shape[3]
    B, T = q.shape[0], q.shape[2]
    o, lse = fa._fwd_kernel(q, k, v, None, 0.125)
    delta = fa._delta(do, o)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def plain_fwd_bwd():
        torch.autograd.grad(fa._flash_attn_plain(qg, kg, vg, None, 0.125), (qg, kg, vg), do)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, scale=0.125, enable_gqa=True)

    def backward():  # as _FlashAttention.backward runs it
        d = fa._delta(do, o)
        fa._bwd_dkv_kernel(q, k, v, None, do, lse, d, 0.125)
        fa._bwd_dq_kernel(q, k, v, None, do, lse, d, 0.125)

    t = {"fwd": device_ms(lambda: fa._fwd_kernel(q, k, v, None, 0.125)),
         "dkv": device_ms(lambda: fa._bwd_dkv_kernel(q, k, v, None, do, lse, delta, 0.125)),
         "dq": device_ms(lambda: fa._bwd_dq_kernel(q, k, v, None, do, lse, delta, 0.125)),
         "bwd": device_ms(backward),
         "plain_fwd": device_ms(lambda: fa._flash_attn_plain(q, k, v, None, 0.125)),
         "plain_fwd_bwd": device_ms(plain_fwd_bwd),
         "lib_fwd": device_ms(torch.no_grad()(sdpa)),
         "lib_fwd_bwd": device_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do))}
    # causal work: T(T+1)/2 (query, key) pairs per (row, head), each pair a
    # length-hd dot product per matrix product: forward QK^T, PV; dK/dV
    # recomputes QK^T, then dO V^T, P^T dO, dS^T Q; dQ recomputes QK^T and
    # dO V^T, then dS K
    pair_flops = 2 * hd * B * nh * T * (T + 1) // 2
    grads_in = nbytes(q, k, v, o, lse, lse)  # q, k, v, dO, lse, delta
    plain_bwd = t["plain_fwd_bwd"] - t["plain_fwd"]
    lib_bwd = t["lib_fwd_bwd"] - t["lib_fwd"]
    plan = fa.bwd_plan(B, nh, k.shape[1], T, hd, q.dtype)["dkv"]
    alt = {(hpb, rows): device_ms(lambda hpb=hpb, rows=rows: fa._bwd_dkv_kernel(
        q, k, v, None, do, lse, delta, 0.125, heads_per_block=hpb, query_rows=rows))
        for hpb, rows in ((1, 32), (1, 64), (2, 32), (2, 64), (4, 16), (4, 32))}
    print(f"    flash dK/dV B={B} T={T} bf16 by plan (query heads a block, query rows a step; "
          f"bwd_plan takes {plan['heads_per_block']}, {plan['query_rows']}): "
          + ", ".join(f"{h}, {r}: {ms * 1e3!r} us" for (h, r), ms in alt.items()))
    print(f"    flash backward B={B} T={T} bf16: dK/dV + dQ {(t['dkv'] + t['dq']) * 1e3!r} us, "
          f"with _delta as training runs it {t['bwd'] * 1e3!r} us; SDPA's backward "
          f"{lib_bwd * 1e3!r} us; (dK/dV + dQ) / SDPA {(t['dkv'] + t['dq']) / lib_bwd!r}, "
          f"whole / SDPA {t['bwd'] / lib_bwd!r}")
    return {
        "flash_fwd": {"ms": t["fwd"], "plain_ms": t["plain_fwd"], "library_ms": t["lib_fwd"],
                      **least_time(nbytes(q, k, v, o, lse), 2 * pair_flops, q.dtype)},
        "flash_bwd_dkv": {"ms": t["dkv"], "plain_ms": plain_bwd, "library_ms": lib_bwd,
                          **least_time(grads_in + nbytes(k, v), 4 * pair_flops, q.dtype)},
        "flash_bwd_dq": {"ms": t["dq"], "plain_ms": plain_bwd, "library_ms": lib_bwd,
                         **least_time(grads_in + nbytes(q), 3 * pair_flops, q.dtype)},
    }


def flash_phase(torch, dev):
    """The flash attention kernels against their twin's autograd: output,
    dQ, dK and dV, at Llama-3.2-1B's heads and each (B, T) of FLASH_CASES;
    the times of each training path's call (bf16, no mask).  Returns the
    errors and stage 1's times."""
    from dmi_tpu_torch.ops.cuda import flash_attn as fa

    nh, nkv, hd = FLASH_HEADS
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": []}
    times = {}
    print(f"kernels flash attention vs _flash_attn_plain ({nh}/{nkv} heads, hd {hd}, "
          "q/k/v in a block's [B, T, heads, hd] layout):")
    for B, T in FLASH_CASES:
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
                name = f"B={B} T={T} {dname}" + (" key-mask" if masked else "")
                out = fa.flash_attention(q, k, v, mask, 0.125)
                ref = fa._flash_attn_plain(q, k, v, mask, 0.125)
                got = torch.autograd.grad(out, (q, k, v), do)
                want = torch.autograd.grad(ref, (q, k, v), do)
                errs["flash_fwd"].append(compare(torch, f"{name} out", out.detach(),
                                                 ref.detach(), TOL[dname]))
                errs["flash_bwd_dq"].append(compare(torch, f"{name} dq", got[0], want[0],
                                                    GRAD_TOL[dname]))
                errs["flash_bwd_dkv"].append(max(
                    compare(torch, f"{name} dk", got[1], want[1], GRAD_TOL[dname]),
                    compare(torch, f"{name} dv", got[2], want[2], GRAD_TOL[dname])))
                if masked or dtype != torch.bfloat16 or (B, T) not in FLASH_PATHS:
                    continue
                t = flash_timings(torch, fa, *(x.detach() for x in (q, k, v)), do)
                for key, kt in t.items():
                    print(f"    {key} B={B} T={T} bf16: {report_times(kt)}; library: "
                          "scaled_dot_product_attention, causal, GQA (backward: its "
                          "forward+backward less its forward, as the twin's)")
                if not times:  # stage 1's call: the kernels line
                    times = t
    return {key: {"max_abs_err": max(errs[key]), **times[key]} for key in errs}


class SyntheticCaptions:
    """A training data source: `batch` rows of a chat prompt (PREFIX_IDS),
    caption tokens and an end token, right-padded to `text` tokens, in the
    collator's schema (input_ids, attention_mask, labels with -100 over the
    prompt and the pad id on right pads) with embs [batch, mm]; with
    `subset`, also a conditioning subset (mm rows, text rows, the prefix
    embedding) as the hypernet's loader gives it with feed_txt_embs.  Made
    with numpy from (SEED, stream, step)."""

    def __init__(self, steps, batch=TRAIN_BATCH, text=TRAIN_TEXT, mm=TRAIN_MM_DIM,
                 subset=None, stream=5):
        self.steps, self.batch, self.text, self.mm = steps, batch, text, mm
        self.subset, self.stream = subset, stream

    def total_train_steps(self):
        return self.steps

    def train_batch(self, step):
        rng = np.random.default_rng((SEED, self.stream, step))
        B, T, P = self.batch, self.text, len(PREFIX_IDS)
        lens = rng.integers(P + min(8, T - P - 1), T + 1, size=B)
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
        embs = rng.normal(size=(B, self.mm)).astype(np.float32)
        return {"input_ids": ids, "attention_mask": mask, "labels": labels, "embs": embs}

    def subset_batch(self, step, split="train"):
        rng = np.random.default_rng((SEED, self.stream + 1, step))
        n, d = self.subset, self.mm
        return (rng.normal(size=(n, d)).astype(np.float32),
                rng.normal(size=(n, d)).astype(np.float32),
                rng.normal(size=(1, d)).astype(np.float32))


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
    data = SyntheticCaptions(TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(**TRAIN_ARGS, checkpoint_dir=tmp)
        trainer = ProjectorTrainer("smoke", cfg, params, spec, pp, [data],
                                   [EmbeddingManager("smoke-encoder", device=dev)], None, args)
        batches = [(0, data.train_batch(step)) for step in range(TRAIN_STEPS)]

        step0_check(torch, "stage 1", lambda plain: trainer.micro_loss(0, batches[0],
                                                                       plain=plain),
                    trainer.params)

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


def step0_check(torch, label, loss_fn, tree, zero=None):
    """Step 0 of a training path, kernel path (loss_fn(False)) against plain
    path (loss_fn(True)): the loss within TOL["loss"], and each trainable
    leaf of `tree` within TOL["logits"] of that leaf's own largest plain
    gradient.  A leaf the loss never reaches must get no gradient on either
    path.  zero maps a leaf whose gradient is 0 in exact arithmetic (both
    paths give rounding noise) to the leaf whose bound it is held to."""
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    names, leaves = zip(*named_leaves(tree))
    print(f"{label} step 0, kernel path vs plain path (loss and trainable gradients):")
    out = {}
    for plain in (False, True):
        loss = loss_fn(plain)
        out[plain] = (loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True))
    compare(torch, "loss", out[False][0], out[True][0], TOL["loss"])
    scale = {n: gp.abs().max().item() for n, gp in zip(names, out[True][1]) if gp is not None}
    for n, g, gp in zip(names, out[False][1], out[True][1]):
        if gp is None:
            if g is not None:
                raise AssertionError(f"{label} leaf {n}: a gradient the twin does not have")
            continue
        compare(torch, f"grad {n} {tuple(g.shape)}", g, gp, TOL["logits"],
                scale=scale[(zero or {}).get(n, n)])


def _tensors(tree):
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    return [t.detach() for _, t in named_leaves(tree)]


def _snapshot(params):
    return [t.clone() for t in _tensors(params)]


def _unchanged(before, tree) -> bool:
    return all(a.equal(b) for a, b in zip(before, _tensors(tree)))


def _reset_counts():
    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import flash_attn as fa
    from dmi_tpu_torch.ops.cuda import lora0 as l0
    from dmi_tpu_torch.ops.cuda import projector as pk

    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.ops.cuda import head_argmax as ha
    from dmi_tpu_torch.ops.cuda import w4_matmul as w4
    from dmi_tpu_torch.ops.cuda import block_mm as bm
    from dmi_tpu_torch.ops.cuda import stream_mm as sm
    from dmi_tpu_torch.ops.cuda import w4_probe as wp

    pk.launches = da.launches = l0.launches = 0
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    dm.launches = ha.launches = w4.launches = w4.w8_launches = 0
    bm.launches = sm.launches = wp.split_out_launches = wp.split_k_launches = 0


def _counts() -> dict:
    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import flash_attn as fa
    from dmi_tpu_torch.ops.cuda import lora0 as l0
    from dmi_tpu_torch.ops.cuda import projector as pk

    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.ops.cuda import head_argmax as ha
    from dmi_tpu_torch.ops.cuda import w4_matmul as w4
    from dmi_tpu_torch.ops.cuda import block_mm as bm
    from dmi_tpu_torch.ops.cuda import stream_mm as sm
    from dmi_tpu_torch.ops.cuda import w4_probe as wp

    return {"mlp2": pk.launches, "decode_attention": da.launches, "lora0": l0.launches,
            "flash_fwd": fa.fwd_launches, "flash_bwd_dkv": fa.dkv_launches,
            "flash_bwd_dq": fa.dq_launches, "decode_mlp": dm.launches,
            "head_argmax": ha.launches, "w4_mm": w4.launches, "w8_mm": w4.w8_launches,
            "block_mm": bm.launches, "stream_mm": sm.launches,
            "w4_split_out": wp.split_out_launches, "w4_split_k": wp.split_k_launches}


def _expect(label, counts, want):
    """The launch counts of a run against the expected ones (absent: 0)."""
    full = {k: want.get(k, 0) for k in counts}
    print(f"  {label} launches {counts} (expected {full})")
    if counts != full:
        raise AssertionError(f"{label}: kernel launches {counts} != {full}")


def frozen_projector(torch, dev):
    """The frozen stage-1 projector of stages 2-3 and the LoRA baseline: 2
    layers, f32, mm 768 -> 2048, from a seed."""
    from dmi_tpu_torch.models import projector as proj

    spec = proj.ProjectorSpec(mm_dim=TRAIN_MM_DIM, lm_dim=2048, dropout=TRAIN_DROPOUT)
    return spec, proj.init(spec, torch.Generator(device=dev).manual_seed(SEED + 7), device=dev)


def hypernet_phase(torch, dev, cfg, params):
    """Stage 2 through HypernetTrainer at full width; returns the stage-2
    run's launch counts and the trained hypernet's parameters."""
    import types

    from dmi_tpu_torch.models import hypernet as hn
    from dmi_tpu_torch.ops.linalg import random_orthogonal
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    spec, frozen = frozen_projector(torch, dev)
    hspec = hn.HypnetSpec(**HN_SPEC)
    hparams = hn.init(hspec, torch.Generator(device=dev).manual_seed(SEED + 8), device=dev)
    n_hn = sum(t.numel() for t in _tensors(hparams))
    data = SyntheticCaptions(HN_STEPS + HN_ACCUM, batch=HN_BATCH, text=HN_TEXT, mm=spec.mm_dim,
                             subset=HN_SUBSET, stream=7)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(**HN_ARGS, checkpoint_dir=tmp)
        trainer = HypernetTrainer("smoke-hypernet", cfg, params, spec, frozen, hspec, hparams,
                                  [data], [EmbeddingManager("smoke-encoder", device=dev)], [],
                                  [], None, args, types.SimpleNamespace(**FEWSHOT))
    print(f"stage 2: hypernet {n_hn} parameters (context {hspec.context_len}), micro-batch "
          f"{HN_BATCH} x T {HN_TEXT + 1}, accumulation {HN_ACCUM}")
    batches = [trainer.fetch_batch(step) for step in range(HN_STEPS + HN_ACCUM)]

    # the loss never reaches the generator heads past layer 0; the key
    # bias adds one constant to every logit of a query's row, which the
    # softmax cancels, so its gradient is 0 in exact arithmetic and is held
    # to the bound of the key weight's
    step0_check(torch, "stage 2", lambda plain: trainer.micro_loss(0, batches[0], plain=plain),
                trainer.params, zero={"attn.k.b": "attn.k.w"})

    llm_before = _snapshot(trainer.llm_params)
    frozen_before = _snapshot(trainer.frozen_proj)
    hn_before = _snapshot(trainer.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    losses = [trainer.train_step(step, HN_STEPS, batches[step])[0] for step in range(HN_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu() * HN_ACCUM
    positions = HN_STEPS * HN_BATCH * (HN_TEXT + 1)
    print(f"stage-2 run: {HN_STEPS} micro-steps, {secs!r} s, {HN_STEPS / secs!r} micro-steps/s, "
          f"{positions / secs!r} tokens/s (sequence positions); peak device memory "
          f"{peak / 2**30!r} GiB; losses first {losses[:3].tolist()} last "
          f"{losses[-3:].tolist()}")
    L = cfg.num_hidden_layers
    _expect("stage-2 run", launches, {"lora0": HN_STEPS, "flash_fwd": L * HN_STEPS,
                                      "flash_bwd_dkv": L * HN_STEPS,
                                      "flash_bwd_dq": L * HN_STEPS})
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("a stage-2 loss is not finite")
    names = [n for n, _ in named_leaves(trainer.params)]
    moved = {n: not a.equal(b) for n, a, b in zip(names, hn_before, _tensors(trainer.params))}
    # the reference runs only layer 0's adapter (projector.py:11-19): the
    # layer-1 generator head gets no gradient, and weight decay at lr ~1e-4
    # moves an f32 weight by less than its rounding
    unreached = {n for n in names if n.startswith("generators.1.")}
    print(f"  hypernet leaves moved {moved}")
    print(f"  frozen projector and every LLM parameter bit-unchanged "
          f"{_unchanged(frozen_before, trainer.frozen_proj)}, "
          f"{_unchanged(llm_before, trainer.llm_params)}")
    if (not all(moved[n] for n in names if n not in unreached)
            or not _unchanged(frozen_before, trainer.frozen_proj)
            or not _unchanged(llm_before, trainer.llm_params)):
        raise AssertionError("the hypernet must move, the frozen projector and the LLM must not")
    del llm_before, frozen_before, hn_before

    idx, batch, subset_raw = batches[0]
    mgr = trainer.emb_mgrs[0]
    _reset_counts()
    ev = trainer.eval_loss(mgr.get_embeddings(batch["embs"]), mgr.get_embeddings(subset_raw),
                           *trainer._device_batch(batch))
    print(f"stage-2 eval loss {ev.item()!r}")
    _expect("eval loss", _counts(), {"lora0": 1, "flash_fwd": L})

    trainer.coalesce = HN_COALESCE  # the micro_batch_coalesce path
    window = [(step, *batches[step]) for step in range(HN_STEPS, HN_STEPS + HN_ACCUM)]
    _reset_counts()
    t0 = time.perf_counter()
    acc = trainer.run_window(window)
    trainer._update(window[-1][0])
    torch.cuda.synchronize()
    secs_k = time.perf_counter() - t0
    n_chunks = HN_ACCUM // HN_COALESCE
    print(f"stage-2 coalesced window: {HN_ACCUM} micro-steps as {n_chunks} chunks of "
          f"{HN_COALESCE}, {secs_k!r} s, {HN_ACCUM / secs_k!r} micro-steps/s (update "
          f"included); mean micro-step loss {acc.item()!r}")
    _expect("coalesced window", _counts(), {"lora0": n_chunks, "flash_fwd": L * n_chunks,
                                            "flash_bwd_dkv": L * n_chunks,
                                            "flash_bwd_dq": L * n_chunks})
    trainer.coalesce = 1

    gen = torch.Generator(device=dev).manual_seed(SEED)
    qr_ms = time_ms(torch, lambda: random_orthogonal(spec.mm_dim, gen), iters=10)
    print(f"random_orthogonal({spec.mm_dim}) on the card: {qr_ms!r} ms/call")

    print("where one stage-2 micro-step's time goes:")
    extra = iter(range(HN_STEPS, HN_STEPS + HN_ACCUM))
    profile_run(torch, f"stage-2 micro-step, batch {HN_BATCH}, T {HN_TEXT + 1}",
                lambda: trainer.train_step(next(extra), 10**9, batches[1]))
    trained = trainer.param_tree()
    del trainer
    return launches, trained


def fewshot_phase(torch, dev, cfg, params, hn_params):
    """Stage 3: the generated projector from one subset of the stage-2
    hypernet, step 0 against the plain path, FS_STEPS few-shot micro-steps
    over it, then one generate batch through it; returns the few-shot run's
    launch counts."""
    import types

    from dmi_tpu_torch.models import hypernet as hn
    from dmi_tpu_torch.models import mmmodel
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer

    spec, frozen = frozen_projector(torch, dev)
    data = SyntheticCaptions(FS_STEPS, batch=FS_BATCH, text=FS_TEXT, mm=spec.mm_dim,
                             subset=HN_SUBSET, stream=9)
    mgr = EmbeddingManager("smoke-fewshot-encoder", device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(**FS_ARGS, checkpoint_dir=tmp)
        trainer = HypernetTrainer("smoke-fewshot", cfg, params, spec, frozen,
                                  hn.HypnetSpec(**HN_SPEC), hn_params, [], [], [data], [mgr],
                                  None, args, types.SimpleNamespace(**FEWSHOT))
    trainer.fewshot_generate_adapters(0)
    step0_check(torch, "stage 3", lambda plain: trainer.fewshot_micro_loss(
        0, data.train_batch(0), None, mgr, plain=plain), trainer.generated_projector)
    opt = trainer.fewshot_optimizer()
    llm_before = _snapshot(trainer.llm_params)
    hn_before = _snapshot(trainer.params)
    gp_before = _snapshot(trainer.generated_projector)
    _reset_counts()
    t0 = time.perf_counter()
    losses = [trainer.fewshot_train_step(step, FS_STEPS, data.train_batch(step), None, mgr,
                                         opt)[0] for step in range(FS_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = torch.stack(losses).float().cpu()
    L = cfg.num_hidden_layers
    print(f"stage 3: {FS_STEPS} few-shot micro-steps at batch {FS_BATCH}, T {FS_TEXT + 1}: "
          f"{secs!r} s, {FS_STEPS / secs!r} micro-steps/s; losses {losses.tolist()}")
    launches = _counts()
    _expect("few-shot run", launches, {"flash_fwd": L * FS_STEPS, "flash_bwd_dkv": L * FS_STEPS,
                                       "flash_bwd_dq": L * FS_STEPS})
    moved = [not a.equal(b) for a, b in zip(gp_before, _tensors(trainer.generated_projector))]
    print(f"  generated projector leaves moved {moved}; hypernet and LLM bit-unchanged "
          f"{_unchanged(hn_before, trainer.params)}, {_unchanged(llm_before, trainer.llm_params)}")
    if (not all(moved) or not bool(torch.isfinite(losses).all())
            or not _unchanged(hn_before, trainer.params)
            or not _unchanged(llm_before, trainer.llm_params)):
        raise AssertionError("stage 3: the generated projector must move, the rest must not")
    del llm_before

    mm = mgr.get_embeddings(data.train_batch(0)["embs"])
    prefix = torch.tensor([PREFIX_IDS] * FS_BATCH, device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        soft = trainer._soft_for_generate(mm, None)
        ids = mmmodel.caption_generate(cfg, trainer.llm_params, soft, prefix, MAX_NEW, PAD_ID)
    torch.cuda.synchronize()
    print(f"stage-3 generate: one batch of {FS_BATCH} through the generated projector in "
          f"{time.perf_counter() - t0!r} s, ids {tuple(ids.shape)}")
    _expect("stage-3 generate", _counts(), {"mlp2": 1, "decode_attention": L * (MAX_NEW - 1),
                                            "decode_mlp": L * (MAX_NEW - 1),
                                            "head_argmax": MAX_NEW - 1})
    if tuple(ids.shape) != (FS_BATCH, MAX_NEW) or not bool(((ids >= 0)
                                                             & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"stage-3 caption ids {tuple(ids.shape)} outside [0, vocab)")
    with torch.no_grad():
        soft = proj.apply(spec, trainer.generated_projector, mm, plain=True)
        ids_plain = mmmodel.caption_generate(cfg, trainer.llm_params, soft, prefix, MAX_NEW,
                                             PAD_ID, plain=True)
    print(f"  token agreement with the plain path {(ids == ids_plain).float().mean().item()!r} "
          "(information: bf16 argmax ties may flip)")
    return launches


def fewshot_hypernet_phase(torch, dev, cfg, params, hn_params):
    """Stage 3 with finetune_generated_projector false: FS_HN_STEPS few-shot
    micro-steps that tune the hypernet itself, each through lora0 at batch
    64; returns the run's launch counts."""
    import types

    from dmi_tpu_torch.models import hypernet as hn
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    spec, frozen = frozen_projector(torch, dev)
    data = SyntheticCaptions(FS_HN_STEPS, batch=FS_BATCH, text=FS_TEXT, mm=spec.mm_dim,
                             subset=HN_SUBSET, stream=13)
    mgr = EmbeddingManager("smoke-fewshot-encoder", device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(**FS_ARGS, checkpoint_dir=tmp)
        trainer = HypernetTrainer(
            "smoke-fewshot-hypernet", cfg, params, spec, frozen, hn.HypnetSpec(**HN_SPEC),
            hn_params, [], [], [data], [mgr], None, args,
            types.SimpleNamespace(**dict(FEWSHOT, finetune_generated_projector=False)))
    trainer.fewshot_generate_adapters(0)  # no generated projector: the hypernet is tuned
    opt = trainer.fewshot_optimizer()
    llm_before = _snapshot(trainer.llm_params)
    frozen_before = _snapshot(trainer.frozen_proj)
    hn_before = _snapshot(trainer.params)
    _reset_counts()
    t0 = time.perf_counter()
    losses = [trainer.fewshot_train_step(step, FS_HN_STEPS, data.train_batch(step),
                                         data.subset_batch(step), mgr, opt)[0]
              for step in range(FS_HN_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = torch.stack(losses).float().cpu()
    L = cfg.num_hidden_layers
    print(f"stage 3 over the hypernet: {FS_HN_STEPS} few-shot micro-steps at batch {FS_BATCH}, "
          f"T {FS_TEXT + 1}: {secs!r} s; losses {losses.tolist()}")
    launches = _counts()
    _expect("few-shot run over the hypernet", launches,
            {"lora0": FS_HN_STEPS, "flash_fwd": L * FS_HN_STEPS,
             "flash_bwd_dkv": L * FS_HN_STEPS, "flash_bwd_dq": L * FS_HN_STEPS})
    names = [n for n, _ in named_leaves(trainer.params)]
    moved = {n: not a.equal(b) for n, a, b in zip(names, hn_before, _tensors(trainer.params))}
    print(f"  hypernet leaves moved {moved}; frozen projector and LLM bit-unchanged "
          f"{_unchanged(frozen_before, trainer.frozen_proj)}, "
          f"{_unchanged(llm_before, trainer.llm_params)}")
    # the layer-1 generator head gets no gradient (see hypernet_phase)
    if (not all(moved[n] for n in names if not n.startswith("generators.1."))
            or not bool(torch.isfinite(losses).all())
            or not _unchanged(frozen_before, trainer.frozen_proj)
            or not _unchanged(llm_before, trainer.llm_params)):
        raise AssertionError("stage 3 over the hypernet: the hypernet must move, the rest not")
    return launches


def lora_phase(torch, dev, cfg, params):
    """The LoRA baseline through LoraTrainer at v3's shapes; returns its
    run's launch counts."""
    import types

    from dmi_tpu_torch.models import lora
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.lora_trainer import LoraTrainer

    spec, frozen = frozen_projector(torch, dev)
    lspec = lora.LoraSpec(rank=HN_RANK, alpha=32)
    adapters = lora.init(lspec, spec, torch.Generator(device=dev).manual_seed(SEED + 10),
                         device=dev)
    data = SyntheticCaptions(FS_STEPS, batch=FS_BATCH, text=FS_TEXT, mm=spec.mm_dim, stream=11)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(**LORA_ARGS, checkpoint_dir=tmp)
        trainer = LoraTrainer(lora_spec=lspec, lora_params=adapters, frozen_proj_params=frozen,
                              name="smoke-lora", llm_cfg=cfg, llm_params=params, proj_spec=spec,
                              loaders=[data],
                              emb_mgrs=[EmbeddingManager("smoke-encoder", device=dev)],
                              tokenizer=None, train_args=args)
    step0_check(torch, "LoRA baseline", lambda plain: trainer.micro_loss(
        0, (0, data.train_batch(0)), plain=plain), trainer.params)
    llm_before = _snapshot(trainer.llm_params)
    frozen_before = _snapshot(trainer._frozen_proj)
    ad_before = _snapshot(trainer.params)
    _reset_counts()
    t0 = time.perf_counter()
    losses = [trainer.train_step(step, FS_STEPS, (0, data.train_batch(step)))[0]
              for step in range(FS_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = torch.stack(losses).float().cpu()
    L = cfg.num_hidden_layers
    print(f"LoRA baseline: {FS_STEPS} micro-steps at batch {FS_BATCH}, T {FS_TEXT + 1}: "
          f"{secs!r} s, {FS_STEPS / secs!r} micro-steps/s; losses {losses.tolist()}")
    launches = _counts()
    _expect("LoRA run", launches, {"flash_fwd": L * FS_STEPS, "flash_bwd_dkv": L * FS_STEPS,
                                   "flash_bwd_dq": L * FS_STEPS})
    moved = [not a.equal(b) for a, b in zip(ad_before, _tensors(trainer.params))]
    print(f"  adapter leaves moved {moved}; frozen projector and LLM bit-unchanged "
          f"{_unchanged(frozen_before, trainer._frozen_proj)}, "
          f"{_unchanged(llm_before, trainer.llm_params)}")
    if (not all(moved) or not bool(torch.isfinite(losses).all())
            or not _unchanged(frozen_before, trainer._frozen_proj)
            or not _unchanged(llm_before, trainer.llm_params)):
        raise AssertionError("LoRA: the adapters must move, the rest must not")
    return launches


def probe_phase(torch):
    """The three kernel probes through their entry points' run() at the
    default shapes, with the launch counters set to 0 just before; each
    probe's gate holds its kernels against their twins before it times
    them.  Returns the run's launch counts and the kernels line's entries."""
    from dmi_tpu_torch.ops.cuda.stream_mm import BLOCK_OUT
    from dmi_tpu_torch.probes import profile_int8_mxu, profile_mlp_stream, profile_w4_matmul

    print("kernel probes at their default shapes:")
    _reset_counts()
    t0 = time.perf_counter()
    r9 = profile_int8_mxu.run(inner=PROBE_INNER)
    r10 = profile_mlp_stream.run(inner=PROBE_INNER)
    r11 = profile_w4_matmul.run(inner=PROBE_INNER)
    counts = _counts()
    print(f"probes: {time.perf_counter() - t0!r} s")
    # a kernel's variant: its gate's call, 3 warm-ups and PROBE_INNER timed calls
    per = 1 + 3 + PROBE_INNER
    _expect("probes", counts, {"block_mm": 2 * per, "stream_mm": len(BLOCK_OUT) * per,
                               "w4_split_out": per, "w4_split_k": per})

    def entry(r, kernel, plain, library, bound_key, err_key):
        return {"max_abs_err": r[err_key], "ms": r[f"{kernel}_ms"], "plain_ms": r[f"{plain}_ms"],
                "library_ms": r.get(f"{library}_ms"),
                "bound_ms": r[f"{bound_key}_bound_us"] / 1e3,
                "bound_by": r[f"{bound_key}_bound_by"]}

    print(f"  block_mm N {r9['N']}, block_m {r9['block_m']} ({r9['device']}): int8 "
          f"{r9['cuda_int8_ms'] * 1e3!r} us ({r9['cuda_int8_tflops']!r} TOP/s), bf16 "
          f"{r9['cuda_bf16_ms'] * 1e3!r} us ({r9['cuda_bf16_tflops']!r} TFLOP/s), int8 speedup "
          f"{r9.get('cuda_int8_speedup')!r}; library _int_mm {r9.get('torch_int8_ms')!r} ms, "
          f"matmul bf16 (bf16 out) {r9['torch_bf16_ms']!r} ms, speedup "
          f"{r9.get('torch_int8_speedup')!r}; twins {r9['plain_int8_ms']!r} (f64), "
          f"{r9['plain_bf16_ms']!r} ms; bounds {r9['cuda_int8_bound_us']!r} / "
          f"{r9['cuda_bf16_bound_us']!r} us")
    best = r10["cuda_best_bo"]
    widths = {bo: (r10[f"cuda_bo{bo}_ms"] * 1e3, r10[f"cuda_bo{bo}_gbps"]) for bo in BLOCK_OUT}
    print(f"  stream_mm I {r10['I']}, O {r10['O']}, B {r10['B']}: us and GB/s by block_out "
          f"{widths}; w.t() @ h {r10['torch_ms'] * 1e3!r} us ({r10['torch_gbps']!r} GB/s); "
          f"bound {r10['cuda_bound_us']!r} us")
    print(f"  w4 K {r11['K']}, OUT {r11['OUT']}, batch {r11['batch']}: split-OUT "
          f"{r11['cuda_split_out_ms'] * 1e3!r} us, split-K {r11['cuda_split_k_ms'] * 1e3!r} us; "
          f"library chains (ms): int8 stream {r11.get('torch_w8_int8_stream_ms')!r}, packed "
          f"stream {r11.get('torch_w4_packed_stream_ms')!r}, split-OUT "
          f"{r11.get('torch_w4_split_out_ms')!r}, split-K {r11.get('torch_w4_split_k_ms')!r}; "
          f"bound {r11['cuda_split_k_bound_us']!r} us")
    kernels = {
        "block_mm": entry(r9, "cuda_int8", "plain_int8", "torch_int8", "cuda_int8",
                          "cuda_int8_max_abs_err"),
        "stream_mm": entry(r10, f"cuda_bo{best}", "plain", "torch", "cuda",
                           f"cuda_bo{best}_max_abs_err"),
        "w4_split_out": entry(r11, "cuda_split_out", "plain_split_out", "torch_w4_split_out",
                              "cuda_split_out", "cuda_split_out_max_abs_err"),
        "w4_split_k": entry(r11, "cuda_split_k", "plain_split_k", "torch_w4_split_k",
                            "cuda_split_k", "cuda_split_k_max_abs_err"),
    }
    return counts, kernels


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
    print("ptxas (kernel: registers, spill store / load bytes): "
          + "; ".join(f"{n}: {r}, {st}/{ld}" for n, r, st, ld in _build.ptxas_usage(
              _build.build_log)))

    kernels = kernel_phase(torch, dev)
    kernels.update(flash_phase(torch, dev))
    kernels.update(lora0_phase(torch, dev))
    kernels.update(bl_kernel_phase(torch, dev))
    # each path's launch counts, set to 0 just before its run and read just after
    paths = {}
    paths["probes"], probe_kernels = probe_phase(torch)
    kernels.update(probe_kernels)

    # Llama-3.2-1B at full width, EOS off as bench.py:252 has it
    cfg = dataclasses.replace(llama.llama32_1b(), eos_token_ids=())
    params = llama.fuse_projections(
        llama.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    decode_step_phase(torch, dev, cfg, params)
    paths["serving"], projector, embs = slice_phase(torch, dev, cfg, params, MAX_NEW)
    paths.update(bl_serving_phase(torch, dev, cfg, params, projector, embs))
    paths["stage 1"] = train_phase(torch, dev, cfg, params)
    paths["stage 2"], hn_params = hypernet_phase(torch, dev, cfg, params)
    paths["stage 3"] = fewshot_phase(torch, dev, cfg, params, hn_params)
    paths["stage 3 over the hypernet"] = fewshot_hypernet_phase(torch, dev, cfg, params,
                                                                hn_params)
    paths["LoRA"] = lora_phase(torch, dev, cfg, params)
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in ("dmi_tpu", "jax"))
    if jax_side:
        raise AssertionError(f"the smoke loaded modules of the JAX side: {jax_side}")

    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    # kernel: (name, source, TPU kernel it replaces, the path whose run's count is reported)
    sources = {"mlp2": ("fused_mlp2", "dmi_tpu_torch/csrc/mlp2.cu",
                        "dmi_tpu/ops/pallas/projector.py:167", "serving"),
               "decode_attention": ("fused_decode_attention",
                                    "dmi_tpu_torch/csrc/decode_attn.cu",
                                    "dmi_tpu/ops/pallas/decode_attn.py:121", "serving"),
               "flash_fwd": ("flash_attention forward", "dmi_tpu_torch/csrc/flash_attn_fwd.cu",
                             f"dmi_tpu/models/llama.py:1086 ({flash}:758 "
                             "_flash_attention_impl)", "stage 1"),
               "flash_bwd_dkv": ("flash_attention backward dK/dV",
                                 "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                 f"dmi_tpu/models/llama.py:1086 ({flash}:1121 "
                                 "_flash_attention_bwd_dkv)", "stage 1"),
               "flash_bwd_dq": ("flash_attention backward dQ",
                                "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                f"dmi_tpu/models/llama.py:1086 ({flash}:1456 "
                                "_flash_attention_bwd_dq)", "stage 1"),
               "lora0": ("fused_lora_layer0", "dmi_tpu_torch/csrc/lora0.cu",
                         "dmi_tpu/ops/pallas/projector.py:251", "stage 2"),
               "head_argmax": ("head_argmax", "dmi_tpu_torch/csrc/head_argmax.cu",
                               "dmi_tpu/ops/pallas/head_argmax.py:97", "serving batch-last"),
               "decode_mlp": ("fused_decode_mlp_bl", "dmi_tpu_torch/csrc/decode_mlp.cu",
                              "dmi_tpu/ops/pallas/decode_mlp.py:97", "serving batch-last"),
               "w4_mm": ("w4_mm_bl", "dmi_tpu_torch/csrc/w4_matmul.cu",
                         "dmi_tpu/ops/pallas/w4_matmul.py:99", "serving w4a8"),
               "block_mm": ("block_mm int8", "dmi_tpu_torch/csrc/block_mm.cu",
                            "scripts/profile_int8_mxu.py:74 (pallas_mm)", "probes"),
               "stream_mm": ("stream_mm_bl", "dmi_tpu_torch/csrc/stream_mm.cu",
                             "scripts/profile_mlp_stream.py:67 (pallas_mm)", "probes"),
               "w4_split_out": ("w4_dot_split_out", "dmi_tpu_torch/csrc/w4_probe.cu",
                                "scripts/profile_w4_matmul.py:156 (dot_w4_pallas)", "probes"),
               "w4_split_k": ("w4_dot_split_k", "dmi_tpu_torch/csrc/w4_probe.cu",
                              "scripts/profile_w4_matmul.py:184 (dot_w4_pallas_k)", "probes")}
    print(f"launches by path: {paths}")
    report = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": paths[path][key], **kernels[key]}
              for key, (name, src, rep, path) in sources.items()]
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
