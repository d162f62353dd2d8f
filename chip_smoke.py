#!/usr/bin/env python3
"""Smoke run of dmi_tpu_torch's serving paths (batch-first, batch-last,
quantized, sampled, continuous batching), its three training stages (with
the LoRA baseline) and its loading of HF-layout weights and reference torch
checkpoints on one CUDA card.

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
7. Where the w4a8 kernel path and its plain path part: one batch of (b)
   through both with every kernel call, its twin's, quantize_act's and
   prefill's outputs recorded in call order; the first op whose outputs
   differ, with its max relative difference beside its tolerance, and each
   kernel against its twin on the kernel path's own inputs.
8. Sampled serving (temperature 0.7, top_k 50, top_p 0.9, seed 0;
   request-indexed draws) of the same requests at batch 128 over the bf16
   tree and one batch of int8="w4a8": launch counts, ids in range, two runs
   identical, token agreement with the plain path; the warp + draw's device
   time per step at V 128256, B 128; one sampled batch profiled.
9. Continuous batching (engine="bulk", pool 128, admit 32) over the bf16
   tree with up to three EOS ids chosen from the batch engine's greedy ids
   so that captions end mid-budget: captions/s of the batch and bulk engines side
   by side, token agreement of bulk with the batch engine and with its
   plain path, launch counts from the engine's steps and admissions (every
   decode-attention launch with a [B, S] bias), engine="auto"'s decision, a
   sampled bulk run against the sampled batch engine, and both engines'
   workloads profiled.  Step 2 also holds decode attention with a [B, S]
   bias against its twin: the bulk shape (B 128, S 38, ring masks, a slot
   never used) and B 2 over 3073 and 16384 positions with whole splits of
   one row and all of another masked; two calls bit-equal; timed against
   SDPA with the same float mask.
10. Stage 1: ProjectorTrainer on the same Llama-3.2-1B with a 2-layer f32
   projector (mm 768, dropout 0.1) and the optimizer of configs/experiments/
   projector/v1:llama1b_inst_all_extracted.json (warmup cut to 2), on
   synthetic batches of 32 captions (64 text tokens and the soft token).
   Step 0's loss and projector gradients through the kernels against the
   plain path; 10 micro-steps with the launch counters set to 0 just before
   (each flash kernel must run 16 x 10 times), finite losses, a projector
   that moves and an LLM that does not; one eval-loss call through
   fused_mlp2; micro-steps/s, tokens/s, peak memory and one step under
   torch.profiler.
11. Stage 2: HypernetTrainer at the v4 hypernet config's shapes (attention
   hypernet, positional encodings, width 768, rank 32, subsets of 128,
   rotation augmentation and text interleave, AdamW and accumulation 40,
   warmup cut to 2) over a frozen f32 projector (mm 768), micro-batches of
   4 captions of 328 text tokens.  Step 0 kernel vs plain path; 80
   micro-steps (lora0 exactly 80 launches, each flash kernel 16 x 80), a
   hypernet that moves, a frozen projector and LLM that do not; one eval
   loss; one coalesced window of 40 at micro_batch_coalesce 4 (10 grouped
   lora0 launches); the card's time of one 768 x 768 random_orthogonal;
   throughput, peak memory and one micro-step under torch.profiler.
12. Stage 3: the generated projector from one subset of the stage-2
   hypernet; step 0 kernel vs plain path; 5 few-shot micro-steps over it at
   batch 64 on sydney-length captions, then one generate batch of 64 through
   it on the batch-last loop (1 mlp2 launch, 16 x 21 decode-attention and
   decode-MLP launches, 21 head + argmax launches); then 2 few-shot
   micro-steps that tune the hypernet itself (finetune_generated_projector
   false: 1 lora0 launch each).
13. The LoRA baseline: LoraTrainer at the v3 config's shapes (batch 64, rank
   32, alpha 32): step 0 kernel vs plain path, then 5 micro-steps (each
   flash kernel 16 x 5).

14. From disk, as the paper's configs name their inputs: the 1B tree
   written in the HF layout (config.json, two safetensors shards and their
   index; the writer is here, the card has no safetensors package) and read
   back through build_lm; the serving projector written as a reference
   torch `.pt` and read through load_projector; the stage-2 hypernet, its
   frozen projector and its AdamW state written as a reference hypernet
   `.pt` and read through HypernetTrainer.load_checkpoint.  Each is held
   bit for bit to the tree it was written from (config, weights, moments,
   steps, sched_step); one batch of 128 greedy captions on the batch-last
   loop must give the in-memory run's ids and launch counts, and one
   stage-3 micro-step over the loaded hypernet its loss, launches and
   updated hypernet.  Bytes written and read, load times and device memory
   are printed.

15. Gemma-2-2B (google/gemma-2-2b's config.json, random bf16 weights) from
   an HF gemma2 directory: its serving kernels at its shapes, the 300
   requests on every loop and engine (family_serving_phase), stage 1 on the
   `_attention` route and its first two layers with a window that binds.
16. OLMoE-1B-7B (allenai/OLMoE-1B-7B-0924's config.json: 16 layers, 64
   experts, top 8, an untied head; 6.92G parameters) built in memory
   through from_hf_state_dict, held to its config and every HF tensor; its
   kernels at its shapes (decode attention at group 1 with an [S] and a
   [B, S] bias, the untied head's argmax over lm_head's rows, the flash
   kernels at 16/16 heads of hd 128, W4A8 at w_qkv and wo), the routed
   MLP's device time per layer-step beside its bound, the routing of a
   prefill of random tokens (every expert of every layer chosen, many top-k
   sets), the 300 requests batch-last (decode attention on every
   layer-step, the decode MLP never, the head + argmax every step) against
   the plain path, one batch-first, one sampled and one int8="w4a8" batch,
   bulk beside batch on mid-budget EOS ids, and 10 stage-1 micro-steps on
   the flash route (step 0 against the plain path, peak memory).
17. DeepSeek-V2-Lite's widths (its config.json cut to 4 of 27 layers, all
   sparse: first_k_dense_replace 0) written as an HF deepseek_v2 directory
   and read back through build_lm: the untied head's argmax at V 102400,
   the routed MLP's and the absorbed MLA attention's time per layer-step,
   the routing check, and the serving paths of 16 with MLA's (no
   decode-attention launch; absorbed batch-last loop against the expanded
   batch-first one).
18. The four CLIs and the serving CLI as a user runs them: fixture data
   from the port's generate_dataset (sydney, sharegpt4v, candels; 16
   training and 8 eval items) and configs/smoke's v2, v4, v6 and v3 (each
   micro-step logged) through train_projector.cli, train_hypernet.cli
   (train, then fewshot), train_lora.cli, then serve.main on stage 1's best
   projector and the sydney test pkl, each run's wall seconds printed.  At
   test:tiny in f32 on the card and with --device cpu, held equal: every
   logged loss within TOL["loss"], the same captions, ids and metrics in
   every results JSON and the same served captions (a caption that differs
   is printed with its token step and, for the served ones, the logit gap
   there).  At test:1b (Llama-3.2-1B's body, vocab 512) in bf16 on the
   card, with a w4a8 serve run too: finite losses, results JSONs with
   training/results.py's keys whose metrics equal metrics_for recomputed
   from their captions, one caption a request, and each run's launches of
   the kernels in CLI_KERNELS non-zero.

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
    by_shape = {"w4_mm": {}, "w8_mm": {}}
    layers = {(H, 3072): "w_qkv", (H, H): "wo", (H, 2 * I): "w_gu", (I, H): "w_down"}
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
        # the library chains: (unpack,) torch._int_mm (batch-first: its row
        # count must exceed 16), rescale
        hq_t = hq.t().contiguous()

        def chain(q, w):
            return lambda: (torch._int_mm(hq_t, q()).t().float() * w["s"].reshape(-1, 1)
                            * a).to(torch.bfloat16)

        for key, w, kernel, plain, chain_fn, packed in (
                ("w4_mm", w4w, w4.w4_mm_bl, w4._w4_mm_plain,
                 chain(lambda: quant.unpack_w4(w4w["qp"]), w4w), True),
                ("w8_mm", w8w, w4.w8_mm_bl, w4._w8_mm_plain, chain(lambda: w8w["q8"], w8w),
                 False)):
            try:
                lib_ms = device_ms(chain_fn)
                equal(f"   library chain of {key} K={K} out={out_dim}", chain_fn(),
                      plain(w, hq, a, torch.bfloat16))
            except RuntimeError as e:  # a yardstick only: the port never calls it
                print(f"    torch._int_mm refused the shape: {str(e)[:200]}")
                lib_ms = None
            weights = w["qp"] if packed else w["q8"]
            t = {"ms": device_ms(lambda: kernel(w, hq, a, torch.bfloat16)),
                 "plain_ms": device_ms(lambda: plain(w, hq, a, torch.bfloat16)),
                 "library_ms": lib_ms,
                 **least_time(nbytes(weights, w["s"], hq, a) + out_dim * b * 2,
                              2 * K * out_dim * b, "int8")}
            us = host_us(torch, lambda: kernel(w, hq, a, torch.bfloat16))
            again = kernel(w, hq, a, torch.bfloat16)
            if not torch.equal(again, kernel(w, hq, a, torch.bfloat16)):
                raise AssertionError(f"{key} K={K} out={out_dim}: two calls differ")
            plan = {k: v for k, v in w4.plan(K, out_dim, b, packed).items()
                    if k in ("splits", "per_split", "grid", "blocks", "tma")}
            print(f"    {key} {layers[(K, out_dim)]} (K={K} out={out_dim} B={b}) bf16: kernel "
                  f"{t['ms'] * 1e3!r} us, plain {t['plain_ms'] * 1e3!r} us, library "
                  f"{None if lib_ms is None else lib_ms * 1e3!r} us (kernel / library "
                  f"{None if lib_ms is None else t['ms'] / lib_ms!r}); bound "
                  f"{t['bound_ms'] * 1e3!r} us ({t['bound_by']}); plan {plan}; host time per "
                  f"call {us!r} us; two calls bit-equal")
            by_shape[key][layers[(K, out_dim)]] = {k: t[k] for k in ("ms", "plain_ms",
                                                                      "library_ms", "bound_ms")}
            if out_dim == 2 * I:  # w_gu, the largest of a step's four: the kernels line
                results[key] = {"max_abs_err": 0.0, **t}
    for key in by_shape:
        results[key]["by_shape"] = by_shape[key]

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
    gaps = {mode: [] for mode in trees}  # each mode's entry gets its own checks' largest gap
    for mode, params in trees.items():
        for b in (B, 8, 64, 100, 256):
            h = _normal(torch, dev, gen, (H, b)).bfloat16()
            gaps[mode].append(head_check(torch, tha, f"{mode} V={V} B={b}", params, h, mode))
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
            us = host_us(torch, lambda: tha.head_argmax(params, h))
            if not torch.equal(tha.head_argmax(params, h), tha.head_argmax(params, h)):
                raise AssertionError(f"head argmax {mode}: two calls differ")
            plan = {k: v for k, v in tha.plan(V, H, b, mode).items() if k != "runs"}
            print(f"    {mode}: {report_times(t)}; library: matmul (the int8 embed widened "
                  f"to bf16 first), argmax; plan {plan}; host time per call {us!r} us; two "
                  f"calls equal")
            # one entry a mode: bf16 (the bf16 tree), q (int8=True), q8 (w4a8, w8a8)
            results["head_argmax" if mode == "bf16" else f"head_argmax_{mode}"] = t
    # a V that no slice size divides, and ties planted across vocab slices
    small = _normal(torch, dev, gen, (1001, H))
    u = _normal(torch, dev, gen, (H,))
    tied = _normal(torch, dev, gen, (9000, H), 0.1)
    tied[7000] = tied[300] = 4.0 * u
    for mode in trees:
        def tree(x):
            return {"embed": x.bfloat16() if mode == "bf16"
                    else quant.quantize_embed_tensor(x, native=(mode == "q8"))}

        gaps[mode].append(head_check(torch, tha, f"{mode} V=1001 B=64", tree(small),
                               _normal(torch, dev, gen, (H, 64)).bfloat16(), mode))
        ids = tha.head_argmax(tree(tied), u[:, None].repeat(1, 32).bfloat16().contiguous())
        first = bool((ids == 300).all())
        print(f"  {mode}: one winning row planted in vocab tiles 1 and 27: first wins {first}")
        if not first:
            raise AssertionError(f"head argmax {mode}: a tie across slices went to {ids.tolist()}")
    del trees, embed
    for mode in gaps:
        key = "head_argmax" if mode == "bf16" else f"head_argmax_{mode}"
        results[key] = {"max_abs_err": max(gaps[mode]), **results[key]}
    print(f"tensor maps encoded so far: head {tha.map_encodes()}, int8 matmul "
          f"{w4.map_encodes()}")
    return results


def bl_serving_phase(torch, dev, cfg, params, projector, embs):
    """The batch-last loop, the Captioner's default, at full width and depth:
    the same requests as slice_phase at batch 128 over (a) the bf16 tree and
    (b) int8="w4a8", then one batch each of (c) int8=True and (d)
    int8="w8a8"; launch counts set to 0 before each run and checked after;
    (a) and (b) against their plain paths, (a) also against the batch-first
    loop.  Returns the launch counts of (a) and (b)."""
    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.ops.cuda import head_argmax as tha
    from dmi_tpu_torch.ops.cuda import w4_matmul as w4
    from dmi_tpu_torch.serve import Captioner

    spec, pparams = projector
    n, L, steps = embs.shape[0], cfg.num_hidden_layers, MAX_NEW - 1
    card = nvidia_smi()

    def captioner(**kw):
        return Captioner(cfg, params, spec, pparams, max_new_tokens=MAX_NEW, batch_size=128,
                         prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID, **kw)

    def maps_now():  # the weights' tensor maps each TMA kernel has encoded
        return {"decode_mlp": dm.map_encodes()["weights"],
                "head_argmax": tha.map_encodes()["weights"], "w4_mm": w4.map_encodes()["weights"]}

    def serve(label, cap, requests, want):
        cap.caption_ids(requests[:128])  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        maps = maps_now()
        t0 = time.perf_counter()
        ids = cap.caption_ids(requests)
        secs = time.perf_counter() - t0
        counts = _counts()
        maps = {k: v - maps[k] for k, v in maps_now().items()}
        print(f"{label}: {len(requests)} requests at batch 128, {secs!r} s, "
              f"{len(requests) / secs!r} captions/s ({card}); weight tensor maps encoded "
              f"after the warm-up batch: {maps}")
        if any(maps.values()):
            raise AssertionError(f"{label}: weight tensor maps encoded again after the warm-up")
        batches = -(-len(requests) // 128)
        _expect(label, counts, {k: v * batches for k, v in want.items()})
        if tuple(ids.shape) != (len(requests), MAX_NEW) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: caption ids {tuple(ids.shape)} outside [0, vocab)")
        return ids, counts

    print("batch-last serving (the Captioner's default loop):")
    per_batch = {"mlp2": 1, "decode_attention": L * steps, "head_argmax": steps}
    cap = captioner()
    ids, counts_a = serve("(a) bf16 tree", cap, embs, {**per_batch, "decode_mlp": L * steps})
    t0 = time.perf_counter()
    plain = cap.caption_ids(embs, plain=True)
    print(f"  plain path: {len(embs) / (time.perf_counter() - t0)!r} captions/s")
    token_agreement("its plain path", ids, plain)
    token_agreement("the batch-first loop", ids, captioner(batch_first=True).caption_ids(embs))
    print("where one batch-last bf16 batch's time goes:")
    profile_run(torch, "batch 128, bf16 tree", lambda: cap.caption_ids(embs[:128]))

    cap = captioner(int8="w4a8")
    ids, counts_b = serve('(b) int8="w4a8"', cap, embs, {**per_batch, "w4_mm": 4 * L * steps})
    t0 = time.perf_counter()
    plain = cap.caption_ids(embs, plain=True)
    print(f"  plain path: {len(embs) / (time.perf_counter() - t0)!r} captions/s")
    token_agreement("its plain path", ids, plain)
    print("where one batch-last w4a8 batch's time goes:")
    profile_run(torch, "batch 128, w4a8 tree", lambda: cap.caption_ids(embs[:128]))

    _, counts_c = serve("(c) int8=True (int8 weights widened at each matmul)",
                        captioner(int8=True), embs[:128], per_batch)
    _, counts_d = serve('(d) int8="w8a8"', captioner(int8="w8a8"), embs[:128],
                        {**per_batch, "w8_mm": 4 * L * steps})
    del cap
    torch.cuda.empty_cache()
    return {"serving batch-last": counts_a, "serving w4a8": counts_b, "serving int8": counts_c,
            "serving w8a8": counts_d}


def token_agreement(label, ids, other):
    """Held to TOKEN_AGREEMENT: the share of equal tokens of two runs."""
    share = (ids == other).float().mean().item()
    first = (ids[:, 0] == other[:, 0]).float().mean().item()
    rows = (ids == other).all(dim=1).float().mean().item()
    ok = share >= TOKEN_AGREEMENT
    print(f"  token agreement with {label}: {share!r} (limit {TOKEN_AGREEMENT}), rows "
          f"identical {rows!r}, first tokens equal {first!r} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"tokens disagree with {label}")
    return share


def _check_ids(cfg, label, ids, n):
    if tuple(ids.shape) != (n, MAX_NEW) or not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"{label}: caption ids {tuple(ids.shape)} outside [0, vocab)")


def row_bias_kernel_phase(torch, dev):
    """Decode attention with a [B, S] bias, a row per slot (the
    continuous-batching engine's), against its twin: at the bulk engine's
    shape (B 128, 32/8 heads, hd 64, S 38 = T 16 + budget 22) with ring-shaped
    masks and row 0 a slot never used (finfo.min everywhere), bf16 and f32;
    at B 2 over 3073 and 16384 positions with finfo.min over whole splits of
    row 0 only and row 1 fully masked.  Two calls bit-equal; timed against
    its bound and SDPA with the same float mask [B, 1, 1, S] and GQA."""
    from dmi_tpu_torch.ops.cuda import decode_attn as da

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    fmin = torch.finfo(torch.float32).min
    T, budget = len(PREFIX_IDS) + 1, MAX_NEW
    errs, times = [], None

    def timed(label, args):
        q, k, v, bias = args
        B, S = bias.shape
        mask = bias.view(B, 1, 1, S).to(q.dtype)
        t = {**device_times(
            torch, lambda: da.fused_decode_attention(*args), lambda: da._decode_attn_plain(*args),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)),
             **least_time(nbytes(q, k, v, bias, q), 4 * B * 32 * S * 64, q.dtype)}
        print(f"    {label}: {report_times(t)}; library: scaled_dot_product_attention, GQA, "
              f"float mask [B, 1, 1, S]; plan {da.plan(B, 8, 4, S, 64, q.element_size())}")
        if not torch.equal(da.fused_decode_attention(*args), da.fused_decode_attention(*args)):
            raise AssertionError(f"{label}: two calls on the same inputs differ")
        print(f"    {label}: two calls bit-equal")
        return t

    print("kernel fused_decode_attention with a [B, S] bias (a row per slot) vs "
          "_decode_attn_plain (32/8 heads, hd 64):")
    for dtype in (torch.bfloat16, torch.float32):
        B, S = 128, T + budget
        q = torch.randn(B, 32, 1, 64, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, 8, S, 64, generator=gen, device=dev).to(dtype) for _ in range(2))
        bias = torch.full((B, S), fmin)
        for b in range(1, B):  # prompt rows and a wrapped run of the slot's own ring rows
            bias[b, :T] = 0.0
            start, n = int(rng.integers(budget)), int(rng.integers(1, budget + 1))
            bias[b, T + (start + np.arange(n)) % budget] = 0.0
        args = (q, k, v, bias.to(dev))
        label = f"B={B} S={S} {str(dtype)[6:]} (ring masks, row 0 never used)"
        errs.append(compare(torch, label, da.fused_decode_attention(*args),
                            da._decode_attn_plain(*args), TOL[str(dtype)[6:]]))
        if dtype == torch.bfloat16:  # the bulk engine's call: the kernels line
            times = timed(label, args)
    for S in (3073, 16384):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(2, 32, 1, 64, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(2, 8, S, 64, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            ks = da.plan(2, 8, 4, S, 64, q.element_size())["keys_per_split"]
            bias = torch.zeros(2, S, device=dev)
            bias[0, ks:3 * ks] = fmin  # whole splits of row 0 only
            bias[1] = fmin             # row 1 fully masked
            args = (q, k, v, bias)
            label = (f"B=2 S={S} {str(dtype)[6:]} (row 0: finfo.min over splits 1-2; "
                     "row 1 fully masked)")
            errs.append(compare(torch, label, da.fused_decode_attention(*args),
                                da._decode_attn_plain(*args), TOL[str(dtype)[6:]]))
            if dtype == torch.bfloat16:
                timed(label, args)
    return {"decode_attention_rows": {"max_abs_err": max(errs), **times}}


SAMPLE = dict(temperature=0.7, top_k=50, top_p=0.9, seed=0)


def sampling_phase(torch, dev, cfg, params, projector, embs):
    """Sampled serving on the batch-last loop (request-indexed draws;
    SAMPLE): the requests at batch 128 over the bf16 tree and one batch of
    int8="w4a8", launch counts checked, ids in range, two runs identical,
    token agreement with the plain path; the warp + draw's device time per
    step at V 128256, B 128; one bf16 batch profiled."""
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.serve import Captioner

    spec, pparams = projector
    L, steps = cfg.num_hidden_layers, MAX_NEW - 1
    card = nvidia_smi()
    print(f"sampled serving (batch-last loop, request-indexed draws, {SAMPLE}):")
    counts = {}
    for label, int8, requests, extra in (("bf16 tree", False, embs, {"decode_mlp": L * steps}),
                                         ('int8="w4a8"', "w4a8", embs[:128],
                                          {"w4_mm": 4 * L * steps})):
        cap = Captioner(cfg, params, spec, pparams, max_new_tokens=MAX_NEW, batch_size=128,
                        prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID, int8=int8)
        cap.caption_ids(requests[:128], **SAMPLE)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        ids = cap.caption_ids(requests, **SAMPLE)
        secs = time.perf_counter() - t0
        counts[label] = _counts()
        print(f"sampled {label}: {len(requests)} requests at batch 128, {secs!r} s, "
              f"{len(requests) / secs!r} captions/s ({card})")
        batches = -(-len(requests) // 128)
        _expect(f"sampled {label}", counts[label],
                {k: v * batches for k, v in {"mlp2": 1, "decode_attention": L * steps,
                                             **extra}.items()})
        _check_ids(cfg, f"sampled {label}", ids, len(requests))
        if not torch.equal(ids, cap.caption_ids(requests, **SAMPLE)):
            raise AssertionError(f"sampled {label}: two runs of one (seed, workload) differ")
        print("  two runs identical")
        token_agreement("its plain path", ids, cap.caption_ids(requests, plain=True, **SAMPLE))
        if int8 is False:
            greedy = cap.caption_ids(requests)
            print(f"  token agreement with greedy decoding: "
                  f"{(ids == greedy).float().mean().item()!r} (sampling moved the tokens)")
            print("where one sampled bf16 batch's time goes:")
            profile_run(torch, "batch 128, sampled bf16 tree",
                        lambda: cap.caption_ids(requests[:128], **SAMPLE))
    V, B = cfg.vocab_size, 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    logits = torch.randn(V, B, generator=gen, device=dev).to(torch.bfloat16)  # head_logits_bl's
    keys = dec._req_keys(SAMPLE["seed"], torch.arange(B, device=dev), MAX_NEW, 5)
    args = (SAMPLE["temperature"], SAMPLE["top_k"], SAMPLE["top_p"])
    warped = dec._warp_bl(logits, *args)
    t = {"pick": device_ms(lambda: dec._sample_pick_bl(logits, keys, *args)),
         "warp": device_ms(lambda: dec._warp_bl(logits, *args)),
         "draw": device_ms(lambda: dec._gumbel_pick(warped, keys))}
    print(f"warp + draw per step at V {V}, B {B} (plain torch ops, device time per call): "
          f"{t['pick'] * 1e3!r} us (the warp chain {t['warp'] * 1e3!r} us, the draw "
          f"{t['draw'] * 1e3!r} us); {steps + 1} a batch ({card})")
    return {"serving sampled": counts["bf16 tree"], "serving sampled w4a8": counts['int8="w4a8"']}


SPEC_K = 4  # proposals a speculative round: the verify attends from k + 1 = 5 positions


def spec_kernel_phase(torch, dev):
    """The kernels at the speculative verify's shapes (Llama-3.2-1B, k 4,
    budget 22, B 128: P * B = 640 lanes): K3, decode attention with P = 5
    query positions per cache row over S = T 16 + 5 x 21 = 121 rows with the
    bias the row bookkeeping builds (earlier rounds' accepted rows, this
    round's rows up to each position, one finished slot), bf16 and f32,
    against its twin, timed beside its bound and SDPA with the same float
    mask [B, 1, P, S]; two calls bit-equal; the decode MLP (H 2048, I 8192,
    silu) and the bf16 head + argmax (V 128256) at 640 columns against
    their twins, timed."""
    import torch.nn.functional as F

    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.ops.cuda import head_argmax as tha

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    rng = np.random.default_rng(SEED + 15)
    T, P, B, H, I, V = len(PREFIX_IDS) + 1, SPEC_K + 1, 128, 2048, 8192, 128256
    S = T + P * (MAX_NEW - 1)
    results = {}
    # round 10 of a batch: each earlier round kept its first 1 + n_acc rows
    rnd = 10
    rt = T + P * rnd
    valid = torch.zeros(B, S, dtype=torch.bool)
    valid[:, :T] = True
    for r in range(rnd):
        keep = 1 + torch.from_numpy(rng.integers(0, P, size=B))
        valid[:, T + P * r:T + P * (r + 1)] = torch.arange(P)[None, :] < keep[:, None]
    valid[:, rt:rt + P] = True
    valid[0, rt:] = False  # a finished slot: its round rows stamped invalid
    sees = torch.arange(S)[None, :] <= (rt + torch.arange(P))[:, None]  # [P, S]
    bias = torch.where(valid[:, None, :] & sees[None], 0.0,
                       torch.finfo(torch.float32).min).to(dev)
    print(f"kernel fused_decode_attention with P = {P} query positions per cache row (K3) vs "
          f"_decode_attn_plain (B {B}, 32/8 heads, hd 64, S {S}, round {rnd}'s rows):")
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, 32, P, 64, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, 8, S, 64, generator=gen, device=dev).to(dtype) for _ in range(2))
        args = (q, k, v, bias)
        label = f"B={B} P={P} S={S} {str(dtype)[6:]}"
        out = da.fused_decode_attention(*args)
        errs.append(compare(torch, label, out, da._decode_attn_plain(*args), TOL[str(dtype)[6:]]))
        if not torch.equal(out, da.fused_decode_attention(*args)):
            raise AssertionError(f"K3 {label}: two calls on the same inputs differ")
        if dtype != torch.bfloat16:
            continue
        mask = bias.view(B, 1, P, S).to(dtype)
        t = {**device_times(
            torch, lambda: da.fused_decode_attention(*args), lambda: da._decode_attn_plain(*args),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)),
             **least_time(nbytes(q, k, v, bias, q), 4 * B * 32 * P * S * 64, dtype)}
        us = host_us(torch, lambda: da.fused_decode_attention(*args))
        print(f"    {label}: {report_times(t)}; library: scaled_dot_product_attention, GQA, "
              f"float mask [B, 1, P, S]; K and V alone {nbytes(k, v) / 1e6!r} MB; plan "
              f"{da.plan(B * P, 8, 4, S, 64, 2)}; host time per call {us!r} us; two calls "
              f"bit-equal")
        results["decode_attention_spec"] = t
    results["decode_attention_spec"]["max_abs_err"] = max(errs)

    N = P * B
    print(f"kernel fused_decode_mlp_bl at the verify's {N} columns (H {H}, I {I}, silu):")
    w_gu = _normal(torch, dev, gen, (H, 2 * I), H ** -0.5).bfloat16()
    w_down = _normal(torch, dev, gen, (I, H), I ** -0.5).bfloat16()
    h = _normal(torch, dev, gen, (H, N)).bfloat16()
    args = (w_gu, w_down, h, "silu")
    err = compare(torch, f"H={H} I={I} B={N} bfloat16 silu", dm.fused_decode_mlp_bl(*args),
                  dm._decode_mlp_plain(*args), TOL["bfloat16"])
    if not torch.equal(dm.fused_decode_mlp_bl(*args), dm.fused_decode_mlp_bl(*args)):
        raise AssertionError(f"decode MLP at B {N}: two calls on the same inputs differ")

    def chain():
        g, u = (w_gu.t() @ h).chunk(2, dim=0)
        return w_down.t() @ (F.silu(g) * u)

    t = {**device_times(torch, lambda: dm.fused_decode_mlp_bl(*args),
                        lambda: dm._decode_mlp_plain(*args), chain),
         **least_time(nbytes(w_gu, w_down, h, h), 2 * N * 3 * H * I, torch.bfloat16)}
    print(f"    B={N}: {report_times(t)}; library: matmul, silu * mul, matmul (the twin is "
          f"this chain); plan {dm.plan(H, I, dm.padded_batch(N))}; two calls bit-equal")
    results["decode_mlp_spec"] = {"max_abs_err": err, **t}

    print(f"kernel head_argmax bf16 at the verify's {N} columns (V {V}, H {H}):")
    params = {"embed": _normal(torch, dev, gen, (V, H)).bfloat16()}
    h = _normal(torch, dev, gen, (H, N)).bfloat16()
    gap = head_check(torch, tha, f"bf16 V={V} B={N}", params, h, "bf16")
    t = {**device_times(torch, lambda: tha.head_argmax(params, h),
                        lambda: tha._head_argmax_plain(params["embed"], h),
                        lambda: (params["embed"] @ h).argmax(dim=0)),
         **least_time(nbytes(params["embed"], h) + 4 * N, 2 * V * H * N, torch.bfloat16)}
    plan = {k: v for k, v in tha.plan(V, H, N, "bf16").items() if k != "runs"}
    print(f"    bf16: {report_times(t)}; library: matmul, argmax; plan {plan}")
    results["head_argmax_spec"] = {"max_abs_err": gap, **t}
    return results


def _sim_forced_rounds(budget, k, wp):
    """The forced harness's rounds in closed form: a proposal at output index
    i is corrupted iff wp > 0 and i % wp == 0; a round emits its clean
    leading proposals and one more token."""
    out_pos, rounds = 1, 0
    while out_pos < budget:
        n_acc = 0
        while n_acc < k and not (wp > 0 and (out_pos + n_acc) % wp == 0):
            n_acc += 1
        out_pos, rounds = min(out_pos + n_acc + 1, budget), rounds + 1
    return rounds


def spec_phase(torch, dev, cfg, params, projector, embs):
    """Speculative decoding (A.8) at full width and depth, bf16 target and
    its W4A8 self-draft, k 4: the requests through
    Captioner(speculative=4).caption_ids beside the plain batch-last run
    (captions/s, token agreement, rounds and tokens a round, launch
    counts: a round is k + 1 draft steps and one verify, so L x rounds K3
    launches, L x (k + 1) x rounds decode-attention launches with a [B, S]
    bias and 4 L x (k + 1) x rounds W4A8 matmuls); one batch profiled; the
    oracle draft at wrong_period 0 over its own fixed point (the closed-form
    5 rounds) and 1, the forced harness at 0 and 1 (its closed-form rounds
    and chain), captions/s of each; one sampled batch (SAMPLE); the bulk
    engine beside the batch engine, both speculative, on mid-budget EOS ids.
    Returns each run's launch counts."""
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import llama, mmmodel
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.models import speculative as sp
    from dmi_tpu_torch.ops import l2_normalize
    from dmi_tpu_torch.serve import Captioner

    spec, pparams = projector
    k, L, n = SPEC_K, cfg.num_hidden_layers, embs.shape[0]
    card = nvidia_smi()

    def captioner(c=cfg, **kw):
        return Captioner(c, params, spec, pparams, max_new_tokens=MAX_NEW, batch_size=128,
                         prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID, **kw)

    def per_round(rounds, heads=True):
        """A round's launches: the verify (K3 on every layer, the decode MLP
        at 640 columns, the bf16 head + argmax) and k + 1 draft steps
        (decode attention with a [B, S] bias, kernel 7 at four matmuls, the
        q8 head + argmax on all but the last)."""
        return {"decode_attention": L * (k + 2) * rounds,
                "decode_attention_rows": L * (k + 1) * rounds,
                "decode_attention_pos": L * rounds, "decode_mlp": L * rounds,
                "w4_mm": 4 * L * (k + 1) * rounds, "head_argmax": (1 + k) * rounds if heads else 0}

    def timed(label, run, rows):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"  {label}: {rows} requests, {secs!r} s, {rows / secs!r} captions/s ({card})")
        return out, secs, _counts()

    print(f"speculative decoding (Captioner(speculative={k}): bf16 target, W4A8 self-draft):")
    plain_cap, cap = captioner(), captioner(speculative=k)
    for c in (plain_cap, cap):  # warm-up
        c.caption_ids(embs[:128])
    plain, plain_secs, _ = timed("plain batch-last bf16", lambda: plain_cap.caption_ids(embs), n)
    ids, secs, counts = timed(f"speculative k={k}", lambda: cap.caption_ids(embs), n)
    rounds = cap.spec_rounds
    batches = -(-n // 128)
    _check_ids(cfg, "speculative", ids, n)
    print(f"    {rounds} rounds over {batches} batches, {rounds / batches!r} a batch; "
          f"{(MAX_NEW - 1) * batches / rounds!r} tokens a round a row (EOS off: 21 a row "
          f"after token 0); captions/s against plain {plain_secs / secs!r}x")
    _expect("speculative", counts, {"mlp2": batches, **per_round(rounds)})
    token_agreement("the plain batch-last run", ids, plain)
    print("where one speculative batch's time goes:")
    profile_run(torch, f"batch 128, speculative k={k}", lambda: cap.caption_ids(embs[:128]))
    paths = {"serving speculative": counts}

    # the measurement entries over the first batch's prompt, as the Captioner
    # assembles it
    e = l2_normalize(torch.as_tensor(embs[:128], device=dev))
    prefix = torch.as_tensor(PREFIX_IDS, device=dev)[None].expand(128, -1)
    prompt = mmmodel.assemble_prompt(cfg, params, proj.apply(spec, pparams, e), prefix)
    draft = cap.draft_params
    oracle = dec.greedy_generate_bl(cfg, params, prompt, MAX_NEW, PAD_ID)
    first_rounds, runs = None, 0
    while True:  # the oracle stream that the verify forward accepts in full
        runs += 1
        got, r = sp.speculative_generate_oracle_bl(cfg, params, prompt, oracle, MAX_NEW, PAD_ID,
                                                   k=k, wrong_period=0)
        first_rounds = r if first_rounds is None else first_rounds
        if torch.equal(got, oracle) or runs == MAX_NEW:
            break
        oracle = got
    print(f"  oracle at wrong_period 0: the plain greedy ids as the stream took {first_rounds} "
          f"rounds; the stream the verify accepts in full found after {runs} runs (each run's "
          f"output the next one's stream)")
    sliding = llama.sliding_effective(cfg, len(PREFIX_IDS) + 1 + MAX_NEW)

    def acceptance(label, draft_params):
        """The batch loop's rounds (speculative_generate_bl's, share_prefill)
        with the accepted proposals of the live rows counted; its tokens and
        rounds held to the loop's own."""
        core, eos, T, max_rounds = sp._spec_setup(cfg, params, None, prompt, MAX_NEW, PAD_ID, k)
        kv_d, valid_d, rp_d, Td = sp._draft_setup(cfg, draft_params, params, prompt, k,
                                                  max_rounds, from_target=core.caches)
        heads = dec.fused_head_weights(cfg, params), dec.fused_head_weights(cfg, draft_params)
        accepted, live_rows, rnd = 0, 0, 0
        while rnd < max_rounds and not bool(core.done.all()):
            live, rd = ~core.done, Td + rnd * (k + 1)
            props = sp._draft_steps_greedy(cfg, draft_params, core.last, core.done, core.out_pos,
                                           kv_d, valid_d, rp_d, rd, Td, k, sliding, heads[1])
            n_acc = sp._verify_round(cfg, params, core, props, rnd, k, T, MAX_NEW, eos, sliding,
                                     head_w=heads[0])
            sp._retract_rows(valid_d, rd, k, n_acc)
            accepted += int(n_acc[live].sum())
            live_rows += int(live.sum())
            rnd += 1
        want, r = sp.speculative_generate_bl(cfg, params, cfg, draft_params, prompt, prompt,
                                             MAX_NEW, PAD_ID, k=k, draft_prefill_params=params,
                                             share_prefill=True)
        print(f"  {label}: {rnd} rounds, {accepted / live_rows!r} of {k} proposals accepted a "
              f"live row a round ({live_rows} row-rounds); tokens and rounds those of "
              f"speculative_generate_bl {torch.equal(core.tokens, want) and rnd == r}")
        if not (torch.equal(core.tokens, want) and rnd == r):
            raise AssertionError(f"{label}: the counted rounds differ from the loop's")

    acceptance("acceptance of the W4A8 self-draft (one batch)", draft)
    acceptance("acceptance of the bf16 tree as its own draft (one batch)", params)
    for wp, want in ((0, -(-(MAX_NEW - 1) // (k + 1))), (1, MAX_NEW - 1)):
        (got, r), osecs, _ = timed(f"oracle wrong_period {wp}", lambda wp=wp: (
            sp.speculative_generate_oracle_bl(cfg, params, prompt, oracle, MAX_NEW, PAD_ID, k=k,
                                              wrong_period=wp)), 128)
        print(f"    {r} rounds (closed form {want}); captions/s against plain "
              f"{plain_secs / n * 128 / osecs!r}x")
        if r != want or (wp == 0 and not torch.equal(got, oracle)):
            raise AssertionError(f"oracle wrong_period {wp}: {r} rounds, not {want}")
    for wp in (0, 1):
        (got, r), fsecs, _ = timed(f"forced harness wrong_period {wp}", lambda wp=wp: (
            sp.speculative_generate_forced_bl(cfg, params, cfg, draft, prompt, prompt, MAX_NEW,
                                              PAD_ID, wp, k=k, draft_prefill_params=params)), 128)
        want = _sim_forced_rounds(MAX_NEW, k, wp)
        chain = sp._chain_next(got[:, :-1], cfg.vocab_size, cfg.eos_token_ids)
        print(f"    {r} rounds (closed form {want}); the chain held {torch.equal(got[:, 1:], chain)}"
              f"; captions/s against plain {plain_secs / n * 128 / fsecs!r}x")
        if r != want or not torch.equal(got[:, 1:], chain):
            raise AssertionError(f"forced harness wrong_period {wp}: {r} rounds, not {want}")

    (sids, ssecs, scounts) = timed(f"sampled speculative ({SAMPLE})",
                                   lambda: cap.caption_ids(embs[:128], **SAMPLE), 128)
    _check_ids(cfg, "sampled speculative", sids, 128)
    _expect("sampled speculative", scounts,
            {"mlp2": 1, **per_round(cap.spec_rounds, heads=False)})
    if not torch.equal(sids, cap.caption_ids(embs[:128], **SAMPLE)):
        raise AssertionError("sampled speculative: two runs of one (seed, workload) differ")
    plain_s = plain_cap.caption_ids(embs[:128], **SAMPLE)
    print(f"    {cap.spec_rounds} rounds; two runs identical; token agreement with the plain "
          f"sampler {(sids == plain_s).float().mean().item()!r} (the same law, other draws "
          f"where the draft is rejected)")
    V = cfg.vocab_size
    logits = torch.randn(V, (k + 1) * 128, device=dev).to(torch.bfloat16)
    res = torch.rand(V, k * 128, device=dev)
    keys = dec._req_keys(SAMPLE["seed"], torch.arange(k * 128, device=dev), MAX_NEW, 3)
    warp_ms = device_ms(lambda: dec._warp_bl(logits, SAMPLE["temperature"], SAMPLE["top_k"],
                                             SAMPLE["top_p"]))
    draw_ms = device_ms(lambda: dec._gumbel_pick(torch.log(res), keys))
    warped = dec._warp_bl(logits, SAMPLE["temperature"], SAMPLE["top_k"], SAMPLE["top_p"])
    rows_ms = device_ms(lambda: sp._softmax_v(warped))
    lead_ms = device_ms(lambda: torch.softmax(warped, dim=0))
    print(f"    the verify's sampler pieces (plain torch ops, device time per call): the warp of "
          f"{(k + 1) * 128} columns {warp_ms * 1e3!r} us, the residual draw over {k * 128} "
          f"columns {draw_ms * 1e3!r} us, p's softmax over rows of the transpose "
          f"(_softmax_v) {rows_ms * 1e3!r} us against {lead_ms * 1e3!r} us over the leading "
          f"axis, at V {V} ({card})")
    paths["serving speculative sampled"] = scounts

    eos, mean_len = _mid_budget_eos(plain)
    ecap = captioner(dataclasses.replace(cfg, eos_token_ids=eos), speculative=k)
    for engine in ("batch", "bulk"):  # warm-up
        ecap.caption_ids(embs[:128], engine=engine)
    print(f"  speculative bulk beside batch, EOS ids {eos} (mean length {mean_len!r}):")
    bids, bsecs, _ = timed("engine=batch speculative", lambda: ecap.caption_ids(
        embs, engine="batch"), n)
    brounds = ecap.spec_rounds
    uids, usecs, ucounts = timed("engine=bulk speculative", lambda: ecap.caption_ids(
        embs, engine="bulk"), n)
    print(f"    rounds: batch {brounds}, bulk {ecap.spec_rounds}; batch / bulk wall "
          f"{bsecs / usecs!r}")
    _expect("engine=bulk speculative", ucounts,
            {"mlp2": -(-n // 32), **per_round(ecap.spec_rounds)})
    _check_ids(cfg, "engine=bulk speculative", uids, n)
    token_agreement("the batch speculative engine", uids, bids)
    paths["serving speculative bulk"] = ucounts
    del cap, ecap, plain_cap
    torch.cuda.empty_cache()
    return paths


def _mid_budget_eos(ids, most=3, pad=PAD_ID):
    """EOS ids, at most `most` (Llama-3's count), that end captions nearest
    the middle of the budget: chosen greedily from the ids of EOS-free
    greedy ids [N, MAX_NEW], each added while it brings the mean caption
    length (first occurrence of any chosen id, else the budget) nearer
    MAX_NEW / 2 (the smallest id on ties; never the pad id).  Returns the
    ids and the mean length."""
    ids = ids.numpy()
    toks = np.array([t for t in np.unique(ids) if t != pad])
    hit = ids[:, :, None] == toks[None, None, :]  # [N, MAX_NEW, U]
    first = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, MAX_NEW)  # [N, U]
    chosen, length = [], np.full(ids.shape[0], MAX_NEW)
    while len(chosen) < most:
        means = np.minimum(length[:, None], first).mean(axis=0)  # [U]
        best = int(np.argmin(np.abs(means - MAX_NEW / 2)))
        if abs(means[best] - MAX_NEW / 2) >= abs(length.mean() - MAX_NEW / 2):
            break
        chosen.append(int(toks[best]))
        length = np.minimum(length, first[:, best])
    return tuple(chosen), float(length.mean())


def bulk_phase(torch, dev, cfg, params, projector, embs):
    """The continuous-batching engine (engine="bulk") over the bf16 tree at
    pool 128, admit 32 (the Captioner's at batch 128), with EOS ids chosen
    from the batch engine's own greedy ids so that captions end mid-budget:
    the batch engine and the bulk engine on the same requests (captions/s
    side by side, token agreement), the bulk engine against its plain path, its
    launch counts (L decode-attention launches a step, every one with a
    [B, S] bias), engine="auto"'s decision, a sampled bulk run against the
    sampled batch engine, and profiles of both engines' whole workload."""
    from dmi_tpu_torch.serve import Captioner

    spec, pparams = projector
    L, n = cfg.num_hidden_layers, embs.shape[0]
    card = nvidia_smi()

    def captioner(c):
        return Captioner(c, params, spec, pparams, max_new_tokens=MAX_NEW, batch_size=128,
                         prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID)

    eos, mean_len = _mid_budget_eos(captioner(cfg).caption_ids(embs))
    print(f"continuous batching (engine=\"bulk\", pool 128, admit 32): EOS ids {eos}, whose "
          f"first occurrences in the batch engine's EOS-free greedy ids give mean length "
          f"{mean_len!r} of {MAX_NEW}")
    cap = captioner(dataclasses.replace(cfg, eos_token_ids=eos))
    for engine in ("batch", "bulk"):  # warm-up
        cap.caption_ids(embs[:128], engine=engine)
    runs = {}
    for engine in ("batch", "bulk"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        ids = cap.caption_ids(embs, engine=engine)
        secs = time.perf_counter() - t0
        runs[engine] = (ids, secs, _counts())
        _check_ids(cfg, f"engine={engine}", ids, n)
        print(f"  engine={engine}: {n} requests, {secs!r} s, {n / secs!r} captions/s "
              f"({card}); mean caption length {(ids != PAD_ID).sum(1).float().mean().item()!r}")
    eng = cap.bulk_engine
    print(f"  bulk engine: {eng.steps} steps, {eng.admissions} admissions; batch engine / bulk "
          f"engine wall {runs['batch'][1] / runs['bulk'][1]!r}")
    counts = runs["bulk"][2]
    _expect("engine=bulk", counts, {"mlp2": eng.admissions, "decode_attention": L * eng.steps,
                                    "decode_attention_rows": L * eng.steps,
                                    "decode_mlp": L * eng.steps, "head_argmax": eng.steps})
    ids = runs["bulk"][0]
    token_agreement("the batch engine", ids, runs["batch"][0])
    token_agreement("its plain path", ids, cap.caption_ids(embs, engine="bulk", plain=True))
    auto = cap.caption_ids(embs, engine="auto")
    _check_ids(cfg, "engine=auto", auto, n)
    print(f"  engine=\"auto\": decision {cap.engine_decision}")
    sampled = {e: cap.caption_ids(embs, engine=e, **SAMPLE) for e in ("batch", "bulk")}
    print(f"  sampled ({SAMPLE}):")
    token_agreement("the sampled batch engine", sampled["bulk"], sampled["batch"])
    print("where the whole workload's time goes, per engine (same EOS):")
    for engine in ("bulk", "batch"):
        profile_run(torch, f"engine={engine}, {n} requests",
                    lambda engine=engine: cap.caption_ids(embs, engine=engine))
    return {"serving bulk": counts}


def w4a8_divergence_phase(torch, dev, cfg, params, projector, embs):
    """Where the w4a8 kernel path and its plain=True path part, on one
    greedy batch of 128 at full width.  Every op the step runs through a
    kernel or its twin (mlp2, quantize_act, the int8 matmuls, decode
    attention, the head), and prefill's logits, is recorded in call order on
    both paths; the first op whose outputs differ is printed with its max
    relative difference (|a - b| / max(1, max |b|)) beside the tolerance that
    op is held to against its twin.  Each kernel is also run against its
    twin on the kernel path's own inputs, so an op that departs from its
    twin by more than its tolerance shows as such (and raises)."""
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import projector as proj_mod
    from dmi_tpu_torch.serve import Captioner

    spec, pparams = projector
    cap = Captioner(cfg, params, spec, pparams, max_new_tokens=MAX_NEW, batch_size=128,
                    prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID, int8="w4a8")
    tol = {"mlp2": TOL["float32"], "decode_attention": TOL["bfloat16"], "w4_mm": 0.0,
           "head_argmax": 0.0, "quantize_act": 0.0, "prefill logits": TOL["logits"]}
    log, own = {}, {}

    def rel(a, b):
        a, b = a.float(), b.float()
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())

    def record(name, module, attr, twin=None):
        """Wrap module.attr so that each call appends (name, output) to the
        current path's log (and, on the kernel path, runs the twin)."""
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            log[mode].append((name, (out[0] if isinstance(out, tuple) else out).clone()))
            if twin is not None and mode == "kernel":
                ref = twin(*args, **kw)
                err = (1.0 - (out == ref).float().mean().item() if name == "head_argmax"
                       else rel(out, ref))
                own[name] = max(own.get(name, 0.0), err)
            return out

        setattr(module, attr, wrapped)

    kernels = (("mlp2", proj_mod, "fused_mlp2", "_mlp2_plain"),
               ("decode_attention", dec, "fused_decode_attention", "_decode_attn_plain"),
               ("w4_mm", dec, "w4_mm_bl", "_w4_mm_plain"),
               ("head_argmax", dec, "head_argmax", "_head_argmax_plain"))
    saved = [(m, a, getattr(m, a)) for _, m, k, p in kernels for a in (k, p)]
    saved += [(dec, "quantize_act", dec.quantize_act), (dec, "prefill", dec.prefill)]
    requests = embs[:128]
    try:
        for name, m, k, p in kernels:
            pfn = getattr(m, p)
            twin = (lambda par, h, pfn=pfn: pfn(par["embed"], h)) if name == "head_argmax" \
                else pfn
            record(name, m, k, twin)
            record(name, m, p)
        record("quantize_act", dec, "quantize_act")
        record("prefill logits", dec, "prefill")
        ids = {}
        for mode in ("kernel", "plain"):
            log[mode] = []
            ids[mode] = cap.caption_ids(requests, plain=(mode == "plain"))
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    print("w4a8 divergence (one batch of 128, EOS off, the kernel path against plain=True; "
          "ops in call order):")
    seq = [n for n, _ in log["kernel"]]
    if seq != [n for n, _ in log["plain"]]:
        raise AssertionError("the two paths ran different sequences of ops")
    step, seen, first, first_over, prompt = 0, {}, None, None, None
    for (name, a), (_, b) in zip(log["kernel"], log["plain"]):
        if name == "prefill logits":
            step, prompt = 1, (a.float(), b.float())
        layer = seen.get((step, name), 0)
        seen[(step, name)] = layer + 1
        d = rel(a, b)
        where = {"mlp2": "the projector, before the prompt pass",
                 "prefill logits": "the prompt pass"}.get(name, f"decode step {step}")
        if name in ("w4_mm", "quantize_act"):
            where += f", layer {layer // 4}, matmul {('w_qkv', 'wo', 'w_gu', 'w_down')[layer % 4]}"
        elif name == "decode_attention":
            where += f", layer {layer}"
        if d > 0 and first is None:
            first = (name, where, d)
        if d > tol[name] and first_over is None:
            first_over = (name, where, d)
        if name == "head_argmax":
            step += 1
    for label, hit in (("first op where the paths part", first),
                       ("first op whose outputs part by more than that op's tolerance against "
                        "its twin (its inputs may have parted before)", first_over)):
        print(f"  {label}: " + ("none" if hit is None else
                                f"{hit[0]} ({hit[1]}): max relative difference {hit[2]!r} "
                                f"(tolerance {tol[hit[0]]!r})"))
    rows = ids["kernel"] != ids["plain"]
    positions = rows.any(dim=0).nonzero()
    print(f"  first token position that differs: "
          f"{int(positions[0]) if len(positions) else None}, in {int(rows[:, 0].sum())} of "
          f"{rows.shape[0]} rows at position 0; token agreement {1 - rows.float().mean().item()!r}")
    flipped = rows[:, 0].nonzero().flatten().tolist()
    if flipped:  # token 0 is the argmax of the prompt pass's logits on each path
        lk, lp = prompt
        tk, tp = ids["kernel"][flipped, 0].to(lk.device), ids["plain"][flipped, 0].to(lk.device)
        r = torch.tensor(flipped, device=lk.device)
        margin_k = (lk[r, tk] - lk[r, tp]).abs().max().item()
        margin_p = (lp[r, tp] - lp[r, tk]).abs().max().item()
        moved = (lk[r] - lp[r]).abs().max().item()
        print(f"  there the two picks' logits lie within {margin_k!r} on the kernel path and "
              f"{margin_p!r} on the plain path, while the paths' logits of those rows differ by "
              f"up to {moved!r}: near-ties, flipped by what parted first ({first[0]})")
    over = {k: v for k, v in own.items() if v > tol[k]}
    print("  each kernel against its twin on the kernel path's own inputs (max relative error; "
          "head: share of ids that differ): " + ", ".join(
              f"{k} {v!r} (tolerance {tol[k]!r})" for k, v in own.items()))
    if over:
        raise AssertionError(f"w4a8 path: kernels beyond their tolerance: {over}")


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
        for hpb, rows in ((1, 32), (1, 64), (2, 32), (2, 64), (4, 16), (4, 32))
        if (nh // k.shape[1]) % hpb == 0}  # a block's heads share one kv head
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
    with numpy from (SEED, stream, step).  Token ids are taken modulo
    `vocab` (an identity for Llama-3's vocabulary and larger ones)."""

    def __init__(self, steps, batch=TRAIN_BATCH, text=TRAIN_TEXT, mm=TRAIN_MM_DIM,
                 subset=None, stream=5, vocab=128256):
        self.steps, self.batch, self.text, self.mm = steps, batch, text, mm
        self.subset, self.stream, self.vocab = subset, stream, vocab

    def total_train_steps(self):
        return self.steps

    def train_batch(self, step):
        rng = np.random.default_rng((SEED, self.stream, step))
        B, T, P = self.batch, self.text, len(PREFIX_IDS)
        lens = rng.integers(P + min(8, T - P - 1), T + 1, size=B)
        lens[0] = T
        pad = PAD_ID % self.vocab
        ids = np.full((B, T), pad, np.int32)
        mask = np.zeros((B, T), np.int32)
        labels = np.full((B, T), pad, np.int64)
        for b, n in enumerate(lens):
            row = np.array(PREFIX_IDS + list(rng.integers(0, 128000, size=n - P - 1))
                           + [PAD_ID]) % self.vocab
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


def train_phase(torch, dev, cfg, params, label="stage 1"):
    """Stage-1 training through ProjectorTrainer at full width; returns the
    flash kernels' launch counts of the 10 micro-steps: each kernel once a
    layer and micro-step where the config takes the flash route
    (llama.flash_route), none where it takes `_attention` (gemma)."""
    import types

    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops.cuda import flash_attn as fa
    from dmi_tpu_torch.ops.cuda import projector as pk
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer

    spec = proj.ProjectorSpec(mm_dim=TRAIN_MM_DIM, lm_dim=cfg.hidden_size,
                              dropout=TRAIN_DROPOUT)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(SEED + 4), device=dev)
    data = SyntheticCaptions(TRAIN_STEPS, vocab=cfg.vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(**TRAIN_ARGS, checkpoint_dir=tmp)
        trainer = ProjectorTrainer("smoke", cfg, params, spec, pp, [data],
                                   [EmbeddingManager("smoke-encoder", device=dev)], None, args)
        batches = [(0, data.train_batch(step)) for step in range(TRAIN_STEPS)]

        step0_check(torch, label, lambda plain: trainer.micro_loss(0, batches[0], plain=plain),
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
        print(f"{label} training run: {TRAIN_STEPS} micro-steps at batch {TRAIN_BATCH}, T "
              f"{TRAIN_TEXT + 1}: {secs!r} s, {TRAIN_STEPS / secs!r} micro-steps/s, "
              f"{positions / secs!r} tokens/s (sequence positions); peak device memory "
              f"{peak / 2**30!r} GiB; losses {losses.tolist()}; launches {launches}")
        flash = cfg.num_hidden_layers if llama.flash_route(cfg, TRAIN_TEXT + 1) else 0
        want = flash * TRAIN_STEPS
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
        if not (bool(torch.isfinite(ev)) and ev_launches == (1, flash, 0, 0)):
            raise AssertionError(f"eval loss {ev.item()} with launches {ev_launches}")

        print(f"where one {label} micro-step's time goes:")
        extra = iter(range(TRAIN_STEPS, TRAIN_STEPS + 10))
        profile_run(torch, f"{label} micro-step, batch {TRAIN_BATCH}",
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

    pk.launches = da.launches = da.row_launches = da.pos_launches = l0.launches = 0
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

    return {"mlp2": pk.launches, "decode_attention": da.launches,
            "decode_attention_rows": da.row_launches,
            "decode_attention_pos": da.pos_launches, "lora0": l0.launches,
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
    run's launch counts, the trained hypernet's parameters and (its AdamW
    state, its sched_step)."""
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
    state = (trainer.optimizer_state(), trainer.sched_step)
    del trainer
    return launches, trained, state


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


# ---------------------------------------------------------------------------
# Weights and checkpoints on disk, in the layouts users hold
# ---------------------------------------------------------------------------

# safetensors dtype names (the card's machine has no safetensors package);
# F64 is there for the reader's refusal test
SAFETENSORS_NAMES = {"bfloat16": "BF16", "float16": "F16", "float32": "F32", "float64": "F64"}


def write_safetensors(torch, path, tensors) -> int:
    """Write `tensors` (name -> tensor, on any device) as one safetensors
    file: an 8-byte little-endian header length, a JSON header of dtype,
    shape and [start, end) offsets per tensor, padded with spaces to 8
    bytes, then each tensor's bytes in order.  Returns the bytes written."""
    import struct

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_NAMES[str(t.dtype).removeprefix("torch.")],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(head) + offset


def hf_llama_state_dict(cfg, params) -> dict:
    """The port's Llama parameters (fused or not) under HF LlamaForCausalLM's
    key names, Linear weights in HF's (out, in) layout (transposed views)."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    sd = {"model.embed_tokens.weight": params["embed"]}
    for i, lw in enumerate(params["layers"]):
        wq, wk, wv = (lw["w_qkv"].split([nh * hd, nkv * hd, nkv * hd], dim=-1)
                      if "w_qkv" in lw else (lw["wq"], lw["wk"], lw["wv"]))
        w_gate, w_up = lw["w_gu"].chunk(2, dim=-1) if "w_gu" in lw else (lw["w_gate"], lw["w_up"])
        p = f"model.layers.{i}."
        for name, w in (("self_attn.q_proj", wq), ("self_attn.k_proj", wk),
                        ("self_attn.v_proj", wv), ("self_attn.o_proj", lw["wo"]),
                        ("mlp.gate_proj", w_gate), ("mlp.up_proj", w_up),
                        ("mlp.down_proj", lw["w_down"])):
            sd[f"{p}{name}.weight"] = w.t()
        sd[f"{p}input_layernorm.weight"] = lw["ln_attn"]
        sd[f"{p}post_attention_layernorm.weight"] = lw["ln_mlp"]
    sd["model.norm.weight"] = params["final_norm"]
    return sd


def write_hf_llama(torch, directory, cfg, params, n_shards=2) -> int:
    """A model directory in the HF layout: config.json (model_type llama,
    tied head, llama3 rope scaling when cfg has it) and the weights
    (write_hf_dir).  Returns the bytes written."""
    rope = None if cfg.rope_scaling_factor is None else {
        "rope_type": "llama3", "factor": cfg.rope_scaling_factor,
        "low_freq_factor": cfg.rope_low_freq_factor,
        "high_freq_factor": cfg.rope_high_freq_factor,
        "original_max_position_embeddings": cfg.rope_original_max_position}
    config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "num_key_value_heads": cfg.num_key_value_heads, "head_dim": cfg.head_dim,
              "hidden_act": "silu", "rms_norm_eps": cfg.rms_norm_eps,
              "rope_theta": cfg.rope_theta, "rope_scaling": rope,
              "max_position_embeddings": 131072, "tie_word_embeddings": True,
              "attention_bias": False, "mlp_bias": False, "bos_token_id": cfg.bos_token_id,
              "eos_token_id": list(cfg.eos_token_ids),
              "torch_dtype": str(cfg.dtype).removeprefix("torch.")}
    return write_hf_dir(torch, directory, config, hf_llama_state_dict(cfg, params), n_shards)


def write_hf_dir(torch, directory, config, sd, n_shards=2) -> int:
    """config.json and the state dict `sd` (HF names -> tensors) as `n_shards`
    safetensors shards of about equal size with their
    model.safetensors.index.json.  Returns the bytes written."""
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    total = sum(t.numel() * t.element_size() for t in sd.values())
    shards, size = [{}], 0
    for name, t in sd.items():
        if size >= total * len(shards) / n_shards and len(shards) < n_shards:
            shards.append({})
        shards[-1][name] = t
        size += t.numel() * t.element_size()
    weight_map, written = {}, 0
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        written += write_safetensors(torch, os.path.join(directory, fname), shard)
        weight_map.update({name: fname for name in shard})
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return written


def reference_projector_pt(torch, path, pparams, step=0) -> None:
    """A reference Projector envelope (net.{i}.weight|bias, (out, in)) of the
    port's projector parameters, without optimizer state."""
    from dmi_tpu_torch.models import torch_import as ti
    from dmi_tpu_torch.training.checkpoint import to_numpy

    sd = ti.export_projector_state_dict(to_numpy(pparams))
    torch.save({"step_idx": step,
                "projector_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "optimizer_state_dict": None, "coco_cider": 0.0}, path)


def reference_hypernet_pt(torch, path, hspec, hn_params, frozen, adamw, step) -> None:
    """A reference HyperNetWrapper envelope (hypernet.* with the pos_encs.pe
    buffer, projector.net.*) with torch AdamW state over the hypernet's
    parameters in the state dict's order: the port's AdamW moments
    (`adamw`, training.optim.adamw_state's trees) exported to the
    reference layout."""
    from dmi_tpu_torch.models import torch_import as ti
    from dmi_tpu_torch.training.checkpoint import to_numpy
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    hn_sd = ti.export_hypernet_state_dict(to_numpy(hn_params), hspec)
    names = [k for k in hn_sd if k not in ti._BUFFER_KEYS]
    mu = ti.export_hypernet_state_dict(to_numpy(adamw["exp_avg"]), hspec)
    nu = ti.export_hypernet_state_dict(to_numpy(adamw["exp_avg_sq"]), hspec)
    steps = {float(t) for _, t in named_leaves(adamw["step"])}
    if len(steps) != 1:
        raise AssertionError(f"the stage-2 AdamW steps differ: {steps}")
    opt = ti.export_adamw_state(names, mu, nu, int(steps.pop()), lr=1e-4)
    sd = {**ti._prefixed(hn_sd, "hypernet."),
          **ti._prefixed(ti.export_projector_state_dict(to_numpy(frozen)), "projector.")}
    torch.save({"step_idx": step,
                "hypernet_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "optimizer_state_dict": opt, "loss": 0.0}, path)


def _bit_equal(torch, a, b) -> bool:
    """Two trees of tensors (or numpy arrays) with the same leaves, bit for bit."""
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    la, lb = list(named_leaves(a)), list(named_leaves(b))
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())
        for (_, x), (_, y) in zip(la, lb))


def disk_phase(torch, dev, cfg, params, projector, embs, hn_params, hn_state):
    """The paper's configs as written: the 1B model from an HF-layout
    directory (config.json, two safetensors shards and their index) through
    build_lm, the projector from a reference torch `.pt` through
    load_projector, and a reference hypernet `.pt` with torch AdamW state
    through HypernetTrainer.load_checkpoint (the functions the entry points
    and Captioner.from_checkpoint call).  Each is held bit for bit to the
    in-memory tree it was written from; one batch of 128 greedy captions on
    the batch-last loop and one stage-3 few-shot micro-step over the loaded
    hypernet must equal the in-memory runs, ids, loss and launch counts.
    Returns the launch counts of the runs from disk."""
    import types

    from dmi_tpu_torch.config import LMArgs
    from dmi_tpu_torch.models import hypernet as hn
    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.serve import Captioner
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer
    from dmi_tpu_torch.training.model_utils import build_lm
    from dmi_tpu_torch.training.projector_trainer import load_projector
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    card = nvidia_smi()
    spec, pparams = projector
    hspec = hn.HypnetSpec(**HN_SPEC)
    fs_spec, frozen = frozen_projector(torch, dev)
    adamw, sched_step = hn_state
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lm_dir = os.path.join(tmp, "Llama-3.2-1B-smoke")
        os.makedirs(lm_dir)
        t0 = time.perf_counter()
        lm_bytes = write_hf_llama(torch, lm_dir, cfg, params)
        proj_path, hn_path = os.path.join(tmp, "projector.pt"), os.path.join(tmp, "hypernet.pt")
        reference_projector_pt(torch, proj_path, pparams)
        reference_hypernet_pt(torch, hn_path, hspec, hn_params, frozen, adamw, sched_step)
        write_s = time.perf_counter() - t0
        sizes = {n: os.path.getsize(p) for n, p in (("projector.pt", proj_path),
                                                     ("hypernet.pt", hn_path))}
        print(f"from disk: wrote the 1B tree in the HF layout ({lm_bytes} bytes in "
              f"{sorted(os.listdir(lm_dir))}), {sizes} in {write_s!r} s")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        dcfg, dparams = build_lm(LMArgs(lm_name_or_path=lm_dir, lm_dtype="bfloat16"), None,
                                 device=dev)
        proj_tree = load_projector(proj_path, spec)
        dpp = {"layers": [{n: torch.as_tensor(a, device=dev) for n, a in layer.items()}
                          for layer in proj_tree["layers"]]}
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        read = lm_bytes + sizes["projector.pt"]
        print(f"  loaded the LM and the projector: {read} bytes read in {load_s!r} s, "
              f"{read / load_s / 1e9!r} GB/s; device memory after the load "
              f"{torch.cuda.memory_allocated() / 2**30!r} GiB allocated "
              f"({(torch.cuda.memory_allocated() - base) / 2**30!r} GiB for the loaded tree) "
              f"({card})")
        mem_params = llama.fuse_projections(dparams)
        same = {"config": dcfg == cfg, "LM": _bit_equal(torch, mem_params, params),
                "projector": _bit_equal(torch, dpp, pparams)}
        print(f"  bit-equal to the in-memory trees: {same}")
        if not all(same.values()):
            raise AssertionError(f"the trees read from disk differ: {same}")

        def serve(label, c, p, pp):
            cap = Captioner(c, p, spec, pp, max_new_tokens=MAX_NEW, batch_size=128,
                            prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID)
            torch.cuda.synchronize()
            _reset_counts()
            ids = cap.caption_ids(embs[:128])
            counts = _counts()
            _expect(label, counts, {"mlp2": 1, "decode_attention": L * (MAX_NEW - 1),
                                    "decode_mlp": L * (MAX_NEW - 1),
                                    "head_argmax": MAX_NEW - 1})
            return ids, counts

        L = cfg.num_hidden_layers
        ids_mem, counts_mem = serve("in-memory batch", cfg, params, pparams)
        ids_disk, counts_disk = serve("from-disk batch", dcfg, dparams, dpp)
        identical = torch.equal(ids_mem, ids_disk)
        print(f"  128 greedy captions on the batch-last loop: ids bit-identical {identical}, "
              f"launch counts equal {counts_mem == counts_disk}")
        if not identical or counts_mem != counts_disk:
            raise AssertionError("serving from disk differs from serving from memory")
        out["serving from disk"] = counts_disk
        del dparams, mem_params

        # stage 3 over the hypernet read from its .pt, against the in-memory hypernet
        data = SyntheticCaptions(1, batch=FS_BATCH, text=FS_TEXT, mm=fs_spec.mm_dim,
                                 subset=HN_SUBSET, stream=17)
        mgr = EmbeddingManager("smoke-fewshot-encoder", device=dev)

        def trainer(hparams):
            args = types.SimpleNamespace(**FS_ARGS, checkpoint_dir=tmp)
            return HypernetTrainer(
                "smoke-disk", cfg, params, fs_spec, frozen, hspec, hparams, [], [],
                [data], [mgr], None, args,
                types.SimpleNamespace(**dict(FEWSHOT, finetune_generated_projector=False)))

        t_mem = trainer(hn_params)
        t_disk = trainer(hn.init(hspec, torch.Generator(device=dev).manual_seed(SEED + 99),
                                 device=dev))
        t0 = time.perf_counter()
        step = t_disk.load_checkpoint(hn_path)["step_idx"]
        frozen_disk = load_projector(hn_path, fs_spec)
        torch.cuda.synchronize()
        print(f"  hypernet .pt ({sizes['hypernet.pt']} bytes) read in "
              f"{time.perf_counter() - t0!r} s: step_idx {step}, sched_step "
              f"{t_disk.sched_step} (written {sched_step})")
        moments = {key: [t_disk.opt.state[leaf][key] for _, leaf in named_leaves(t_disk.params)]
                   for key in ("exp_avg", "exp_avg_sq", "step")}
        same = {"hypernet": _bit_equal(torch, t_disk.params, hn_params),
                "frozen projector": _bit_equal(torch, frozen_disk, frozen),
                "AdamW moments": all(
                    torch.equal(m, w) for key in ("exp_avg", "exp_avg_sq")
                    for m, (_, w) in zip(moments[key], named_leaves(adamw[key]))),
                "AdamW steps": all(torch.equal(m, w.float().cpu()) for m, (_, w) in
                                   zip(moments["step"], named_leaves(adamw["step"]))),
                "sched_step": t_disk.sched_step == sched_step == step}
        print(f"  bit-equal to the stage-2 trainer's state: {same}")
        if not all(same.values()):
            raise AssertionError(f"the hypernet .pt read back differs: {same}")

        losses, counts = {}, {}
        for label, t in (("in-memory", t_mem), ("from-disk", t_disk)):
            t.fewshot_generate_adapters(0)
            opt = t.fewshot_optimizer()
            _reset_counts()
            loss, _ = t.fewshot_train_step(0, 1, data.train_batch(0), data.subset_batch(0),
                                           mgr, opt)
            torch.cuda.synchronize()
            losses[label], counts[label] = loss.item(), _counts()
            _expect(f"stage-3 step 0 over the {label} hypernet", counts[label],
                    {"lora0": 1, "flash_fwd": L, "flash_bwd_dkv": L, "flash_bwd_dq": L})
        after = _bit_equal(torch, t_disk.params, t_mem.params)
        print(f"  stage-3 step 0 over the hypernet: losses {losses}, equal "
              f"{losses['in-memory'] == losses['from-disk']}; hypernets after the update "
              f"bit-equal {after}")
        if losses["in-memory"] != losses["from-disk"] or not after:
            raise AssertionError("stage 3 from the hypernet .pt differs from the in-memory run")
        out["stage 3 from disk"] = counts["from-disk"]
        del t_mem, t_disk
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Gemma-2-2B: the dense decoder families
# ---------------------------------------------------------------------------

# google/gemma-2-2b's published config.json; its weights are not in the
# repository, so the phase writes random bf16 ones in the gemma2 HF layout
GEMMA2_2B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "vocab_size": 256000,
    "hidden_size": 2304, "intermediate_size": 9216, "num_hidden_layers": 26,
    "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 256,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
    "tie_word_embeddings": True, "max_position_embeddings": 8192, "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
    "initializer_range": 0.02, "cache_implementation": "hybrid", "torch_dtype": "bfloat16",
}
GEMMA_WINDOW = 16  # the window phase's: binds from position 16 of T 16 + the budget
GEMMA_PATH = "Gemma-2-2B serving batch-last"


def hf_gemma2_state_dict(torch, dev, c, seed) -> dict:
    """Random bf16 weights of a gemma2 config under HF Gemma2ForCausalLM's
    names and (out, in) layout, on `dev`: Linear weights and the embedding
    normal(0, 0.02) (the config's initializer_range); gemma stores w of its
    (1 + w) norm scale, normal(0, 0.1) for the pre-norms and the final norm
    and normal(3, 0.1) for the two post-block norms.  With post-block
    scales near 1, a random model's residual stream is dominated by the
    input embedding times sqrt(H), and the tied head echoes it: every step
    repeats its input token, in every row.  Scales near 4 let the
    sublayers set the greedy tokens, so that rows, windows and engines can
    be told apart by their ids."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    nh, nkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]

    def w(*shape, scale=0.02, mean=0.0):
        return (mean + torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    sd = {"model.embed_tokens.weight": w(V, H)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (nh * hd, H)),
                            ("self_attn.k_proj", (nkv * hd, H)),
                            ("self_attn.v_proj", (nkv * hd, H)),
                            ("self_attn.o_proj", (H, nh * hd)), ("mlp.gate_proj", (I, H)),
                            ("mlp.up_proj", (I, H)), ("mlp.down_proj", (H, I))):
            sd[f"{p}{name}.weight"] = w(*shape)
        for norm in ("input_layernorm", "pre_feedforward_layernorm"):
            sd[f"{p}{norm}.weight"] = w(H, scale=0.1)
        for norm in ("post_attention_layernorm", "post_feedforward_layernorm"):
            sd[f"{p}{norm}.weight"] = w(H, scale=0.1, mean=3.0)
    sd["model.norm.weight"] = w(H, scale=0.1)
    return sd


def gemma_load_phase(torch, dev):
    """Gemma-2-2B at full width and depth from disk: GEMMA2_2B and random
    bf16 weights written as an HF gemma2 directory (three safetensors
    shards), read back through build_lm, held to the published config and
    bit for bit to what was written (Linear weights transposed, every norm
    folded to f32(w) + 1), and removed.  Returns the config and the
    parameters."""
    from dmi_tpu_torch.config import LMArgs
    from dmi_tpu_torch.training.model_utils import build_lm

    c = GEMMA2_2B
    sd = hf_gemma2_state_dict(torch, dev, c, SEED + 20)
    with tempfile.TemporaryDirectory() as tmp:
        lm_dir = os.path.join(tmp, "gemma-2-2b-smoke")
        os.makedirs(lm_dir)
        t0 = time.perf_counter()
        written = write_hf_dir(torch, lm_dir, c, sd, n_shards=3)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cfg, params = build_lm(LMArgs(lm_name_or_path=lm_dir, lm_dtype="bfloat16"), None,
                               device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"Gemma-2-2B from disk: wrote {written} bytes ({sorted(os.listdir(lm_dir))}) in "
              f"{write_s!r} s; build_lm read them in {load_s!r} s ({written / load_s / 1e9!r} "
              f"GB/s), {(torch.cuda.memory_allocated() - base) / 2**30!r} GiB on the card")
    want = {k: c[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                              "num_hidden_layers", "num_attention_heads",
                              "num_key_value_heads", "head_dim", "rms_norm_eps", "rope_theta",
                              "sliding_window", "tie_word_embeddings")}
    want.update(mlp_act="gelu_tanh", attn_scale=c["query_pre_attn_scalar"] ** -0.5,
                attn_logit_softcap=c["attn_logit_softcapping"],
                final_logit_softcap=c["final_logit_softcapping"],
                embedding_normalizer=c["hidden_size"] ** 0.5, post_block_norms=True,
                norm_plus_one=True, eos_token_ids=(c["eos_token_id"],), dtype=torch.bfloat16,
                layer_sliding=tuple(i % 2 == 0 for i in range(c["num_hidden_layers"])))
    _config_of("Gemma-2-2B", cfg, want)
    _held_to_hf(torch, "Gemma-2-2B (norms folded in f32)", cfg, params, sd)
    del sd
    torch.cuda.empty_cache()
    return cfg, params


def gemma_kernel_phase(torch, dev, cfg, params):
    """The serving kernels at Gemma-2-2B's shapes, B 128, each against its
    twin and timed beside its bound and library call: decode attention (8/4
    heads, hd 256 on the CUDA-core instance, its score scale and softcap 50,
    S 38 = T 16 + budget 22; a zero row, a window row, and a binding cap of
    2.0), the tanh-GELU decode MLP on layer 0's weights (H 2304, I 9216),
    the head argmax over the model's embed (V 256000) and mlp2 (f32, 1024
    -> 2304 -> 2304)."""
    import torch.nn.functional as F

    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops import l2_normalize
    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.ops.cuda import head_argmax as tha
    from dmi_tpu_torch.ops.cuda import projector as pk

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    B, S = 128, len(PREFIX_IDS) + 1 + MAX_NEW
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    scale, cap = llama.attn_score_scale(cfg), cfg.attn_logit_softcap
    bf = torch.bfloat16
    results = {}
    print(f"Gemma-2-2B's serving kernels vs their twins (B {B}):")

    q = torch.randn(B, nh, 1, hd, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(B, nkv, S, hd, generator=gen, device=dev).to(bf) for _ in range(2))
    zero = torch.zeros(S, device=dev)
    window = torch.where(llama.window_mask(dataclasses.replace(cfg, sliding_window=GEMMA_WINDOW),
                                           S - 1, torch.arange(S, device=dev)),
                         0.0, torch.finfo(torch.float32).min)
    errs = []
    for label, bias, c in (("zero row", zero, cap), (f"window row of {GEMMA_WINDOW}", window, cap),
                           ("zero row, a binding cap of 2.0", zero, 2.0)):
        args = (q, k, v, bias, scale, c)
        ref = da._decode_attn_plain(*args)
        errs.append(compare(torch, f"decode attention S={S} hd={hd} softcap={c} ({label})",
                            da.fused_decode_attention(*args), ref, TOL["bfloat16"]))
        if c == 2.0:
            move = (ref.float() - da._decode_attn_plain(*args[:5]).float()).abs().max().item()
            if move <= TOL["bfloat16"] * max(1.0, ref.float().abs().max().item()):
                raise AssertionError("the cap of 2.0 does not bind at hd 256")
    args = (q, k, v, zero, scale, cap)
    t = {**device_times(torch, lambda: da.fused_decode_attention(*args),
                        lambda: da._decode_attn_plain(*args),
                        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale,
                                                               enable_gqa=True)),
         **least_time(nbytes(q, k, v, zero, q), 4 * B * nh * S * hd, bf)}
    print(f"    {report_times(t)}; library: scaled_dot_product_attention, GQA, without the "
          f"softcap (SDPA has none); plan {da.plan(B, nkv, nh // nkv, S, hd, 2)}")
    results["decode_attention_gemma"] = {"max_abs_err": max(errs), **t}

    lw = params["layers"][0]
    h = torch.randn(H, B, generator=gen, device=dev).to(bf)
    args = (lw["w_gu"], lw["w_down"], h, cfg.mlp_act)
    err = compare(torch, f"decode MLP H={H} I={I} {cfg.mlp_act} (layer 0's weights)",
                  dm.fused_decode_mlp_bl(*args), dm._decode_mlp_plain(*args), TOL["bfloat16"])

    def chain():
        g, u = (lw["w_gu"].t() @ h).chunk(2, dim=0)
        return lw["w_down"].t() @ (F.gelu(g, approximate="tanh") * u)

    t = {**device_times(torch, lambda: dm.fused_decode_mlp_bl(*args),
                        lambda: dm._decode_mlp_plain(*args), chain),
         **least_time(nbytes(lw["w_gu"], lw["w_down"], h, h), 2 * B * 3 * H * I, bf)}
    print(f"    {report_times(t)}; library: matmul, gelu * mul, matmul; plan "
          f"{dm.plan(H, I, dm.padded_batch(B))}")
    results["decode_mlp_gemma"] = {"max_abs_err": err, **t}

    head = {"embed": params["embed"]}
    h = torch.randn(H, B, generator=gen, device=dev).to(bf)
    gap = head_check(torch, tha, f"head argmax bf16 V={V} H={H}", head, h, "bf16")
    t = {**device_times(torch, lambda: tha.head_argmax(head, h),
                        lambda: tha._head_argmax_plain(head["embed"], h),
                        lambda: (head["embed"] @ h).argmax(dim=0)),
         **least_time(nbytes(head["embed"], h) + 4 * B, 2 * V * H * B, bf)}
    plan = {k: v for k, v in tha.plan(V, H, B, "bf16").items() if k != "runs"}
    print(f"    {report_times(t)}; library: matmul, argmax; plan {plan}")
    results["head_argmax_gemma"] = {"max_abs_err": gap, **t}

    spec = proj.ProjectorSpec(mm_dim=MM_DIM, lm_dim=H)
    p = proj.init(spec, gen, dtype=torch.float32, device=dev)["layers"]
    x = l2_normalize(torch.randn(B, MM_DIM, generator=gen, device=dev))
    args = (x, p[0]["w"], p[0]["b"], p[1]["w"], p[1]["b"])
    err = compare(torch, f"mlp2 B={B} {MM_DIM} -> {H} -> {H} float32", pk.fused_mlp2(*args),
                  pk._mlp2_plain(*args), TOL["float32"])
    x, w0, b0, w1, b1 = args
    t = {**device_times(torch, lambda: pk.fused_mlp2(*args), lambda: pk._mlp2_plain(*args),
                        lambda: torch.addmm(b1, F.gelu(torch.addmm(b0, x, w0),
                                                       approximate="tanh"), w1)),
         **least_time(nbytes(*args) + B * H * 4, 2 * B * (w0.numel() + w1.numel()),
                      torch.float32)}
    print(f"    {report_times(t)}; library: addmm, gelu, addmm")
    results["mlp2_gemma"] = {"max_abs_err": err, **t}
    return results


def gemma_window_phase(torch, dev, cfg, params, projector, embs):
    """A window that binds on the card: Gemma-2-2B's widths at its first two
    layers (sliding, then full) with sliding_window 16, so that the window
    binds from position 16 of T 16 + 22.  One batch of 128 greedy captions
    on the batch-last loop against its plain path and the bulk engine
    against the batch engine, with launch counts; the same requests with
    the window dropped give other ids."""
    from dmi_tpu_torch.serve import Captioner

    spec, pp = projector
    c = dataclasses.replace(cfg, num_hidden_layers=2, sliding_window=GEMMA_WINDOW,
                            layer_sliding=(True, False))
    p2 = {**params, "layers": params["layers"][:2]}
    steps = MAX_NEW - 1

    def captioner(c):
        return Captioner(c, p2, spec, pp, max_new_tokens=MAX_NEW, batch_size=128,
                         prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID)

    cap = captioner(c)
    requests = embs[:128]
    cap.caption_ids(requests)  # warm-up
    _reset_counts()
    ids = cap.caption_ids(requests)
    counts = _counts()
    print(f"Gemma-2-2B widths, 2 layers, sliding_window {GEMMA_WINDOW} (binds from position "
          f"{GEMMA_WINDOW} of {len(PREFIX_IDS) + 1} + {MAX_NEW}):")
    _expect("window, batch-last", counts, {"mlp2": 1, "decode_attention": 2 * steps,
                                           "decode_mlp": 2 * steps, "head_argmax": steps})
    _check_ids(c, "window, batch-last", ids, 128)
    token_agreement("its plain path", ids, cap.caption_ids(requests, plain=True))
    _reset_counts()
    bulk = cap.caption_ids(requests, engine="bulk")
    eng = cap.bulk_engine
    _expect("window, bulk", _counts(), {"mlp2": eng.admissions,
                                        "decode_attention": 2 * eng.steps,
                                        "decode_attention_rows": 2 * eng.steps,
                                        "decode_mlp": 2 * eng.steps, "head_argmax": eng.steps})
    token_agreement("the batch engine", bulk, ids)
    wide = captioner(dataclasses.replace(c, sliding_window=None)).caption_ids(requests)
    share = (wide == ids).float().mean().item()
    print(f"  token agreement with the window dropped: {share!r} (the window binds: < 1)")
    if share == 1.0:
        raise AssertionError("the window of 16 moved no token")
    return {"Gemma-2-2B window": counts}


def gemma_phase(torch, dev):
    """Every Gemma-2-2B phase; returns its kernels' entries and its paths'
    launch counts."""
    from dmi_tpu_torch.models import llama

    cfg, params = gemma_load_phase(torch, dev)
    # EOS off, as the Llama phases have it; the fused layout the Captioner
    # would make, once
    cfg = dataclasses.replace(cfg, eos_token_ids=())
    params = llama.fuse_projections(params)
    torch.cuda.empty_cache()
    kernels = gemma_kernel_phase(torch, dev, cfg, params)
    paths, projector, embs = family_serving_phase(torch, dev, "Gemma-2-2B", cfg, params,
                                                  SEED + 22)
    paths["Gemma-2-2B stage 1"] = train_phase(torch, dev, cfg, params, label="Gemma-2-2B stage 1")
    paths.update(gemma_window_phase(torch, dev, cfg, params, projector, embs))
    del params
    torch.cuda.empty_cache()
    return kernels, paths


# ---------------------------------------------------------------------------
# The MoE and MLA families: OLMoE-1B-7B and DeepSeek-V2-Lite's widths
# ---------------------------------------------------------------------------

# allenai/OLMoE-1B-7B-0924's published config.json: every layer sparse,
# clip_qkv null, an untied head
OLMOE_1B_7B = {
    "architectures": ["OlmoeForCausalLM"], "model_type": "olmoe", "vocab_size": 50304,
    "hidden_size": 2048, "intermediate_size": 1024, "num_hidden_layers": 16,
    "num_attention_heads": 16, "num_key_value_heads": 16, "num_experts": 64,
    "num_experts_per_tok": 8, "norm_topk_prob": False, "clip_qkv": None,
    "attention_bias": False, "attention_dropout": 0.0, "hidden_act": "silu",
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "rope_scaling": None,
    "max_position_embeddings": 4096, "tie_word_embeddings": False, "eos_token_id": 50279,
    "pad_token_id": 1, "bos_token_id": None, "initializer_range": 0.02,
    "output_router_logits": False, "router_aux_loss_coef": 0.01, "torch_dtype": "bfloat16",
}
OLMOE = "OLMoE-1B-7B"
# deepseek-ai/DeepSeek-V2-Lite's published config.json, cut to 4 of its 27
# layers, all sparse (first_k_dense_replace 0: its 1 makes a mixed stack,
# which dmi_tpu refuses)
V2_LITE = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 4, "first_k_dense_replace": 0,
    "num_attention_heads": 16, "num_key_value_heads": 16, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
    "routed_scaling_factor": 1.0, "topk_method": "greedy", "n_group": 1, "topk_group": 1,
    "norm_topk_prob": False, "scoring_func": "softmax", "moe_layer_freq": 1,
    "aux_loss_alpha": 0.001, "seq_aux": True, "attention_bias": False,
    "attention_dropout": 0.0, "hidden_act": "silu", "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                                          "mscale": 0.707, "mscale_all_dim": 0.707,
                                          "original_max_position_embeddings": 4096,
                                          "type": "yarn"},
    "max_position_embeddings": 163840, "tie_word_embeddings": False, "bos_token_id": 100000,
    "eos_token_id": 100001, "initializer_range": 0.02, "pretraining_tp": 1,
    "torch_dtype": "bfloat16",
}
V2 = "V2-Lite widths"


def hf_state_dict_of(torch, dev, cfg, seed) -> dict:
    """Random bf16 weights of the port's config `cfg` under the HF names and
    (out, in) layout the loader reads (llama.hf_layer_keys: MLA, experts one
    by one), on `dev`: every Linear weight and the embedding normal(0,
    0.02), the config's initializer_range, drawn by llama.init from a
    generator seeded with `seed`; RMSNorm scales 1 + normal(0, 0.1).  At
    these widths the sublayers' outputs outweigh the embedding in the
    residual stream, so that rows and experts can be told apart."""
    from dmi_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = llama.init(cfg, gen, dev)
    sd = {"model.embed_tokens.weight": params.pop("embed"),
          "lm_head.weight": params.pop("lm_head").t().contiguous(),
          "model.norm.weight": params.pop("final_norm")}
    keys = llama.hf_layer_keys(cfg, False)
    for i, lw in enumerate(params.pop("layers")):
        for name, (key, kind) in keys.items():
            t = lw.pop(name)
            if kind == "x":
                for e in range(t.shape[0]):
                    sd[f"model.layers.{i}.{key.format(e=e)}"] = t[e].t().contiguous()
            elif kind == "n":
                sd[f"model.layers.{i}.{key}"] = t
            else:
                sd[f"model.layers.{i}.{key}"] = t.t().contiguous()
            del t
    for key, t in sd.items():
        if key.endswith("norm.weight"):
            t.add_(torch.randn(t.shape, generator=gen, device=dev).mul_(0.1).to(t.dtype))
    return sd


def _held_to_hf(torch, label, cfg, params, sd) -> None:
    """Every parameter the loader made equal to the HF tensor it read
    (Linear weights transposed, expert stacks [E, in, out], gemma's norms
    folded to f32(w) + 1)."""
    from dmi_tpu_torch.models import llama

    def norm(t):
        return t.float() + 1 if cfg.norm_plus_one else t

    same = torch.equal(params["embed"], sd["model.embed_tokens.weight"])
    same &= torch.equal(params["final_norm"], norm(sd["model.norm.weight"]))
    if not cfg.tie_word_embeddings:
        same &= torch.equal(params["lm_head"], sd["lm_head.weight"].t())
    for i, lw in enumerate(params["layers"]):
        for name, (key, kind) in llama.hf_layer_keys(cfg, False).items():
            if kind == "x":
                ref = torch.stack([sd[f"model.layers.{i}.{key.format(e=e)}"].t()
                                   for e in range(cfg.num_experts)])
            else:
                t = sd[f"model.layers.{i}.{key}"]
                ref = t.t() if kind == "w" else norm(t) if kind == "n" else t
            same &= lw[name].dtype == ref.dtype and torch.equal(lw[name], ref)
    print(f"  {label}: every tensor equal to the HF one it was read from: {same}")
    if not same:
        raise AssertionError(f"{label}: a loaded tensor differs from the HF one")


def _config_of(label, cfg, want) -> None:
    got = {k: getattr(cfg, k) for k in want}
    print(f"  {label} config: {got}")
    if got != want:
        raise AssertionError(f"{label}: config {got} != the published {want}")


def olmoe_load_phase(torch, dev):
    """OLMoE-1B-7B at full width and depth, in memory: OLMOE_1B_7B through
    the loader's _hf_to_config, random bf16 weights under the olmoe HF names
    through from_hf_state_dict (13.8 GB: a directory this size would cost the
    smoke more disk and time than it has), held to the published config and
    to every HF tensor.  Returns the config and the parameters."""
    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.training.model_utils import _hf_to_config

    c = OLMOE_1B_7B
    cfg = _hf_to_config(c, torch.bfloat16, None)
    _config_of(OLMOE, cfg, {
        "vocab_size": 50304, "hidden_size": 2048, "intermediate_size": 1024,
        "num_hidden_layers": 16, "num_attention_heads": 16, "num_key_value_heads": 16,
        "head_dim": 128, "num_experts": 64, "num_experts_per_tok": 8, "moe_norm_topk": False,
        "qk_norm_wide": True, "tie_word_embeddings": False, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "eos_token_ids": (50279,)})
    t0 = time.perf_counter()
    sd = hf_state_dict_of(torch, dev, cfg, SEED + 30)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    n = sum(t.numel() for t in sd.values())
    t0 = time.perf_counter()
    params = llama.from_hf_state_dict(sd, cfg, dev)
    torch.cuda.synchronize()
    print(f"{OLMOE} in memory: {n} parameters, {2 * n} bytes of bf16 in {len(sd)} HF tensors "
          f"made in {made_s!r} s, read by from_hf_state_dict in {time.perf_counter() - t0!r} s")
    _held_to_hf(torch, OLMOE, cfg, params, sd)
    del sd
    torch.cuda.empty_cache()
    return cfg, params


def v2lite_load_phase(torch, dev):
    """DeepSeek-V2-Lite's widths, 4 layers, from disk: V2_LITE and random
    bf16 weights written as an HF deepseek_v2 directory (three safetensors
    shards), read back through build_lm, held to the published config
    (yarn, MLA widths, the deepseek MoE) and bit for bit to what was
    written, and removed.  Returns the config and the parameters."""
    from dmi_tpu_torch.config import LMArgs
    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.training.model_utils import _hf_to_config, build_lm

    c = V2_LITE
    want = {"vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 1408,
            "num_hidden_layers": 4, "num_attention_heads": 16, "num_key_value_heads": 16,
            "head_dim": 192, "q_lora_rank": None, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
            "qk_rope_head_dim": 64, "v_head_dim": 128, "rope_interleaved": True,
            "num_experts": 64, "num_experts_per_tok": 6, "n_shared_experts": 2,
            "routed_scaling_factor": 1.0, "moe_norm_topk": False, "moe_gate_fp32": True,
            "rope_yarn_factor": 40.0, "rope_original_max_position": 4096,
            "rope_yarn_mscale": 0.707, "rope_yarn_mscale_all_dim": 0.707,
            "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "eos_token_ids": (100001,)}
    sd = hf_state_dict_of(torch, dev, _hf_to_config(c, torch.bfloat16, None), SEED + 40)
    with tempfile.TemporaryDirectory() as tmp:
        lm_dir = os.path.join(tmp, "deepseek-v2-lite-4-layers-smoke")
        os.makedirs(lm_dir)
        t0 = time.perf_counter()
        written = write_hf_dir(torch, lm_dir, c, sd, n_shards=3)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cfg, params = build_lm(LMArgs(lm_name_or_path=lm_dir, lm_dtype="bfloat16"), None,
                               device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"{V2} (4 layers) from disk: wrote {written} bytes ({sorted(os.listdir(lm_dir))}) "
              f"in {write_s!r} s; build_lm read them in {load_s!r} s "
              f"({written / load_s / 1e9!r} GB/s), "
              f"{(torch.cuda.memory_allocated() - base) / 2**30!r} GiB on the card")
    _config_of(V2, cfg, want)
    print(f"  yarn attention factor {llama.rope_attention_factor(cfg)!r}, rope over "
          f"{llama.rope_dim(cfg)} dims")
    _held_to_hf(torch, V2, cfg, params, sd)
    del sd
    torch.cuda.empty_cache()
    return cfg, params


def routing_check(torch, dev, label, cfg, params) -> None:
    """Which experts one batch's prefill routes to (llama.moe_gate_weights
    watched), over 128 prompts of 16 random tokens (the serving prompts
    share their chat prefix and differ in the soft token alone): every
    expert of every layer is chosen at least once, and the tokens' top-k
    sets are many."""
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    ids = torch.randint(0, cfg.vocab_size, (128, len(PREFIX_IDS) + 1), generator=gen,
                        device=dev)
    picks, real = [], llama.moe_gate_weights

    def watched(c, logits):
        w = real(c, logits)
        picks.append((w > 0).reshape(-1, w.shape[-1]))
        return w

    llama.moe_gate_weights = watched
    try:
        with torch.no_grad():
            dec._prefill_caches(cfg, params, llama.embed_tokens(cfg, params, ids), ids.shape[1])
    finally:
        llama.moe_gate_weights = real
    used = [int(p.any(0).sum()) for p in picks]
    sets = [int(torch.unique(p, dim=0).shape[0]) for p in picks]
    k = {int(n) for p in picks for n in p.sum(-1).unique().tolist()}
    print(f"  {label} routing in one prefill of {ids.shape[0]} x {ids.shape[1]} random tokens: "
          f"experts chosen per layer {used} of {cfg.num_experts}; distinct top-"
          f"{cfg.num_experts_per_tok} sets per layer {sets} of {ids.numel()} tokens; experts "
          f"a token {k}")
    if len(picks) != cfg.num_hidden_layers or k != {cfg.num_experts_per_tok}:
        raise AssertionError(f"{label}: {len(picks)} gates, {k} experts a token")
    if min(used) < cfg.num_experts or min(sets) < ids.numel() // 4:
        raise AssertionError(f"{label}: routing is degenerate ({used}, {sets})")


def moe_mla_kernel_phase(torch, dev, label, cfg, params):
    """The kernels at the shapes a model gives them, B 128, each against its
    twin and timed beside its bound and library call (OLMoE: decode
    attention at group 1, with an [S] and a [B, S] bias, the untied head's
    argmax, the flash kernels at 16/16 heads, hd 128, B 32, T 65, W4A8 at
    w_qkv and wo; V2-Lite: the untied head's argmax at V 102400), and the
    torch-op blocks of a layer-step: the routed MLP beside its bytes bound
    (MLA: also the absorbed attention over a latent cache of S 38)."""
    import torch.nn.functional as F

    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import llama, quant
    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import flash_attn as fa
    from dmi_tpu_torch.ops.cuda import head_argmax as tha
    from dmi_tpu_torch.ops.cuda import w4_matmul as w4

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    B, S = 128, len(PREFIX_IDS) + 1 + MAX_NEW
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    bf = torch.bfloat16
    tag = "olmoe" if label == OLMOE else "v2lite"
    results = {}
    print(f"{label}'s kernels vs their twins (B {B}):")
    h = torch.randn(H, B, generator=gen, device=dev).to(bf)

    head = dec.fused_head_weights(cfg, params)
    gap = head_check(torch, tha, f"head argmax bf16 V={V} H={H} (the untied lm_head's rows)",
                     head, h, "bf16")
    t = {**device_times(torch, lambda: tha.head_argmax(head, h),
                        lambda: tha._head_argmax_plain(head["embed"], h),
                        lambda: (params["lm_head"].t() @ h).argmax(dim=0)),
         **least_time(nbytes(head["embed"], h) + 4 * B, 2 * V * H * B, bf)}
    plan = {k: v for k, v in tha.plan(V, H, B, "bf16").items() if k != "runs"}
    print(f"    {report_times(t)}; library: lm_head.t() @ h, argmax (the logits path); "
          f"the rows' copy {device_ms(lambda: params['lm_head'].t().contiguous()) * 1e3!r} us "
          f"once a call; plan {plan}")
    results[f"head_argmax_{tag}"] = {"max_abs_err": gap, **t}

    if cfg.kv_lora_rank is None:
        scale = llama.attn_score_scale(cfg)
        q = torch.randn(B, nh, 1, hd, generator=gen, device=dev).to(bf)
        k, v = (torch.randn(B, nkv, S, hd, generator=gen, device=dev).to(bf) for _ in range(2))
        fmin = torch.finfo(torch.float32).min
        rows = torch.full((B, S), fmin, device=dev)
        rng = np.random.default_rng(SEED + 31)
        T, budget = len(PREFIX_IDS) + 1, MAX_NEW
        for b in range(1, B):  # ring masks; row 0 a slot never used
            rows[b, :T] = 0.0
            start, n = int(rng.integers(budget)), int(rng.integers(1, budget + 1))
            rows[b, T + (start + torch.arange(n, device=dev)) % budget] = 0.0
        for key, bias, lib_mask in (("decode_attention", torch.zeros(S, device=dev), None),
                                    ("decode_attention_rows", rows,
                                     rows.view(B, 1, 1, S).to(bf))):
            args = (q, k, v, bias, scale, None)
            name = (f"decode attention {nh}/{nkv} heads (group {nh // nkv}) hd {hd} S {S} "
                    f"{'[S]' if bias.ndim == 1 else '[B, S] ring'} bias")
            err = compare(torch, name, da.fused_decode_attention(*args),
                          da._decode_attn_plain(*args), TOL["bfloat16"])
            t = {**device_times(torch, lambda: da.fused_decode_attention(*args),
                                lambda: da._decode_attn_plain(*args),
                                lambda m=lib_mask: F.scaled_dot_product_attention(
                                    q, k, v, attn_mask=m, scale=scale)),
                 **least_time(nbytes(q, k, v, bias, q), 4 * B * nh * S * hd, bf)}
            print(f"    {report_times(t)}; library: scaled_dot_product_attention (MHA); plan "
                  f"{da.plan(B, nkv, nh // nkv, S, hd, 2)}")
            results[f"{key}_{tag}"] = {"max_abs_err": err, **t}

        Tt = TRAIN_TEXT + 1
        q, k, v = (torch.randn(TRAIN_BATCH, Tt, n, hd, generator=gen, device=dev).to(bf)
                   .transpose(1, 2).requires_grad_() for n in (nh, nkv, nkv))
        do = torch.randn(TRAIN_BATCH, nh, Tt, hd, generator=gen, device=dev).to(bf)
        out, ref = fa.flash_attention(q, k, v, None, 0.125), fa._flash_attn_plain(q, k, v, None,
                                                                                   0.125)
        got, want = (torch.autograd.grad(o, (q, k, v), do) for o in (out, ref))
        name = f"flash B={TRAIN_BATCH} T={Tt} {nh}/{nkv} heads hd {hd} bf16"
        errs = {"flash_fwd": compare(torch, f"{name} out", out.detach(), ref.detach(),
                                     TOL["bfloat16"]),
                "flash_bwd_dq": compare(torch, f"{name} dq", got[0], want[0],
                                        GRAD_TOL["bfloat16"]),
                "flash_bwd_dkv": max(compare(torch, f"{name} dk", got[1], want[1],
                                             GRAD_TOL["bfloat16"]),
                                     compare(torch, f"{name} dv", got[2], want[2],
                                             GRAD_TOL["bfloat16"]))}
        t = flash_timings(torch, fa, *(x.detach() for x in (q, k, v)), do)
        for key, kt in t.items():
            print(f"    {key} {name}: {report_times(kt)}; library: scaled_dot_product_attention, "
                  "causal (backward: its forward+backward less its forward)")
            results[f"{key}_{tag}"] = {"max_abs_err": errs[key], **kt}

        lw = params["layers"][0]
        times = {}
        for wname in ("w_qkv", "wo"):
            wq = quant.quantize_tensor_int4(lw[wname])
            K, n_out = lw[wname].shape
            hq, a = quant.quantize_act(torch.randn(K, B, generator=gen, device=dev), axis=0)
            got = w4.w4_mm_bl(wq, hq, a, bf)
            torch.cuda.synchronize()
            if not torch.equal(got, w4._w4_mm_plain(wq, hq, a, bf)):
                raise AssertionError(f"w4 {wname} K={K} out={n_out}: differs from its twin")
            hq_t = hq.t().contiguous()
            t = {**device_times(torch, lambda: w4.w4_mm_bl(wq, hq, a, bf),
                                lambda: w4._w4_mm_plain(wq, hq, a, bf),
                                lambda: (torch._int_mm(hq_t, quant.unpack_w4(wq["qp"])).t()
                                         .float() * wq["s"].reshape(-1, 1) * a).to(bf)),
                 **least_time(nbytes(wq["qp"], wq["s"], hq, a) + n_out * B * 2,
                              2 * K * n_out * B, torch.int8)}
            print(f"    w4a8 {wname} K={K} out={n_out} B={B}: bit-equal to its twin; "
                  f"{report_times(t)}; library: unpack, torch._int_mm, rescale")
            times[wname] = t
        results[f"w4_mm_{tag}"] = {"max_abs_err": 0.0, **times["w_qkv"],
                                   "by_shape": {n: {k: v for k, v in t.items()}
                                                for n, t in times.items()}}

    lw = params["layers"][0]
    hn = torch.randn(H, B, generator=gen, device=dev).to(bf)
    E, I = cfg.num_experts, cfg.intermediate_size
    with torch.no_grad():
        moe_ms = device_ms(lambda: dec._moe_mlp_bl(cfg, lw, hn))
    stacks = nbytes(lw["moe_w1"], lw["moe_w3"], lw["moe_w2"], lw["w_router"], hn, hn)
    shared = sum(nbytes(lw[k]) for k in ("w_shared_gate", "w_shared_up", "w_shared_down")
                 if k in lw)
    bound = least_time(stacks + shared, 2 * B * 3 * H * I * (E + cfg.n_shared_experts), bf)
    print(f"  {label} routed MLP (dense-evaluated, torch ops) per layer-step at B {B}: "
          f"{moe_ms * 1e3!r} us, bound {bound['bound_ms'] * 1e3!r} us ({bound['bound_by']}: "
          f"{(stacks + shared) / 1e9!r} GB of experts); x {L} layers "
          f"{moe_ms * L!r} ms a step")
    if cfg.kv_lora_rank is not None:
        latent = torch.randn(B, S, cfg.kv_lora_rank + cfg.qk_rope_head_dim, generator=gen,
                             device=dev).to(bf)
        cos, sin = llama.rope_tables(cfg, torch.tensor(S - 1, device=dev))
        zero = torch.zeros(S, device=dev)
        with torch.no_grad():
            mla_ms = device_ms(lambda: dec._mla_attn_bl(cfg, lw, hn, latent, S - 1, S, zero,
                                                        cos, sin))
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
        # the projections, the absorption into q and out, and the two
        # products over the cache
        macs = B * (H * nh * (dn + dr) + H * (r + dr) + nh * dn * r + nh * r * dv
                    + S * nh * (2 * r + dr))
        mla_bound = least_time(nbytes(latent, lw["wq"], lw["wkv_a"], lw["wkv_b"], hn)
                               + 2 * nh * dv * B, 2 * macs, bf)
        print(f"  {label} absorbed MLA attention (torch ops, latent cache [B, S {S}, "
              f"{latent.shape[-1]}]) per layer-step at B {B}: {mla_ms * 1e3!r} us, bound "
              f"{mla_bound['bound_ms'] * 1e3!r} us ({mla_bound['bound_by']})")
    return results


def prompt_ids(cfg):
    """The chat prefix and pad id of a model whose vocabulary is smaller than
    Llama-3's: PREFIX_IDS and PAD_ID modulo its vocab_size."""
    return [t % cfg.vocab_size for t in PREFIX_IDS], PAD_ID % cfg.vocab_size


def family_serving_phase(torch, dev, label, cfg, params, seed, w4a8=False):
    """A model served through the Captioner: the 300 requests at batch 128
    on the batch-last loop (bf16, greedy, EOS off) against its plain path,
    then one batch on the batch-first loop, one sampled batch (SAMPLE)
    against its plain path, the bulk engine beside the batch engine on EOS
    ids chosen mid-budget and, with w4a8, one int8="w4a8" batch against its
    plain path; launch counts set to 0 before each run and checked after:
    decode attention on every layer-step but MLA's (torch ops), the decode
    MLP on every dense layer-step and never a MoE one, the head + argmax
    on every greedy step of a bf16 head it can read (tied, or untied rows).
    At least half the rows' ids differ.  The chat prefix and the pad id are
    PREFIX_IDS and PAD_ID modulo the vocabulary (prompt_ids).  Returns the
    launch counts, the projector and the requests."""
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.serve import Captioner

    card = nvidia_smi()
    spec = proj.ProjectorSpec(mm_dim=MM_DIM, lm_dim=cfg.hidden_size)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(seed),
                   dtype=torch.float32, device=dev)
    embs = np.random.default_rng(SEED).normal(size=(N_REQUESTS, MM_DIM)).astype(np.float32)
    L, steps = cfg.num_hidden_layers, MAX_NEW - 1
    attn = 0 if cfg.kv_lora_rank is not None else L
    mlp = 0 if cfg.num_experts else L
    fused = dec.fused_head_weights(cfg, params) is not None
    prefix, pad = prompt_ids(cfg)

    def captioner(c=cfg, **kw):
        return Captioner(c, params, spec, pp, max_new_tokens=MAX_NEW, batch_size=128,
                         prefix_ids=prefix, pad_token_id=pad, **kw)

    def run(name, cap, requests, per_batch, **kw):
        cap.caption_ids(requests[:128], **kw)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        ids = cap.caption_ids(requests, **kw)
        secs = time.perf_counter() - t0
        counts = _counts()
        print(f"{label} {name}: {len(requests)} requests at batch 128, {secs!r} s, "
              f"{len(requests) / secs!r} captions/s ({card})")
        _expect(name, counts, {k: n * -(-len(requests) // 128) for k, n in per_batch.items()})
        _check_ids(cfg, name, ids, len(requests))
        return ids, counts

    loop = {"mlp2": 1, "decode_attention": attn * steps}
    out = {}
    cap = captioner()
    ids, out[f"{label} serving batch-last"] = run(
        "(a) batch-last bf16 greedy", cap, embs,
        {**loop, "decode_mlp": mlp * steps, "head_argmax": steps if fused else 0})
    rows = len({tuple(r) for r in ids.tolist()})
    print(f"  {rows} distinct rows of {len(ids)}, {len(torch.unique(ids))} distinct tokens")
    if rows < len(ids) // 2:
        raise AssertionError(f"{label}: the rows' ids are alike (the random model echoes)")
    token_agreement("its plain path", ids, cap.caption_ids(embs, plain=True))
    print(f"where one {label} batch-last batch's time goes:")
    profile_run(torch, f"{label} batch 128, batch-last bf16", lambda: cap.caption_ids(embs[:128]))
    first, out[f"{label} serving batch-first"] = run(
        "(b) batch-first", captioner(batch_first=True), embs[:128], loop)
    token_agreement("the batch-last loop", first, ids[:128])
    token_agreement("the batch-first plain path", first,
                    captioner(batch_first=True).caption_ids(embs[:128], plain=True))
    sampled, out[f"{label} serving sampled"] = run(
        f"(c) sampled {SAMPLE}", cap, embs[:128], {**loop, "decode_mlp": mlp * steps}, **SAMPLE)
    token_agreement("its plain path", sampled, cap.caption_ids(embs[:128], plain=True, **SAMPLE))

    eos, mean_len = _mid_budget_eos(ids, pad=pad)
    print(f"{label} (d) bulk beside batch: EOS ids {eos} (mean length {mean_len!r} of "
          f"{MAX_NEW} in the greedy ids)")
    ecap = captioner(dataclasses.replace(cfg, eos_token_ids=eos))
    for engine in ("batch", "bulk"):  # warm-up
        ecap.caption_ids(embs[:128], engine=engine)
    runs = {}
    for engine in ("batch", "bulk"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        runs[engine] = ecap.caption_ids(embs, engine=engine)
        secs = time.perf_counter() - t0
        counts = _counts()
        _check_ids(cfg, f"engine={engine}", runs[engine], len(embs))
        print(f"  engine={engine}: {len(embs) / secs!r} captions/s ({card})")
    eng = ecap.bulk_engine
    _expect(f"{label} engine=bulk", counts,
            {"mlp2": eng.admissions, "decode_attention": attn * eng.steps,
             "decode_attention_rows": attn * eng.steps, "decode_mlp": mlp * eng.steps,
             "head_argmax": eng.steps if fused else 0})
    out[f"{label} serving bulk"] = counts
    token_agreement("the batch engine", runs["bulk"], runs["batch"])
    del ecap
    if w4a8:
        qcap = captioner(int8="w4a8")
        # w_qkv and wo of each layer-step and the untied head's step: the
        # expert stacks are dequantized into their products
        matmuls = 2 * L + (0 if cfg.tie_word_embeddings else 1)
        qids, out[f"{label} serving w4a8"] = run(
            '(e) int8="w4a8"', qcap, embs[:128], {**loop, "w4_mm": matmuls * steps})
        token_agreement("its plain path", qids, qcap.caption_ids(embs[:128], plain=True))
        print(f"  token agreement with the bf16 tree (information: int4 weights move "
              f"tokens): {(qids == ids[:128]).float().mean().item()!r}")
        del qcap
    torch.cuda.empty_cache()
    return out, (spec, pp), embs


def moe_mla_phase(torch, dev, label, cfg, params, seed, w4a8=False):
    """One MoE or MLA model on the card: its kernels at its shapes, the
    routing of one batch's prefill, its serving paths (family_serving_phase) and,
    for OLMoE, 10 stage-1 micro-steps on the flash route.  Returns its
    kernels' entries and its paths' launch counts."""
    from dmi_tpu_torch.models import llama

    # EOS off, as the other phases have it; the fused layout the Captioner
    # would make, once
    cfg = dataclasses.replace(cfg, eos_token_ids=())
    params = llama.fuse_projections(params)
    kernels = moe_mla_kernel_phase(torch, dev, label, cfg, params)
    routing_check(torch, dev, label, cfg, params)
    paths = family_serving_phase(torch, dev, label, cfg, params, seed, w4a8)[0]
    if label == OLMOE:
        paths[f"{label} stage 1"] = train_phase(torch, dev, cfg, params,
                                                label=f"{label} stage 1")
    del params
    torch.cuda.empty_cache()
    return kernels, paths


# the paper's entry points end to end: configs/smoke's chain (v2 stage 1, v4
# stage 2, v6 stage 3, v3 the LoRA baseline), each config derived as below,
# on fixture data from the port's generate_dataset, through each module's
# cli(); then the serving CLI on stage 1's best projector checkpoint and the
# sydney test pkl
CLI_CHAIN = (("stage 1", "train_projector", "v2:smoke_projector_sydney"),
             ("stage 2", "train_hypernet", "v4:smoke_hypernet"),
             ("stage 3", "train_hypernet", "v6:smoke_fewshot_candels"),
             ("LoRA", "train_lora", "v3:smoke_lora_sydney"))
CLI_DATA = (("sydney", "RemoteCLIP-RN50-Unchanged"), ("sharegpt4v", "ViT-L-16-SigLIP2-384"),
            ("candels", "zoobot-encoder-convnext_base"))
# 16 training items a dataset (2 micro-steps an epoch at the configs' batch
# of 8) and 8 eval items; the configs' mm_dim of 32; every micro-step logged
CLI_N_TRAIN, CLI_N_EVAL, CLI_MM = 16, 8, 32
CLI_OVERRIDES = {"logging_steps": 1}
CLI_PROJECTOR = ("checkpoints/v2:smoke_projector_sydney-dszfull-seed42-checkpoint-"
                 "projector-best.pt")
RESULT_KEYS = {"metrics", "gts", "preds", "ids", "eval_env"}  # training/results.py's
# the kernels each test:1b run must launch (ROADMAP B's numbering in PERF.md)
CLI_KERNELS = {"stage 1": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "mlp2"),
               "stage 2": ("lora0",),
               "serve": ("mlp2", "decode_attention", "decode_mlp", "head_argmax"),
               "serve w4a8": ("w4_mm",)}


def _timed_cli(torch, fn, argv) -> dict:
    """Wall seconds and kernel launches of one CLI call."""
    _reset_counts()
    t0 = time.perf_counter()
    fn(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "launches": _counts()}


def cli_chain(torch, workdir, lm, dtype, device, w4a8=False) -> dict:
    """Writes the fixture data and the derived configs into workdir and runs
    the chain there through the CLIs; returns each run's wall seconds and
    launches."""
    from dmi_tpu_torch import serve, train_hypernet, train_lora, train_projector
    from dmi_tpu_torch.data.fixtures import generate_dataset
    from dmi_tpu_torch.registry import dataset_spec

    clis = {"train_projector": train_projector.cli, "train_hypernet": train_hypernet.cli,
            "train_lora": train_lora.cli}
    smoke_configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "smoke")
    here = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    os.environ.setdefault("WANDB_MODE", "disabled")
    runs = {}
    try:
        for i, (name, encoder) in enumerate(CLI_DATA):
            generate_dataset("data", name, encoder, mm_dim=CLI_MM, n_train=CLI_N_TRAIN,
                             n_eval=CLI_N_EVAL, text_dim=CLI_MM, seed=SEED + i)
        for label, module, config in CLI_CHAIN:
            with open(os.path.join(smoke_configs, f"{config}.json")) as f:
                cfg = json.load(f)
            cfg.update(CLI_OVERRIDES, lm_name_or_path=lm, lm_dtype=dtype)
            with open(f"{config}.json", "w") as f:
                json.dump(cfg, f, indent=2)
            runs[label] = _timed_cli(torch, clis[module], [f"{config}.json", "--device", device])
        embs = os.path.join("data", dataset_spec("sydney").path,
                            f"test_embs_{CLI_DATA[0][1]}.pkl")
        argv = ["--lm", lm, "--lm-dtype", dtype, "--projector-ckpt", CLI_PROJECTOR,
                "--dataset", "sydney", "--embs", embs, "--engine", "batch", "--device", device]
        runs["serve"] = _timed_cli(torch, serve.main, argv + ["--out", "captions.json"])
        if w4a8:
            runs["serve w4a8"] = _timed_cli(torch, serve.main,
                                            argv + ["--out", "captions_w4a8.json", "--int8",
                                                    "w4a8"])
    finally:
        os.chdir(here)
    return runs


def cli_record(workdir) -> tuple:
    """(losses, results, captions) of a chain: every loss the trainers logged
    (logs/*.metrics.jsonl) keyed (run, step, name), every JSON under
    outputs/, and each serve run's captions."""
    import glob

    losses = {}
    for path in sorted(glob.glob(os.path.join(workdir, "logs", "*.metrics.jsonl"))):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                losses.update({(os.path.basename(path), rec["step"], k): v
                               for k, v in rec.items() if "loss" in k})
    results, captions = {}, {}
    for path in sorted(glob.glob(os.path.join(workdir, "outputs", "*.json"))):
        with open(path) as f:
            results[os.path.basename(path)] = json.load(f)
    for path in sorted(glob.glob(os.path.join(workdir, "captions*.json"))):
        with open(path) as f:
            captions[os.path.basename(path)] = json.load(f)
    return losses, results, captions


def _first_token_step(tokenizer, a: str, b: str) -> int:
    ta, tb = tokenizer(a)["input_ids"], tokenizer(b)["input_ids"]
    return next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), min(len(ta), len(tb)))


def _caption_diffs(tokenizer, label, card, cpu) -> list:
    """(where, item, step, card caption, CPU caption) of every caption that differs."""
    out = []
    for key in sorted(set(card) | set(cpu)):
        a, b = card.get(key), cpu.get(key)
        if isinstance(a, dict) and isinstance(b, dict) and "preds" in a:
            for enc in a["preds"]:
                for i, (x, y) in enumerate(zip(a["preds"][enc], b["preds"][enc])):
                    if x != y:
                        out.append((f"{label} {key} {enc}", a["ids"][enc][i],
                                    _first_token_step(tokenizer, x, y), x, y))
        elif isinstance(a, dict) and isinstance(b, dict):
            out += [(f"{label} {key}", k, _first_token_step(tokenizer, a[k], b.get(k, "")),
                     a[k], b.get(k)) for k in a if a[k] != b.get(k)]
    return out


def serve_logit_gap(torch, workdir, lm, dtype, item, step) -> float:
    """The gap between the two largest logits of the served caption of
    `item` at decode step `step`, from the plain path on the CPU: how near
    a tie the greedy pick that parted the two runs was."""
    import pickle

    from dmi_tpu_torch.models import llama, mmmodel
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops import l2_normalize
    from dmi_tpu_torch.registry import dataset_spec
    from dmi_tpu_torch.serve import Captioner

    here = os.getcwd()
    os.chdir(workdir)
    try:
        cap = Captioner.from_checkpoint(lm, CLI_PROJECTOR, "sydney", lm_dtype=dtype,
                                        device="cpu", batch_size=1)
        with open(os.path.join("data", dataset_spec("sydney").path,
                               f"test_embs_{CLI_DATA[0][1]}.pkl"), "rb") as f:
            emb = np.asarray(pickle.load(f)[item]["emb"], np.float32)[None]
    finally:
        os.chdir(here)
    ids = cap.caption_ids(emb, plain=True)[0, :step]
    soft = proj.apply(cap.proj_spec, cap.proj_params, l2_normalize(torch.as_tensor(emb)),
                      plain=True)
    embeds = torch.cat([mmmodel.assemble_prompt(cap.llm_cfg, cap.llm_params, soft,
                                                cap._prefix[:1]),
                        llama.embed_tokens(cap.llm_cfg, cap.llm_params, ids[None])], dim=1)
    logits = llama.forward(cap.llm_cfg, cap.llm_params, embeds, plain=True)[0, -1].float()
    top = logits.topk(2).values
    return float(top[0] - top[1])


def cli_phase(torch, dev) -> dict:
    """The chain at test:tiny in f32 on the card and with --device cpu, held
    equal (losses within TOL["loss"], the same captions, ids and metrics),
    then at test:1b in bf16 on the card (finite losses, results JSONs with
    training/results.py's keys and metrics equal to calc_metrics recomputed
    from their captions, one caption a request, the kernels of CLI_KERNELS
    launched); returns the test:1b runs' launch counts by path."""
    import math
    import shutil
    import types

    from dmi_tpu_torch.data.tok_fixture import build_test_tokenizer
    from dmi_tpu_torch.registry import dataset_spec
    from dmi_tpu_torch.training.generation import metrics_for

    tokenizer = build_test_tokenizer()
    root = tempfile.mkdtemp(prefix="dmi_cli_")
    try:
        tiny = {}
        for device in ("cuda", "cpu"):
            work = os.path.join(root, f"tiny-{device}")
            runs = cli_chain(torch, work, "test:tiny", "float32", device)
            for label, run in runs.items():
                print(f"CLI test:tiny f32 {device} {label}: {run['seconds']!r} s")
            tiny[device] = cli_record(work)
        (lc, rc, cc), (lp, rp, cp) = tiny["cuda"], tiny["cpu"]
        if set(lc) != set(lp) or not lc:
            raise AssertionError(f"CLI test:tiny: logged losses differ in kind: "
                                 f"{sorted(set(lc) ^ set(lp))}")
        worst = max(abs(lc[k] - lp[k]) / max(1.0, abs(lp[k])) for k in lc)
        print(f"CLI test:tiny: {len(lc)} logged losses, card against CPU: largest relative "
              f"difference {worst!r} (bound {TOL['loss']!r})")
        diffs = _caption_diffs(tokenizer, "results", rc, rp) + _caption_diffs(
            tokenizer, "serve", cc, cp)
        for where, item, step, a, b in diffs:
            gap = (serve_logit_gap(torch, os.path.join(root, "tiny-cpu"), "test:tiny",
                                   "float32", item, step) if where.startswith("serve")
                   else "not recomputed (an eval inside a training run)")
            print(f"  CLI test:tiny caption parts at {where} item {item} token step {step} "
                  f"(logit gap {gap}): card {a!r}, CPU {b!r}")
        if worst > TOL["loss"] or diffs or rc != rp or cc != cp:
            raise AssertionError("CLI test:tiny: the card's chain differs from the CPU's")
        print(f"CLI test:tiny: {len(rc)} results JSONs and {len(cc)} caption files equal, "
              f"card against CPU")

        work = os.path.join(root, "1b")
        runs = cli_chain(torch, work, "test:1b", "bfloat16", "cuda", w4a8=True)
        losses, results, captions = cli_record(work)
        for label, run in runs.items():
            print(f"CLI test:1b bf16 {label}: {run['seconds']!r} s, launches "
                  f"{ {k: v for k, v in run['launches'].items() if v} }")
            missing = [k for k in CLI_KERNELS.get(label, ()) if not run["launches"][k]]
            if missing:
                raise AssertionError(f"CLI test:1b {label}: no launch of {missing}")
        if not losses or not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"CLI test:1b: losses {losses}")
        per_run = {k: v for k, v in results.items() if "-seed" in k}
        datasets = {encoder: name for name, encoder in CLI_DATA}
        for name, res in per_run.items():
            if set(res) != RESULT_KEYS:
                raise AssertionError(f"CLI test:1b {name}: keys {sorted(res)}")
            for enc, metrics in res["metrics"].items():
                again = metrics_for(types.SimpleNamespace(dataset_name=datasets[enc]),
                                    res["preds"][enc], res["ids"][enc], res["gts"][enc], name,
                                    "test", os.path.join(work, "data"))
                if again != metrics:
                    raise AssertionError(f"CLI test:1b {name} {enc}: metrics {metrics} != "
                                         f"{again} recomputed")
        print(f"CLI test:1b: {len(losses)} finite losses; {sorted(per_run)} hold "
              f"{sorted(RESULT_KEYS)} and their metrics recompute")
        with open(os.path.join(work, "data", dataset_spec("sydney").path,
                               f"test_embs_{CLI_DATA[0][1]}.pkl"), "rb") as f:
            requests = sorted(pickle.load(f))
        for name, caps in captions.items():
            if sorted(caps) != requests or not all(isinstance(c, str) for c in caps.values()):
                raise AssertionError(f"CLI test:1b {name}: {len(caps)} captions for "
                                     f"{len(requests)} requests")
        print(f"CLI test:1b: {sorted(captions)} hold one caption for each of "
              f"{len(requests)} requests")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {f"CLI {label}": run["launches"] for label, run in runs.items()}


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
    kernels.update(row_bias_kernel_phase(torch, dev))
    kernels.update(spec_kernel_phase(torch, dev))
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
    w4a8_divergence_phase(torch, dev, cfg, params, projector, embs)
    paths.update(sampling_phase(torch, dev, cfg, params, projector, embs))
    paths.update(bulk_phase(torch, dev, cfg, params, projector, embs))
    paths.update(spec_phase(torch, dev, cfg, params, projector, embs))
    paths["stage 1"] = train_phase(torch, dev, cfg, params)
    paths["stage 2"], hn_params, hn_state = hypernet_phase(torch, dev, cfg, params)
    paths["stage 3"] = fewshot_phase(torch, dev, cfg, params, hn_params)
    paths["stage 3 over the hypernet"] = fewshot_hypernet_phase(torch, dev, cfg, params,
                                                                hn_params)
    paths["LoRA"] = lora_phase(torch, dev, cfg, params)
    paths.update(disk_phase(torch, dev, cfg, params, projector, embs, hn_params, hn_state))
    del params, hn_params, hn_state, projector
    torch.cuda.empty_cache()
    gemma_kernels, gemma_paths = gemma_phase(torch, dev)
    kernels.update(gemma_kernels)
    paths.update(gemma_paths)
    for label, load, seed, w4a8 in ((OLMOE, olmoe_load_phase, SEED + 32, True),
                                    (V2, v2lite_load_phase, SEED + 42, False)):
        model_cfg, model_params = load(torch, dev)
        model_kernels, model_paths = moe_mla_phase(torch, dev, label, model_cfg, model_params,
                                                   seed, w4a8)
        del model_params
        torch.cuda.empty_cache()
        kernels.update(model_kernels)
        paths.update(model_paths)
    paths.update(cli_phase(torch, dev))
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in ("dmi_tpu", "jax"))
    if jax_side:
        raise AssertionError(f"the smoke loaded modules of the JAX side: {jax_side}")

    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    # kernel: (name, source, TPU kernel it replaces, the path whose run's count is
    # reported, the launch counter that counts it there)
    head = ("dmi_tpu_torch/csrc/head_argmax.cu", "dmi_tpu/ops/pallas/head_argmax.py:97")
    int8_mm = ("dmi_tpu_torch/csrc/w4_matmul.cu", "dmi_tpu/ops/pallas/w4_matmul.py:99")
    sources = {"mlp2": ("fused_mlp2", "dmi_tpu_torch/csrc/mlp2.cu",
                        "dmi_tpu/ops/pallas/projector.py:167", "serving", "mlp2"),
               "decode_attention": ("fused_decode_attention",
                                    "dmi_tpu_torch/csrc/decode_attn.cu",
                                    "dmi_tpu/ops/pallas/decode_attn.py:121", "serving",
                                    "decode_attention"),
               "decode_attention_rows": ("fused_decode_attention, a [B, S] bias row per slot",
                                         "dmi_tpu_torch/csrc/decode_attn.cu",
                                         "dmi_tpu/ops/pallas/decode_attn.py:121",
                                         "serving bulk", "decode_attention_rows"),
               "decode_attention_spec": ("fused_decode_attention with k + 1 = 5 query "
                                         "positions per cache row (K3; dmi_tpu's verify "
                                         "attends through XLA, "
                                         "dmi_tpu/models/speculative.py:142)",
                                         "dmi_tpu_torch/csrc/decode_attn.cu",
                                         "dmi_tpu/ops/pallas/decode_attn.py:121",
                                         "serving speculative", "decode_attention_pos"),
               "decode_mlp_spec": ("fused_decode_mlp_bl at the verify's 640 columns",
                                   "dmi_tpu_torch/csrc/decode_mlp.cu",
                                   "dmi_tpu/ops/pallas/decode_mlp.py:97", "serving speculative",
                                   "decode_mlp"),
               "head_argmax_spec": ("head_argmax bf16 at the verify's 640 columns (the count "
                                    "also holds the draft's q8 calls, 4 a round)", *head,
                                    "serving speculative", "head_argmax"),
               "flash_fwd": ("flash_attention forward", "dmi_tpu_torch/csrc/flash_attn_fwd.cu",
                             f"dmi_tpu/models/llama.py:1086 ({flash}:758 "
                             "_flash_attention_impl)", "stage 1", "flash_fwd"),
               "flash_bwd_dkv": ("flash_attention backward dK/dV",
                                 "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                 f"dmi_tpu/models/llama.py:1086 ({flash}:1121 "
                                 "_flash_attention_bwd_dkv)", "stage 1", "flash_bwd_dkv"),
               "flash_bwd_dq": ("flash_attention backward dQ",
                                "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                f"dmi_tpu/models/llama.py:1086 ({flash}:1456 "
                                "_flash_attention_bwd_dq)", "stage 1", "flash_bwd_dq"),
               "lora0": ("fused_lora_layer0", "dmi_tpu_torch/csrc/lora0.cu",
                         "dmi_tpu/ops/pallas/projector.py:251", "stage 2", "lora0"),
               "head_argmax": ("head_argmax bf16", *head, "serving batch-last", "head_argmax"),
               "head_argmax_q": ("head_argmax q", *head, "serving int8", "head_argmax"),
               "head_argmax_q8": ("head_argmax q8", *head, "serving w4a8", "head_argmax"),
               "decode_mlp": ("fused_decode_mlp_bl", "dmi_tpu_torch/csrc/decode_mlp.cu",
                              "dmi_tpu/ops/pallas/decode_mlp.py:97", "serving batch-last",
                              "decode_mlp"),
               "w4_mm": ("w4_mm_bl", *int8_mm, "serving w4a8", "w4_mm"),
               "w8_mm": ("w8_mm_bl (the W8A8 instance; dmi_tpu runs W8A8 on XLA)", *int8_mm,
                         "serving w8a8", "w8_mm"),
               "block_mm": ("block_mm int8", "dmi_tpu_torch/csrc/block_mm.cu",
                            "scripts/profile_int8_mxu.py:74 (pallas_mm)", "probes", "block_mm"),
               "stream_mm": ("stream_mm_bl", "dmi_tpu_torch/csrc/stream_mm.cu",
                             "scripts/profile_mlp_stream.py:67 (pallas_mm)", "probes",
                             "stream_mm"),
               "w4_split_out": ("w4_dot_split_out", "dmi_tpu_torch/csrc/w4_probe.cu",
                                "scripts/profile_w4_matmul.py:156 (dot_w4_pallas)", "probes",
                                "w4_split_out"),
               "w4_split_k": ("w4_dot_split_k", "dmi_tpu_torch/csrc/w4_probe.cu",
                              "scripts/profile_w4_matmul.py:184 (dot_w4_pallas_k)", "probes",
                              "w4_split_k"),
               "mlp2_gemma": ("fused_mlp2 at Gemma-2-2B (f32, 1024 -> 2304 -> 2304)",
                              "dmi_tpu_torch/csrc/mlp2.cu", "dmi_tpu/ops/pallas/projector.py:167",
                              GEMMA_PATH, "mlp2"),
               "decode_attention_gemma": ("fused_decode_attention at Gemma-2-2B (8/4 heads, "
                                          "hd 256, softcap 50)",
                                          "dmi_tpu_torch/csrc/decode_attn.cu",
                                          "dmi_tpu/ops/pallas/decode_attn.py:121", GEMMA_PATH,
                                          "decode_attention"),
               "decode_mlp_gemma": ("fused_decode_mlp_bl at Gemma-2-2B (gelu_tanh, H 2304, "
                                    "I 9216)", "dmi_tpu_torch/csrc/decode_mlp.cu",
                                    "dmi_tpu/ops/pallas/decode_mlp.py:97", GEMMA_PATH,
                                    "decode_mlp"),
               "head_argmax_gemma": ("head_argmax bf16 at Gemma-2-2B (V 256000, H 2304)", *head,
                                     GEMMA_PATH, "head_argmax"),
               "decode_attention_olmoe": ("fused_decode_attention at OLMoE-1B-7B (16/16 heads, "
                                          "group 1, hd 128)",
                                          "dmi_tpu_torch/csrc/decode_attn.cu",
                                          "dmi_tpu/ops/pallas/decode_attn.py:121",
                                          f"{OLMOE} serving batch-last", "decode_attention"),
               "decode_attention_rows_olmoe": ("fused_decode_attention at OLMoE-1B-7B, a [B, S] "
                                               "bias row per slot",
                                               "dmi_tpu_torch/csrc/decode_attn.cu",
                                               "dmi_tpu/ops/pallas/decode_attn.py:121",
                                               f"{OLMOE} serving bulk", "decode_attention_rows"),
               "head_argmax_olmoe": ("head_argmax bf16 at OLMoE-1B-7B's untied head (V 50304, "
                                     "H 2048)", *head, f"{OLMOE} serving batch-last",
                                     "head_argmax"),
               "w4_mm_olmoe": ("w4_mm_bl at OLMoE-1B-7B (w_qkv 2048 -> 6144; wo in by_shape)",
                               *int8_mm, f"{OLMOE} serving w4a8", "w4_mm"),
               "flash_fwd_olmoe": ("flash_attention forward at OLMoE-1B-7B (16/16 heads, hd "
                                   "128)", "dmi_tpu_torch/csrc/flash_attn_fwd.cu",
                                   f"dmi_tpu/models/llama.py:1086 ({flash}:758 "
                                   "_flash_attention_impl)", f"{OLMOE} stage 1", "flash_fwd"),
               "flash_bwd_dkv_olmoe": ("flash_attention backward dK/dV at OLMoE-1B-7B",
                                       "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                       f"dmi_tpu/models/llama.py:1086 ({flash}:1121 "
                                       "_flash_attention_bwd_dkv)", f"{OLMOE} stage 1",
                                       "flash_bwd_dkv"),
               "flash_bwd_dq_olmoe": ("flash_attention backward dQ at OLMoE-1B-7B",
                                      "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                      f"dmi_tpu/models/llama.py:1086 ({flash}:1456 "
                                      "_flash_attention_bwd_dq)", f"{OLMOE} stage 1",
                                      "flash_bwd_dq"),
               "head_argmax_v2lite": ("head_argmax bf16 at DeepSeek-V2-Lite's untied head "
                                      "(V 102400, H 2048)", *head, f"{V2} serving batch-last",
                                      "head_argmax")}
    print(f"launches by path: {paths}")
    report = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": paths[path][count], **kernels[key]}
              for key, (name, src, rep, path, count) in sources.items()]
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
