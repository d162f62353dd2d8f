#!/usr/bin/env python3
"""Smoke run of dmi_tpu_torch's serving paths (batch-first, batch-last,
quantized, sampled, continuous batching, tensor- and data-parallel), its
three training stages (with the LoRA baseline, and on a mesh) and its
loading of HF-layout weights and reference torch checkpoints on one CUDA
card.

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
   are printed.  Then the paper's LM name (hub_phase): a temporary hub
   cache holds meta-llama/Llama-3.2-1B-Instruct (the 1B tree in the HF
   layout and the Llama-3 fixture tokenizer of data/hf_tokenizer.py);
   build_tokenizer reads the name with the port's reader, held exactly to
   transformers' output in llama3_tok_golden.json;
   configs/experiments/projector/v2:llama1b_sydney_rn50_mlp2 runs through
   train_projector.cli with its lm_name_or_path as written (data sizes,
   steps, seeds, output root and logging changed) and one serve.main batch
   on the name, each launching its kernels; the phase's seconds, the
   tokenizer's load time and its host time per caption are printed.

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

19. Tensor- and data-parallel serving (dmi_tpu_torch/parallel/) at
   Llama-3.2-1B's full width, its 128 first requests (weights, projector
   and requests from the same seeds): the kernels at a model rank's shapes
   (decode attention at 16/4 heads, the decode MLP at I 4096, the head +
   argmax over a vocab block of 64128 rows with its scores, the packed W4A8
   matmul's f32 instance at a w_down row shard, K 4096), each against its
   twin and timed; (a) a one-rank NCCL mesh (1, 1) in this process, its
   greedy ids bit-equal to the unsharded run's; (b) NCCL with two ranks on
   the one card (refused; printed); (c) two worker processes on cuda:0
   over gloo, started with spawn: gloo's take of CUDA tensors checked op by
   op, then at (1, 2) greedy batch-last bf16, int8="w4a8" and the bulk
   engine, at (2, 1) greedy bf16, each with launch counts from both
   workers, captions/s beside the one-rank run and the share of the wall
   in the collective calls; the bf16 runs' token agreement with one rank
   held to TOKEN_AGREEMENT (w4a8's printed), the first step's logits at
   (1, 2) within PARALLEL_LOGITS_TOL, where the prompt pass parts from
   one rank's (K cache layer by layer), the W4A8 token loop from one
   prompt pass bit-equal sharded and whole, and a tiny f32 model's ids at
   (1, 2) and (2, 1) identical to one rank's.
20. Training on a mesh at Llama-3.2-1B's full width: the flash kernels at a
   model rank's heads (16/4 timed, 8/2 held), mlp2 and lora0 at a data
   rank's rows, each against its twin and timed; the device time of a
   (1, 2) micro-step's row-parallel products (wo, w_down shards) in f32, as
   the training path computes them, beside bf16; (a) stage 1 on a one-rank
   NCCL mesh (1, 1) bit-equal to the unsharded trainer (step 0's loss and
   projector gradients, 4 micro-steps' losses, the projector after them);
   (b) two gloo worker processes on cuda:0 at (1, 2) and (2, 1): stage 1
   (projector/v1's shapes, 4 updates) and stage 2 (hypernet/v4's, 2
   micro-steps), step 0's loss within TOL["loss"] of one rank's and each
   gradient leaf within TOL["logits"] of its largest one-rank gradient,
   micro-steps/s beside one rank's, the share of the wall in the
   collective calls, launch counts of the flash kernels, mlp2 (an eval
   loss) and lora0 on both workers; (c) a tiny f32 model's losses over 4
   updates with dropout equal to one rank's to 1e-5 relative; (d) a
   torch.distributed.checkpoint directory written and read back across the
   workers, bit for bit.

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
    mask [B, 1, P, S]; two calls bit-equal; the same at P 2 and 4 (the
    round's first P rows), at OLMoE's heads (group 1: 16/16, hd 128) and at
    Gemma-2-2B's (8/4 heads, hd 256 on the CUDA cores, scale 256^-0.5,
    softcap 50; SDPA without it); the decode MLP (H 2048, I 8192, silu) and
    the bf16 head + argmax (V 128256) at 640 columns against their twins,
    timed."""
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
    print(f"kernel fused_decode_attention with P query positions per cache row (K3) vs "
          f"_decode_attn_plain (B {B}, S {S}, round {rnd}'s rows; position p sees the rows "
          f"up to rt + p):")
    errs = []
    # (query heads, kv heads, hd, P, dtypes, scale, softcap): the verify's
    # shape first (the kernels line's entry), then P 2 and 4, OLMoE's heads
    # and Gemma-2-2B's
    cases = ((32, 8, 64, P, (torch.bfloat16, torch.float32), None, None),
             (32, 8, 64, 2, (torch.bfloat16, torch.float32), None, None),
             (32, 8, 64, 4, (torch.bfloat16, torch.float32), None, None),
             (16, 16, 128, P, (torch.bfloat16,), None, None),
             (8, 4, 256, P, (torch.bfloat16,), 256 ** -0.5, 50.0))
    for nh, nkv, hd, npos, dtypes, scale, cap in cases:
        pb = bias[:, :npos].contiguous()
        for dtype in dtypes:
            q = torch.randn(B, nh, npos, hd, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(B, nkv, S, hd, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            args = (q, k, v, pb, scale, cap)
            label = f"B={B} {nh}/{nkv} heads hd={hd} P={npos} S={S} {str(dtype)[6:]}"
            out = da.fused_decode_attention(*args)
            err = compare(torch, label, out, da._decode_attn_plain(*args), TOL[str(dtype)[6:]])
            if (nh, npos) == (32, P):  # the kernels line's entry: the verify's shape
                errs.append(err)
            if not torch.equal(out, da.fused_decode_attention(*args)):
                raise AssertionError(f"K3 {label}: two calls on the same inputs differ")
            if dtype != torch.bfloat16:
                continue
            mask = pb.view(B, 1, npos, S).to(dtype)
            t = {**device_times(
                torch, lambda: da.fused_decode_attention(*args),
                lambda: da._decode_attn_plain(*args),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale,
                                                       enable_gqa=True)),
                 **least_time(nbytes(q, k, v, pb, q), 4 * B * nh * npos * S * hd, dtype)}
            us = host_us(torch, lambda: da.fused_decode_attention(*args))
            print(f"    {label}: {report_times(t)}; library: scaled_dot_product_attention, "
                  f"GQA, float mask [B, 1, P, S]{', no softcap' if cap else ''}; K and V alone "
                  f"{nbytes(k, v) / 1e6!r} MB; plan "
                  f"{da.plan(B, nkv, nh // nkv, S, hd, 2, npos)}; host time per call {us!r} "
                  f"us; two calls bit-equal")
            if (nh, npos) == (32, P):
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
    bm.launches = bm.bf16_launches = sm.launches = 0
    wp.split_out_launches = wp.split_k_launches = wp.tma_launches = wp.wmma_launches = 0


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
            "block_mm": bm.launches - bm.bf16_launches, "block_mm_bf16": bm.bf16_launches,
            "stream_mm": sm.launches,
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
    from dmi_tpu_torch.ops.cuda import w4_probe
    from dmi_tpu_torch.ops.cuda.stream_mm import BLOCK_OUT
    from dmi_tpu_torch.probes import profile_int8_mxu, profile_mlp_stream, profile_w4_matmul

    print("kernel probes at their default shapes:")
    _reset_counts()
    t0 = time.perf_counter()
    r9 = profile_int8_mxu.run(inner=PROBE_INNER)
    r10 = profile_mlp_stream.run(inner=PROBE_INNER)
    r11 = profile_w4_matmul.run(inner=PROBE_INNER)
    counts = _counts()
    w4_routes = {"tma": w4_probe.tma_launches, "wmma": w4_probe.wmma_launches}
    print(f"probes: {time.perf_counter() - t0!r} s")
    # a kernel's variant: its gate's call, 3 warm-ups and PROBE_INNER timed calls
    per = 1 + 3 + PROBE_INNER
    _expect("probes", counts, {"block_mm": per, "block_mm_bf16": per,
                               "stream_mm": len(BLOCK_OUT) * per,
                               "w4_split_out": per, "w4_split_k": per})

    def entry(r, kernel, plain, library, bound_key, err_key):
        return {"max_abs_err": r[err_key], "ms": r[f"{kernel}_ms"], "plain_ms": r[f"{plain}_ms"],
                "library_ms": r.get(f"{library}_ms"),
                "bound_ms": r[f"{bound_key}_bound_us"] / 1e3,
                "bound_by": r[f"{bound_key}_bound_by"]}

    def against(e):
        """the kernel's time over its library call's, and its bound's share of it"""
        lib = "no library call" if e["library_ms"] is None else \
            f"{e['ms'] / e['library_ms']!r}x the library"
        return f"{lib}, {e['bound_ms'] / e['ms']!r} of its bound"

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
    # both layouts at the probe's shape take the wgmma route: 11a's and 11b's
    # launches all counted there
    print(f"  w4 probe launches by route: {w4_routes}")
    if w4_routes != {"tma": 2 * per, "wmma": 0}:
        raise AssertionError(f"w4 probe routes {w4_routes}: the wgmma route did not run")
    for name, split_k in (("w4_split_out", False), ("w4_split_k", True)):
        pl = w4_probe.plan(r11["OUT"], r11["batch"], r11["K"], split_k)
        print(f"  {name}: tiles of {pl['bm']} rows x {pl['bn']} batch columns, "
              f"{pl.get('tiles')} tiles on {pl['grid']} blocks, {pl.get('stages')} stages of "
              f"{pl.get('stage_bytes')} bytes")
    kernels = {
        "block_mm": entry(r9, "cuda_int8", "plain_int8", "torch_int8", "cuda_int8",
                          "cuda_int8_max_abs_err"),
        "block_mm_bf16": entry(r9, "cuda_bf16", "plain_bf16", "torch_bf16", "cuda_bf16",
                               "cuda_bf16_max_abs_err"),
        "stream_mm": entry(r10, f"cuda_bo{best}", "plain", "torch", "cuda",
                           f"cuda_bo{best}_max_abs_err"),
        "w4_split_out": entry(r11, "cuda_split_out", "plain_split_out", "torch_w4_split_out",
                              "cuda_split_out", "cuda_split_out_max_abs_err"),
        "w4_split_k": entry(r11, "cuda_split_k", "plain_split_k", "torch_w4_split_k",
                            "cuda_split_k", "cuda_split_k_max_abs_err"),
    }
    for name, e in kernels.items():
        print(f"  {name}: {e['ms'] * 1e3!r} us, {against(e)}")
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
    stacks = nbytes(*llama.expert_stacks(lw, bf), lw["w_router"], hn, hn)
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


# ---------------------------------------------------------------------------
# The paper's LM name: meta-llama/Llama-3.2-1B-Instruct from a hub cache
# ---------------------------------------------------------------------------

HUB_NAME = "meta-llama/Llama-3.2-1B-Instruct"
HUB_CONFIG = "v2:llama1b_sydney_rn50_mlp2"  # under configs/experiments/projector
# what the phase changes in that config: the data sizes, the steps and the
# runs (one epoch at the full size of generate_dataset's data, in the
# working directory, under the first of the default seeds), the results'
# directory (in the working directory) and the logging
HUB_OVERRIDES = {"dataset_size_l": ["full"], "epochs_l": [1], "seeds": [55625],
                 "output_root": "outputs", "logging_steps": 1}
HUB_N_TRAIN, HUB_N_EVAL = 64, 64  # micro-steps at the config's batch of 64; one eval batch
HUB_ENCODER = "RemoteCLIP-RN50-Unchanged"


def golden_check(tok) -> int:
    """The reader's ids (with and without bos), decodes, chat renders, chat
    ids and assistant masks on llama3_tok_golden.json's texts and chats,
    exactly as transformers computed them; returns the bytes checked."""
    from dmi_tpu_torch.data import hf_tokenizer

    gold = json.loads(hf_tokenizer.GOLDEN_FILE.read_text(encoding="utf-8"))
    got = hf_tokenizer.golden_outputs(tok, gold["texts"], gold["chats"], gold["date_string"])
    wrong = sorted(k for k in set(got) | set(gold) if got.get(k) != gold.get(k))
    if wrong:
        raise AssertionError(f"the tokenizer reader differs from transformers' golden output "
                             f"at {wrong}")
    return sum(len(json.dumps(v)) for k, v in got.items()
               if k not in ("texts", "chats", "date_string"))


def hub_phase(torch, dev, cfg, params) -> dict:
    """The paper's configs run as written, by their LM name: a temporary hub
    cache holds models--meta-llama--Llama-3.2-1B-Instruct/snapshots/<rev>
    (refs/main) with the 1B tree in the HF layout and the Llama-3 fixture
    tokenizer (hf_tokenizer.write_llama3_tokenizer_dir), HF_HUB_CACHE points
    at it and DMI_LM_OVERRIDE is unset.  (a) build_tokenizer reads the name
    through the port's reader (never transformers), held to the golden file
    exactly; (b) configs/experiments/projector/HUB_CONFIG with its
    lm_name_or_path as written through train_projector.cli, on
    generate_dataset's sydney data (HUB_OVERRIDES: data sizes, steps,
    logging); (c) one serve.main batch on the name and stage (b)'s best
    projector.  Each run launches the kernels of CLI_KERNELS; returns its
    launch counts.  Prints the phase's seconds, the tokenizer's load time
    and its host time per caption (encode and decode)."""
    import glob
    import shutil

    from dmi_tpu_torch import serve, train_projector
    from dmi_tpu_torch.config import LMArgs
    from dmi_tpu_torch.data import hf_tokenizer
    from dmi_tpu_torch.data.fixtures import generate_dataset
    from dmi_tpu_torch.registry import dataset_spec
    from dmi_tpu_torch.training.model_utils import build_tokenizer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dmi_hub_")
    saved_env = {k: os.environ.get(k) for k in ("HF_HUB_CACHE", "DMI_LM_OVERRIDE")}
    here = os.getcwd()
    out = {}
    try:
        repo = os.path.join(root, "hub", "models--" + HUB_NAME.replace("/", "--"))
        snapshot = os.path.join(repo, "snapshots", "0123abcd")
        os.makedirs(snapshot)
        os.makedirs(os.path.join(repo, "refs"))
        with open(os.path.join(repo, "refs", "main"), "w") as f:
            f.write("0123abcd")
        t0 = time.perf_counter()
        hub_cfg = dataclasses.replace(cfg, eos_token_ids=(128001, 128008, 128009))
        lm_bytes = write_hf_llama(torch, snapshot, hub_cfg, params)
        hf_tokenizer.write_llama3_tokenizer_dir(snapshot)
        print(f"hub {HUB_NAME}: wrote {lm_bytes} bytes of weights and "
              f"{sorted(n for n in os.listdir(snapshot) if n.startswith('tok') or 'special' in n)}"
              f" in {time.perf_counter() - t0!r} s")
        os.environ["HF_HUB_CACHE"] = os.path.join(root, "hub")
        os.environ.pop("DMI_LM_OVERRIDE", None)

        # (a) the tokenizer by name, held to transformers' golden output
        t0 = time.perf_counter()
        tok = build_tokenizer(LMArgs(lm_name_or_path=HUB_NAME))
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hf_tokenizer.llama3_regex()
        regex_s = time.perf_counter() - t0
        if not isinstance(tok, hf_tokenizer.Llama3Tokenizer):
            raise AssertionError(f"build_tokenizer({HUB_NAME!r}) gave {type(tok)}")
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("transformers",
                                                                       "tokenizers"))
        if loaded:
            raise AssertionError(f"the hub phase loaded {loaded}")
        checked = golden_check(tok)
        print(f"  tokenizer: {type(tok).__name__} (bos {tok.bos_token_id}, eos "
              f"{tok.eos_token_id}, pad {tok.pad_token_id}, vocab {tok.vocab_size} + "
              f"{len(tok._added)} added) read in {load_s!r} s, its Split pattern's "
              f"classes built in {regex_s!r} s; golden file held exactly ({checked} bytes of "
              f"ids, masks, renders and decodes)")

        # (b) stage 1 through the CLI, the config's LM name as written
        work = os.path.join(root, "work")
        os.makedirs(work)
        os.chdir(work)
        os.environ.setdefault("WANDB_MODE", "disabled")
        generate_dataset("data", "sydney", HUB_ENCODER, mm_dim=1024, n_train=HUB_N_TRAIN,
                         n_eval=HUB_N_EVAL, seed=SEED)
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                               "experiments", "projector", f"{HUB_CONFIG}.json")) as f:
            config = json.load(f)
        if config["lm_name_or_path"] != HUB_NAME:
            raise AssertionError(f"{HUB_CONFIG} names {config['lm_name_or_path']}")
        config.update(HUB_OVERRIDES)
        with open(f"{HUB_CONFIG}.json", "w") as f:
            json.dump(config, f, indent=2)
        runs = {"stage 1": _timed_cli(torch, train_projector.cli,
                                      [f"{HUB_CONFIG}.json", "--device", dev.type])}
        best = glob.glob(os.path.join("checkpoints", "*projector-best.pt"))
        embs = os.path.join("data", dataset_spec("sydney").path, f"test_embs_{HUB_ENCODER}.pkl")
        if len(best) != 1:
            raise AssertionError(f"stage 1 left {best}")
        # (c) one serving batch on the name
        runs["serve"] = _timed_cli(torch, serve.main, [
            "--lm", HUB_NAME, "--projector-ckpt", best[0], "--dataset", "sydney", "--embs",
            embs, "--engine", "batch", "--out", "captions.json", "--device", dev.type])
        losses, results, captions = cli_record(".")
        for label, run in runs.items():
            print(f"  {label} on {HUB_NAME}: {run['seconds']!r} s, launches "
                  f"{ {k: v for k, v in run['launches'].items() if v} }")
            missing = [k for k in CLI_KERNELS[label] if not run["launches"][k]]
            if missing:
                raise AssertionError(f"{HUB_NAME} {label}: no launch of {missing}")
            out[f"hub {label}"] = run["launches"]
        with open(embs, "rb") as f:
            requests = sorted(pickle.load(f))
        caps = captions.get("captions.json", {})
        if (not losses or not all(np.isfinite(v) for v in losses.values())
                or sorted(caps) != requests or not results):
            raise AssertionError(f"{HUB_NAME}: losses {losses}, {len(caps)} captions for "
                                 f"{len(requests)} requests, results {sorted(results)}")

        # the tokenizer's host time per caption, as the loader and serving use it
        with open(os.path.join("data", dataset_spec("sydney").path,
                               f"train_embs_{HUB_ENCODER}.pkl"), "rb") as f:
            texts = [v["caption"] for v in pickle.load(f).values()]
        # captions of 12 words drawn from SURVEY.md's, for a vocabulary wider
        # than the fixture's eight captions
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "SURVEY.md"),
                  encoding="utf-8") as f:
            words = f.read().split()
        rng = np.random.default_rng(SEED)
        distinct = [" ".join(rng.choice(words, 12)) for _ in range(len(texts))]
        per_caption = {}
        for label, batch in (("the training chats", texts), ("distinct captions", distinct)):
            chats = [[{"role": "user", "content": "Describe the satellite image"},
                      {"role": "assistant", "content": c}] for c in batch]
            fresh = build_tokenizer(LMArgs(lm_name_or_path=HUB_NAME))  # a cold BPE cache
            t0 = time.perf_counter()
            enc = fresh.apply_chat_template(chats, tokenize=True, return_dict=True,
                                            return_assistant_tokens_mask=True)
            t1 = time.perf_counter()
            fresh.batch_decode(enc["input_ids"], skip_special_tokens=True)
            t2 = time.perf_counter()
            per_caption[label] = ((t1 - t0) / len(chats) * 1e6, (t2 - t1) / len(chats) * 1e6)
        print(f"  tokenizer host time per caption (encode with assistant masks, decode; us): "
              + "; ".join(f"{k} ({len(texts)}, {len(set(b))} distinct): {e!r}, {d!r}"
                          for (k, (e, d)), b in zip(per_caption.items(), (texts, distinct)))
              + f"; {len(losses)} finite losses, {len(caps)} captions for {len(requests)} "
              f"requests, results {sorted(results)}")
    finally:
        os.chdir(here)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    print(f"hub phase: {time.perf_counter() - t_phase!r} s ({nvidia_smi()})")
    return out


# ---------------------------------------------------------------------------
# Tensor- and data-parallel serving (dmi_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

PARALLEL_REQUESTS = 128  # one batch of 128 requests a full-width run
PARALLEL_MESHES = ((1, 2), (2, 1))
# the first step's logits of (1, 2) against the one-rank run, bf16: each rank
# rounds its partial wo and MLP products to bf16 before the psum (only the
# int8 kernels emit f32 partials), so a logit may move by a few bf16 steps
PARALLEL_LOGITS_TOL = TOL["logits"]
PARALLEL_TIMEOUT = 900  # seconds the worker processes may take, set-up included
TINY_PARALLEL = dict(vocab_size=253, eos=(5,))  # f32, 2 layers, 4/2 heads: m = 2 and 4 split
TINY_REQUESTS, TINY_BUDGET, TINY_PREFIX = 12, 10, [3, 7, 9]


def _parallel_model(torch, dev):
    """Llama-3.2-1B at full width (EOS off), its fused tree from SEED, the
    serving projector (mm 1024, from SEED + 2) and PARALLEL_REQUESTS
    requests: main()'s and slice_phase's, rebuilt from the same seeds in
    each process of the parallel phase."""
    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.models import projector as proj

    cfg = dataclasses.replace(llama.llama32_1b(), eos_token_ids=())
    params = llama.fuse_projections(
        llama.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    spec = proj.ProjectorSpec(mm_dim=MM_DIM, lm_dim=cfg.hidden_size)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(SEED + 2),
                   dtype=torch.float32, device=dev)
    embs = np.random.default_rng(SEED).normal(size=(PARALLEL_REQUESTS, MM_DIM)).astype(
        np.float32)
    return cfg, params, spec, pp, embs


def _parallel_tiny(torch, dev):
    """A tiny f32 LM (layer weights scaled to std 0.2 so that greedy tokens
    vary and EOS fires at staggered ages), a projector (mm 16) and
    TINY_REQUESTS requests, from SEED + 70."""
    from dmi_tpu_torch.models import llama
    from dmi_tpu_torch.models import projector as proj

    cfg = llama.tiny_config(**TINY_PARALLEL)
    params = llama.init(cfg, torch.Generator(device=dev).manual_seed(SEED + 70), dev)
    params["layers"] = [{k: v * 10.0 if k.startswith("w") else v for k, v in lw.items()}
                        for lw in params["layers"]]
    spec = proj.ProjectorSpec(mm_dim=16, lm_dim=cfg.hidden_size)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(SEED + 71),
                   dtype=torch.float32, device=dev)
    embs = np.random.default_rng(SEED + 72).normal(size=(TINY_REQUESTS, 16)).astype(np.float32)
    return cfg, params, spec, pp, embs


def _bits_sum(torch, t) -> int:
    """An exact checksum of a bf16 tensor: the sum of its bit patterns."""
    return int(t.contiguous().view(torch.int16).to(torch.int64).sum())


def _parallel_captioner(cfg, params, spec, pp, **kw):
    from dmi_tpu_torch.serve import Captioner

    return Captioner(cfg, params, spec, pp, max_new_tokens=MAX_NEW,
                     batch_size=PARALLEL_REQUESTS, prefix_ids=PREFIX_IDS, pad_token_id=PAD_ID,
                     **kw)


def _tiny_ids(torch, dev, mesh_shape=None):
    from dmi_tpu_torch.serve import Captioner

    cfg, params, spec, pp, embs = _parallel_tiny(torch, dev)
    cap = Captioner(cfg, params, spec, pp, max_new_tokens=TINY_BUDGET, batch_size=4,
                    mesh_shape=mesh_shape, prefix_ids=TINY_PREFIX, pad_token_id=0)
    return cap.caption_ids(embs)


# the full-width runs of the workers: (label, Captioner kwargs, caption_ids kwargs)
PARALLEL_RUNS = (("bf16", {}, {}), ("w4a8", {"int8": "w4a8"}, {}),
                 ("bulk", {}, {"engine": "bulk"}))


def _greedy_loop(torch, cfg, tree, caches, logits0, T):
    """greedy_generate_bl's token loop (EOS off) from given prompt caches
    and next-token logits: [B, MAX_NEW] ids through the fused head."""
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import llama

    head_w = dec.fused_head_weights(cfg, tree)
    tok = logits0.argmax(dim=-1)
    ids = [tok]
    for step in range(MAX_NEW - 1):
        h = llama.scale_embeds(cfg, llama.embed_tokens(cfg, tree, tok).t().to(cfg.dtype))
        tok = dec.head_ids(head_w, dec._decode_step_bl(cfg, tree, h.contiguous(), caches,
                                                       T + step, head=False))
        ids.append(tok)
    return torch.stack(ids, dim=1)


def _gloo_cuda_probe(torch, dist, rank, world, dev) -> dict:
    """Whether gloo takes the device's tensors directly for each collective
    the port calls, in each dtype it hands over (bf16 and f32 activations,
    int64 ids and counts): True, or the error it raised."""
    out = {}
    for op, dtype in ((op, dtype) for op in ("all_reduce", "all_gather", "broadcast")
                      for dtype in (torch.bfloat16, torch.float32, torch.int64)):
        x = torch.full((4,), rank + 1, device=dev, dtype=dtype)
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
                ok = bool((x == world * (world + 1) // 2).all())
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = all(bool((p == g + 1).all()) for g, p in enumerate(parts))
            else:
                dist.broadcast(x, 0)
                ok = bool((x == 1).all())
            torch.cuda.synchronize()
            out[f"{op} {str(dtype)[6:]}"] = ok or "wrong values"
        except (RuntimeError, ValueError) as e:
            out[f"{op} {str(dtype)[6:]}"] = f"{type(e).__name__}: {str(e)[:300]}"
    return out


def _parallel_worker(rank, world, store, out_dir, device):
    """One rank of the gloo world on cuda:0: the gloo probe, then every run
    of PARALLEL_RUNS at (1, 2) and the bf16 run at (2, 1) on the full-width
    model, the first step's logits at (1, 2) against the whole tree's, and
    the tiny f32 ids at both meshes; saved to out_dir/rank{rank}.pt."""
    import torch
    import torch.distributed as dist

    from dmi_tpu_torch import parallel
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import mmmodel
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.models.quant import quantize_llama
    from dmi_tpu_torch.ops import l2_normalize
    from dmi_tpu_torch.ops.cuda import w4_matmul as w4
    from dmi_tpu_torch.parallel import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    parallel.init_distributed(init_method=f"file://{store}", rank=rank, world_size=world,
                              backend="gloo")
    res = {"gloo_cuda": _gloo_cuda_probe(torch, dist, rank, world, dev), "runs": {}}
    spent = [0.0]

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            return out
        return run

    collectives.all_reduce = timed(collectives.all_reduce)
    collectives.all_gather = timed(collectives.all_gather)
    cfg, params, spec, pp, embs = _parallel_model(torch, dev)
    res["checksum"] = _bits_sum(torch, params["embed"])
    for shape in PARALLEL_MESHES:
        for label, kw, ckw in PARALLEL_RUNS:
            if shape != (1, 2) and label != "bf16":
                continue
            cap = _parallel_captioner(cfg, params, spec, pp, mesh_shape=shape, **kw)
            cap.caption_ids(embs, **ckw)  # warm-up
            _reset_counts()
            w4.f32_launches = 0
            spent[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = cap.caption_ids(embs, **ckw)
            secs = time.perf_counter() - t0
            run = {"ids": ids, "secs": secs, "collective_secs": spent[0],
                   "counts": {**_counts(), "w4_mm_f32": w4.f32_launches}}
            if label == "bulk":
                run["steps"], run["admissions"] = cap.bulk_engine.steps, cap.bulk_engine.admissions
            res["runs"][f"{shape} {label}"] = run
            del cap
            torch.cuda.empty_cache()

    mesh = parallel.make_mesh((1, 2), device=dev)
    local = parallel.shard_llm_params(mesh, params, cfg)
    soft = proj.apply(spec, pp, l2_normalize(torch.as_tensor(embs, device=dev)))
    prefix = torch.as_tensor(PREFIX_IDS, device=dev)[None].expand(PARALLEL_REQUESTS, -1)
    logits, caches = {}, {}
    for name, tree in (("sharded", local), ("whole", params)):
        x = mmmodel.assemble_prompt(cfg, tree, soft, prefix)
        caches[name], logits[name] = dec._prefill_caches(cfg, tree, x, x.shape[1] + 1)
        logits[name] = logits[name].float()
    ref = logits["whole"]
    res["logits_err"] = (logits["sharded"] - ref).abs().max().item()
    res["logits_bound"] = PARALLEL_LOGITS_TOL * max(1.0, ref.abs().max().item())
    # where the shard's prompt pass parts from the whole tree's: the share of
    # this rank's K cache entries (its kv heads) that differ, layer by layer,
    # and of the first tokens
    nkv = local["shard"].nkv_l
    heads = slice(local["shard"].r * nkv, (local["shard"].r + 1) * nkv)
    res["cache_differs"] = [
        (caches["sharded"][0][i] != caches["whole"][0][i][:, heads]).float().mean().item()
        for i in range(cfg.num_hidden_layers)]
    res["first_tokens_equal"] = (logits["sharded"].argmax(-1) == ref.argmax(-1)).float().mean(
    ).item()
    # one column-parallel and one row-parallel product of layer 0 at the
    # prompt pass's shape: the share of outputs that differ from the whole's
    h = torch.randn(PARALLEL_REQUESTS * 16, cfg.hidden_size, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 73)).bfloat16()
    whole_qkv = h @ params["layers"][0]["w_qkv"]
    q_cols = local["shard"].nh_l * cfg.head_dim  # this rank's q columns
    q0 = local["shard"].r * q_cols
    res["column_differs"] = ((h @ local["layers"][0]["w_qkv"])[:, :q_cols]
                             != whole_qkv[:, q0:q0 + q_cols]).float().mean().item()
    # the W4A8 loop from one prompt pass: the whole tree's prompt caches, cut
    # to this rank's kv heads, under the sharded W4A8 tree, against the whole
    # W4A8 tree from the same caches (the row-parallel products sum their
    # integer accumulators, the q8 head merges exact scores)
    q_whole = quantize_llama(params, bits=4)
    q_local = parallel.shard_llm_params(mesh, q_whole, cfg)
    x = mmmodel.assemble_prompt(cfg, params, soft, prefix)
    T = x.shape[1]
    whole_caches, logits0 = dec._prefill_caches(cfg, params, x, T + MAX_NEW)
    local_caches = tuple(c[:, :, heads].contiguous() for c in whole_caches)
    res["w4a8_loop"] = {name: _greedy_loop(torch, cfg, tree, caches, logits0, T)
                        for name, tree, caches in (("sharded", q_local, local_caches),
                                                   ("whole", q_whole, whole_caches))}
    del local, logits, caches, params, q_whole, q_local, whole_caches, local_caches
    torch.cuda.empty_cache()
    res["tiny"] = {shape: _tiny_ids(torch, dev, shape) for shape in PARALLEL_MESHES}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _nccl_two_ranks_worker(rank, world, store, out_dir, device):
    """Two NCCL ranks on one card: expected to be refused."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(device)
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        x = torch.ones(4, device=device)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        outcome = f"accepted (all_reduce gave {x.tolist()})"
    except (RuntimeError, ValueError) as e:  # the refusal this check looks for
        outcome = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:300]}"
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as f:
        f.write(outcome)


def _spawn(torch, fn, world, timeout, dev):
    """fn(rank, world, store, out_dir, device) in `world` processes started
    with spawn, every one on the device dev; returns (out_dir, exit codes).
    Processes still alive at the timeout are terminated (exit code None)."""
    import torch.multiprocessing as tmp

    out_dir = tempfile.mkdtemp(prefix="dmi_parallel_")
    store = os.path.join(out_dir, "store")
    ctx = tmp.start_processes(fn, args=(world, store, out_dir, str(dev)), nprocs=world,
                              join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            if time.perf_counter() >= deadline:
                break
    except tmp.ProcessRaisedException as e:
        raise AssertionError(f"a rank of {fn.__name__} failed: {e}") from e
    codes = []
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return out_dir, codes


def parallel_kernel_phase(torch, dev):
    """The kernels of tensor-parallel serving at Llama-3.2-1B's shard shapes
    at m = 2, each against its twin and timed: decode attention at 16/4
    heads (S 38, B 128), the decode MLP at I 4096, the head + argmax over a
    vocab block of 64128 rows with its scores (the merge's input), and the
    packed W4A8 matmul of a row-parallel w_down shard (K 4096 -> 2048) with
    an f32 output, bit for bit."""
    import torch.nn.functional as F

    from dmi_tpu_torch.models import quant
    from dmi_tpu_torch.ops.cuda import decode_attn as da
    from dmi_tpu_torch.ops.cuda import decode_mlp as dm
    from dmi_tpu_torch.ops.cuda import head_argmax as tha
    from dmi_tpu_torch.ops.cuda import w4_matmul as w4

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    H, I, V, B, S = 2048, 4096, 64128, 128, 38
    results = {}

    print(f"kernel fused_decode_attention at a model rank's heads (16/4, hd 64, B {B}, S {S}):")
    q = _normal(torch, dev, gen, (B, 16, 1, 64)).bfloat16()
    k, v = (_normal(torch, dev, gen, (B, 4, S, 64)).bfloat16() for _ in range(2))
    bias = torch.zeros(S, device=dev)
    args = (q, k, v, bias)
    err = compare(torch, f"B={B} 16/4 S={S} bfloat16", da.fused_decode_attention(*args),
                  da._decode_attn_plain(*args), TOL["bfloat16"])
    t = {**device_times(torch, lambda: da.fused_decode_attention(*args),
                        lambda: da._decode_attn_plain(*args),
                        lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)),
         **least_time(nbytes(q, k, v, bias, q), 4 * B * 16 * S * 64, torch.bfloat16)}
    print(f"    {report_times(t)}; library: scaled_dot_product_attention, GQA; plan "
          f"{da.plan(B, 4, 4, S, 64, 2)}")
    results["decode_attention_tp"] = {"max_abs_err": err, **t}

    print(f"kernel fused_decode_mlp_bl at a model rank's columns (H {H}, I {I}, B {B}, silu):")
    w_gu = _normal(torch, dev, gen, (H, 2 * I), H ** -0.5).bfloat16()
    w_down = _normal(torch, dev, gen, (I, H), I ** -0.5).bfloat16()
    h = _normal(torch, dev, gen, (H, B)).bfloat16()
    args = (w_gu, w_down, h, "silu")
    err = compare(torch, f"H={H} I={I} B={B} bfloat16 silu", dm.fused_decode_mlp_bl(*args),
                  dm._decode_mlp_plain(*args), TOL["bfloat16"])

    def chain():
        g, u = (w_gu.t() @ h).chunk(2, dim=0)
        return w_down.t() @ (F.silu(g) * u)

    t = {**device_times(torch, lambda: dm.fused_decode_mlp_bl(*args),
                        lambda: dm._decode_mlp_plain(*args), chain),
         **least_time(nbytes(w_gu, w_down, h, h), 2 * B * 3 * H * I, torch.bfloat16)}
    print(f"    {report_times(t)}; library: matmul, silu * mul, matmul; plan "
          f"{dm.plan(H, I, dm.padded_batch(B))}")
    results["decode_mlp_tp"] = {"max_abs_err": err, **t}

    print(f"kernel head_argmax bf16 over a vocab block (V {V}, H {H}, B {B}) with its scores:")
    params = {"embed": _normal(torch, dev, gen, (V, H)).bfloat16()}
    h = _normal(torch, dev, gen, (H, B)).bfloat16()
    gap = head_check(torch, tha, f"bf16 V={V} B={B}", params, h, "bf16")
    ids, scores = tha.head_argmax(params, h, scores=True)
    logits = tha.head_logits_bl(params["embed"], h).float()
    if not torch.equal(ids, tha.head_argmax(params, h)):
        raise AssertionError("head argmax: the ids with scores differ from the ids alone")
    # each column's score is its own id's logit, rounded as the kernel rounds
    mine = logits.gather(0, ids[None])[0]
    rel = ((scores - mine).abs() / mine.abs().clamp(min=1e-30)).max().item()
    print(f"  scores against the twin's logit of the same id: largest relative difference "
          f"{rel!r} (bound {2.0 ** -7!r})")
    if rel > 2.0 ** -7 or not bool(torch.isfinite(scores).all()):
        raise AssertionError("head argmax: the scores are not the logits of the ids")
    t = {**device_times(torch, lambda: tha.head_argmax(params, h, scores=True),
                        lambda: tha._head_argmax_plain(params["embed"], h, scores=True),
                        lambda: (params["embed"] @ h).max(dim=0)),
         **least_time(nbytes(params["embed"], h) + 8 * B, 2 * V * H * B, torch.bfloat16)}
    print(f"    {report_times(t)}; library: matmul, max (values and ids)")
    results["head_argmax_tp"] = {"max_abs_err": gap, **t}

    K, out_dim = 2 * I // 2, H
    print(f"kernel w4_mm_bl f32 output at a row-parallel w_down shard (K {K}, out {out_dim}, "
          f"B {B}), bit for bit:")
    w = quant.quantize_tensor_int4(_normal(torch, dev, gen, (K, out_dim), 0.02))
    hq, a = quant.quantize_act(_normal(torch, dev, gen, (K, B)), axis=0)
    out = w4.w4_mm_bl(w, hq, a, torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(out, w4._w4_mm_plain(w, hq, a, torch.float32)):
        raise AssertionError("w4_mm_bl f32: kernel differs from its plain twin")
    hq_t = hq.t().contiguous()
    t = {**device_times(
        torch, lambda: w4.w4_mm_bl(w, hq, a, torch.float32),
        lambda: w4._w4_mm_plain(w, hq, a, torch.float32),
        lambda: torch._int_mm(hq_t, quant.unpack_w4(w["qp"])).t().float()
        * w["s"].reshape(-1, 1) * a),
         **least_time(nbytes(w["qp"], w["s"], hq, a) + 4 * out_dim * B, 2 * K * out_dim * B,
                      "int8")}
    print(f"    bit-equal; {report_times(t)}; library: unpack, torch._int_mm, rescale; plan "
          f"{ {k: v for k, v in w4.plan(K, out_dim, B, True).items() if k in ('splits', 'grid')} }")
    results["w4_mm_tp_f32"] = {"max_abs_err": 0.0, **t}
    return results


def parallel_phase(torch, dev) -> dict:
    """Tensor- and data-parallel serving at Llama-3.2-1B's full width:
    (a) a one-rank NCCL mesh (1, 1) in this process, its greedy ids bit-equal
    to the unsharded run's; (b) NCCL with two ranks on this one card (refused,
    printed); (c) two worker processes on cuda:0 over gloo (_parallel_worker)
    at (1, 2) and (2, 1): launch counts, token agreement with the one-rank
    runs held to TOKEN_AGREEMENT, the first step's logits within
    PARALLEL_LOGITS_TOL, and a tiny f32 model's ids identical to one rank's.
    Prints captions/s beside the one-rank runs and the share of the wall
    time inside the collectives; returns the workers' launch counts by
    path."""
    import socket

    import torch.distributed as dist

    from dmi_tpu_torch import parallel

    cfg, params, spec, pp, embs = _parallel_model(torch, dev)
    L, steps = cfg.num_hidden_layers, MAX_NEW - 1
    one = {}
    for label, kw, ckw in PARALLEL_RUNS:
        cap = _parallel_captioner(cfg, params, spec, pp, **kw)
        cap.caption_ids(embs, **ckw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one[label] = (cap.caption_ids(embs, **ckw), time.perf_counter() - t0)
        del cap
    tiny_one = _tiny_ids(torch, dev)

    with socket.socket() as s:  # a free port on this machine for the one-rank store
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    parallel.init_distributed(init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                              backend="nccl")
    try:
        cap = _parallel_captioner(cfg, params, spec, pp, mesh_shape=(1, 1))
        cap.caption_ids(embs)  # warm-up
        _reset_counts()
        ids = cap.caption_ids(embs)
        counts = _counts()
        del cap
    finally:
        dist.destroy_process_group()
    equal = torch.equal(ids, one["bf16"][0])
    print(f"parallel (a) one-rank NCCL mesh (1, 1): greedy ids bit-equal to the unsharded run: "
          f"{equal}")
    if not equal:
        raise AssertionError("the one-rank mesh's ids differ from the unsharded run's")
    per_batch = {"mlp2": 1, "decode_attention": L * steps, "decode_mlp": L * steps,
                 "head_argmax": steps}
    _expect("parallel (1, 1) bf16", counts, per_batch)
    paths = {"parallel (1, 1) bf16": counts}
    base = _bits_sum(torch, params["embed"])
    del params
    torch.cuda.empty_cache()

    out_dir, codes = _spawn(torch, _nccl_two_ranks_worker, 2, 120, dev)
    outcomes = []
    for r in range(2):
        path = os.path.join(out_dir, f"nccl{r}.txt")
        outcomes.append(open(path).read() if os.path.exists(path) else
                        f"no outcome (exit code {codes[r]})")
    print(f"parallel (b) NCCL with two ranks on {dev}: {outcomes}")

    t0 = time.perf_counter()
    out_dir, codes = _spawn(torch, _parallel_worker, 2, PARALLEL_TIMEOUT, dev)
    if codes != [0, 0]:
        raise AssertionError(f"parallel (c): the gloo workers exited with {codes}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    probe = ranks[0]["gloo_cuda"]
    print(f"parallel (c) two gloo ranks on {dev}, {time.perf_counter() - t0!r} s with set-up; "
          f"gloo takes {dev.type} tensors directly: {probe}; staged through host memory "
          f"by parallel/collectives.py: none")
    if not all(v is True for v in probe.values()):
        raise AssertionError(f"gloo refused {dev.type} tensors, which collectives hands it "
                             f"unstaged: {probe}")
    if any(r["checksum"] != base for r in ranks):
        raise AssertionError("the workers built other weights than this process")
    failures = []
    want = {"bf16": per_batch,
            "w4a8": {"mlp2": 1, "decode_attention": L * steps, "head_argmax": steps,
                     "w4_mm": 4 * L * steps, "w4_mm_f32": 2 * L * steps}}
    for name, run in ranks[0]["runs"].items():
        label = name.split()[-1]
        ref, one_secs = one[label]
        for r, rank in enumerate(ranks):
            mine = rank["runs"][name]
            if not torch.equal(mine["ids"], run["ids"]):
                raise AssertionError(f"parallel {name}: ranks 0 and {r} return other ids")
            if label == "bulk":
                n = mine["steps"]
                expect = {"mlp2": mine["admissions"], "decode_attention": L * n,
                          "decode_attention_rows": L * n, "decode_mlp": L * n,
                          "head_argmax": n}
            else:
                expect = want[label]
            _expect(f"parallel {name} rank {r}", mine["counts"],
                    {k: expect.get(k, 0) for k in mine["counts"]})
        ids = run["ids"]
        if tuple(ids.shape) != tuple(ref.shape) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"parallel {name}: ids {tuple(ids.shape)} out of range")
        if label == "w4a8":
            # printed, not held: W4A8 on random weights turns the prompt
            # pass's last-bit differences (summation order) into other tokens
            # on most rows, as its own plain path does at one rank; its loop
            # is held bit for bit from one prompt pass below
            agree = (ids == ref).float().mean().item()
            print(f"  token agreement with one rank ({name}): {agree!r} (printed; rows "
                  f"identical {(ids == ref).all(dim=1).float().mean().item()!r}, first "
                  f"tokens equal {(ids[:, 0] == ref[:, 0]).float().mean().item()!r})")
        else:
            try:
                agree = token_agreement(f"one rank ({name})", ids, ref)
            except AssertionError as e:  # every measurement prints before the phase fails
                failures.append(str(e))
                agree = (ids == ref).float().mean().item()
        share = max(rk["runs"][name]["collective_secs"] / rk["runs"][name]["secs"]
                    for rk in ranks)
        print(f"  parallel {name}: {PARALLEL_REQUESTS / run['secs']!r} captions/s (one rank: "
              f"{PARALLEL_REQUESTS / one_secs!r}); host wall time inside the collective "
              f"calls (gloo's waits for the kernels queued before them included): "
              f"{share!r} of the run; agreement {agree!r}")
        paths[f"parallel {name}"] = run["counts"]
    err, bound = ranks[0]["logits_err"], ranks[0]["logits_bound"]
    print(f"parallel (1, 2): the first step's logits against the whole tree's: max_abs_err "
          f"{err!r} (bound {bound!r}); first tokens equal {ranks[0]['first_tokens_equal']!r}; "
          f"share of the prompt pass's K cache entries that differ, layer by layer "
          f"{ranks[0]['cache_differs']}; share of a column-parallel product's outputs (layer "
          f"0's q columns at the prompt pass's shape) that differ from the whole product's "
          f"{ranks[0]['column_differs']!r}")
    if err > bound:
        failures.append("parallel (1, 2): the first step's logits disagree")
    loops = ranks[0]["w4a8_loop"]
    same = torch.equal(loops["sharded"], loops["whole"])
    print(f"parallel (1, 2) w4a8: the token loop from the whole tree's prompt pass, sharded "
          f"against whole: ids bit-equal {same} (token agreement "
          f"{(loops['sharded'] == loops['whole']).float().mean().item()!r})")
    if not same:
        failures.append("parallel (1, 2) w4a8: the loop from one prompt pass differs")
    for shape, ids in ranks[0]["tiny"].items():
        same = torch.equal(ids, tiny_one)
        print(f"parallel {shape} tiny f32: ids identical to one rank's: {same} "
              f"({len(torch.unique(ids))} distinct tokens)")
        if not same or any(not torch.equal(rk["tiny"][shape], ids) for rk in ranks):
            failures.append(f"parallel {shape} tiny f32: the ids differ from one rank's")
    if failures:
        raise AssertionError(f"parallel phase: {failures}")
    return paths


# ---------------------------------------------------------------------------
# Training on a mesh (ROADMAP A.10b)
# ---------------------------------------------------------------------------

PT_STEPS = 4  # stage-1 micro-steps of the parallel training runs, one update each
PT_HN_STEPS = 2  # stage-2 micro-steps (inside one accumulation window)
PT_TIMEOUT = 900  # seconds the training workers may take, set-up included
PT_TINY = dict(batch=4, text=24, mm=16)  # the tiny f32 runs' data
PT_ARGS = dict(TRAIN_ARGS, gradient_accumulation_steps=1)
PT_TINY_DROPOUT = 0.1  # the tiny runs draw dropout: a data rank's rows get one rank's mask
# the hypernet's key bias has a gradient of 0 in exact arithmetic (see
# hypernet_phase): held to the bound of the key weight's
PT_ZERO = {"attn.k.b": "attn.k.w"}


def _pt_stage1(torch, dev, cfg, params, mesh_shape=None, tmp="."):
    """A stage-1 ProjectorTrainer at projector/v1's shapes on the full-width
    model (train_phase's projector from SEED + 4), and its data."""
    import types

    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer

    spec = proj.ProjectorSpec(mm_dim=TRAIN_MM_DIM, lm_dim=cfg.hidden_size,
                              dropout=TRAIN_DROPOUT)
    pp = proj.init(spec, torch.Generator(device=dev).manual_seed(SEED + 4), device=dev)
    data = SyntheticCaptions(PT_STEPS, mm=spec.mm_dim, vocab=cfg.vocab_size)
    args = types.SimpleNamespace(**dict(PT_ARGS, mesh_shape=mesh_shape), checkpoint_dir=tmp)
    trainer = ProjectorTrainer("smoke-mesh", cfg, params, spec, pp, [data],
                               [EmbeddingManager("smoke-encoder", device=dev)], None, args)
    return trainer, [(0, data.train_batch(s)) for s in range(PT_STEPS)]


def _pt_stage2(torch, dev, cfg, params, mesh_shape=None, tmp="."):
    """A stage-2 HypernetTrainer at hypernet/v4's shapes (hypernet_phase's
    hypernet from SEED + 8, the frozen projector), and its batches."""
    import types

    from dmi_tpu_torch.models import hypernet as hn
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer

    spec, frozen = frozen_projector(torch, dev)
    hspec = hn.HypnetSpec(**HN_SPEC)
    hparams = hn.init(hspec, torch.Generator(device=dev).manual_seed(SEED + 8), device=dev)
    data = SyntheticCaptions(PT_HN_STEPS, batch=HN_BATCH, text=HN_TEXT, mm=spec.mm_dim,
                             subset=HN_SUBSET, stream=7, vocab=cfg.vocab_size)
    args = types.SimpleNamespace(**dict(HN_ARGS, mesh_shape=mesh_shape), checkpoint_dir=tmp)
    trainer = HypernetTrainer("smoke-mesh-hypernet", cfg, params, spec, frozen, hspec, hparams,
                              [data], [EmbeddingManager("smoke-encoder", device=dev)], [], [],
                              None, args, types.SimpleNamespace(**FEWSHOT))
    return trainer, [trainer.fetch_batch(s) for s in range(PT_HN_STEPS)]


def _pt_tiny(torch, dev, mesh_shape=None, tmp="."):
    """A stage-1 ProjectorTrainer on the tiny f32 model of the parallel
    phase (_parallel_tiny), dropout on, and its batches."""
    import types

    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer

    cfg, params, spec, pp, _ = _parallel_tiny(torch, dev)
    spec = dataclasses.replace(spec, dropout=PT_TINY_DROPOUT)
    data = SyntheticCaptions(PT_STEPS, batch=PT_TINY["batch"], text=PT_TINY["text"],
                             mm=PT_TINY["mm"], stream=17, vocab=cfg.vocab_size)
    args = types.SimpleNamespace(**dict(PT_ARGS, mesh_shape=mesh_shape), checkpoint_dir=tmp)
    trainer = ProjectorTrainer("smoke-mesh-tiny", cfg, params, spec, pp, [data],
                               [EmbeddingManager("smoke-encoder", device=dev)], None, args)
    return trainer, [(0, data.train_batch(s)) for s in range(PT_STEPS)], (cfg, params)


def _pt_step0(torch, trainer, loss_fn):
    """Step 0's global loss and trainable gradients by leaf name (summed over
    the data ranks on a mesh), without touching the trainer's
    accumulators."""
    from dmi_tpu_torch.training import mesh as tm
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    names = [n for n, _ in named_leaves(trainer.params)]
    part = loss_fn()
    grads = torch.autograd.grad(part, trainer.leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(trainer.leaves, grads)]
    if trainer.shard is not None:
        trainer.shard.reduce_grads(grads)
    return (tm.global_value(trainer.shard, part.detach()).float().cpu(),
            {n: g.cpu() for n, g in zip(names, grads)})


def _pt_run(torch, trainer, batches, steps, total):
    """`steps` timed train_steps; returns (losses, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_step(s, total, batches[s])[0] for s in range(steps)]
    torch.cuda.synchronize()
    return torch.stack(losses).float().cpu(), time.perf_counter() - t0


def _parallel_train_worker(rank, world, store, out_dir, device):
    """One rank of the training world on cuda:0 over gloo: stage 1 and
    stage 2 at full width and the tiny f32 runs at each mesh of
    PARALLEL_MESHES (step 0's loss and gradients, the timed micro-steps,
    launch counts, wall time inside the collectives), an eval loss at each
    mesh, and a DCP checkpoint at (1, 2); saved to out_dir/train{rank}.pt."""
    import torch
    import torch.distributed as dist

    from dmi_tpu_torch import parallel
    from dmi_tpu_torch.parallel import collectives
    from dmi_tpu_torch.training import checkpoint as ckpt
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    parallel.init_distributed(init_method=f"file://{store}", rank=rank, world_size=world,
                              backend="gloo")
    spent = [0.0]

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            return out
        return run

    collectives.all_reduce = timed(collectives.all_reduce)
    collectives.all_gather = timed(collectives.all_gather)
    cfg, params, _, _, _ = _parallel_model(torch, dev)
    res = {"checksum": _bits_sum(torch, params["embed"]), "runs": {}}

    def record(label, make, steps, total):
        """Step 0 and a warm-up step on one trainer, the timed run on a
        fresh one (the one-rank run's order); returns the latter."""
        trainer, batches = make()
        loss0, grads0 = _pt_step0(torch, trainer, lambda: trainer.micro_loss(0, batches[0]))
        trainer.train_step(0, total, batches[0])
        del trainer
        trainer, batches = make()
        _reset_counts()
        spent[0] = 0.0
        losses, secs = _pt_run(torch, trainer, batches, steps, total)
        res["runs"][label] = {"loss0": loss0, "grads0": grads0, "losses": losses, "secs": secs,
                              "collective_secs": spent[0], "counts": _counts()}
        return trainer, batches

    with tempfile.TemporaryDirectory() as tmp:
        for shape in PARALLEL_MESHES:
            trainer, batches = record(f"{shape} stage 1", lambda: _pt_stage1(
                torch, dev, cfg, params, shape, tmp), PT_STEPS, PT_STEPS)
            batch = batches[0][1]
            _reset_counts()
            ev = trainer.eval_loss(trainer.emb_mgrs[0].get_embeddings(batch["embs"]),
                                   *trainer._device_batch(batch))
            res["runs"][f"{shape} eval"] = {"loss": ev.float().cpu(), "counts": _counts()}
            trained = trainer.param_tree()
            del trainer
            torch.cuda.empty_cache()

            trainer, _ = record(f"{shape} stage 2", lambda: _pt_stage2(
                torch, dev, cfg, params, shape, tmp), PT_HN_STEPS, 10**9)
            del trainer
            torch.cuda.empty_cache()

            trainer, batches, (tcfg, tparams) = _pt_tiny(torch, dev, shape, tmp)
            res["runs"][f"{shape} tiny"] = {
                "losses": _pt_run(torch, trainer, batches, PT_STEPS, PT_STEPS)[0]}
            if shape == (1, 2):
                # the sharded tiny tree and the full-width trained projector
                # through a torch.distributed.checkpoint directory both ranks share
                tree = {"llm": trainer.llm_params, "proj": trained, "step": PT_STEPS}
                path = os.path.join(out_dir, "dcp")
                t0 = time.perf_counter()
                ckpt.save_pytree_dcp(path, tree)
                back = ckpt.load_pytree_dcp(path, ckpt.sharded_like(tree))
                torch.cuda.synchronize()
                pairs = [(a, b) for part in ("llm", "proj")
                         for (_, a), (_, b) in zip(named_leaves(tree[part]),
                                                   named_leaves(back[part]))
                         if torch.is_tensor(a)]
                res["dcp"] = {"bit_equal": back["step"] == PT_STEPS and all(
                    a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
                    "leaves": len(pairs), "secs": time.perf_counter() - t0,
                    "files": sorted(os.listdir(path))}
            del trainer
    del params
    torch.save(res, os.path.join(out_dir, f"train{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def parallel_train_kernel_phase(torch, dev):
    """The kernels of training on a mesh at their shard shapes, each against
    its twin and timed: the three flash kernels at a model rank's heads of
    Llama-3.2-1B at m = 2 (16/4, hd 64, B 32, T 65; 8/2 of m = 4 held too),
    mlp2 at a data rank's rows of the stage-1 eval batch at d = 2 (B 16, mm
    768) and lora0 at a data rank's rows of stage 2 at d = 2 (B 2)."""
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.ops import l2_normalize
    from dmi_tpu_torch.ops.cuda import flash_attn as fa
    from dmi_tpu_torch.ops.cuda import lora0 as l0
    from dmi_tpu_torch.ops.cuda import projector as pk

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    B, T, hd = TRAIN_BATCH, TRAIN_TEXT + 1, FLASH_HEADS[2]
    results, errs = {}, {"fwd": [], "dkv": [], "dq": []}
    times = None
    for nh, nkv in ((FLASH_HEADS[0] // 2, FLASH_HEADS[1] // 2),
                    (FLASH_HEADS[0] // 4, FLASH_HEADS[1] // 4)):
        print(f"kernels flash attention at a model rank's heads ({nh}/{nkv}, hd {hd}, B {B}, "
              f"T {T}, bf16, causal):")
        q, k, v = (torch.randn(B, T, n, hd, generator=gen, device=dev).bfloat16()
                   .transpose(1, 2).requires_grad_() for n in (nh, nkv, nkv))
        do = torch.randn(B, nh, T, hd, generator=gen, device=dev).bfloat16()
        out = fa.flash_attention(q, k, v, None, 0.125)
        ref = fa._flash_attn_plain(q, k, v, None, 0.125)
        got = torch.autograd.grad(out, (q, k, v), do)
        want = torch.autograd.grad(ref, (q, k, v), do)
        errs["fwd"].append(compare(torch, "out", out.detach(), ref.detach(), TOL["bfloat16"]))
        errs["dq"].append(compare(torch, "dq", got[0], want[0], GRAD_TOL["bfloat16"]))
        errs["dkv"].append(max(compare(torch, "dk", got[1], want[1], GRAD_TOL["bfloat16"]),
                               compare(torch, "dv", got[2], want[2], GRAD_TOL["bfloat16"])))
        if times is None:  # m = 2's shard: the kernels line
            times = flash_timings(torch, fa, *(x.detach() for x in (q, k, v)), do)
            for name, kt in times.items():
                print(f"    {name} {nh}/{nkv}: {report_times(kt)}; library: "
                      "scaled_dot_product_attention, causal, GQA")
    for part, name in (("fwd", "flash_fwd"), ("dkv", "flash_bwd_dkv"), ("dq", "flash_bwd_dq")):
        results[f"{name}_tp"] = {"max_abs_err": max(errs[part]), **times[name]}

    rows = TRAIN_BATCH // 2
    print(f"kernel fused_mlp2 at a data rank's rows (B {rows}, mm {TRAIN_MM_DIM}, lm 2048, f32):")
    spec = proj.ProjectorSpec(mm_dim=TRAIN_MM_DIM, lm_dim=2048)
    p = proj.init(spec, gen, device=dev)["layers"]
    x = l2_normalize(torch.randn(rows, TRAIN_MM_DIM, generator=gen, device=dev))
    args = (x, p[0]["w"], p[0]["b"], p[1]["w"], p[1]["b"])
    err = compare(torch, f"B={rows}", pk.fused_mlp2(*args), pk._mlp2_plain(*args),
                  TOL["float32"])
    t = {**device_times(torch, lambda: pk.fused_mlp2(*args), lambda: pk._mlp2_plain(*args),
                        lambda: torch.addmm(p[1]["b"], torch.nn.functional.gelu(
                            torch.addmm(p[0]["b"], x, p[0]["w"]), approximate="tanh"),
                            p[1]["w"])),
         **least_time(nbytes(*args) + rows * 2048 * 4,
                      2 * rows * (p[0]["w"].numel() + p[1]["w"].numel()), torch.float32)}
    print(f"    {report_times(t)}; library: addmm, gelu, addmm")
    results["mlp2_dp"] = {"max_abs_err": err, **t}

    rows = HN_BATCH // 2
    mm, lm, r = TRAIN_MM_DIM, 2048, HN_RANK
    print(f"kernel fused_lora_layer0 at a data rank's rows (B {rows}, mm {mm}, lm {lm}, r {r}, "
          "f32):")
    shapes = [(rows, mm), (mm, lm), (lm,), (mm, r), (r, lm), (lm,)]
    scales = [1.0, mm ** -0.5, 0.1, mm ** -0.5, r ** -0.5, 0.1]
    call = [torch.randn(sh, generator=gen, device=dev) * c for sh, c in zip(shapes, scales)]
    x, w0, b0, A, Bm, d = call
    err = compare(torch, f"B={rows}", l0.fused_lora_layer0(*call), l0._lora0_plain(*call),
                  TOL["float32"])
    t = {**device_times(torch, lambda: l0.fused_lora_layer0(*call),
                        lambda: l0._lora0_plain(*call),
                        lambda: torch.nn.functional.gelu(
                            torch.addmm(torch.addmm(b0 + d, x, w0), x @ A, Bm),
                            approximate="tanh")),
         **least_time(nbytes(*call) + rows * lm * 4, 2 * rows * (mm * lm + mm * r + r * lm),
                      torch.float32)}
    print(f"    {report_times(t)}; library: add, addmm, matmul, addmm, gelu")
    results["lora0_dp"] = {"max_abs_err": err, **t}
    row_parallel_products(torch, dev, gen)
    return results


def row_parallel_products(torch, dev, gen) -> None:
    """Device time of the row-parallel products of one stage-1 micro-step on
    one rank at (1, 2) (Llama-3.2-1B's wo 1024 -> 2048 and w_down 4096 ->
    2048 shards, B 32, T 65, every layer), as llama._mm computes them on the
    training path: the bf16 activations and weight shard cast to f32, the
    f32 product forward, the f32 product of the output gradient with the
    weight shard backward, cast to bf16 (the weights are frozen: no dW);
    beside the same two products in bf16.  Prints both; a card holding two
    ranks runs twice this a micro-step."""
    L, rows, H = 16, TRAIN_BATCH * (TRAIN_TEXT + 1), 2048
    parts = []
    for k in (H // 2, 2 * H):  # wo's and w_down's contraction at m = 2 (I 8192 / 2)
        h = torch.randn(rows, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, H, generator=gen, device=dev) * k ** -0.5).bfloat16()
        g = torch.randn(rows, H, generator=gen, device=dev).bfloat16()
        parts.append((h, w, g))

    def f32():
        for h, w, g in parts:
            wf = w.float()
            h.float() @ wf
            (g.float() @ wf.t()).bfloat16()

    def bf16():
        for h, w, g in parts:
            h @ w
            g @ w.t()

    ms32, ms16 = device_ms(f32), device_ms(bf16)
    flops = 2 * 2 * rows * H * sum(h.shape[1] for h, _, _ in parts)
    print(f"row-parallel products of a (1, 2) stage-1 micro-step on one rank ({L} layers, wo "
          f"and w_down shards, B*T {rows}, forward and input-gradient products): f32 as "
          f"llama._mm computes them on the training path (casts included) {L * ms32!r} ms, "
          f"{flops / ms32 / 1e9!r} TFLOP/s; the same products in bf16 {L * ms16!r} ms, "
          f"{flops / ms16 / 1e9!r} TFLOP/s")


def parallel_train_phase(torch, dev) -> dict:
    """Training on a mesh at Llama-3.2-1B's full width: (a) a one-rank NCCL
    mesh (1, 1) in this process, whose stage-1 step 0 (loss and projector
    gradients) and PT_STEPS micro-steps (losses and the projector after
    them) are bit-equal to the unsharded trainer's; (b) two gloo worker
    processes on cuda:0 (_parallel_train_worker) at (1, 2) and (2, 1): stage
    1 and stage 2's step-0 loss within TOL["loss"] of one rank's and every
    gradient leaf within TOL["logits"] of its largest one-rank gradient,
    their micro-steps/s beside one rank's and the share of the wall inside
    the collectives, launch counts of the flash kernels, mlp2 and lora0 on
    both ranks; (c) the tiny f32 model's losses over PT_STEPS updates (with
    dropout) equal to one rank's to 1e-5 relative; (d) a DCP checkpoint
    saved and read back across the workers bit for bit.  Returns the
    workers' launch counts by path."""
    import socket

    import torch.distributed as dist

    from dmi_tpu_torch import parallel

    cfg, params, _, _, _ = _parallel_model(torch, dev)
    L = cfg.num_hidden_layers
    one = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer, batches = _pt_stage1(torch, dev, cfg, params, tmp=tmp)
        one["stage 1 step 0"] = _pt_step0(torch, trainer, lambda: trainer.micro_loss(
            0, batches[0]))
        trainer.train_step(0, PT_STEPS, batches[0])  # warm-up
        trainer.opt.zero_grad(set_to_none=True)
        # the timed run from the same start as the (1, 1) run below
        t1, batches = _pt_stage1(torch, dev, cfg, params, tmp=tmp)
        del trainer
        one["stage 1"] = _pt_run(torch, t1, batches, PT_STEPS, PT_STEPS)
        one["stage 1 params"] = [t.detach().clone() for t in t1.leaves]
        del t1
        trainer, hbatches = _pt_stage2(torch, dev, cfg, params, tmp=tmp)
        one["stage 2 step 0"] = _pt_step0(torch, trainer, lambda: trainer.micro_loss(
            0, hbatches[0]))
        trainer.train_step(0, 10**9, hbatches[0])  # warm-up
        trainer.opt.zero_grad(set_to_none=True)
        one["stage 2"] = _pt_run(torch, trainer, hbatches, PT_HN_STEPS, 10**9)
        del trainer
        trainer, tbatches, _ = _pt_tiny(torch, dev, tmp=tmp)
        one["tiny"] = _pt_run(torch, trainer, tbatches, PT_STEPS, PT_STEPS)[0]
        del trainer
        torch.cuda.empty_cache()

        with socket.socket() as s:  # a free port on this machine for the one-rank store
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        parallel.init_distributed(init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                                  backend="nccl")
        try:
            mesh_t, batches = _pt_stage1(torch, dev, cfg, params, (1, 1), tmp)
            loss0, grads0 = _pt_step0(torch, mesh_t, lambda: mesh_t.micro_loss(0, batches[0]))
            losses, _ = _pt_run(torch, mesh_t, batches, PT_STEPS, PT_STEPS)
            final = [t.detach().clone() for t in mesh_t.leaves]
            del mesh_t
        finally:
            dist.destroy_process_group()
    ref_loss0, ref_grads0 = one["stage 1 step 0"]
    equal = {"step-0 loss": torch.equal(loss0, ref_loss0),
             "step-0 gradients": all(torch.equal(grads0[n], g) for n, g in ref_grads0.items()),
             "losses": torch.equal(losses, one["stage 1"][0]),
             "projector after the run": all(torch.equal(a, b) for a, b in
                                            zip(final, one["stage 1 params"]))}
    print(f"parallel training (a) one-rank NCCL mesh (1, 1), stage 1 ({PT_STEPS} micro-steps, "
          f"B {TRAIN_BATCH}, T {TRAIN_TEXT + 1}): bit-equal to the unsharded trainer: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"the one-rank training mesh differs from the unsharded run: "
                             f"{equal}")
    base = _bits_sum(torch, params["embed"])
    del params, final, one["stage 1 params"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out_dir, codes = _spawn(torch, _parallel_train_worker, 2, PT_TIMEOUT, dev)
    if codes != [0, 0]:
        raise AssertionError(f"parallel training (b): the gloo workers exited with {codes}")
    ranks = [torch.load(os.path.join(out_dir, f"train{r}.pt"), weights_only=False)
             for r in range(2)]
    print(f"parallel training (b) two gloo ranks on {dev}: {time.perf_counter() - t0!r} s "
          "with set-up")
    if any(r["checksum"] != base for r in ranks):
        raise AssertionError("the training workers built other weights than this process")
    failures, paths = [], {}
    want = {"stage 1": {k: L * PT_STEPS for k in ("flash_fwd", "flash_bwd_dkv",
                                                   "flash_bwd_dq")},
            "stage 2": {"lora0": PT_HN_STEPS,
                        **{k: L * PT_HN_STEPS for k in ("flash_fwd", "flash_bwd_dkv",
                                                        "flash_bwd_dq")}},
            "eval": {"mlp2": 1, "flash_fwd": L}}
    steps = {"stage 1": PT_STEPS, "stage 2": PT_HN_STEPS}
    for shape in PARALLEL_MESHES:
        for stage in ("stage 1", "stage 2"):
            name = f"{shape} {stage}"
            run = ranks[0]["runs"][name]
            ref_loss0, ref_grads0 = one[f"{stage} step 0"]
            print(f"parallel training {name}:")
            for r, rank in enumerate(ranks):
                mine = rank["runs"][name]
                _expect(f"parallel training {name} rank {r}", mine["counts"], want[stage])
                if not torch.equal(mine["losses"], run["losses"]):
                    failures.append(f"{name}: ranks 0 and {r} report other losses")
            try:
                compare(torch, "step-0 loss against one rank", run["loss0"], ref_loss0,
                        TOL["loss"])
                for n, gr in ref_grads0.items():
                    g = run["grads0"][n]
                    compare(torch, f"step-0 gradient {n} {tuple(g.shape)}", g, gr,
                            TOL["logits"], scale=ref_grads0[PT_ZERO.get(n, n)].abs().max().item())
            except AssertionError as e:  # every measurement prints before the phase fails
                failures.append(f"{name}: {e}")
            ref_secs = one[stage][1]
            share = max(rk["runs"][name]["collective_secs"] / rk["runs"][name]["secs"]
                        for rk in ranks)
            print(f"  {steps[stage] / run['secs']!r} micro-steps/s (one rank: "
                  f"{steps[stage] / ref_secs!r}); host wall time inside the collective "
                  f"calls (gloo's waits for the kernels queued before them included): "
                  f"{share!r} of the run; losses {run['losses'].tolist()} (one rank "
                  f"{one[stage][0].tolist()})")
            paths[f"parallel train {name}"] = run["counts"]
        name = f"{shape} eval"
        for r, rank in enumerate(ranks):
            _expect(f"parallel training {name} rank {r}", rank["runs"][name]["counts"],
                    want["eval"])
        print(f"parallel training {name}: loss {ranks[0]['runs'][name]['loss'].item()!r}")
        paths[f"parallel train {name}"] = ranks[0]["runs"][name]["counts"]
        tiny = ranks[0]["runs"][f"{shape} tiny"]["losses"]
        rel = ((tiny - one["tiny"]).abs() / one["tiny"].abs()).max().item()
        print(f"parallel training (c) {shape} tiny f32, dropout {PT_TINY_DROPOUT}: losses over "
              f"{PT_STEPS} updates {tiny.tolist()} against one rank's {one['tiny'].tolist()}: "
              f"largest relative difference {rel!r} (bound 1e-5)")
        if rel > 1e-5:
            failures.append(f"{shape} tiny: losses differ from one rank's")
    dcp = [rk["dcp"] for rk in ranks]
    print(f"parallel training (d) DCP checkpoint at (1, 2) (the sharded tiny tree and the "
          f"trained projector): restored bit for bit {[d['bit_equal'] for d in dcp]}, "
          f"{dcp[0]['leaves']} leaves, save + load {max(d['secs'] for d in dcp)!r} s, files "
          f"{dcp[0]['files']}")
    if not all(d["bit_equal"] for d in dcp):
        failures.append("the DCP checkpoint did not restore bit for bit")
    if failures:
        raise AssertionError(f"parallel training phase: {failures}")
    return paths


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
    paths.update(hub_phase(torch, dev, cfg, params))
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
    kernels.update(parallel_kernel_phase(torch, dev))
    paths.update(parallel_phase(torch, dev))
    kernels.update(parallel_train_kernel_phase(torch, dev))
    paths.update(parallel_train_phase(torch, dev))
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
               "block_mm_bf16": ("block_mm bf16", "dmi_tpu_torch/csrc/block_mm.cu",
                                 "scripts/profile_int8_mxu.py:74 (pallas_mm)", "probes",
                                 "block_mm_bf16"),
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
                                      "head_argmax"),
               "decode_attention_tp": ("fused_decode_attention at a model rank's heads (16/4 of "
                                       "Llama-3.2-1B at m 2; launches: rank 0 of (1, 2))",
                                       "dmi_tpu_torch/csrc/decode_attn.cu",
                                       "dmi_tpu/ops/pallas/decode_attn.py:121",
                                       "parallel (1, 2) bf16", "decode_attention"),
               "decode_mlp_tp": ("fused_decode_mlp_bl at a model rank's columns (H 2048, I 4096)",
                                 "dmi_tpu_torch/csrc/decode_mlp.cu",
                                 "dmi_tpu/ops/pallas/decode_mlp.py:97", "parallel (1, 2) bf16",
                                 "decode_mlp"),
               "head_argmax_tp": ("head_argmax bf16 over a vocab block (V 64128, H 2048) with "
                                  "its scores, merged over the model group", *head,
                                  "parallel (1, 2) bf16", "head_argmax"),
               "w4_mm_tp_f32": ("w4_mm_bl with an f32 output at a row-parallel w_down shard "
                                "(K 4096 -> 2048; launches: the f32-output ones of (1, 2) w4a8)",
                                *int8_mm, "parallel (1, 2) w4a8", "w4_mm_f32"),
               "flash_fwd_tp": ("flash_attention forward at a model rank's heads (16/4 of "
                                "Llama-3.2-1B at m 2, B 32, T 65; launches: rank 0 of stage 1 "
                                "at (1, 2))", "dmi_tpu_torch/csrc/flash_attn_fwd.cu",
                                f"dmi_tpu/models/llama.py:1086 ({flash}:758 "
                                "_flash_attention_impl)", "parallel train (1, 2) stage 1",
                                "flash_fwd"),
               "flash_bwd_dkv_tp": ("flash_attention backward dK/dV at a model rank's heads "
                                    "(16/4, B 32, T 65)", "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                    f"dmi_tpu/models/llama.py:1086 ({flash}:1121 "
                                    "_flash_attention_bwd_dkv)", "parallel train (1, 2) stage 1",
                                    "flash_bwd_dkv"),
               "flash_bwd_dq_tp": ("flash_attention backward dQ at a model rank's heads (16/4, "
                                   "B 32, T 65)", "dmi_tpu_torch/csrc/flash_attn_bwd.cu",
                                   f"dmi_tpu/models/llama.py:1086 ({flash}:1456 "
                                   "_flash_attention_bwd_dq)", "parallel train (1, 2) stage 1",
                                   "flash_bwd_dq"),
               "mlp2_dp": ("fused_mlp2 at a data rank's rows (B 16 of the stage-1 eval batch at "
                           "(2, 1), mm 768)", "dmi_tpu_torch/csrc/mlp2.cu",
                           "dmi_tpu/ops/pallas/projector.py:167", "parallel train (2, 1) eval",
                           "mlp2"),
               "lora0_dp": ("fused_lora_layer0 at a data rank's rows (B 2 of stage 2 at (2, 1))",
                            "dmi_tpu_torch/csrc/lora0.cu", "dmi_tpu/ops/pallas/projector.py:251",
                            "parallel train (2, 1) stage 2", "lora0")}
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
