"""dmi_tpu_torch's CUDA kernels against their plain twins, on a card.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
without a CUDA device.  This file imports no JAX (the card's machine has
none); run it there without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are relative to max(1, max |twin|): at f32 the kernels differ
from their twins by summation order only (1e-4); at bf16 also by the
last-bit rounding of outputs and hidden activations (1e-2, about two bf16
ulps).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from dmi_tpu_torch.models import decode as dec
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.models import quant
from dmi_tpu_torch.ops.cuda import block_mm as tbm
from dmi_tpu_torch.ops.cuda import decode_attn as tda
from dmi_tpu_torch.ops.cuda import decode_mlp as tdm
from dmi_tpu_torch.ops.cuda import flash_attn as tfa
from dmi_tpu_torch.ops.cuda import head_argmax as tha
from dmi_tpu_torch.ops.cuda import lora0 as tl0
from dmi_tpu_torch.ops.cuda import projector as tpk
from dmi_tpu_torch.ops.cuda import stream_mm as tsm
from dmi_tpu_torch.ops.cuda import w4_matmul as tw4
from dmi_tpu_torch.ops.cuda import w4_probe as twp
from dmi_tpu_torch.probes import bf16_steps, f32_sum_slack
from dmi_tpu_torch.utils.profiling import device_ms

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# flash gradients at bf16: dS and p are rounded to bf16 before their
# products in the kernels (as on the TPU), a few more roundings than outputs
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tol):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


def _mlp2_args(B, mm, lm, lm2, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, mm), (mm, lm), (lm,), (lm, lm2), (lm2,)]
    scales = [1.0, mm ** -0.5, mm ** -0.5, lm ** -0.5, lm ** -0.5]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32) * c).to(dev, dtype)
            for s, c in zip(shapes, scales)]


@pytest.mark.parametrize("B,mm,lm,lm2,dtype", [
    (128, 1024, 2048, 2048, torch.float32),   # the serving projector
    (44, 1024, 2048, 2048, torch.float32),    # ragged last row tile
    (256, 1024, 2048, 2048, torch.float32),   # the serving projector at batch 256
    (128, 1024, 2048, 2048, torch.bfloat16),
    (5, 96, 160, 72, torch.float32),          # widths off every multiple
    (37, 1024, 4096, 4096, torch.bfloat16),   # an 8B-wide projector
    (1, 1024, 2048, 2048, torch.float32),     # one row: a 16-row tile, 15 empty
    (64, 1024, 2048, 2048, torch.float32),    # 16-row tiles, 128 blocks
    (132, 1024, 2048, 2048, torch.float32),   # one row past a tile multiple
    (64, 768, 2048, 2048, torch.float32),     # stage 3's generate
    (7, 97, 161, 75, torch.float32),          # widths no 16-byte vector divides
    (7, 97, 161, 75, torch.bfloat16),
])
def test_mlp2_kernel_matches_twin(cuda, B, mm, lm, lm2, dtype):
    args = _mlp2_args(B, mm, lm, lm2, dtype, cuda)
    n0 = tpk.launches
    out = tpk.fused_mlp2(*args)
    assert tpk.launches == n0 + 1
    _close(out, tpk._mlp2_plain(*args), TOL[dtype])


@pytest.mark.parametrize("no_grad", [False, True], ids=["grad", "no_grad"])
def test_mlp2_kernel_differentiates_like_twin(cuda, no_grad):
    """Parameters that require grad (the trainer's eval loss and generate):
    the kernel runs, and the gradient of its output with respect to x and
    all four weights is the twin's."""
    args = [t.requires_grad_() for t in _mlp2_args(16, 96, 160, 72, torch.float32, cuda)]
    n0 = tpk.launches
    with torch.no_grad():
        out_ng = tpk.fused_mlp2(*args)
    assert tpk.launches == n0 + 1 and not out_ng.requires_grad
    _close(out_ng, tpk._mlp2_plain(*args).detach(), TOL[torch.float32])
    if no_grad:
        return
    out = tpk.fused_mlp2(*args)
    ref = tpk._mlp2_plain(*args)
    _close(out.detach(), ref.detach(), TOL[torch.float32])
    gy = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    for got, want in zip(torch.autograd.grad(out, args, gy), torch.autograd.grad(ref, args, gy)):
        _close(got, want, TOL[torch.float32])


def test_mlp2_kernel_refuses_mixed_dtypes(cuda):
    args = _mlp2_args(4, 32, 64, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="one dtype"):
        tpk.fused_mlp2(args[0].bfloat16(), *args[1:])


def _lora0_args(G, B, mm, lm, r, dtype, dev, seed=0):
    """x, w0, b0, a, b, d; x, a, b and d grouped when G is not None."""
    rng = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    shapes = [lead + (B, mm), (mm, lm), (lm,), lead + (mm, r), lead + (r, lm), lead + (lm,)]
    scales = [1.0, mm ** -0.5, 0.1, mm ** -0.5, r ** -0.5, 0.1]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32) * c).to(dev, dtype)
            for s, c in zip(shapes, scales)]


@pytest.mark.parametrize("G,B,mm,lm,r,dtype", [
    (None, 4, 768, 2048, 32, torch.float32),   # the stage-2 micro-batch
    (None, 44, 768, 2048, 32, torch.float32),  # ragged last row tile
    (None, 64, 768, 2048, 32, torch.float32),  # eval and few-shot batch
    (4, 4, 768, 2048, 32, torch.float32),      # coalesced: 4 adapter groups
    (None, 64, 768, 2048, 32, torch.bfloat16),
    (None, 8, 768, 2048, 32, torch.float32),   # the 8-row tile
    (3, 5, 96, 200, 7, torch.float32),         # a rank off every multiple: scalar loads of a
    (2, 3, 97, 130, 8, torch.float32),         # widths off 4: scalar loads of x, w0 and b
    (None, 6, 64, 202, 5, torch.bfloat16),     # all loads scalar
])
def test_lora0_kernel_matches_twin(cuda, G, B, mm, lm, r, dtype):
    args = _lora0_args(G, B, mm, lm, r, dtype, cuda)
    n0 = tl0.launches
    out = tl0.fused_lora_layer0(*args)
    assert tl0.launches == n0 + 1
    _close(out, tl0._lora0_plain(*args), TOL[dtype])


def test_lora0_kernel_differentiates_like_twin(cuda):
    """The hypernet's gradient path: x, a, b and d require grad (w0 and b0,
    the frozen projector, do not)."""
    args = _lora0_args(2, 4, 96, 160, 8, torch.float32, cuda)
    for i in (0, 3, 4, 5):
        args[i].requires_grad_()
    cot = torch.randn(2, 4, 160, device=cuda)
    want = torch.autograd.grad((tl0._lora0_plain(*args) * cot).sum(),
                               [args[i] for i in (0, 3, 4, 5)])
    got = torch.autograd.grad((tl0.fused_lora_layer0(*args) * cot).sum(),
                              [args[i] for i in (0, 3, 4, 5)])
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_lora0_kernel_takes_unaligned_inputs(cuda):
    """Tensors that start off a 16-byte boundary take the scalar loads."""
    args = _lora0_args(None, 4, 96, 160, 8, torch.float32, cuda)
    shifted = []
    for t in args:
        buf = torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)
        shifted.append(buf[1:].view(t.shape))
        shifted[-1].copy_(t)
    _close(tl0.fused_lora_layer0(*shifted), tl0._lora0_plain(*args), TOL[torch.float32])


def test_lora0_kernel_refuses_what_it_cannot_take(cuda):
    args = _lora0_args(None, 4, 32, 64, 8, torch.float32, cuda)
    with pytest.raises(TypeError, match="one dtype"):
        tl0.fused_lora_layer0(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tl0.fused_lora_layer0(args[0], args[1], args[2], args[3].t().contiguous().t(),
                              *args[4:])
    big = _lora0_args(None, 4, 32, 64, 300, torch.float32, cuda)
    with pytest.raises(ValueError, match="rank"):
        tl0.fused_lora_layer0(*big)


def _attn_args(B, nh, nkv, S, hd, dtype, dev, cache_len=None, seed=0):
    rng = np.random.default_rng(seed)
    cache_len = cache_len or S
    q = rng.normal(size=(B, nh, 1, hd)).astype(np.float32)
    k = rng.normal(size=(B, nkv, cache_len, hd)).astype(np.float32)
    v = rng.normal(size=(B, nkv, cache_len, hd)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in (q, k, v))
    return q, k[:, :, :S], v[:, :, :S]


@pytest.mark.parametrize("B,nh,nkv,S,hd,dtype,softcap", [
    (128, 32, 8, 16, 64, torch.bfloat16, None),   # Llama-3.2-1B decode steps
    (128, 32, 8, 23, 64, torch.bfloat16, None),
    (128, 32, 8, 38, 64, torch.bfloat16, 50.0),
    (128, 32, 8, 38, 64, torch.bfloat16, 2.0),    # a cap that binds
    (128, 32, 8, 38, 64, torch.float32, 2.0),
    (128, 32, 8, 38, 64, torch.float32, None),
    (256, 32, 8, 23, 64, torch.bfloat16, None),   # batch 256
    (3, 24, 8, 70, 128, torch.bfloat16, None),    # Llama-3.2-3B heads (g = 3)
    (2, 8, 8, 1, 64, torch.float32, None),        # g = 1, one key
    (1, 32, 8, 3000, 64, torch.float32, None),    # one chunk of scores
    (2, 32, 8, 3073, 64, torch.float32, None),    # g = 4: one key past a chunk
    (2, 32, 8, 3073, 64, torch.bfloat16, None),
    (2, 32, 8, 8192, 64, torch.float32, None),
    (2, 32, 8, 8192, 64, torch.bfloat16, 2.0),
    (2, 32, 8, 20000, 64, torch.float32, None),
    (2, 32, 8, 20000, 64, torch.bfloat16, None),
    (1, 256, 8, 4000, 64, torch.float32, None),   # g = 32: chunks of 384
])
def test_decode_attn_kernel_matches_twin(cuda, B, nh, nkv, S, hd, dtype, softcap):
    q, k, v, bias = _attn_case(B, nh, nkv, S, hd, dtype, cuda)
    n0 = tda.launches
    out = tda.fused_decode_attention(q, k, v, bias, None, softcap)
    assert tda.launches == n0 + 1
    _close(out, tda._decode_attn_plain(q, k, v, bias, None, softcap), TOL[dtype])


def _attn_case(B, nh, nkv, S, hd, dtype, dev):
    q, k, v = _attn_args(B, nh, nkv, S, hd, dtype, dev, cache_len=S + 5)
    bias = torch.zeros(S, device=dev)
    bias[S // 2:] = -1.0  # a non-trivial additive bias
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attn_softcap_case_binds(cuda, dtype):
    """The cap of 2.0 moves the twin's output by more than the tolerance on
    the inputs of its case above, so that case fails for a kernel that
    ignores the softcap (a cap of 50.0 on unit-size scores moves it less)."""
    q, k, v, bias = _attn_case(128, 32, 8, 38, 64, dtype, cuda)
    capped = tda._decode_attn_plain(q, k, v, bias, None, 2.0).float()
    free = tda._decode_attn_plain(q, k, v, bias).float()
    assert (capped - free).abs().max().item() > TOL[dtype] * max(
        1.0, capped.abs().max().item())


def test_decode_attn_kernel_masks_like_twin(cuda):
    """finfo.min on the tail, as the JAX loop's bias has it: exp gives 0."""
    q, k, v = _attn_args(4, 32, 8, 20, 64, torch.float32, cuda)
    bias = torch.zeros(20, device=cuda)
    bias[9:] = torch.finfo(torch.float32).min
    out = tda.fused_decode_attention(q, k, v, bias, 0.1)
    _close(out, tda.fused_decode_attention(q, k[:, :, :9], v[:, :, :9], bias[:9], 0.1), 1e-5)
    _close(out, tda._decode_attn_plain(q, k, v, bias, 0.1), 1e-4)


@pytest.mark.parametrize("start,stop", [(0, 3100), (3000, 8192), (9, 8192)],
                         ids=["head-chunk", "tail-chunks", "all-but-9"])
def test_decode_attn_kernel_masks_across_chunks(cuda, start, stop):
    """finfo.min over whole chunks of the online softmax (3072 keys each at
    g = 4): a first chunk whose keys are all masked is wiped by the next
    chunk's rescale, later masked chunks add nothing, and no NaN appears."""
    q, k, v = _attn_args(2, 32, 8, 8192, 64, torch.float32, cuda)
    bias = torch.zeros(8192, device=cuda)
    bias[start:stop] = torch.finfo(torch.float32).min
    out = tda.fused_decode_attention(q, k, v, bias)
    assert bool(torch.isfinite(out).all())
    _close(out, tda._decode_attn_plain(q, k, v, bias), 1e-4)


def test_decode_attn_kernel_refuses_what_it_cannot_take(cuda):
    """S is no limit (a cache of 5000 positions matches the twin, where the
    first kernel refused it); rows that are not contiguous are refused."""
    q, k, v = _attn_args(2, 8, 2, 5000, 64, torch.float32, cuda)
    bias = torch.zeros(5000, device=cuda)
    _close(tda.fused_decode_attention(q, k, v, bias), tda._decode_attn_plain(q, k, v, bias),
           TOL[torch.float32])
    q, k, v = _attn_args(2, 8, 2, 10, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        tda.fused_decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v,
                                   torch.zeros(10, device=cuda))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,group", [(64, 1), (64, 4), (64, 32), (128, 4), (256, 1), (256, 32)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 3073, 16384])
def test_decode_attn_kernel_split_plans(cuda, S, hd, group, dtype):
    """Every plan the wrapper makes at 2 x 2 kv heads (4 blocks before S is
    split): one chunk, one split of several chunks, and S split over blocks
    and merged; head widths 64-256, groups 1-32, views of a longer cache."""
    q, k, v, bias = _attn_case(2, 2 * group, 2, S, hd, dtype, cuda)
    p = tda.plan(2, 2, group, S, hd, q.element_size())
    assert (p["splits"] > 1) == (S > tda.MIN_SPLIT_KEYS)
    n0 = tda.launches
    out = tda.fused_decode_attention(q, k, v, bias)
    assert tda.launches == n0 + 1
    _close(out, tda._decode_attn_plain(q, k, v, bias), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,S", [(1, 9), (36, 70), (36, 3000), (200, 65)])
def test_decode_attn_kernel_odd_heads_and_rows(cuda, hd, S, dtype):
    """Head widths off the 16-byte vector (rows staged element by element,
    zeros past hd) and a q that is not 16-byte aligned: every shape the
    first kernel took, on both instances."""
    q, k, v, bias = _attn_case(2, 8, 2, S, hd, dtype, cuda)
    q_off = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)[1:].view(q.shape)
    q_off.copy_(q)
    _close(tda.fused_decode_attention(q_off, k, v, bias),
           tda._decode_attn_plain(q, k, v, bias), TOL[dtype])


@pytest.mark.parametrize("mask", ["tail-from-mid-chunk", "head-to-mid-chunk", "whole-splits",
                                  "every-key"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attn_kernel_masked_splits(cuda, mask, dtype):
    """finfo.min, as the JAX loops mask a fixed-length cache, over the
    plan's splits of whole 64-key chunks (B 2, 8 kv heads, S 16384): splits
    whose every key is masked weigh 0 after the merge and splits cut by the
    mask keep their other keys; with every key masked, the uniform average
    a single softmax gives.  No NaN in any case."""
    q, k, v = _attn_args(2, 32, 8, 16384, 64, dtype, cuda)
    p = tda.plan(2, 8, 4, 16384, 64, q.element_size())
    assert p["splits"] > 3 and p["chunk"] == 64 and p["keys_per_split"] % 64 == 0
    start, stop = {"tail-from-mid-chunk": (16384 - 1000, 16384), "head-to-mid-chunk": (0, 5037),
                   "whole-splits": (p["keys_per_split"], 3 * p["keys_per_split"]),
                   "every-key": (0, 16384)}[mask]
    bias = torch.zeros(16384, device=cuda)
    bias[start:stop] = torch.finfo(torch.float32).min
    out = tda.fused_decode_attention(q, k, v, bias)
    assert bool(torch.isfinite(out).all())
    _close(out, tda._decode_attn_plain(q, k, v, bias), TOL[dtype])


@pytest.mark.parametrize("B,S", [(128, 23), (2, 3073), (2, 16384)])
def test_decode_attn_kernel_is_deterministic(cuda, B, S):
    """The splits are merged in a fixed order: two calls agree bit for bit."""
    q, k, v, bias = _attn_case(B, 32, 8, S, 64, torch.bfloat16, cuda)
    assert torch.equal(tda.fused_decode_attention(q, k, v, bias),
                       tda.fused_decode_attention(q, k, v, bias))


def _tiny_model(dev, dtype):
    cfg = dataclasses.replace(
        llama.tiny_config(vocab_size=320, hidden_size=128, n_layers=3, n_heads=8, n_kv=2,
                          intermediate=256, dtype=dtype, eos=(7,)),
        rope_scaling_factor=32.0,
    )
    params = llama.fuse_projections(llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                                               dev))
    for lw in params["layers"]:  # std 0.2: varied greedy tokens
        for name in ("w_qkv", "wo", "w_gu", "w_down"):
            lw[name].mul_(10)
    return cfg, params


def test_greedy_kernel_path_matches_plain_path_f32(cuda):
    cfg, params = _tiny_model(cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    embeds = torch.randn(6, 9, 128, generator=gen, device=cuda)
    n0 = tda.launches
    ids = dec.greedy_generate(cfg, params, embeds, 12, 1)
    assert tda.launches > n0
    assert torch.equal(ids, dec.greedy_generate(cfg, params, embeds, 12, 1, plain=True))


def test_decode_step_kernel_path_matches_plain_path_bf16(cuda):
    cfg, params = _tiny_model(cuda, torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(2)
    embeds = torch.randn(8, 9, 128, generator=gen, device=cuda).bfloat16()
    with torch.no_grad():
        caches = dec.init_cache(cfg, 8, 16, cuda)
        logits = dec.prefill(cfg, params, embeds, caches)
        emb = llama.embed_tokens(cfg, params, logits.argmax(-1))[:, None]
        outs = [dec.decode_step(cfg, params, emb, (caches[0].clone(), caches[1].clone()), 9,
                                plain=plain) for plain in (False, True)]
    _close(outs[0], outs[1], 5e-2)


def _flash_args(B, nh, nkv, T, hd, dtype, dev, masked, seed=0):
    """q, k, v in the [B, T, heads, hd] layout of a block's projections,
    viewed as [B, heads, T, hd]; a key mask that zeroes a ragged tail of
    each row but the first (key 0, the soft token, stays)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, n, hd)).astype(np.float32)).to(
        dev, dtype).transpose(1, 2) for n in (nh, nkv, nkv))
    mask = None
    if masked:
        mask = torch.ones(B, T, dtype=torch.int32)
        for b in range(1, B):
            mask[b, max(1, T - 1 - 7 * b):] = 0
        mask = mask.to(dev)
    return q, k, v, mask


def _flash_vs_twin(q, k, v, mask, dtype, seed=1):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    n = (tfa.fwd_launches, tfa.dkv_launches, tfa.dq_launches)
    out = tfa.flash_attention(q, k, v, mask, 0.125)
    ref = tfa._flash_attn_plain(q, k, v, mask, 0.125)
    _close(out.detach(), ref.detach(), TOL[dtype])
    gen = torch.Generator(q.device).manual_seed(seed)
    do = torch.randn(out.shape, generator=gen, device=q.device).to(dtype)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref, (q, k, v), do)
    assert (tfa.fwd_launches, tfa.dkv_launches, tfa.dq_launches) == (n[0] + 1, n[1] + 1,
                                                                      n[2] + 1)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL[dtype])


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "key-mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T", [(2, 1), (3, 17), (32, 65), (4, 128), (2, 606)])
def test_flash_kernels_match_twin(cuda, B, T, dtype, masked):
    """Llama-3.2-1B heads (32/8, hd 64); T 65 is stage 1's training length
    (64 text tokens and the soft token), 606 sharegpt4video's budget."""
    _flash_vs_twin(*_flash_args(B, 32, 8, T, 64, dtype, cuda, masked), dtype)


@pytest.mark.parametrize("nh,nkv,hd", [(4, 4, 16), (6, 2, 128), (8, 1, 40)])
def test_flash_kernels_other_heads(cuda, nh, nkv, hd):
    _flash_vs_twin(*_flash_args(2, nh, nkv, 70, hd, torch.float32, cuda, True),
                   torch.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "key-mask"])
@pytest.mark.parametrize("B,nh,nkv,T,hd", [
    (2, 4, 4, 70, 16), (2, 8, 1, 70, 40), (2, 6, 2, 70, 128),  # head dims of 1, 3, 8 slices
    (2, 6, 2, 33, 80), (2, 6, 2, 33, 96),                      # 80 padded to 96
    (4, 32, 8, 1, 64), (2, 32, 8, 64, 64), (32, 32, 8, 65, 64),
    (4, 32, 8, 329, 64), (1, 32, 8, 2048, 64),                 # stage 2, a long sequence
])
def test_flash_bf16_tensor_core_forward(cuda, B, nh, nkv, T, hd, masked):
    """The bf16 forward (mma.sync on the tensor cores, hd padded to 16
    kd) and the backward that reads its o and lse, against the twin, at
    every head-slice instance and at T that fill one tile, pass one by one
    row, run six tiles and 32."""
    _flash_vs_twin(*_flash_args(B, nh, nkv, T, hd, torch.bfloat16, cuda, masked),
                   torch.bfloat16)


def test_flash_bf16_unaligned_rows_are_staged_by_elements(cuda):
    """q, k and v whose rows are no 16-byte multiple apart (a [B, T, heads,
    hd] buffer one element off the start) take the element-wise staging."""
    q, k, v, mask = _flash_args(2, 8, 2, 40, 64, torch.bfloat16, cuda, True)
    off = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)[1:]
        off.append(buf.view(t.shape[0], t.shape[2], t.shape[1], t.shape[3])
                   .copy_(t.transpose(1, 2)).transpose(1, 2))
    assert off[0].data_ptr() % 16
    _flash_vs_twin(*off, mask, torch.bfloat16)


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "key-mask"])
@pytest.mark.parametrize("T", [1, 39, 64, 65, 329, 2048])
@pytest.mark.parametrize("hd", [16, 40, 56, 64, 80, 96, 128])
def test_flash_bf16_tensor_core_backward(cuda, hd, T, masked):
    """The bf16 dK/dV and dQ kernels (mma.sync on the tensor cores, query
    heads packed to a block by bwd_plan) against the twin's autograd at
    groups 1, 3, 4 and 8 over 2 kv heads: head dims of 1, 3, 4 (TMA tiles,
    zero-filled past hd 56), 6 (80 padded to 96) and 8 slices; T of one
    key, of stage 3, one tile, one tile and a key (stage 1), stage 2's, and
    32 tiles."""
    B = 1 if T == 2048 else 2
    for group in (1, 3, 4, 8):
        _flash_vs_twin(*_flash_args(B, 2 * group, 2, T, hd, torch.bfloat16, cuda, masked),
                       torch.bfloat16)


@pytest.mark.parametrize("hd", [36, 64])
def test_flash_bf16_backward_unaligned_rows(cuda, hd):
    """q, k and v one element off 16 bytes (and at hd 36 no 16-byte vector
    of 8 bf16 fits a row): the backward stages rows and writes dK/dV element
    by element, with no TMA at hd 64."""
    q, k, v, mask = _flash_args(2, 6, 2, 40, hd, torch.bfloat16, cuda, True)
    off = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)[1:]
        off.append(buf.view(t.shape[0], t.shape[2], t.shape[1], t.shape[3])
                   .copy_(t.transpose(1, 2)).transpose(1, 2))
    assert off[0].data_ptr() % 16
    _flash_vs_twin(*off, mask, torch.bfloat16)


def test_flash_bf16_fully_masked_row_gives_zero_gradients(cuda):
    """bf16: rows with no key to attend (lse = -inf) write zeros and get
    zero dQ, no NaN anywhere; with their cotangent zeroed (the twin spreads
    such a row over its masked keys) every gradient matches the twin's."""
    q, k, v, _ = _flash_args(2, 8, 2, 70, 64, torch.bfloat16, cuda, False)
    mask = torch.ones(2, 70, dtype=torch.int32, device=cuda)
    mask[1, :3] = 0  # rows 0-2 of batch row 1 see no key
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(q, k, v, mask)
    assert torch.equal(out[1, :, :3], torch.zeros_like(out[1, :, :3]))
    do = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(2),
                     device=cuda).bfloat16()
    do[1, :, :3] = 0
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(tfa._flash_attn_plain(q, k, v, mask), (q, k, v), do)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert torch.equal(got[0][1, :, :3], torch.zeros_like(got[0][1, :, :3]))
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_backward_is_deterministic(cuda, dtype):
    """Two identical backward calls at stage 2's shape (B 4, 32/8 heads, T
    329, a key mask) give bit-identical dQ, dK and dV: the group's sum is
    taken in a fixed order, with no atomics."""
    q, k, v, _ = _flash_args(4, 32, 8, 329, 64, dtype, cuda, False)
    mask = torch.ones(4, 329, dtype=torch.int32, device=cuda)
    mask[1:, 300:] = 0
    o, lse = tfa._fwd_kernel(q, k, v, mask, 0.125)
    do = torch.randn(o.shape, generator=torch.Generator(cuda).manual_seed(3),
                     device=cuda).to(dtype)
    delta = tfa._delta(do, o)
    runs = [tfa._bwd_dkv_kernel(q, k, v, mask, do, lse, delta, 0.125)
            + (tfa._bwd_dq_kernel(q, k, v, mask, do, lse, delta, 0.125),) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(bool(torch.isfinite(g).all()) for g in runs[0])


def test_flash_contiguous_inputs(cuda):
    q, k, v, mask = _flash_args(2, 8, 2, 33, 64, torch.float32, cuda, True)
    _flash_vs_twin(q.contiguous(), k.contiguous(), v.contiguous(), mask, torch.float32)


def test_flash_fully_masked_row_gives_zeros(cuda):
    """A row with no key to attend (its only causal key masked) writes
    zeros and gets zero gradients, not NaN."""
    q, k, v, _ = _flash_args(2, 8, 2, 20, 64, torch.float32, cuda, False)
    mask = torch.ones(2, 20, dtype=torch.int32, device=cuda)
    mask[1, :3] = 0  # rows 0-2 of batch row 1 see no key
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(q, k, v, mask)
    assert torch.equal(out[1, :, :3], torch.zeros_like(out[1, :, :3]))
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert torch.equal(grads[0][1, :, :3], torch.zeros_like(grads[0][1, :, :3]))
    ref = tfa._flash_attn_plain(q, k, v, mask)
    _close(out[:, :, 3:].detach(), ref[:, :, 3:].detach(), 1e-4)
    _close(out[0].detach(), ref[0].detach(), 1e-4)


def test_flash_refuses_what_it_cannot_take(cuda):
    q, k, v, mask = _flash_args(2, 8, 2, 16, 64, torch.float32, cuda, True)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        tfa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention(q, k.bfloat16(), v, mask)
    with pytest.raises(ValueError, match="flash attention shapes"):
        tfa.flash_attention(q, k[:, :, :15], v, mask)
    with pytest.raises(ValueError, match="flash attention shapes"):
        tfa.flash_attention(q, k, v, mask[:, :15])
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_attention(q, k, v, mask.cpu())
    with pytest.raises(ValueError, match="hd 256"):
        tfa.flash_attention(*_flash_args(1, 2, 2, 4, 256, torch.float32, cuda, False)[:3])
    with pytest.raises(TypeError, match="integer or bool"):
        tfa.flash_attention(q, k, v, mask.float())


def test_full_width_trainer_kernel_path_matches_plain_path(cuda):
    """Two micro-steps of ProjectorTrainer on Llama-3.2-1B at full width
    (bf16, seeded random weights), batch 8 of 40 text tokens: at each step
    the loss through the flash kernels matches the plain path's (bf16
    logits tolerance, 5e-2), every layer launches each flash kernel once,
    and the updates (constant LR: with a warmup, the reference's schedule
    gives the first two updates an LR of 0) move the projector."""
    import types

    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.training.embeddings import EmbeddingManager
    from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer

    cfg = dataclasses.replace(llama.llama32_1b(), eos_token_ids=())
    params = llama.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    spec = proj.ProjectorSpec(mm_dim=768, lm_dim=cfg.hidden_size, dropout=0.1)
    pp = proj.init(spec, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    rng = np.random.default_rng(0)

    def batch():
        B, T = 8, 40
        ids = rng.integers(0, 128000, size=(B, T)).astype(np.int32)
        mask = np.ones((B, T), np.int32)
        mask[1:, 30:] = 0
        labels = np.where(mask == 1, ids, 128009).astype(np.int64)
        labels[:, :10] = -100
        return {"input_ids": ids, "attention_mask": mask, "labels": labels,
                "embs": rng.normal(size=(B, 768)).astype(np.float32)}

    class Source:
        def total_train_steps(self):
            return 2

    args = types.SimpleNamespace(
        learning_rate=1e-4, adam_beta1=0.9, adam_beta2=0.95, adam_epsilon=1e-8,
        weight_decay=5e-6, max_grad_norm=1.0, scheduler=None, warmup_steps=0,
        gradient_accumulation_steps=1, seed=0, mesh_shape=None,
        finetune_from_checkpoint=None, checkpoint_dir="unused")
    trainer = ProjectorTrainer("cuda-test", cfg, params, spec, pp, [Source()],
                               [EmbeddingManager("enc", device=cuda)], None, args)
    before = [t.detach().clone() for t in trainer.leaves]
    for step in range(2):
        b = (0, batch())
        with torch.no_grad():
            plain = trainer.micro_loss(step, b, plain=True)
        n0 = (tfa.fwd_launches, tfa.dkv_launches, tfa.dq_launches)
        loss, did_update = trainer.train_step(step, 2, b)
        assert did_update
        assert (tfa.fwd_launches - n0[0], tfa.dkv_launches - n0[1],
                tfa.dq_launches - n0[2]) == (16, 16, 16)
        assert bool(torch.isfinite(loss))
        _close(loss, plain, 5e-2)
    assert all(not torch.equal(a, b.detach()) for a, b in zip(before, trainer.leaves))


# ---------------------------------------------------------------------------
# The batch-last serving kernels: int8 matmuls, decode MLP, head + argmax
# ---------------------------------------------------------------------------

def _normal(shape, dev, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev)


# Llama-3.2-1B's four layer matmuls at the serving batch; the batch sizes the
# TPU kernel's gate kept out (8, 64, 100); shapes off every vector width
INT8_MM_SHAPES = [
    (2048, 3072, 128), (2048, 2048, 128), (2048, 16384, 128), (8192, 2048, 128),
    (2048, 2048, 8), (2048, 2048, 64), (2048, 3072, 100), (2048, 2048, 256),
    (70, 37, 5), (6, 33, 130), (1024, 40, 1),
]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K,out,B", INT8_MM_SHAPES)
def test_w4_kernel_equals_twin_bit_for_bit(cuda, K, out, B, out_dtype):
    w = quant.quantize_tensor_int4(_normal((K, out), cuda, 0, 0.05))
    hq, a = quant.quantize_act(_normal((K, B), cuda, 1), axis=0)
    n0 = tw4.launches
    got = tw4.w4_mm_bl(w, hq, a, out_dtype)
    assert tw4.launches == n0 + 1
    torch.cuda.synchronize()
    want = tw4._w4_mm_plain(w, hq, a, out_dtype)
    assert got.shape == (out, B) and got.dtype == out_dtype
    assert torch.equal(got, want)


def test_w4_kernel_sign_extends_every_nibble(cuda):
    """Every byte value, -8 included (quantize_tensor_int4 never emits it)."""
    K, out, B = 64, 256, 16
    qp = torch.arange(256, dtype=torch.uint8, device=cuda).repeat(K // 2, 1).contiguous()
    qp = qp[:, torch.randperm(256, device=cuda)].contiguous()
    w = {"qp": qp, "s": torch.full((1, out), 0.01, device=cuda)}
    hq, a = quant.quantize_act(_normal((K, B), cuda, 2), axis=0)
    assert torch.equal(tw4.w4_mm_bl(w, hq, a, torch.float32),
                       tw4._w4_mm_plain(w, hq, a, torch.float32))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K,out,B", INT8_MM_SHAPES)
def test_w8_kernel_equals_twin_bit_for_bit(cuda, K, out, B, out_dtype):
    w = quant.quantize_tensor(_normal((K, out), cuda, 0, 0.05), native=True)
    hq, a = quant.quantize_act(_normal((K, B), cuda, 1), axis=0)
    n0 = tw4.w8_launches
    got = tw4.w8_mm_bl(w, hq, a, out_dtype)
    assert tw4.w8_launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, tw4._w8_mm_plain(w, hq, a, out_dtype))


def test_int8_mm_kernels_refuse_what_they_cannot_take(cuda):
    w = quant.quantize_tensor_int4(_normal((64, 32), cuda, 0))
    hq, a = quant.quantize_act(_normal((64, 8), cuda, 1), axis=0)
    with pytest.raises(TypeError, match="int8"):
        tw4.w4_mm_bl(w, hq.float(), a, torch.float32)
    with pytest.raises(ValueError, match="one device"):
        tw4.w4_mm_bl(w, hq, a.cpu(), torch.float32)
    with pytest.raises(ValueError, match="shapes"):
        tw4.w4_mm_bl(w, hq[:32].contiguous(), a, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tw4.w4_mm_bl(w, hq, a, torch.float16)
    with pytest.raises(ValueError, match="per-channel"):
        tw4.w4_mm_bl(quant.quantize_tensor_int4(_normal((64, 32), cuda, 0), 16), hq, a,
                     torch.float32)
    w8 = quant.quantize_tensor(_normal((64, 32), cuda, 0), native=True)
    with pytest.raises(TypeError, match="int8"):
        tw4.w8_mm_bl({"q8": w8["q8"].view(torch.uint8), "s": w8["s"]}, hq, a, torch.float32)


def _mlp_args(H, I, B, dtype, dev):
    return (_normal((H, 2 * I), dev, 0, H ** -0.5).to(dtype),
            _normal((I, H), dev, 1, I ** -0.5).to(dtype), _normal((H, B), dev, 2).to(dtype))


@pytest.mark.parametrize("H,I,B,dtype,act", [
    (2048, 8192, 128, torch.bfloat16, "silu"),       # Llama-3.2-1B at the serving batch
    (2048, 8192, 128, torch.bfloat16, "gelu_tanh"),
    (2048, 8192, 8, torch.bfloat16, "silu"),
    (2048, 8192, 16, torch.bfloat16, "silu"),
    (2048, 8192, 64, torch.bfloat16, "silu"),
    (2048, 8192, 100, torch.bfloat16, "silu"),       # a batch the wrapper pads
    (2048, 8192, 256, torch.bfloat16, "silu"),       # two batch tiles
    (2048, 8192, 128, torch.float32, "silu"),        # the CUDA-core path
    (256, 512, 16, torch.float32, "gelu_tanh"),
    (72, 136, 5, torch.float32, "silu"),             # ragged tiles on every axis
    (72, 136, 5, torch.bfloat16, "gelu_tanh"),
    (64, 8, 3, torch.bfloat16, "silu"),              # I below one tile
])
def test_decode_mlp_kernel_matches_twin(cuda, H, I, B, dtype, act):
    args = _mlp_args(H, I, B, dtype, cuda)
    n0 = tdm.launches
    out = tdm.fused_decode_mlp_bl(*args, act)
    assert tdm.launches == n0 + 1
    _close(out, tdm._decode_mlp_plain(*args, act), TOL[dtype])


def test_decode_mlp_kernel_is_deterministic(cuda):
    """The partials are added in a fixed order: two calls agree bit for bit."""
    args = _mlp_args(2048, 8192, 128, torch.bfloat16, cuda)
    assert torch.equal(tdm.fused_decode_mlp_bl(*args), tdm.fused_decode_mlp_bl(*args))


@pytest.mark.parametrize("B", [8, 256])
def test_decode_mlp_kernel_is_deterministic_at_other_tiles(cuda, B):
    """m64n64 tiles (B 8) and two consumer warpgroups (B 256): bit-equal."""
    args = _mlp_args(2048, 8192, B, torch.bfloat16, cuda)
    assert torch.equal(tdm.fused_decode_mlp_bl(*args), tdm.fused_decode_mlp_bl(*args))


def test_decode_mlp_kernel_encodes_weight_maps_once(cuda):
    """The weights' TMA descriptors are cached: a second call on the same
    weights encodes none, and the split counters are left at 0."""
    args = _mlp_args(1024, 2048, 64, torch.bfloat16, cuda)
    tdm.fused_decode_mlp_bl(*args)
    before = tdm.map_encodes()
    h2 = _normal((1024, 64), cuda, 7).bfloat16()
    _close(tdm.fused_decode_mlp_bl(args[0], args[1], h2),
           tdm._decode_mlp_plain(args[0], args[1], h2), TOL[torch.bfloat16])
    assert tdm.map_encodes()["weights"] == before["weights"]
    for c in tdm._counters.values():
        assert int(c.abs().sum()) == 0


def test_decode_mlp_kernel_refuses_what_it_cannot_take(cuda):
    w_gu, w_down, h = _mlp_args(64, 128, 4, torch.float32, cuda)
    with pytest.raises(TypeError, match="one dtype"):
        tdm.fused_decode_mlp_bl(w_gu, w_down, h.bfloat16())
    with pytest.raises(ValueError, match="one device"):
        tdm.fused_decode_mlp_bl(w_gu, w_down.cpu(), h)
    with pytest.raises(ValueError, match="shapes"):
        tdm.fused_decode_mlp_bl(w_gu, w_down[:64], h)
    with pytest.raises(ValueError, match="mlp_act"):
        tdm.fused_decode_mlp_bl(w_gu, w_down, h, "relu")
    with pytest.raises(ValueError, match="multiples of 8"):
        tdm.fused_decode_mlp_bl(*_mlp_args(60, 128, 4, torch.float32, cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tdm.fused_decode_mlp_bl(w_gu.half(), w_down.half(), h.half())


def _head_params(mode, V, H, dev, seed=0):
    embed = _normal((V, H), dev, seed)
    if mode == "bf16":
        return {"embed": embed.bfloat16()}
    return {"embed": quant.quantize_embed_tensor(embed, native=(mode == "q8"))}


def _check_head(params, h, mode):
    n0 = tha.launches
    ids = tha.head_argmax(params, h)
    assert tha.launches == n0 + 1
    torch.cuda.synchronize()
    logits = tha.head_logits_bl(params["embed"], h).float()
    want = logits.argmax(dim=0)
    assert ids.shape == want.shape and ids.dtype == torch.long
    if mode == "q8":  # integer work: bit equality with the twin
        assert torch.equal(ids, want)
        return
    # another summation order than the library matmul's: a near-tie may round
    # to the other bf16 value.  Most columns agree, and where one differs the
    # twin's two logits lie within one bf16 step (2**-7 relative) per
    # rounding of the mode (the q mode rounds twice)
    assert (ids == want).float().mean().item() >= 0.9
    cols = torch.nonzero(ids != want).flatten()
    a, b = logits[ids[cols], cols], logits[want[cols], cols]
    steps = 2 if mode == "q" else 1
    assert bool(((a - b).abs() <= steps * 2.0 ** -7 * b.abs()).all())


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
@pytest.mark.parametrize("V,B", [(128256, 128), (128256, 8), (128256, 100), (1001, 64),
                                 (100, 16), (5000, 256)])
def test_head_argmax_kernel_matches_twin(cuda, mode, V, B):
    """Llama-3.2-1B's vocabulary and width; a V no slice size divides."""
    params = _head_params(mode, V, 2048, cuda)
    _check_head(params, _normal((2048, B), cuda, 1).bfloat16(), mode)


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
def test_head_argmax_kernel_ties_go_to_the_first_row(cuda, mode):
    """Every row identical: every logit ties, across slices and blocks too."""
    V, H, B = 1000, 64, 24
    params = _head_params(mode, V, H, cuda)
    row = _normal((1, H), cuda, 3)
    if mode == "bf16":
        params["embed"] = row.bfloat16().repeat(V, 1).contiguous()
    else:
        params["embed"] = quant.quantize_embed_tensor(row.repeat(V, 1), native=(mode == "q8"))
    ids = tha.head_argmax(params, _normal((H, B), cuda, 4).bfloat16())
    assert torch.equal(ids, torch.zeros(B, dtype=torch.long, device=cuda))


@pytest.mark.parametrize("mode", ["bf16", "q", "q8"])
def test_head_argmax_kernel_planted_tie_across_blocks(cuda, mode):
    """The same winning row planted in two vocab slices: the first wins."""
    V, H, B = 9000, 128, 32
    u = _normal((H,), cuda, 5)
    embed = _normal((V, H), cuda, 6, 0.1)
    embed[7000] = embed[300] = 4.0 * u
    params = ({"embed": embed.bfloat16()} if mode == "bf16" else
              {"embed": quant.quantize_embed_tensor(embed, native=(mode == "q8"))})
    h = u[:, None].repeat(1, B).bfloat16().contiguous()
    ids = tha.head_argmax(params, h)
    assert torch.equal(ids, torch.full((B,), 300, dtype=torch.long, device=cuda))


def test_head_argmax_kernel_refuses_what_it_cannot_take(cuda):
    params = _head_params("bf16", 256, 64, cuda)
    h = _normal((64, 8), cuda, 1)
    with pytest.raises(TypeError, match="bf16"):
        tha.head_argmax(params, h)  # an f32 state
    with pytest.raises(TypeError, match="bf16"):
        tha.head_argmax({"embed": params["embed"].float()}, h.bfloat16())
    with pytest.raises(ValueError, match="one device"):
        tha.head_argmax(params, h.bfloat16().cpu())
    with pytest.raises(ValueError, match="shapes"):
        tha.head_argmax(params, h[:32].bfloat16())
    with pytest.raises(ValueError, match="multiple of 16"):
        tha.head_argmax(_head_params("bf16", 256, 40, cuda), _normal((40, 8), cuda, 1).bfloat16())


def _bl_counts():
    return (tda.launches, tdm.launches, tha.launches, tw4.launches, tw4.w8_launches)


@pytest.mark.parametrize("tree", ["bf16", "q", "w8a8", "w4a8", "w4a8-grouped"])
def test_greedy_bl_kernel_path_against_plain_path(cuda, tree):
    """The batch-last loop on a tiny bf16 model, every weight kind: the
    kernels the tree calls for are launched (3 layers, 11 steps), and the
    tokens agree with the plain path's up to bf16 near-ties (the first
    token, from the shared prefill, always)."""
    cfg, params = _tiny_model(cuda, torch.bfloat16)
    cfg = dataclasses.replace(cfg, eos_token_ids=())  # every step of the budget runs
    prefill_params = None
    if tree == "q":
        params = quant.quantize_llama(params)
    elif tree == "w8a8":
        prefill_params, params = params, quant.quantize_llama(params, native=True)
    elif tree.startswith("w4a8"):
        prefill_params, params = params, quant.quantize_llama(
            params, bits=4, group_size=32 if tree.endswith("grouped") else None)
    gen = torch.Generator(device=cuda).manual_seed(1)
    embeds = torch.randn(6, 9, 128, generator=gen, device=cuda).bfloat16()
    n0 = _bl_counts()
    ids = dec.greedy_generate_bl(cfg, params, embeds, 12, 1, prefill_params=prefill_params)
    got = tuple(b - a for a, b in zip(n0, _bl_counts()))
    steps = 11  # the last token is an argmax of the last step's selection
    want = {"bf16": (3, 3, 1, 0, 0), "q": (3, 0, 1, 0, 0), "w8a8": (3, 0, 1, 0, 12),
            "w4a8": (3, 0, 1, 12, 0), "w4a8-grouped": (3, 0, 1, 0, 0)}[tree]
    assert got == tuple(steps * n for n in want)
    plain = dec.greedy_generate_bl(cfg, params, embeds, 12, 1, prefill_params=prefill_params,
                                   plain=True)
    assert _bl_counts() == tuple(a + b for a, b in zip(n0, got))  # the twins launch nothing
    assert torch.equal(ids[:, 0], plain[:, 0])
    assert (ids == plain).float().mean().item() >= 0.7


def test_greedy_bl_kernel_path_f32_and_batch_first(cuda):
    """An f32 model takes the logits path for the head and the CUDA-core
    decode MLP; its tokens equal the plain path's and the batch-first loop's."""
    cfg, params = _tiny_model(cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    embeds = torch.randn(6, 9, 128, generator=gen, device=cuda)
    n0 = _bl_counts()
    ids = dec.greedy_generate_bl(cfg, params, embeds, 12, 1)
    got = tuple(b - a for a, b in zip(n0, _bl_counts()))
    assert got[1] > 0 and got[0] == got[1] and got[2:] == (0, 0, 0)
    assert torch.equal(ids, dec.greedy_generate_bl(cfg, params, embeds, 12, 1, plain=True))
    assert torch.equal(ids, dec.greedy_generate(cfg, params, embeds, 12, 1))


# ---------------------------------------------------------------------------
# The probe kernels: blocked int8/bf16 matmul, weight-stream matmul, packed W4
# ---------------------------------------------------------------------------

def _ints(shape, lo, hi, dev, seed):
    a = np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int8)
    return torch.from_numpy(a).to(dev)


# (M, N, K): the probe's --small and default squares; tiles that divide
# nothing, with whole 16-byte rows and without (K 70 and N 200 are not
# multiples of an int8 vector)
BLOCK_MM_SHAPES = [(256, 256, 256), (4096, 4096, 4096), (129, 136, 144), (130, 200, 70),
                   (17, 5, 33)]


@pytest.mark.parametrize("block_m", tbm.BLOCK_M)
@pytest.mark.parametrize("M,N,K", BLOCK_MM_SHAPES)
def test_block_mm_int8_kernel_is_exact(cuda, M, N, K, block_m):
    a, b = _ints((M, K), -127, 128, cuda, 0), _ints((K, N), -127, 128, cuda, 1)
    n0 = tbm.launches
    got = tbm.block_mm(a, b, block_m)
    assert tbm.launches == n0 + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, tbm._block_mm_plain(a, b))


@pytest.mark.parametrize("block_m", tbm.BLOCK_M)
@pytest.mark.parametrize("M,N,K", BLOCK_MM_SHAPES)
def test_block_mm_bf16_kernel_matches_twin(cuda, M, N, K, block_m):
    """Both sum in f32, in another order: within 1e-5 of the largest |out|."""
    a, b = _normal((M, K), cuda, 0).bfloat16(), _normal((K, N), cuda, 1).bfloat16()
    got = tbm.block_mm(a, b, block_m)
    torch.cuda.synchronize()
    ref = tbm._block_mm_plain(a, b)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# (I, O, B): the probe's --small and default shapes, then odd ones (B 5 is
# not a whole bf16 vector, O 200 fills no tile)
STREAM_SHAPES = [(128, 256, 32), (2048, 16384, 256), (72, 136, 40), (100, 200, 5)]


@pytest.mark.parametrize("block_out", tsm.BLOCK_OUT)
@pytest.mark.parametrize("I,O,B", STREAM_SHAPES)
def test_stream_mm_kernel_within_one_bf16_step(cuda, I, O, B, block_out):
    w, h = _normal((I, O), cuda, 0).bfloat16(), _normal((I, B), cuda, 1).bfloat16()
    n0 = tsm.launches
    got = tsm.stream_mm_bl(w, h, block_out)
    assert tsm.launches == n0 + 1
    torch.cuda.synchronize()
    ref = tsm._stream_mm_plain(w, h)
    assert got.dtype == torch.bfloat16 and got.shape == (O, B)
    # where a sum cancels, two f32 summation orders differ by many bf16
    # steps of the result: the step is counted beyond that slack
    assert bf16_steps(got, ref, f32_sum_slack(w.t(), h)) <= 1


# (K, OUT, B): the probe's --small and default shapes, then odd ones
W4_PROBE_SHAPES = [(64, 128, 4), (2048, 16384, 256), (70, 200, 5), (130, 96, 33), (2, 2, 1)]


@pytest.mark.parametrize("layout", ["split_out", "split_k"])
@pytest.mark.parametrize("K,OUT,B", W4_PROBE_SHAPES)
def test_w4_probe_kernels_equal_the_int8_product(cuda, K, OUT, B, layout):
    """Every nibble value, -8 included; exact against the twin and the int8
    product."""
    w8 = np.random.default_rng(0).integers(-8, 8, size=(K, OUT)).astype(np.int8)
    h = _ints((K, B), -128, 128, cuda, 1)
    pack, fn, plain, count = {
        "split_out": (twp.pack_split_out, twp.w4_dot_split_out, twp._w4_split_out_plain,
                      "split_out_launches"),
        "split_k": (twp.pack_split_k, twp.w4_dot_split_k, twp._w4_split_k_plain,
                    "split_k_launches")}[layout]
    p = torch.from_numpy(pack(w8)).to(cuda)
    n0 = getattr(twp, count)
    got = fn(p, h)
    assert getattr(twp, count) == n0 + 1
    torch.cuda.synchronize()
    want = (torch.from_numpy(w8).to(cuda).double().t() @ h.double()).to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got, plain(p, h))


def test_probe_kernels_refuse_what_they_cannot_take(cuda):
    a = _ints((32, 32), -1, 1, cuda, 0)
    with pytest.raises(TypeError, match="int8 or two bf16"):
        tbm.block_mm(a, a.bfloat16())
    with pytest.raises(ValueError, match="block_m"):
        tbm.block_mm(a, a, 96)
    with pytest.raises(ValueError, match="one device"):
        tbm.block_mm(a, a.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tbm.block_mm(a.t(), a)
    w = a.bfloat16()
    with pytest.raises(ValueError, match="block_out"):
        tsm.stream_mm_bl(w, w, 512)
    with pytest.raises(TypeError, match="bf16"):
        tsm.stream_mm_bl(w.float(), w)
    p = torch.zeros((32, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="shapes"):
        twp.w4_dot_split_k(p, a)
    with pytest.raises(TypeError, match="uint8"):
        twp.w4_dot_split_out(p.view(torch.int8), a)


def test_device_ms_holds_the_bound_after_the_process_idles(cuda):
    """The timer of the smoke and the probes.  Summed torch.profiler kernel
    spans lost the kernels of a short session once the process had idled
    (a 4096³ bf16 matmul read faster than the card's peak); CUDA events
    around calls enqueued behind a held stream do not."""
    a = _normal((1024, 1024), cuda, 0).bfloat16()
    bound_ms = 2 * 1024 ** 3 / 989e12 * 1e3
    first = device_ms(lambda: a @ a)
    time.sleep(40)
    again = device_ms(lambda: a @ a)
    assert first >= bound_ms and again >= bound_ms, (first, again, bound_ms)
    assert 0.5 * first <= again <= 2 * first, (first, again)
