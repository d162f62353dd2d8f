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

import numpy as np
import pytest
import torch

from dmi_tpu_torch.models import decode as dec
from dmi_tpu_torch.models import llama
from dmi_tpu_torch.ops.cuda import decode_attn as tda
from dmi_tpu_torch.ops.cuda import projector as tpk

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
    (37, 1024, 4096, 4096, torch.bfloat16),   # an 8B-wide projector (11-row tiles)
])
def test_mlp2_kernel_matches_twin(cuda, B, mm, lm, lm2, dtype):
    args = _mlp2_args(B, mm, lm, lm2, dtype, cuda)
    n0 = tpk.launches
    out = tpk.fused_mlp2(*args)
    assert tpk.launches == n0 + 1
    _close(out, tpk._mlp2_plain(*args), TOL[dtype])


def test_mlp2_kernel_refuses_grad_and_mixed_dtypes(cuda):
    args = _mlp2_args(4, 32, 64, 64, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tpk.fused_mlp2(args[0].requires_grad_(), *args[1:])
    args = _mlp2_args(4, 32, 64, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="one dtype"):
        tpk.fused_mlp2(args[0].bfloat16(), *args[1:])


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
    (1, 32, 8, 3000, 64, torch.float32, None),    # near the shared-memory cap
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


def test_decode_attn_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _attn_args(2, 8, 2, 5000, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="S 5000"):
        tda.fused_decode_attention(q, k, v, torch.zeros(5000, device=cuda))
    q, k, v = _attn_args(2, 8, 2, 10, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        tda.fused_decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v,
                                   torch.zeros(10, device=cuda))


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
