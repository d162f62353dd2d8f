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
from dmi_tpu_torch.ops.cuda import flash_attn as tfa
from dmi_tpu_torch.ops.cuda import lora0 as tl0
from dmi_tpu_torch.ops.cuda import projector as tpk

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
    (37, 1024, 4096, 4096, torch.bfloat16),   # an 8B-wide projector (11-row tiles)
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
