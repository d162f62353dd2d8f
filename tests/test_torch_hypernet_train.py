"""dmi_tpu_torch's HypernetTrainer (stages 2 and 3) against dmi_tpu's, on
shared weights and the fixture data, at f32 on the CPU.

The rotations of the augmentation are JAX's, handed to the port through
HypernetTrainer.rotation, and dropout is 0 where the two packages are
compared (their random bits differ); with it on, the port is compared with
itself: two runs of one seed are bit-identical, and a resumed run ends where
the uninterrupted one ends.  Per-step losses agree to 1e-5 relative (the
same math in another summation order) before any update, to 1e-4 after
them (AdamW's normalized updates carry the f32 differences on, as
tests/test_torch_train.py states); parameters after a few updates within
the JAX package's own coalescing bound (rtol 5e-4, atol 5e-6,
tests/test_hypernet_e2e.py:179-181).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.config import FewshotArgs, TrainArgs
from dmi_tpu.data.fixtures import generate_dataset
from dmi_tpu.data.loader import DatasetLoader as JaxLoader
from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import hypernet as jhn
from dmi_tpu.models import projector as jproj
from dmi_tpu.ops import random_orthogonal as jrandom_orthogonal
from dmi_tpu.registry import dataset_spec
from dmi_tpu.training import optim as joptim
from dmi_tpu.training.embeddings import EmbeddingManager as JaxEmbeddingManager
from dmi_tpu.training.hypernet_trainer import HypernetTrainer as JaxHypernetTrainer
from dmi_tpu.training.hypernet_trainer import TrainState
from dmi_tpu_torch import bridge
from dmi_tpu_torch.data.loader import DatasetLoader
from dmi_tpu_torch.training.embeddings import EmbeddingManager
from dmi_tpu_torch.training.hypernet_trainer import HypernetTrainer
from dmi_tpu_torch.utils.grad_stats import named_leaves
from tests.test_torch_train import _close, _llms

torch.set_num_threads(1)

MM = 32
ENCODER = "timm/ViT-L-16-SigLIP2-384"
FEWSHOT_ENCODER = "mwalmsley/zoobot-encoder-convnext_base"
PARAM_TOL = dict(rtol=5e-4, atol=5e-6)


@pytest.fixture()
def tok(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    generate_dataset("data", "sharegpt4v", "ViT-L-16-SigLIP2-384", mm_dim=MM, n_train=12,
                     n_eval=4, text_dim=MM, seed=1)
    generate_dataset("data", "candels", "zoobot-encoder-convnext_base", mm_dim=MM, n_train=8,
                     n_eval=2, text_dim=MM, seed=2)
    return build_test_tokenizer()


def _args(**kw):
    base = dict(output_dir="x", train_batch_size=4, subset_batch_size=4, eval_batch_size=4,
                epochs=2, dataset_size="full", seed=3, learning_rate=1e-3, warmup_steps=1,
                scheduler="cosine_warmup", gradient_accumulation_steps=2, feed_txt_embs=True,
                augment_emb_space=True, save_steps=1000, eval_steps=1000, generate_steps=1000,
                weight_decay=0.05, checkpoint_dir="ck", output_root="outputs")
    return TrainArgs(**{**base, **kw})


def _pair(tok, args, attn_dropout=0.0, proj_dropout=0.0, fewshot=None, weight_scale=1.0,
          mode="train"):
    """dmi_tpu's HypernetTrainer and the port's on the same LM, frozen
    projector, hypernet and loaders; the port draws JAX's rotations."""
    args = dataclasses.replace(args, mode=mode)
    jcfg, jllm, tcfg, tllm = _llms(vocab=tok.vocab_size + 8, weight_scale=weight_scale)
    pspec = jproj.ProjectorSpec(mm_dim=MM, lm_dim=64, dropout=proj_dropout)
    jpp = jproj.init(jax.random.key(1), pspec)
    hspec = jhn.HypnetSpec(lm_dim=64, mm_dim=MM, n_tokens=args.subset_batch_size,
                           arch="attention", hypnet_dim=MM, rank=4, alpha=4,
                           use_pos_encs=True, attn_dropout=attn_dropout)
    jhp = jhn.init(jax.random.key(2), hspec)
    fargs = fewshot or FewshotArgs(finetune_generated_projector=True)
    loaders = ([("sharegpt4v", ENCODER)] if mode == "train" else [])
    fs = [("candels", FEWSHOT_ENCODER)]

    def build(cls, mgr, pairs):
        return ([cls(dataset_spec(ds), tok, args, enc.split("/")[-1], True, "data")
                 for ds, enc in pairs], [mgr(enc) for _, enc in pairs])

    jl, jm = build(JaxLoader, JaxEmbeddingManager, loaders)
    jfl, jfm = build(JaxLoader, JaxEmbeddingManager, fs)
    jt = JaxHypernetTrainer("jax", jcfg, jllm, pspec, jpp, hspec, jhp, jl, jm, jfl, jfm, tok,
                            args, fargs)
    tl, tm = build(DatasetLoader, EmbeddingManager, loaders)
    tfl, tfm = build(DatasetLoader, EmbeddingManager, fs)
    tt = HypernetTrainer("port", tcfg, tllm, bridge.projector_spec_from_jax(pspec),
                         jax.tree.map(np.asarray, jpp), bridge.hypnet_spec_from_jax(hspec),
                         bridge.hypernet_params_from_jax(jax.tree.map(np.asarray, jhp)),
                         tl, tm, tfl, tfm, tok, args, fargs)
    tt.rotation = lambda step: torch.from_numpy(np.array(jrandom_orthogonal(
        jax.random.fold_in(jt._base_key, 2 * step), MM)))
    return jt, tt


def _jax_step(jt, step, total):
    """One micro-step of dmi_tpu's sequential train loop
    (hypernet_trainer.py:503-516)."""
    idx, batch, subset_raw = jt.fetch_batch(step)
    mgr = jt.emb_mgrs[idx]
    do_update = jt.cond.grad_acc(step, total)
    jt.state, loss, _ = jt._micro_step(
        jt.state, jt.llm_params, mgr.get_embeddings(batch["embs"]),
        mgr.get_embeddings(subset_raw), *jt._device_batch(batch),
        jax.random.fold_in(jt._base_key, 2 * step), jax.random.fold_in(jt._base_key, 2 * step + 1),
        step, do_update, can_rotate=True)
    return float(loss), do_update


def _params_close(tree, jtree, **tol):
    leaves = [(t, j) for (_, t), j in zip(named_leaves(tree), jax.tree.leaves(jtree))]
    assert len(leaves) == len(jax.tree.leaves(jtree))
    for t, j in leaves:
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def test_stage2_losses_and_hypernet_match_dmi_tpu(tok):
    """6 micro-steps with rotation augmentation and text interleave, an
    update every 2nd: per-step losses, update steps and sched_step follow
    dmi_tpu's; the hypernet after 3 updates agrees leaf by leaf."""
    jt, tt = _pair(tok, _args())
    total = tt.total_steps
    assert total == jt.total_steps == 6
    for step in range(total):
        jl, jdid = _jax_step(jt, step, total)
        tl, tdid = tt.train_step(step, total)
        assert tdid == jdid
        _close(tl.item(), jl, 1e-5 if step < 2 else 1e-4)
        assert tt.sched_step == int(jt.state.sched_step)
    _params_close(tt.params, jt.state.params, **PARAM_TOL)
    assert tt._last_grad_stats["grad_global_norm"].item() > 0
    # eval loss through the eval-mode path (no rotation, no dropout)
    _close(tt.evaluate(), jt.evaluate(), 1e-4)


def test_stage2_dropout_and_augmentation_are_reproducible(tok):
    """Attention dropout 0.05 and the port's own rotations: two trainers of
    one seed take bit-identical steps; another seed does not."""
    def run(seed):
        _, tt = _pair(tok, _args(seed=seed), attn_dropout=0.05)
        del tt.rotation  # the port's own draw, from (seed, 2 * step)
        return [tt.train_step(s, 4)[0] for s in range(4)], tt

    (l1, t1), (l2, t2), (l3, _) = run(3), run(3), run(4)
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    for (_, a), (_, b) in zip(named_leaves(t1.params), named_leaves(t2.params)):
        assert torch.equal(a, b)
    assert not torch.equal(l1[0], l3[0])
    r = t1.rotation(5)
    np.testing.assert_allclose((r.T @ r).numpy(), np.eye(MM), atol=1e-5)
    assert torch.equal(r, t2.rotation(5)) and not torch.equal(r, t1.rotation(6))


def test_stage2_coalesced_window_matches_sequential(tok):
    """One accumulation window of 4 micro-steps, 2-way coalesced (one grouped
    lora0 call and one [2B]-row LLM forward per chunk) against the
    sequential micro-steps: the same accumulated loss and the same update."""
    args = _args(gradient_accumulation_steps=4)
    _, seq = _pair(tok, args, attn_dropout=0.05)
    _, coal = _pair(tok, dataclasses.replace(args, micro_batch_coalesce=2), attn_dropout=0.05)
    for t in (seq, coal):
        del t.rotation
    assert coal.coalesce == 2
    seq_loss = sum(seq.train_step(s, 6)[0] for s in range(4))
    window = [(s, *coal.fetch_batch(s)) for s in range(4)]
    coal_loss = coal.run_window(window)
    coal._update(3)
    _close(coal_loss.item(), seq_loss.item(), 1e-5)
    for (_, a), (_, b) in zip(named_leaves(coal.params), named_leaves(seq.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **PARAM_TOL)


def test_stage2_resume_reproduces_uninterrupted_run(tok):
    """Dropout and augmentation on: 4 steps, a checkpoint with the optimizer
    state, a fresh trainer resumed from it and 4 more steps end where 8
    uninterrupted steps end."""
    def make():
        _, tt = _pair(tok, _args(epochs=3), attn_dropout=0.05)
        del tt.rotation
        return tt

    t1 = make()
    for step in range(8):
        t1.train_step(step, 9)
    t2 = make()
    for step in range(4):
        t2.train_step(step, 9)
    t2.ckpt.save(3, 1.0, "loss", t2.param_tree(), optimizer_state=t2.optimizer_state())
    t3 = make()
    assert t3.load_checkpoint(t2.ckpt.best_path)["step_idx"] == 3 and t3.sched_step == 3
    for step in range(4, 8):
        t3.train_step(step, 9)
    for (_, a), (_, b) in zip(named_leaves(t1.params), named_leaves(t3.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7)


def test_stage2_resumes_from_a_dmi_tpu_checkpoint(tok):
    """dmi_tpu trains 4 micro-steps and writes its checkpoint with the optax
    state; the port loads it (AdamW moments, step count, sched_step) and its
    next update equals dmi_tpu's."""
    jt, tt = _pair(tok, _args(epochs=3))
    total = jt.total_steps
    for step in range(4):
        _jax_step(jt, step, total)
    jt.ckpt.save(3, 1.0, "loss", jt.state.params, optimizer_state=jt.state.opt_state)
    assert tt.load_checkpoint(jt.ckpt.best_path) == {"step_idx": 3}
    assert tt.sched_step == 3
    _params_close(tt.params, jt.state.params, rtol=0, atol=0)
    for step in (4, 5):
        jl, _ = _jax_step(jt, step, total)
        tl, _ = tt.train_step(step, total)
        _close(tl.item(), jl, 1e-5)
    _params_close(tt.params, jt.state.params, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("finetune_generated", [True, False],
                         ids=["generated-projector", "hypernet"])
def test_stage3_fewshot_matches_dmi_tpu(tok, finetune_generated):
    """The generated projector from the mean of two subset draws, then 4
    few-shot micro-steps (an update every 2nd) over it or over the hypernet:
    per-step losses and the trained parameters against dmi_tpu's few-shot
    step (_build_fewshot_step); then both decode identical greedy captions
    from the generated projector."""
    fargs = FewshotArgs(finetune_generated_projector=finetune_generated,
                        fewshot_learning_rate=1e-3, fewshot_weight_decay=1e-3)
    jt, tt = _pair(tok, _args(), fewshot=fargs, weight_scale=10.0, mode="fewshot")
    jt.fewshot_generate_adapters(0)
    tt.fewshot_generate_adapters(0)
    if finetune_generated:
        _params_close(tt.generated_projector, jt.generated_projector, rtol=1e-5, atol=1e-6)
    trainable = jt.generated_projector if finetune_generated else jt.state.params
    fs_opt = joptim.make_optimizer(TrainArgs(
        output_dir="x", learning_rate=1e-3, weight_decay=1e-3, max_grad_norm=1.0,
        adam_beta1=0.9, adam_beta2=0.999, adam_epsilon=1e-8))
    fs_state = TrainState(trainable, fs_opt.init(trainable),
                          jax.tree.map(jnp.zeros_like, trainable), jnp.asarray(0, jnp.int32))
    micro = jt._build_fewshot_step(fs_opt, 1e-3)
    t_opt = tt.fewshot_optimizer()
    loader, jmgr, tmgr = tt.fewshot_loaders[0], jt.fewshot_emb_mgrs[0], tt.fewshot_emb_mgrs[0]
    total = 4
    for step in range(total):
        batch, subset_raw = loader.train_batch(step), loader.subset_batch(step, "train")
        do_update = jt.cond.grad_acc(step, total)
        fs_state, jl = micro(fs_state, jt.llm_params, jmgr.get_embeddings(batch["embs"]),
                             jmgr.get_embeddings(subset_raw), *jt._device_batch(batch),
                             jax.random.fold_in(jt._base_key, 3 * step + 2), do_update)
        tl, tdid = tt.fewshot_train_step(step, total, batch, subset_raw, tmgr, t_opt)
        assert tdid == do_update
        _close(tl.item(), float(jl), 1e-5 if step < 2 else 1e-4)
    ported = tt.generated_projector if finetune_generated else tt.params
    _params_close(ported, fs_state.params, **PARAM_TOL)

    if finetune_generated:
        jt.generated_projector = jax.tree.map(
            jnp.asarray, jax.tree.map(lambda t: t.detach().numpy(), tt.generated_projector))
        _, jgts, jpreds, jids = jt.generate("test", fewshot_idx=0)
        _, tgts, tpreds, tids = tt.generate("test", fewshot_idx=0)
        assert (tgts, tids) == (jgts, jids)
        assert tpreds == jpreds


def test_trainers_refuse_unported_options():
    """Multi-card training (ported: tests/test_torch_parallel_train.py)
    needs a process group first; the LoRA baseline does not fine-tune from a
    checkpoint, as dmi_tpu's refuses to."""
    import types

    from dmi_tpu_torch.training.lora_trainer import LoraTrainer

    with pytest.raises(RuntimeError, match="init_distributed"):
        HypernetTrainer("x", None, {"embed": torch.zeros(2, 2)}, None, None, None, None, [], [],
                        [], [], None, _args(mesh_shape=[1, 1]), None)
    with pytest.raises(NotImplementedError, match="fine-tune"):
        LoraTrainer(lora_spec=None, lora_params=[], frozen_proj_params={},
                    train_args=types.SimpleNamespace(finetune_from_checkpoint="ck.pt"))
