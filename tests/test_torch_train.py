"""dmi_tpu_torch's stage-1 projector training against dmi_tpu's, on shared
weights.

Same inputs (numpy seeds, the byte-BPE tokenizer fixture, the synthetic
sydney fixture data) through both packages at f32 on the CPU:

  * llama.forward logits, causal_lm_loss and mmmodel.caption_loss (both
    mask_padding values), with the gradient with respect to the soft tokens
    and the projector: 1e-5 relative (summation order only);
  * the optimizer, clip + AdamW + schedule over 6 steps: 1e-6 relative;
  * ProjectorTrainer's per-step losses over 8 micro-steps with gradient
    accumulation 2, at dropout 0: 1e-4 relative (8 micro-steps of
    differently ordered f32 sums feeding AdamW's normalized updates);
  * dropout: keep rate and scaling statistically, the draws exactly
    reproducible per (seed, step);
  * the end-to-end CLI path (train_projector.run) and checkpoints read
    across the packages.

Tolerances are relative to max(1, max |reference|).
"""

import dataclasses
import json
import os
import os.path as osp
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.config import TrainArgs
from dmi_tpu.data.fixtures import generate_dataset
from dmi_tpu.data.loader import DatasetLoader
from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import mmmodel as jmm
from dmi_tpu.models import projector as jproj
from dmi_tpu.registry import dataset_spec
from dmi_tpu.training import optim as joptim
from dmi_tpu.training.embeddings import EmbeddingManager as JaxEmbeddingManager
from dmi_tpu.training.projector_trainer import ProjectorTrainer as JaxTrainer
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.models import mmmodel as tmm
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.training import checkpoint as tckpt
from dmi_tpu_torch.training import optim as toptim
from dmi_tpu_torch.training.embeddings import EmbeddingManager
from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer, dropout_generator

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ENCODER = "chendelong/RemoteCLIP-RN50-Unchanged"


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _llms(vocab=96, seed=0, weight_scale=1.0):
    """A tiny f32 dmi_tpu LM on its additive-bias path, and the port's copy."""
    jcfg = dataclasses.replace(
        jllama.tiny_config(vocab_size=vocab, hidden_size=64, n_layers=2, n_heads=4, n_kv=2,
                           intermediate=128),
        attention_impl="xla",
    )
    jparams = jllama.init(jax.random.key(seed), jcfg)
    jparams["layers"] = {k: v * weight_scale if k.startswith("w") else v
                         for k, v in jparams["layers"].items()}
    tparams = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.config_from_jax(jcfg), tparams


def _text_batch(B, T, vocab, seed):
    """Right-padded ids, their mask and labels in the collator's schema:
    -100 over a 3-token prompt, the pad id as label on pads."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(B, T))
    lens = [T - 4 * b for b in range(B)]
    mask = np.zeros((B, T), np.int32)
    labels = ids.copy()
    for b, n in enumerate(lens):
        mask[b, :n] = 1
        ids[b, n:] = 1
        labels[b, n:] = 1
        labels[b, :3] = -100
    return ids, mask, labels


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "attention-mask"])
def test_forward_logits_and_causal_lm_loss_match(masked):
    jcfg, jparams, tcfg, tparams = _llms()
    x = np.random.default_rng(1).normal(size=(3, 12, 64)).astype(np.float32)
    _, mask, labels = _text_batch(3, 12, 96, 2)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ref = jllama.forward(jcfg, jparams, jnp.asarray(x), jm)
    out = tllama.forward(tcfg, tparams, torch.from_numpy(x), tm)
    _close(out.numpy(), np.asarray(ref), 1e-5)
    _close(tllama.causal_lm_loss(out, torch.from_numpy(labels)).item(),
           float(jllama.causal_lm_loss(ref, jnp.asarray(labels))), 1e-5)


def test_causal_lm_loss_with_no_valid_label_is_zero():
    logits = torch.randn(2, 5, 7)
    assert tllama.causal_lm_loss(logits, torch.full((2, 5), -100)).item() == 0.0


@pytest.mark.parametrize("mask_padding", [False, True])
def test_caption_loss_and_gradients_match(mask_padding):
    """Loss, its gradient with respect to the soft tokens, and with respect
    to every projector parameter through the eval-mode projector
    (fused_mlp2's autograd.Function against dmi_tpu's custom_vjp)."""
    jcfg, jparams, tcfg, tparams = _llms(weight_scale=5.0)
    jspec = jproj.ProjectorSpec(mm_dim=24, lm_dim=64)
    jpp = jproj.init(jax.random.key(1), jspec)
    rng = np.random.default_rng(3)
    embs = rng.normal(size=(3, 24)).astype(np.float32)
    ids, mask, labels = _text_batch(3, 10, 96, 4)
    jargs = tuple(map(jnp.asarray, (ids, mask, labels)))
    targs = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(labels))

    def jloss(pp, soft_delta):
        soft = jproj.apply(jspec, pp, jnp.asarray(embs)) + soft_delta
        return jmm.caption_loss(jcfg, jparams, soft, *jargs, mask_padding=mask_padding)

    ref, (jg_pp, jg_soft) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jpp, jnp.zeros((3, 64), jnp.float32))

    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    leaves = [t.requires_grad_() for layer in tpp["layers"] for t in (layer["b"], layer["w"])]
    soft = tproj.apply(bridge.projector_spec_from_jax(jspec), tpp, torch.from_numpy(embs))
    soft.retain_grad()
    loss = tmm.caption_loss(tcfg, tparams, soft, *targs, mask_padding=mask_padding)
    loss.backward()
    _close(loss.item(), float(ref), 1e-5)
    _close(soft.grad.numpy(), np.asarray(jg_soft), 1e-5)
    want = [g for layer in jg_pp["layers"] for g in (layer["b"], layer["w"])]
    for t, g in zip(leaves, want):
        _close(t.grad.numpy(), np.asarray(g), 1e-5)


def test_caption_loss_mask_padding_changes_ragged_loss():
    """The reference quirk: without mask_padding the pads are attended."""
    _, _, tcfg, tparams = _llms(weight_scale=5.0)
    ids, mask, labels = _text_batch(3, 10, 96, 5)
    soft = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    args = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(labels))
    a = tmm.caption_loss(tcfg, tparams, soft, *args).item()
    b = tmm.caption_loss(tcfg, tparams, soft, *args, mask_padding=True).item()
    assert abs(a - b) > 1e-4


def test_optimizer_matches_optax_over_six_steps():
    """clip + AdamW + cosine warmup against dmi_tpu.training.optim (optax),
    with the LR of each update taken at the previous update's step
    (sched_step).  Steps 1 and 4 carry gradients above max_grad_norm, so
    they clip.  torch's clip_grad_norm_ divides by norm + 1e-6, optax by the
    norm: a relative difference of 1e-6 / norm on those steps, inside the
    tolerance."""
    args = TrainArgs(output_dir="x", learning_rate=1e-2, warmup_steps=2, max_grad_norm=1.0,
                     weight_decay=0.05, adam_beta1=0.9, adam_beta2=0.95, adam_epsilon=1e-8,
                     scheduler="cosine_warmup")
    rng = np.random.default_rng(7)
    params = {"layers": [{"b": rng.normal(size=(4,)).astype(np.float32),
                          "w": rng.normal(size=(5, 4)).astype(np.float32)}]}
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * s).astype(np.float32), params)
             for s in (0.05, 3.0, 0.1, 0.02, 2.0, 0.08)]
    total = len(grads)
    assert [float(np.sqrt(sum((x ** 2).sum() for x in jax.tree.leaves(g)))) > 1.0
            for g in grads] == [False, True, False, False, True, False]

    jlr = joptim.make_lr_fn(args, total)
    jopt = joptim.make_optimizer(args)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tlr = toptim.make_lr_fn(args, total)
    tleaves = [torch.from_numpy(params["layers"][0][n].copy()).requires_grad_()
               for n in ("b", "w")]
    topt = toptim.make_optimizer(args, tleaves)
    sched = 0
    for step, g in enumerate(grads):
        assert tlr(sched) == pytest.approx(float(jlr(sched)), rel=1e-6)
        jstate = joptim.set_lr(jstate, jlr(sched))
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(jnp.add, jp, updates)
        for t, n in zip(tleaves, ("b", "w")):
            t.grad = torch.from_numpy(g["layers"][0][n].copy())
        toptim.set_lr(topt, tlr(sched))
        toptim.clip_and_step(topt, args.max_grad_norm)
        sched = step
        for t, n in zip(tleaves, ("b", "w")):
            _close(t.detach().numpy(), np.asarray(jp["layers"][0][n]), 1e-6)
    assert tlr(0) == 0.0 and tlr(1) == pytest.approx(5e-3)


@pytest.mark.parametrize("scheduler", ["linear_warmup", None])
def test_lr_schedules_match(scheduler):
    args = TrainArgs(output_dir="x", learning_rate=3e-4, warmup_steps=5, scheduler=scheduler)
    jlr, tlr = joptim.make_lr_fn(args, 20), toptim.make_lr_fn(args, 20)
    for step in range(20):
        assert tlr(step) == pytest.approx(float(jlr(step)), rel=1e-6)


def test_grad_summary_matches_dmi_tpu():
    from dmi_tpu.utils import grad_stats as jgs
    from dmi_tpu_torch.utils import grad_stats as tgs

    rng = np.random.default_rng(8)
    grads = {"layers": [{"w": (rng.normal(size=(6, 5)) * 10.0 ** rng.integers(-9, 2, (6, 5))
                               ).astype(np.float32),
                         "b": rng.normal(size=(5,)).astype(np.float32)} for _ in range(2)]}
    ref = jgs.host_grad_summary(jgs.grad_summary(jax.tree.map(jnp.asarray, grads)))
    out = tgs.host_grad_summary(tgs.grad_summary(jax.tree.map(torch.from_numpy, grads)))
    assert list(out) == list(ref)
    assert out["grad_hist"] == ref["grad_hist"]
    for k in ref:
        if k != "grad_hist":
            assert out[k] == pytest.approx(ref[k], rel=1e-6)


def test_step_conditions_and_loader_choice_match_dmi_tpu():
    from dmi_tpu.training import trainer as jtr
    from dmi_tpu_torch.training import trainer as ttr

    for kw in ({}, {"eval_steps_l": [3, 7], "save_steps_l": [5], "generate_steps_l": [2]},
               {"gradient_accumulation_steps": 3, "eval_at_step_zero": True,
                "generate_at_step_zero": True}):
        args = TrainArgs(output_dir="x", eval_steps=4, save_steps=3, generate_steps=5, **kw)
        jc, tc = jtr.StepConditions(args), ttr.StepConditions(args)
        for step in range(12):
            for name in ("grad_acc", "evaluate", "generate", "save"):
                assert getattr(tc, name)(step, 12) == getattr(jc, name)(step, 12), (kw, name)
    for step in range(20):
        assert ttr.pick_loader(3, step, 3, [4, 1, 2]) == jtr.pick_loader(3, step, 3, [4, 1, 2])
        assert ttr.pick_loader(3, step, 4) == jtr.pick_loader(3, step, 4)
    texts = ["user\n\nDescribe assistant\n\n\n A cat. ", "no marker"]
    assert ttr.strip_to_assistant(texts) == jtr.strip_to_assistant(texts)


def test_dropout_keep_rate_scaling_and_determinism():
    """Dropout's bits are torch's, not JAX's: both keep 1 - rate of the
    elements (within 5 sigma over 2**18 draws) and scale them by 1 / keep;
    the port's draws are a pure function of (seed, step)."""
    n = 1 << 18
    x = np.ones((64, n // 64), np.float32)
    jy = np.asarray(jproj._dropout(jnp.asarray(x), 0.1, jax.random.key(0), True))
    ty = tproj._dropout(torch.from_numpy(x), 0.1, torch.Generator().manual_seed(0)).numpy()
    sigma = np.sqrt(0.1 * 0.9 / n)
    for y in (jy, ty):
        assert abs((y != 0).mean() - 0.9) < 5 * sigma
        np.testing.assert_allclose(y[y != 0], 1 / 0.9, rtol=1e-7)

    spec = tproj.ProjectorSpec(mm_dim=8, lm_dim=16, n_layers=3, dropout=0.1)
    params = tproj.init(spec, torch.Generator().manual_seed(1))
    xs = torch.randn(5, 8, generator=torch.Generator().manual_seed(2))

    def run(step):
        return tproj.apply(spec, params, xs, train=True,
                           generator=dropout_generator(11, step, "cpu"))

    assert torch.equal(run(4), run(4))
    assert not torch.equal(run(4), run(5))
    assert torch.equal(tproj.apply(spec, params, xs),
                       tproj.apply(spec, params, xs, train=True))  # no generator: identity


def test_prune_and_spec_bridge():
    jspec = jproj.ProjectorSpec(mm_dim=12, lm_dim=8, act="quick_gelu", dropout=0.25)
    assert bridge.projector_spec_from_jax(jspec) == tproj.ProjectorSpec(
        mm_dim=12, lm_dim=8, dropout=0.25)
    jpp = jproj.init(jax.random.key(0), jspec)
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    ref = jproj.prune(jpp, 5)
    out = tproj.prune(tpp, 5)
    for a, b in zip(jax.tree.leaves(ref), [out["layers"][i][n] for i in range(2)
                                           for n in ("b", "w")]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# Trainers on the fixture data
# ---------------------------------------------------------------------------


@pytest.fixture()
def fixture_data(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    generate_dataset("data", "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=32,
                     n_train=8, n_eval=2, seed=0)
    return build_test_tokenizer()


def _train_args(**kw):
    base = dict(output_dir="x", train_batch_size=5, eval_batch_size=4, epochs=1,
                dataset_size="full", seed=3, learning_rate=1e-3, warmup_steps=2,
                save_steps=1000, eval_steps=1000, generate_steps=1000)
    return TrainArgs(**{**base, **kw})


def _both_trainers(tok, args, dropout=0.0, weight_scale=1.0):
    jcfg, jllm, tcfg, tllm = _llms(vocab=tok.vocab_size + 8, weight_scale=weight_scale)
    jspec = jproj.ProjectorSpec(mm_dim=32, lm_dim=64, dropout=dropout)
    jpp = jproj.init(jax.random.key(1), jspec)
    loader = DatasetLoader(dataset_spec("sydney"), tok, args, "RemoteCLIP-RN50-Unchanged",
                           True, "data")
    jt = JaxTrainer(name="parity", llm_cfg=jcfg, llm_params=jllm, proj_spec=jspec,
                    proj_params=jpp, loaders=[loader], emb_mgrs=[JaxEmbeddingManager(ENCODER)],
                    tokenizer=tok, train_args=args)
    tt = ProjectorTrainer(name="parity", llm_cfg=tcfg, llm_params=tllm,
                          proj_spec=bridge.projector_spec_from_jax(jspec),
                          proj_params=bridge.projector_params_from_train_state(jt.state),
                          loaders=[loader], emb_mgrs=[EmbeddingManager(ENCODER)],
                          tokenizer=tok, train_args=args)
    return jt, tt


def test_trainer_losses_match_dmi_tpu_with_accumulation(fixture_data):
    """8 micro-steps, an update every 2nd: identical update steps, per-step
    losses (already divided by the accumulation) and final parameters to
    1e-4; the port's sched_step follows dmi_tpu's.  Then both generate
    from the port's trained projector: identical greedy captions (LM
    weights x10 so that greedy decode emits varied tokens)."""
    tok = fixture_data
    jt, tt = _both_trainers(tok, _train_args(gradient_accumulation_steps=2),
                            weight_scale=10.0)
    total = tt.total_steps
    assert total == jt.total_steps == 8
    for step in range(total):
        jl, jdid = jt.train_step(step, total)
        tl, tdid = tt.train_step(step, total)
        assert tdid == jdid == (step % 2 == 1)
        _close(tl.item(), float(jl), 1e-4)
        assert tt.sched_step == int(jt.state.sched_step)
    for (_, t), j in zip(bridge_leaves(tt), jax.tree.leaves(jt.state.params)):
        _close(t.detach().numpy(), np.asarray(j), 1e-4)
    stats = tt._last_grad_stats
    assert stats["grad_norm/layers.0.w"].item() > 0 and stats["grad_hist"].sum() > 0

    jt.state = jt.state._replace(
        params=jax.tree.map(jnp.asarray, tckpt.to_numpy(tt.param_tree())))
    _, jgts, jpreds, jids = jt.generate("test")
    _, tgts, tpreds, tids = tt.generate("test")
    assert (tgts, tids) == (jgts, jids)
    assert tpreds == jpreds
    assert len({p for ps in tpreds.values() for p in ps}) > 1


def bridge_leaves(trainer):
    from dmi_tpu_torch.utils.grad_stats import named_leaves

    return named_leaves(trainer.params)


def test_trainer_evaluate_matches_dmi_tpu(fixture_data):
    jt, tt = _both_trainers(fixture_data, _train_args(eval_batch_size=3))
    _close(tt.evaluate(), jt.evaluate(), 1e-5)


def test_trainer_resume_reproduces_uninterrupted_run(fixture_data):
    """Dropout 0.1 and gradient accumulation 2: 4 steps, a checkpoint with
    the optimizer state, a fresh trainer resumed from it and 4 more steps
    end where 8 uninterrupted steps end."""
    tok = fixture_data
    args = _train_args(gradient_accumulation_steps=2, checkpoint_dir="ck")

    def make():
        return _both_trainers(tok, args, dropout=0.1)[1]

    t1 = make()
    for step in range(8):
        t1.train_step(step, 8)
    t2 = make()
    for step in range(4):
        t2.train_step(step, 8)
    t2.ckpt.save(3, 0.0, "coco_cider", t2.param_tree(), optimizer_state=t2.optimizer_state())
    t3 = make()
    assert t3.resume() == 4 and t3.sched_step == 3
    for step in range(4, 8):
        t3.train_step(step, 8)
    for (_, a), (_, b) in zip(bridge_leaves(t1), bridge_leaves(t3)):
        _close(a.detach().numpy(), b.detach().numpy(), 1e-6)


def test_checkpoints_read_across_packages(fixture_data, tmp_path):
    """The port's checkpoint is dmi_tpu's envelope: dmi_tpu loads its
    projector and fine-tunes from it (pruned to a narrower mm_dim).
    dmi_tpu's checkpoint loads in the port, which fine-tunes from it too and
    resumes from it, with the AdamW moments of dmi_tpu's optax state."""
    from dmi_tpu.training.checkpoint import BestCheckpointer as JaxCheckpointer
    from dmi_tpu.training.checkpoint import load_pytree as jload

    tok = fixture_data
    jt, tt = _both_trainers(tok, _train_args())
    tt.train_step(0, 8)
    tt.ckpt.save(0, 0.5, "coco_cider", tt.param_tree(), optimizer_state=tt.optimizer_state())
    env = jload(tt.ckpt.best_path)
    assert env["step_idx"] == 0 and env["coco_cider"] == 0.5
    assert env["optimizer_state_dict"]["format"] == tckpt.ADAMW_FORMAT
    for (_, t), a in zip(bridge_leaves(tt), jax.tree.leaves(env["projector_state_dict"])):
        np.testing.assert_array_equal(a, t.detach().numpy())

    jt.train_step(0, 8)
    jck = JaxCheckpointer(str(tmp_path / "jck"), "jax", "projector")
    jck.save(2, 0.25, "coco_cider", jt.state.params, optimizer_state=jt.state.opt_state)
    env = tckpt.load_pytree(jck.best_path)
    for (_, t), a in zip(bridge_leaves(tt), jax.tree.leaves(env["projector_state_dict"])):
        assert a.shape == tuple(t.shape)
    port_w = tt.params["layers"][0]["w"].detach().clone()
    assert tt.resume(jck.best_path) == 3 and tt.sched_step == 2
    adam = jt.state.opt_state[1].inner_state[0]
    for leaf, mu, nu in zip(tt.leaves, jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)):
        state = tt.opt.state[leaf]
        assert state["step"].item() == int(adam.count) == 1
        np.testing.assert_array_equal(state["exp_avg"].numpy(), np.asarray(mu))
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), np.asarray(nu))

    # fine-tune each package from the other's checkpoint at mm_dim 20
    ft_args = _train_args(finetune_from_checkpoint=tt.ckpt.best_path)
    loader = DatasetLoader(dataset_spec("sydney"), tok, ft_args, "RemoteCLIP-RN50-Unchanged",
                           True, "data")
    jft = JaxTrainer(name="ft", llm_cfg=jt.llm_cfg, llm_params=jt.llm_params,
                     proj_spec=jproj.ProjectorSpec(mm_dim=20, lm_dim=64),
                     proj_params=jt.state.params, loaders=[loader],
                     emb_mgrs=[JaxEmbeddingManager(ENCODER)], tokenizer=tok,
                     train_args=ft_args)
    assert jft.TRAINER_TYPE == "ft_projector"
    np.testing.assert_array_equal(np.asarray(jft.state.params["layers"][0]["w"]),
                                  port_w.numpy()[:20])
    ft_args = _train_args(finetune_from_checkpoint=jck.best_path)
    tft = ProjectorTrainer(name="ft", llm_cfg=tt.llm_cfg, llm_params=tt.llm_params,
                           proj_spec=tproj.ProjectorSpec(mm_dim=20, lm_dim=64),
                           proj_params=tt.param_tree(), loaders=[loader],
                           emb_mgrs=[EmbeddingManager(ENCODER)], tokenizer=tok,
                           train_args=ft_args)
    assert tft.TRAINER_TYPE == "ft_projector"
    np.testing.assert_array_equal(tft.params["layers"][0]["w"].detach().numpy(),
                                  np.asarray(jt.state.params["layers"][0]["w"])[:20])


def test_trainer_refuses_unported_options(tmp_path, monkeypatch):
    """Multi-card training (ported: tests/test_torch_parallel_train.py) needs
    a process group first; a hub id the HF cache does not hold is an error
    that names where it looked.  The MoE and MLA families, once refused
    here, build (tests/test_torch_families_e2e.py trains them)."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        ProjectorTrainer("x", None, {"embed": torch.zeros(2, 2)}, None, None, [], [], None,
                         _train_args(mesh_shape=[1, 1]))
    from dmi_tpu.config import LMArgs
    from dmi_tpu_torch.training.model_utils import build_lm

    monkeypatch.delenv("DMI_LM_OVERRIDE", raising=False)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="models--meta-llama--Llama-3.2-1B-Instruct"):
        build_lm(LMArgs(lm_name_or_path="meta-llama/Llama-3.2-1B-Instruct"), None)
    from dmi_tpu.data.tok_fixture import build_test_tokenizer

    cfg, _ = build_lm(LMArgs(lm_name_or_path="test:tiny-mixtral"), build_test_tokenizer())
    assert cfg.num_experts == 4
    assert bridge.config_from_jax(jllama.tiny_mixtral_config()).num_experts == 4


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def _e2e_config(tmp_path, **overrides):
    """tests/test_projector_e2e.py's configuration."""
    cfg = {
        "output_dir": "proj_1", "train_batch_size": 4, "eval_batch_size": 4,
        "learning_rate": 1e-3, "epochs_l": [2], "dataset_size_l": ["full"],
        "warmup_steps": 2, "scheduler": "cosine_warmup", "logging_steps": 8,
        "save_steps": 8, "eval_steps": 8, "generate_steps": 8, "seeds": [7],
        "pad_to_multiple_of": 8, "menc_names_or_paths": [ENCODER], "mm_dim": 32,
        "load_extracted_features": [True], "lm_name_or_path": "test:tiny",
        "lm_dtype": "float32", "dataset_names_or_paths": ["sydney"],
        "proj_name_or_path": "proj_1", "proj_arch": "mlp", "proj_n_layers": 2,
        "proj_dropout": 0.1, "output_root": "outputs",
    }
    cfg.update(overrides)
    path = tmp_path / "cfg_projector_smoke.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_projector_end_to_end_through_run(tmp_path, monkeypatch):
    """tests/test_projector_e2e.py::test_projector_end_to_end through
    dmi_tpu_torch.train_projector.run: the results JSON has dmi_tpu's keys,
    metric names, references and ids, and dmi_tpu's trainer decodes the
    same greedy captions from the port's trained projector and LM."""
    from dmi_tpu.config import LMArgs
    from dmi_tpu_torch.train_projector import run
    from dmi_tpu_torch.training.model_utils import build_lm

    monkeypatch.chdir(tmp_path)
    generate_dataset("data", "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=32,
                     n_train=4, n_eval=2, seed=0)
    cfg_path = _e2e_config(tmp_path)
    run(cfg_path, device="cpu")
    run_file = osp.join("outputs", "projector:cfg_projector_smoke-dszfull-seed7-results.json")
    results = json.load(open(run_file))
    assert set(results) == {"metrics", "gts", "preds", "ids", "eval_env"}
    assert results["eval_env"]["coco_meteor_stages"] == ["exact", "stem"]
    assert len(results["preds"]["RemoteCLIP-RN50-Unchanged"]) == 10
    agg = json.load(open(osp.join("outputs", "sydney-results.json")))
    assert "projector:cfg_projector_smoke-dszfull" in agg
    best = osp.join("checkpoints",
                    "cfg_projector_smoke-dszfull-seed7-checkpoint-projector-best.pt")
    assert osp.exists(best)
    mtime = os.path.getmtime(run_file)
    run(cfg_path, device="cpu")  # idempotent skip
    assert os.path.getmtime(run_file) == mtime

    tok = build_test_tokenizer()
    tcfg, tllm = build_lm(LMArgs(lm_name_or_path="test:tiny", lm_dtype="float32"), tok,
                          seed=7)
    jcfg = jllama.tiny_config(vocab_size=tcfg.vocab_size, hidden_size=64, n_layers=2,
                              n_heads=4, n_kv=2, intermediate=128,
                              eos=tcfg.eos_token_ids)
    args = _train_args(seed=7, train_batch_size=4, epochs=2)
    loader = DatasetLoader(dataset_spec("sydney"), tok, args, "RemoteCLIP-RN50-Unchanged",
                           True, "data")
    jt = JaxTrainer(name="e2e", llm_cfg=jcfg,
                    llm_params=jax.tree.map(jnp.asarray, bridge.llm_params_to_numpy(tllm)),
                    proj_spec=jproj.ProjectorSpec(mm_dim=32, lm_dim=64),
                    proj_params=jax.tree.map(jnp.asarray,
                                             tckpt.load_pytree(best)["projector_state_dict"]),
                    loaders=[loader], emb_mgrs=[JaxEmbeddingManager(ENCODER)],
                    tokenizer=tok, train_args=args)
    metrics, gts, preds, ids = jt.generate("test")
    assert set(results["metrics"]["RemoteCLIP-RN50-Unchanged"]) == set(
        metrics["RemoteCLIP-RN50-Unchanged"])
    assert results["gts"] == gts and results["ids"] == ids
    assert results["preds"] == preds


def test_train_projector_cli(tmp_path):
    """python -m dmi_tpu_torch.train_projector <config.json> --device cpu."""
    env = dict(os.environ, PYTHONPATH=str(REPO), WANDB_MODE="disabled")
    r = subprocess.run(
        [sys.executable, "-c", "from dmi_tpu.data.fixtures import generate_dataset; "
         "generate_dataset('data', 'sydney', 'RemoteCLIP-RN50-Unchanged', mm_dim=32, "
         "n_train=4, n_eval=2, seed=0)"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    cfg_path = _e2e_config(tmp_path, epochs_l=[1], save_steps=4, eval_steps=4,
                           generate_steps=4)
    r = subprocess.run(
        [sys.executable, "-m", "dmi_tpu_torch.train_projector", cfg_path, "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "outputs" / "projector:cfg_projector_smoke-dszfull-seed7-results.json"
            ).exists()
    assert "Starting training" in r.stderr
