"""dmi_tpu_torch's stage-2/3 modules against dmi_tpu's, on shared weights.

Same inputs (numpy seeds) through both packages at f32 on the CPU:
hypernet.apply for every arch, with and without positional encodings and
with a padded z (eval mode, 1e-5 relative: the same math in another
summation order); average_adapters, lora_apply (both branches),
module_lora_apply and combine_lora; interleave_rows and
sinusoidal_positions; process_embeddings with JAX's rotation handed in;
random_orthogonal's properties; causal_lm_loss_grouped.  Tolerances are
relative to max(1, max |reference|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmi_tpu.models import hypernet as jhn
from dmi_tpu.models import llama as jllama
from dmi_tpu.models import lora as jlora
from dmi_tpu.models import projector as jproj
from dmi_tpu.ops import linalg as jlinalg
from dmi_tpu.training import hypernet_trainer as jht
from dmi_tpu_torch import bridge
from dmi_tpu_torch.models import hypernet as thn
from dmi_tpu_torch.models import llama as tllama
from dmi_tpu_torch.models import lora as tlora
from dmi_tpu_torch.models import projector as tproj
from dmi_tpu_torch.ops import linalg as tlinalg
from dmi_tpu_torch.training import hypernet_trainer as tht
from dmi_tpu_torch.utils.grad_stats import named_leaves

torch.set_num_threads(1)


def _close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _spec(arch, pos, **kw):
    base = dict(lm_dim=48, mm_dim=24, n_tokens=5, arch=arch, n_heads=2, hypnet_dim=32, rank=4,
                alpha=8, use_pos_encs=pos)
    return jhn.HypnetSpec(**{**base, **kw})


def _both_hypernets(jspec, seed=0):
    jparams = jhn.init(jax.random.key(seed), jspec)
    return jparams, bridge.hypernet_params_from_jax(jax.tree.map(np.asarray, jparams))


def _adapters_close(out, ref, tol=1e-5):
    for ts, js in zip(out, ref):
        if js is None:
            assert ts is None
            continue
        assert len(ts) == len(js)
        for t, j in zip(ts, js):
            _close(t.detach().numpy(), j, tol)


@pytest.mark.parametrize("pos", [False, True], ids=["no-pe", "pe"])
@pytest.mark.parametrize("arch", ["attention", "att_w_nonlinear", "transformer"])
def test_hypernet_apply_matches(arch, pos):
    jspec = _spec(arch, pos, n_layers=2 if arch == "transformer" else 1)
    jparams, tparams = _both_hypernets(jspec)
    tspec = bridge.hypnet_spec_from_jax(jspec)
    assert tspec.context_len == jspec.context_len == 13
    assert [tspec.gen_out_dim(i) for i in range(2)] == [jspec.gen_out_dim(i) for i in range(2)]
    z = np.random.default_rng(1).normal(size=(7, 32)).astype(np.float32)
    ref = jhn.apply(jspec, jparams, jnp.asarray(z))
    out = thn.apply(tspec, tparams, torch.from_numpy(z))
    _adapters_close(out, ref)
    # layer 0's `a` is cut to mm_dim * rank (hypnet_dim 32 > mm_dim 24)
    assert out[0][0].shape == (24 * 4,) and out[0][1].shape == (48 * 4,)


@pytest.mark.parametrize("arch", ["attention", "transformer"])
def test_hypernet_padded_z_is_invariant(arch):
    """Trailing rows of z past z_len are masked keys: a z padded with junk
    rows and z_len gives what the unpadded z gives, in both packages."""
    jspec = _spec(arch, True, predict_bias=False)
    jparams, tparams = _both_hypernets(jspec, seed=2)
    tspec = bridge.hypnet_spec_from_jax(jspec)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(6, 32)).astype(np.float32)
    zp = np.concatenate([z, rng.normal(size=(4, 32)).astype(np.float32) * 9], axis=0)
    ref = jhn.apply(jspec, jparams, jnp.asarray(zp), z_len=jnp.asarray(6))
    out = thn.apply(tspec, tparams, torch.from_numpy(zp), z_len=6)
    plain = thn.apply(tspec, tparams, torch.from_numpy(z))
    assert out[2] is None
    _adapters_close(out, ref)
    _adapters_close(out, tuple(None if ts is None else [t.detach().numpy() for t in ts]
                               for ts in plain))


def test_hypernet_dropout_is_per_generator_and_off_in_eval():
    jspec = _spec("transformer", True)
    _, tparams = _both_hypernets(jspec)
    tspec = bridge.hypnet_spec_from_jax(jspec)
    z = torch.randn(5, 32, generator=torch.Generator().manual_seed(0))

    def run(seed, train=True):
        g = torch.Generator().manual_seed(seed)
        return thn.apply(tspec, tparams, z, train=train, generator=g)[0][0]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), thn.apply(tspec, tparams, z)[0][0])


def test_hypernet_init_matches_reference_scheme():
    """Shapes as dmi_tpu's, zero generator biases, xavier bounds."""
    jspec = _spec("transformer", False, n_layers=1)
    jparams = jhn.init(jax.random.key(0), jspec)
    tparams = thn.init(bridge.hypnet_spec_from_jax(jspec), torch.Generator().manual_seed(0))
    jl = {n: np.asarray(a) for n, a in named_leaves(jax.tree.map(np.asarray, jparams))}
    tl = {n: t.numpy() for n, t in named_leaves(tparams)}
    assert {n: a.shape for n, a in tl.items()} == {n: a.shape for n, a in jl.items()}
    for g in range(2):
        assert not tl[f"generators.{g}.b"].any()
        bound = np.sqrt(6.0 / (32 + jspec.gen_out_dim(g)))
        assert np.abs(tl[f"generators.{g}.w"]).max() <= bound


def test_average_adapters_matches():
    jspec = _spec("attention", True)
    jparams, tparams = _both_hypernets(jspec)
    tspec = bridge.hypnet_spec_from_jax(jspec)
    zs = [np.random.default_rng(s).normal(size=(10, 32)).astype(np.float32) for s in range(3)]
    ref = jhn.average_adapters([jhn.apply(jspec, jparams, jnp.asarray(z)) for z in zs])
    out = thn.average_adapters([thn.apply(tspec, tparams, torch.from_numpy(z)) for z in zs])
    _adapters_close(out, ref)


def _projector_and_adapters(seed=0, predict_bias=True):
    jspec = jproj.ProjectorSpec(mm_dim=24, lm_dim=48)
    jpp = jproj.init(jax.random.key(seed), jspec)
    hspec = _spec("attention", True, predict_bias=predict_bias)
    jhp = jhn.init(jax.random.key(seed + 1), hspec)
    z = np.random.default_rng(seed).normal(size=(10, 32)).astype(np.float32)
    jad = jhn.apply(hspec, jhp, jnp.asarray(z))
    tad = tuple(None if ts is None else [torch.from_numpy(np.array(a)) for a in ts]
                for ts in jad)
    tpp = bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp))
    return jspec, jpp, jad, bridge.projector_spec_from_jax(jspec), tpp, tad


@pytest.mark.parametrize("predict_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("truncate", [True, False], ids=["reference-truncated", "full"])
def test_lora_apply_matches(truncate, predict_bias):
    jspec, jpp, jad, tspec, tpp, tad = _projector_and_adapters(predict_bias=predict_bias)
    x = np.random.default_rng(5).normal(size=(6, 24)).astype(np.float32)
    ref = jproj.lora_apply(jspec, jpp, jnp.asarray(x), *jad, truncate_like_reference=truncate)
    out = tproj.lora_apply(tspec, tpp, torch.from_numpy(x), *tad,
                           truncate_like_reference=truncate)
    assert out.shape == (6, 48)
    _close(out.numpy(), ref)
    plain = tproj.lora_apply(tspec, tpp, torch.from_numpy(x), *tad,
                             truncate_like_reference=truncate, plain=True)
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_module_lora_apply_matches():
    jspec = jproj.ProjectorSpec(mm_dim=24, lm_dim=48, n_layers=3)
    jpp = jproj.init(jax.random.key(0), jspec)
    jad = jlora.init(jax.random.key(1), jlora.LoraSpec(rank=4, alpha=8), jspec)
    # B is zero at init: give it values so that the delta shows
    jad = [{"a": ad["a"], "b": ad["b"] + 0.1 * (i + 1)} for i, ad in enumerate(jad)]
    x = np.random.default_rng(2).normal(size=(5, 24)).astype(np.float32)
    ref = jproj.module_lora_apply(jspec, jpp, jnp.asarray(x), jad, 8, 4)
    out = tproj.module_lora_apply(
        bridge.projector_spec_from_jax(jspec),
        bridge.projector_params_from_jax(jax.tree.map(np.asarray, jpp)),
        torch.from_numpy(x), bridge.lora_params_from_jax(jax.tree.map(np.asarray, jad)), 8, 4)
    _close(out.numpy(), ref)


def test_lora_init_matches_reference_scheme():
    pspec = tproj.ProjectorSpec(mm_dim=24, lm_dim=48, n_layers=3)
    ad = tlora.init(tlora.LoraSpec(rank=64, alpha=8), pspec, torch.Generator().manual_seed(0))
    assert [(a["a"].shape, a["b"].shape) for a in ad] == [
        ((24, 64), (64, 48)), ((48, 64), (64, 48)), ((48, 64), (64, 48))]
    assert all(not a["b"].any() for a in ad)
    std = torch.cat([a["a"].ravel() for a in ad]).std().item()
    assert abs(std - 64 ** -0.5) < 0.01


@pytest.mark.parametrize("predict_bias", [True, False], ids=["bias", "no-bias"])
def test_combine_lora_matches(predict_bias):
    jspec, jpp, jad, tspec, tpp, tad = _projector_and_adapters(predict_bias=predict_bias)
    ref = jproj.combine_lora(jspec, jpp, *jad)
    out = tproj.combine_lora(tspec, tpp, *tad)
    for (_, t), j in zip(named_leaves(out), jax.tree.leaves(ref)):
        _close(t.numpy(), j)
    with pytest.raises(ValueError, match="adapters"):
        tproj.combine_lora(tspec, tpp, tad[0][:1], tad[1][:1], None)


def test_interleave_rows_and_sinusoidal_positions_match():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        tlinalg.interleave_rows(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jlinalg.interleave_rows(jnp.asarray(a), jnp.asarray(b))))
    with pytest.raises(ValueError):
        tlinalg.interleave_rows(torch.zeros(2, 3), torch.zeros(3, 3))
    # XLA's and torch's f32 exp differ by an ulp at some frequencies; at the
    # v4 context's last position (258) that moves the angle, whose f32 ulp is
    # 1.5e-5 there, by one ulp: hence 2e-5
    for d, n, off in ((32, 13, 0), (768, 259, 0), (10, 5, 3)):
        _close(tlinalg.sinusoidal_positions(d, n, off).numpy(),
               jlinalg.sinusoidal_positions(d, n, off), 2e-5)


def test_random_orthogonal_properties():
    """Orthogonal to 1e-5, a pure function of the generator, diag(R) > 0 for
    the Gaussian it came from (the sign fix), and the requested dtype."""
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    q = tlinalg.random_orthogonal(48, gen())
    assert q.shape == (48, 48) and q.dtype == torch.float32
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(48), atol=1e-5)
    assert torch.equal(q, tlinalg.random_orthogonal(48, gen()))
    assert not torch.equal(q, tlinalg.random_orthogonal(48, torch.Generator().manual_seed(5)))
    g = torch.randn(48, 48, generator=gen())
    r = q.T @ g  # g = q r with r upper triangular and a positive diagonal
    assert (torch.diagonal(r) > 0).all()
    np.testing.assert_allclose(torch.tril(r, -1).numpy(), 0, atol=1e-4)
    assert tlinalg.random_orthogonal(8, gen(), dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("feed", [True, False], ids=["text", "no-text"])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "no-prefix"])
def test_process_embeddings_matches_with_jax_rotation(feed, prefix):
    """The JAX package's rotation matrix handed to the port: mm and z agree;
    pruned subsets are zero-padded to pad_to."""
    rng = np.random.default_rng(6)
    mm = rng.normal(size=(3, 24)).astype(np.float32)
    sub = [rng.normal(size=(5, 24)).astype(np.float32),
           rng.normal(size=(5, 32)).astype(np.float32)]
    if prefix:
        sub.append(rng.normal(size=(1, 32)).astype(np.float32))
    key = jax.random.key(9)
    jsub = tuple(map(jnp.asarray, sub)) if feed else jnp.asarray(sub[0])
    tsub = tuple(map(torch.from_numpy, sub)) if feed else torch.from_numpy(sub[0])
    if not feed:
        prefix = True  # the no-text path has no prefix; one case suffices
    jmm, jz = jht.process_embeddings(jnp.asarray(mm), jsub, feed_txt_embs=feed, augment=True,
                                     rotate_key=key, pad_to=32)
    rot = torch.from_numpy(np.array(jlinalg.random_orthogonal(key, 24)))
    tmm, tz = tht.process_embeddings(torch.from_numpy(mm), tsub, feed_txt_embs=feed,
                                     rotation=rot, pad_to=32)
    _close(tmm.numpy(), jmm)
    _close(tz.numpy(), jz)
    assert tz.shape == ((10 + (1 if prefix and feed else 0), 32) if feed else (5, 32))


def test_causal_lm_loss_grouped_matches():
    """[G] per-group losses against dmi_tpu's, each equal to the ungrouped
    loss of its rows; a group with no valid label gives 0."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(6, 9, 40)).astype(np.float32)
    labels = rng.integers(0, 40, size=(6, 9))
    labels[:, :3] = -100
    labels[4:, :] = -100  # group 2 has no valid label
    ref = jllama.causal_lm_loss_grouped(jnp.asarray(logits), jnp.asarray(labels), 3)
    out = tllama.causal_lm_loss_grouped(torch.from_numpy(logits), torch.from_numpy(labels), 3)
    _close(out.numpy(), ref)
    assert out[2].item() == 0.0
    for g in range(2):
        rows = slice(2 * g, 2 * g + 2)
        _close(out[g].item(), tllama.causal_lm_loss(torch.from_numpy(logits[rows]),
                                                    torch.from_numpy(labels[rows])).item())


def test_caption_loss_grouped_matches():
    from dmi_tpu.models import mmmodel as jmm
    from dmi_tpu_torch.models import mmmodel as tmm
    from tests.test_torch_train import _llms, _text_batch

    jcfg, jparams, tcfg, tparams = _llms(weight_scale=5.0)
    ids, mask, labels = _text_batch(4, 10, 96, 8)
    soft = np.random.default_rng(9).normal(size=(4, 64)).astype(np.float32)
    ref = jmm.caption_loss_grouped(jcfg, jparams, jnp.asarray(soft), jnp.asarray(ids),
                                   jnp.asarray(mask), jnp.asarray(labels), 2)
    out = tmm.caption_loss_grouped(tcfg, tparams, torch.from_numpy(soft), torch.from_numpy(ids),
                                   torch.from_numpy(mask), torch.from_numpy(labels), 2)
    _close(out.numpy(), ref)
    assert dataclasses.is_dataclass(tcfg)
