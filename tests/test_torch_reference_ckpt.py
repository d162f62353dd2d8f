"""The reference's torch `.pt` checkpoints in the port, against dmi_tpu.

Torch modules are built in the reference's key layouts, as
tests/test_torch_import.py builds them (the projector as nn.ModuleList
`net`, mlp2, mlp3 and linear; the HyperNetWrapper `hypernet.*` +
`projector.net.*` in the three encoder archs; the LoraWrapper
`lora_adapters.loras.{i}.A|B` + `projector.net.*`), take two
torch.optim.AdamW steps and are written with torch.save in the reference
envelope.  Then, at f32 on the CPU:

  * load: dmi_tpu_torch's load_pytree gives dmi_tpu's parameters bit for
    bit, a projector wider than mm_dim pruned alike on both sides, and the
    converted AdamW moments alike;
  * resume: each of the three trainers resumes from the file (AdamW
    moments, step count, step_idx and sched_step) and takes its next
    update; parameters and moments agree with dmi_tpu's resumed update to
    1e-6 relative to max(1, max |dmi_tpu|);
  * serve: Captioner.from_checkpoint on a projector, a hypernet and a
    lora_model `.pt` gives dmi_tpu's greedy captions on the same LM.
"""

import pickle

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from dmi_tpu.data.fixtures import generate_dataset
from dmi_tpu.data.loader import DatasetLoader as JaxLoader
from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import hypernet as jhn
from dmi_tpu.models import lora as jlora
from dmi_tpu.models import projector as jproj
from dmi_tpu.models import torch_import as jti
from dmi_tpu.registry import dataset_spec
from dmi_tpu.training.checkpoint import load_pytree as jload
from dmi_tpu.training.embeddings import EmbeddingManager as JaxEmbeddingManager
from dmi_tpu.training.lora_trainer import LoraTrainer as JaxLoraTrainer
from dmi_tpu_torch import bridge
from dmi_tpu_torch.data.loader import DatasetLoader
from dmi_tpu_torch.models import lora as tlora
from dmi_tpu_torch.models import torch_import as tti
from dmi_tpu_torch.training.checkpoint import load_pytree
from dmi_tpu_torch.training.embeddings import EmbeddingManager
from dmi_tpu_torch.training.lora_trainer import LoraTrainer
from dmi_tpu_torch.training.optim import set_adamw_moments
from dmi_tpu_torch.training.projector_trainer import load_projector
from dmi_tpu_torch.utils.grad_stats import named_leaves
from tests.test_torch_hypernet_train import _args, _jax_step, _pair
from tests.test_torch_train import _both_trainers, _close, _train_args

torch.set_num_threads(1)

ENCODER = "RemoteCLIP-RN50-Unchanged"


# ---------------------------------------------------------------------------
# Reference-layout torch modules and their envelopes
# ---------------------------------------------------------------------------


class Projector(nn.Module):
    """Reference Projector: nn.ModuleList `net` of Linear, GELU, Dropout."""

    def __init__(self, mm, lm, n_layers=2, arch="mlp"):
        super().__init__()
        if arch == "linear":
            mods = [nn.Linear(mm, lm), nn.Dropout(0.1)]
        else:
            mods = [nn.Linear(mm, lm), nn.GELU(approximate="tanh"), nn.Dropout(0.1)]
            for _ in range(n_layers - 2):
                mods += [nn.Linear(lm, lm), nn.GELU(approximate="tanh"), nn.Dropout(0.1)]
            mods.append(nn.Linear(lm, lm))
        self.net = nn.ModuleList(mods)


class MHSA(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.q, self.k, self.v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)


class PosEnc(nn.Module):
    def __init__(self, pe):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(pe))


class HyperNetwork(nn.Module):
    """Reference HyperNetwork key layout of a dmi_tpu HypnetSpec, holding the
    weights of a dmi_tpu hypernet tree (exported by dmi_tpu's exporter and
    loaded strictly, so the layout is the one torch makes)."""

    def __init__(self, jspec, jparams):
        super().__init__()
        d = jspec.hypnet_dim
        if jspec.arch == "attention":
            self.hypnet = MHSA(d)
        elif jspec.arch == "att_w_nonlinear":
            self.hypnet = nn.Sequential(MHSA(d), nn.GELU())
        else:
            layer = nn.TransformerEncoderLayer(d, jspec.n_heads, 4 * d, batch_first=True,
                                               activation="gelu")
            self.hypnet = nn.TransformerEncoder(layer, jspec.n_layers,
                                                enable_nested_tensor=False)
        self.generators = nn.ModuleList(
            [nn.Linear(d, jspec.gen_out_dim(i)) for i in range(jspec.n_proj_layers)])
        self.prefix_tokens = nn.Parameter(torch.zeros(jspec.n_proj_layers, d))
        sd = jti.export_hypernet_state_dict(jax.tree.map(np.asarray, jparams), jspec)
        if jspec.use_pos_encs:
            self.pos_encs = PosEnc(sd["pos_encs.pe"])
        self.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})


class Wrapper(nn.Module):
    """HyperNetWrapper (hypernet + projector) or LoraWrapper."""

    def __init__(self, projector, hypernet=None, loras=None):
        super().__init__()
        if hypernet is not None:
            self.hypernet = hypernet
        if loras is not None:
            adapters = nn.Module()
            adapters.loras = nn.ModuleList()
            for a, b in loras:
                lo = nn.Module()
                lo.A, lo.B = nn.Parameter(torch.from_numpy(a)), nn.Parameter(torch.from_numpy(b))
                adapters.loras.append(lo)
            self.lora_adapters = adapters
        self.projector = projector


def adamw_steps(params, skip=(), n=2, seed=0):
    """`n` torch.optim.AdamW steps on a weighted square loss over the named
    parameters; those whose name starts with one of `skip` get no gradient,
    so AdamW makes no state slot for them (as for the reference's unused
    generator head).  Returns the optimizer."""
    params = list(params)
    gen = torch.Generator().manual_seed(seed)
    weights = [torch.rand(p.shape, generator=gen) for _, p in params]
    opt = torch.optim.AdamW([p for _, p in params], lr=1e-3, weight_decay=0.01)
    for _ in range(n):
        opt.zero_grad()
        loss = sum((p * p * w).sum() for (name, p), w in zip(params, weights)
                   if not name.startswith(skip))
        loss.backward()
        opt.step()
    return opt


def save_envelope(path, save_type, module, opt=None, step=3, metric=0.5):
    torch.save({"step_idx": step, f"{save_type}_state_dict": module.state_dict(),
                "optimizer_state_dict": opt.state_dict() if opt is not None else None,
                "metric": metric}, path)
    return str(path)


def projector_pt(path, mm=12, lm=16, n_layers=2, arch="mlp", seed=0):
    torch.manual_seed(seed)
    p = Projector(mm, lm, n_layers, arch)
    return save_envelope(path, "projector", p, adamw_steps(p.named_parameters()))


def hypernet_spec(arch):
    return jhn.HypnetSpec(lm_dim=16, mm_dim=12, n_tokens=2, arch=arch, n_heads=2,
                          hypnet_dim=12, rank=2, alpha=2, n_proj_layers=2, use_pos_encs=True)


def hypernet_pt(path, jspec, jparams, mm, lm, seed=0):
    """A HyperNetWrapper envelope whose optimizer covers the hypernet only;
    generator head 1 gets no gradient."""
    torch.manual_seed(seed)
    wrapper = Wrapper(Projector(mm, lm), hypernet=HyperNetwork(jspec, jparams))
    opt = adamw_steps(wrapper.hypernet.named_parameters(), skip=("generators.1.",), seed=seed)
    return save_envelope(path, "hypernet", wrapper, opt, metric=1.25)


def lora_pt(path, jadapters, mm, lm, seed=0):
    torch.manual_seed(seed)
    wrapper = Wrapper(Projector(mm, lm), loras=[(np.array(a["a"]), np.array(a["b"]))
                                                for a in jax.tree.map(np.asarray, jadapters)])
    opt = adamw_steps(wrapper.lora_adapters.named_parameters(), seed=seed)
    return save_envelope(path, "lora_model", wrapper, opt)


def _trees_equal(ours, ref):
    """Two trees of numpy leaves, the same structure and the same bits."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref)
        for k in ref:
            _trees_equal(ours[k], ref[k])
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _trees_equal(a, b)
    else:
        ours, ref = np.asarray(ours), np.asarray(ref)
        assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


def _cases(tmp_path):
    """(name, path, save type, hypernet arch) of every envelope kind."""
    cases = [(f"projector-{arch}{n}", projector_pt(tmp_path / f"p{arch}{n}.pt", n_layers=n,
                                                   arch=arch), "projector", "auto")
             for arch, n in (("mlp", 2), ("mlp", 3), ("linear", 1))]
    for i, arch in enumerate(("attention", "att_w_nonlinear", "transformer")):
        spec = hypernet_spec(arch)
        cases.append((f"hypernet-{arch}", hypernet_pt(
            tmp_path / f"h{arch}.pt", spec, jhn.init(jax.random.key(i), spec), 12, 16,
            seed=i), "hypernet", arch))
    lspec = jlora.LoraSpec(rank=2, alpha=4)
    adapters = jlora.init(jax.random.key(5), lspec, jproj.ProjectorSpec(mm_dim=12, lm_dim=16))
    cases.append(("lora", lora_pt(tmp_path / "lora.pt", adapters, 12, 16), "lora_model", "auto"))
    return cases


CASE_NAMES = ["projector-mlp2", "projector-mlp3", "projector-linear1", "hypernet-attention",
              "hypernet-att_w_nonlinear", "hypernet-transformer", "lora"]


@pytest.fixture(scope="module")
def envelopes(tmp_path_factory):
    return {name: (path, st, arch)
            for name, path, st, arch in _cases(tmp_path_factory.mktemp("envelopes"))}


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASE_NAMES)
def test_load_pytree_matches_dmi_tpu(envelopes, case):
    """The envelope's keys, step_idx, metric and every parameter tree equal
    dmi_tpu's, bit for bit; the port's bridge turns dmi_tpu's trees into the
    same tensors."""
    path, save_type, _ = envelopes[case]
    ours, ref = load_pytree(path), jload(path)
    assert list(ours) == list(ref)
    assert ours["step_idx"] == ref["step_idx"] == 3
    assert ours["optimizer_state_dict"] is ref["optimizer_state_dict"] is None
    assert ours["metric"] == ref["metric"]
    for key in ref:
        if key.endswith("_state_dict") and key != "optimizer_state_dict":
            _trees_equal(ours[key], jax.tree.map(np.asarray, ref[key]))
    proj = bridge.projector_params_from_jax(ref["projector_state_dict"])
    for layer, want in zip(ours["projector_state_dict"]["layers"], proj["layers"]):
        assert torch.equal(torch.from_numpy(layer["w"]), want["w"])
    if save_type == "hypernet":
        got = bridge.hypernet_params_from_jax(ref["hypernet_state_dict"])
        for (n, a), (m, b) in zip(named_leaves(got), named_leaves(ours["hypernet_state_dict"])):
            assert n == m and torch.equal(a, torch.from_numpy(b))


@pytest.mark.parametrize("case", CASE_NAMES)
def test_adamw_moments_match_dmi_tpu(envelopes, case):
    """optax_moments_from_checkpoint: dmi_tpu's (mu, nu, count) bit for bit,
    a zero moment for the slot AdamW never made; load_torch_checkpoint's raw
    optimizer state alike."""
    path, save_type, arch = envelopes[case]
    ours = tti.optax_moments_from_checkpoint(path, save_type, arch=arch)
    ref = jti.optax_moments_from_checkpoint(path, save_type, arch=arch)
    assert ours["count"] == ref["count"] == 2
    _trees_equal(ours["mu"], ref["mu"])
    _trees_equal(ours["nu"], ref["nu"])
    if save_type == "hypernet":
        assert not ours["mu"]["generators"][1]["w"].any()
        assert ours["mu"]["generators"][0]["w"].any()
    raw, raw_ref = tti.load_torch_checkpoint(path), jti.load_torch_checkpoint(path)
    assert sorted(raw["optimizer_state"]) == sorted(raw_ref["optimizer_state"])
    for i, slot in raw_ref["optimizer_state"].items():
        assert raw["optimizer_state"][i]["step"] == slot["step"]
        np.testing.assert_array_equal(raw["optimizer_state"][i]["exp_avg"], slot["exp_avg"])


def test_load_pytree_reads_legacy_torch_files(envelopes, tmp_path):
    """torch.save's legacy (pre-zip) format falls through to the torch
    loader; a pickle of something else than an envelope still raises, and
    so does a file that is neither a pickle nor a torch file."""
    path, _, _ = envelopes["hypernet-transformer"]
    legacy = tmp_path / "legacy.pt"
    torch.save(torch.load(path, weights_only=False), legacy,
               _use_new_zipfile_serialization=False)
    ours, ref = load_pytree(str(legacy)), load_pytree(path)
    assert list(ours) == list(ref)
    _trees_equal(ours["hypernet_state_dict"], ref["hypernet_state_dict"])
    other = tmp_path / "list.pkl"
    other.write_bytes(pickle.dumps([1, 2]))
    with pytest.raises(ValueError, match="not a checkpoint envelope"):
        load_pytree(str(other))
    junk = tmp_path / "junk.pt"
    junk.write_bytes(b"\x00not a pickle")
    with pytest.raises(Exception):
        load_pytree(str(junk))


@pytest.mark.parametrize("case", ["projector-mlp2", "hypernet-attention", "lora"])
def test_load_projector_prunes_a_wider_projector_like_dmi_tpu(tmp_path, case):
    """load_projector (the fine-tune source and the frozen projector) on a
    `.pt` whose layer 0 is 20 inputs wide, at mm_dim 12: dmi_tpu's
    ProjectorTrainer._load_pruned and proj.prune give the same rows."""
    from dmi_tpu_torch.models import projector as tproj

    if case == "projector-mlp2":
        path = projector_pt(tmp_path / "wide.pt", mm=20)
    elif case == "lora":
        spec = jproj.ProjectorSpec(mm_dim=20, lm_dim=16)
        path = lora_pt(tmp_path / "wide.pt", jlora.init(jax.random.key(1),
                                                        jlora.LoraSpec(rank=2), spec), 20, 16)
    else:
        spec = hypernet_spec("attention")
        path = hypernet_pt(tmp_path / "wide.pt", spec, jhn.init(jax.random.key(0), spec), 20, 16)
    ours = load_projector(path, tproj.ProjectorSpec(mm_dim=12, lm_dim=16))
    ref = jproj.prune(jload(path)["projector_state_dict"], 12)
    assert ours["layers"][0]["w"].shape == (12, 16)
    _trees_equal(ours, jax.tree.map(np.asarray, ref))
    sd = next(v for k, v in torch.load(path, weights_only=False).items()
              if k.endswith("_state_dict") and k != "optimizer_state_dict")
    w0 = sd["net.0.weight" if "net.0.weight" in sd else "projector.net.0.weight"]
    np.testing.assert_array_equal(ours["layers"][0]["w"], w0.numpy()[:, :12].T)


# ---------------------------------------------------------------------------
# The module's other functions against dmi_tpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["attention", "att_w_nonlinear", "transformer"])
def test_exporters_and_writer_match_dmi_tpu(tmp_path, arch):
    """The exporters emit dmi_tpu's keys and arrays, the `pos_encs.pe`
    buffer within f32 rounding of dmi_tpu's (the port's sinusoidal table);
    save_reference_checkpoint writes a file both packages read alike, and
    detect_hypernet_arch reads the arch back from it."""
    spec = hypernet_spec(arch)
    params = jax.tree.map(np.asarray, jhn.init(jax.random.key(3), spec))
    pspec = jproj.ProjectorSpec(mm_dim=12, lm_dim=16)
    pparams = jax.tree.map(np.asarray, jproj.init(jax.random.key(4), pspec))
    ours = tti.export_hypernet_state_dict(params, bridge.hypnet_spec_from_jax(spec))
    ref = jti.export_hypernet_state_dict(params, spec)
    assert list(ours) == list(ref)
    for k in ref:
        if k == "pos_encs.pe":
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(ours[k], ref[k])
    assert tti.detect_hypernet_arch(ours) == arch
    for f in ("export_projector_state_dict",):
        a, b = getattr(tti, f)(pparams), getattr(jti, f)(pparams)
        assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)
    sd = {**tti._prefixed(ours, "hypernet."),
          **tti._prefixed(tti.export_projector_state_dict(pparams), "projector.")}
    path = str(tmp_path / "exported.pt")
    tti.save_reference_checkpoint(path, save_type="hypernet", state_dict=sd, step_idx=4)
    env, env_ref = load_pytree(path), jload(path)
    assert env["step_idx"] == env_ref["step_idx"] == 4
    _trees_equal(env["hypernet_state_dict"], jax.tree.map(np.asarray,
                                                          env_ref["hypernet_state_dict"]))
    _trees_equal(env["hypernet_state_dict"], params)
    assert tti.optax_moments_from_checkpoint(path, "hypernet") is None


def test_lora_export_and_adamw_export_match_dmi_tpu():
    """export_lora_state_dict and export_adamw_state give dmi_tpu's; a torch
    AdamW loads the latter."""
    spec = jproj.ProjectorSpec(mm_dim=12, lm_dim=16)
    adapters = jax.tree.map(np.asarray, jlora.init(jax.random.key(0), jlora.LoraSpec(rank=2),
                                                   spec))
    a, b = tti.export_lora_state_dict(adapters), jti.export_lora_state_dict(adapters)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)
    names = list(a)
    nu = {k: np.abs(v) for k, v in a.items()}
    ours = tti.export_adamw_state(names, a, nu, 7, lr=1e-3)
    ref = jti.export_adamw_state(names, a, nu, 7, lr=1e-3)
    assert ours["param_groups"] == ref["param_groups"]
    for i in ref["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ours["state"][i][k], ref["state"][i][k])
    opt = torch.optim.AdamW([nn.Parameter(torch.from_numpy(np.array(v))) for v in a.values()])
    opt.load_state_dict(ours)
    assert opt.state_dict()["state"][0]["step"].item() == 7
    with pytest.raises(KeyError):
        tti.export_adamw_state(names + ["x"], a, nu, 7, lr=1e-3)


def test_converters_refuse_what_dmi_tpu_refuses(tmp_path):
    """Unknown keys, an unknown arch, differing per-slot steps and an
    envelope with no known state dict raise as in dmi_tpu."""
    with pytest.raises(KeyError):
        tti.projector_from_state_dict({"net.0.scale": np.zeros(2)})
    with pytest.raises(KeyError):
        tti.lora_from_state_dict({"loras.0.C": np.zeros(2)})
    with pytest.raises(ValueError, match="arch"):
        tti.hypernet_from_state_dict({"prefix_tokens": np.zeros(2)}, arch="mamba")
    sd = {"net.0.weight": np.zeros((2, 3), np.float32), "net.0.bias": np.zeros(2, np.float32)}
    moments = {i: {"step": s, "exp_avg": v, "exp_avg_sq": v}
               for i, (s, v) in enumerate(zip((1, 2), sd.values()))}
    with pytest.raises(ValueError, match="differ"):
        tti.adamw_moments_to_pytrees(sd, moments, tti.projector_from_state_dict)
    with pytest.raises(ValueError, match="slots"):
        tti.adamw_moments_to_pytrees({}, moments, tti.projector_from_state_dict)
    path = tmp_path / "bad.pt"
    torch.save({"nothing": 1}, path)
    with pytest.raises(KeyError, match="no recognized"):
        tti.load_torch_checkpoint(str(path))
    # an envelope without the asked-for state dict, or no zip at all: None
    assert tti.optax_moments_from_checkpoint(projector_pt(tmp_path / "p.pt"), "hypernet") is None
    assert tti.optax_moments_from_checkpoint(__file__, "projector") is None


def test_set_adamw_moments_installs_count_and_checks_names():
    """Every leaf's torch step is the count and its moments the converted
    ones; moments of another tree are refused."""
    leaves = {"layers": [{"w": torch.zeros(3, 2), "b": torch.zeros(2)}]}
    opt = torch.optim.AdamW([leaves["layers"][0]["b"], leaves["layers"][0]["w"]])
    mu = {"layers": [{"w": np.full((3, 2), 0.5, np.float32), "b": np.ones(2, np.float32)}]}
    set_adamw_moments(opt, leaves, {"mu": mu, "nu": mu, "count": 5}, "cpu")
    for name, leaf in named_leaves(leaves):
        state = opt.state[leaf]
        assert state["step"].item() == 5 and state["step"].dtype == torch.float32
        assert state["exp_avg"].shape == leaf.shape
    assert opt.state[leaves["layers"][0]["w"]]["exp_avg"][0, 0].item() == 0.5
    with pytest.raises(ValueError, match="moments"):
        set_adamw_moments(opt, leaves, {"mu": {"layers": [{"w": mu["layers"][0]["w"]}]},
                                        "nu": mu, "count": 5}, "cpu")


# ---------------------------------------------------------------------------
# Resume: each trainer's next update against dmi_tpu's
# ---------------------------------------------------------------------------


def _find_adam(node):
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    if isinstance(node, tuple):
        for v in node:
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def _state_matches(tt, jt_state, tol=1e-6):
    """The port trainer's parameters and AdamW moments against a dmi_tpu
    TrainState's, leaf by leaf, and the step counts."""
    adam = _find_adam(jt_state.opt_state)
    leaves = [t for _, t in named_leaves(tt.params)]
    mus, nus = jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)
    assert len(leaves) == len(mus) == len(jax.tree.leaves(jt_state.params))
    for leaf, p, mu, nu in zip(leaves, jax.tree.leaves(jt_state.params), mus, nus):
        state = tt.opt.state[leaf]
        assert state["step"].item() == int(adam.count)
        _close(leaf.detach().numpy(), np.asarray(p), tol)
        _close(state["exp_avg"].numpy(), np.asarray(mu), tol)
        _close(state["exp_avg_sq"].numpy(), np.asarray(nu), tol)


@pytest.fixture()
def sydney(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    generate_dataset("data", "sydney", ENCODER, mm_dim=32, n_train=8, n_eval=2, seed=0)
    return build_test_tokenizer()


def test_projector_trainer_resumes_from_reference_pt(sydney, tmp_path):
    """ProjectorTrainer.resume on a reference projector `.pt` with AdamW
    state: the step to start from, sched_step, the parameters and moments
    bit for bit; then its next update against dmi_tpu's."""
    jt, tt = _both_trainers(sydney, _train_args())
    path = projector_pt(tmp_path / "proj.pt", mm=32, lm=64, seed=4)
    assert jt.resume(path) == tt.resume(path) == 4
    assert tt.sched_step == int(jt.state.sched_step) == 3
    _state_matches(tt, jt.state, tol=0.0)
    total = tt.total_steps
    for step in (4, 5):
        jl, jdid = jt.train_step(step, total)
        tl, tdid = tt.train_step(step, total)
        assert jdid and tdid
        _close(tl.item(), float(jl), 1e-5)
    assert tt.sched_step == int(jt.state.sched_step) == 5
    _state_matches(tt, jt.state)


def test_hypernet_trainer_resumes_from_reference_pt(tmp_path, monkeypatch):
    """HypernetTrainer.load_checkpoint on a reference hypernet `.pt` (the
    wrapper's frozen projector outside the optimizer, generator head 1
    without a state slot): step_idx, sched_step, parameters and moments;
    then the next accumulation window's update against dmi_tpu's."""
    monkeypatch.chdir(tmp_path)
    generate_dataset("data", "sharegpt4v", "ViT-L-16-SigLIP2-384", mm_dim=32, n_train=12,
                     n_eval=4, text_dim=32, seed=1)
    generate_dataset("data", "candels", "zoobot-encoder-convnext_base", mm_dim=32, n_train=8,
                     n_eval=2, text_dim=32, seed=2)
    tok = build_test_tokenizer()
    jt, tt = _pair(tok, _args(epochs=3))
    path = hypernet_pt(tmp_path / "hn.pt", jt.hn_spec, jhn.init(jax.random.key(9), jt.hn_spec),
                       32, 64, seed=2)
    assert jt.load_checkpoint(path) == tt.load_checkpoint(path) == {"step_idx": 3}
    assert tt.sched_step == int(jt.state.sched_step) == 3
    _state_matches(tt, jt.state, tol=0.0)
    assert not tt.opt.state[tt.params["generators"][1]["w"]]["exp_avg"].any()
    total = jt.total_steps
    for step in (4, 5):
        jl, jdid = _jax_step(jt, step, total)
        tl, tdid = tt.train_step(step, total)
        assert tdid == jdid == (step == 5)
        _close(tl.item(), jl, 1e-5)
    assert tt.sched_step == int(jt.state.sched_step) == 5
    _state_matches(tt, jt.state)


def test_lora_trainer_resumes_from_reference_pt(sydney, tmp_path):
    """LoraTrainer.resume on a reference lora_model `.pt`: the adapters and
    their moments (the optimizer covers LoraAdapters only), then the next
    update against dmi_tpu's."""
    from tests.test_torch_train import _llms

    tok = sydney
    args = _train_args(epochs=2)
    jcfg, jllm, tcfg, tllm = _llms(vocab=tok.vocab_size + 8)
    pspec = jproj.ProjectorSpec(mm_dim=32, lm_dim=64)
    jpp = jproj.init(jax.random.key(1), pspec)
    lspec = jlora.LoraSpec(rank=4, alpha=8)
    jad = jlora.init(jax.random.key(2), lspec, pspec)
    jt = JaxLoraTrainer(lora_spec=lspec, lora_params=jad, frozen_proj_params=jpp, name="jax",
                        llm_cfg=jcfg, llm_params=jllm, proj_spec=pspec,
                        loaders=[JaxLoader(dataset_spec("sydney"), tok, args, ENCODER, True,
                                           "data")],
                        emb_mgrs=[JaxEmbeddingManager(f"chendelong/{ENCODER}")], tokenizer=tok,
                        train_args=args)
    tt = LoraTrainer(lora_spec=tlora.LoraSpec(rank=4, alpha=8),
                     lora_params=bridge.lora_params_from_jax(jax.tree.map(np.asarray, jad)),
                     frozen_proj_params=jax.tree.map(np.asarray, jpp), name="port",
                     llm_cfg=tcfg, llm_params=tllm,
                     proj_spec=bridge.projector_spec_from_jax(pspec),
                     loaders=[DatasetLoader(dataset_spec("sydney"), tok, args, ENCODER, True,
                                            "data")],
                     emb_mgrs=[EmbeddingManager(f"chendelong/{ENCODER}")], tokenizer=tok,
                     train_args=args)
    path = lora_pt(tmp_path / "lora.pt", jlora.init(jax.random.key(7), lspec, pspec), 32, 64,
                   seed=3)
    assert jt.resume(path) == tt.resume(path) == 4
    assert tt.sched_step == int(jt.state.sched_step) == 3
    _state_matches(tt, jt.state, tol=0.0)
    total = tt.total_steps
    for step in (4, 5):
        jl, _ = jt.train_step(step, total)
        tl, _ = tt.train_step(step, total)
        _close(tl.item(), float(jl), 1e-5)
    _state_matches(tt, jt.state)


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["projector", "hypernet", "lora_model"])
def test_captioner_from_reference_pt_matches_dmi_tpu(tmp_path, monkeypatch, kind):
    """Captioner.from_checkpoint on a projector, a hypernet and a lora_model
    `.pt` (the projector the envelope holds, as dmi_tpu picks it) with a
    test:tiny LM whose weights both packages share: dmi_tpu's greedy
    captions."""
    from dmi_tpu import serve as jserve
    from dmi_tpu_torch import serve as tserve
    from tests.test_torch_serve import _models

    tok = build_test_tokenizer()
    jcfg, jparams, tcfg, tparams = _models(eos=(tok.eos_token_id,), vocab=len(tok) + 8)
    monkeypatch.setattr(jserve, "build_lm", lambda *a, **k: (jcfg, jparams))
    monkeypatch.setattr(tserve, "build_lm", lambda *a, **k: (tcfg, tparams))
    if kind == "projector":
        path = projector_pt(tmp_path / "p.pt", mm=24, lm=64)
    elif kind == "hypernet":
        spec = hypernet_spec("attention")
        path = hypernet_pt(tmp_path / "h.pt", spec, jhn.init(jax.random.key(0), spec), 24, 64)
    else:
        path = lora_pt(tmp_path / "l.pt", jlora.init(jax.random.key(1), jlora.LoraSpec(rank=2),
                                                     jproj.ProjectorSpec(mm_dim=24, lm_dim=64)),
                       24, 64)
    jcap = jserve.Captioner.from_checkpoint("test:tiny", path, "sydney", lm_dtype="float32",
                                            batch_size=4)
    tcap = tserve.Captioner.from_checkpoint("test:tiny", path, "sydney", lm_dtype="float32",
                                            device="cpu", batch_size=4)
    assert tcap.proj_spec.mm_dim == 24 and tcap.max_new_tokens == jcap.max_new_tokens
    embs = np.random.default_rng(6).normal(size=(6, 24)).astype(np.float32)
    ours = tcap.caption(embs)
    assert ours == jcap.caption(embs, engine="batch")
    assert len(set(ours)) > 1


# ---------------------------------------------------------------------------
# The configs' entry points with reference `.pt` inputs
# ---------------------------------------------------------------------------


def test_entry_points_take_reference_pt_files(tmp_path, monkeypatch):
    """As the paper's configs name them: train_projector fine-tunes from a
    reference projector `.pt` 40 inputs wide (pruned to mm_dim 32);
    train_hypernet's few-shot mode runs over that frozen projector, resumed
    from a reference hypernet `.pt`; train_lora trains over it, resumed from
    a reference lora_model `.pt`.  Each writes its results JSON."""
    import json
    import os.path as osp

    from dmi_tpu_torch.train_hypernet import run as run_hypernet
    from dmi_tpu_torch.train_lora import run as run_lora
    from dmi_tpu_torch.train_projector import run as run_projector
    from tests.test_hypernet_e2e import hypernet_config
    from tests.test_projector_e2e import make_config
    from tests.test_torch_hypernet_e2e import _lora_config

    monkeypatch.chdir(tmp_path)
    for ds, enc, seed in (("sydney", ENCODER, 0), ("sharegpt4v", "ViT-L-16-SigLIP2-384", 1),
                          ("candels", "zoobot-encoder-convnext_base", 2)):
        generate_dataset("data", ds, enc, mm_dim=32, n_train=4, n_eval=2, text_dim=32,
                         seed=seed)
    proj = projector_pt(tmp_path / "ref-projector.pt", mm=40, lm=64)
    run_projector(make_config(tmp_path, epochs_l=[1], finetune_from_checkpoint=proj),
                  device="cpu")
    assert osp.exists(osp.join("outputs",
                               "ft_projector:cfg_projector_smoke-dszfull-seed7-results.json"))

    hspec = jhn.HypnetSpec(lm_dim=64, mm_dim=32, n_tokens=4, arch="attention", hypnet_dim=32,
                           rank=4, alpha=4, use_pos_encs=True)
    hn_pt = hypernet_pt(tmp_path / "ref-hypernet.pt", hspec, jhn.init(jax.random.key(3), hspec),
                        40, 64)
    run_hypernet(hypernet_config(tmp_path, proj, "fewshot", resume=hn_pt, fewshot_epochs=[1]),
                 device="cpu")
    results = json.load(open(osp.join(
        "outputs", "hypernet:cfg_hypernet_fewshot-dsz10-seed7-results.json")))
    assert "coco_cider" in results["metrics"]["zoobot-encoder-convnext_base"]

    lspec = jlora.LoraSpec(rank=4, alpha=4)
    lora = lora_pt(tmp_path / "ref-lora.pt", jlora.init(
        jax.random.key(4), lspec, jproj.ProjectorSpec(mm_dim=32, lm_dim=64)), 40, 64)
    cfg = json.loads(open(_lora_config(tmp_path)).read())
    cfg.update(proj_name_or_path=proj, resume_from_checkpoint=lora)
    (tmp_path / "cfg_lora_smoke.json").write_text(json.dumps(cfg))
    run_lora(str(tmp_path / "cfg_lora_smoke.json"), device="cpu")
    assert osp.exists(osp.join("outputs", "lora:cfg_lora_smoke-dszfull-seed7-results.json"))
