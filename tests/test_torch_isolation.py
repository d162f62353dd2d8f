"""The port stands alone: no module of dmi_tpu_torch, nor chip_smoke.py,
imports dmi_tpu or JAX, lazily or not; the framework-free modules it
carries are dmi_tpu's with only the package name of their imports
rewritten; and every entry point runs on the card unless asked for the CPU,
failing here, where torch sees no card, before it loads anything.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dmi_tpu_torch"
FORBIDDEN = ("dmi_tpu", "jax", "jaxlib", "optax", "flax", "orbax")

# the framework-free dmi_tpu modules the port keeps its own copies of
COPIES = [
    "config.py", "registry.py", "chat_templates.py", "training/results.py", "utils/logging.py",
    "data/__init__.py", "data/collator.py", "data/loader.py", "data/inffs.py", "data/sampler.py",
    "data/prefetch.py", "data/tok_fixture.py",
    *(f"evals/{p.name}" for p in sorted((REPO / "dmi_tpu" / "evals").glob("*.py"))),
]
_HEADER = ("# Copy of dmi_tpu/{rel} with its dmi_tpu imports rewritten to dmi_tpu_torch, so that\n"
           "# the port loads no module of the JAX package (tests/test_torch_isolation.py holds "
           "the two equal).\n")
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)dmi_tpu(?=[.\s])")


def _forbidden_imports(path: Path):
    """(line, module) of every import of a forbidden package in the file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_and_smoke_import_no_dmi_tpu_or_jax():
    sources = _sources()
    assert len(sources) > 50
    bad = {str(p.relative_to(REPO)): f for p in sources if (f := _forbidden_imports(p))}
    assert not bad, bad


def test_isolation_check_sees_lazy_imports(tmp_path):
    """The check reads nested, lazy imports too, and tells dmi_tpu_torch apart."""
    src = tmp_path / "m.py"
    src.write_text("import dmi_tpu_torch.ops\nfrom dmi_tpu_torch import bridge\n"
                   "def f():\n    from dmi_tpu.config import TrainArgs\n"
                   "    import jax.numpy as jnp\n")
    assert _forbidden_imports(src) == [(4, "dmi_tpu.config"), (5, "jax.numpy")]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_dmi_tpu(rel):
    """A copy drifts from its original in neither direction: it is the
    original with `dmi_tpu` rewritten to `dmi_tpu_torch` in its import
    statements, under a two-line header."""
    original = (REPO / "dmi_tpu" / rel).read_text().splitlines(keepends=True)
    want = _HEADER.format(rel=rel) + "".join(_IMPORT.sub(r"\1dmi_tpu_torch", line)
                                             for line in original)
    assert (PORT / rel).read_text() == want


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("module", ["train_projector", "train_hypernet", "train_lora"])
def test_training_entry_points_default_to_the_card(module, monkeypatch, tmp_path):
    """run() and the CLI default to cuda and raise without a card before they
    read the config (the path does not exist); device="cpu" gets past the
    check (and then fails on the missing config)."""
    import importlib
    import inspect

    mod = importlib.import_module(f"dmi_tpu_torch.{module}")
    _no_card(monkeypatch)
    for fn in (mod.run, mod.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    missing = str(tmp_path / "absent.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(missing)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.cli([missing])
    with pytest.raises(FileNotFoundError):
        mod.cli([missing, "--device", "cpu"])


def test_captioner_defaults_to_the_card(monkeypatch):
    import inspect

    from dmi_tpu_torch import serve

    _no_card(monkeypatch)
    sig = inspect.signature(serve.Captioner.from_checkpoint)
    assert sig.parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Captioner.from_checkpoint("test:tiny", "absent.pt", "sydney")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--lm", "test:tiny", "--projector-ckpt", "absent.pt", "--dataset", "sydney",
                    "--embs", "absent.npy"])


def test_require_device(monkeypatch):
    from dmi_tpu_torch.training.model_utils import require_device

    _no_card(monkeypatch)
    assert require_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        require_device()
