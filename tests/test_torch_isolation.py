"""The port stands alone: no module of dmi_tpu_torch, nor chip_smoke.py,
imports dmi_tpu or JAX, lazily or not, nor a package the card's machine
lacks (transformers only inside the guarded places listed below); the
framework-free modules it carries are dmi_tpu's with only the package name
of their imports rewritten, and the third-party scorers they import swapped
for the port's own stand-ins (SUBSTITUTIONS); and every entry point runs on
the card unless asked for the CPU, failing here, where torch sees no card,
before it loads anything.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dmi_tpu_torch"
FORBIDDEN = ("dmi_tpu", "jax", "jaxlib", "optax", "flax", "orbax")
# packages the card's machine does not have: the port carries stand-ins
ABSENT_ON_CARD = ("tokenizers", "nltk", "rouge_score", "regex", "transformers")
# the only imports of those packages the port keeps, as (file, function,
# package): in the copies, each inside a try whose except takes the
# documented fallback (SciBERT's tokenizer absent: the BasicTokenizer
# stand-in, and the eval environment's record of it; wordnet absent: METEOR
# without the synonym stage; the hub's Llama tokenizer absent: stats.py's
# __main__ counts with the fixture's); and the tokenizer of a real HF LM
# (test: LMs use the port's own)
GUARDED_IMPORTS = {("data/stats.py", None, "transformers"),
                   ("evals/captions.py", "get_chebi_tokenizer", "transformers"),
                   ("evals/environment.py", "_chebi_tokenizer_kind", "transformers"),
                   ("evals/meteor15.py", "wordnet_synonyms", "nltk"),
                   ("training/model_utils.py", "build_tokenizer", "transformers")}

# the framework-free dmi_tpu modules the port keeps its own copies of
COPIES = [
    "config.py", "registry.py", "chat_templates.py", "training/results.py", "utils/logging.py",
    "data/__init__.py", "data/collator.py", "data/loader.py", "data/inffs.py", "data/sampler.py",
    "data/prefetch.py", "data/fixtures.py", "data/stats.py",
    *(f"evals/{p.name}" for p in sorted((REPO / "dmi_tpu" / "evals").glob("*.py"))),
]
# the third-party imports a copy swaps for the port's own stand-in, besides
# the dmi_tpu -> dmi_tpu_torch rewrite (tests/test_torch_evals_standalone.py
# holds each stand-in to its original)
SUBSTITUTIONS = {
    "from nltk.stem.porter import": "from dmi_tpu_torch.evals.stem import",
    "from nltk.stem.snowball import": "from dmi_tpu_torch.evals.stem import",
    "from nltk.translate.bleu_score import": "from dmi_tpu_torch.evals.nltk_bleu import",
    "from rouge_score import rouge_scorer": "from dmi_tpu_torch.evals import rouge_scorer",
    "from transformers.models.bert.tokenization_bert import":
        "from dmi_tpu_torch.evals.basic_tokenizer import",
}
_HEADER = ("# Copy of dmi_tpu/{rel} with its dmi_tpu imports rewritten to dmi_tpu_torch, so that\n"
           "# the port loads no module of the JAX package (tests/test_torch_isolation.py holds "
           "the two equal).\n")
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)dmi_tpu(?=[.\s])")


def _ported_line(line: str) -> str:
    """A line of a dmi_tpu module as its copy has it."""
    line = _IMPORT.sub(r"\1dmi_tpu_torch", line)
    body = line.lstrip()
    for original, own in SUBSTITUTIONS.items():
        if body.startswith(original + " ") or body.rstrip("\n") == original:
            return line[:len(line) - len(body)] + own + body[len(original):]
    return line


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


def _imports_in_functions(path: Path):
    """(innermost enclosing function or None, module) of every import."""
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                found.extend((fn, a.name) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                found.append((fn, child.module))
            visit(child, fn)

    visit(ast.parse(path.read_text(), str(path)), None)
    return found


def test_port_and_smoke_import_no_package_the_card_lacks():
    """Only in the guarded places of GUARDED_IMPORTS, each of which is still
    there."""
    bad, seen = {}, set()
    for p in _sources():
        rel = str(p.relative_to(PORT)) if p.is_relative_to(PORT) else p.name
        for fn, module in _imports_in_functions(p):
            top = module.split(".")[0]
            if top not in ABSENT_ON_CARD:
                continue
            if (rel, fn, top) in GUARDED_IMPORTS:
                seen.add((rel, fn, top))
            else:
                bad.setdefault(rel, []).append((fn, module))
    assert not bad, bad
    assert seen == GUARDED_IMPORTS


def test_isolation_check_sees_lazy_imports(tmp_path):
    """The check reads nested, lazy imports too, and tells dmi_tpu_torch apart."""
    src = tmp_path / "m.py"
    src.write_text("import dmi_tpu_torch.ops\nfrom dmi_tpu_torch import bridge\n"
                   "def f():\n    from dmi_tpu.config import TrainArgs\n"
                   "    import jax.numpy as jnp\n")
    assert _forbidden_imports(src) == [(4, "dmi_tpu.config"), (5, "jax.numpy")]


def test_every_substitution_is_used():
    """Each row of SUBSTITUTIONS rewrites a line of some copy, and no copy
    keeps an import of a scorer package the card lacks."""
    used = set()
    for rel in COPIES:
        for line in (REPO / "dmi_tpu" / rel).read_text().splitlines(keepends=True):
            used.update(k for k in SUBSTITUTIONS if line.lstrip().startswith(k))
    assert used == set(SUBSTITUTIONS)
    assert _ported_line("    from nltk.stem.porter import PorterStemmer\n") == (
        "    from dmi_tpu_torch.evals.stem import PorterStemmer\n")
    assert _ported_line("from rouge_score import rouge_scorer\n") == (
        "from dmi_tpu_torch.evals import rouge_scorer\n")
    assert _ported_line("from rouge_score import scoring\n") == "from rouge_score import scoring\n"


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_dmi_tpu(rel):
    """A copy drifts from its original in neither direction: it is the
    original with `dmi_tpu` rewritten to `dmi_tpu_torch` in its import
    statements and SUBSTITUTIONS applied to them, under a two-line header."""
    original = (REPO / "dmi_tpu" / rel).read_text().splitlines(keepends=True)
    want = _HEADER.format(rel=rel) + "".join(map(_ported_line, original))
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


# the decode path: serving, the models and every op (the kernel build reads
# CUDA_HOME to find nvcc, and nothing else)
DECODE_PATH = [PORT / "serve.py", *sorted((PORT / "models").glob("*.py")),
               *(p for p in sorted((PORT / "ops").rglob("*.py")) if p.name != "_build.py")]
# dmi_tpu's switches of the same path
JAX_SWITCHES = ("DMI_DECODE_BATCH_FIRST", "DMI_PALLAS_HEAD_ARGMAX", "DMI_PALLAS_DECODE_MLP",
                "DMI_W4_XLA", "DMI_W4_BO", "DMI_PIN_WEIGHTS")


def _reads_environment(path: Path):
    """Lines of the file that import os or touch an environment."""
    tree = ast.parse(path.read_text(), str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(a.name == "os" for a in node.names):
            found.append(node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            found.append(node.lineno)
        elif isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv", "putenv"):
            found.append(node.lineno)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and any(
                s in node.value for s in JAX_SWITCHES):
            found.append(node.lineno)
    return found


def test_decode_path_reads_no_environment_variable():
    """dmi_tpu hides its decode kernels behind DMI_* switches; the port has
    none: which loop and which kernel run follows from the arguments, the
    weights' kind and the tensors' device alone."""
    assert len(DECODE_PATH) > 15
    names = {p.name for p in DECODE_PATH}
    assert {"decode.py", "mmmodel.py", "quant.py", "decode_mlp.py", "head_argmax.py",
            "w4_matmul.py"} <= names
    bad = {str(p.relative_to(REPO)): lines for p in DECODE_PATH
           if (lines := _reads_environment(p))}
    assert not bad, bad


def test_environment_check_sees_reads(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n\ndef f():\n    return os.environ.get('DMI_W4_XLA') == '1'\n")
    assert _reads_environment(src) == [1, 4, 4]


def test_serving_defaults_to_the_batch_last_loop(monkeypatch):
    """caption_generate and Captioner(int8="w4a8") take the batch-last loop
    unless batch_first is passed; dmi_tpu's environment switches change
    nothing."""
    import inspect

    import numpy as np

    from dmi_tpu_torch import serve
    from dmi_tpu_torch.models import decode as dec
    from dmi_tpu_torch.models import llama, mmmodel
    from dmi_tpu_torch.models import projector as proj

    torch.set_num_threads(1)
    assert inspect.signature(mmmodel.caption_generate).parameters["batch_first"].default is False
    assert inspect.signature(serve.Captioner.__init__).parameters["batch_first"].default is False
    for name in JAX_SWITCHES:
        monkeypatch.setenv(name, "1")
    calls = []
    real_bl, real_bf = dec.greedy_generate_bl, dec.greedy_generate
    monkeypatch.setattr(dec, "greedy_generate_bl",
                        lambda *a, **kw: calls.append(("bl", kw)) or real_bl(*a, **kw))
    monkeypatch.setattr(dec, "greedy_generate",
                        lambda *a, **kw: calls.append(("bf", kw)) or real_bf(*a, **kw))
    cfg = llama.tiny_config(vocab_size=64, hidden_size=32, n_layers=1, n_heads=2, n_kv=1,
                            intermediate=64)
    gen = torch.Generator().manual_seed(0)
    params = llama.init(cfg, gen)
    spec = proj.ProjectorSpec(mm_dim=8, lm_dim=32)
    cap = serve.Captioner(cfg, params, spec, proj.init(spec, gen), max_new_tokens=3,
                          batch_size=2, int8="w4a8", prefix_ids=[1, 2], pad_token_id=0)
    ids = cap.caption_ids(np.ones((2, 8), np.float32))
    assert tuple(ids.shape) == (2, 3)
    assert [c[0] for c in calls] == ["bl"]
    assert calls[0][1]["prefill_params"] is cap.llm_params_prefill is not None
    assert "qp" in cap.llm_params["layers"][0]["w_gu"]
    serve.Captioner(cfg, params, spec, cap.proj_params, max_new_tokens=3, batch_size=2,
                    batch_first=True, prefix_ids=[1, 2], pad_token_id=0).caption_ids(
                        np.ones((2, 8), np.float32))
    assert [c[0] for c in calls] == ["bl", "bf"]
