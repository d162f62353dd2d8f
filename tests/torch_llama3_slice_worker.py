"""Worker of tests/test_torch_llama3_slice.py: both packages resolve
meta-llama/Llama-3.2-1B-Instruct from one hub cache and run the slice.

    HF_HUB_CACHE=CACHE HF_HUB_OFFLINE=1 python tests/torch_llama3_slice_worker.py WORKDIR OUT

WORKDIR holds data/ from generate_dataset (sydney, mm 32); CACHE holds the
model's snapshot (a tiny f32 Llama at vocab 128256 and the Llama-3 fixture
tokenizer).  huggingface_hub reads HF_HUB_CACHE and HF_HUB_OFFLINE when it
is imported, so dmi_tpu's AutoTokenizer and AutoModelForCausalLM see the
cache only in a process started with them.  Writes OUT (JSON): each
package's tokenizer outputs, first stage-1 batch, step-0 loss and greedy
serve batch, for the test to compare.
"""

import json
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmi_tpu import config as jconfig  # noqa: E402
from dmi_tpu.data.loader import DatasetLoader as JaxLoader  # noqa: E402
from dmi_tpu.models import projector as jproj  # noqa: E402
from dmi_tpu.registry import dataset_spec  # noqa: E402
from dmi_tpu.serve import Captioner as JaxCaptioner  # noqa: E402
from dmi_tpu.training import model_utils as jmu  # noqa: E402
from dmi_tpu.training.checkpoint import save_pytree  # noqa: E402
from dmi_tpu.training.embeddings import EmbeddingManager as JaxEmbeddingManager  # noqa: E402
from dmi_tpu.training.projector_trainer import ProjectorTrainer as JaxTrainer  # noqa: E402
from dmi_tpu_torch import bridge  # noqa: E402
from dmi_tpu_torch import config as tconfig  # noqa: E402
from dmi_tpu_torch.data.loader import DatasetLoader  # noqa: E402
from dmi_tpu_torch.serve import Captioner  # noqa: E402
from dmi_tpu_torch.training import model_utils as tmu  # noqa: E402
from dmi_tpu_torch.training.embeddings import EmbeddingManager  # noqa: E402
from dmi_tpu_torch.training.projector_trainer import ProjectorTrainer  # noqa: E402

torch.set_num_threads(1)

NAME = "meta-llama/Llama-3.2-1B-Instruct"
ENCODER = "RemoteCLIP-RN50-Unchanged"
MM = 32
TRAIN = dict(output_dir="slice", train_batch_size=5, eval_batch_size=4, epochs=1,
             dataset_size="full", seed=3, learning_rate=1e-3, warmup_steps=2, save_steps=1000,
             eval_steps=1000, generate_steps=1000)
SERVE_BATCH = 4


def _lists(batch: dict) -> dict:
    return {k: np.asarray(v).tolist() for k, v in batch.items()}


def tokenizers_side(tok, spec) -> dict:
    """What the slice asks of a tokenizer: the loader's chats with assistant
    masks, the serving prompt, captions with bos, and their decodes."""
    from dmi_tpu_torch.data.fixtures import CAPTION_BANK

    prefix = spec.fixed_prefix or f"Describe the {spec.modality.value}"
    chats = [[{"role": "user", "content": prefix}, {"role": "assistant", "content": c}]
             for c in CAPTION_BANK]
    enc = tok.apply_chat_template(chats, tokenize=True, return_dict=True,
                                  return_assistant_tokens_mask=True, date_string="1 Jan 2025")
    plain = tok(CAPTION_BANK)["input_ids"]
    return {"class": type(tok).__name__, "bos": tok.bos_token_id, "eos": tok.eos_token_id,
            "pad": tok.pad_token_id, "vocab_size": tok.vocab_size,
            "padding_side": tok.padding_side, "chat_template": tok.chat_template,
            "input_ids": enc["input_ids"], "assistant_masks": enc["assistant_masks"],
            "prompt": tok.apply_chat_template([{"role": "user", "content": prefix}],
                                              tokenize=True, add_generation_prompt=True),
            "plain": plain, "decoded": tok.batch_decode(plain, skip_special_tokens=True),
            "decoded_special": tok.batch_decode(enc["input_ids"])}


def main(workdir: str, out_path: str) -> None:
    os.chdir(workdir)
    spec = dataset_spec("sydney")
    out = {}
    jtok = jmu.build_tokenizer(jconfig.LMArgs(lm_name_or_path=NAME))
    ttok = tmu.build_tokenizer(tconfig.LMArgs(lm_name_or_path=NAME))
    out["tokenizer"] = {"jax": tokenizers_side(jtok, spec), "torch": tokenizers_side(ttok, spec)}

    jcfg, jparams = jmu.build_lm(jconfig.LMArgs(lm_name_or_path=NAME, lm_dtype="float32"), jtok)
    tcfg, tparams = tmu.build_lm(tconfig.LMArgs(lm_name_or_path=NAME, lm_dtype="float32"), ttok)
    want = bridge.llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    out["config_equal"] = tcfg == bridge.config_from_jax(jcfg)
    out["params_equal"] = all(torch.equal(a, b) for a, b in zip(
        [tparams["embed"], tparams["final_norm"], *(l[k] for l in tparams["layers"]
                                                     for k in sorted(l))],
        [want["embed"], want["final_norm"], *(l[k] for l in want["layers"] for k in sorted(l))]))
    out["vocab_size"] = tcfg.vocab_size

    is_instruct = jmu.is_instruct_lm(NAME)
    out["is_instruct"] = [is_instruct, tmu.is_instruct_lm(NAME)]
    jloader = JaxLoader(spec, jtok, jconfig.TrainArgs(**TRAIN), ENCODER, is_instruct, "data")
    tloader = DatasetLoader(spec, ttok, tconfig.TrainArgs(**TRAIN), ENCODER,
                            tmu.is_instruct_lm(NAME), "data")
    out["batch"] = {"jax": _lists(jloader.train_batch(0)), "torch": _lists(tloader.train_batch(0))}

    jspec = jproj.ProjectorSpec(mm_dim=MM, lm_dim=tcfg.hidden_size, dropout=0.0)
    jpp = jproj.init(jax.random.key(1), jspec)
    encoder = f"chendelong/{ENCODER}"
    jt = JaxTrainer(name="slice", llm_cfg=jcfg, llm_params=jparams, proj_spec=jspec,
                    proj_params=jpp, loaders=[jloader], emb_mgrs=[JaxEmbeddingManager(encoder)],
                    tokenizer=jtok, train_args=jconfig.TrainArgs(**TRAIN))
    tt = ProjectorTrainer(name="slice", llm_cfg=tcfg, llm_params=tparams,
                          proj_spec=bridge.projector_spec_from_jax(jspec),
                          proj_params=bridge.projector_params_from_train_state(jt.state),
                          loaders=[tloader], emb_mgrs=[EmbeddingManager(encoder)],
                          tokenizer=ttok, train_args=tconfig.TrainArgs(**TRAIN))
    total = tt.total_steps
    out["loss"] = {"jax": float(jt.train_step(0, total)[0]),
                   "torch": float(tt.train_step(0, total)[0].item())}

    ckpt = os.path.join(workdir, "projector.pt")
    save_pytree(ckpt, {"step_idx": 0, "projector_state_dict": jpp})
    embs = np.random.default_rng(5).normal(size=(SERVE_BATCH, MM)).astype(np.float32)
    jcap = JaxCaptioner.from_checkpoint(NAME, ckpt, "sydney", lm_dtype="float32",
                                        batch_size=SERVE_BATCH)
    tcap = Captioner.from_checkpoint(NAME, ckpt, "sydney", lm_dtype="float32", device="cpu",
                                     batch_size=SERVE_BATCH)
    out["serve"] = {
        "jax": {"prefix": np.asarray(jcap._prefix).tolist(),
                "ids": np.asarray(jcap._dispatch_batch(embs, None, 0, 0, 0)[0]).tolist(),
                "captions": jcap.caption(embs, engine="batch")},
        "torch": {"prefix": np.asarray(tcap._prefix).tolist(),
                  "ids": tcap.caption_ids(embs).tolist(), "captions": tcap.caption(embs)}}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
