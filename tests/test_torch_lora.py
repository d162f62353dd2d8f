"""dmi_tpu_torch's LoraTrainer (the LoRA baseline) against dmi_tpu's, on
shared weights and the fixture data, at f32 on the CPU: per-step losses to
1e-5 relative before any update and 1e-4 after (AdamW's normalized updates
carry the f32 differences on), the adapters within rtol 5e-4, atol 5e-6,
and identical greedy captions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dmi_tpu.data.fixtures import generate_dataset
from dmi_tpu.data.loader import DatasetLoader as JaxLoader
from dmi_tpu.data.tok_fixture import build_test_tokenizer
from dmi_tpu.models import lora as jlora
from dmi_tpu.models import projector as jproj
from dmi_tpu.registry import dataset_spec
from dmi_tpu.training.embeddings import EmbeddingManager as JaxEmbeddingManager
from dmi_tpu.training.lora_trainer import LoraTrainer as JaxLoraTrainer
from dmi_tpu_torch import bridge
from dmi_tpu_torch.data.loader import DatasetLoader
from dmi_tpu_torch.models import lora as tlora
from dmi_tpu_torch.training.embeddings import EmbeddingManager
from dmi_tpu_torch.training.lora_trainer import LoraTrainer
from tests.test_torch_hypernet_train import MM, PARAM_TOL, _args, _params_close
from tests.test_torch_train import _close, _llms

torch.set_num_threads(1)


def test_lora_trainer_losses_match_dmi_tpu(tmp_path, monkeypatch):
    """LoraTrainer: 6 micro-steps, an update every 2nd, per-step losses and
    the adapters against dmi_tpu's; both decode identical greedy captions."""
    monkeypatch.chdir(tmp_path)
    generate_dataset("data", "sydney", "RemoteCLIP-RN50-Unchanged", mm_dim=MM, n_train=4,
                     n_eval=2, seed=0)
    tok = build_test_tokenizer()
    args = _args(feed_txt_embs=False, augment_emb_space=False, epochs=2)
    jcfg, jllm, tcfg, tllm = _llms(vocab=tok.vocab_size + 8, weight_scale=10.0)
    pspec = jproj.ProjectorSpec(mm_dim=MM, lm_dim=64)
    jpp = jproj.init(jax.random.key(1), pspec)
    lspec = jlora.LoraSpec(rank=4, alpha=8)
    jad = jlora.init(jax.random.key(2), lspec, pspec)
    enc = "chendelong/RemoteCLIP-RN50-Unchanged"
    jloader = JaxLoader(dataset_spec("sydney"), tok, args, "RemoteCLIP-RN50-Unchanged", True,
                        "data")
    tloader = DatasetLoader(dataset_spec("sydney"), tok, args, "RemoteCLIP-RN50-Unchanged",
                            True, "data")
    jt = JaxLoraTrainer(lora_spec=lspec, lora_params=jad, frozen_proj_params=jpp, name="jax",
                        llm_cfg=jcfg, llm_params=jllm, proj_spec=pspec, loaders=[jloader],
                        emb_mgrs=[JaxEmbeddingManager(enc)], tokenizer=tok, train_args=args)
    tt = LoraTrainer(lora_spec=tlora.LoraSpec(rank=4, alpha=8),
                     lora_params=bridge.lora_params_from_jax(jax.tree.map(np.asarray, jad)),
                     frozen_proj_params=jax.tree.map(np.asarray, jpp), name="port",
                     llm_cfg=tcfg, llm_params=tllm,
                     proj_spec=bridge.projector_spec_from_jax(pspec), loaders=[tloader],
                     emb_mgrs=[EmbeddingManager(enc)], tokenizer=tok, train_args=args)
    total = tt.total_steps
    assert total == jt.total_steps > 6
    for step in range(6):
        jl, jdid = jt.train_step(step, total)
        tl, tdid = tt.train_step(step, total)
        assert tdid == jdid
        _close(tl.item(), float(jl), 1e-5 if step < 2 else 1e-4)
    _params_close(tt.params, jt.state.params, **PARAM_TOL)
    assert all(not t.requires_grad for layer in tt._frozen_proj["layers"] for t in layer.values())
    jt.state = jt.state._replace(params=jax.tree.map(
        jnp.asarray, [{k: v.detach().numpy() for k, v in ad.items()} for ad in tt.params]))
    _, jgts, jpreds, _ = jt.generate("test")
    _, tgts, tpreds, _ = tt.generate("test")
    assert tgts == jgts and tpreds == jpreds
