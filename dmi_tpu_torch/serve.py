"""Batch captioning service: embeddings in, captions out (counterpart of
dmi_tpu/serve.py, greedy batch engine).

    captioner = Captioner.from_checkpoint(
        lm="test:1b", projector_ckpt="checkpoints/...-projector-best.pt",
        dataset="sydney", device="cuda",
    )
    captions = captioner.caption(embeddings)   # [N, mm_dim] -> N strings

Per batch: l2-normalize, project (the fused MLP2 CUDA kernel), prepend the
soft token to the chat prefix, greedy-decode on the batch-last loop (per
step: the decode-attention and decode-MLP CUDA kernels on every layer, the
fused head + argmax kernel once; with int8="w8a8"|"w4a8" the int8 matmul
kernels in place of the layers' matmuls).  The tail batch is padded to the
batch size, as in the JAX package.

CLI:  python -m dmi_tpu_torch.serve --lm test:tiny --projector-ckpt P
      --dataset sydney --embs embs.npy --out captions.json
      [--int8 [1|w8a8|w4a8]] [--device cpu]

It runs on the card unless asked for the CPU, and fails before loading
anything when no card is visible.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from dmi_tpu_torch.models import mmmodel
from dmi_tpu_torch.models import projector as proj
from dmi_tpu_torch.models.llama import fuse_projections
from dmi_tpu_torch.models.quant import quantize_llama
from dmi_tpu_torch.ops import l2_normalize
from dmi_tpu_torch.training.checkpoint import load_pytree
from dmi_tpu_torch.training.model_utils import build_lm, build_tokenizer, require_device


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class Captioner:
    """Greedy captioner over one LLM and one projector.

    int8: False serves the weights as they are; True quantizes them to int8
    and widens them at each matmul; "w8a8" runs int8 x int8 matmuls in the
    token loop; "w4a8" packs the layer weights to int4 for the token loop
    (its embed stays int8).  The last two keep the unquantized originals for
    the compute-bound prefill (llm_params_prefill), as dmi_tpu does.
    batch_first=True pins the batch-first decode loop (a parity oracle: the
    batch-last loop is the default and is token-identical).

    Surface difference from dmi_tpu.serve.Captioner: the default engine is
    "batch" (fixed batches, tail padded), the only engine ported so far;
    engine="auto"|"bulk", sampling (temperature), mesh_shape and
    speculative raise NotImplementedError naming their ROADMAP item.

    The chat prefix comes from `tokenizer` + `prefix` (the chat template
    applied, as in dmi_tpu), or directly as `prefix_ids`, with no tokenizer
    needed; `pad_token_id` defaults to the tokenizer's."""

    def __init__(
        self,
        llm_cfg,
        llm_params: dict,
        proj_spec: proj.ProjectorSpec,
        proj_params: dict,
        tokenizer=None,
        prefix: Optional[str] = None,
        max_new_tokens: int = 22,
        batch_size: int = 256,
        int8=False,
        mesh_shape: Optional[tuple] = None,
        speculative: int = 0,
        batch_first: bool = False,
        *,
        prefix_ids: Optional[Sequence[int]] = None,
        pad_token_id: Optional[int] = None,
    ):
        if int8 not in (False, True, "w8a8", "w4a8"):
            raise ValueError(f"int8 must be False, True, 'w8a8' or 'w4a8', got {int8!r}")
        if mesh_shape:
            raise _not_ported("mesh_shape", "A.10 (parallelism)")
        if speculative:
            raise _not_ported("speculative decoding", "A.8 (speculative decoding)")
        if prefix_ids is None:
            if tokenizer is None or prefix is None:
                raise ValueError("pass tokenizer and prefix, or prefix_ids")
            prefix_ids = tokenizer.apply_chat_template(
                [{"role": "user", "content": prefix}],
                tokenize=True,
                add_generation_prompt=True,
            )
        if pad_token_id is None:
            if tokenizer is None:
                raise ValueError("pass pad_token_id when there is no tokenizer")
            pad_token_id = tokenizer.pad_token_id
        self.llm_cfg = llm_cfg
        llm_params = fuse_projections(llm_params)
        # w8a8 and w4a8 quantize the token loop only: prefill runs on the
        # unquantized originals (one more weight copy in device memory)
        self.llm_params_prefill = llm_params if int8 in ("w8a8", "w4a8") else None
        if int8 == "w4a8":
            llm_params = quantize_llama(llm_params, bits=4)
        elif int8:
            llm_params = quantize_llama(llm_params, native=(int8 == "w8a8"))
        self.llm_params = llm_params
        self.batch_first = batch_first
        self.proj_spec = proj_spec
        self.proj_params = proj_params
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size
        self.pad_token_id = pad_token_id
        self.device = self.llm_params["final_norm"].device
        self._prefix = torch.as_tensor(
            np.asarray(prefix_ids, np.int64), device=self.device
        )[None, :].expand(batch_size, -1)

    @classmethod
    def from_checkpoint(
        cls,
        lm: str,
        projector_ckpt: str,
        dataset: str,
        lm_dtype: str = "bfloat16",
        device="cuda",
        **kwargs,
    ) -> "Captioner":
        # imported here so that serving from parameters loads neither
        from dmi_tpu_torch.config import LMArgs
        from dmi_tpu_torch.registry import dataset_spec

        device = require_device(device)
        spec = dataset_spec(dataset)
        lm_args = LMArgs(lm_name_or_path=lm, lm_dtype=lm_dtype)
        tokenizer = build_tokenizer(lm_args)
        llm_cfg, llm_params = build_lm(lm_args, tokenizer, device=device)
        ckpt = load_pytree(projector_ckpt)
        if ckpt.get("generated_projector") is not None:
            # fewshot checkpoint: serve the baked generated projector
            tree = ckpt["generated_projector"]
        else:
            key = next(
                k for k in ckpt
                if k.endswith("_state_dict")
                and k not in ("optimizer_state_dict", "hypernet_state_dict")
            )
            tree = ckpt[key]
        pparams = {"layers": [
            {n: torch.as_tensor(np.asarray(layer[n]), device=device) for n in ("w", "b")}
            for layer in tree["layers"]
        ]}
        pspec = proj.ProjectorSpec(
            mm_dim=pparams["layers"][0]["w"].shape[0],
            lm_dim=llm_cfg.hidden_size,
            n_layers=len(pparams["layers"]),
        )
        prefix = spec.fixed_prefix or f"Describe the {spec.modality.value}"
        return cls(
            llm_cfg, llm_params, pspec, pparams, tokenizer,
            prefix, spec.max_new_tokens, **kwargs,
        )

    def _dispatch_batch(self, chunk: np.ndarray, plain: bool = False):
        """Pad one chunk to the batch size and decode it (asynchronously on
        a CUDA device); returns (tokens [batch_size, max_new], real rows)."""
        real = chunk.shape[0]
        if real < self.batch_size:  # pad the tail to the batch shape
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], self.batch_size - real, axis=0)], axis=0
            )
        embs = l2_normalize(torch.as_tensor(chunk, dtype=torch.float32, device=self.device))
        soft = proj.apply(self.proj_spec, self.proj_params, embs, plain=plain)
        tokens = mmmodel.caption_generate(
            self.llm_cfg, self.llm_params, soft, self._prefix,
            self.max_new_tokens, self.pad_token_id,
            prefill_params=self.llm_params_prefill, batch_first=self.batch_first, plain=plain,
        )
        return tokens, real

    @torch.no_grad()
    def caption_ids(self, embeddings: np.ndarray, plain: bool = False) -> torch.Tensor:
        """Greedy caption ids, LongTensor [N, max_new_tokens] on the CPU,
        pad-filled after each row's EOS.  plain=True runs the kernels'
        plain twins in place of the CUDA kernels (a reference path)."""
        embeddings = np.asarray(embeddings, np.float32)
        pending = [
            self._dispatch_batch(embeddings[s : s + self.batch_size], plain=plain)
            for s in range(0, embeddings.shape[0], self.batch_size)
        ]
        if not pending:
            return torch.zeros((0, self.max_new_tokens), dtype=torch.long)
        return torch.cat([tokens[:real] for tokens, real in pending]).cpu()

    def caption(
        self,
        embeddings: np.ndarray,
        temperature: Optional[float] = None,
        engine: str = "batch",
    ) -> List[str]:
        """Greedy captions, one string per row of embeddings [N, mm_dim]."""
        if engine not in ("auto", "batch", "bulk"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine != "batch":
            raise _not_ported(f"engine={engine!r}", "A.7 (continuous batching)")
        if temperature is not None:
            raise _not_ported("sampling (temperature)", "A.6 (sampling)")
        if self.tokenizer is None:
            raise ValueError("caption() needs a tokenizer; use caption_ids()")
        ids = self.caption_ids(embeddings)
        return self.tokenizer.batch_decode(ids.numpy(), skip_special_tokens=True)


def _load_embs(path: str):
    import pickle

    if path.endswith(".npy"):
        arr = np.load(path)
        return [str(i) for i in range(arr.shape[0])], arr
    with open(path, "rb") as f:
        d = pickle.load(f)
    ids = list(d)
    key = "emb" if "emb" in next(iter(d.values())) else "embs"
    embs = np.stack([np.asarray(d[i][key], np.float32) for i in ids])
    if embs.ndim == 3:
        embs = embs[:, 0]
    return ids, embs


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--lm", required=True)
    ap.add_argument("--projector-ckpt", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--embs", required=True, help=".npy array or reference-schema .pkl")
    ap.add_argument("--out", default="captions.json")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--int8", nargs="?", const="1", default=None,
                    choices=["1", "w8a8", "w4a8"],
                    help="quantize the LLM: int8 weights widened at the matmul (1), int8 x "
                         "int8 matmuls (w8a8) or int4 weights with int8 activations (w4a8) "
                         "in the token loop")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cap = Captioner.from_checkpoint(
        args.lm, args.projector_ckpt, args.dataset, device=args.device,
        batch_size=args.batch_size,
        int8={None: False, "1": True}.get(args.int8, args.int8),
    )
    ids, embs = _load_embs(args.embs)
    captions = cap.caption(embs)
    with open(args.out, "w") as f:
        json.dump(dict(zip(ids, captions)), f, indent=2)
    print(f"wrote {len(captions)} captions -> {args.out}")


if __name__ == "__main__":
    main()
