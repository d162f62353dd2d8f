"""Embedding manager: on-device L2 normalization of precomputed features
(counterpart of dmi_tpu/training/embeddings.py; reference EmbeddingManager,
dmi/utils/model_utils.py:47-62).  When feed_txt_embs, the (mm, text[,
prefix]) tuple has every member normalized.  Live encoders are inoperable
in the reference too (dmi/model/__init__.py:66-131)."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from dmi_tpu_torch.ops import l2_normalize


class EmbeddingManager:
    def __init__(self, model_name_or_path: str, load_extracted_features: bool = True,
                 device="cpu"):
        if not load_extracted_features:
            raise NotImplementedError(
                "live encoders are not wired in the reference either "
                "(dmi/model/__init__.py:66-131); provide extracted features"
            )
        self.model_name_or_path = model_name_or_path
        self.load_extracted_features = load_extracted_features
        self.device = torch.device(device)

    @property
    def short_name(self) -> str:
        return self.model_name_or_path.split("/")[-1]

    def _norm(self, x) -> torch.Tensor:
        return l2_normalize(torch.as_tensor(np.asarray(x, np.float32), device=self.device))

    def get_embeddings(self, inputs) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """L2-normalize an embedding array [B, mm] or a (mm, text[, prefix])
        tuple, as f32 tensors on the manager's device."""
        if isinstance(inputs, (tuple, list)):
            return tuple(self._norm(x) for x in inputs)
        return self._norm(inputs)


def build_embedding_managers(menc_args, device="cpu") -> list:
    return [
        EmbeddingManager(name, ext, device)
        for name, ext in zip(menc_args.menc_names_or_paths, menc_args.load_extracted_features)
    ]


def build_fewshot_embedding_managers(menc_args, device="cpu") -> list:
    return [
        EmbeddingManager(name, ext, device)
        for name, ext in zip(menc_args.fewshot_menc_names_or_paths,
                             menc_args.fewshot_load_extracted_features)
    ]
