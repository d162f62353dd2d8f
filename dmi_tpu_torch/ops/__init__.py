"""Compute ops: plain PyTorch ops plus the hand-written CUDA kernels of
dmi_tpu_torch.ops.cuda, each with a plain twin beside it."""

from dmi_tpu_torch.ops.linalg import l2_normalize, pad_features

__all__ = ["l2_normalize", "pad_features"]
