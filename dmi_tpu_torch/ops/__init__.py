"""Compute ops: plain PyTorch ops plus the hand-written CUDA kernels of
dmi_tpu_torch.ops.cuda, each with a plain twin beside it."""

from dmi_tpu_torch.ops.linalg import (
    interleave_rows,
    l2_normalize,
    pad_features,
    random_orthogonal,
    sinusoidal_positions,
)

__all__ = [
    "interleave_rows",
    "l2_normalize",
    "pad_features",
    "random_orthogonal",
    "sinusoidal_positions",
]
