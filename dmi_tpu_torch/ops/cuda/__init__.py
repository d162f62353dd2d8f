"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each wrapper checks its inputs, runs its plain PyTorch twin for tensors on
the CPU, and launches its kernel for tensors on a CUDA device, counting the
launch in the module's `launches`.  The kernels are compiled from
dmi_tpu_torch/csrc at first launch (_build.py).
"""

from dmi_tpu_torch.ops.cuda.decode_attn import fused_decode_attention
from dmi_tpu_torch.ops.cuda.projector import fused_mlp2

__all__ = ["fused_decode_attention", "fused_mlp2"]
