"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each wrapper checks its inputs, runs its plain PyTorch twin for tensors on
the CPU, and launches its kernel for tensors on a CUDA device, counting the
launch in the module's launch counter.  The kernels are compiled from
dmi_tpu_torch/csrc at first launch (_build.py).  The fused head + argmax is
head_argmax.head_argmax: a function of its module's name is not re-exported
here, where it would hide the module.
"""

from dmi_tpu_torch.ops.cuda.decode_attn import fused_decode_attention
from dmi_tpu_torch.ops.cuda.decode_mlp import fused_decode_mlp_bl
from dmi_tpu_torch.ops.cuda.flash_attn import flash_attention
from dmi_tpu_torch.ops.cuda.lora0 import fused_lora_layer0
from dmi_tpu_torch.ops.cuda.projector import fused_mlp2
from dmi_tpu_torch.ops.cuda.w4_matmul import w4_mm_bl, w8_mm_bl

__all__ = ["flash_attention", "fused_decode_attention", "fused_decode_mlp_bl",
           "fused_lora_layer0", "fused_mlp2", "w4_mm_bl", "w8_mm_bl"]
