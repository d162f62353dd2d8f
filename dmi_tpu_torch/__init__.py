"""dmi_tpu_torch — the PyTorch and CUDA port of dmi_tpu for NVIDIA Hopper.

A second package beside dmi_tpu, which stays the reference the port is held
against: the same weights and inputs go through both packages in the tests
(bridge.py converts dmi_tpu's parameters).  The port imports torch and
nothing of JAX or dmi_tpu: it carries its own copies of dmi_tpu's
framework-free modules (config, registry, chat_templates, data, evals,
training/results, utils/logging), which tests/test_torch_isolation.py holds
equal to the originals.  Its entry points run on the card unless asked for
the CPU (device="cpu", --device cpu).

Ported so far: greedy serving on the llama-3.x body (serve.Captioner);
stage-1 projector training (train_projector); stage-2 hypernetwork training
and stage-3 few-shot integration (train_hypernet); the LoRA baseline
(train_lora).  The projector MLP2, the single-token decode attention, the
causal flash attention (forward and backward) and the fused LoRA layer 0
are hand-written CUDA kernels for sm_90a (csrc/, bound through ops/cuda/).
Serving also runs tensor- and data-parallel over torch.distributed
(parallel/, Captioner(mesh_shape=...)).  ROADMAP.md lists what comes next.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level API (importing the package loads no torch module)
    if name == "Captioner":
        from dmi_tpu_torch.serve import Captioner

        return Captioner
    if name == "LlamaConfig":
        from dmi_tpu_torch.models.llama import LlamaConfig

        return LlamaConfig
    raise AttributeError(name)
