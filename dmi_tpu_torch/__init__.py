"""dmi_tpu_torch — the PyTorch and CUDA port of dmi_tpu for NVIDIA Hopper.

A second package beside dmi_tpu, which stays the reference the port is held
against: the same weights and inputs go through both packages in the tests
(bridge.py converts dmi_tpu's parameters).  The port imports torch and never
JAX; it reuses dmi_tpu's framework-free modules (registry, config,
chat_templates, and the tokenizer fixture, lazily).

Ported so far: greedy serving on the llama-3.x body (serve.Captioner), with
the projector MLP2 and single-token decode attention as hand-written CUDA
kernels for sm_90a (csrc/, bound through ops/cuda/).  ROADMAP.md lists
what comes next.
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
