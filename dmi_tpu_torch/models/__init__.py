"""Port of dmi_tpu.models: llama-3.x decoder, projector, greedy decode."""
