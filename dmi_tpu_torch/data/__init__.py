# Copy of dmi_tpu/data/__init__.py with its dmi_tpu imports rewritten to dmi_tpu_torch, so that
# the port loads no module of the JAX package (tests/test_torch_isolation.py holds the two equal).
"""Data layer: pickle-schema loaders, chat collator, samplers, fixtures."""
