"""Port of dmi_tpu.utils: gradient summaries and tracing."""
