"""Port of dmi_tpu.training: checkpoint loading and LM builders."""
