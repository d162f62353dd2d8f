"""Port of dmi_tpu.training: stage-1 projector training, its optimizer,
checkpoints, generation helpers and LM constructors."""
