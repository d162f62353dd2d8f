"""Device operations (kernels, memcpys, memsets) the traced micro-steps
ran, per training row."""

MOVES = "train_samples_per_s"


def read(t):
    n = t.work.get("samples")
    return len(t.ops) / n if n and t.ops else None
