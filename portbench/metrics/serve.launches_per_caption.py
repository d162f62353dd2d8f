"""Device operations (kernels, memcpys, memsets) the traced calls ran, per
caption they returned: the host's launch work that sets the pace where
the device waits for it."""

MOVES = "captions_per_s"


def read(t):
    n = t.work.get("captions")
    return len(t.ops) / n if n and t.ops else None
