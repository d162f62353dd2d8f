"""The share of the run's measured window in which no operation ran on the
device: one minus the device's busy seconds a call (the union of every
kernel, memcpy and memset over the traced calls, which run the same work
after the window) times the window's calls, over the window's seconds.
The profiler slows the host, so the traced calls take longer than measured
ones; the driver's own idle share (busy_s over window_s) reads that longer
window.

The ranges below label the breakdown's idle gaps by the step the host was
in when it launched the operation that ended the gap."""

MOVES = "train_samples_per_s"
SPANS = {"forward": [("dmi_tpu_torch.models.llama", "forward", None)]}


def read(t):
    secs, units = t.ctx.get("timed_s"), t.ctx.get("timed_units")
    if not secs or not units or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.work["units"] * units / secs)
