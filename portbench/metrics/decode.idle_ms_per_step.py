"""Milliseconds a decode step leaves the device idle: the untraced window's
idle seconds a call (its seconds a call less the device's busy seconds a
traced call, the correction idle_share.serve makes for the profiler's
slower host), times the share of the traced idle gaps whose closing
operation was launched inside the program's range `decode.step` (one
iteration of the batch-last loop, its bookkeeping included), over the
decode steps a call (max_new_tokens - 1; one batch a call).  A program
without the range gives no value."""

MOVES = "captions_per_s"


def read(t):
    secs, units = t.ctx.get("timed_s"), t.ctx.get("timed_units")
    if not secs or not units or t.busy_s <= 0 or "decode.step" not in t.ranges:
        return None
    idle, in_step, end = 0.0, 0.0, None
    for s, e, _, launch in t.ops:
        if end is not None and s > end:
            idle += s - end
            if launch is not None and t._inside("decode.step", launch):
                in_step += s - end
        end = e if end is None else max(end, e)
    if idle <= 0:
        return None
    per_call = secs / units - t.busy_s / t.work["units"]
    return 1e3 * per_call * (in_step / idle) / (t.ctx["traffic"]["max_new_tokens"] - 1)
