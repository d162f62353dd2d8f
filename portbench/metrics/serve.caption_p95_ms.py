"""The 95th percentile of the request latency over every request of the
run's measured window: from the hand-off of a request's batch to
caption_ids to its ids on the host, so all requests of a call share the
call's seconds.  The closed loop keeps the system saturated (the next
batch is always waiting), so the tail is the service time's tail, and the
end-to-end metric is the throughput it moves."""

import statistics

MOVES = "captions_per_s"


def read(t):
    secs, batch = t.ctx.get("call_seconds"), t.ctx["traffic"]["batch"]
    if not secs or len(secs) < 2:
        return None
    per_request = [1e3 * s for s in secs for _ in range(batch)]
    return statistics.quantiles(per_request, n=20, method="inclusive")[-1]
