"""The router's share of the routed MLP's device time while serving: the
device seconds of the operations launched inside the program's span
`moe.route` (the router product and the gate weights) over those launched
inside `decode.moe` and `llama.moe` (the whole routed MLP, decode and
prefill).  A program without the span gives no value."""

MOVES = "captions_per_s"


def read(t):
    if "moe.route" not in t.ranges:
        return None
    whole = t.span_seconds("decode.moe", "llama.moe")
    return 100.0 * t.span_seconds("moe.route") / whole if whole > 0 else None
