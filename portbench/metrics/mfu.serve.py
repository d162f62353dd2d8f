"""The whole serving step's share of the card's bf16 peak: the model
operations of the requests the run's measured window returned
(portbench.counts.caption_flops: the prompt, every decode step and the
head's emitted tokens, the routed MLP at k experts a token), over the
window's seconds on the host's clock and 989 TFLOP/s."""

from portbench import counts

MOVES = "captions_per_s"


def read(t):
    c, tr = t.ctx["config"], t.ctx["traffic"]
    secs = t.ctx.get("timed_s")
    if not secs or not t.ctx.get("timed_units"):
        return None
    n = t.ctx["timed_units"] * tr["batch"]
    flops = n * counts.caption_flops(c, 1 + tr["prefix_len"], tr["max_new_tokens"])
    return 100.0 * flops / (secs * counts.PEAK_BF16_FLOPS)
