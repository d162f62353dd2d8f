"""The whole serving step's share of the card's bf16 peak on a configuration
with leading dense layers, q-LoRA attention or one expert-parallel rank's
share of the experts: the model operations of the requests the run's
measured window returned (portbench.counts_ep.caption_flops: the prompt,
every decode step and the head's emitted tokens; the dense layers at their
width, the routed ones at the held experts' share of k experts a token),
over the window's seconds on the host's clock and 989 TFLOP/s."""

from portbench import counts_ep

MOVES = "captions_per_s"


def read(t):
    c, tr = t.ctx["config"], t.ctx["traffic"]
    secs = t.ctx.get("timed_s")
    if not secs or not t.ctx.get("timed_units"):
        return None
    n = t.ctx["timed_units"] * tr["batch"]
    flops = n * counts_ep.caption_flops(c, 1 + tr["prefix_len"], tr["max_new_tokens"])
    return 100.0 * flops / (secs * counts_ep.PEAK_BF16_FLOPS)
