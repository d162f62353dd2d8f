"""The whole stage-1 micro-step's share of the card's bf16 peak: the model
operations of the micro-steps of the run's measured window
(portbench.counts.stage1_flops: the frozen LLM's forward and its backward
to the activations, the routed MLP at k experts a token, and the
projector's), over the window's seconds on the host's clock and 989
TFLOP/s."""

from portbench import counts

MOVES = "train_samples_per_s"


def read(t):
    c, tr = t.ctx["config"], t.ctx["traffic"]
    secs = t.ctx.get("timed_s")
    if not secs or not t.ctx.get("timed_units"):
        return None
    flops = t.ctx["timed_units"] * counts.stage1_flops(c, tr["batch"], tr["text"] + 1,
                                                        tr["mm_dim"])
    return 100.0 * flops / (secs * counts.PEAK_BF16_FLOPS)
