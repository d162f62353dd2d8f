"""The routed MLP's share of its roofline in the stage-1 micro-step: the
least time for its forward and its backward over the device time of the
operations launched inside the program's own ranges `llama.moe` (the
forward, `models.llama._moe_mlp`) and `llama.moe.bwd` (autograd's backward
of that region, on the engine's thread).

A call runs over n = batch x (text + 1) tokens; its forward's (operations,
bytes) are moe.roofline.serve's `work(c, n)`.  The experts are frozen, so
the backward goes to the activations only: the same products again and
every expert's weights read once more, the forward's (operations, bytes).
Calls: num_hidden_layers a micro-step.  A program without the ranges
gives no value."""

from portbench import counts
from portbench import harness as hx

MOVES = "train_samples_per_s"


def read(t):
    secs, steps = t.span_seconds("llama.moe", "llama.moe.bwd"), t.work.get("units")
    if secs <= 0 or not steps:
        return None
    c, tr = t.ctx["config"], t.ctx["traffic"]
    call = counts.least_seconds(*hx.reader("moe.roofline.serve").work(
        c, tr["batch"] * (tr["text"] + 1)))
    return 100.0 * 2 * call * counts.sizes(c)["L"] * steps / secs
