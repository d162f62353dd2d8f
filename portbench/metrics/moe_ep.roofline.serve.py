"""The routed MLP's share of its roofline on one expert-parallel rank while
serving: the least time the card could take for the work the inputs need,
over the device time of the operations launched inside
`decode._moe_mlp_bl` (each decode step) and `llama._moe_mlp` (the prefill).

Operations over n tokens: 2n (H E_pub + 3 H I (k E_held / E_pub + shared)),
the router over every published expert and the held experts' share of
each token's k (portbench.counts_ep.moe_work).  Bytes: the held experts,
the shared experts, the router and its correction bias read once a call,
the tokens in and out."""

from portbench import counts_ep

MOVES = "captions_per_s"


def _bl(cfg, lw, hn, *a, **k):
    return {"n": hn.shape[1]}


def _bf(cfg, lw, h, *a, **k):
    return {"n": h.shape[0] * h.shape[1]}


SPANS = {"moe_ep": [("dmi_tpu_torch.models.decode", "_moe_mlp_bl", _bl),
                    ("dmi_tpu_torch.models.llama", "_moe_mlp", _bf)]}


def read(t):
    calls, secs = t.calls.get("moe_ep"), t.span_seconds("moe_ep")
    if not calls or secs <= 0:
        return None
    c = t.ctx["config"]
    return 100.0 * sum(counts_ep.least_seconds(*counts_ep.moe_work(c, x["n"]))
                       for x in calls) / secs
