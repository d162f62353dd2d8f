"""The routed MLP's share of its roofline while serving: the least time the
card could take for the work the inputs need, over the device time of the
operations launched inside `decode._moe_mlp_bl` (each decode step) and
`llama._moe_mlp` (the prefill).

Operations: per token the router (H x E) and the k experts it is routed to
and the shared experts, 3 H x I products each.  Bytes: every expert's
weights read once a call (at 512 rows and more, top-8 or top-6 of 64
leaves an expert unchosen with a chance under 1e-28, so every expert is
read), the router and shared experts' weights, the tokens in and out."""

from portbench import counts

MOVES = "captions_per_s"


def _bl(cfg, lw, hn, *a, **k):
    return {"n": hn.shape[1]}


def _bf(cfg, lw, h, *a, **k):
    return {"n": h.shape[0] * h.shape[1]}


SPANS = {"moe": [("dmi_tpu_torch.models.decode", "_moe_mlp_bl", _bl),
                 ("dmi_tpu_torch.models.llama", "_moe_mlp", _bf)]}


def work(c: dict, n: int) -> tuple:
    """(operations, bytes) of one call over n tokens, bf16 weights."""
    s = counts.sizes(c)
    H, I, E = s["H"], s["I"], s["E"]
    flops = 2.0 * n * (H * E + 3 * H * I * (s["k"] + s["shared"]))
    nbytes = 2.0 * (3 * H * I * (E + s["shared"]) + H * E + 2 * n * H)
    return flops, nbytes


def read(t):
    calls, secs = t.calls.get("moe"), t.span_seconds("moe")
    if not calls or secs <= 0:
        return None
    c = t.ctx["config"]
    return 100.0 * sum(counts.least_seconds(*work(c, x["n"])) for x in calls) / secs
