"""The head + argmax kernel's share of its roofline: the least time for
what each call of `ops.cuda.head_argmax.head_argmax` needs over the device
time of the operations launched inside it.

Operations: the logits, 2 V H B.  Bytes: the head's V x H rows (bf16), the
final norm's output [H, B] (bf16) and the ids out (int64)."""

from portbench import counts

MOVES = "captions_per_s"


def _shape(params, h, *a, **kw):
    V, H = params["embed"].shape
    return {"V": V, "H": H, "B": h.shape[1]}


SPANS = {"head_argmax": [("dmi_tpu_torch.ops.cuda.head_argmax", "head_argmax", _shape)]}


def work(x: dict) -> tuple:
    return (2.0 * x["V"] * x["H"] * x["B"],
            2.0 * x["V"] * x["H"] + 2.0 * x["H"] * x["B"] + 8.0 * x["B"])


def read(t):
    calls, secs = t.calls.get("head_argmax"), t.span_seconds("head_argmax")
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(counts.least_seconds(*work(x)) for x in calls) / secs
