"""The decode-MLP kernel's share of its roofline: the least time for what
each call of `ops.cuda.decode_mlp.fused_decode_mlp_bl` needs over the
device time of the operations launched inside it.

At the call's H, I and B: operations 6 H I B (the gate, up and down
products); bytes 2 (3 H I + 2 H B), the bf16 weights read once and the
state in and out."""

from portbench import counts

MOVES = "captions_per_s"


def _shape(w_gu, w_down, h, *a, **kw):
    return {"H": h.shape[0], "I": w_down.shape[0], "B": h.shape[1]}


SPANS = {"decode_mlp": [("dmi_tpu_torch.ops.cuda.decode_mlp", "fused_decode_mlp_bl", _shape)]}


def work(x: dict) -> tuple:
    H, I, B = x["H"], x["I"], x["B"]
    return 6.0 * H * I * B, 2.0 * (3 * H * I + 2 * H * B)


def read(t):
    calls, secs = t.calls.get("decode_mlp"), t.span_seconds("decode_mlp")
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(counts.least_seconds(*work(x)) for x in calls) / secs
