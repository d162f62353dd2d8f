"""The decode-attention kernel's share of its roofline: the least time for
what each call needs over the device time of the operations launched
inside `ops.cuda.decode_attn.fused_decode_attention`.

Operations: scores and context, 4 B nh P S hd.  Bytes: q and the output
(bf16), K and V over the S positions the call reads (bf16), the f32 bias."""

from portbench import counts

MOVES = "captions_per_s"


def _shape(q, k, v, bias, *a, **kw):
    B, nh, P, hd = q.shape
    return {"B": B, "nh": nh, "P": P, "hd": hd, "nkv": k.shape[1], "S": k.shape[2],
            "bias": bias.numel()}


SPANS = {"decode_attn": [("dmi_tpu_torch.ops.cuda.decode_attn", "fused_decode_attention",
                          _shape)]}


def work(x: dict) -> tuple:
    flops = 4.0 * x["B"] * x["nh"] * x["P"] * x["S"] * x["hd"]
    nbytes = (2.0 * 2 * x["B"] * x["nh"] * x["P"] * x["hd"]
              + 2.0 * 2 * x["B"] * x["nkv"] * x["S"] * x["hd"] + 4.0 * x["bias"])
    return flops, nbytes


def read(t):
    calls, secs = t.calls.get("decode_attn"), t.span_seconds("decode_attn")
    if not calls or secs <= 0:
        return None
    return 100.0 * sum(counts.least_seconds(*work(x)) for x in calls) / secs
