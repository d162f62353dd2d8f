"""Absorbed MLA's share of its roofline in the decode step: the least time
for what each call of `models.decode._mla_attn_bl` needs over the device
time of the operations launched inside it.

Operations: the q and kv_a projections, wkv_b absorbed into q and into the
output, and the scores and context over the latent cache's S rows (all
heads).  Bytes: wq, wkv_a and wkv_b (bf16), the cache's S rows of r + dr
read and the step's row written, the normed input in and the output out."""

from portbench import counts

MOVES = "captions_per_s"


def _shape(cfg, lw, hn, latent, row, span, *a, **kw):
    return {"B": hn.shape[1], "S": span}


SPANS = {"mla_attn": [("dmi_tpu_torch.models.decode", "_mla_attn_bl", _shape)]}


def work(c: dict, B: int, S: int) -> tuple:
    s = counts.sizes(c)
    H, nh, r, dn, dr, dv = s["H"], s["nh"], s["r"], s["dn"], s["dr"], s["dv"]
    macs = B * (H * nh * (dn + dr) + H * (r + dr) + nh * dn * r + nh * r * dv
                + S * nh * (2 * r + dr))
    weights = H * nh * (dn + dr) + H * (r + dr) + r * nh * (dn + dv)
    nbytes = 2.0 * (weights + B * (S + 1) * (r + dr) + B * H + B * nh * dv)
    return 2.0 * macs, nbytes


def read(t):
    calls, secs = t.calls.get("mla_attn"), t.span_seconds("mla_attn")
    if not calls or secs <= 0:
        return None
    c = t.ctx["config"]
    return 100.0 * sum(counts.least_seconds(*work(c, x["B"], x["S"])) for x in calls) / secs
