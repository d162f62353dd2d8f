"""Absorbed MLA's share of its roofline in the decode step of a q-LoRA
model: the least time for what each call of `models.decode._mla_attn_bl`
needs over the device time of the operations launched inside it.

mla_attn.roofline's count with the q-LoRA bottleneck (wq_a, then wq_b) in
place of a plain wq (portbench.counts_ep.mla_work): the q and kv_a
projections, wkv_b absorbed into q and into the output, the scores and
context over the latent cache's S rows (all heads); bytes the weights
(bf16), the cache's S rows of r + dr read and the step's row written, the
normed input in and the output out."""

from portbench import counts_ep

MOVES = "captions_per_s"


def _shape(cfg, lw, hn, latent, row, span, *a, **kw):
    return {"B": hn.shape[1], "S": span}


SPANS = {"mla_qlora": [("dmi_tpu_torch.models.decode", "_mla_attn_bl", _shape)]}


def read(t):
    calls, secs = t.calls.get("mla_qlora"), t.span_seconds("mla_qlora")
    if not calls or secs <= 0:
        return None
    c = t.ctx["config"]
    return 100.0 * sum(counts_ep.least_seconds(*counts_ep.mla_work(c, x["B"], x["S"]))
                       for x in calls) / secs
