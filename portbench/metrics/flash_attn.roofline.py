"""Training attention's share of its roofline: the least time for the
causal attention's forward and backward over the device time of the
operations launched inside the flash kernels' entry points
(`ops.cuda.flash_attn._fwd_kernel`, and for the backward `_delta`,
`_bwd_dkv_kernel` and `_bwd_dq_kernel`).

Forward: q, k, v read and the output and its row statistics (f32)
written; 4 hd operations per causal pair and head.  Backward: q, k, v, the
output, its gradient and the row statistics read, dq, dk, dv written; the
scores recomputed (P is not kept) and dV, dP, dQ, dK: 10 hd operations per
pair and head.  No key mask (the stage-1 loss runs causal attention over
every position)."""

from portbench import counts

MOVES = "train_samples_per_s"


def _shape(q, k, *a, **kw):
    B, nh, T, hd = q.shape
    return {"B": B, "nh": nh, "T": T, "hd": hd, "nkv": k.shape[1]}


SPANS = {"flash.fwd": [("dmi_tpu_torch.ops.cuda.flash_attn", "_fwd_kernel", _shape)],
         "flash.bwd": [("dmi_tpu_torch.ops.cuda.flash_attn", "_bwd_dkv_kernel", _shape),
                       ("dmi_tpu_torch.ops.cuda.flash_attn", "_bwd_dq_kernel", None),
                       ("dmi_tpu_torch.ops.cuda.flash_attn", "_delta", None)]}


def work(x: dict, backward: bool) -> tuple:
    B, nh, T, hd, nkv = x["B"], x["nh"], x["T"], x["hd"], x["nkv"]
    pairs = T * (T + 1) / 2
    q, kv, stats = 2.0 * B * nh * T * hd, 2.0 * B * nkv * T * hd, 4.0 * B * nh * T
    if backward:
        return 10.0 * B * nh * pairs * hd, 4 * q + 4 * kv + stats
    return 4.0 * B * nh * pairs * hd, 2 * q + 2 * kv + stats


def read(t):
    fwd, bwd = t.calls.get("flash.fwd"), t.calls.get("flash.bwd")
    secs = t.span_seconds("flash.fwd", "flash.bwd")
    if not fwd or secs <= 0:
        return None
    bound = sum(counts.least_seconds(*work(x, False)) for x in fwd)
    bound += sum(counts.least_seconds(*work(x, True)) for x in bwd or [])
    return 100.0 * bound / secs
