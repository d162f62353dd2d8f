"""Captioning traffic on a deepseek_v3 configuration: caption.py's closed
loop of one client (the same requests, calls, set-up and window), with
`correct` decided against the DeepSeek-V3 reference
(portbench/reference/deepseek_v3.py) in place of decoder.py's.

caption.py is loaded as a module of its own here and given this file's
gap_numbers, so caption.py itself is left as it is.  The reference runs
over the sampled requests in chunks of CHUNK rows, so that its f32 logits
over the 129280-row vocabulary fit beside the drawn weights.

The control of the cell's limits is the reference itself with int8
weights (gap_numbers' control; serve_readings, run by
portbench/control_v3.py).  The system's own int8 path, the control of the
other caption cells, would hold the drawn weights (38.8 GB), their fused
copies (14.3 GB) and the int8 tree (19.4 GB) at once, with the f32
temporaries of quantizing the 129280 x 7168 head on top.
"""

from __future__ import annotations

import numpy as np

from portbench import harness as hx

caption = hx.load_module(hx.PKG / "traffic" / "caption.py", "portbench_traffic_caption_for_v3")
CHUNK = 128  # reference rows at a time: [128, 22, 129280] f32 logits, 1.46 GB


def gap_numbers(w: dict, params: dict, pp: dict, seed: int, served: list, device,
                weight_fn=None, control: bool = False) -> dict:
    """caption.gap_numbers' numbers (the served tokens' gaps below the
    reference's best logit over a sample of the served requests drawn from
    the seed, the window's last request always in it) from the DeepSeek-V3
    reference.

    control: the gaps, under the same reference, of the tokens that the
    reference computed with int8 weights (decoder.int8_weights, the
    nearest precision below the configuration's bf16) chooses at each
    position of the same sequences: the control of the cell's limits."""
    import torch

    from portbench.reference.decoder import int8_weights
    from portbench.reference.deepseek_v3 import Decoder
    from portbench.reference.projector import soft_token

    t = w["traffic_json"]
    B = t["batch"]
    total = len(served) * B
    picks = np.random.default_rng([seed, 3]).choice(total, size=min(t["check_requests"], total),
                                                    replace=False)
    picks[0] = total - 1
    ref = Decoder(w["config_json"], params, weight_fn)
    low = Decoder(w["config_json"], params, int8_weights) if control else None
    prefix = torch.tensor(caption.prefix_ids(w, seed), device=device)
    calls = {}
    for p in picks:
        i = served[p // B][0]
        if i not in calls:
            calls[i] = caption.embeddings(w, seed, i)
    embs = np.stack([calls[served[p // B][0]][p % B] for p in picks])
    ids = torch.stack([served[p // B][1][p % B] for p in picks]).to(device)
    gap_sum, widest, near, n = 0.0, 0.0, 0, 0
    for s in range(0, len(picks), CHUNK):
        rows = ids[s:s + CHUNK]
        soft = soft_token(pp, torch.as_tensor(embs[s:s + CHUNK], device=device))
        x = torch.cat([soft[:, None], ref.embed(prefix).expand(len(rows), -1, -1),
                       ref.embed(rows[:, :-1])], dim=1)
        logits = ref.logits(x, first=len(prefix))  # the positions that chose each served token
        chosen = rows if low is None else low.logits(x, first=len(prefix)).argmax(-1)
        top2 = logits.topk(2, dim=-1).values
        gap = top2[..., 0] - logits.gather(-1, chosen[..., None])[..., 0]
        del logits
        gap_sum += float(gap.sum())
        widest = max(widest, float(gap.max()))
        near += int((top2[..., 0] - top2[..., 1] < caption.NEAR_TIE).sum())
        n += gap.numel()
    return {"gap_per_near_tie": gap_sum / max(near, 1), "logit_gap": widest,
            "mean_logit_gap": gap_sum / n, "near_ties": near}


caption.gap_numbers = gap_numbers
run = caption.run


def serve_readings(w: dict, seed: int, control: bool, calls: int, device="cuda") -> dict:
    """The numbers the cell compares for the system as it serves `calls`
    calls of the cell's batch after one warm-up call, and (with `control`)
    the control's on the same sequences (gap_numbers' control)."""
    _, params, _, pp, cap = caption.build(w, seed, device)
    cap.caption_ids(caption.embeddings(w, seed, caption.WARMUP))
    served = [(i, caption.call(w, cap, caption.embeddings(w, seed, i))[0]) for i in range(calls)]
    del cap
    hx.free(device)
    out = {"program": gap_numbers(w, params, pp, seed, served, device)}
    if control:
        out["control"] = gap_numbers(w, params, pp, seed, served, device, control=True)
    return out
