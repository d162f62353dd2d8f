"""Captioning traffic: a closed loop of one client.  Each call hands one
batch of distinct requests to `serve.Captioner.caption_ids` and waits for
their ids on the host; the next call starts when it returns.

A request is an encoder embedding (normal, from the seed and the call's
index) projected to one soft token by a 2-layer f32 projector, prepended to
a prefix of token ids shared by every request (from the seed), and decoded
greedily for `max_new_tokens` tokens with EOS off, so every request decodes
the whole budget.  A request's latency runs from the moment its batch is
handed to caption_ids to the moment its ids are on the host.

`correct`: once the window has closed and the system's state is freed, a
sample of the finished requests drawn from the seed is run through the
plain f32 reference (portbench/reference) over the prompt and the served
tokens; the numbers are the gaps by which the served tokens' logits lie
below the reference's best at their positions (gap_numbers), and the
cell's limits file names those compared.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import harness as hx

WARMUP = 1 << 40  # the call index of the warm-up's requests, which no window call has
NEAR_TIE = 0.05  # logits: a reference top-2 margin under this counts as a near tie


def prefix_ids(w: dict, seed: int) -> list:
    c, t = w["config_json"], w["traffic_json"]
    return np.random.default_rng([seed, 1]).integers(0, c["vocab_size"], t["prefix_len"]).tolist()


def embeddings(w: dict, seed: int, call: int) -> np.ndarray:
    t = w["traffic_json"]
    rng = np.random.default_rng([seed, 2, call])  # the warm-up's call is WARMUP
    return rng.standard_normal((t["batch"], t["mm_dim"]), dtype=np.float32)


def build(w: dict, seed: int, device, params=None, **captioner_kw):
    """(config, weights, projector spec and parameters, Captioner)."""
    from dmi_tpu_torch.models import projector as proj
    from dmi_tpu_torch.serve import Captioner

    c, t = w["config_json"], w["traffic_json"]
    cfg = hx.port_config(c)
    if params is None:
        params = hx.draw_weights(cfg, seed, device)
    spec = proj.ProjectorSpec(mm_dim=t["mm_dim"], lm_dim=cfg.hidden_size,
                              n_layers=t["projector_layers"])
    pp = hx.draw_projector(spec.layer_dims(), seed, device)
    pad = c.get("pad_token_id", c.get("eos_token_id"))
    cap = Captioner(cfg, params, spec, pp, max_new_tokens=t["max_new_tokens"],
                    batch_size=t["batch"], prefix_ids=prefix_ids(w, seed), pad_token_id=pad,
                    **captioner_kw)
    return cfg, params, spec, pp, cap


def call(w: dict, cap, embs: np.ndarray):
    """One request batch through the system -> (ids [batch, max_new] on the
    host, seconds from hand-off to ids on the host)."""
    t0 = time.perf_counter()
    ids = cap.caption_ids(embs, engine=w["traffic_json"]["engine"])
    return ids, time.perf_counter() - t0


def gap_numbers(w: dict, params: dict, pp: dict, seed: int, served: list, device,
                weight_fn=None) -> dict:
    """Over a sample of the served requests drawn from the seed (the window's
    last request always in it), the gap by which each served token's
    reference logit lies below the reference's best logit at its position.

    `gap_per_near_tie`, the number compared: the gaps' sum over the count
    of positions whose reference top-2 margin is under NEAR_TIE.  A
    computation whose logits are off by e flips a position whose margin m
    is under about e, at a cost of m, so the gaps' sum grows as e squared
    times the density of near ties, which depends on the random weights
    (seeds differ by four times); the count divides that density out.  The
    widest gap (`logit_gap`) and the mean gap (`mean_logit_gap`) follow e
    and e squared without that correction; they are printed, not compared
    (PERF.md gives their readings).  served: [(call index, ids [batch,
    max_new])] of every call whose requests finished."""
    import torch

    from portbench.reference.decoder import Decoder
    from portbench.reference.projector import soft_token

    t = w["traffic_json"]
    total = len(served) * t["batch"]
    picks = np.random.default_rng([seed, 3]).choice(total, size=min(t["check_requests"], total),
                                                    replace=False)
    picks[0] = total - 1
    ref = Decoder(w["config_json"], params, weight_fn)
    prefix = torch.tensor(prefix_ids(w, seed), device=device)
    embs = np.stack([embeddings(w, seed, served[p // t["batch"]][0])[p % t["batch"]]
                     for p in picks])
    ids = torch.stack([served[p // t["batch"]][1][p % t["batch"]] for p in picks]).to(device)
    soft = soft_token(pp, torch.as_tensor(embs, device=device))
    x = torch.cat([soft[:, None], ref.embed(prefix).expand(len(picks), -1, -1),
                   ref.embed(ids[:, :-1])], dim=1)
    logits = ref.logits(x, first=len(prefix))  # the positions that chose each served token
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - logits.gather(-1, ids[..., None])[..., 0]
    near = int((top2[..., 0] - top2[..., 1] < NEAR_TIE).sum())
    return {"gap_per_near_tie": float(gap.sum()) / max(near, 1), "logit_gap": float(gap.max()),
            "mean_logit_gap": float(gap.mean()), "near_ties": near}


def run(w: dict, seed: int, seconds: float, trace: bool, device, t_start: float, chips: int):
    import torch

    t = w["traffic_json"]
    t_built = time.perf_counter()
    cfg, params, spec, pp, cap = build(w, seed, device)
    t_warm = time.perf_counter()
    cap.caption_ids(embeddings(w, seed, WARMUP), engine=t["engine"])  # warm-up: the same shapes
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"set-up: imports {t_built - t_start:.3f} s, weights and Captioner "
          f"{t_warm - t_built:.3f} s, warm-up call {setup_s - (t_warm - t_start):.3f} s",
          file=sys.stderr)

    served, lat = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = len(served)
        ids, dt = call(w, cap, embeddings(w, seed, i))
        served.append((i, ids))
        lat.append(dt)
    window = time.perf_counter() - t0
    print(f"calls {len(lat)}, seconds each {[round(x, 4) for x in lat]}", file=sys.stderr)
    if not trace:
        metrics = {"captions_per_s": {"value": len(served) * t["batch"] / window,
                                      "unit": "captions/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        breakdown = None
    else:
        k, n = t["trace_calls"], len(served)

        def traced_calls():
            for i in range(n, n + k):
                served.append((i, call(w, cap, embeddings(w, seed, i))[0]))
            return {"captions": k * t["batch"], "units": k}

        events, calls, traced_s, work = hx.traced(traced_calls, hx.span_specs(w["per_layer"]),
                                                  device)
        tr = hx.Trace(events, calls, traced_s, work,
                      {"config": w["config_json"], "traffic": t, "timed_s": window,
                       "timed_units": n, "call_seconds": lat})
        del events
        metrics = hx.per_layer_metrics(w, tr)
        breakdown = tr.breakdown()
    attempted = len(served) * t["batch"]
    finished = sum(int(((ids >= 0) & (ids < cfg.vocab_size)).all(-1).sum()) for _, ids in served)
    info = hx.device_info(device, chips)
    if trace:
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    del cap
    hx.free(device)
    correct, checks = hx.judge(gap_numbers(w, params, pp, seed, served, device), w["limits"])
    result = {"correct": correct and finished == attempted, "attempted": attempted,
              "failed": attempted - finished, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks
