"""The readings that the limits of `correct` are set from, on the chip at a
cell's own sizes (the benchmark's runs never run this):

    python3 -m portbench.control --workload <cell> --seeds <n> ... [--control-seeds <n> ...]

For each seed, one JSON line: the system's readings (the numbers the cell
compares) and, for the control seeds, the control's: in a serving cell the
system with its own int8 weight path switched on (Captioner(int8=True)),
the nearest precision below the bf16 the configuration states; in a
training cell the plain reference with every matrix rounded to int8 put in
the system's place, and the faults a training cell can have (half of each
batch left out, the mean taken over the rest; a step that leaves the
projector unchanged, which reads 1 by construction).  Serving seeds run
`calls` calls of the cell's batch; training seeds run the cell's check
steps.  Set-up is paid once a seed (new weights)."""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness as hx


def serve_readings(w: dict, seed: int, control: bool, calls: int, device="cuda") -> dict:
    caption = hx.driver("caption")
    _, params, _, pp, cap = caption.build(w, seed, device)
    out = {}
    for label, kw in (("program", {}), ("control", {"int8": True}))[:2 if control else 1]:
        if kw:
            _, _, _, pp, cap = caption.build(w, seed, device, params=params, **kw)
        cap.caption_ids(caption.embeddings(w, seed, caption.WARMUP))
        served = [(i, caption.call(w, cap, caption.embeddings(w, seed, i))[0])
                  for i in range(calls)]
        del cap
        hx.free(device)
        out[label] = caption.gap_numbers(w, params, pp, seed, served, device)
    return out


def train_readings(w: dict, seed: int, control: bool, device="cuda") -> dict:
    from portbench.reference.decoder import int8_weights

    stage1 = hx.driver("stage1")
    _, params, pp0, data, trainer = stage1.build(w, seed, device)
    prog = stage1.check_steps(w, trainer, data)
    del trainer
    hx.free(device)
    ref = stage1.reference_steps(w, seed, params, pp0, data, device)
    p0 = stage1.leaves(pp0)
    out = {"program": stage1.gaps(prog, ref, p0)}
    if control:
        low = stage1.reference_steps(w, seed, params, pp0, data, device, int8_weights)
        out["control"] = stage1.gaps(low, ref, p0)
        half = stage1.reference_steps(w, seed, params, pp0, HalfBatch(data), device)
        out["faults"] = {"half_batch": stage1.gaps(half, ref, p0),
                         "state_unchanged": stage1.gaps(
                             {**prog, "after": [x.detach().clone() for x in p0]}, ref, p0)}
    return out


class HalfBatch:
    """The cell's data with every batch cut to its first half: the loss is
    the mean over the rows that are left."""

    def __init__(self, data):
        self.data, self.B = data, data.B // 2

    def train_batch(self, step):
        b = self.data.train_batch(step)
        return {k: v[: self.B] for k, v in b.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=3)
    a = ap.parse_args(argv)
    w = hx.cell(a.workload)
    kind = w["traffic_json"]["kind"]
    for seed in a.seeds:
        control = seed in a.control_seeds
        if kind == "caption":
            r = serve_readings(w, seed, control, a.calls)
        else:
            r = train_readings(w, seed, control)
        print(json.dumps({"workload": a.workload, "seed": seed, **r}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
