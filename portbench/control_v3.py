"""The readings that the limit of `correct` in a deepseek_v3 caption cell is
set from, on the chip at the cell's own sizes (the benchmark's runs never
run this):

    python3 -m portbench.control_v3 --workload v3-caption-b2048 --seeds <n> ...
        [--control-seeds <n> ...] [--calls 1]

For each seed, one JSON line: the system's readings (the numbers the cell
compares, portbench/traffic/caption_v3.py) and, for the control seeds, the
control's: the reference with int8 weights choosing the tokens of the same
sequences.  Set-up is paid once a seed (new weights)."""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness as hx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=1)
    a = ap.parse_args(argv)
    w = hx.cell(a.workload)
    drv = hx.driver(w["traffic_json"]["kind"])
    for seed in a.seeds:
        r = drv.serve_readings(w, seed, seed in a.control_seeds, a.calls)
        print(json.dumps({"workload": a.workload, "seed": seed, **r}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
