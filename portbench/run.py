"""Run one cell of BENCHMARK.json on this machine's cards and print one
JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the nvcc build of the
system's kernels on a checkout's first run, weights drawn on the card from
the seed, one warm-up call of the cell's shapes) is timed as setup_s; then
the cell's traffic runs for --seconds (--trace 0: the end-to-end metrics)
or a few calls run untraced and then under torch.profiler (--trace 1: the
per-layer metrics, the device's busy seconds and the breakdown); then the
system's outputs are compared with the plain reference.  The last line on
standard output is the result; the numbers compared, each beside its
limit, are the last lines on standard error.  Without the cards the cell
asks for, or with JAX or the JAX package loaded at the end, it exits with
a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")  # a library that would load JAX by itself must not


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import harness as hx

    w = hx.cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{a.workload} needs {w['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = hx.driver(w["traffic_json"]["kind"]).run(
        w, a.seed, a.seconds, bool(a.trace), "cuda", T_START, w["chips"])
    found = hx.forbidden_modules()
    if found:
        print(f"loaded in this process: {found} (JAX or the JAX package)", file=sys.stderr)
        return 3
    hx.report(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
