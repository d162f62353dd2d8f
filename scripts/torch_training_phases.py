"""Micro-steps/s of dmi_tpu_torch's training stages on the card: chip_smoke.py's
stage-1, stage-2 and stage-3 phases (Llama-3.2-1B at full width, the
configs' shapes; each prints its micro-steps/s, and stage 2 the card's time
of one 768 x 768 random_orthogonal), run from the root of the tree to time.

    python scripts/torch_training_phases.py LABEL

To hold two commits against each other on one card, unpack the other one
with `git archive` under the gitignored _archive/ and run the trees in
turns in one call (other, this, this, other), from each tree's root:

    (cd _archive/other && python ../../scripts/torch_training_phases.py 1-other)
    python scripts/torch_training_phases.py 2-this
"""

import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())  # the tree being timed
import chip_smoke as cs  # noqa: E402
from dmi_tpu_torch.models import llama  # noqa: E402
from dmi_tpu_torch.ops.cuda import _build  # noqa: E402


def main(label: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.lib()
    print(f"[{label}] kernels ready in {time.perf_counter() - t0!r} s")
    cfg = dataclasses.replace(llama.llama32_1b(), eos_token_ids=())
    params = llama.fuse_projections(
        llama.init(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev))
    cs.train_phase(torch, dev, cfg, params)
    _, hn_params, _ = cs.hypernet_phase(torch, dev, cfg, params)
    cs.fewshot_phase(torch, dev, cfg, params, hn_params)
    print(f"[{label}] {cs.nvidia_smi()}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "this")
