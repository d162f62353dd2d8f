"""The control of each cell, on the card at the cell's own sizes: the
nearest precision below the configuration's bf16 (the system's int8 weight
path in a serving cell; the reference with int8 weights in a training
cell) must come out not correct under the cell's limits, where the system
itself comes out correct.  Needs the card: skips without one.

    python3 -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import pytest

from portbench import control, harness as hx

CELLS = ["olmoe-caption-b512", "olmoe-stage1-b32", "v2lite-caption-b1024"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_system_passes(card, name):
    w = hx.cell(name)
    seed = 2**31 + 11
    if w["traffic_json"]["kind"] == "caption":
        r = control.serve_readings(w, seed, True, calls=1)
    else:
        r = control.train_readings(w, seed, True)
    assert hx.judge(r["program"], w["limits"])[0], r
    assert not hx.judge(r["control"], w["limits"])[0], r
