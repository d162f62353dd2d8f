"""The rest of a run, on the CPU at tiny sizes with the cell's own limits:
`correct` holds on the unbroken path and comes out false with the timed
path broken underneath, once for each fault the cell can have: a served
token altered where it is produced; a training step that leaves the state
unchanged; half of each batch left out, the mean taken over the rest.
(One card: no exchange between chips to leave out.)"""

import time

import pytest
import torch

from portbench import harness as hx
from portbench.tests.tiny import tiny_cell


def run(name: str, trace: bool = False):
    w = tiny_cell(name)
    return hx.driver(w["traffic_json"]["kind"]).run(w, 2**33 + 17, 0.5, trace, "cpu",
                                                    time.perf_counter(), 1)


@pytest.mark.parametrize("name", ["olmoe-caption-b512", "v2lite-caption-b1024",
                                  "olmoe-stage1-b32"])
@pytest.mark.parametrize("trace", [False, True])
def test_unbroken_is_correct(name, trace):
    result, checks = run(name, trace)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(checks) == list(hx.cell(name)["limits"])


@pytest.mark.parametrize("name", ["olmoe-caption-b512", "v2lite-caption-b1024"])
def test_altered_token_is_caught(name, monkeypatch):
    from dmi_tpu_torch.models import decode

    real = decode.head_ids

    def altered(head_w, out, plain=False):
        ids = real(head_w, out, plain).clone()
        ids[-1] = (ids[-1] + head_w["embed"].shape[0] // 2) % head_w["embed"].shape[0]
        return ids

    monkeypatch.setattr(decode, "head_ids", altered)
    result, checks = run(name)
    assert not result["correct"], checks


def test_unchanged_state_is_caught(monkeypatch):
    from dmi_tpu_torch.training import projector_trainer

    monkeypatch.setattr(projector_trainer, "clip_and_step", lambda opt, norm: None)
    result, checks = run("olmoe-stage1-b32")
    assert not result["correct"], checks


def test_half_batch_is_caught(monkeypatch):
    from dmi_tpu_torch.models import mmmodel
    from dmi_tpu_torch.training import projector_trainer

    real = mmmodel.caption_loss

    def half(cfg, params, soft, ids, mask, labels, **kw):
        n = soft.shape[0] // 2
        return real(cfg, params, soft[:n], ids[:n], mask[:n], labels[:n], **kw)

    monkeypatch.setattr(projector_trainer.mmmodel, "caption_loss", half)
    result, checks = run("olmoe-stage1-b32")
    assert not result["correct"], checks
