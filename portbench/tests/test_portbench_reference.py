"""The plain reference against dmi_tpu_torch at tiny OLMoE and DeepSeek-V2
sizes, in f32 on the CPU: logits of a causal forward, and one stage-1
step's projector gradients."""

import numpy as np
import pytest
import torch

from portbench import harness as hx
from portbench.reference.decoder import Decoder, int8_weights
from portbench.tests.tiny import tiny_cell

CELLS = {"olmoe": "olmoe-caption-b512", "deepseek_v2": "v2lite-caption-b1024"}


def f32_model(family: str, seed: int = 5):
    from dmi_tpu_torch.models import llama

    w = tiny_cell(CELLS[family])
    cfg = hx.port_config(w["config_json"], torch.float32)
    params = hx.draw_weights(cfg, seed, "cpu")
    return w, cfg, params, llama


@pytest.mark.parametrize("family", sorted(CELLS))
def test_logits_match_the_port(family):
    w, cfg, params, llama = f32_model(family)
    x = torch.randn(3, 11, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    want = llama.forward(cfg, params, x)
    got = Decoder(w["config_json"], params).logits(x)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("family", sorted(CELLS))
def test_int8_weights_move_the_logits(family):
    w, cfg, params, _ = f32_model(family)
    x = torch.randn(2, 7, cfg.hidden_size, generator=torch.Generator().manual_seed(2))
    exact = Decoder(w["config_json"], params).logits(x)
    low = Decoder(w["config_json"], params, int8_weights).logits(x)
    assert 0 < (low - exact).abs().max() < 0.1 * exact.abs().max()


def test_stage1_step_matches_the_port():
    from portbench.traffic import stage1

    w = tiny_cell("olmoe-stage1-b32")
    _, params, pp0, data, trainer = stage1.build(w, 9, "cpu")
    prog = stage1.check_steps(w, trainer, data)
    ref = stage1.reference_steps(w, 9, params, pp0, data, "cpu")
    g = stage1.gaps(prog, ref, stage1.leaves(pp0))
    # a bf16 LLM against the f32 reference: rounding of a few 1e-3
    assert g["loss_gap"] < 1e-3 and g["grad_gap"] < 2e-2 and g["change_gap"] < 2e-2, g
    assert all(np.isfinite(v) for v in g.values())
