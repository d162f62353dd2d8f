"""BENCHMARK.json against the contract's shape, and every cell's files:
each workload names a configuration file, a traffic mix and its driver,
and a file of limits that exist; each per-layer metric has a reader that
names the end-to-end metric it moves."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness as hx

BENCH = json.loads((hx.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((hx.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= KEYS[section] and NAME.match(e["name"]), e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    c = json.loads((hx.PKG / "configs" / f"{w['config']}.json").read_text())
    entry = next(e for e in BENCH["configs"] if e["name"] == w["config"])
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert sorted(c["reduced"]) == sorted(entry["reduced"]) and c["source"] == entry["source"]
    t = json.loads((hx.PKG / "traffic" / f"{w['traffic']}.json").read_text())
    assert (hx.PKG / "traffic" / f"{t['kind']}.py").is_file()
    assert w["chips"] == 1
    limits = hx.cell(w["name"])["limits"]
    assert limits and all(v["limit"] > 0 for v in limits.values())


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader(m):
    r = hx.reader(m["name"])
    assert r.MOVES == m["moves"] and callable(r.read)
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", m["workloads"]))


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for e in BENCH["end_to_end"]:
        assert set(e.get("workloads", cells)) <= cells
        assert 0.01 <= e["bound"] <= 0.25
    for w in cells:
        reported = [e for e in BENCH["end_to_end"] if w in e.get("workloads", [w])]
        assert "setup_s" in [e["name"] for e in reported] and len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_catalog_numbers_kept():
    """DeepSeek-V2-Lite's file holds the catalog's numbers, but for the keys
    in `reduced`."""
    c = json.loads((hx.PKG / "configs" / "deepseek-v2-lite-26.json").read_text())
    published = {"hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
                 "max_position_embeddings": 163840, "moe_intermediate_size": 1408,
                 "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64, "n_shared_experts": 2,
                 "num_attention_heads": 16, "num_experts_per_tok": 6, "num_key_value_heads": 16,
                 "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
                 "rope_theta": 10000, "routed_scaling_factor": 1, "topk_group": 1,
                 "v_head_dim": 128, "vocab_size": 102400, "first_k_dense_replace": 1,
                 "num_hidden_layers": 27}
    for k, v in published.items():
        assert c[k] == v or k in c["reduced"], k
    assert c["rope_scaling"]["factor"] == 40 and c["rope_scaling"]["type"] == "yarn"
