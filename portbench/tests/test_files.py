"""Every file BENCHMARK.json names loads, and the entries keep the
contract's shape: each cell reports setup_s, another end-to-end metric
and a per-layer one, and every cell that reports a per-layer metric
reports the end-to-end metric it moves."""

import json
import re

import pytest

from portbench import harness
from portbench.arith import model

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert NAME.match(conf["name"])
    data = harness.load_json(harness.ROOT / conf["file"])
    assert data["name"] == conf["name"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    t = data["transformer"]
    # the published widths, as run
    assert data["hidden_size"] == t["d_model"] == 4096
    assert data["intermediate_size"] == t["d_ff"] == 14336
    assert data["num_attention_heads"] == t["n_heads"] == 32
    assert data["num_key_value_heads"] == t["n_kv_heads"] == 8
    assert data["vocab_size"] == t["vocab_size"]
    assert data["num_hidden_layers"] == t["n_layers"]
    assert t["d_model"] // t["n_heads"] == data["head_dim"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file(w):
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    cell = harness.load_cell(w["name"])
    assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
    assert cell["traffic"] == w["traffic"] and cell["why"] == w["why"]
    assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert (harness.PB / "traffic" / f"{cell['kind']}.py").exists()
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, w["name"],
                                                     "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, w["name"], "per_layer")


def test_train_flops_in_cell_files():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        if cell["kind"] != "train":
            continue
        t = cell["config_file"]["transformer"]
        want = model.train_flops_per_token(
            t, cell["seq_len"], weight_grads=not cell.get("lora"))
        assert cell["model_flops_per_token"] == pytest.approx(want)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    reader = harness.load_module(harness.PB / "metrics" / f"{m['name']}.py")
    assert callable(reader.read)
    assert reader.read({}) is None      # nothing to read: nothing returned


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(m):
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert m["moves"] in [x["name"] for x in harness.cell_metrics(
            BENCH, cell, "end_to_end")]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
