"""A run's last line of standard output is the contract's result, with
`checks` last and each check also on standard error; a run without a
card fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

RUN = [sys.executable, str(harness.PB / "run.py")]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", tiny.cells())
def test_last_line(name, trace, capsys):
    ctx = tiny.context(name, trace=bool(trace))
    outcome = harness.drive(ctx)
    assert harness.finish(ctx, outcome, harness.benchmark()) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True, line
    assert {"kind", "count", "memory_peak_bytes"} <= set(line["device"])
    bench = harness.benchmark()
    want = {m["name"] for m in harness.cell_metrics(
        bench, name, "per_layer" if trace else "end_to_end")}
    if trace:   # device metrics have nothing to read on the CPU
        assert set(line["metrics"]) <= want
        assert "breakdown" in line
    else:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name_, text in zip(line["checks"], tail):
        assert text.startswith(f"check {name_} ")


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return env


def test_run_without_card_fails():
    proc = subprocess.run(
        RUN + ["--workload", tiny.cells()[0], "--seed", "5000000000",
               "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=_no_card_env(), timeout=300,
        cwd=harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", tiny.cells()[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=_no_card_env(), timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
