"""On the card: one short run of each cell comes out correct, with the
contract's device fields.  Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.chip
@pytest.mark.parametrize("name", tiny.cells())
def test_short_run_is_correct(name, cuda_device):
    proc = subprocess.run(
        [sys.executable, str(harness.PB / "run.py"), "--workload", name,
         "--seed", "3141592653", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
