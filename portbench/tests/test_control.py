"""The control comes out not correct: the reference put in the program's
place a precision lower (float8 e4m3 operands), read by control.py as the
chip reads it, at a tiny size on the CPU against the tiny size's limits
(tests/tiny.py)."""

import pytest

from portbench import control
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.cells("train"))
def test_train_control_fails_a_number(name):
    ctx = tiny.context(name)
    out = control.train_readings(ctx, [11], [11], faults=False)
    limits = ctx.cell["limits"]
    prog, ctl = out["program"][0], out["control"][0]
    assert all(prog[k] < limits[k.split(".")[0]] for k in prog
               if k != "seed")
    assert any(ctl[k] > limits[k.split(".")[0]] for k in ctl
               if k != "seed"), ctl


@pytest.mark.parametrize("name", tiny.cells("serve"))
def test_serve_control_fails(name):
    ctx = tiny.context(name)
    out = control.serve_readings(ctx, [11, 13], [11, 13])
    limit = ctx.cell["limits"]["widest_gap"]
    assert all(r["widest_gap"] < limit for r in out["program"])
    assert max(r["widest_gap"] for r in out["control"]) > limit, out
