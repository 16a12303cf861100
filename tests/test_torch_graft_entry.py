"""The port's twin of the root `__graft_entry__.py`
(`cloudtik_tpu_torch/graft_entry.py`): the reference's mesh factoring,
and the multi-rank dry run's three passes over gloo CPU ranks."""

import pytest

import __graft_entry__ as reference
from cloudtik_tpu_torch import graft_entry


@pytest.mark.parametrize("n", range(1, 17))
def test_pick_mesh_is_the_references(n):
    got = graft_entry._pick_mesh(n)
    want = reference._pick_mesh(n)
    for axis in ("data", "fsdp", "pipe", "expert", "seq", "tensor",
                 "num_slices"):
        assert getattr(got, axis) == getattr(want, axis), axis


def test_dryrun_multichip_runs_its_three_passes(capsys):
    graft_entry.dryrun_multichip(4, timeout_s=240)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" OK")[0] for ln in lines] == [
        "dryrun_multichip(4)", "dryrun_multichip(4) pipeline",
        "dryrun_multichip(4) pipe4/1f1b"]
    assert "mesh={'fsdp': 2, 'tensor': 2}" in lines[0]
    assert "mesh={'fsdp': 2, 'pipe': 2}" in lines[1]
    assert "mesh={'pipe': 4}" in lines[2]


def test_entry_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
