"""The port's tik-run: one process per card on every host.

`cloudtik_tpu_torch.launch.distributor` keeps the reference's host parsing
and host-level env and adds `nproc_per_node` with each process's
`LOCAL_RANK`/`LOCAL_WORLD_SIZE`; `distributed.auto_initialize` maps them to
host-major ranks.  `cloudtik_tpu_torch.launch.run` starts the ranks on one
host, or this launcher on every host over ssh.  The spawn in this file
runs the DLRM recipe as two gloo ranks through `python -m
cloudtik_tpu_torch.launch.run --nproc-per-node 2`, against one process;
the failing-rank check runs two bare interpreters.
"""

import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from cloudtik_tpu.launch import distributor as JD
from cloudtik_tpu_torch.launch import distributor as TD
from cloudtik_tpu_torch.launch import run as TR
from cloudtik_tpu_torch.parallel import distributed
from cloudtik_tpu_torch.parallel.launch import free_port

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------- the reference's Distributor --

class TestDistributor:
    """tests/test_launch.py's cases, on the port's Distributor."""

    def test_slots_syntax_and_comma_lists(self):
        d = TD.Distributor(hosts=["10.0.0.1:4,10.0.0.2", "10.0.0.3:2"])
        assert [h.address for h in d.hosts] == \
            ["10.0.0.1", "10.0.0.2", "10.0.0.3"]
        assert [h.slots for h in d.hosts] == [4, 1, 2]
        assert d.num_processes == 3
        assert d.coordinator_address == "10.0.0.1:8476"

    def test_hostfile_with_comments(self, tmp_path):
        hostfile = tmp_path / "hosts"
        hostfile.write_text("# slice hosts\n10.0.0.1\n\n10.0.0.2:8\n")
        d = TD.Distributor(hostfile=str(hostfile))
        assert [h.address for h in d.hosts] == ["10.0.0.1", "10.0.0.2"]
        assert d.hosts[1].slots == 8

    def test_num_nodes_truncates_and_validates(self):
        d = TD.Distributor(hosts=["a", "b", "c"], num_nodes=2)
        assert d.num_processes == 2
        with pytest.raises(ValueError, match="available hosts"):
            TD.Distributor(hosts=["a"], num_nodes=3)

    def test_defaults_to_localhost(self):
        d = TD.Distributor()
        assert d.num_processes == 1 and not d.distributed()
        # no CUDA here: one process a host
        assert d.nproc_per_node == 1

    def test_env_for_process(self):
        d = TD.Distributor(hosts=["h0", "h1"], coordinator_port=9000)
        env = d.env_for(1)
        assert env == {"TIK_COORDINATOR_ADDRESS": "h0:9000",
                       "TIK_NUM_PROCESSES": "2",
                       "TIK_PROCESS_ID": "1"}

    def test_env_for_exports_slice_topology(self):
        d = TD.Distributor(hosts=["h0", "h1", "h2", "h3"], num_slices=2)
        envs = [d.env_for(i) for i in range(4)]
        assert [e["TIK_SLICE_INDEX"] for e in envs] == \
            ["0", "0", "1", "1"]
        assert all(e["TIK_NUM_SLICES"] == "2" for e in envs)
        assert envs[3]["TIK_PROCESS_ID"] == "3"

    def test_no_slices_keeps_env_unchanged(self):
        d = TD.Distributor(hosts=["h0", "h1"])
        assert "TIK_SLICE_INDEX" not in d.env_for(0)

    def test_indivisible_slice_count_refuses(self):
        with pytest.raises(ValueError, match="evenly divide"):
            TD.Distributor(hosts=["a", "b", "c"], num_slices=2)


@pytest.mark.parametrize("kw", [
    {}, {"hosts": ["h0", "h1"], "coordinator_port": 9000},
    {"hosts": ["a:8", "b:8", "c:8", "d:8"], "num_slices": 2},
    {"hosts": ["a", "b", "c"], "num_nodes": 2, "num_slices": 1}])
def test_host_env_is_the_references(kw):
    port = TD.Distributor(nproc_per_node=4, **kw)
    ref = JD.Distributor(**kw)
    assert port.num_processes == ref.num_processes
    assert port.coordinator_address == ref.coordinator_address
    for host in range(ref.num_processes):
        assert port.env_for(host) == ref.env_for(host)
        local = port.env_for(host, 3)
        assert {k: local.pop(k) for k in ("LOCAL_RANK",
                                          "LOCAL_WORLD_SIZE")} == {
            "LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4"}
        assert local == ref.env_for(host)


def test_nproc_per_node_is_checked():
    with pytest.raises(ValueError, match="nproc_per_node"):
        TD.Distributor(nproc_per_node=0)
    with pytest.raises(ValueError, match="local rank"):
        TD.Distributor(nproc_per_node=2).env_for(0, 2)


@pytest.fixture
def captured(monkeypatch):
    """auto_initialize with the process-group calls captured."""
    calls = {}
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT", "TIK_COORDINATOR_ADDRESS",
                 "TIK_NUM_PROCESSES", "TIK_PROCESS_ID", "TIK_SLICE_INDEX",
                 "TIK_NUM_SLICES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda **kw: calls.update(kw))
    return calls


def test_two_hosts_of_two_cards_give_host_major_ranks(captured,
                                                      monkeypatch):
    d = TD.Distributor(hosts=["h0", "h1"], coordinator_port=9100,
                       nproc_per_node=2, num_slices=2)
    seen = []
    for host in range(2):
        for local in range(2):
            for k, v in d.env_for(host, local).items():
                monkeypatch.setenv(k, v)
            assert distributed.auto_initialize() is True
            seen.append((captured["rank"], captured["world_size"],
                         captured["init_method"],
                         distributed.slice_index(),
                         distributed.local_rank()))
    assert seen == [(0, 4, "tcp://h0:9100", 0, 0), (1, 4, "tcp://h0:9100",
                                                    0, 1),
                    (2, 4, "tcp://h0:9100", 1, 0), (3, 4, "tcp://h0:9100",
                                                    1, 1)]


@pytest.mark.parametrize("argv, own, program", [
    (["train.py", "--hosts", "x"], [], ["train.py", "--hosts", "x"]),
    (["--nproc-per-node", "2", "-m", "pkg.mod", "--data", "2"],
     ["--nproc-per-node", "2"], ["-m", "pkg.mod", "--data", "2"]),
    (["--hosts=a,b", "--host-local", "-n", "1", "--", "--odd", "1"],
     ["--hosts=a,b", "--host-local", "-n", "1"], ["--odd", "1"]),
    (["--deadline-s", "5"], ["--deadline-s", "5"], [])])
def test_program_starts_at_the_first_argument_not_the_launchers(
        argv, own, program):
    assert TR.split_argv(argv) == (own, program)
    options = {s for a in TR.parser()._actions for s in a.option_strings}
    assert options == TR._VALUED | TR._FLAGS


def test_slice_hosts_env_resolution(monkeypatch):
    monkeypatch.setenv("TIK_SLICE_HOSTS", "a,b")
    assert TR.resolve_cluster_hosts() == ["a", "b"]
    monkeypatch.delenv("TIK_SLICE_HOSTS")
    # TPU VM metadata: no counterpart on GPU hosts
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "w0,w1,w2")
    assert TR.resolve_cluster_hosts() == []


# ----------------------------------------------------------- several hosts --

class FakeProc:
    """A process that exits with `code` at its first poll (None: never)."""

    def __init__(self, code=0):
        self.code, self.returncode = code, None
        self.pid = 2 ** 22 + 7
        self.stdout = io.StringIO("")
        self.killed = False

    def poll(self):
        if self.killed:
            self.returncode = -9
        elif self.code is not None:
            self.returncode = self.code
        return self.returncode

    def kill(self):
        self.killed = True

    def wait(self):
        return self.poll()


def test_several_hosts_run_the_port_launcher_over_ssh(monkeypatch):
    calls = []

    def popen(cmd, **kw):
        calls.append(cmd)
        return FakeProc(0)

    monkeypatch.setattr(TR.subprocess, "Popen", popen)
    rc = TR.main(["--hosts", "h0,h1,h2", "--ssh-user", "tik",
                  "--ssh-key", "/k.pem", "--coordinator-port", "9100",
                  "--num-slices", "3", "--nproc-per-node", "2",
                  "--python", "/usr/bin/python3", "train.py", "--lr",
                  "1e-4"])
    assert rc == 0
    assert len(calls) == 3
    for i, cmd in enumerate(calls):
        assert cmd[:7] == ["ssh", "-o", "StrictHostKeyChecking=no", "-o",
                           "UserKnownHostsFile=/dev/null", "-o",
                           "LogLevel=ERROR"]
        assert cmd[7:10] == ["-i", "/k.pem", f"tik@h{i}"]
        env = " ".join(f"{k}={v}" for k, v in TD.Distributor(
            hosts=["h0", "h1", "h2"], coordinator_port=9100, num_slices=3,
            nproc_per_node=2).env_for(i).items())
        assert cmd[10] == (
            f"{env} /usr/bin/python3 -m cloudtik_tpu_torch.launch.run "
            "--host-local --python /usr/bin/python3 --nproc-per-node 2 -- "
            "train.py --lr 1e-4")


def test_a_failed_host_stops_the_others(monkeypatch):
    procs = iter([FakeProc(None), FakeProc(3), FakeProc(None)])
    made = []

    def popen(cmd, **kw):
        made.append(next(procs))
        return made[-1]

    monkeypatch.setattr(TR.subprocess, "Popen", popen)
    monkeypatch.setattr(TR.os, "killpg", lambda pid, sig: (_ for _ in ())
                        .throw(ProcessLookupError()))
    assert TR.main(["--hosts", "a,b,c", "x.py"]) == 3
    assert [p.killed for p in made] == [True, False, True]


def test_the_deadline_stops_every_process(monkeypatch):
    monkeypatch.setattr(TR.os, "killpg", lambda pid, sig: (_ for _ in ())
                        .throw(ProcessLookupError()))
    procs = [FakeProc(None), FakeProc(0)]
    t0 = time.monotonic()
    assert TR.wait_all(procs, deadline_s=0.2) == TR.DEADLINE_EXIT
    assert time.monotonic() - t0 < 5
    assert procs[0].killed and not procs[1].killed


# ------------------------------------------------------------- one host --

def test_a_failing_rank_kills_the_other(tmp_path):
    """A host's launcher (`--host-local`, host 1 of 2): each rank records
    its env and pid; local rank 0 then exits 1 and local rank 1 would
    sleep for two minutes.  The launcher kills rank 1 and exits 1 well
    inside its deadline."""
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import json, os, sys, time\n"
        "local = os.environ['LOCAL_RANK']\n"
        f"with open(os.path.join({str(tmp_path)!r}, 'r' + local), 'w') "
        "as f:\n"
        "    json.dump(dict(os.environ, pid=os.getpid()), f)\n"
        "if local == '0':\n"
        "    time.sleep(0.5)\n"
        "    sys.exit(1)\n"
        "time.sleep(120)\n")
    env = dict(os.environ, TIK_COORDINATOR_ADDRESS="h0:9100",
               TIK_NUM_PROCESSES="2", TIK_PROCESS_ID="1", RANK="9",
               WORLD_SIZE="9")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "cloudtik_tpu_torch.launch.run",
         "--host-local", "--nproc-per-node", "2", "--deadline-s", "60",
         str(probe)], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=90)
    assert out.returncode == 1, out.stdout + out.stderr
    assert time.monotonic() - t0 < 30
    assert "rank 2 exited 1" in out.stderr
    envs = [json.loads((tmp_path / f"r{i}").read_text()) for i in range(2)]
    for local, e in enumerate(envs):
        assert (e["LOCAL_RANK"], e["LOCAL_WORLD_SIZE"]) == (str(local), "2")
        assert (e["TIK_PROCESS_ID"], e["TIK_NUM_PROCESSES"],
                e["TIK_COORDINATOR_ADDRESS"]) == ("1", "2", "h0:9100")
        assert "RANK" not in e and "WORLD_SIZE" not in e
    with pytest.raises(ProcessLookupError):
        os.kill(envs[1]["pid"], 0)


def test_two_ranks_of_a_recipe_match_one_process(capsys):
    """The repaired fault: one host, `--nproc-per-node 2`, two gloo ranks
    of the DLRM recipe at data=2 (before, no launcher started the second
    rank).  Each rank's final loss is within 1e-3 relative of one process
    (test_torch_recipes' tolerance: bf16 compute, the ranks sum their
    halves' rounded losses)."""
    from cloudtik_tpu_torch.recipes import dlrm_criteo

    base = ["--model", "tiny", "--steps", "2", "--log-every", "1",
            "--device", "cpu", "--batch", "16"]
    one = dlrm_criteo.main(base)
    capsys.readouterr()
    out = subprocess.run(
        [sys.executable, "-m", "cloudtik_tpu_torch.launch.run",
         "--nproc-per-node", "2", "--coordinator-port", str(free_port()),
         "--deadline-s", "150", "-m", "cloudtik_tpu_torch.recipes.dlrm_criteo",
         *base, "--data", "2"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    results = {}
    for line in out.stdout.splitlines():
        prefix, _, rest = line.partition(" ")
        if rest.startswith("{"):
            results[prefix] = json.loads(rest)
    assert sorted(results) == ["[0]", "[1]"]
    for got in results.values():
        assert got["steps"] == 2
        assert abs(got["final_loss"] - one["final_loss"]) <= \
            1e-3 * one["final_loss"]
