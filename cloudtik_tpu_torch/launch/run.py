"""`tik-run` for the port: one process per card on every host.

    python -m cloudtik_tpu_torch.launch.run [--nproc-per-node N] train.py ...
    python -m cloudtik_tpu_torch.launch.run [options] -m package.module ...

Counterpart of `cloudtik_tpu/launch/run.py`, with its flags (`--hosts`,
`--hostfile`, `--num-nodes`, `--num-slices`, `--coordinator-port`,
`--ssh-user`, `--ssh-key`, `--python`), written with argparse.  The JAX
package starts one SPMD process a host; torch runs one process a card, so
here each host starts `--nproc-per-node` ranks (default: its CUDA device
count, 1 without CUDA), each with the host's `TIK_COORDINATOR_ADDRESS`,
`TIK_NUM_PROCESSES` (hosts), `TIK_PROCESS_ID` (host), the slice env under
`--num-slices`, and its own `LOCAL_RANK` and `LOCAL_WORLD_SIZE`, which
`parallel.distributed.auto_initialize` maps to world and rank.

On one host the launcher starts the ranks itself.  On several it runs,
over ssh, this same launcher on each host with that host's env, and each
starts its host's ranks.  Either way it waits with `parallel/launch.py`'s
rule: when one rank (or one host's launcher) fails, or `--deadline-s`
passes, it kills every one still running, and it exits non-zero when any
failed.  Hosts come from `--hosts`, `--hostfile` or `TIK_SLICE_HOSTS`
(the TPU VM metadata `TPU_WORKER_HOSTNAMES` the reference also reads has
no GPU counterpart).
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

from cloudtik_tpu_torch.launch.distributor import (Distributor,
                                                    default_nproc_per_node,
                                                    local_env)

MODULE = "cloudtik_tpu_torch.launch.run"
# exit code when the deadline passed (as `timeout` gives)
DEADLINE_EXIT = 124
# host-level env a rank takes from its launcher
HOST_ENV = ("TIK_COORDINATOR_ADDRESS", "TIK_NUM_PROCESSES", "TIK_PROCESS_ID",
            "TIK_SLICE_INDEX", "TIK_NUM_SLICES")


def _pump(stream, prefix: str) -> threading.Thread:
    def run():
        for line in stream:
            sys.stdout.write(f"{prefix}{line}")
            sys.stdout.flush()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def _kill(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                p.kill()
    for p in procs:
        p.wait()


def wait_all(procs: Sequence[subprocess.Popen],
             deadline_s: Optional[float] = None,
             names: Optional[Sequence[str]] = None) -> int:
    """Wait for every process; the first to fail, or the deadline, kills
    every one still running.  Returns 0, the failed one's exit code
    (128 + signal for a killed one), or DEADLINE_EXIT."""
    names = list(names or [f"rank {i}" for i in range(len(procs))])
    deadline = None if deadline_s is None else \
        time.monotonic() + deadline_s
    code = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                c = codes[bad[0]]
                code = c if c > 0 else 128 - c
                print(f"tik-run: {names[bad[0]]} exited {c}; stopping the "
                      "others", file=sys.stderr, flush=True)
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                code = DEADLINE_EXIT
                print(f"tik-run: deadline of {deadline_s} s passed; "
                      "stopping every process", file=sys.stderr, flush=True)
                break
            time.sleep(0.05)
    except KeyboardInterrupt:
        code = 130
    finally:
        _kill(procs)
    return code


def launch_local(program: List[str], host_env: dict, nproc_per_node: int,
                 deadline_s: Optional[float] = None) -> int:
    """Start this host's `nproc_per_node` ranks of `program` and wait for
    them (`wait_all`).  With more than one, each line a rank prints is
    prefixed with its global rank."""
    base = {**os.environ, **host_env}
    # the torchrun names take precedence in auto_initialize: a launcher
    # started from inside another launch must not hand them down
    for name in ("RANK", "WORLD_SIZE"):
        base.pop(name, None)
    host = int(host_env.get("TIK_PROCESS_ID", "0"))
    procs, pumps, names = [], [], []
    piped = nproc_per_node > 1
    try:
        for local in range(nproc_per_node):
            rank = host * nproc_per_node + local
            proc = subprocess.Popen(
                program, env={**base, **local_env(local, nproc_per_node)},
                start_new_session=True,
                stdout=subprocess.PIPE if piped else None,
                stderr=subprocess.STDOUT if piped else None,
                text=True)
            procs.append(proc)
            names.append(f"rank {rank}")
            if piped:
                pumps.append(_pump(proc.stdout, f"[{rank}] "))
    except OSError:
        _kill(procs)
        raise
    code = wait_all(procs, deadline_s, names)
    for pump in pumps:
        pump.join(timeout=10)
    return code


def _ssh_launch(host: str, program: List[str], env: dict,
                ssh_user: Optional[str], ssh_key: Optional[str],
                output_prefix: str) -> subprocess.Popen:
    env_prefix = " ".join(
        f"{k}={shlex.quote(str(v))}" for k, v in env.items())
    remote_cmd = f"{env_prefix} {' '.join(shlex.quote(a) for a in program)}"
    ssh_cmd = ["ssh", "-o", "StrictHostKeyChecking=no",
               "-o", "UserKnownHostsFile=/dev/null", "-o", "LogLevel=ERROR"]
    if ssh_key:
        ssh_cmd += ["-i", ssh_key]
    target = f"{ssh_user}@{host}" if ssh_user else host
    ssh_cmd += [target, remote_cmd]
    proc = subprocess.Popen(
        ssh_cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    _pump(proc.stdout, output_prefix)
    return proc


def resolve_cluster_hosts() -> List[str]:
    """Hosts of this node's slice, from tik-exported env (AI runtime)."""
    hosts = os.environ.get("TIK_SLICE_HOSTS")
    if hosts:
        return [h for h in hosts.split(",") if h]
    return []


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "tik-run", usage="%(prog)s [options] (script.py | -m module | "
        "-- command) [args ...]", description="Launch a program as one "
        "process per card on every host.")
    p.add_argument("--hosts", default=None,
                   help="Comma-separated hosts (default: this slice's "
                        "hosts, else this host).")
    p.add_argument("--hostfile", default=None)
    p.add_argument("--num-nodes", "-n", type=int, default=None,
                   help="Limit to the first N hosts.")
    p.add_argument("--num-slices", type=int, default=None,
                   help="Split the hosts into N slices: each process gets "
                        "TIK_SLICE_INDEX/TIK_NUM_SLICES in its env.")
    p.add_argument("--coordinator-port", type=int, default=8476)
    p.add_argument("--ssh-user", default=None)
    p.add_argument("--ssh-key", default=None)
    p.add_argument("--python", dest="python_bin", default=sys.executable)
    p.add_argument("--nproc-per-node", type=int, default=None,
                   help="Processes a host, one a card (default: the "
                        "host's CUDA device count, 1 without CUDA).")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="Kill every process still running after this "
                        "many seconds (default: none).")
    # a host's own launcher under a multi-host launch: its TIK_* env is
    # the host's, set by the launcher that started it
    p.add_argument("--host-local", action="store_true",
                   help=argparse.SUPPRESS)
    return p


# the launcher's own options: those that take a value, and the flags; the
# program starts at the first other argument (a script or `-m module`), or
# after `--`
_VALUED = frozenset(("--hosts", "--hostfile", "--num-nodes", "-n",
                     "--num-slices", "--coordinator-port", "--ssh-user",
                     "--ssh-key", "--python", "--nproc-per-node",
                     "--deadline-s"))
_FLAGS = frozenset(("--host-local", "-h", "--help"))


def split_argv(argv: Sequence[str]) -> Tuple[List[str], List[str]]:
    """(the launcher's own arguments, the program and its arguments)."""
    argv = list(argv)
    i = 0
    while i < len(argv):
        name, eq, _ = argv[i].partition("=")
        if argv[i] == "--":
            return argv[:i], argv[i + 1:]
        if name in _FLAGS or (name in _VALUED and eq):
            i += 1
        elif name in _VALUED:
            i += 2
        else:
            break
    return argv[:i], argv[i:]


def main(argv: Optional[List[str]] = None) -> int:
    own, program = split_argv(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(own)
    if not program:
        parser().error("a program to launch is required: a script.py or "
                       "-m module, with its arguments")
    launched = list(program)
    if program[0].endswith(".py") or program[0] == "-m":
        program = [args.python_bin] + program

    if args.host_local:
        host_env = {k: os.environ[k] for k in HOST_ENV if k in os.environ}
        nproc = args.nproc_per_node if args.nproc_per_node is not None \
            else default_nproc_per_node()
        return launch_local(program, host_env, nproc, args.deadline_s)

    host_list = [h for h in (args.hosts or "").split(",") if h] or \
        resolve_cluster_hosts()
    dist = Distributor(
        hosts=host_list or None, hostfile=args.hostfile,
        num_nodes=args.num_nodes, coordinator_port=args.coordinator_port,
        num_slices=args.num_slices, nproc_per_node=args.nproc_per_node)

    if not dist.distributed():
        print(f"tik-run: single host, {dist.nproc_per_node} process(es)",
              file=sys.stderr, flush=True)
        return launch_local(program, dist.env_for(0), dist.nproc_per_node,
                            args.deadline_s)

    print(f"tik-run: launching on {dist.num_processes} hosts (coordinator "
          f"{dist.coordinator_address})", file=sys.stderr, flush=True)
    remote = [args.python_bin, "-m", MODULE, "--host-local",
              "--python", args.python_bin]
    # unset, each host starts one process per card it has
    if args.nproc_per_node is not None:
        remote += ["--nproc-per-node", str(args.nproc_per_node)]
    if args.deadline_s is not None:
        remote += ["--deadline-s", str(args.deadline_s)]
    procs, names = [], []
    try:
        for idx, spec in enumerate(dist.hosts):
            procs.append(_ssh_launch(
                spec.address, remote + ["--"] + launched, dist.env_for(idx),
                args.ssh_user, args.ssh_key, f"[{idx}:{spec.address}] "))
            names.append(f"host {idx} ({spec.address})")
    except OSError:
        _kill(procs)
        raise
    return wait_all(procs, args.deadline_s, names)


if __name__ == "__main__":
    sys.exit(main())
