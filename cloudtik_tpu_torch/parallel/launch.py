"""Run one Python program as N local ranks with a deadline.

A local stand-in for `torchrun --standalone --nproc-per-node N`: each rank
gets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`
and `MASTER_PORT` (a free port on 127.0.0.1), which
`distributed.auto_initialize` reads.  The call waits at most `timeout_s`
for all of them; on expiry, or when one rank fails, it kills every rank
still running, so a hung collective costs its deadline and no more.

An elastic drill ends ranks on purpose and starts them again: a rank that
exits with `LEFT` has left (its slice was lost) and is not a failure, and
a running rank may ask for a rank to come back (`request_return`): once
that rank's process has ended, a fresh process takes its place, with
`TIK_RANK_INCARNATION` counting its returns.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankFailure(RuntimeError):
    pass


# The exit code of a rank that left on purpose (an elastic drill's lost
# slice): run_ranks does not count it as a failure.
LEFT = 75


def request_return(rank: int) -> None:
    """Ask the `run_ranks` that started this process to start `rank` again as a fresh process once its current one has ended
    (an elastic drill's returning slice)."""
    folder = os.environ["TIK_RETURN_DIR"]
    with open(os.path.join(folder, f"rank{rank}.tmp"), "w"):
        pass
    os.replace(os.path.join(folder, f"rank{rank}.tmp"),
               os.path.join(folder, f"rank{rank}"))


def incarnation() -> int:
    """How many times this rank has returned (0 for its first process)."""
    return int(os.environ.get("TIK_RANK_INCARNATION", "0"))


def run_ranks(argv: Sequence[str], world: int, timeout_s: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run `python *argv` as `world` ranks; return each rank's output
    (stdout and stderr together, every incarnation's in turn).  Raises
    `RankFailure` with every rank's output when a rank exits other than 0
    or `LEFT`, or the deadline passes (all ranks are killed first).  A
    rank may ask for a rank to come back (`request_return`)."""
    port = str(free_port())
    returns_dir = tempfile.mkdtemp(prefix="tik-returns-")
    procs, logs = [], [[] for _ in range(world)]
    counts = [0] * world

    def start(rank: int) -> subprocess.Popen:
        penv = dict(os.environ if env is None else env)
        penv.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                    TIK_RANK_INCARNATION=str(counts[rank]),
                    TIK_RETURN_DIR=returns_dir)
        # a file, not a pipe: a rank that writes much never blocks on it
        logs[rank].append(tempfile.TemporaryFile(mode="w+"))
        return subprocess.Popen(
            [sys.executable, *argv], env=penv, cwd=cwd,
            stdout=logs[rank][-1], stderr=subprocess.STDOUT, text=True)

    def asked() -> List[int]:
        return sorted(int(n[4:]) for n in os.listdir(returns_dir)
                      if n.startswith("rank") and n[4:].isdigit())

    for rank in range(world):
        procs.append(start(rank))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            for rank in asked():
                if procs[rank].poll() is not None:
                    os.unlink(os.path.join(returns_dir, f"rank{rank}"))
                    counts[rank] += 1
                    procs[rank] = start(rank)
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0, LEFT)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if all(p.poll() is not None for p in procs) and not asked():
                break
            if time.monotonic() > deadline:
                failed = f"deadline of {timeout_s} s passed"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for rank_logs in logs:
            text = []
            for log in rank_logs:
                log.seek(0)
                text.append(log.read())
                log.close()
            outs.append("".join(text))
        shutil.rmtree(returns_dir, ignore_errors=True)
    if failed is not None:
        raise RankFailure(failed + "\n" + "\n".join(
            f"--- rank {i} ---\n{o[-4000:]}" for i, o in enumerate(outs)))
    return outs
