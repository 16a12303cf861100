"""Run one Python program as N local ranks with a deadline.

A local stand-in for `torchrun --standalone --nproc-per-node N`: each rank
gets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`
and `MASTER_PORT` (a free port on 127.0.0.1), which
`distributed.auto_initialize` reads.  The call waits at most `timeout_s`
for all of them; on expiry, or when one rank fails, it kills every rank
still running, so a hung collective costs its deadline and no more.
"""

from __future__ import annotations

import os
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


def run_ranks(argv: Sequence[str], world: int, timeout_s: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run `python *argv` as `world` ranks; return each rank's output
    (stdout and stderr together).  Raises `RankFailure` with every rank's
    output when a rank exits non-zero or the deadline passes (all ranks
    are killed first)."""
    port = str(free_port())
    procs, logs = [], []
    for rank in range(world):
        penv = dict(os.environ if env is None else env)
        penv.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        # a file, not a pipe: a rank that writes much never blocks on it
        logs.append(tempfile.TemporaryFile(mode="w+"))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=penv, cwd=cwd, stdout=logs[-1],
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
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
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    if failed is None:
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    if failed is not None:
        raise RankFailure(failed + "\n" + "\n".join(
            f"--- rank {i} ---\n{o[-4000:]}" for i, o in enumerate(outs)))
    return outs
