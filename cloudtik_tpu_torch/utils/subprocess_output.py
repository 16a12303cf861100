"""Stream-while-capture subprocess execution.

Reference parity: core/_private/subprocess_output_util.py:392 — node
bootstrap commands must stream per-line to the operator's console (with
the node's log prefix) while a bounded tail is captured for the error
report when the command fails.  `check_call` gives streaming with no
capture; `check_output` gives capture with no streaming; this gives
both.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import time
from typing import Callable, Deque, Optional, Tuple

DEFAULT_TAIL_LINES = 200


def run_with_streaming_output(
    cmd: str,
    *,
    prefix: str = "",
    line_callback: Optional[Callable[[str], None]] = None,
    timeout: Optional[float] = None,
    tail_lines: int = DEFAULT_TAIL_LINES,
    stream=None,
) -> Tuple[int, str]:
    """Run `cmd` through the shell; echo each output line (stderr merged)
    to `stream` (default: real stdout) prefixed, keep the last
    `tail_lines` lines, return (returncode, tail).  On timeout the
    process group is killed and (-1, tail) returns."""
    import threading

    stream = stream if stream is not None else sys.stdout
    tail: Deque[str] = collections.deque(maxlen=tail_lines)
    proc = subprocess.Popen(
        cmd, shell=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, errors="replace",
        start_new_session=True)
    # watchdog (not a post-line deadline check): a command that goes
    # silent would otherwise block readline past any deadline
    timed_out = threading.Event()
    watchdog: Optional[threading.Timer] = None
    if timeout:
        def _expire():
            timed_out.set()
            _kill(proc)

        watchdog = threading.Timer(timeout, _expire)
        watchdog.daemon = True
        watchdog.start()
    try:
        assert proc.stdout is not None
        for line in proc.stdout:
            line = line.rstrip("\n")
            tail.append(line)
            if line_callback is not None:
                line_callback(line)
            else:
                print(f"{prefix}{line}", file=stream, flush=True)
        rc = proc.wait()
    finally:
        if watchdog is not None:
            watchdog.cancel()
    if timed_out.is_set():
        tail.append(f"[timeout after {timeout}s]")
        return -1, "\n".join(tail)
    return rc, "\n".join(tail)


def _kill(proc: subprocess.Popen) -> None:
    import os
    import signal
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        proc.kill()
    proc.wait(timeout=5)
