"""Child fate-sharing (the reference's process reaper, kernel-assisted).

Reference parity: core/_private/service/cloudtik_process_reaper.py —
the reference runs a reaper daemon that kills the process tree when the
parent dies, so a crashed node-services process never leaves orphaned
runtime daemons.  On Linux the kernel does this directly:
PR_SET_PDEATHSIG delivers a signal to the child when its parent thread
dies.

`preexec()` is for PYTHON children only.  The native C++ daemons
(state server, host sampler) arm PDEATHSIG themselves via their
--fate-parent flag instead: a Popen preexec_fn forces fork()+exec,
which both risks deadlock in a multithreaded (JAX) parent and blocks
subprocess's posix_spawn fast path."""

from __future__ import annotations

import ctypes
import signal
import sys

PR_SET_PDEATHSIG = 1


def preexec(sig: int = signal.SIGTERM):
    """Popen preexec_fn installing parent-death fate-sharing (Linux);
    no-op elsewhere."""
    if not sys.platform.startswith("linux"):
        return None

    def _set():
        try:
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            libc.prctl(PR_SET_PDEATHSIG, sig, 0, 0, 0)
        except Exception:
            pass

    return _set
