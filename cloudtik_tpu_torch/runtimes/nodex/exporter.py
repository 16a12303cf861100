"""Standalone node-metrics exporter process.

Reference parity: runtime/nodex ran the prometheus node-exporter binary on
every node (runtime/nodex/runtime.py:13).  This build's exporter is
self-contained Python: psutil gauges registered in the tik telemetry
registry (telemetry/instruments.py) and served by the telemetry HTTP
server — so the SAME port also exposes every telemetry metric and span
the process accumulates (`/metrics`, `/trace`, `/trace/summary`).
Spawned by the delivery layer:
`python -m cloudtik_tpu_torch.runtimes.nodex.exporter --port 9100
 [--interval 10]`.
"""

from __future__ import annotations

import argparse
import threading
import time


def start_exporter(port: int, interval_s: float = 10.0):
    """Start the HTTP server + collection thread; returns the server."""
    import psutil

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.telemetry import http as telemetry_http
    from cloudtik_tpu_torch.telemetry import instruments as ti

    # exporting metrics IS this process's job: force the registry on
    # even when the host env carries TIK_TELEMETRY=off for workloads
    telemetry.enable()
    # join the boot trace when the start command carried one
    telemetry.adopt_traceparent_from_env()

    # prime the cpu sampler: the first cpu_percent(interval=None) call
    # has no reference window and returns a meaningless 0.0 — take the
    # throwaway reading now so the first scrape is real
    psutil.cpu_percent(interval=None)

    server = telemetry_http.start_server(port)

    def _collect():
        while True:
            ti.NODE_CPU_PERCENT.set(psutil.cpu_percent(interval=None))
            ti.NODE_MEMORY_PERCENT.set(psutil.virtual_memory().percent)
            ti.NODE_DISK_PERCENT.set(psutil.disk_usage("/").percent)
            io = psutil.net_io_counters()
            ti.NODE_NET_SENT.set(io.bytes_sent)
            ti.NODE_NET_RECV.set(io.bytes_recv)
            time.sleep(interval_s)

    threading.Thread(target=_collect, daemon=True,
                     name="tik-nodex-collect").start()
    return server


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=9100)
    parser.add_argument("--interval", type=float, default=10.0,
                        help="Seconds between psutil collections.")
    args = parser.parse_args()
    start_exporter(args.port, args.interval)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
