"""Discovery sync daemon: renders the live service registry to consumers.

Reference parity: the consul fabric's downstream renderers — prometheus
file-SD generation (runtime/prometheus/discovery.py:62) and DNS zone data
(dnsmasq/bind/coredns runtimes).  This build's registry lives in the head
state store (discovery/runtime.py ServiceRegistry); this daemon runs on
the head and periodically renders it into:

  * {TIK_HOME}/prometheus/targets.json  — prometheus file-SD target groups
  * {TIK_HOME}/dns/hosts.tik            — `ip fqdn` lines (dnsmasq/hosts)
  * {TIK_HOME}/dns/services.json        — full registry snapshot

Run: `python -m cloudtik_tpu_torch.runtimes.discovery.sync --head-ip 10.0.0.2
      --cluster c --workspace w [--interval 5]`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils.constants import TIK_STATE_PORT_DEFAULT, tik_home


def render_once(registry, home: str) -> Dict[str, Any]:
    from cloudtik_tpu_torch.runtimes.discovery.runtime import service_fqdn
    from cloudtik_tpu_torch.runtimes.prometheus.runtime import write_targets_file

    services = registry.services_by_name()
    scrapeable = {name: svc for name, svc in services.items()
                  if svc.get("protocol") == "http"}
    write_targets_file(os.path.join(home, "prometheus"), scrapeable)

    dns_dir = os.path.join(home, "dns")
    os.makedirs(dns_dir, exist_ok=True)
    lines = []
    for name, svc in sorted(services.items()):
        fqdn = service_fqdn(name, registry.cluster, registry.workspace)
        for node in svc["nodes"]:
            lines.append(f"{node['ip']} {fqdn}")
    with open(os.path.join(dns_dir, "hosts.tik"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    with open(os.path.join(dns_dir, "services.json"), "w") as f:
        json.dump(services, f, indent=1, default=str)
    return services


def next_delay(interval: float, consecutive_failures: int,
               max_backoff: float = 60.0, jitter: float = 0.1) -> float:
    """Poll delay: base interval on success; exponential backoff with
    jitter while the head store is unreachable so a restarting head isn't
    hammered by every node's sync daemon at once.  Delegates to the
    tree-wide audited policy in utils/retry.py."""
    from cloudtik_tpu_torch.utils.retry import poll_delay
    return poll_delay(interval, consecutive_failures,
                      max_delay_s=max_backoff, jitter=jitter)


def run_loop(registry, home: str, interval: float,
             max_iterations: int = 0) -> None:
    """Render loop with failure backoff; max_iterations>0 bounds it (tests)."""
    failures = 0
    iterations = 0
    while True:
        try:
            with telemetry.span("discovery.render"):
                render_once(registry, home)
            failures = 0
            ti.DISCOVERY_SYNCS.inc(result="ok")
        except Exception as e:  # head store down/restarting: back off
            failures += 1
            ti.DISCOVERY_SYNCS.inc(result="failed")
            print(f"discovery-sync: render failed ({failures}x): {e}",
                  flush=True)
        iterations += 1
        if max_iterations and iterations >= max_iterations:
            return
        time.sleep(next_delay(interval, failures))


def main() -> None:
    from cloudtik_tpu_torch.control.state import StateClient, TcpStateBackend
    from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry

    parser = argparse.ArgumentParser()
    parser.add_argument("--head-ip", default="127.0.0.1")
    parser.add_argument("--state-port", type=int,
                        default=TIK_STATE_PORT_DEFAULT)
    parser.add_argument("--cluster", default="")
    parser.add_argument("--workspace", default="")
    parser.add_argument("--interval", type=float, default=5.0)
    args = parser.parse_args()

    client = StateClient(TcpStateBackend(args.head_ip, args.state_port))
    registry = ServiceRegistry(client, args.cluster, args.workspace)
    run_loop(registry, tik_home(), args.interval)


if __name__ == "__main__":
    main()
