"""Load-balancer reconcile daemon: discovery registry -> cloud LBs.

Reference parity: runtime/loadbalancer/scripting.py:108 start_controller.
Runs on the head next to the discovery-sync daemon; each tick it reads
lb-expose-tagged services from the head state store and reconciles them
into the workspace's LoadBalancerProvider (GCP NLB / AWS ELBv2 / a fake in
tests via provider.load_balancer_module).

Run: `python -m cloudtik_tpu_torch.runtimes.loadbalancer.sync --head-ip ...
      --cluster c --workspace w [--interval 15]`.
"""

from __future__ import annotations

import argparse
import json
import time

from cloudtik_tpu_torch.utils.constants import TIK_STATE_PORT_DEFAULT


def main() -> None:
    from cloudtik_tpu_torch.control.state import StateClient, TcpStateBackend
    from cloudtik_tpu_torch.providers.factory import create_load_balancer_provider
    from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry
    from cloudtik_tpu_torch.runtimes.loadbalancer.runtime import (
        LoadBalancerController)

    parser = argparse.ArgumentParser()
    parser.add_argument("--head-ip", default="127.0.0.1")
    parser.add_argument("--state-port", type=int,
                        default=TIK_STATE_PORT_DEFAULT)
    parser.add_argument("--cluster", default="")
    parser.add_argument("--workspace", default="")
    parser.add_argument("--interval", type=float, default=15.0)
    parser.add_argument("--provider-config", default="{}",
                        help="provider section of the cluster config, JSON")
    args = parser.parse_args()

    provider = create_load_balancer_provider(
        json.loads(args.provider_config), args.workspace)
    client = StateClient(TcpStateBackend(args.head_ip, args.state_port))
    registry = ServiceRegistry(client, args.cluster, args.workspace)
    controller = LoadBalancerController(
        provider, registry, args.workspace, interval_s=args.interval)
    while True:
        try:
            result = controller.run_once()
            if any(result.values()):
                print(f"lb-reconcile: {result}", flush=True)
        except Exception as e:
            print(f"lb-reconcile failed: {e}", flush=True)
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
