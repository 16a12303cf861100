"""Cloud simulator: an HTTP service managing an on-premise machine pool.

Reference parity: providers/_private/onpremise (SURVEY.md §2.2 —
`cloudtik-simulator` HTTP service + CloudSimulatorScheduler
cloud_simulator_scheduler.py:23 against a fake machine inventory).  The
service owns the inventory (machines + their allocation state); any number
of clusters allocate from it over JSON/HTTP.  `tik-simulator` runs it.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler
from socketserver import ThreadingTCPServer
from typing import Any, Dict, List, Optional

DEFAULT_PORT = 8517


class MachinePool:
    """In-memory inventory: machine id -> {ip, instance_type, allocated_to,
    tags}.  Thread-safe."""

    def __init__(self, machines: List[Dict[str, Any]]):
        self._lock = threading.RLock()
        self.machines: Dict[str, Dict[str, Any]] = {}
        for i, m in enumerate(machines):
            mid = m.get("id") or f"machine-{i}"
            self.machines[mid] = {
                "id": mid,
                "ip": m["ip"],
                "external_ip": m.get("external_ip", m["ip"]),
                "instance_type": m.get("instance_type", "default"),
                "allocated_to": None,
                "tags": {},
            }

    def list(self, cluster: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = [dict(m) for m in self.machines.values()]
        if cluster is not None:
            out = [m for m in out if m["allocated_to"] == cluster]
        return out

    def allocate(self, cluster: str, count: int, instance_type: str,
                 tags: Dict[str, str]) -> List[Dict[str, Any]]:
        with self._lock:
            free = [m for m in self.machines.values()
                    if m["allocated_to"] is None
                    and (instance_type in ("default", "")
                         or m["instance_type"] == instance_type)]
            if len(free) < count:
                raise ValueError(
                    f"only {len(free)} machines free of type "
                    f"{instance_type!r}, need {count}")
            got = []
            for m in free[:count]:
                m["allocated_to"] = cluster
                m["tags"] = dict(tags)
                m["allocated_at"] = time.time()
                got.append(dict(m))
            return got

    def release(self, cluster: str, machine_id: str) -> bool:
        with self._lock:
            m = self.machines.get(machine_id)
            if m is None or m["allocated_to"] != cluster:
                return False
            m["allocated_to"] = None
            m["tags"] = {}
            return True

    def set_tags(self, cluster: str, machine_id: str,
                 tags: Dict[str, str]) -> bool:
        with self._lock:
            m = self.machines.get(machine_id)
            if m is None or m["allocated_to"] != cluster:
                return False
            m["tags"].update(tags)
            return True


class CloudSimulator:
    """HTTP wrapper around a MachinePool.

    POST /  body {"op": "...", ...} -> {"ok": true, ...} — one endpoint,
    op-dispatched, mirroring the reference simulator's RPC style.
    """

    def __init__(self, machines: List[Dict[str, Any]],
                 host: str = "0.0.0.0", port: int = DEFAULT_PORT):
        self.pool = MachinePool(machines)
        pool = self.pool

        class _Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length))
                    op = req.get("op")
                    if op == "list":
                        resp = {"ok": True,
                                "machines": pool.list(req.get("cluster"))}
                    elif op == "allocate":
                        resp = {"ok": True, "machines": pool.allocate(
                            req["cluster"], int(req.get("count", 1)),
                            req.get("instance_type", "default"),
                            req.get("tags", {}))}
                    elif op == "release":
                        resp = {"ok": pool.release(req["cluster"],
                                                   req["machine_id"])}
                    elif op == "set_tags":
                        resp = {"ok": pool.set_tags(
                            req["cluster"], req["machine_id"],
                            req.get("tags", {}))}
                    else:
                        resp = {"ok": False, "error": f"bad op {op!r}"}
                except Exception as e:
                    resp = {"ok": False, "error": str(e)}
                body = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        class _Server(ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="tik-simulator")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def serve_forever(self) -> None:
        self._server.serve_forever()


def main():  # `tik-simulator <machines.json> [port]`
    import sys
    with open(sys.argv[1]) as f:
        machines = json.load(f)
    port = int(sys.argv[2]) if len(sys.argv) > 2 else DEFAULT_PORT
    sim = CloudSimulator(machines, port=port)
    print(f"tik-simulator serving {len(sim.pool.machines)} machines "
          f"on :{sim.port}")
    sim.serve_forever()


if __name__ == "__main__":
    main()
