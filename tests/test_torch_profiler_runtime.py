"""The port's profiler runtime: its captures served over HTTP.

Mirrors `tests/test_profiler_runtime.py` for the port.  The port's
captures (`telemetry/stepprof.py` `ProfileCapture`) are Chrome-trace JSON
files, which XProf and TensorBoard without the PyTorch profiler plugin do
not read, so the runtime serves the profile root with the standard
library's HTTP server: it boots through the delivery spawn path and hands
back a capture byte for byte.
"""

from __future__ import annotations

import json
import socket
import sys
import urllib.request

import pytest
import torch

from cloudtik_tpu.runtimes.profiler import runtime as JPR
from cloudtik_tpu_torch.runtimes.profiler import runtime as TPR
from cloudtik_tpu_torch.runtimes.registry import get_runtime_cls
from cloudtik_tpu_torch.telemetry import stepprof


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path, timeout=30):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.status, resp.read()


@pytest.fixture
def captured_trace(tmp_path):
    """A real (tiny) capture, as a requested `ProfileCapture` writes it."""
    profile_root = tmp_path / "profiles"
    capture = stepprof.ProfileCapture(path=str(tmp_path / "request.json"))
    assert capture.start(str(profile_root / "run1"))
    x = torch.ones(64, 64)
    (x @ x).sum()
    capture.stop()
    trace = profile_root / "run1" / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]
    return profile_root, trace


class TestProfilerRuntime:
    def test_boots_and_serves_captured_trace(self, captured_trace, tmp_path,
                                             monkeypatch):
        monkeypatch.setenv("TIK_HOME", str(tmp_path / "home"))
        profile_root, trace = captured_trace
        port = _free_port()
        rt = TPR.ProfilerRuntime({"profile_dir": str(profile_root),
                                  "port": port, "start_timeout_s": 60})
        ctx = {"is_head": True, "node_id": "head", "node_ip": "127.0.0.1",
               "config": {"cluster_name": "c1", "workspace_name": "w1"},
               "conf_dir": str(tmp_path)}
        try:
            rt.node_services(ctx, "start")
            status, listing = _get(port, "/", timeout=60)
            assert status == 200 and b"run1/" in listing
            status, body = _get(port, "/run1/trace.json", timeout=60)
            assert status == 200
            assert body == trace.read_bytes()
        finally:
            rt.node_services(ctx, "stop")
        with pytest.raises(OSError):
            _get(port, "/", timeout=2)

    def test_registered_and_endpoint(self):
        assert get_runtime_cls("profiler") is TPR.ProfilerRuntime
        rt = TPR.ProfilerRuntime({})
        eps = rt.get_runtime_endpoints({}, "10.0.0.1")
        assert eps["profiler"]["url"] == "http://10.0.0.1:6006"
        svcs = rt.get_runtime_services({}, "10.0.0.1")
        assert svcs == JPR.ProfilerRuntime({}).get_runtime_services(
            {}, "10.0.0.1")
        assert svcs["profiler"]["node_kind"] == "head"

    def test_command_is_the_standard_library_server(self, tmp_path):
        """Where the reference runs XProf or TensorBoard (or nothing, when
        neither is installed), the port always has a server: the profile
        root as static files, named by the process scan."""
        cfg = {"profile_dir": str(tmp_path / "p"), "port": 7007}
        rt = TPR.ProfilerRuntime(cfg)
        cmd = rt.service_command({"is_head": True})
        assert cmd == [sys.executable, "-m", "http.server", "--directory",
                       str(tmp_path / "p"), "--bind", "0.0.0.0", "7007"]
        assert (tmp_path / "p").is_dir()
        assert TPR.profile_root(cfg) == JPR.profile_root(cfg)
        assert TPR.profile_root() == JPR.profile_root()
        assert rt.get_processes() == [("http.server", False, "profiler",
                                       "head")]
        assert rt.get_processes()[0][0] in cmd
