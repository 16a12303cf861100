"""Port parity: the port's `tik-serve` vs the JAX backends.

The port's server, given parameters converted from the JAX
`init_params(PRNGKey(0), tiny)`, answers /v1/generate with the tokens of
the JAX `transformer_backend("tiny")` (both in fp32, greedy), and keeps the
JAX server's health, model list, error and drain behaviour.  Its
`engine_backend` (`--engine`) answers concurrent posts with the same
tokens, maps the engine's refusals to 413, 429 + Retry-After and 400 with
the reason in the body, returns the request-id headers, and a drain lets
in-flight requests finish before it stops the engine.  A refusal reaches
the client whole, however large the request it refuses.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve.server import transformer_backend as jax_backend
from cloudtik_tpu_torch.serve.server import (
    BackendError, ModelBackend, ServeServer, drain_and_stop, engine_backend,
    transformer_backend)

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


@pytest.fixture(scope="module")
def served():
    params = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), JT.config("tiny")))
    backend = transformer_backend("tiny", device="cpu", params=params,
                                  dtype=torch.float32)
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    yield backend, f"http://127.0.0.1:{server.port}"
    server.stop()


@pytest.mark.parametrize("batch,plen,new", [(1, 8, 6), (2, 5, 4)])
def test_generate_matches_jax_backend(served, batch, plen, new):
    _, base = served
    prompt = np.random.default_rng(plen).integers(0, 256, (batch, plen))
    payload = {"tokens": prompt.tolist(), "max_new_tokens": new}
    want = jax_backend("tiny", dtype=jnp.float32).endpoints["generate"](
        payload)
    status, body, _ = _http(base + "/v1/generate", payload)
    assert status == 200
    assert body["tokens"] == want["tokens"]


def test_top_k_request_is_seeded(served):
    _, base = served
    payload = {"tokens": [[1, 2, 3]], "max_new_tokens": 5,
               "temperature": 1.0, "top_k": 10, "seed": 3}
    first = _http(base + "/v1/generate", payload)[1]["tokens"]
    assert first == _http(base + "/v1/generate", payload)[1]["tokens"]
    assert np.asarray(first).shape == (1, 5)


def test_health_models_and_not_found(served):
    _, base = served
    assert _http(base + "/healthz")[:2] == (200, {"status": "ok"})
    assert _http(base + "/v1/models")[:2] == (
        200, {"models": ["transformer:tiny"]})
    assert _http(base + "/nope")[0] == 404
    assert _http(base + "/v1/nope", {})[0] == 404


@pytest.mark.parametrize("payload", [
    {"tokens": "abc"},
    {"tokens": [[1, 2, 300]]},              # outside the vocab
    {"tokens": [1, 2, 3]},                  # not [batch, seq]
    {"tokens": [[1]], "max_new_tokens": 0},
    {"max_new_tokens": 2},
])
def test_bad_requests_get_400(served, payload):
    _, base = served
    status, body, _ = _http(base + "/v1/generate", payload)
    assert status == 400 and "error" in body


def test_backend_error_status_and_headers():
    def fail(payload):
        raise BackendError("full", {"x-tik-request-id": "7"}, status=429,
                           reason="queue_full")

    server = ServeServer([ModelBackend("m", {"generate": fail})],
                         host="127.0.0.1", port=0)
    server.start()
    try:
        status, body, headers = _http(
            f"http://127.0.0.1:{server.port}/v1/generate", {})
    finally:
        server.stop()
    assert status == 429
    assert body == {"error": "full", "reason": "queue_full"}
    assert headers["x-tik-request-id"] == "7"


def test_drain_refuses_new_and_lets_inflight_finish():
    entered, release = threading.Event(), threading.Event()

    def slow(payload):
        entered.set()
        release.wait(10)
        return {"tokens": [[1]]}

    server = ServeServer([ModelBackend("m", {"generate": slow})],
                         host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}/v1/generate"
    results = []
    worker = threading.Thread(target=lambda: results.append(_http(base, {})))
    worker.start()
    try:
        assert entered.wait(10)
        drained = []
        drainer = threading.Thread(
            target=lambda: drained.append(server.drain(grace_s=10)))
        drainer.start()
        while not server.draining:
            pass
        status, body, headers = _http(base, {})
        assert status == 503 and body["reason"] == "draining"
        assert headers["Retry-After"] == "1"
        release.set()
        worker.join(10)
        drainer.join(10)
        assert not worker.is_alive() and not drainer.is_alive()
        assert results[0][0] == 200 and drained == [True]
    finally:
        release.set()
        server.stop()


@pytest.mark.parametrize("path,status", [("/v1/generate", 503),
                                         ("/nope", 404)])
def test_refusal_over_a_large_body_reaches_the_client(path, status):
    """A refusal sent over an unread request body used to be followed by
    a reset that could reach the client first (a 4 MiB body makes it
    certain): the server reads the body before it answers."""
    import http.client

    server = ServeServer([ModelBackend("m", {"generate": lambda p: {}})],
                         host="127.0.0.1", port=0)
    server.start()
    try:
        assert server.drain(grace_s=1)
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("POST", path, body=json.dumps(
            {"tokens": [[1]], "pad": "x" * (4 << 20)}).encode())
        resp = conn.getresponse()
        assert resp.status == status and "error" in json.loads(resp.read())
        conn.close()
    finally:
        server.stop()


def test_bad_content_length_is_400():
    import socket

    server = ServeServer([ModelBackend("m", {"generate": lambda p: {}})],
                         host="127.0.0.1", port=0)
    server.start()
    try:
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=30) as sock:
            sock.sendall(b"POST /v1/generate HTTP/1.0\r\n"
                         b"Content-Length: abc\r\n\r\n")
            reply = b""
            while chunk := sock.recv(65536):
                reply += chunk
        head, _, body = reply.partition(b"\r\n\r\n")
        assert head.split()[1] == b"400"
        assert "bad Content-Length" in json.loads(body)["error"]
    finally:
        server.stop()


def test_checkpoint_dir_is_not_supported_yet(tmp_path):
    """`checkpoint_dir` is ported (tests/test_torch_checkpoint.py serves a
    restored one): a directory that holds no checkpoint raises, and
    reading it leaves nothing behind.  The name dates from before the
    port and is kept, so that the test's history follows it."""
    missing = tmp_path / "nonexistent"
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        transformer_backend("tiny", checkpoint_dir=str(missing),
                            device="cpu")
    assert not missing.exists()


def test_backend_without_params_inits_from_seed_zero():
    a = transformer_backend("tiny", device="cpu")
    b = transformer_backend("tiny", device="cpu")
    assert torch.equal(a.params["layers"]["wq"], b.params["layers"]["wq"])
    out = a.endpoints["generate"]({"tokens": [[4, 5]],
                                   "max_new_tokens": 3})
    assert np.asarray(out["tokens"]).shape == (1, 3)


# -- tik-serve --engine ------------------------------------------------------

@pytest.fixture(scope="module")
def engine_served():
    params = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), JT.config("tiny")))
    backend = engine_backend("tiny", slots=2, max_len=32, block_size=8,
                             device="cpu", params=params,
                             dtype=torch.float32)
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    try:
        yield backend, f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()
        backend.engine.stop()


def test_engine_backend_serves_concurrent_posts_like_jax(engine_served):
    backend, base = engine_served
    prompts = [[1, 2, 3], [9, 9], [200, 17, 5, 4, 3]]
    results = {}

    def post(i):
        results[i] = _http(base + "/v1/generate",
                           {"tokens": [prompts[i]], "max_new_tokens": 4})

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    want = jax_backend("tiny", dtype=jnp.float32).endpoints["generate"]
    ids = set()
    for i, prompt in enumerate(prompts):
        status, body, headers = results[i]
        assert status == 200
        assert body["tokens"] == want({"tokens": [prompt],
                                       "max_new_tokens": 4})["tokens"]
        assert headers["x-tik-request-id"] == str(body["request_id"])
        assert headers["x-tik-traceparent"].startswith("00-")
        ids.add(body["request_id"])
    assert len(ids) == 3
    assert _http(base + "/v1/models")[1] == {
        "models": ["transformer-engine:tiny"]}


@pytest.mark.parametrize("payload, status, reason", [
    ({"tokens": [[1, 2, 3, 4]], "max_new_tokens": 100}, 413, "capacity"),
    ({"tokens": [[1, 256]], "max_new_tokens": 2}, 400, "token_ids"),
    ({"tokens": [[]], "max_new_tokens": 2}, 400, "empty_prompt"),
    ({"tokens": [[1]], "adapter": "prod"}, 400, "adapter"),
])
def test_engine_backend_refusals(engine_served, payload, status, reason):
    _, base = engine_served
    got, body, headers = _http(base + "/v1/generate", payload)
    assert (got, body["reason"]) == (status, reason)
    assert headers["x-tik-request-id"]
    if reason == "capacity":
        assert "KV blocks" in body["error"]


def test_engine_backend_full_queue_is_429_with_retry_after():
    backend = engine_backend("tiny", slots=1, max_len=32, device="cpu",
                             max_queue_depth=0, dtype=torch.float32)
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    try:
        status, body, headers = _http(
            f"http://127.0.0.1:{server.port}/v1/generate",
            {"tokens": [[1, 2]], "max_new_tokens": 2})
    finally:
        server.stop()
        backend.engine.stop()
    assert status == 429 and body["reason"] == "queue_full"
    assert headers["Retry-After"] == "1"
    assert headers["x-tik-request-id"]


def test_drain_and_stop_finishes_inflight_then_stops_the_engine():
    backend = engine_backend("tiny", slots=1, max_len=64, device="cpu",
                             dtype=torch.float32)
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}/v1/generate"
    engine = backend.engine
    results = []
    worker = threading.Thread(target=lambda: results.append(
        _http(base, {"tokens": [[1, 2, 3]], "max_new_tokens": 40})))
    worker.start()
    drained = []
    try:
        deadline = time.monotonic() + 60
        while not any(s is not None for s in engine._slots):
            assert time.monotonic() < deadline
            time.sleep(0.002)
        drainer = threading.Thread(target=lambda: drained.append(
            drain_and_stop(server, [backend], grace_s=60)))
        drainer.start()
        while not server.draining:
            time.sleep(0.001)
        assert _http(base, {"tokens": [[1]]})[0] == 503
        worker.join(60)
        drainer.join(60)
        assert not worker.is_alive() and not drainer.is_alive()
    finally:
        engine.stop()
    assert results[0][0] == 200 and len(results[0][1]["tokens"][0]) == 40
    assert drained == [True]
    assert not engine._thread.is_alive()
    assert engine.pool.used() == 0


@pytest.mark.parametrize("flag, item", [
    ({"disagg": True}, "A2"), ({"adapters_dir": "/a"}, "A6"),
    ({"checkpoint_dir": "/c"}, "A6"), ({"spec_checkpoint_dir": "/s"}, "A6")])
def test_engine_backend_unported_modes_raise(flag, item):
    """`disagg` (A2) is ported: what raises there are the reference's two
    refusals, `disagg` with a draft model and with adapters (the disagg
    mode itself: tests/test_torch_disagg.py).  The checkpoint flags (A6)
    are: a directory that holds no checkpoint raises when the backend is
    built, and a missing adapter directory fails the request that names
    the adapter."""
    if item == "A2":
        with pytest.raises(ValueError, match="--disagg and --spec-model"):
            engine_backend("tiny", device="cpu", spec_model="tiny", **flag)
        with pytest.raises(ValueError, match="--disagg and --adapters-dir"):
            engine_backend("tiny", device="cpu", adapters_dir="/a", **flag)
        return
    if "adapters_dir" in flag:
        backend = engine_backend("tiny", device="cpu", slots=1, max_len=32,
                                 block_size=8, **flag)
        try:
            with pytest.raises(BackendError, match="no checkpoint"):
                backend.endpoints["generate"]({
                    "tokens": [[1, 2]], "max_new_tokens": 2,
                    "adapter": "t0"})
        finally:
            backend.engine.stop()
        return
    spec = {"spec_model": "tiny"} if "spec_checkpoint_dir" in flag else {}
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        engine_backend("tiny", device="cpu", **flag, **spec)


def test_engine_backend_spec_model_is_a_self_draft_from_seed_zero():
    """`--spec-model` names a preset whose weights come from seed 0, as
    the target's do: the same preset is a self-draft.  Concurrent posts
    speculate and answer what `generate` gives."""
    from cloudtik_tpu_torch.models import generate as TG
    from cloudtik_tpu_torch.telemetry import instruments as ti

    backend = engine_backend("tiny", slots=2, max_len=64, block_size=8,
                             spec_model="tiny", spec_k=3, device="cpu",
                             dtype=torch.float32)
    engine = backend.engine
    assert engine._spec.k == 3
    assert torch.equal(engine._draft_params["layers"]["wq"],
                       backend.params["layers"]["wq"])
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    steps0 = ti.SERVE_SPEC_STEPS.value()
    prompts = [[1, 2, 3], [200, 17, 5, 4, 3]]
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, _http(f"http://127.0.0.1:{server.port}/v1/generate",
                 {"tokens": [prompts[i]], "max_new_tokens": 9})))
        for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        server.stop()
        engine.stop()
    assert not any(t.is_alive() for t in threads)
    for i, prompt in enumerate(prompts):
        status, body, _ = results[i]
        assert status == 200
        assert body["tokens"][0] == TG.generate(
            backend.params, torch.tensor([prompt]), backend.cfg,
            max_new_tokens=9)[0].tolist()
    assert ti.SERVE_SPEC_STEPS.value() - steps0 >= 4
    assert engine.pool.used() == 0


def test_engine_backend_adapter_and_tenant_payload_fields(tmp_path):
    """With an adapter loader, a post naming `"adapter"` decodes on that
    adapter (the tokens of `generate` on the merged weights) and its
    ledger record carries the adapter and the `"tenant"`; an unknown
    adapter fails its request alone (400)."""
    from cloudtik_tpu_torch.models import generate as TG
    from cloudtik_tpu_torch.models import lora as TL
    from cloudtik_tpu_torch.models import transformer as TT
    from cloudtik_tpu_torch.serve import reqlog

    lora_cfg = TL.LoRAConfig(rank=4, alpha=8.0)
    bank = {"t0": TL.random_lora_params(torch.Generator().manual_seed(3),
                                        TT.config("tiny"), lora_cfg,
                                        device="cpu")}
    backend = engine_backend("tiny", slots=2, max_len=32, block_size=8,
                             adapter_loader=bank.__getitem__,
                             adapter_slots=1, lora_rank=4, lora_alpha=8.0,
                             device="cpu", dtype=torch.float32)
    engine = backend.engine
    assert engine._adapters.capacity == 1
    assert engine._adapters.lora_cfg == lora_cfg
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    path = str(tmp_path / "requests.jsonl")
    reqlog.install(path)
    try:
        status, body, _ = _http(url, {"tokens": [[5, 6, 7]],
                                      "max_new_tokens": 5, "adapter": "t0",
                                      "tenant": "acme"})
        bad, bad_body, _ = _http(url, {"tokens": [[5, 6, 7]],
                                       "adapter": "nope"})
        again, _, _ = _http(url, {"tokens": [[5, 6, 7]],
                                  "max_new_tokens": 2})
    finally:
        reqlog.uninstall()
        server.stop()
        engine.stop()
    merged = dict(backend.params, layers=TL.merge_lora(
        backend.params["layers"], bank["t0"], lora_cfg))
    assert status == 200
    assert body["tokens"][0] == TG.generate(
        merged, torch.tensor([[5, 6, 7]]), backend.cfg,
        max_new_tokens=5)[0].tolist()
    assert (bad, again) == (400, 200)
    assert "nope" in bad_body["error"]
    records = reqlog.read_requests(path)
    assert [(r["tenant"], r["adapter_id"]) for r in records] == [
        ("acme", "t0"), ("default", "nope"), ("default", None)]


def test_replica_registration_beats_and_sigterm_deregisters(tmp_path):
    """`tik-serve --engine --disagg --replica-id r0 --state-host ...`
    registers in the replica registry (role `prefill` for the disagg pair,
    its version, its URL, the prefill engine's stats), serves, and on
    SIGTERM drains and leaves the registry before it exits 0."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    from cloudtik_tpu_torch.control.state import (
        InMemoryStateBackend, StateClient, StateServer)
    from cloudtik_tpu_torch.serve.replicas import ReplicaRegistry

    root = Path(__file__).resolve().parents[1]
    store = InMemoryStateBackend()
    state = StateServer(host="127.0.0.1", port=0, backend=store)
    state.start()
    registry = ReplicaRegistry(StateClient(store))
    env = dict(os.environ, PYTHONPATH=str(root),
               TIK_REQLOG_PATH=str(tmp_path / "requests.jsonl"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cloudtik_tpu_torch.serve.server",
         "--engine", "--disagg", "--model", "tiny", "--device", "cpu",
         "--slots", "2", "--max-len", "64", "--block-size", "8",
         "--host", "127.0.0.1", "--port", "0", "--replica-id", "r0",
         "--state-host", "127.0.0.1", "--state-port", str(state.port),
         "--version", "v7", "--drain-grace-s", "10"],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        deadline = time.monotonic() + 120
        while not registry.list_replicas():
            assert proc.poll() is None, "the server exited early"
            assert time.monotonic() < deadline, "never registered"
            time.sleep(0.05)
        (info,) = registry.list_replicas()
        assert (info.replica_id, info.role, info.version) == (
            "r0", "prefill", "v7")
        assert info.stats["slots"] == 2 and not info.draining
        status, body, _ = _http(f"{info.url}/v1/generate", {
            "tokens": [[1, 2, 3]], "max_new_tokens": 3})
        assert status == 200 and len(body["tokens"][0]) == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert registry.list_replicas() == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        state.stop()
