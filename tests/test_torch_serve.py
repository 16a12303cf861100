"""Port parity: the port's `tik-serve` non-engine server vs the JAX backend.

The port's server, given parameters converted from the JAX
`init_params(PRNGKey(0), tiny)`, answers /v1/generate with the tokens of
the JAX `transformer_backend("tiny")` (both in fp32, greedy), and keeps the
JAX server's health, model list, error and drain behaviour.
"""

import json
import threading
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
    BackendError, ModelBackend, ServeServer, transformer_backend)

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


def test_checkpoint_dir_is_not_supported_yet():
    with pytest.raises(NotImplementedError, match="checkpoint"):
        transformer_backend("tiny", checkpoint_dir="/nonexistent",
                            device="cpu")


def test_backend_without_params_inits_from_seed_zero():
    a = transformer_backend("tiny", device="cpu")
    b = transformer_backend("tiny", device="cpu")
    assert torch.equal(a.params["layers"]["wq"], b.params["layers"]["wq"])
    out = a.endpoints["generate"]({"tokens": [[4, 5]],
                                   "max_new_tokens": 3})
    assert np.asarray(out["tokens"]).shape == (1, 3)
