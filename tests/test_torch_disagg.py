"""Port parity: cloudtik_tpu_torch.serve.disagg (`DisaggServing`) and
`tik-serve --engine --disagg`, against the JAX package's.

`tiny` in fp32 on the CPU, one intra-op thread, parameters from the JAX
`init_params(PRNGKey(0))`.  The same requests go through the port's
prefill/decode pair and the JAX one: the greedy tokens are equal to each
other and to the port's monolithic `generate`, and so are the migration
and prefix counts.  A transfer torn by a planted `serve.kvcache.migrate`
fault falls back to a plain submit on the decode role and still answers
right.  Every wait is bounded.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve import disagg as JD
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import disagg as TD
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.serve import reqlog as TR
from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend
from cloudtik_tpu_torch.telemetry import instruments as ti

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference",
                 remat=False)
TCFG = TT.config("tiny", dtype=torch.float32)
WAIT = 60          # seconds: every wait is bounded
EC = dict(slots=2, max_len=96, prefill_buckets=(8, 16), block_size=8)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _reference(tp, prompt, max_new):
    return TG.generate(tp, torch.tensor([prompt]), TCFG,
                       max_new_tokens=max_new)[0].tolist()


def _pair(M, params, prefill=EC, decode=EC):
    jp, tp = params
    if M is JD:
        pair = JD.DisaggServing(jp, JCFG, JE.EngineConfig(**prefill),
                                JE.EngineConfig(**decode))
    else:
        pair = TD.DisaggServing(tp, TCFG, TE.EngineConfig(**prefill),
                                TE.EngineConfig(**decode), device="cpu")
    pair.start()
    return pair


@pytest.fixture(scope="module")
def pairs(params):
    made = {M: _pair(M, params) for M in (JD, TD)}
    yield made
    for pair in made.values():
        pair.stop()


def _done(req):
    return {"tokens": req.wait(timeout=WAIT),
            "migrations": req.migrations,
            "migrated_tokens": req.migrated_tokens,
            "prefix_tokens": req.prefix_tokens,
            "multi_chunk": req.prefill_chunks >= 2}


# -- scenarios: each takes the engine module and a pair, returns what it
#    observed; the test holds JAX's and the port's observations equal --

def sc_single(E, pair):
    return [_done(pair.submit(E.Request([5, 17, 101, 9],
                                        max_new_tokens=8)))]


def sc_multi_chunk(E, pair):
    prompt = [((i * 37) % 250) + 1 for i in range(40)]
    return [_done(pair.submit(E.Request(prompt, max_new_tokens=8)))]


def sc_prefix_reuse(E, pair):
    """Identical then extended prompts: the second hits the prefill
    role's prefix cache (its exported blocks park on its LRU)."""
    prompt = [((i * 13) % 250) + 1 for i in range(24)]
    out = [_done(pair.submit(E.Request(prompt, max_new_tokens=6)))]
    out.append(_done(pair.submit(E.Request(prompt, max_new_tokens=6))))
    out.append(_done(pair.submit(E.Request(prompt + [7, 8, 9],
                                           max_new_tokens=6))))
    assert out[1]["prefix_tokens"] > 0
    return out


def sc_concurrent(E, pair):
    prompts = [[1, 2, 3], [42, 7, 19, 23, 88, 4, 11],
               [((i * 11) % 250) + 1 for i in range(20)]]
    reqs = [pair.submit(E.Request(p, max_new_tokens=10)) for p in prompts]
    return [_done(r) for r in reqs]


SCENARIOS = {"single": sc_single, "multi_chunk": sc_multi_chunk,
             "prefix_reuse": sc_prefix_reuse, "concurrent": sc_concurrent}
PROMPTS = {"single": [([5, 17, 101, 9], 8)],
           "multi_chunk": [([((i * 37) % 250) + 1 for i in range(40)], 8)],
           "prefix_reuse": [
               ([((i * 13) % 250) + 1 for i in range(24)], 6)] * 2 + [
               ([((i * 13) % 250) + 1 for i in range(24)] + [7, 8, 9], 6)],
           "concurrent": [([1, 2, 3], 10),
                          ([42, 7, 19, 23, 88, 4, 11], 10),
                          ([((i * 11) % 250) + 1 for i in range(20)], 10)]}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_equal_the_monolith_and_the_jax_pair(pairs, params, name):
    got = SCENARIOS[name](TE, pairs[TD])
    want = SCENARIOS[name](JE, pairs[JD])
    assert got == want
    for obs, (prompt, new) in zip(got, PROMPTS[name]):
        assert obs["tokens"] == _reference(params[1], prompt, new)
        assert obs["migrations"] == 1
        assert obs["migrated_tokens"] == len(prompt)


def test_prefill_role_charges_prompt_only_footprint(params):
    """A long-OUTPUT request is admitted through a prefill pool smaller
    than its worst case, while a request the DECODE role can never hold
    rejects at submit (HTTP 413's reason)."""
    pair = _pair(TD, params, prefill=dict(EC, max_len=64, num_blocks=5),
                 decode=dict(EC, max_len=64))
    try:
        prompt = list(range(1, 17))
        req = pair.submit(TE.Request(prompt, max_new_tokens=40))
        assert req.wait(timeout=WAIT) == _reference(params[1], prompt, 40)
        bad = pair.submit(TE.Request([1, 2, 3], max_new_tokens=500))
        with pytest.raises(TE.RequestRejected) as exc:
            bad.wait(timeout=WAIT)
        assert exc.value.reason == "capacity"
    finally:
        pair.stop()
    assert pair.prefill.pool.used() == 0 and pair.decode.pool.used() == 0


def test_torn_transfer_falls_back_to_the_decode_role(params, tmp_path):
    """A fault after the first block frame tears the transfer: the
    request re-prefills as a plain submit on the decode role, answers
    right, finishes `done` once in the ledger, and leaks no block."""
    pair = _pair(TD, params)
    path = str(tmp_path / "requests.jsonl")
    TR.install(path)
    failures0 = ti.SERVE_KV_MIGRATION_FAILURES.value()
    prompt = [((i * 29) % 250) + 1 for i in range(24)]
    plan = FaultPlan([FaultPoint("serve.kvcache.migrate", "raise",
                                 at_call=2, times=1)])
    try:
        with seams.armed(plan):
            req = pair.submit(TE.Request(prompt, max_new_tokens=6))
            out = req.wait(timeout=WAIT)
        assert plan.points[0].fired == 1
        assert out == _reference(params[1], prompt, 6)
        assert req.error is None and req.migrations == 0
        assert ti.SERVE_KV_MIGRATION_FAILURES.value() == failures0 + 1
    finally:
        TR.uninstall()
        pair.stop()
    assert pair.prefill.pool.used() == 0 and pair.decode.pool.used() == 0
    records = TR.read_requests(path)
    assert [r["finish"] for r in records] == ["done"]
    assert records[0]["migrations"] == 0


def test_pools_fully_free_after_stop(params):
    pair = _pair(TD, params, prefill=dict(EC, max_len=64,
                                          prefill_buckets=(8,)),
                 decode=dict(EC, max_len=64, prefill_buckets=(8,)))
    reqs = [pair.submit(TE.Request([i + 1] * 6, max_new_tokens=30))
            for i in range(4)]
    deadline = threading.Event()
    for _ in range(500):
        if reqs[0].tokens:
            break
        deadline.wait(0.01)
    reqs[0].cancel()
    pair.stop()
    for req in reqs:
        assert req._done.is_set()
    assert pair.prefill.pool.used() == 0 and pair.decode.pool.used() == 0


def test_disagg_backend_over_http(params, tmp_path):
    """`tik-serve --engine --disagg` end to end: the monolith's tokens and
    the request-id header over HTTP, ledger records of one migration,
    and the admission bound on the prefill role, where requests arrive."""
    backend = engine_backend("tiny", slots=2, max_len=64, block_size=8,
                             disagg=True, prefill_slots=2,
                             max_queue_depth=4, device="cpu",
                             params=jax.tree.map(np.asarray, params[0]),
                             dtype=torch.float32)
    assert backend.name == "transformer-engine-disagg:tiny"
    pair = backend.engine
    assert isinstance(pair, TD.DisaggServing)
    assert (pair.prefill.ec.slots, pair.decode.ec.slots) == (2, 2)
    assert pair.prefill.ec.max_queue_depth == 4
    assert pair.decode.ec.max_queue_depth is None
    assert (pair.prefill._role, pair.decode._role) == ("prefill", "decode")
    server = ServeServer([backend], host="127.0.0.1")
    server.start()
    path = str(tmp_path / "requests.jsonl")
    TR.install(path)
    try:
        body = json.dumps({"tokens": [[1, 2, 3]],
                           "max_new_tokens": 4}).encode()
        r = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=WAIT) as resp:
            payload = json.loads(resp.read())
            assert resp.headers.get("x-tik-request-id")
        assert payload["tokens"][0] == _reference(params[1], [1, 2, 3], 4)
    finally:
        TR.uninstall()
        server.stop()
        pair.stop()
    # the prefill role's "migrated" milestone, then the finishing record
    milestone, record = TR.read_requests(path)
    assert (milestone["finish"], record["finish"]) == ("migrated", "done")
    assert (record["migrations"], record["migrated_tokens"]) == (1, 3)
