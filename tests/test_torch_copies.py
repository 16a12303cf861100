"""The port's copies of the JAX package's jax-free host modules.

The serving engine, the cluster runtimes (the AI and serving runtimes'
base classes, discovery, the installer), the GCP provider (the provider
base class, the REST and Compute clients, the command executors the base
class builds) and the scrape path (the telemetry HTTP server, the
prometheus runtime with its collector, windows, alerts and SLO engine, the
node exporter, the scaling policies) reach these modules at run time, and
the port keeps its own copies of them (it imports nothing of the JAX
package): each is the reference's source with `cloudtik_tpu` imports
renamed to `cloudtik_tpu_torch`, and nothing else changed but the lines
`ALLOWED_DIFFERENCES` names.  Through them the port
engine emits the reference's `tik_serve_*` metrics and writes request
records that the JAX package's ledger reader takes as its own.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu.serve import reqlog as JR
from cloudtik_tpu.telemetry import core as JC
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.serve import reqlog as TR
from cloudtik_tpu_torch.telemetry import core as TC

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COPIES = (
    "utils/constants.py", "faults/__init__.py", "faults/plan.py",
    "faults/seams.py", "telemetry/names.py", "telemetry/core.py",
    "telemetry/export.py", "telemetry/__init__.py",
    "telemetry/instruments.py", "telemetry/events.py",
    "telemetry/goodput.py", "serve/kvcache.py", "serve/reqlog.py",
    "utils/retry.py", "control/state.py", "serve/replicas.py",
    "serve/routerlog.py", "serve/router.py", "serve/fabric.py",
    "serve/explain.py", "core/runtime.py", "core/job_waiter.py",
    "core/scaling_policy.py", "core/tags.py", "runtimes/installer.py",
    "runtimes/common/runtime_base.py", "runtimes/common/process_runner.py",
    "runtimes/discovery/runtime.py", "runtimes/discovery/sync.py",
    "runtimes/ai/data.py", "core/node_provider.py",
    "providers/__init__.py", "providers/gcp/__init__.py",
    "providers/gcp/rest.py", "providers/gcp/compute.py",
    "control/executor/__init__.py", "control/executor/base.py",
    "control/executor/factory.py", "control/executor/ssh.py",
    "control/executor/docker.py", "control/executor/local.py",
    "control/executor/kubernetes.py", "utils/subprocess_output.py",
    "telemetry/http.py", "runtimes/prometheus/__init__.py",
    "runtimes/prometheus/runtime.py", "runtimes/prometheus/windows.py",
    "runtimes/prometheus/alerts.py", "telemetry/slo.py",
    "runtimes/prometheus/collector.py",
    "runtimes/prometheus/trace_collector.py", "runtimes/nodex/__init__.py",
    "runtimes/nodex/runtime.py", "runtimes/nodex/exporter.py",
    "control/scaling_policies.py", "train/tokenizer.py",
)
# (copy, line in the port) -> why it differs from the reference
_ONE_GPU = ("the serve-demand policy asks one GPU a replica by default: the "
            "port's serving runtime starts one tik-serve per card, and no "
            "H100 host advertises TPU")
ALLOWED_DIFFERENCES = {
    ("control/scaling_policies.py", 140): _ONE_GPU,
    ("control/scaling_policies.py", 161): _ONE_GPU,
}


def _renamed(text):
    return re.sub(r"\bcloudtik_tpu\b", "cloudtik_tpu_torch", text)


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_reference_with_its_imports_renamed(path):
    want = _renamed((ROOT / "cloudtik_tpu" / path).read_text()).splitlines()
    got = (ROOT / "cloudtik_tpu_torch" / path).read_text().splitlines()
    assert len(got) == len(want)
    differing = {(path, i + 1): line for i, (line, ref)
                 in enumerate(zip(got, want)) if line != ref}
    assert set(differing) <= set(ALLOWED_DIFFERENCES), differing


def test_executors_propagate_the_references_cache_variable():
    """The copied executor base exports `compile_cache.CACHE_DIR_ENV` into
    every remote command; the port's compile_cache is its own module (it
    points the kernel build, not XLA's cache) but names the same
    variable, so the copy needs no difference."""
    from cloudtik_tpu.utils import compile_cache as JCC
    from cloudtik_tpu_torch.control.executor import base
    from cloudtik_tpu_torch.utils import compile_cache as TCC

    assert base.compile_cache is TCC
    assert TCC.CACHE_DIR_ENV == JCC.CACHE_DIR_ENV == "TIK_COMPILE_CACHE_DIR"


JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference",
                 remat=False)
TCFG = TT.config("tiny", dtype=torch.float32)
EC = dict(slots=2, max_len=64, prefill_buckets=(8, 16), block_size=8)
# a 20-token prompt: two prefill chunks, and a prefix hit when repeated
PROMPT = [((i * 13) % 250) + 1 for i in range(20)]


@pytest.fixture(scope="module")
def engines():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {JE: JE.DecodeEngine(jp, JCFG, JE.EngineConfig(**EC)),
            TE: TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**EC),
                                device="cpu")}


@pytest.fixture
def telemetry_on():
    was = (JC.STATE.enabled, TC.STATE.enabled)
    for core in (JC, TC):
        core.enable()
        core.reset()
    try:
        yield
    finally:
        for core, on in zip((JC, TC), was):
            core.STATE.enabled = on


def _serve(M, eng, n=1):
    eng.start()
    try:
        return [eng.submit(M.Request(PROMPT, max_new_tokens=5)).wait(
            timeout=60) for _ in range(n)]
    finally:
        eng.stop()


def test_engines_emit_the_same_serve_metric_names(engines, telemetry_on):
    names = {}
    for M, core in ((JE, JC), (TE, TC)):
        _serve(M, engines[M])
        names[M] = {inst.name for inst in core.REGISTRY.instruments()
                    if inst.name.startswith("tik_serve_")
                    and inst.samples()}
    assert names[TE] == names[JE]
    assert {"tik_serve_requests_total", "tik_serve_ttft_seconds",
            "tik_serve_tokens_generated_total",
            "tik_serve_prefill_chunks_total"} <= names[TE]


def test_port_request_records_read_back_through_the_jax_reader(
        tmp_path, telemetry_on):
    """Two requests for one prompt (the second a prefix hit) through each
    engine, each writing its own package's ledger; the JAX reader reads
    both, and the port's records carry the same fields and values."""
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    records = {}
    for M, R, eng in (
            (JE, JR, JE.DecodeEngine(jp, JCFG, JE.EngineConfig(**EC))),
            (TE, TR, TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**EC),
                                     device="cpu"))):
        path = str(tmp_path / f"{M.__name__}.jsonl")
        R.install(path)
        try:
            _serve(M, eng, n=2)
        finally:
            R.uninstall()
        records[M] = JR.read_requests(path)
    got, want = records[TE], records[JE]
    assert len(got) == len(want) == 2
    same = ("finish", "tenant", "adapter_id", "bucket", "prompt_tokens",
            "output_tokens", "kv_blocks", "prefix_blocks", "prefix_tokens",
            "prefill_chunks", "preemptions", "migrations", "spec_steps")
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: g[k] for k in same} == {k: w[k] for k in same}
        assert {k for k in JR.RECORD_FIELDS if g.get(k) is None} == \
            {k for k in JR.RECORD_FIELDS if w.get(k) is None}
        for phase in ("queue_wait_s", "ttft_s", "tpot_s", "router_wait_s",
                      "prefill_s", "decode_rest_s"):
            assert g[phase] is not None and g[phase] >= 0
    assert [g["prefill_chunks"] for g in got] == [2, 1]
    assert [g["prefix_tokens"] for g in got] == [0, 16]
    assert JR.compute_stats(got)["count"] == 2
