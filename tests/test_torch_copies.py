"""The port's copies of the JAX package's jax-free host modules.

The serving engine, the cluster runtimes (the AI and serving runtimes'
base classes, discovery, the installer), the GCP provider (the provider
base class, the REST and Compute clients, the command executors the base
class builds), the scrape path (the telemetry HTTP server, the prometheus
runtime with its collector, windows, alerts and SLO engine, the node
exporter, the scaling policies), every other built-in runtime with its
helpers and delivery, the port's CLI and the control plane (the node
agent with its native sampler and state server, the log agent, the
updater, the launcher, the demand scheduler, quorum and membership, the
scaler, the controller, the cluster operator, the provider factory, the
virtual provider and GCP's load balancer) and the operator surface (the
config pipeline, the public API, node services, cluster dumps,
workspaces, proxies, chaos drills and the whole CLI) and the other
providers (local hosts, an on-premise pool, GCP's workspace, storage and
database, AWS, Azure, Alibaba Cloud, Huawei Cloud and Kubernetes) reach
these modules at run time,
and the port keeps its own copies of them (it imports nothing of the JAX
package): each is the reference's source with `cloudtik_tpu` imports
renamed to `cloudtik_tpu_torch`, and nothing else changed but the lines
`ALLOWED_DIFFERENCES` names.  The templates are the reference's bytes,
but for the TPU slice templates, which the port ships as their A3
counterparts (`TEMPLATE_COUNTERPARTS`).  Through them the port engine emits the
reference's `tik_serve_*` metrics and writes request records that the JAX
package's ledger reader takes as its own.
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
    # every other built-in runtime, their common helpers, delivery, and
    # the CLI's package and logger
    "scripts/__init__.py",
    "runtimes/apisix/__init__.py", "runtimes/apisix/runtime.py",
    "runtimes/bind/__init__.py", "runtimes/bind/runtime.py",
    "runtimes/consul/__init__.py", "runtimes/consul/runtime.py",
    "runtimes/coredns/__init__.py", "runtimes/coredns/runtime.py",
    "runtimes/dns/__init__.py", "runtimes/dns/records.py",
    "runtimes/dnsmasq/__init__.py", "runtimes/dnsmasq/runtime.py",
    "runtimes/elasticsearch/__init__.py", "runtimes/elasticsearch/runtime.py",
    "runtimes/etcd/__init__.py", "runtimes/etcd/runtime.py",
    "runtimes/flink/__init__.py", "runtimes/flink/runtime.py",
    "runtimes/grafana/__init__.py", "runtimes/grafana/dashboards.py",
    "runtimes/grafana/runtime.py", "runtimes/haproxy/__init__.py",
    "runtimes/haproxy/runtime.py", "runtimes/hdfs/__init__.py",
    "runtimes/hdfs/runtime.py", "runtimes/kafka/__init__.py",
    "runtimes/kafka/runtime.py", "runtimes/kong/__init__.py",
    "runtimes/kong/runtime.py", "runtimes/loadbalancer/__init__.py",
    "runtimes/loadbalancer/runtime.py", "runtimes/loadbalancer/sync.py",
    "runtimes/metastore/__init__.py", "runtimes/metastore/runtime.py",
    "runtimes/minio/__init__.py", "runtimes/minio/runtime.py",
    "runtimes/mlflow/__init__.py", "runtimes/mlflow/runtime.py",
    "runtimes/mongodb/__init__.py", "runtimes/mongodb/runtime.py",
    "runtimes/mount/__init__.py", "runtimes/mount/runtime.py",
    "runtimes/mysql/__init__.py", "runtimes/mysql/runtime.py",
    "runtimes/nginx/__init__.py", "runtimes/nginx/runtime.py",
    "runtimes/pgbouncer/__init__.py", "runtimes/pgbouncer/runtime.py",
    "runtimes/pgpool/__init__.py", "runtimes/pgpool/runtime.py",
    "runtimes/postgres/__init__.py", "runtimes/postgres/runtime.py",
    "runtimes/presto/__init__.py", "runtimes/presto/runtime.py",
    "runtimes/ray/__init__.py", "runtimes/ray/runtime.py",
    "runtimes/redis/__init__.py", "runtimes/redis/runtime.py",
    "runtimes/spark/__init__.py", "runtimes/spark/runtime.py",
    "runtimes/sshserver/__init__.py", "runtimes/sshserver/runtime.py",
    "runtimes/trino/__init__.py", "runtimes/trino/runtime.py",
    "runtimes/xinetd/__init__.py", "runtimes/xinetd/runtime.py",
    "runtimes/yarn/__init__.py", "runtimes/yarn/runtime.py",
    "runtimes/zookeeper/__init__.py", "runtimes/zookeeper/runtime.py",
    "runtimes/common/active_standby.py", "runtimes/common/discovery_client.py",
    "runtimes/common/failover.py", "runtimes/common/health_check.py",
    "runtimes/common/leader_election.py", "runtimes/common/lock.py",
    "runtimes/delivery.py", "core/load_balancer_provider.py",
    "utils/cli_logger.py",
    # the control plane's daemons, bottom-up, and the providers beneath
    "config/hashing.py", "utils/concurrent_cache.py",
    "utils/event_summarizer.py", "utils/call_context.py",
    "native/__init__.py", "control/metrics.py", "control/membership.py",
    "control/node_availability.py", "control/job_waiters.py",
    "control/demand.py", "control/quorum.py", "control/node_agent.py",
    "control/log_agent.py", "control/updater.py", "control/launcher.py",
    "control/scaler.py", "control/controller.py",
    "control/cluster_operator.py", "core/workspace_provider.py",
    "providers/factory.py", "providers/virtual/__init__.py",
    "providers/virtual/node_provider.py",
    "providers/virtual/workspace_provider.py",
    "providers/gcp/load_balancer_provider.py",
    # the operator surface: the lifecycle's helpers, the config pipeline,
    # the public API, node services, dumps, workspaces, proxies, chaos
    # drills and the whole CLI
    "utils/event_system.py", "utils/log_timer.py", "utils/fate_sharing.py",
    "config/crypto.py", "config/schema.py", "config/loader.py",
    "config/__init__.py", "core/storage_provider.py",
    "core/database_provider.py", "core/api.py", "control/services.py",
    "control/cluster_dump.py", "control/workspace_operator.py",
    "control/proxy.py", "faults/chaos.py", "scripts/cli.py",
    # the other providers: local hosts, an on-premise pool, GCP's
    # workspace, storage and database, the other clouds and Kubernetes
    "providers/local/__init__.py", "providers/local/node_provider.py",
    "providers/onpremise/__init__.py", "providers/onpremise/node_provider.py",
    "providers/onpremise/simulator.py", "providers/gcp/database_provider.py",
    "providers/gcp/storage_provider.py", "providers/gcp/workspace_provider.py",
    "providers/aws/__init__.py", "providers/aws/config.py",
    "providers/aws/database_provider.py",
    "providers/aws/load_balancer_provider.py",
    "providers/aws/node_provider.py", "providers/aws/storage_provider.py",
    "providers/aws/workspace_provider.py", "providers/azure/__init__.py",
    "providers/azure/database_provider.py",
    "providers/azure/load_balancer_provider.py",
    "providers/azure/node_provider.py", "providers/azure/storage_provider.py",
    "providers/azure/workspace_provider.py", "providers/aliyun/__init__.py",
    "providers/aliyun/database_provider.py",
    "providers/aliyun/load_balancer_provider.py",
    "providers/aliyun/node_provider.py",
    "providers/aliyun/storage_provider.py",
    "providers/aliyun/workspace_provider.py",
    "providers/huaweicloud/__init__.py",
    "providers/huaweicloud/database_provider.py",
    "providers/huaweicloud/load_balancer_provider.py",
    "providers/huaweicloud/node_provider.py",
    "providers/huaweicloud/storage_provider.py",
    "providers/huaweicloud/workspace_provider.py",
    "providers/kubernetes/__init__.py", "providers/kubernetes/cloud.py",
    "providers/kubernetes/manifests.py",
    "providers/kubernetes/node_provider.py",
    "providers/kubernetes/operator.py",
)
# sources the copies build at run time: the same bytes (they name no
# package)
BYTE_COPIES = ("native/host_agent.cpp", "native/state_server.cpp")
# (copy, line in the port) -> why it differs from the reference
_ONE_GPU = ("the serve-demand policy asks one GPU a replica by default: the "
            "port's serving runtime starts one tik-serve per card, and no "
            "H100 host advertises TPU")
ALLOWED_DIFFERENCES = {
    ("control/scaling_policies.py", 140): _ONE_GPU,
    ("control/scaling_policies.py", 161): _ONE_GPU,
    ("runtimes/prometheus/trace_collector.py", 28): (
        "the port's serving process serves its spans at /trace under the "
        "job serving-telemetry (runtimes/serving/runtime.py), where the "
        "reference's serve spans come from the head's telemetry job"),
}
_ONE_ENDPOINT = (
    "the node-services process serves its registry through the serving "
    "runtime's serve_process_telemetry, so a ServingRuntime it starts "
    "serves no serving-telemetry endpoint of its own beside the head's "
    "telemetry job: one answered request is one set of serve spans and "
    "one count at the cluster's scrape")
_TORCH_JOURNAL = (
    "a dump also takes the port's events-torch.jsonl, the journal a "
    "serving process without node services writes "
    "(runtimes/serving/runtime.py journal_path), beside the default one")
_SPAN_DURATION = (
    "a finished span keeps its duration as `dur`, so the port's decode "
    "engine splits a step's time into busy and idle lanes on the span's "
    "own clock instead of a second perf_counter pair")
ALLOWED_DIFFERENCES.update({
    ("telemetry/core.py", 491): _SPAN_DURATION,
    ("telemetry/core.py", 522): _SPAN_DURATION,
    ("control/services.py", 177): _ONE_ENDPOINT,
    ("control/services.py", 178): _ONE_ENDPOINT,
    **{("control/cluster_dump.py", line): _TORCH_JOURNAL
       for line in range(52, 57)},
})
# The reference's templates the port ships with other contents: the TPU
# slice templates, whose node types the port's GCP provider refuses
# (providers/gcp/config.py bootstrap_gcp), each with its A3 counterpart in
# the same role (providers/gcp/gpu.py GPU_MACHINES)
TEMPLATE_COUNTERPARTS = {
    "gcp/tpu-v5e-small.yaml": "gcp/h100-1g-small.yaml",
    "gcp/tpu-v5p-small.yaml": "gcp/h100-small.yaml",
    "gcp/tpu-v5p-pod.yaml": "gcp/h100-pod.yaml",
}
TEMPLATES = sorted(
    str(p.relative_to(ROOT / "cloudtik_tpu" / "templates"))
    for p in (ROOT / "cloudtik_tpu" / "templates").glob("*/*.yaml"))


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


@pytest.mark.parametrize("path", TEMPLATES)
def test_template_is_the_references_or_its_a3_counterpart(path):
    ref = (ROOT / "cloudtik_tpu" / "templates" / path).read_text()
    port = ROOT / "cloudtik_tpu_torch" / "templates"
    if path in TEMPLATE_COUNTERPARTS:
        assert not (port / path).exists()
        assert "machineType: a3-" in (
            port / TEMPLATE_COUNTERPARTS[path]).read_text()
    else:
        assert (port / path).read_text() == ref
    shipped = sorted(str(p.relative_to(port))
                     for p in port.glob("*/*.yaml"))
    assert shipped == sorted(TEMPLATE_COUNTERPARTS.get(p, p)
                             for p in TEMPLATES)


@pytest.mark.parametrize("path", BYTE_COPIES)
def test_native_source_is_the_references_byte_for_byte(path):
    want = (ROOT / "cloudtik_tpu" / path).read_bytes()
    assert (ROOT / "cloudtik_tpu_torch" / path).read_bytes() == want
    assert b"cloudtik_tpu" not in want


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
