"""The registry instruments — every in-process metric, created once.

Instrument construction is driven by the catalog (telemetry/names.py):
each registry-sourced MetricSpec becomes exactly one module attribute
here, so emit sites import a concrete object (`ti.SERVE_TTFT.observe(x)`)
and the name checker can diff `REGISTRY` against the catalog.
"""

from __future__ import annotations

from cloudtik_tpu_torch.telemetry.core import (
    Counter, Gauge, Histogram, Instrument, REGISTRY)
from cloudtik_tpu_torch.telemetry.names import METRICS


def _build(name: str) -> Instrument:
    spec = METRICS[name]
    if spec.source != "registry":
        raise ValueError(f"{name} is an external metric, not an "
                         "in-process instrument")
    if spec.kind == "counter":
        return REGISTRY.counter(spec.name, spec.help, spec.labels)
    if spec.kind == "gauge":
        return REGISTRY.gauge(spec.name, spec.help, spec.labels)
    if spec.kind == "histogram":
        return REGISTRY.histogram(spec.name, spec.help, spec.labels,
                                  spec.buckets)
    raise ValueError(f"{name}: unknown kind {spec.kind!r}")


# providers / control plane
GCP_REST_REQUESTS: Counter = _build("tik_gcp_rest_requests_total")
GCP_REST_LATENCY: Histogram = _build("tik_gcp_rest_latency_seconds")
NODE_LAUNCHES: Counter = _build("tik_node_launches_total")
NODE_LAUNCH_FAILURES: Counter = _build("tik_node_launch_failures_total")
SCALER_RECONCILES: Counter = _build("tik_scaler_reconcile_total")
SCALER_RECONCILE_SECONDS: Histogram = _build("tik_scaler_reconcile_seconds")
SCALER_TERMINATIONS: Counter = _build("tik_scaler_terminations_total")
SCALER_RECOVERIES: Counter = _build("tik_scaler_recoveries_total")
NODE_UPDATES: Counter = _build("tik_node_updates_total")
UPDATER_PHASE_SECONDS: Histogram = _build("tik_updater_phase_seconds")
EXECUTOR_RUNS: Counter = _build("tik_executor_runs_total")
EXECUTOR_RUN_SECONDS: Histogram = _build("tik_executor_run_seconds")
HEARTBEATS_PUBLISHED: Counter = _build("tik_heartbeats_published_total")
DISCOVERY_SYNCS: Counter = _build("tik_discovery_sync_total")

# train
CHECKPOINT_SAVES: Counter = _build("tik_checkpoint_saves_total")
CHECKPOINT_SAVE_SECONDS: Histogram = _build("tik_checkpoint_save_seconds")
CHECKPOINT_D2H_SECONDS: Histogram = _build("tik_checkpoint_d2h_seconds")
CHECKPOINT_RESTORE_SECONDS: Histogram = _build(
    "tik_checkpoint_restore_seconds")
TRAIN_STEPS: Counter = _build("tik_train_steps_total")
TRAIN_STEP_SECONDS: Histogram = _build("tik_train_step_seconds")
TRAIN_TOKENS_PER_SEC: Gauge = _build("tik_train_tokens_per_sec")
TRAIN_MFU: Gauge = _build("tik_train_mfu")

# serve
SERVE_REQUESTS: Counter = _build("tik_serve_requests_total")
SERVE_QUEUE_WAIT: Histogram = _build("tik_serve_queue_wait_seconds")
SERVE_TTFT: Histogram = _build("tik_serve_ttft_seconds")
SERVE_TPOT: Histogram = _build("tik_serve_tpot_seconds")
SERVE_TOKENS: Counter = _build("tik_serve_tokens_generated_total")
SERVE_ACTIVE_SLOTS: Gauge = _build("tik_serve_active_slots")
SERVE_QUEUE_DEPTH: Gauge = _build("tik_serve_queue_depth")

# serve paged KV cache (serve/kvcache.py + chunked prefill scheduler)
SERVE_KV_POOL_UTILIZATION: Gauge = _build("tik_serve_kv_pool_utilization")
SERVE_KV_BLOCKS_IN_USE: Gauge = _build("tik_serve_kv_blocks_in_use")
SERVE_PREFIX_HITS: Counter = _build("tik_serve_prefix_cache_hits_total")
SERVE_PREFIX_TOKENS_SAVED: Counter = _build(
    "tik_serve_prefix_cache_tokens_saved_total")
SERVE_PREFILL_CHUNKS: Counter = _build("tik_serve_prefill_chunks_total")
SERVE_PREFILL_PENDING: Gauge = _build("tik_serve_prefill_pending_tokens")
SERVE_PREEMPTIONS: Counter = _build("tik_serve_preemptions_total")
SERVE_PREEMPTED_TOKENS: Counter = _build(
    "tik_serve_preempted_tokens_total")

# serve KV-block migration (serve/migration.py + disaggregated roles)
SERVE_KV_MIGRATIONS: Counter = _build("tik_serve_kv_migrations_total")
SERVE_KV_MIGRATED_TOKENS: Counter = _build(
    "tik_serve_kv_migrated_tokens_total")
SERVE_KV_MIGRATION_FAILURES: Counter = _build(
    "tik_serve_kv_migration_failures_total")

# serve multi-replica router (serve/router.py + serve/replicas.py)
SERVE_ROUTER_REQUESTS: Counter = _build("tik_serve_router_requests_total")
SERVE_ROUTER_FAILOVERS: Counter = _build(
    "tik_serve_router_failovers_total")
SERVE_ROUTER_SPILLS: Counter = _build("tik_serve_router_spills_total")
SERVE_ROUTER_AFFINITY_HITS: Counter = _build(
    "tik_serve_router_affinity_hits_total")
SERVE_ROUTER_REPLICAS: Gauge = _build("tik_serve_router_replicas")
SERVE_ROUTER_INFLIGHT: Gauge = _build("tik_serve_router_inflight")
SERVE_ROUTER_PROBE_FAILURES: Counter = _build(
    "tik_serve_router_probe_failures_total")
SERVE_REPLICA_TARGET: Gauge = _build("tik_serve_replica_target")

# role-aware serving fabric (serve/fabric.py + the router's role path)
SERVE_FABRIC_REQUESTS: Counter = _build(
    "tik_serve_fabric_requests_total")
SERVE_FABRIC_HANDOFF_SECONDS: Histogram = _build(
    "tik_serve_fabric_handoff_seconds")
SERVE_PHASE_SECONDS: Histogram = _build("tik_serve_phase_seconds")

# serve multi-tenant LoRA (serve/adapters.py pool + tenant SLO substrate)
SERVE_TENANT_REQUESTS: Counter = _build("tik_serve_tenant_requests_total")
SERVE_TENANT_TTFT: Histogram = _build("tik_serve_tenant_ttft_seconds")
SERVE_TENANT_TPOT: Histogram = _build("tik_serve_tenant_tpot_seconds")
SERVE_TENANT_QUEUE_DEPTH: Gauge = _build("tik_serve_tenant_queue_depth")
SERVE_ADAPTERS_RESIDENT: Gauge = _build("tik_serve_adapters_resident")
SERVE_ADAPTER_LOADS: Counter = _build("tik_serve_adapter_loads_total")
SERVE_ADAPTER_EVICTIONS: Counter = _build(
    "tik_serve_adapter_evictions_total")

# serve speculative decoding (EngineConfig.spec draft/verify loop)
SERVE_SPEC_DRAFT_TOKENS: Counter = _build(
    "tik_serve_spec_draft_tokens_total")
SERVE_SPEC_ACCEPTED_TOKENS: Counter = _build(
    "tik_serve_spec_accepted_tokens_total")
SERVE_SPEC_STEPS: Counter = _build("tik_serve_spec_verify_steps_total")
SERVE_SPEC_ACCEPTANCE: Gauge = _build("tik_serve_spec_acceptance_rate")
SERVE_SPEC_TOKENS_PER_VERIFY: Gauge = _build(
    "tik_serve_spec_tokens_per_verify")

# elastic multislice training (train/elastic.py re-mesh loop)
ELASTIC_SLICES: Gauge = _build("tik_elastic_slices")
ELASTIC_REMESHES: Counter = _build("tik_elastic_remesh_total")
ELASTIC_REMESH_SECONDS: Histogram = _build("tik_elastic_remesh_seconds")

# goodput ledger / step profiler
GOODPUT_SECONDS: Counter = _build("tik_goodput_seconds_total")
GOODPUT_WALL: Gauge = _build("tik_goodput_wall_seconds")
GOODPUT_FRACTION: Gauge = _build("tik_goodput_fraction")
TRAIN_DATA_WAIT_SECONDS: Histogram = _build("tik_train_data_wait_seconds")
TRAIN_HOST_TRANSFER_SECONDS: Histogram = _build(
    "tik_train_host_transfer_seconds")
TRAIN_DISPATCH_SECONDS: Histogram = _build("tik_train_dispatch_seconds")
TRAIN_GRAD_SYNC_SECONDS: Histogram = _build("tik_train_grad_sync_seconds")
TRAIN_COMPILES: Counter = _build("tik_train_compiles_total")
TRAIN_STRAGGLER_LAG: Gauge = _build("tik_train_straggler_lag_seconds")
TRAIN_PREFETCH_QUEUE_DEPTH: Gauge = _build("tik_train_prefetch_queue_depth")
TRAIN_PREFETCH_CONSUMER_WAIT: Histogram = _build(
    "tik_train_prefetch_consumer_wait_seconds")
TRAIN_PREFETCH_PRODUCER_STALL: Histogram = _build(
    "tik_train_prefetch_producer_stall_seconds")
TRAIN_PREFETCH_BATCHES: Counter = _build("tik_train_prefetch_batches_total")
SERVE_SLOT_IDLE_FRACTION: Gauge = _build("tik_serve_slot_idle_fraction")

# telemetry self-accounting
SPANS_DROPPED: Counter = _build("tik_spans_dropped_total")

# nodex exporter gauges (set only by the exporter process)
NODE_CPU_PERCENT: Gauge = _build("tik_node_cpu_percent")
NODE_MEMORY_PERCENT: Gauge = _build("tik_node_memory_percent")
NODE_DISK_PERCENT: Gauge = _build("tik_node_disk_percent")
NODE_NET_SENT: Gauge = _build("tik_node_net_sent_bytes")
NODE_NET_RECV: Gauge = _build("tik_node_net_recv_bytes")
