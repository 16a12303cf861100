"""The authoritative telemetry name catalog.

Every metric, span, and flight-recorder event name the tree emits is
declared HERE, exactly once.
`tools/check_telemetry_names.py` (run standalone or as the tier-1 test
tests/test_telemetry_names.py) enforces that:

  * every metric name matches ``tik_[a-z0-9_]+`` and is declared once,
  * every instrument the registry creates is declared in this catalog,
  * every ``telemetry.span("...")`` literal in the source is declared,
  * every declared span name is actually fired somewhere,
  * docs/observability.md and the grafana dashboards reference only
    names that resolve against this catalog.

Keep docs/observability.md's metric catalog table in sync when editing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# Default fixed bucket ladders (seconds).  Exposition emits cumulative
# `le` buckets plus +Inf, prometheus-style.
LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
FAST_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 1.0)
SLOW_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                120.0, 300.0, 600.0)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str                      # counter | gauge | histogram
    help: str
    layer: str                     # which layer emits it
    labels: Tuple[str, ...] = ()
    buckets: Tuple[float, ...] = ()
    # registry: created by telemetry/instruments.py in-process.
    # external: emitted by a standalone surface (controller's
    # prometheus_client gauges, the collector's own series) — cataloged
    # so docs/dashboards referencing them resolve.
    source: str = "registry"


def _m(name: str, kind: str, help: str, layer: str,
       labels: Tuple[str, ...] = (),
       buckets: Tuple[float, ...] = (),
       source: str = "registry") -> MetricSpec:
    return MetricSpec(name, kind, help, layer, labels, buckets, source)


_ALL = [
    # -- providers / control plane ---------------------------------------
    _m("tik_gcp_rest_requests_total", "counter",
       "GCP REST calls by method and outcome code.", "providers",
       ("method", "code")),
    _m("tik_gcp_rest_latency_seconds", "histogram",
       "GCP REST call latency (including retries).", "providers",
       ("method",), LATENCY_BUCKETS),
    _m("tik_node_launches_total", "counter",
       "Provider node launches requested.", "control", ("node_type",)),
    _m("tik_node_launch_failures_total", "counter",
       "Provider node launches that raised.", "control", ("node_type",)),
    _m("tik_scaler_reconcile_total", "counter",
       "Scaler reconciliation passes, by result.", "control",
       ("result",)),
    _m("tik_scaler_reconcile_seconds", "histogram",
       "Wall time of one scaler reconciliation pass.", "control",
       (), LATENCY_BUCKETS),
    _m("tik_scaler_terminations_total", "counter",
       "Nodes the scaler decided to terminate, by why.", "control",
       ("reason",)),
    _m("tik_scaler_recoveries_total", "counter",
       "Heartbeat-lost nodes sent back through start commands.",
       "control"),
    _m("tik_node_updates_total", "counter",
       "Node updater runs by result.", "control", ("result",)),
    _m("tik_updater_phase_seconds", "histogram",
       "Node updater phase durations.", "control", ("phase",),
       SLOW_BUCKETS),
    _m("tik_executor_runs_total", "counter",
       "Commands run through node executors, by result.", "control",
       ("result",)),
    _m("tik_executor_run_seconds", "histogram",
       "Node executor command latency.", "control", (), SLOW_BUCKETS),
    _m("tik_heartbeats_published_total", "counter",
       "Heartbeats the node agent published.", "control"),
    _m("tik_discovery_sync_total", "counter",
       "Discovery sync render passes by result.", "runtimes",
       ("result",)),
    # -- train -----------------------------------------------------------
    _m("tik_checkpoint_saves_total", "counter",
       "Checkpoint saves started, by result.", "train", ("result",)),
    _m("tik_checkpoint_save_seconds", "histogram",
       "Checkpoint save dispatch latency (async: device->host copy).",
       "train", (), SLOW_BUCKETS),
    _m("tik_checkpoint_restore_seconds", "histogram",
       "Checkpoint restore latency.", "train", (), SLOW_BUCKETS),
    _m("tik_train_steps_total", "counter",
       "Optimizer steps taken.", "train"),
    _m("tik_train_step_seconds", "histogram",
       "Per-step wall time in the training loop.", "train", (),
       LATENCY_BUCKETS),
    _m("tik_train_tokens_per_sec", "gauge",
       "Training throughput over the last log window.", "train"),
    _m("tik_train_mfu", "gauge",
       "Analytic model FLOPs utilization over the last log window "
       "(flops_per_token x tokens/sec over device peak).", "train"),
    # -- serve -----------------------------------------------------------
    _m("tik_serve_requests_total", "counter",
       "Serve requests finished, by result.", "serve", ("result",)),
    _m("tik_serve_queue_wait_seconds", "histogram",
       "Submit -> slot admission wait.", "serve", (), LATENCY_BUCKETS),
    _m("tik_serve_ttft_seconds", "histogram",
       "Time to first token (submit -> prefill's first token).",
       "serve", (), LATENCY_BUCKETS),
    _m("tik_serve_tpot_seconds", "histogram",
       "Time per output token after the first (decode cadence).",
       "serve", (), FAST_BUCKETS),
    _m("tik_serve_tokens_generated_total", "counter",
       "Tokens produced by the decode engine.", "serve"),
    _m("tik_serve_active_slots", "gauge",
       "Decode slots occupied this step.", "serve", ("role",)),
    _m("tik_serve_queue_depth", "gauge",
       "Requests waiting for a slot.", "serve", ("role",)),
    # -- serve paged KV cache (serve/kvcache.py) -------------------------
    _m("tik_serve_kv_pool_utilization", "gauge",
       "Fraction of usable KV blocks held by requests (cached-idle "
       "prefix blocks count as reclaimable, not used).  role = "
       "engine (monolithic) | prefill | decode (disaggregated).",
       "serve", ("role",)),
    _m("tik_serve_kv_blocks_in_use", "gauge",
       "KV blocks held by in-flight requests.", "serve", ("role",)),
    _m("tik_serve_prefix_cache_hits_total", "counter",
       "Admissions whose prompt opened with cached prefix blocks.",
       "serve"),
    _m("tik_serve_prefix_cache_tokens_saved_total", "counter",
       "Prompt tokens served from the prefix cache instead of "
       "recomputed by prefill.", "serve"),
    _m("tik_serve_prefill_chunks_total", "counter",
       "Prompt chunks run by the chunked-prefill scheduler.", "serve"),
    _m("tik_serve_prefill_pending_tokens", "gauge",
       "Prompt tokens admitted but not yet prefilled (the chunk "
       "queue).", "serve", ("role",)),
    _m("tik_serve_preemptions_total", "counter",
       "Requests preempted and requeued because the KV pool ran out "
       "of blocks.", "serve"),
    _m("tik_serve_preempted_tokens_total", "counter",
       "Prompt tokens whose prefill work was at stake when their "
       "request was preempted (read the salvage win against it: "
       "salvaged blocks make the re-admission a prefix-cache hit).",
       "serve"),
    # -- serve KV-block migration (serve/migration.py) --------------------
    _m("tik_serve_kv_migrations_total", "counter",
       "KV-block migrations completed, by direction (out = exported "
       "to another engine, in = imported into this pool).", "serve",
       ("direction",)),
    _m("tik_serve_kv_migrated_tokens_total", "counter",
       "Tokens whose KV state moved between engines instead of being "
       "recomputed, by direction.", "serve", ("direction",)),
    _m("tik_serve_kv_migration_failures_total", "counter",
       "Migrations aborted mid-transfer; the request degraded to the "
       "re-prefill path on the decode role.", "serve"),
    # -- serve multi-replica router (serve/router.py + serve/replicas.py)
    _m("tik_serve_router_requests_total", "counter",
       "Requests the affinity router completed, by result (ok = "
       "finished on some replica; rejected = cleanly refused, 503 — "
       "no routable replica or every candidate draining, work never "
       "started; error = retries exhausted on real failures).",
       "serve", ("result",)),
    _m("tik_serve_router_failovers_total", "counter",
       "Forward attempts that failed connection-shaped (dead replica, "
       "deadline, injected fault) and retried on a survivor.",
       "serve"),
    _m("tik_serve_router_spills_total", "counter",
       "Requests routed off their affinity primary, by reason (load = "
       "bounded-load walk past a hot replica, drain = the primary "
       "refused with 503 Retry-After).", "serve", ("reason",)),
    _m("tik_serve_router_affinity_hits_total", "counter",
       "Requests that landed on their chain-key ring primary — the "
       "replica whose prefix blocks are warm.", "serve"),
    _m("tik_serve_router_replicas", "gauge",
       "Registry view by state (routable | draining | condemned).",
       "serve", ("state",)),
    _m("tik_serve_router_inflight", "gauge",
       "Requests currently forwarded and unfinished, all replicas.",
       "serve"),
    _m("tik_serve_router_probe_failures_total", "counter",
       "Health probes that failed (consecutive failures condemn the "
       "replica).", "serve"),
    _m("tik_serve_replica_target", "gauge",
       "Replica count the serve_demand autoscaler currently wants, by "
       "role (engine = monolithic fleet; a role-split fabric carries "
       "separate prefill/decode targets).", "serve", ("role",)),
    # -- role-aware serving fabric (serve/fabric.py) ----------------------
    _m("tik_serve_fabric_requests_total", "counter",
       "Prompt-heavy requests through the role-aware fabric, by path "
       "(migrated = prefill-role -> socket KV migration -> decode-role; "
       "fallback = transfer torn, re-prefilled plain on the decode "
       "replica; direct = degraded to the role-blind path because no "
       "prefill-role replica was usable).", "serve", ("path",)),
    _m("tik_serve_fabric_handoff_seconds", "histogram",
       "Wall time of one cross-replica KV handoff: socket connect + "
       "header/blocks/commit stream to the decode replica's migration "
       "receiver (the DCN cost of disaggregation).", "serve", (),
       LATENCY_BUCKETS),
    _m("tik_serve_phase_seconds", "histogram",
       "Per-request lifecycle phase decomposition, observed once at "
       "the finishing engine's completion point (router_wait = submit "
       "-> slot admission; prefill = admission -> prefill done on the "
       "prompt-owning engine; handoff_wire = socket KV handoff wall; "
       "decode_first = handoff arrival -> first decode-side token; "
       "decode_rest = first token -> done).  Sums to the request wall "
       "— the per-fleet twin of `tik serve explain`.", "serve",
       ("phase",), LATENCY_BUCKETS),
    # -- serve multi-tenant LoRA (serve/adapters.py + tenant SLOs) --------
    _m("tik_serve_tenant_requests_total", "counter",
       "Serve requests finished, by tenant and result — the per-tenant "
       "availability SLO reads it.", "serve", ("tenant", "result")),
    _m("tik_serve_tenant_ttft_seconds", "histogram",
       "Time to first token, by tenant — the per-tenant TTFT burn-rate "
       "SLO reads it.", "serve", ("tenant",), LATENCY_BUCKETS),
    _m("tik_serve_tenant_tpot_seconds", "histogram",
       "Decode cadence after the first token, by tenant.", "serve",
       ("tenant",), FAST_BUCKETS),
    _m("tik_serve_tenant_queue_depth", "gauge",
       "Requests waiting for a slot, by tenant — a bursting tenant's "
       "queue grows while weighted-fair admission holds the others "
       "flat.  role keeps two engines in one process (a disaggregated "
       "pair) from overwriting each other.", "serve",
       ("tenant", "role")),
    _m("tik_serve_adapters_resident", "gauge",
       "LoRA adapters resident in the stacked plane slots (pinned + "
       "idle-LRU; capacity is AdapterPool(capacity=...), the "
       "--adapter-slots serving flag).", "serve", ("role",)),
    _m("tik_serve_adapter_loads_total", "counter",
       "Cold adapter loads through the serve.lora.load seam, by "
       "result (a load failure fails the request, not the engine).",
       "serve", ("result",)),
    _m("tik_serve_adapter_evictions_total", "counter",
       "Idle adapters evicted from their plane slot to make room "
       "(LRU, like the prefix cache).", "serve"),
    # -- serve speculative decoding (EngineConfig.spec) ------------------
    _m("tik_serve_spec_draft_tokens_total", "counter",
       "Draft-model tokens proposed and verified by speculative "
       "decoding.", "serve"),
    _m("tik_serve_spec_accepted_tokens_total", "counter",
       "Draft tokens the target verify accepted.", "serve"),
    _m("tik_serve_spec_verify_steps_total", "counter",
       "Speculative draft/verify rounds the decode engine ran.",
       "serve"),
    _m("tik_serve_spec_acceptance_rate", "gauge",
       "Cumulative accepted/draft token ratio of speculative decoding "
       "(the SpecAcceptanceLow alert watches it).", "serve"),
    _m("tik_serve_spec_tokens_per_verify", "gauge",
       "Mean tokens emitted per target verify step (accepted + 1; "
       "upper bound spec.k + 1).", "serve"),
    # -- elastic multislice training (train/elastic.py) ------------------
    _m("tik_elastic_slices", "gauge",
       "Data-parallel slices the elastic trainer is currently meshed "
       "over.", "train"),
    _m("tik_elastic_remesh_total", "counter",
       "Elastic re-mesh transitions, by direction (shrink after a "
       "slice loss, expand when capacity returns).", "train",
       ("direction",)),
    _m("tik_elastic_remesh_seconds", "histogram",
       "Wall time of one elastic re-mesh (step-loop pause to resume: "
       "checkpoint drain, mesh + sharding rebuild, state restore or "
       "live reshard).", "train", (), SLOW_BUCKETS),
    # -- goodput ledger / step profiler ----------------------------------
    _m("tik_goodput_seconds_total", "counter",
       "Job wall time attributed to a goodput bucket "
       "(telemetry/goodput.py taxonomy).", "telemetry",
       ("bucket", "job")),
    _m("tik_goodput_wall_seconds", "gauge",
       "Total wall time the goodput ledger has accounted so far.",
       "telemetry", ("job",)),
    _m("tik_goodput_fraction", "gauge",
       "Productive step-compute fraction of accounted wall time.",
       "telemetry", ("job",)),
    _m("tik_train_data_wait_seconds", "histogram",
       "Per-step wait on the input pipeline (next(batch)).", "train",
       (), FAST_BUCKETS),
    _m("tik_train_host_transfer_seconds", "histogram",
       "Per-step host->device batch transfer (device_put).", "train",
       (), FAST_BUCKETS),
    _m("tik_train_dispatch_seconds", "histogram",
       "Per-step dispatch wall time of the jitted step (compile time "
       "subtracted when the compile tracker saw one).", "train",
       (), LATENCY_BUCKETS),
    _m("tik_train_compiles_total", "counter",
       "XLA backend compiles observed by the compile-tracking seam "
       "(first-step and recompiles).", "train"),
    _m("tik_train_grad_sync_seconds", "histogram",
       "Host-visible gradient-sync wall of an accumulated step: the "
       "grads->apply dispatch boundary per step plus the window "
       "flush's sync/update retirement tail (books to the grad_sync "
       "goodput bucket, never step_compute).", "train",
       (), FAST_BUCKETS),
    _m("tik_checkpoint_d2h_seconds", "histogram",
       "Background device->host transfer of one offloaded checkpoint "
       "save (chunked per shard off the step loop; the step loop only "
       "paid the on-device snapshot copy).", "train", (),
       SLOW_BUCKETS),
    _m("tik_train_straggler_lag_seconds", "gauge",
       "Largest per-host step-publish lag behind the fastest host.",
       "train"),
    # -- async input pipeline (train/prefetch.py) ------------------------
    _m("tik_train_prefetch_queue_depth", "gauge",
       "Device-resident batches ready in the prefetch queue.", "train"),
    _m("tik_train_prefetch_consumer_wait_seconds", "histogram",
       "Step-loop wait for the next prefetched batch (the residual "
       "data wait once transfers overlap compute).", "train",
       (), FAST_BUCKETS),
    _m("tik_train_prefetch_producer_stall_seconds", "histogram",
       "Producer blocked on a full prefetch queue (the accelerator is "
       "the bottleneck — the healthy state).", "train",
       (), FAST_BUCKETS),
    _m("tik_train_prefetch_batches_total", "counter",
       "Batches the prefetcher transferred and handed to the step "
       "loop.", "train"),
    # -- serve goodput ----------------------------------------------------
    _m("tik_serve_slot_idle_fraction", "gauge",
       "Fraction of decode-step lanes idle this step (1 - active/slots).",
       "serve", ("role",)),
    # -- telemetry self-accounting ---------------------------------------
    _m("tik_spans_dropped_total", "counter",
       "Finished spans overwritten in the ring before export.",
       "telemetry"),
    # -- nodex exporter (registry gauges set by the exporter process) ----
    _m("tik_node_cpu_percent", "gauge", "CPU utilization.", "nodex"),
    _m("tik_node_memory_percent", "gauge", "Memory utilization.",
       "nodex"),
    _m("tik_node_disk_percent", "gauge", "Disk utilization of /.",
       "nodex"),
    _m("tik_node_net_sent_bytes", "gauge", "Bytes sent.", "nodex"),
    _m("tik_node_net_recv_bytes", "gauge", "Bytes received.", "nodex"),
    # -- external surfaces (not registry instruments) --------------------
    _m("tik_cluster_workers", "gauge",
       "Non-terminated worker count (controller exporter).", "control",
       source="external"),
    _m("tik_pending_launches", "gauge",
       "Launches in flight (controller exporter).", "control",
       source="external"),
    _m("tik_active_updaters", "gauge",
       "Node updaters running (controller exporter).", "control",
       source="external"),
    _m("tik_collector_uptime_seconds", "gauge",
       "Built-in prometheus collector uptime.", "runtimes",
       source="external"),
    _m("tik_alerts_firing", "gauge",
       "1 per firing alert rule, 0 otherwise (collector's alert "
       "engine).", "runtimes", ("rule",), source="external"),
    _m("tik_slo_error_budget_remaining", "gauge",
       "Fraction of the SLO's error budget left over the collector's "
       "retained window (1 = untouched, <0 = overspent).", "runtimes",
       ("slo",), source="external"),
    _m("tik_slo_burn_rate", "gauge",
       "Error-budget burn rate per SLO over the fast/slow window "
       "(1.0 = spending exactly the budget).", "runtimes",
       ("slo", "window"), source="external"),
]

METRICS: Dict[str, MetricSpec] = {}
for _spec in _ALL:
    if _spec.name in METRICS:
        raise ValueError(f"duplicate metric name {_spec.name!r}")
    METRICS[_spec.name] = _spec
del _ALL, _spec


# Flight-recorder event catalog (telemetry/events.py): the durable
# control-plane transitions journaled to the events JSONL.  Same
# one-declaration law as metrics: every `events.emit("...")` literal in
# the tree must name an entry here, each entry must be emitted
# somewhere, and docs/observability.md documents all of them
# (tools/check_telemetry_names.py enforces it).
_EVENT_LIST = [
    ("tik_node_services_start",
     "a node's service daemons booted (node lifecycle)."),
    ("tik_node_launch",
     "the launcher asked the provider to create nodes."),
    ("tik_node_launch_failed",
     "a provider node launch raised."),
    ("tik_node_update",
     "a node updater finished, by result (node lifecycle)."),
    ("tik_scaler_decision",
     "one scale decision with its why (action + reason attrs)."),
    ("tik_checkpoint_commit",
     "a checkpoint save committed or failed, by step."),
    ("tik_serve_admission",
     "a serve request took a decode slot."),
    ("tik_serve_cancel",
     "a serve request was cancelled."),
    ("tik_serve_preemption",
     "a serve request was preempted (KV pool exhausted) and requeued; "
     "its computed prompt blocks are salvaged to the evictable prefix "
     "LRU so re-admission is a cache hit."),
    ("tik_serve_migration",
     "a request's KV blocks migrated between engines (direction, "
     "result, token/block counts; a failed out-migration degrades "
     "the request to the re-prefill path)."),
    ("tik_serve_replica_registered",
     "a serving replica registered in the fabric registry with role "
     "and capacity."),
    ("tik_serve_replica_drain",
     "a serving replica began draining (SIGTERM): not-routable, "
     "in-flight requests finish, new traffic spills."),
    ("tik_serve_replica_condemned",
     "the router condemned a replica (consecutive health-probe "
     "failures or heartbeat timeout); its traffic fails over."),
    ("tik_fault_fired",
     "an armed fault plan fired at a seam (chaos drills)."),
    ("tik_train_resume",
     "a trainer resumed from a checkpoint; replay_until marks the "
     "last step already run before the restart (goodput replay)."),
    ("tik_elastic_remesh",
     "the elastic trainer re-meshed across slices, with its why "
     "(reason=slice_lost|capacity_returned, from/to slice sets, the "
     "step resumed from)."),
    ("tik_checkpoint_wait_timeout",
     "an async checkpoint wait/close hit its deadline with saves "
     "still in flight (wedged save thread; teardown proceeded)."),
    ("tik_alert_fired",
     "an alert rule crossed into firing (collector alert engine)."),
    ("tik_alert_resolved",
     "a firing alert rule returned to ok."),
]

EVENTS: Dict[str, str] = {}
for _name, _help in _EVENT_LIST:
    if _name in EVENTS:
        raise ValueError(f"duplicate event name {_name!r}")
    if _name in METRICS:
        raise ValueError(f"event name {_name!r} collides with a metric")
    EVENTS[_name] = _help
del _EVENT_LIST, _name, _help


# Span taxonomy: dotted names mirroring the fault-seam registry
# (faults/seams.py) where the two share an instrumentation point.
SPANS: Dict[str, str] = {
    "gcp.rest.request":       "one authenticated REST call incl. retries",
    "provider.create_node":   "node launcher -> provider create",
    "provider.terminate_nodes": "scaler -> provider terminate",
    "scaler.reconcile":       "one full reconciliation pass",
    "scaler.decision":        "a scale decision; attrs carry action + why",
    "executor.run":           "one command over ssh/local executor",
    "updater.wait_ready":     "boot probe until the node answers",
    "updater.sync_files":     "file-mount rsync",
    "updater.setup":          "initialization + setup commands",
    "updater.start_services": "start commands",
    "checkpoint.save":        "checkpoint save dispatch",
    "checkpoint.d2h":         "background device->host copy of an offloaded save",
    "checkpoint.restore":     "checkpoint restore",
    "discovery.render":       "registry -> targets/dns render pass",
    "serve.enqueue":          "request submit -> queued",
    "serve.router.forward":   "one router forward attempt to a replica",
    "serve.prefill":          "one prompt prefill chunk against the paged pool",
    "serve.kvcache.migrate":  "export a request's KV blocks through the migration transport",
    "serve.lora.load":        "cold-load one LoRA adapter into its plane slot",
    "serve.kvcache.import":   "import migrated KV blocks into a decode-role pool",
    "serve.spec.verify":      "one speculative draft/verify round for a slot",
    "serve.decode_step":      "one engine decode step over all slots",
    "serve.decode":           "per-request decode window (first->last token)",
    "train.window":           "one log_every window of training steps",
    "train.remesh":           "one elastic re-mesh (pause -> resume)",
}
