"""Built-in Grafana dashboards (provisioned JSON).

Reference parity: runtime/grafana conf/dashboards — the reference ships
provisioned dashboards for its metrics stack.  Two dashboards over the
metrics this framework actually emits (the catalog in
telemetry/names.py — tools/check_telemetry_names.py verifies every
expression below resolves against it): a cluster overview (nodex
gauges + controller/scaler series) and an AI-workload view (serve
TTFT/TPOT/throughput + trainer step time/MFU).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


def _panel(panel_id: int, title: str, expr: str, unit: str,
           x: int, y: int) -> Dict[str, Any]:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "fieldConfig": {"defaults": {"unit": unit}},
        "targets": [{
            "expr": expr,
            "legendFormat": "{{instance}}",
            "refId": "A",
        }],
        "datasource": {"type": "prometheus",
                       "uid": "tik-prometheus"},
    }


def cluster_overview_dashboard() -> Dict[str, Any]:
    panels: List[Dict[str, Any]] = [
        _panel(1, "CPU utilization", "tik_node_cpu_percent",
               "percent", 0, 0),
        _panel(2, "Memory utilization", "tik_node_memory_percent",
               "percent", 12, 0),
        _panel(3, "Disk utilization", "tik_node_disk_percent",
               "percent", 0, 8),
        _panel(4, "Network throughput",
               "rate(tik_node_net_sent_bytes[1m]) "
               "+ rate(tik_node_net_recv_bytes[1m])", "Bps", 12, 8),
        _panel(5, "Cluster workers",
               "tik_cluster_workers", "short", 0, 16),
        _panel(6, "Pending launches / active updaters",
               "tik_pending_launches or tik_active_updaters",
               "short", 12, 16),
        _panel(7, "Scaler reconcile latency (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_scaler_reconcile_seconds_bucket[5m]))",
               "s", 0, 24),
        _panel(8, "Scale decisions",
               "rate(tik_scaler_terminations_total[5m]) "
               "or rate(tik_node_launches_total[5m])",
               "ops", 12, 24),
        _panel(9, "Heartbeats published",
               "rate(tik_heartbeats_published_total[5m])",
               "ops", 0, 32),
        _panel(10, "Executor command latency (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_executor_run_seconds_bucket[5m]))",
               "s", 12, 32),
    ]
    return {
        "uid": "tik-cluster-overview",
        "title": "Tik Cluster Overview",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "panels": panels,
        "templating": {"list": []},
    }


def ai_workload_dashboard() -> Dict[str, Any]:
    """Serve latency + trainer throughput over the telemetry registry."""
    panels: List[Dict[str, Any]] = [
        _panel(1, "Time to first token (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_serve_ttft_seconds_bucket[5m]))", "s", 0, 0),
        _panel(2, "Time per output token (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_serve_tpot_seconds_bucket[5m]))", "s", 12, 0),
        _panel(3, "Queue wait (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_serve_queue_wait_seconds_bucket[5m]))",
               "s", 0, 8),
        _panel(4, "Request outcomes",
               "rate(tik_serve_requests_total[5m])", "ops", 12, 8),
        _panel(5, "Tokens generated / active slots",
               "rate(tik_serve_tokens_generated_total[5m]) "
               "or tik_serve_active_slots", "short", 0, 16),
        _panel(6, "Train step time (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_train_step_seconds_bucket[5m]))", "s", 12, 16),
        _panel(7, "Train throughput",
               "tik_train_tokens_per_sec", "short", 0, 24),
        _panel(8, "Train MFU",
               "tik_train_mfu", "percentunit", 12, 24),
        _panel(9, "Checkpoint save latency (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_checkpoint_save_seconds_bucket[5m]))",
               "s", 0, 32),
        _panel(10, "Serve queue depth",
               "tik_serve_queue_depth", "short", 12, 32),
        # -- Goodput row: where every TPU-second goes ---------------------
        {"id": 11, "type": "row", "title": "Goodput", "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 40}, "panels": []},
        _panel(12, "Goodput fraction",
               "tik_goodput_fraction", "percentunit", 0, 41),
        _panel(13, "TPU-seconds by bucket",
               "rate(tik_goodput_seconds_total[5m])", "percentunit",
               12, 41),
        _panel(14, "Input-pipeline wait (p95)",
               "histogram_quantile(0.95, "
               "rate(tik_train_data_wait_seconds_bucket[5m]))",
               "s", 0, 49),
        _panel(15, "Straggler lag / slot idle",
               "tik_train_straggler_lag_seconds "
               "or tik_serve_slot_idle_fraction", "short", 12, 49),
        _panel(16, "Alerts firing",
               "tik_alerts_firing", "short", 0, 57),
        _panel(17, "XLA compiles",
               "rate(tik_train_compiles_total[5m])", "ops", 12, 57),
        # -- Serving SLO row: burn rates the collector evaluates ----------
        {"id": 18, "type": "row", "title": "Serving SLOs",
         "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 65}, "panels": []},
        _panel(19, "SLO burn rate (fast/slow windows)",
               "tik_slo_burn_rate", "short", 0, 66),
        _panel(20, "SLO error budget remaining",
               "tik_slo_error_budget_remaining", "percentunit", 12, 66),
        # -- Paged KV cache row: pool pressure + prefix-cache wins --------
        {"id": 21, "type": "row", "title": "Paged KV cache",
         "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 74}, "panels": []},
        # one expression per panel: these pairs share identical label
        # sets, so a PromQL `a or b` would silently drop the right side
        _panel(22, "KV pool utilization",
               "tik_serve_kv_pool_utilization", "percentunit", 0, 75),
        _panel(23, "KV blocks in use",
               "tik_serve_kv_blocks_in_use", "short", 12, 75),
        _panel(24, "Prefix-cache hit rate",
               "rate(tik_serve_prefix_cache_hits_total[5m])",
               "ops", 0, 83),
        _panel(25, "Prefix-cache tokens saved",
               "rate(tik_serve_prefix_cache_tokens_saved_total[5m])",
               "short", 12, 83),
        _panel(26, "Prefill chunk queue (pending tokens)",
               "tik_serve_prefill_pending_tokens", "short", 0, 91),
        _panel(27, "Pool preemptions",
               "rate(tik_serve_preemptions_total[5m])", "ops", 12, 91),
        # -- Speculative decoding row: is the draft earning its keep? -----
        {"id": 28, "type": "row", "title": "Speculative decoding",
         "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 99}, "panels": []},
        _panel(29, "Spec acceptance rate",
               "tik_serve_spec_acceptance_rate", "percentunit", 0, 100),
        _panel(30, "Spec tokens per verify",
               "tik_serve_spec_tokens_per_verify", "short", 12, 100),
        _panel(31, "Draft tokens proposed",
               "rate(tik_serve_spec_draft_tokens_total[5m])",
               "ops", 0, 108),
        _panel(32, "Verify rounds",
               "rate(tik_serve_spec_verify_steps_total[5m])",
               "ops", 12, 108),
        # -- KV migration row: disaggregated roles + preemption salvage ---
        {"id": 33, "type": "row", "title": "KV-block migration",
         "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 116}, "panels": []},
        _panel(34, "Migrations by direction",
               "rate(tik_serve_kv_migrations_total[5m])", "ops",
               0, 117),
        _panel(35, "Migrated tokens (KV moved, not recomputed)",
               "rate(tik_serve_kv_migrated_tokens_total[5m])",
               "short", 12, 117),
        _panel(36, "Migration failures (degraded to re-prefill)",
               "rate(tik_serve_kv_migration_failures_total[5m])",
               "ops", 0, 125),
        _panel(37, "Preempted tokens (prefill work at stake)",
               "rate(tik_serve_preempted_tokens_total[5m])",
               "short", 12, 125),
        # -- Multi-replica router row: affinity, failover, fleet size -----
        {"id": 38, "type": "row", "title": "Multi-replica router",
         "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 133}, "panels": []},
        _panel(39, "Routed requests by result",
               "rate(tik_serve_router_requests_total[5m])", "ops",
               0, 134),
        _panel(40, "Affinity hits (ring-primary placements)",
               "rate(tik_serve_router_affinity_hits_total[5m])",
               "ops", 12, 134),
        _panel(41, "Spills by reason (load / drain)",
               "rate(tik_serve_router_spills_total[5m])", "ops",
               0, 142),
        _panel(42, "Failovers (retried on a survivor)",
               "rate(tik_serve_router_failovers_total[5m])", "ops",
               12, 142),
        _panel(43, "Replicas by state",
               "tik_serve_router_replicas", "short", 0, 150),
        _panel(44, "Autoscaler target replicas",
               "tik_serve_replica_target", "short", 12, 150),
        # -- Multi-tenant serving row: who is spending whose budget -------
        {"id": 45, "type": "row", "title": "Multi-tenant serving",
         "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 158}, "panels": []},
        _panel(46, "Tenant TTFT p95",
               "histogram_quantile(0.95, "
               "rate(tik_serve_tenant_ttft_seconds_bucket[5m]))",
               "s", 0, 159),
        _panel(47, "Tenant request rate by result",
               "rate(tik_serve_tenant_requests_total[5m])", "ops",
               12, 159),
        _panel(48, "Tenant queue depth (a burst queues behind itself)",
               "tik_serve_tenant_queue_depth", "short", 0, 167),
        _panel(49, "Tenant TPOT p95",
               "histogram_quantile(0.95, "
               "rate(tik_serve_tenant_tpot_seconds_bucket[5m]))",
               "s", 12, 167),
        _panel(50, "Resident LoRA adapters",
               "tik_serve_adapters_resident", "short", 0, 175),
        _panel(51, "Adapter loads by result",
               "rate(tik_serve_adapter_loads_total[5m])", "ops",
               12, 175),
        _panel(52, "Adapter evictions (LRU pressure)",
               "rate(tik_serve_adapter_evictions_total[5m])", "ops",
               0, 183),
        # -- Request forensics row: per-phase TTFT decomposition ----------
        {"id": 53, "type": "row", "title": "Request forensics",
         "collapsed": False,
         "gridPos": {"h": 1, "w": 24, "x": 0, "y": 191}, "panels": []},
        # where a routed request's wall actually went (router_wait /
        # prefill / handoff_wire / decode_first / decode_rest) — one
        # series per phase label; the fat phase is the one to chase
        _panel(54, "Request phase latency p95 (by phase)",
               "histogram_quantile(0.95, sum by (le, phase) "
               "(rate(tik_serve_phase_seconds_bucket[5m])))",
               "s", 0, 192),
        _panel(55, "Phase samples (completion-point emission rate)",
               "rate(tik_serve_phase_seconds_count[5m])", "ops",
               12, 192),
    ]
    return {
        "uid": "tik-ai-workloads",
        "title": "Tik AI Workloads",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "panels": panels,
        "templating": {"list": []},
    }


def render_dashboard_provider(dashboards_dir: str) -> str:
    """provisioning/dashboards provider yaml (file-based)."""
    import yaml
    return yaml.safe_dump({
        "apiVersion": 1,
        "providers": [{
            "name": "tik",
            "type": "file",
            "options": {"path": dashboards_dir},
        }],
    })


def write_dashboards(provisioning_dir: str) -> List[str]:
    """Write provider yaml + dashboard JSONs; returns created paths."""
    import os
    dash_dir = os.path.join(provisioning_dir, "dashboards")
    os.makedirs(dash_dir, exist_ok=True)
    provider = os.path.join(dash_dir, "tik.yaml")
    with open(provider, "w") as f:
        f.write(render_dashboard_provider(dash_dir))
    created = [provider]
    for filename, dashboard in (
            ("cluster-overview.json", cluster_overview_dashboard()),
            ("ai-workloads.json", ai_workload_dashboard())):
        path = os.path.join(dash_dir, filename)
        with open(path, "w") as f:
            json.dump(dashboard, f, indent=1)
        created.append(path)
    return created
