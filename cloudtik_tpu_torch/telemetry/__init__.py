"""tik telemetry: always-on, low-overhead tracing spans + metrics.

Dependency-free and thread-safe.  Instrumented paths pay ONE attribute
check when disabled (`TIK_TELEMETRY=off`) — same discipline as the fault
seams (faults/seams.py).  docs/observability.md is the operator guide;
telemetry/names.py is the authoritative name catalog.

Emit sites::

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.telemetry import instruments as ti

    with telemetry.span("scaler.reconcile", tick=n):
        ...
    ti.SERVE_TTFT.observe(dt)

Export::

    telemetry.render_prometheus()   # Prometheus text
    telemetry.chrome_trace()        # chrome://tracing JSON
    telemetry.http.start_server(p)  # /metrics /trace /trace/summary
"""

from cloudtik_tpu_torch.telemetry.core import (  # noqa: F401
    NOOP_SPAN, REGISTRY, SPAN_RING, TRACEPARENT_ENV, add_span,
    adopt_traceparent, adopt_traceparent_from_env,
    clear_adopted_traceparent, configure_from_env, current_traceparent,
    disable, enable, enabled, format_traceparent, parse_traceparent,
    reset, span, spans, timed_span, trace_context)
from cloudtik_tpu_torch.telemetry.export import (  # noqa: F401
    chrome_trace, parse_prometheus, render_prometheus, trace_summary)
from cloudtik_tpu_torch.telemetry.names import (  # noqa: F401
    EVENTS, METRICS, SPANS)

__all__ = [
    "EVENTS", "METRICS", "NOOP_SPAN", "REGISTRY", "SPANS", "SPAN_RING",
    "TRACEPARENT_ENV", "add_span", "adopt_traceparent",
    "adopt_traceparent_from_env", "chrome_trace",
    "clear_adopted_traceparent", "configure_from_env",
    "current_traceparent", "disable", "enable", "enabled",
    "format_traceparent", "parse_prometheus", "parse_traceparent",
    "render_prometheus", "reset", "span", "spans", "timed_span",
    "trace_context", "trace_summary",
]
