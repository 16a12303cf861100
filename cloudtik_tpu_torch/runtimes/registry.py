"""Runtime registry: name -> Runtime class, over the port's runtimes.

Counterpart of `cloudtik_tpu/runtimes/registry.py`, whose loading rules it
keeps: a registered class first, then a built-in name, then an external
`package.module:Class`.  The built-in names are the runtimes the port has;
a name the reference has built in and the port does not (`spark`, `etcd`,
...) raises `UnknownRuntimeError` naming it, so a port cluster never
reaches a JAX-package class by a short name.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Type

from cloudtik_tpu_torch.core.runtime import Runtime

# built-in runtime name -> module path : class name
_BUILT_IN: Dict[str, str] = {
    "ai": "cloudtik_tpu_torch.runtimes.ai.runtime:AIRuntime",
    "prometheus":
        "cloudtik_tpu_torch.runtimes.prometheus.runtime:PrometheusRuntime",
    "nodex": "cloudtik_tpu_torch.runtimes.nodex.runtime:NodexRuntime",
    "discovery":
        "cloudtik_tpu_torch.runtimes.discovery.runtime:DiscoveryRuntime",
    "serving": "cloudtik_tpu_torch.runtimes.serving.runtime:ServingRuntime",
    "profiler":
        "cloudtik_tpu_torch.runtimes.profiler.runtime:ProfilerRuntime",
}

# Installed on every cluster unless disabled, as in the reference.
DEFAULT_RUNTIMES: List[str] = ["nodex", "prometheus"]

_registry: Dict[str, Type[Runtime]] = {}


class UnknownRuntimeError(ValueError):
    pass


def register_runtime(name: str, cls: Type[Runtime]) -> None:
    _registry[name] = cls


def get_runtime_cls(name: str) -> Type[Runtime]:
    if name in _registry:
        return _registry[name]
    spec = _BUILT_IN.get(name)
    if spec is None:
        # external runtime: "package.module:Class"
        if ":" in name:
            spec = name
        else:
            raise UnknownRuntimeError(
                f"Unknown runtime {name!r}; known: {sorted(_BUILT_IN)}")
    module_name, _, cls_name = spec.partition(":")
    module = importlib.import_module(module_name)
    cls = getattr(module, cls_name)
    _registry[name] = cls
    return cls


def create_runtime(name: str, runtime_config: Dict[str, Any]) -> Runtime:
    runtime = get_runtime_cls(name)(runtime_config)
    # the registered name is what the CLI, delivery status records and
    # state tables key on
    runtime.registered_name = name
    return runtime


def runtime_types(config: Dict[str, Any]) -> List[str]:
    return list((config.get("runtime") or {}).get("types") or [])


def iter_runtimes(config: Dict[str, Any]) -> List[Runtime]:
    """Instantiate all runtimes declared in a cluster config, in dependency
    order (a runtime's get_dependencies run before it)."""
    names = runtime_types(config)
    runtime_config = config.get("runtime", {})
    ordered: List[str] = []
    visiting: set = set()

    def visit(name: str):
        if name in ordered:
            return
        if name in visiting:
            raise ValueError(f"runtime dependency cycle at {name!r}")
        visiting.add(name)
        for dep in get_runtime_cls(name).get_dependencies():
            if dep in names:
                visit(dep)
        visiting.discard(name)
        ordered.append(name)

    for n in names:
        visit(n)
    return [create_runtime(n, runtime_config.get(n, {})) for n in ordered]
