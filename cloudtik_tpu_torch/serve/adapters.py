"""LoRA adapter pool: hot-load/evict adapters for multi-tenant serving.

Counterpart of `cloudtik_tpu/serve/adapters.py`, with the same residency
rules, seam, span and metric names.  All resident adapters live in
fixed-capacity stacked device planes `[L, A+1, ...]` (models/lora.py),
written in place, and this pool decides which adapter occupies which plane
slot.  The discipline mirrors the prefix cache (serve/kvcache.py):

  * **slot 0 is the reserved null adapter** — all zeros, delta exactly 0
    — so base-model requests ride the same forward; it is never
    allocated, never evicted.
  * **resident + referenced** — at least one in-flight request decodes
    with the adapter; it cannot be evicted.
  * **resident + idle** — refcount 0, parked on an LRU: the planes (and
    the lazily-merged copy behind the batch-homogeneous decode) stay warm
    for the next request, reclaimable when a new adapter needs the slot.

`acquire` fires the `serve.lora.load` fault seam before a cold load; a
load failure (a loader error, mismatched shapes, an injected fault)
raises :class:`AdapterLoadError`, which **fails the request, not the
engine**.  All slots pinned raises :class:`AdapterSlotsExhausted`; the
engine leaves the request queued exactly like KV-block exhaustion.

Not thread-safe by design: every mutation happens on the engine's loop
thread (the BlockPool rule).  The pool takes any `loader` callable;
`checkpoint_loader` restores adapters from the LoRA trainer's checkpoints.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultInjected
from cloudtik_tpu_torch.models import lora as LO
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.tree import tree_map

Params = Dict[str, Any]

NULL_SLOT = 0


class AdapterLoadError(RuntimeError):
    """Loading an adapter failed (unreadable checkpoint, injected
    fault): the REQUEST carrying the adapter_id fails, the engine
    lives on."""


class AdapterSlotsExhausted(RuntimeError):
    """Every plane slot is pinned by an in-flight request — admission
    waits, exactly like KV-block exhaustion."""


def fire_load_seam(adapter_id: str) -> None:
    """The `serve.lora.load` injection seam, fired immediately before
    every cold adapter load (`raise` -> the load fails and the request
    carrying the adapter fails; the engine is untouched).  Unarmed this
    is one attribute check."""
    seams.fire("serve.lora.load", adapter=adapter_id)


def checkpoint_loader(adapters_dir: str, cfg, lora_cfg: LO.LoRAConfig
                      ) -> Callable[[str], Params]:
    """Loader restoring adapter `<adapters_dir>/<adapter_id>` from a
    trainer checkpoint (the LoRA trainer saves {"params": adapters}; the
    JAX package's convert with `tools/import_jax_checkpoint.py`).  The
    restore template is `init_lora_params` on the "meta" device, so
    shapes are checked against this server's model and rank; the adapter
    comes back on the host and the pool moves it to its planes."""
    import os

    from cloudtik_tpu_torch.train.checkpoint import restore_params

    def load(adapter_id: str) -> Params:
        directory = os.path.join(adapters_dir, adapter_id)
        if not os.path.isdir(directory):
            raise AdapterLoadError(
                f"adapter {adapter_id!r}: no checkpoint directory at "
                f"{directory}")
        template = LO.init_lora_params(torch.Generator(), cfg, lora_cfg,
                                       "meta")
        return restore_params(directory, template)

    return load


class AdapterPool:
    """Fixed-capacity plane slots + LRU residency for LoRA adapters.

    `planes` is the live stacked-plane tree the engine hands its forward
    ([L, capacity+1, ...] per target, on the base parameters' device;
    shapes never change, a load writes one slot in place).  `base` is the
    frozen base params; `merged(adapter_id)` lazily builds and caches the
    merge_lora'd full params behind the batch-homogeneous decode and the
    speculative verify (dropped on eviction with the rest of the
    residency).  The loader's trees may lie anywhere: they are moved to
    the planes' device."""

    def __init__(self, base: Params, cfg, lora_cfg: LO.LoRAConfig,
                 loader: Callable[[str], Params], capacity: int = 8,
                 role: str = "engine"):
        if capacity < 1:
            raise ValueError("AdapterPool capacity must be >= 1")
        self.base = base
        self.cfg = cfg
        self.lora_cfg = lora_cfg
        self.capacity = int(capacity)
        self.role = role
        self._loader = loader
        self.device = base["embed"].device
        self.planes = LO.init_adapter_planes(cfg, lora_cfg,
                                             self.capacity + 1, self.device)
        self._slots: Dict[str, int] = {}        # adapter_id -> slot
        self._free: List[int] = list(range(self.capacity, 0, -1))
        self._ref: Dict[str, int] = {}
        # resident, refcount-0 adapters in least-recently-used order
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._params: Dict[str, Params] = {}    # raw adapter trees
        self._merged: Dict[str, Params] = {}    # homogeneous fallback
        self._emit_gauges()

    # -- residency --------------------------------------------------------
    def resident(self) -> List[str]:
        return sorted(self._slots)

    def slot(self, adapter_id: Optional[str]) -> int:
        """The plane slot a RESIDENT adapter occupies (None -> the null
        slot).  KeyError when not resident — acquire first."""
        if adapter_id is None:
            return NULL_SLOT
        return self._slots[adapter_id]

    def acquire(self, adapter_id: Optional[str]) -> int:
        """Pin `adapter_id` for one request and return its plane slot.

        Resident adapters just bump their refcount (and leave the idle
        LRU).  A cold adapter takes a free slot — evicting the
        least-recently-used idle adapter when none is free — and loads
        through the `serve.lora.load` seam; load failure raises
        :class:`AdapterLoadError` with the slot returned to the free
        list.  All slots pinned raises :class:`AdapterSlotsExhausted`.
        """
        if adapter_id is None:
            return NULL_SLOT
        slot = self._slots.get(adapter_id)
        if slot is not None:
            self._ref[adapter_id] = self._ref.get(adapter_id, 0) + 1
            self._lru.pop(adapter_id, None)
            return slot
        slot = self._take_slot()
        try:
            fire_load_seam(adapter_id)
            with telemetry.span("serve.lora.load", adapter=adapter_id,
                                slot=slot):
                params = tree_map(
                    lambda t: torch.as_tensor(t).to(self.device),
                    self._loader(adapter_id))
                # the plane write is part of the load: a loader returning
                # mismatched targets/shapes must ALSO fail as
                # AdapterLoadError with the slot returned
                LO.write_adapter_slot(self.planes, slot, params)
        except (Exception, FaultInjected) as e:
            self._free.append(slot)
            ti.SERVE_ADAPTER_LOADS.inc(result="error")
            if isinstance(e, AdapterLoadError):
                raise
            raise AdapterLoadError(
                f"adapter {adapter_id!r} failed to load: {e}") from e
        self._slots[adapter_id] = slot
        self._ref[adapter_id] = 1
        self._params[adapter_id] = params
        ti.SERVE_ADAPTER_LOADS.inc(result="ok")
        self._emit_gauges()
        return slot

    def release(self, adapter_id: Optional[str]) -> None:
        """Drop one request's pin; a refcount reaching 0 parks the
        adapter on the idle LRU (planes stay warm, reclaimable)."""
        if adapter_id is None:
            return
        refs = self._ref.get(adapter_id)
        if refs is None:
            raise ValueError(f"adapter {adapter_id!r} is not acquired")
        if refs > 1:
            self._ref[adapter_id] = refs - 1
            return
        del self._ref[adapter_id]
        self._lru[adapter_id] = None
        self._lru.move_to_end(adapter_id)

    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if not self._lru:
            raise AdapterSlotsExhausted(
                f"all {self.capacity} adapter slots are pinned by "
                "in-flight requests")
        victim, _ = self._lru.popitem(last=False)
        slot = self._slots.pop(victim)
        self._params.pop(victim, None)
        self._merged.pop(victim, None)
        ti.SERVE_ADAPTER_EVICTIONS.inc()
        self._emit_gauges()
        return slot

    # -- batch-homogeneous fallback ---------------------------------------
    def merged(self, adapter_id: Optional[str]) -> Params:
        """Full params with `adapter_id` merged into the layer weights
        (merge_lora) — the batch-homogeneous decode and the speculative
        verify of an adapter request.  None -> the base params untouched.
        Built lazily, cached while resident."""
        if adapter_id is None:
            return self.base
        cached = self._merged.get(adapter_id)
        if cached is not None:
            return cached
        merged = dict(self.base)
        merged["layers"] = LO.merge_lora(self.base["layers"],
                                         self._params[adapter_id],
                                         self.lora_cfg)
        self._merged[adapter_id] = merged
        return merged

    # -- telemetry --------------------------------------------------------
    def _emit_gauges(self) -> None:
        ti.SERVE_ADAPTERS_RESIDENT.set(len(self._slots), role=self.role)
