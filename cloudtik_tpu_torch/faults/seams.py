"""Injection seams: the one-attribute-check gate the fault plan arms.

Instrumented code paths call ``seams.fire("seam.name", **ctx)``.  With no
plan armed (`_plan is None`, the production state) that is ONE module
attribute read and a None check — no allocation, no locking, no plan
logic; the acceptance test asserts this by arming a tripwire in place of
`FaultPlan.fire` and running every instrumented path.

Arming:
  * tests / drill drivers: ``seams.arm(plan)`` or ``with seams.armed(plan)``
  * operators: set ``TIK_FAULT_PLAN=/path/plan.yaml`` in the environment
    of the process under drill (read once at import; `arm_from_env()`
    re-reads on demand) or run ``tik chaos run plan.yaml``.

Seam registry (keep docs/fault-injection.md in sync):

  provider.non_terminated_nodes   scaler snapshot       {provider}
  provider.create_node            node launcher         {provider, node_type, count}
  provider.terminate_node         scaler terminations   {provider, node_ids}
  executor.run                    ssh/local run         {node_id, cmd}
  state.get / state.put           StateClient kv+tables {table, key}
  node_agent.heartbeat            heartbeat publish     {ip, node_id}   supports drop
  checkpoint.save                 Checkpointer.save     {step, directory} supports torn_write
  events.append                   flight recorder append {name, path}    supports torn_write
  serve.reqlog.append             request ledger append {name, path}     supports torn_write
  serve.router.record             router ledger append  {name, path}     supports torn_write
  serve.kvcache.alloc             KV block pool alloc   {need, free, evictable}  raise -> pool exhausted
  serve.lora.load                 LoRA adapter cold load {adapter}      raise -> the request fails, not the engine
  serve.kvcache.migrate           KV block export, per block chunk {request, seq, blocks}  raise -> transfer torn, request degrades to re-prefill
  serve.spec.verify               speculative verify    {request, width}  raise -> request degrades to plain decode
  serve.router.forward            router forward attempt {replica, request}  raise -> attempt fails over to the next ring replica
  train.prefetch.next             prefetcher hand-off   {qsize}         latency -> data_wait
  train.grad_sync                 accumulated-step sync boundary {step, overlap, sync_bytes, fence}  latency -> grad_sync bucket, never step_compute
  elastic.slice_lost              coordinator membership poll {slice, step}  drop -> slice treated as lost
  elastic.remesh                  elastic re-mesh boundary {from_slices, to_slices, reason}  raise aborts the re-mesh
  serve.decode_step               DecodeEngine._step    {active}
  utils.retry                     every retry sleep     {fn, attempt}
"""

from __future__ import annotations

import os
from typing import Optional

from cloudtik_tpu_torch.faults.plan import FaultPlan, load_plan

_plan: Optional[FaultPlan] = None


def fire(seam: str, **ctx) -> Optional[str]:
    """Fire a seam.  Fast path (no plan armed) is one attribute check."""
    plan = _plan
    if plan is None:
        return None
    return plan.fire(seam, ctx)


def arm(plan: FaultPlan) -> FaultPlan:
    global _plan
    _plan = plan
    return plan


def disarm() -> None:
    global _plan
    _plan = None


def active_plan() -> Optional[FaultPlan]:
    return _plan


class armed:
    """Context manager: arm a plan for the `with` block, restore after."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        global _plan
        self._prev = _plan
        _plan = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        global _plan
        _plan = self._prev


def arm_from_env(strict: bool = True) -> Optional[FaultPlan]:
    """Arm from TIK_FAULT_PLAN=<plan.yaml> if set (env/config gating for
    daemons that cannot be handed a plan object).

    strict=False (the import-time call below) must never take a process
    down: a stale path or malformed plan in the environment disarms with
    a stderr warning instead of crashing node boot before logging is up.
    """
    path = os.environ.get("TIK_FAULT_PLAN")
    if not path:
        return None
    try:
        return arm(load_plan(path))
    except Exception as e:
        if strict:
            raise
        import sys
        print(f"tik-faults: ignoring TIK_FAULT_PLAN={path!r}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return None


arm_from_env(strict=False)
