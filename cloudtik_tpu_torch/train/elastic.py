"""Elastic multislice training: survive slice preemption by re-meshing.

Counterpart of `cloudtik_tpu/train/elastic.py`.  A job trains across K
slices (a slice is a contiguous run of ranks with the same intra-slice
layout; the `data` axis is the only one that spans slices), and when a
slice is lost the surviving processes do not restart.  The
:class:`ElasticCoordinator` watches slice membership and, at a step
boundary, tells the trainer (`Trainer.fit_elastic`) to:

  * **shrink** (``slice_lost``): re-form the process group and the mesh
    at K-1 over the surviving slices, restore the last committed
    checkpoint into the new placements (each rank reads the pieces of the
    per-rank shards that overlap its new shard), keep the global batch
    constant and resume from that step;
  * **expand** (``capacity_returned``): when the slice's processes return,
    re-form the group and the mesh at K and hand the live state to the
    returning ranks (nothing was lost, so no checkpoint rewind).

The re-mesh pause is booked to the goodput ledger's ``elastic_remesh``
bucket (net of the restore and compile seconds booked to their own
buckets).  Two fault seams make the path drillable: ``elastic.slice_lost``
(a ``drop`` marks a slice lost for the poll) and ``elastic.remesh`` (fired
at the boundary before any mutation; ``raise`` aborts the re-mesh).

The reference is one controller over every device; the port runs one
process per rank, which changes three things:

  * **Every rank has its own coordinator, and all of them reach one
    decision at one boundary** through the store that outlives every rank
    (`parallel.distributed.elastic_store`), never a collective of the old
    group (which hangs once a member is gone): the first rank to reach
    boundary (generation, step) writes its decision with ``compare_set``,
    and every rank adopts what is written.  A decision that changes the
    slices is also announced under its generation, where a returning
    process finds the one that takes it back.
  * **A lost slice's ranks leave.**  In a drill their `fit_elastic`
    returns at the boundary (``left`` in its result); for real, the
    process is gone.
  * **A returned slice is a fresh process with no state.**  It registers
    (`admit`), joins the next generation's group, and receives the step,
    its shard of every leaf and the optimizer state from the survivors.

`StoreMembership` is membership over the same store: each rank registers
itself, and the coordinators mark the ranks of a slice the job re-meshed
without as gone, so a slice counts again only when its new processes
register.  Any callable, or any object with ``alive_slices()``, serves as
membership too, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import (Callable, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple, Union)

from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import DIRECTIVE_DROP
from cloudtik_tpu_torch.parallel import distributed
from cloudtik_tpu_torch.parallel.mesh import (MeshConfig, build_elastic_mesh,
                                              elastic_ranks,
                                              slice_device_groups)
from cloudtik_tpu_torch.telemetry import core as tcore
from cloudtik_tpu_torch.telemetry import instruments as ti

logger = logging.getLogger(__name__)

REASON_SLICE_LOST = "slice_lost"
REASON_CAPACITY_RETURNED = "capacity_returned"

DIRECTION_SHRINK = "shrink"
DIRECTION_EXPAND = "expand"

# the store's keys
_ALIVE = "tik-elastic/alive/{rank}"
_DECISION = "tik-elastic/decision/{generation}/{step}"
_ANNOUNCED = "tik-elastic/generation/{generation}"
_LATEST = "tik-elastic/latest"

# Membership sources the coordinator accepts: a SliceMembership-like
# object (alive_slices() -> iterable of slice ids) or a bare callable.
MembershipLike = Union[Callable[[], Iterable[int]], object]


@dataclasses.dataclass(frozen=True)
class RemeshDecision:
    """One boundary decision: change the live slice set, and why."""

    from_slices: Tuple[int, ...]
    to_slices: Tuple[int, ...]
    reason: str              # REASON_SLICE_LOST | REASON_CAPACITY_RETURNED

    @property
    def direction(self) -> str:
        # tied to the reason, not the set sizes: an equal-size swap
        # (one slice dies as another returns) takes the slice_lost
        # restore path and must count as a shrink-shaped event
        return (DIRECTION_SHRINK if self.reason == REASON_SLICE_LOST
                else DIRECTION_EXPAND)


def fire_slice_lost_seam(slice_id: int, step: int) -> Optional[str]:
    """The membership-poll injection point: an armed ``drop`` marks
    this slice lost for this poll (simulated preemption)."""
    return seams.fire("elastic.slice_lost", slice=slice_id, step=step)


def fire_remesh_seam(from_slices: Tuple[int, ...],
                     to_slices: Tuple[int, ...],
                     reason: str) -> Optional[str]:
    """Fired at the re-mesh boundary before any state mutation; an
    armed ``raise`` aborts the re-mesh (the step loop fails loudly)."""
    return seams.fire("elastic.remesh", from_slices=from_slices,
                      to_slices=to_slices, reason=reason)


def _note_remesh(direction: str, seconds: float, slices: int) -> None:
    """Instrument one re-mesh.  Single attribute check when telemetry
    is off (the elastic path must stay free on TIK_TELEMETRY=off)."""
    if not tcore.STATE.enabled:
        return
    ti.ELASTIC_REMESHES.inc(direction=direction)
    ti.ELASTIC_REMESH_SECONDS.observe(seconds)
    ti.ELASTIC_SLICES.set(slices)


def _encode(decision: Optional[RemeshDecision], step: int) -> str:
    if decision is None:
        return "none"
    return json.dumps({"from": list(decision.from_slices),
                       "to": list(decision.to_slices),
                       "reason": decision.reason, "step": step})


def _decode(value) -> Optional[dict]:
    value = value.decode() if isinstance(value, bytes) else value
    return None if value == "none" else json.loads(value)


def _decision(record: dict) -> RemeshDecision:
    return RemeshDecision(from_slices=tuple(record["from"]),
                          to_slices=tuple(record["to"]),
                          reason=record["reason"])


class StoreMembership:
    """Slice membership over an elastic store: a slice is alive when every
    one of its ranks has registered and has not been marked gone."""

    def __init__(self, store, groups: Dict[int, Sequence[int]]):
        self.store = store
        self.groups = {int(s): list(r) for s, r in groups.items()}

    def register(self, ranks: Iterable[int]) -> None:
        for r in ranks:
            self.store.set(_ALIVE.format(rank=r), "1")

    def forget(self, ranks: Iterable[int]) -> None:
        for r in ranks:
            self.store.set(_ALIVE.format(rank=r), "0")

    def _up(self, rank: int) -> bool:
        key = _ALIVE.format(rank=rank)
        return self.store.check([key]) and self.store.get(key) == b"1"

    def alive_slices(self) -> Set[int]:
        return {s for s, ranks in self.groups.items()
                if all(self._up(r) for r in ranks)}


class ElasticCoordinator:
    """Decides, at step boundaries, which slices the job runs on.

    ``membership`` answers "which slices are alive right now" (any
    callable, an object with ``alive_slices()``, or a `StoreMembership`);
    the coordinator holds the slice -> ranks map and the per-slice mesh
    layout, turns membership changes into :class:`RemeshDecision`s, and
    builds the mesh for any live slice set.  It never mutates trainer
    state itself: the trainer applies decisions at its own boundary
    (`Trainer.fit_elastic`).

    With a ``store`` (`parallel.distributed.elastic_store`) and this
    process's ``rank`` in the job's first numbering, the coordinators of
    all ranks agree on each boundary's decision through the store, and
    `build_mesh` forms each generation's process group over the live
    ranks (`parallel.distributed.reform_group`) before building its mesh.
    Without one it is the reference's single coordinator (its mesh over
    the default group as it stands).
    """

    def __init__(
        self,
        membership: MembershipLike,
        mesh_config: Optional[MeshConfig] = None,
        num_slices: Optional[int] = None,
        slice_devices: Optional[Dict[int, Sequence[int]]] = None,
        min_slices: int = 1,
        check_every: int = 1,
        checkpoint_wait_s: float = 60.0,
        min_slices_grace_s: float = 60.0,
        remesh_dwell_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        store=None,
        rank: Optional[int] = None,
        backend: Optional[str] = None,
        timeout_s: float = distributed.DEFAULT_TIMEOUT_S,
    ):
        """``mesh_config`` describes ONE slice's layout (its ``data``
        axis must be explicit); ``slice_devices`` maps slice id to that
        slice's ranks in the job's first numbering (default:
        ``slice_device_groups`` over the default group's ranks and
        ``num_slices``)."""
        self.membership = membership
        self.mesh_config = mesh_config or MeshConfig(data=1, fsdp=-1)
        if slice_devices is None:
            if num_slices is None:
                raise ValueError(
                    "pass num_slices or an explicit slice_devices map")
            slice_devices = slice_device_groups(num_slices=num_slices)
        self.slice_devices = {int(s): list(d)
                              for s, d in slice_devices.items()}
        self.all_slices: Tuple[int, ...] = tuple(sorted(self.slice_devices))
        if min_slices < 1:
            raise ValueError(f"min_slices must be >= 1, got {min_slices}")
        self.min_slices = int(min_slices)
        self.check_every = max(int(check_every), 1)
        self.checkpoint_wait_s = float(checkpoint_wait_s)
        # a membership blackout (head state-server restart, every beat
        # stale at once) must not kill the job instantly: below-min
        # polls HOLD the current mesh for this long before escalating
        self.min_slices_grace_s = float(min_slices_grace_s)
        # minimum time between re-meshes: a flapping slice must not
        # thrash shrink/restore/expand cycles (each shrink rewinds to the
        # last commit).  During the dwell, membership changes HOLD; the
        # below-min grace path still applies.
        self.remesh_dwell_s = float(remesh_dwell_s)
        self._clock = clock
        self._below_min_since: Optional[float] = None
        self._last_remesh_at: Optional[float] = None
        self.current: Tuple[int, ...] = self.all_slices
        # the process-group side (a store makes the ranks agree)
        if store is not None and rank is None:
            raise ValueError("a coordinator with a store needs this "
                             "process's rank")
        self.store = store
        self.rank = rank
        self.backend = backend
        self.timeout_s = float(timeout_s)
        # the generation of `current`, and the one whose group this
        # process has formed (None: none yet)
        self.generation = 0
        self._group_generation: Optional[int] = None

    # -- membership --------------------------------------------------------
    def _alive(self) -> Set[int]:
        source = self.membership
        alive = (source() if callable(source)
                 else source.alive_slices())
        return {int(s) for s in alive} & set(self.all_slices)

    def slice_of(self, rank: int) -> int:
        """The slice a rank (in the job's first numbering) belongs to."""
        return next(s for s, ranks in self.slice_devices.items()
                    if rank in ranks)

    def poll(self, step: int) -> Optional[RemeshDecision]:
        """One boundary check: compare live slices to the working set.

        Returns a decision when they differ, None to keep stepping.
        Fires ``elastic.slice_lost`` once per known slice so a chaos
        plan can deterministically mark slices lost (``drop``).  With a
        store, the decision is the one every rank adopts at this
        boundary (`_agree`).
        """
        decision = self._decide(step)
        if self.store is None:
            return decision
        return self._agree(step, decision)

    def _decide(self, step: int) -> Optional[RemeshDecision]:
        alive = self._alive()
        for slice_id in self.all_slices:
            if fire_slice_lost_seam(slice_id, step) == DIRECTIVE_DROP:
                alive.discard(slice_id)
        target = tuple(sorted(alive))
        if target == self.current:
            self._below_min_since = None
            return None
        if len(target) < self.min_slices:
            # possibly a transient membership blackout rather than a
            # real total loss: hold the current mesh for a grace window
            # and only then fail loudly
            now = self._clock()
            if self._below_min_since is None:
                self._below_min_since = now
                logger.warning(
                    "only %d slice(s) alive (%s) — below min_slices="
                    "%d; holding the current mesh for up to %.0fs",
                    len(target), list(target), self.min_slices,
                    self.min_slices_grace_s)
            if now - self._below_min_since < self.min_slices_grace_s:
                return None
            raise RuntimeError(
                f"only {len(target)} slice(s) alive "
                f"({list(target)}) — below min_slices="
                f"{self.min_slices} for more than "
                f"{self.min_slices_grace_s:.0f}s; cannot re-mesh")
        self._below_min_since = None
        if self._last_remesh_at is not None and \
                self._clock() - self._last_remesh_at < \
                self.remesh_dwell_s:
            # dwell: too soon after the last re-mesh — hold the current
            # mesh so a flapping slice costs at most one re-mesh per
            # dwell window
            return None
        lost = set(self.current) - set(target)
        reason = REASON_SLICE_LOST if lost else REASON_CAPACITY_RETURNED
        return RemeshDecision(from_slices=self.current,
                              to_slices=target, reason=reason)

    def _agree(self, step: int, mine: Optional[RemeshDecision]
               ) -> Optional[RemeshDecision]:
        """The decision of boundary (generation, step): the first rank's
        to get here, written with compare_set.  A decision that changes
        the slices is announced under its generation, and the ranks of
        the slices it drops are marked gone in the membership."""
        key = _DECISION.format(generation=self.generation, step=step)
        record = _decode(self.store.compare_set(key, "",
                                                _encode(mine, step)))
        if record is None:
            return None
        decision = _decision(record)
        lost = set(decision.from_slices) - set(decision.to_slices)
        if lost and hasattr(self.membership, "forget"):
            self.membership.forget(
                [r for s in sorted(lost) for r in self.slice_devices[s]])
        announced = json.dumps(record)
        self.store.set(_ANNOUNCED.format(generation=self.generation + 1),
                       announced)
        self.store.set(_LATEST, str(self.generation + 1))
        return decision

    def commit(self, decision: RemeshDecision) -> None:
        """The trainer applied the decision; make it the working set."""
        self.current = tuple(sorted(decision.to_slices))
        self._last_remesh_at = self._clock()
        self.generation += 1

    # -- joining and leaving -------------------------------------------------
    def admit(self) -> Tuple[RemeshDecision, int]:
        """For a process that returns to a running job (a recycled slice's
        fresh process): register with the membership, then wait for the
        generation whose decision takes this process's slice back.
        Returns (that decision, the boundary step it was made at); the
        caller applies it like every other rank (`Trainer.fit_elastic`)."""
        if self.store is None:
            raise RuntimeError("admitting a process needs the job's store")
        latest = int(self.store.get(_LATEST)) \
            if self.store.check([_LATEST]) else 0
        if hasattr(self.membership, "register"):
            self.membership.register([self.rank])
        mine = self.slice_of(self.rank)
        generation = latest + 1
        deadline = time.monotonic() + self.timeout_s
        while True:
            key = _ANNOUNCED.format(generation=generation)
            if not self.store.check([key]):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"rank {self.rank} was not taken back within "
                        f"{self.timeout_s:.0f}s (waiting on generation "
                        f"{generation})")
                time.sleep(0.05)
                continue
            record = json.loads(self.store.get(key))
            if mine in record["to"]:
                decision = _decision(record)
                self.generation = generation - 1
                self.current = decision.from_slices
                return decision, int(record["step"])
            generation += 1

    def leaves(self, decision: RemeshDecision) -> bool:
        """Whether this process's slice is not in the decision's set (it
        leaves the job at this boundary)."""
        return self.rank is not None and \
            self.slice_of(self.rank) not in decision.to_slices

    def leave(self) -> None:
        """This process leaves the job: its group is dropped (nothing is
        issued on it) and its rank marked gone."""
        if hasattr(self.membership, "forget"):
            self.membership.forget([self.rank])
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        self._group_generation = None

    # -- meshes ------------------------------------------------------------
    def build_mesh(self, slices: Optional[Sequence[int]] = None):
        """Mesh over the given (default: current) slice set.  With a
        store, first forms the process group of that set's generation
        (the current one, or the next for another set) when this process
        has not formed it yet; every member of the set must call it."""
        slices = tuple(sorted(set(self.current if slices is None
                                  else slices)))
        if self.store is not None:
            generation = self.generation + (slices != self.current)
            if self._group_generation != generation:
                order = elastic_ranks(self.slice_devices, slices)
                if self.rank not in order:
                    raise RuntimeError(
                        f"rank {self.rank} is not in slices {list(slices)}")
                if hasattr(self.membership, "register"):
                    self.membership.register([self.rank])
                distributed.reform_group(
                    self.store, generation, order.index(self.rank),
                    len(order), backend=self.backend,
                    timeout_s=self.timeout_s)
                self._group_generation = generation
        return build_elastic_mesh(self.mesh_config, self.slice_devices,
                                  slices)

    def ranks(self, slices: Optional[Sequence[int]] = None) -> List[int]:
        """The ranks of a slice set (default: current), slice-major: rank
        i of its group is the i-th."""
        return elastic_ranks(self.slice_devices,
                             self.current if slices is None else slices)
