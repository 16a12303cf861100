"""Multi-process bring-up over `torch.distributed`, with a deterministic
rank order.

Counterpart of `cloudtik_tpu/parallel/distributed.py`.  JAX runs one
process per host and `TIK_NUM_PROCESSES` counts hosts; torch runs one
process per card.  The mapping:

* torchrun (or any launcher that exports them): `RANK`, `WORLD_SIZE`,
  `LOCAL_RANK` and `MASTER_ADDR`/`MASTER_PORT` are taken as they are.
* tik-run: `TIK_COORDINATOR_ADDRESS` (host:port of host 0),
  `TIK_NUM_PROCESSES` (hosts) and `TIK_PROCESS_ID` (this host) describe
  hosts; each host runs one process per card, told apart by `LOCAL_RANK`,
  with `LOCAL_WORLD_SIZE` cards a host (default: the host's CUDA device
  count, 1 without CUDA).  Then world = hosts x local cards and rank =
  host * local cards + LOCAL_RANK: host-major, so a slice (a contiguous
  run of hosts) is a contiguous run of ranks.

The backend is NCCL when CUDA is up and gloo otherwise (or as asked), and
every group gets an explicit `timeout`.  `slice_index` / `slice_count`
read the env the launcher exports; off a launch they are the defaults.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def local_rank() -> int:
    """This process's card on its host (`LOCAL_RANK`, default 0)."""
    return _env_int("LOCAL_RANK") or 0


def _local_world_size() -> int:
    n = _env_int("LOCAL_WORLD_SIZE")
    if n is not None:
        return n
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


def auto_initialize(coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    backend: Optional[str] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S,
                    init_method: Optional[str] = None) -> bool:
    """Initialise the default process group from args > torchrun env >
    tik-run env.  `num_processes` / `process_id` count processes (cards),
    not hosts.  Returns True if a group of more than one process is (now)
    up, False for a single process.  Idempotent."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    address = coordinator_address
    if world is None and _env_int("TIK_NUM_PROCESSES") is not None:
        per_host = _local_world_size()
        world = _env_int("TIK_NUM_PROCESSES") * per_host
        rank = (_env_int("TIK_PROCESS_ID") or 0) * per_host + local_rank()
    if address is None:
        address = os.environ.get("TIK_COORDINATOR_ADDRESS")
    if address is None and "MASTER_ADDR" in os.environ:
        address = (f"{os.environ['MASTER_ADDR']}:"
                   f"{os.environ.get('MASTER_PORT', '29500')}")
    if world in (None, 1):
        return False
    if rank is None:
        raise ValueError(f"a world of {world} processes needs this "
                         "process's rank (RANK, TIK_PROCESS_ID or "
                         "process_id)")
    if init_method is None:
        if address is None:
            raise ValueError(f"a world of {world} processes needs a "
                             "coordinator address")
        init_method = f"tcp://{address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed initialised: %d/%d (%s) @ %s",
                rank, world, backend, init_method)
    return True


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: `device` if given, else
    cuda:LOCAL_RANK (the card; raises without CUDA)."""
    from cloudtik_tpu_torch.device import resolve_device

    if device is not None:
        return resolve_device(device)
    return resolve_device(f"cuda:{local_rank()}")


def slice_index(default: int = 0) -> int:
    """Which slice this process belongs to (`TIK_SLICE_INDEX` > default)."""
    env = os.environ.get("TIK_SLICE_INDEX")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            logger.warning("ignoring malformed TIK_SLICE_INDEX=%r", env)
    return default


def slice_count(default: int = 1) -> int:
    """How many slices the job spans (`TIK_NUM_SLICES` > default)."""
    env = os.environ.get("TIK_NUM_SLICES")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            logger.warning("ignoring malformed TIK_NUM_SLICES=%r", env)
    return default


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0
