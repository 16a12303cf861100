"""Distributor: normalize host/process topology for a distributed launch.

Counterpart of `cloudtik_tpu/launch/distributor.py` (hosts, `host:slots`,
hostfiles, `num_nodes`, `num_slices`).  The JAX package runs ONE process a
host, which owns all of the host's chips.  Torch runs one process a card,
so a host runs `nproc_per_node` processes (default: the host's CUDA device
count, 1 without CUDA).  `env_for(host)` is the host-level env the
reference exports; `env_for(host, local)` adds `LOCAL_RANK` and
`LOCAL_WORLD_SIZE`, from which `parallel.distributed.auto_initialize`
takes world = hosts x nproc_per_node and rank = host x nproc_per_node +
LOCAL_RANK (host-major, so a slice is a contiguous run of ranks).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence


def default_nproc_per_node() -> int:
    """The host's CUDA device count, 1 without CUDA."""
    import torch

    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


@dataclasses.dataclass
class HostSpec:
    address: str
    slots: int = 1          # informational; nproc_per_node sets the ranks

    @staticmethod
    def parse(text: str) -> "HostSpec":
        # accepted: "host", "host:slots"
        if ":" in text:
            host, slots = text.rsplit(":", 1)
            return HostSpec(host.strip(), int(slots))
        return HostSpec(text.strip())


class Distributor:
    def __init__(
        self,
        hosts: Optional[Sequence[str]] = None,
        hostfile: Optional[str] = None,
        num_nodes: Optional[int] = None,
        coordinator_port: int = 8476,
        num_slices: Optional[int] = None,
        nproc_per_node: Optional[int] = None,
    ):
        specs: List[HostSpec] = []
        if hostfile:
            with open(os.path.expanduser(hostfile)) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        specs.append(HostSpec.parse(line))
        if hosts:
            for h in hosts:
                for part in str(h).split(","):
                    if part.strip():
                        specs.append(HostSpec.parse(part))
        if not specs:
            specs = [HostSpec("127.0.0.1")]
        if num_nodes is not None:
            if num_nodes > len(specs):
                raise ValueError(
                    f"num_nodes={num_nodes} > available hosts {len(specs)}")
            specs = specs[:num_nodes]
        self.hosts = specs
        self.coordinator_port = coordinator_port
        # Multi-slice topology: hosts split into `num_slices` contiguous
        # groups; each process learns its host's dense slice index through
        # env (parallel/distributed.slice_index)
        if num_slices is not None:
            if num_slices < 1 or len(specs) % num_slices != 0:
                raise ValueError(
                    f"num_slices={num_slices} must evenly divide the "
                    f"{len(specs)} launch host(s)")
        self.num_slices = num_slices
        if nproc_per_node is not None and nproc_per_node < 1:
            raise ValueError(f"nproc_per_node={nproc_per_node} must be >= 1")
        self.nproc_per_node = nproc_per_node if nproc_per_node is not None \
            else default_nproc_per_node()

    @property
    def num_processes(self) -> int:
        """Hosts, as the reference counts them (`TIK_NUM_PROCESSES`)."""
        return len(self.hosts)

    @property
    def coordinator_address(self) -> str:
        return f"{self.hosts[0].address}:{self.coordinator_port}"

    def distributed(self) -> bool:
        """More than one host (the launch fans out over ssh)."""
        return self.num_processes > 1

    def env_for(self, process_index: int,
                local_rank: Optional[int] = None) -> dict:
        """Env exported to the processes on host `process_index`; with
        `local_rank`, that one process's (its card on the host)."""
        env = {
            "TIK_COORDINATOR_ADDRESS": self.coordinator_address,
            "TIK_NUM_PROCESSES": str(self.num_processes),
            "TIK_PROCESS_ID": str(process_index),
        }
        if self.num_slices:
            hosts_per_slice = self.num_processes // self.num_slices
            env["TIK_SLICE_INDEX"] = str(
                process_index // hosts_per_slice)
            env["TIK_NUM_SLICES"] = str(self.num_slices)
        if local_rank is not None:
            env.update(local_env(local_rank, self.nproc_per_node))
        return env


def local_env(local_rank: int, nproc_per_node: int) -> dict:
    """The per-card part of a process's env."""
    if not 0 <= local_rank < nproc_per_node:
        raise ValueError(f"local rank {local_rank} outside "
                         f"[0, {nproc_per_node})")
    return {"LOCAL_RANK": str(local_rank),
            "LOCAL_WORLD_SIZE": str(nproc_per_node)}
