"""Quorum manager: minimal-node / quorum launch semantics.

Reference parity: core/_private/cluster/quorum_manager.py (NodeConstraints:19,
QuorumManager:29, wait_for_update:160, _publish_nodes_for_quorum:266).

Two related semantics live here:
  * minimal-launch: a runtime declares it needs N nodes of a type up
    *together* before services start (e.g. etcd, zookeeper).
  * atomic node groups (TPU pod slices): membership is provider-defined and
    failure of any member fails the whole group — the scaler consults this
    manager to expand a single unhealthy host into its full group.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Set

from cloudtik_tpu_torch.core.node_provider import NodeProvider
from cloudtik_tpu_torch.core.runtime import NodeConstraint
from cloudtik_tpu_torch.core.tags import (
    TAG_NODE_GROUP_ID, TAG_QUORUM_ID, TAG_USER_NODE_TYPE)

logger = logging.getLogger(__name__)


class QuorumManager:
    def __init__(self, provider: NodeProvider,
                 constraints: Dict[str, NodeConstraint]):
        # constraints: node_type -> NodeConstraint from runtimes
        self.provider = provider
        self.constraints = constraints
        self._quorum_seq = int(time.time())

    # --- minimal-launch -----------------------------------------------------
    def commit_launch(self, node_type: str, requested: int,
                      existing: int) -> int:
        """Gate a launch: for a constrained type, only launch when the full
        minimal set can be requested at once (all-or-nothing)."""
        constraint = self.constraints.get(node_type)
        if constraint is None:
            return requested
        missing = max(constraint.minimal - existing, 0)
        if missing == 0:
            if not constraint.scalable:
                return 0
            return requested
        if requested + existing < constraint.minimal:
            logger.info(
                "quorum: holding launch of %s (%d requested, %d existing, "
                "minimal %d)", node_type, requested, existing,
                constraint.minimal)
            return 0
        return requested

    def is_satisfied(self, node_type: str, ready: int) -> bool:
        constraint = self.constraints.get(node_type)
        return constraint is None or ready >= constraint.minimal

    def assign_quorum(self, node_ids: List[str]) -> str:
        """Stamp a fresh quorum id on a newly-completed minimal set."""
        quorum_id = f"q-{self._quorum_seq}"
        self._quorum_seq += 1
        for node_id in node_ids:
            tags = self.provider.node_tags(node_id)
            if TAG_QUORUM_ID not in tags:
                self.provider.set_node_tags(
                    node_id, {TAG_QUORUM_ID: quorum_id})
        return quorum_id

    # --- atomic groups ------------------------------------------------------
    def expand_to_group(self, node_ids: List[str]) -> Set[str]:
        """Expand node ids to full group membership: if any member of an
        atomic group is in the set, all members are."""
        if not self.provider.supports_node_groups():
            return set(node_ids)
        result: Set[str] = set(node_ids)
        groups = self.provider.list_node_groups({})
        for group_id, members in groups.items():
            if result & set(members):
                result.update(members)
        return result

    def groups_of(self, node_ids: List[str]) -> Dict[str, List[str]]:
        """group id -> members, for the given nodes ('' = ungrouped)."""
        out: Dict[str, List[str]] = {}
        for node_id in node_ids:
            tags = self.provider.node_tags(node_id)
            gid = tags.get(TAG_NODE_GROUP_ID, "")
            out.setdefault(gid, []).append(node_id)
        return out
