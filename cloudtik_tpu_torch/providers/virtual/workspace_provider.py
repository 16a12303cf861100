"""Virtual workspace provider: a directory standing in for shared infra.

Reference parity: the local/virtual providers' workspace handling
(SURVEY.md §2.2) — no real VPC/IAM; existence = directory + marker file.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.workspace_provider import Existence, WorkspaceProvider


def workspace_root(name: str) -> str:
    return os.path.expanduser(f"~/.tik/workspaces/{name}")


class VirtualWorkspaceProvider(WorkspaceProvider):
    def _root(self) -> str:
        return self.provider_config.get(
            "root_dir") or workspace_root(self.workspace_name)

    def create_workspace(self, config):
        root = self._root()
        os.makedirs(os.path.join(root, "storage"), exist_ok=True)
        with open(os.path.join(root, "workspace.json"), "w") as f:
            json.dump({"name": self.workspace_name,
                       "provider": "virtual"}, f)

    def delete_workspace(self, config, delete_managed_storage=False,
                         delete_managed_database=False):
        root = self._root()
        if os.path.isdir(root):
            if delete_managed_storage:
                shutil.rmtree(root, ignore_errors=True)
            else:
                marker = os.path.join(root, "workspace.json")
                if os.path.exists(marker):
                    os.unlink(marker)

    def update_workspace(self, config, **kwargs):
        self.create_workspace(config)

    def check_workspace_existence(self, config) -> Existence:
        root = self._root()
        marker = os.path.join(root, "workspace.json")
        storage = os.path.join(root, "storage")
        if os.path.exists(marker):
            return Existence.COMPLETED
        if os.path.isdir(storage):
            return Existence.STORAGE_ONLY
        return Existence.NOT_EXIST

    def publish_global_variables(self, cluster_config, global_variables):
        root = self._root()
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, "globals.json")
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data.update(global_variables)
        with open(path, "w") as f:
            json.dump(data, f)

    def subscribe_global_variables(self, cluster_config) -> Dict[str, Any]:
        path = os.path.join(self._root(), "globals.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def get_workspace_info(self, config):
        return {"name": self.workspace_name, "root": self._root(),
                "existence": self.check_workspace_existence(config).name}
