"""Cluster debug-archive collection.

Reference parity: core/_private/cluster/cluster_dump.py:783 (`cloudtik
cluster-dump` — logs/configs/process info zipped from all nodes).  The
head collects its own artifacts locally and pulls per-node artifacts via
each node's command executor (rsync-down), producing one tar.gz.
"""

from __future__ import annotations

import datetime
import io
import json
import os
import shutil
import tarfile
import tempfile
from typing import Any, Callable, Dict, List, Optional

DEFAULT_LOG_DIRS = ["~/.tik/logs"]
DEFAULT_CONF_GLOBS = ["~/.tik/bootstrap-config.yaml"]


def collect_local(archive_dir: str,
                  log_dirs: Optional[List[str]] = None,
                  conf_paths: Optional[List[str]] = None,
                  processes: bool = True) -> List[str]:
    """Copy this host's logs/configs/process table into archive_dir;
    returns the created paths."""
    created = []
    os.makedirs(archive_dir, exist_ok=True)
    for log_dir in (log_dirs or DEFAULT_LOG_DIRS):
        src = os.path.expanduser(log_dir)
        if os.path.isdir(src):
            dst = os.path.join(archive_dir, "logs",
                               os.path.basename(src.rstrip("/")))
            shutil.copytree(src, dst, dirs_exist_ok=True)
            created.append(dst)
    for conf in (conf_paths or DEFAULT_CONF_GLOBS):
        src = os.path.expanduser(conf)
        if os.path.isfile(src):
            dst = os.path.join(archive_dir, "config",
                               os.path.basename(src))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(src, dst)
            created.append(dst)
    if processes:
        dst = os.path.join(archive_dir, "processes.json")
        with open(dst, "w") as f:
            json.dump(_process_table(), f, indent=1)
        created.append(dst)
    # flight-recorder journals, the default and the serving runtime's
    from cloudtik_tpu_torch.runtimes.serving.runtime import journal_path
    from cloudtik_tpu_torch.telemetry import events as tevents
    serving = tevents.journal_files(journal_path())
    for src in dict.fromkeys(tevents.journal_files() + serving):
        dst = os.path.join(archive_dir, "events", os.path.basename(src))
        try:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(src, dst)
        except OSError:
            # a live daemon may rotate the journal between listing and
            # copy — losing one generation must not lose the whole dump
            continue
        created.append(dst)
    return created


def _process_table() -> List[Dict[str, Any]]:
    try:
        import psutil
    except ImportError:
        return []
    out = []
    for proc in psutil.process_iter(["pid", "name", "cmdline",
                                     "cpu_percent", "memory_percent"]):
        try:
            info = proc.info
            cmdline = " ".join(info.get("cmdline") or [])
            if "tik" in cmdline or "tik" in (info.get("name") or ""):
                out.append({"pid": info["pid"], "name": info["name"],
                            "cmdline": cmdline[:500]})
        except (psutil.NoSuchProcess, psutil.AccessDenied):
            continue
    return out


def collect_from_node(node_id: str, executor, archive_dir: str,
                      log_dirs: Optional[List[str]] = None) -> str:
    """Pull a node's ~/.tik/logs into archive_dir/<node_id>/ via the
    executor's rsync-down."""
    node_dir = os.path.join(archive_dir, "nodes", node_id)
    os.makedirs(node_dir, exist_ok=True)
    for log_dir in (log_dirs or DEFAULT_LOG_DIRS):
        try:
            executor.run_rsync_down(log_dir + "/", node_dir)
        except Exception as e:
            with open(os.path.join(node_dir, "rsync-error.txt"),
                      "a") as f:
                f.write(f"{log_dir}: {e}\n")
    return node_dir


def create_archive(output_path: Optional[str] = None,
                   cluster_name: str = "cluster",
                   collect: Optional[Callable[[str], None]] = None
                   ) -> str:
    """Build the tar.gz.  `collect(staging_dir)` fills the staging dir
    (defaults to local-only collection); returns the archive path."""
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    output_path = output_path or f"tik-dump-{cluster_name}-{stamp}.tar.gz"
    staging = tempfile.mkdtemp(prefix="tik-dump-")
    try:
        if collect is not None:
            collect(staging)
        else:
            collect_local(staging)
        with tarfile.open(output_path, "w:gz") as tar:
            tar.add(staging, arcname=f"tik-dump-{cluster_name}")
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return output_path
