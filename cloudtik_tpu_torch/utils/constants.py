"""Central env-var knobs and timing constants.

Reference parity: core/_private/constants.py (env_integer pattern :124-136).
"""

from __future__ import annotations

import os


def env_integer(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, default))
    except ValueError:
        return default


def env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, default))
    except ValueError:
        return default


def env_bool(key: str, default: bool) -> bool:
    v = os.environ.get(key)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


# --- control plane timing ---------------------------------------------------
# Scaler reconciliation period (reference: CLOUDTIK_UPDATE_INTERVAL_S=5).
TIK_UPDATE_INTERVAL_S = env_integer("TIK_UPDATE_INTERVAL_S", 5)
# Node agent heartbeat period (reference: 1s, constants.py:136).
TIK_HEARTBEAT_PERIOD_S = env_float("TIK_HEARTBEAT_PERIOD_S", 1.0)
# Grace window after a node's bootstrap completes before a missing
# heartbeat may condemn it (the freshly-started agent needs time to import,
# connect, and publish its first heartbeat).
TIK_BOOT_GRACE_S = env_integer("TIK_BOOT_GRACE_S", 120)

# Heartbeat timeout before a node is unhealthy (reference: 30s).
TIK_HEARTBEAT_TIMEOUT_S = env_integer("TIK_HEARTBEAT_TIMEOUT_S", 30)
# Max boot time the scaler tolerates before declaring a launch failed.
TIK_NODE_START_WAIT_S = env_integer("TIK_NODE_START_WAIT_S", 900)
# Max concurrent node launches.
TIK_MAX_CONCURRENT_LAUNCHES = env_integer("TIK_MAX_CONCURRENT_LAUNCHES", 10)
# Max concurrent node updaters (SSH bootstraps).
TIK_MAX_CONCURRENT_UPDATES = env_integer("TIK_MAX_CONCURRENT_UPDATES", 20)

# --- state store -------------------------------------------------------------
TIK_STATE_PORT_DEFAULT = env_integer("TIK_STATE_PORT", 6879)
TIK_STATE_NAMESPACE_DEFAULT = "tik"

# --- metrics -----------------------------------------------------------------
TIK_METRICS_PORT_DEFAULT = env_integer("TIK_METRICS_PORT", 44217)
# telemetry HTTP exposition (/metrics, /trace, /trace/summary) served by
# head services; `tik trace`/`tik metrics` fetch from it
TIK_TELEMETRY_PORT_DEFAULT = env_integer("TIK_TELEMETRY_PORT", 9103)

# --- files on nodes ----------------------------------------------------------
def tik_home() -> str:
    """Dynamic TIK_HOME (tests point it at a temp dir after import)."""
    return os.path.expanduser(os.environ.get("TIK_HOME", "~/.tik"))


TIK_HOME = tik_home()
TIK_BOOTSTRAP_CONFIG_FILE = os.path.join(TIK_HOME, "bootstrap-config.yaml")
# Remote-relative form: used as rsync target / file-mount key so the REMOTE
# user's home is expanded on the node, not the operator's local home.
TIK_BOOTSTRAP_CONFIG_REMOTE = "~/.tik/bootstrap-config.yaml"
TIK_BOOTSTRAP_KEY_FILE = os.path.join(TIK_HOME, "bootstrap-key.pem")
TIK_RUNTIME_ENV_FILE = os.path.join(TIK_HOME, "runtime-env.json")
TIK_LOGS_DIR = os.path.join(TIK_HOME, "logs")
TIK_RUN_DIR = os.path.join(TIK_HOME, "run")

# --- AI / launcher -----------------------------------------------------------
TIK_COORDINATOR_PORT_DEFAULT = env_integer("TIK_COORDINATOR_PORT", 8476)
