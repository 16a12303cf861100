"""Node tag/label constants.

Tags are the control plane's durable per-node metadata, stored by the provider
(cloud labels, or in-memory for the virtual provider).  Reference parity:
core/tags.py (CLOUDTIK_TAG_*), extended with node-group tags for atomic TPU
pod slices.
"""

# --- Node kind -------------------------------------------------------------
TAG_NODE_KIND = "tik-node-kind"
NODE_KIND_HEAD = "head"
NODE_KIND_WORKER = "worker"

# --- Node status (bootstrap lifecycle) -------------------------------------
TAG_NODE_STATUS = "tik-node-status"
STATUS_UNINITIALIZED = "uninitialized"
STATUS_WAITING_FOR_SSH = "waiting-for-ssh"
STATUS_SYNCING_FILES = "syncing-files"
STATUS_SETTING_UP = "setting-up"
STATUS_UPDATE_FAILED = "update-failed"
STATUS_UP_TO_DATE = "up-to-date"

# --- Identity --------------------------------------------------------------
TAG_CLUSTER_NAME = "tik-cluster-name"
TAG_WORKSPACE_NAME = "tik-workspace-name"
TAG_NODE_NAME = "tik-node-name"
TAG_NODE_SEQ_ID = "tik-node-seq-id"          # stable small integer per node
TAG_NODE_NUMBER = "tik-node-number"          # launch ordinal
TAG_HEAD_NODE_SEQ_ID = 1

# --- Node type (entry in available_node_types) -----------------------------
TAG_USER_NODE_TYPE = "tik-user-node-type"

# --- Config hashes (idempotent reconciliation) -----------------------------
# hash of launch config -> node needs replacement when changed
TAG_LAUNCH_CONFIG = "tik-launch-config"
# hash of file mounts + setup commands -> node needs re-setup when changed
TAG_RUNTIME_CONFIG = "tik-runtime-config"
# hash of file mounts only (for no-restart sync)
TAG_FILE_MOUNTS_CONTENTS = "tik-file-mounts-contents"

# --- Node groups (TPU pod slices; no reference equivalent) -----------------
# A node group is an atomic multi-host unit: all member nodes are created and
# terminated together, and failure of any member fails the group.  For a GCP
# TPU pod slice the group id is the TPU name; members are its worker VMs.
TAG_NODE_GROUP_ID = "tik-node-group-id"
TAG_NODE_GROUP_WORKER_INDEX = "tik-node-group-worker-index"  # host index in slice
TAG_NODE_GROUP_SIZE = "tik-node-group-size"

# --- Quorum (stateful runtimes) --------------------------------------------
TAG_QUORUM_ID = "tik-quorum-id"
TAG_QUORUM_JOIN = "tik-quorum-join"
QUORUM_JOIN_STATUS_INIT = "init"
