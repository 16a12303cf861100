from cloudtik_tpu_torch.config.loader import (  # noqa: F401
    deep_merge,
    fill_with_defaults,
    load_yaml,
    prepare_config,
)
from cloudtik_tpu_torch.config.schema import validate_cluster_config, validate_workspace_config  # noqa: F401
