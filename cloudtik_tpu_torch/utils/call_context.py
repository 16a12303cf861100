"""Per-call context carrying the CLI logger + call config flags.

Reference parity: core/_private/call_context.py:90.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from cloudtik_tpu_torch.utils.cli_logger import CliLogger, cli_logger


class CallContext:
    def __init__(self, _cli_logger: CliLogger = None):
        self.cli_logger = _cli_logger or cli_logger
        self.config: Dict[str, Any] = {
            "use_login_shells": True,
            "ssh_control_path": None,
            "allow_interactive": True,
            "output_redirected": False,
        }

    def new_call_context(self) -> "CallContext":
        ctx = CallContext(self.cli_logger)
        ctx.config = copy.deepcopy(self.config)
        return ctx
