"""Device resolution for the port's entry points.

`device=None` means the card.  Without CUDA an entry point raises rather
than quietly running on the CPU; a caller that wants the CPU (the tests)
says so with `device="cpu"`.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev

