"""NHWC convolution helpers for the vision models.

Counterpart of `cloudtik_tpu/ops/conv.py`.  Activations are NHWC and
kernels HWIO `[kh, kw, c_in/groups, c_out]`, as in the JAX package, so
parameter trees convert with no transposes.  At each call the kernel is cast
to the compute dtype and permuted to OIHW, and the activation is handed to
cuDNN as an NCHW view in `channels_last` memory, which is the same NHWC
bytes: no layout copy on either side.

`padding="SAME"` in XLA is asymmetric: the total pad is
`max((out - 1) * s + k - in, 0)`, the low side `total // 2` and the high
side the rest.  `F.conv2d(padding=k // 2)` pads both sides alike and shifts
every stride-2 output, so the port pads with `F.pad` first.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

KERNEL_AXES: Tuple[None, None, str, str] = (None, None, "conv_in",
                                            "conv_out")


def conv_kernel_axes() -> Tuple[None, None, str, str]:
    return KERNEL_AXES


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same_nchw(x: torch.Tensor, kh: int, kw: int, stride: int,
                  value: float = 0.0) -> torch.Tensor:
    """x [N, C, H, W] padded as XLA's SAME would for a (kh, kw) window."""
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
              dtype: torch.dtype = torch.bfloat16,
              groups: int = 1) -> torch.Tensor:
    """x [N, H, W, C_in], kernel HWIO -> [N, H', W', C_out] in `dtype`,
    SAME padding; `groups` > 1 is a grouped conv (ResNeXt cardinality)."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    xc = x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    xc = pad_same_nchw(xc, kh, kw, stride)
    w = kernel.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(xc, w, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv_kernel_init(generator: torch.Generator, kh: int, kw: int,
                     c_in: int, c_out: int, param_dtype: torch.dtype,
                     groups: int = 1,
                     device: torch.device = None) -> torch.Tensor:
    """HWIO kernel, truncated normal in [-2, 2] times sqrt(2 / fan_in) as
    in the JAX package; for grouped convs the I dim is c_in // groups.
    Draws come from `generator`, so they differ from jax.random's."""
    fan_in = kh * kw * (c_in // groups)
    w = torch.empty((kh, kw, c_in // groups, c_out), device=device,
                    dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (2.0 / fan_in) ** 0.5).to(param_dtype)
