"""The control's precision: float8 (e4m3) operands, one scale a tensor.

The configurations compute in bf16, so the control puts the reference in
the program's place computed a step lower: both operands of every matrix
product rounded to float8 e4m3 after scaling the tensor's largest
magnitude to e4m3's largest (448), the products summed in float32.  The
rounding passes the gradient straight through, so a training control
also differentiates at the lowered precision's forward.
"""

import torch

E4M3_MAX = 448.0


class _RoundE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def e4m3(x: torch.Tensor) -> torch.Tensor:
    return _RoundE4M3.apply(x)
