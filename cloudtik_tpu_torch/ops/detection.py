"""Detection ops for Hopper: greedy NMS and ROIAlign as hand-written CUDA
kernels, with their plain PyTorch versions.

Counterpart of `cloudtik_tpu/ops/detection.py`.  `csrc/nms.cu` replaces the
Pallas `_nms_kernel` (one block per image: the greedy argmax loop as a scan
of the candidates in score order, ordered a band at a time by a radix
select and a sort of its own, resolved 64 at a time with suppression
bitmasks; any box count); `csrc/roi_align.cu` replaces
`_roi_align_kernel` (a gather with the ROI's taps in shared memory, by one
of two routes that `roi_align_route` picks: 16-byte loads of 8 channels of
a bf16 NHWC map, or scalar loads through any strides).

`nms` / `nms_batched` and `roi_align` / `roi_align_batched` launch the
kernel on a CUDA tensor and run the plain version (`nms_reference`,
`roi_align_reference`) on a CPU tensor; on a CUDA tensor they launch or
raise, and never fall back.  The batched entries are the written-out `vmap`
of the JAX callers, so one `detect` call launches each kernel once per
pooled size, over all images.

ROIAlign has a gradient with respect to the features on both devices
(`_RoIAlignFn`): the forward is the kernel or the plain version as above,
and the backward is `roi_align_grad`, the same torch code on both, the
adjoint of the reference's weight-matmul form `_roi_align_one` (the JAX
package differentiates that form with XLA and has no backward Pallas
kernel).  The ROIs get no gradient: ones that require it are refused.
`sigmoid_focal_loss` and `optax_sigmoid_ce` are elementwise torch ops, as
XLA fuses them in the reference.

The plain NMS is `_nms_select_rows` op for op: areas, intersection and union
in the JAX order, `iou > thr` strict and in f32 (the threshold is a weak
Python float in JAX, so f32(thr)), the lowest index winning ties, a score at
or below -5e29 counting as absent, NaN propagated as XLA does (a NaN score
keeps nothing in its image; a box with a NaN coordinate suppresses nothing
and is never suppressed).  Eager torch rounds after each op, as XLA does, so
nothing is contracted into an FMA.  The kernel keeps the same order with
round-to-nearest intrinsics, so the two keep lists are equal.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

_NEG_INF = -1e30

# Launches of each CUDA kernel in this process (its wrapper adds one per
# launch and nowhere else), so a run can show its path went through them.
LAUNCHES_NMS = 0
LAUNCHES_ROI_ALIGN = 0
# The route of the last ROIAlign launch ("vector" or "strided"), so a run
# can show which form of csrc/roi_align.cu its path took.
LAST_ROI_ROUTE = None

# ROIs the plain ROIAlign gathers, and its gradient contracts, at a time:
# bounds the gather's [R, C, P*s, P*s] temporaries at full width (4 x 25 MB
# at Mask R-CNN's 14x14) and the gradient's [B, R, C, P, W] (235 MB at
# B=4 there, against 0.94 GB for all 128 ROIs at once)
_ROI_CHUNK = 32
_ROI_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROI_ROUTE_CODES = {"strided": 0, "vector": 1}
# csrc/roi_align.cu's vector route stages 64 channels x P*P f32 outputs
# (plus one float in 32) and its tap table within a block's 227 KB
_ROI_VEC_CHANNELS = 64
_SMEM_BYTES = 227 * 1024


# --------------------------------------------------------------------------
# IoU
# --------------------------------------------------------------------------

def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU.  boxes_a [*, M, 4], boxes_b [*, N, 4] as (x1, y1, x2,
    y2), their leading dims broadcast -> [*, M, N]; the JAX `box_iou` op
    for op (per image, as its callers vmap it)."""
    area_a = ((boxes_a[..., 2] - boxes_a[..., 0])
              * (boxes_a[..., 3] - boxes_a[..., 1]))
    area_b = ((boxes_b[..., 2] - boxes_b[..., 0])
              * (boxes_b[..., 3] - boxes_b[..., 1]))
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


# --------------------------------------------------------------------------
# NMS
# --------------------------------------------------------------------------

def _check_nms(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"boxes must be [B, N, 4] and scores [B, N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")


def nms_reference_batched(boxes: torch.Tensor, scores: torch.Tensor, *,
                          iou_threshold: float = 0.5,
                          max_output: int = 100) -> torch.Tensor:
    """Plain PyTorch NMS per image, the semantics of the kernel
    (`_nms_select_rows` over a batch): boxes [B, N, 4], scores [B, N] ->
    keep [B, max_output] int32, -1-padded, by descending score."""
    _check_nms(boxes, scores)
    B, n = scores.shape
    max_output = int(max_output)
    boxes = boxes.float()
    live = scores.float().clone()
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    col = torch.arange(n, device=live.device).expand(B, n)
    thr = torch.tensor(float(iou_threshold), dtype=torch.float32)
    keep = torch.full((B, max_output), -1, dtype=torch.int32,
                      device=live.device)
    neg = torch.tensor(_NEG_INF, dtype=torch.float32, device=live.device)
    for k in range(max_output):
        m = live.max(dim=-1, keepdim=True).values
        valid = m > _NEG_INF / 2
        best = torch.where(live == m, col, n).min(dim=-1, keepdim=True).values
        onehot = col == best
        idx = best.clamp(max=n - 1)
        bx1, by1 = x1.gather(1, idx), y1.gather(1, idx)
        bx2, by2 = x2.gather(1, idx), y2.gather(1, idx)
        barea = areas.gather(1, idx)
        inter = ((torch.minimum(bx2, x2) - torch.maximum(bx1, x1)).clamp(
            min=0) * (torch.minimum(by2, y2)
                      - torch.maximum(by1, y1)).clamp(min=0))
        iou = inter / (barea + areas - inter).clamp(min=1e-9)
        suppress = (iou > thr) | onehot
        live = torch.where(valid & suppress, neg, live)
        keep[:, k] = torch.where(valid[:, 0], best[:, 0].int(),
                                 keep[:, k])
    return keep


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor, *,
                  iou_threshold: float = 0.5,
                  max_output: int = 100) -> torch.Tensor:
    """Plain PyTorch NMS: boxes [N, 4], scores [N] -> keep [max_output]
    int32, -1-padded, by descending score."""
    return nms_reference_batched(boxes[None], scores[None],
                                 iou_threshold=iou_threshold,
                                 max_output=max_output)[0]


def _kernel_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, max_output: int) -> torch.Tensor:
    """Launch csrc/nms.cu on CUDA tensors; raise on what it does not take."""
    global LAUNCHES_NMS
    from cloudtik_tpu_torch.ops import _kernels

    B, N = scores.shape
    if boxes.device != scores.device:
        raise ValueError("boxes and scores must be on the same CUDA device")
    if max_output < 1:
        raise ValueError(f"max_output must be positive, got {max_output}")
    boxes = boxes.float().contiguous()
    scores = scores.float().contiguous()
    keep = torch.empty((B, max_output), dtype=torch.int32,
                       device=boxes.device)
    # the boxes kept so far, which each later candidate is held against
    kept = torch.empty((B, max_output, 4), dtype=torch.float32,
                       device=boxes.device)
    lib = _kernels.library("nms")
    err = lib.tik_nms(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                      kept.data_ptr(), B, N, max_output,
                      float(iou_threshold),
                      torch.cuda.current_stream(boxes.device).cuda_stream)
    _kernels.check(lib, err, "nms launch")
    LAUNCHES_NMS += 1
    return keep


def nms_batched(boxes: torch.Tensor, scores: torch.Tensor, *,
                iou_threshold: float = 0.5,
                max_output: int = 100) -> torch.Tensor:
    """Greedy NMS per image: boxes [B, N, 4] xyxy, scores [B, N] -> keep
    [B, max_output] int32, -1-padded, in descending score order.  The CUDA
    kernel for CUDA tensors (one launch for the batch), the plain version
    for CPU tensors; any other device raises."""
    _check_nms(boxes, scores)
    if boxes.is_cuda:
        return _kernel_nms(boxes, scores, iou_threshold, int(max_output))
    if boxes.device.type == "cpu":
        return nms_reference_batched(boxes, scores,
                                     iou_threshold=iou_threshold,
                                     max_output=max_output)
    raise ValueError(f"no nms for device {boxes.device}")


def nms(boxes: torch.Tensor, scores: torch.Tensor, *,
        iou_threshold: float = 0.5, max_output: int = 100) -> torch.Tensor:
    """Non-maximum suppression.  boxes [N, 4], scores [N] -> keep indices
    [max_output] int32, -1-padded, in descending score order."""
    n = boxes.shape[0]
    if tuple(scores.shape) != (n,):
        raise ValueError(f"scores {tuple(scores.shape)} vs boxes "
                         f"{tuple(boxes.shape)}")
    return nms_batched(boxes[None], scores[None],
                       iou_threshold=iou_threshold,
                       max_output=max_output)[0]


# --------------------------------------------------------------------------
# ROIAlign
# --------------------------------------------------------------------------

def _check_roi(features: torch.Tensor, rois: torch.Tensor) -> None:
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4 \
            or rois.shape[0] != features.shape[0]:
        raise ValueError(f"features must be [B, C, H, W] and rois "
                         f"[B, R, 4], got {tuple(features.shape)} and "
                         f"{tuple(rois.shape)}")


def _sample_coords(rois: torch.Tensor, pooled: int, sampling: int,
                   spatial_scale: float):
    """Per-axis sample coordinates [R, pooled * sampling] for rois [R, 4]
    (x1, y1, x2, y2), ROIAlign's aligned=False convention, as the JAX
    `_roi_sample_coords` computes them."""
    x1, y1, x2, y2 = rois.unbind(-1)
    w = ((x2 - x1) * spatial_scale).clamp(min=1.0)
    h = ((y2 - y1) * spatial_scale).clamp(min=1.0)
    # Divisors as tensors: CUDA torch divides by a Python scalar as a
    # product with its rounded reciprocal, an ulp off IEEE division here
    # and there, and an ulp of a coordinate near 31 moves an output by
    # ~2e-5.  JAX and the kernel divide.
    p = torch.full_like(w, pooled)
    bin_w = (w / p)[:, None]
    bin_h = (h / p)[:, None]
    s = torch.arange(pooled * sampling, dtype=torch.float32,
                     device=rois.device)
    samp = torch.full_like(bin_w, sampling)
    xs = x1[:, None] * spatial_scale + (s + 0.5) * bin_w / samp
    ys = y1[:, None] * spatial_scale + (s + 0.5) * bin_h / samp
    return ys - 0.5, xs - 0.5


def _roi_align_image(features: torch.Tensor, rois: torch.Tensor,
                     pooled: int, sampling: int,
                     spatial_scale: float) -> torch.Tensor:
    """Gather-form ROIAlign of one image: [C, H, W] x [R, 4] ->
    [R, C, pooled, pooled] f32 (`roi_align_reference` of the JAX package,
    with the ROIs as a batch dimension)."""
    C, H, W = features.shape
    f = features.float()
    ys, xs = _sample_coords(rois.float(), pooled, sampling, spatial_scale)
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = ys.floor().long().clamp(0, H - 1)
    x0 = xs.floor().long().clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    wy1 = ys - y0
    wx1 = xs - x0

    def sample(yi, xi):   # -> [R, C, S, S]
        return f[:, yi[:, :, None], xi[:, None, :]].permute(1, 0, 2, 3)

    wy1_, wx1_ = wy1[:, None, :, None], wx1[:, None, None, :]
    val = (sample(y0, x0) * ((1 - wy1_) * (1 - wx1_))
           + sample(y0, x1) * ((1 - wy1_) * wx1_)
           + sample(y1, x0) * (wy1_ * (1 - wx1_))
           + sample(y1, x1) * (wy1_ * wx1_))
    R = rois.shape[0]
    val = val.reshape(R, C, pooled, sampling, pooled, sampling)
    return val.mean(dim=(3, 5))


def roi_align_reference_batched(features: torch.Tensor, rois: torch.Tensor,
                                *, pooled_size: int = 7,
                                sampling_ratio: int = 2,
                                spatial_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch ROIAlign over a batch: features [B, C, H, W] (any
    strides and float dtype), rois [B, R, 4] -> [B, R, C, P, P] f32."""
    _check_roi(features, rois)
    B, R = rois.shape[:2]
    out = [torch.cat([_roi_align_image(features[b], rois[b, i:i + _ROI_CHUNK],
                                       pooled_size, sampling_ratio,
                                       spatial_scale)
                      for i in range(0, max(R, 1), _ROI_CHUNK)])
           for b in range(B)]
    return torch.stack(out)


def roi_align_reference(features: torch.Tensor, rois: torch.Tensor, *,
                        pooled_size: int = 7, sampling_ratio: int = 2,
                        spatial_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch ROIAlign: features [C, H, W], rois [R, 4] ->
    [R, C, P, P] f32."""
    return roi_align_reference_batched(
        features[None], rois[None], pooled_size=pooled_size,
        sampling_ratio=sampling_ratio, spatial_scale=spatial_scale)[0]


def roi_align_route(features: torch.Tensor, pooled_size: int = 7,
                    sampling_ratio: int = 2) -> str:
    """Which form of csrc/roi_align.cu takes these features [B, C, H, W]:
    "vector" for bf16 with channel stride 1, C a multiple of 8, a 16-byte
    aligned base and strides, offsets within an image in 32 bits and the
    staged outputs within shared memory (the detect path's NHWC map
    permuted to [B, C, H, W]); "strided" for anything else."""
    _, C, H, W = features.shape
    sb, sc, sh, sw = features.stride()
    pp = int(pooled_size) ** 2
    smem = (4 * (_ROI_VEC_CHANNELS * pp + _ROI_VEC_CHANNELS * pp // 32 + 1)
            + 24 * int(pooled_size) * int(sampling_ratio))
    vector = (features.dtype == torch.bfloat16 and sc == 1 and C % 8 == 0
              and features.data_ptr() % 16 == 0
              and sb % 8 == 0 and sh % 8 == 0 and sw % 8 == 0
              and (H - 1) * sh + (W - 1) * sw + C <= 2 ** 31 - 1
              and smem <= _SMEM_BYTES)
    return "vector" if vector else "strided"


def _kernel_roi_align(features: torch.Tensor, rois: torch.Tensor,
                      pooled: int, sampling: int,
                      spatial_scale: float) -> torch.Tensor:
    """Launch csrc/roi_align.cu on CUDA tensors; raise on what it does not
    take.  The features go in through their strides (an NHWC map permuted
    to [B, C, H, W] is read in place), by the route `roi_align_route`
    picks."""
    global LAUNCHES_ROI_ALIGN, LAST_ROI_ROUTE
    from cloudtik_tpu_torch.ops import _kernels

    if features.dtype not in _ROI_DTYPE_CODES:
        raise ValueError(f"roi_align kernel takes f32 or bf16 features, got "
                         f"{features.dtype}")
    if rois.device != features.device:
        raise ValueError("features and rois must be on the same CUDA device")
    if pooled < 1 or sampling < 1:
        raise ValueError(f"pooled_size {pooled} and sampling_ratio "
                         f"{sampling} must be positive")
    B, C, H, W = features.shape
    R = rois.shape[1]
    rois = rois.float().contiguous()
    out = torch.empty((B, R, C, pooled, pooled), dtype=torch.float32,
                      device=features.device)
    if out.numel() == 0:
        return out
    route = roi_align_route(features, pooled, sampling)
    strides = (ctypes.c_longlong * 4)(*features.stride())
    lib = _kernels.library("roi_align")
    err = lib.tik_roi_align(
        _ROI_DTYPE_CODES[features.dtype], _ROI_ROUTE_CODES[route],
        features.data_ptr(),
        rois.data_ptr(), out.data_ptr(), B, C, H, W, strides, R, pooled,
        sampling, float(spatial_scale),
        torch.cuda.current_stream(features.device).cuda_stream)
    _kernels.check(lib, err, f"roi_align launch ({route} route)")
    LAUNCHES_ROI_ALIGN += 1
    LAST_ROI_ROUTE = route
    return out


@contextlib.contextmanager
def _no_tf32():
    """f32 products in full precision, as the reference pins
    `Precision.HIGHEST` for ROIAlign.  PyTorch's default already has TF32
    off, and then nothing is touched; where a caller turned it on, the
    flag is process-wide, so matmuls that other threads issue inside the
    block (the backward runs on autograd's device thread) lose TF32 too,
    until the block restores it."""
    if not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def _pooling_weights(rois: torch.Tensor, pooled: int, sampling: int,
                     spatial_scale: float, size: int, axis: int
                     ) -> torch.Tensor:
    """The JAX `_axis_weights` for rois [..., 4] along one axis (0: y
    over `size` rows, 1: x over `size` columns): [..., pooled, size], row
    p the mean of its samples' hat weights max(0, 1 - |coord - q|) at the
    clipped coordinates."""
    lead = rois.shape[:-1]
    coords = _sample_coords(rois.reshape(-1, 4).float(), pooled, sampling,
                            spatial_scale)[axis].clamp(0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=rois.device)
    hat = (1.0 - (coords[..., None] - grid).abs()).clamp(min=0.0)
    return hat.reshape(*lead, pooled, sampling, size).mean(dim=-2)


def roi_align_grad(grad: torch.Tensor, rois: torch.Tensor, size,
                   pooled_size: int, sampling_ratio: int,
                   spatial_scale: float) -> torch.Tensor:
    """The gradient of ROIAlign with respect to features of `size`
    (B, C, H, W), given the output's gradient `grad` [B, R, C, P, P] and
    rois [B, R, 4]: per ROI dF[c, h, w] += sum_{p,q} wy[p, h] g[c, p, q]
    wx[q, w], the adjoint of the reference's Wy @ F @ Wx^T with the same
    weights.  Two batched contractions, ROIs a chunk at a time; f32, as a
    [B, C, H, W] view of a [B, H, W, C] tensor (the detectors' NHWC
    maps)."""
    B, C, H, W = size
    R = rois.shape[1]
    wy = _pooling_weights(rois, pooled_size, sampling_ratio, spatial_scale,
                          H, 0)                              # [B, R, P, H]
    wx = _pooling_weights(rois, pooled_size, sampling_ratio, spatial_scale,
                          W, 1)                              # [B, R, P, W]
    out = torch.zeros((B, H, W, C), dtype=torch.float32, device=grad.device)
    with _no_tf32():
        for i in range(0, R, _ROI_CHUNK):
            chunk = slice(i, i + _ROI_CHUNK)
            t = torch.einsum("brcpq,brqw->brcpw", grad[:, chunk].float(),
                             wx[:, chunk])
            out += torch.einsum("brph,brcpw->bhwc", wy[:, chunk], t)
    return out.permute(0, 3, 1, 2)


class _RoIAlignFn(torch.autograd.Function):
    """ROIAlign with a gradient for the features: the forward is the CUDA
    kernel on the card and the plain gather form on the CPU, the backward
    `roi_align_grad` on both, cast to the features' dtype."""

    @staticmethod
    def forward(ctx, features, rois, pooled, sampling, spatial_scale):
        ctx.save_for_backward(rois)
        ctx.meta = (tuple(features.shape), features.dtype, pooled, sampling,
                    spatial_scale)
        if features.is_cuda:
            return _kernel_roi_align(features, rois, pooled, sampling,
                                     spatial_scale)
        return roi_align_reference_batched(
            features, rois, pooled_size=pooled, sampling_ratio=sampling,
            spatial_scale=spatial_scale)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        size, dtype, pooled, sampling, spatial_scale = ctx.meta
        dfeatures = roi_align_grad(grad, rois, size, pooled, sampling,
                                   spatial_scale).to(dtype)
        return dfeatures, None, None, None, None


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor, *,
                      pooled_size: int = 7, sampling_ratio: int = 2,
                      spatial_scale: float = 1.0) -> torch.Tensor:
    """ROIAlign per image: features [B, C, H, W] (any strides), rois
    [B, R, 4] (x1, y1, x2, y2 in input coordinates) -> [B, R, C, P, P] f32.
    The CUDA kernel for CUDA tensors (one launch for the batch), the plain
    version for CPU tensors; any other device raises.  Differentiable with
    respect to `features`; `rois` that require grad raise."""
    _check_roi(features, rois)
    if not (features.is_cuda or features.device.type == "cpu"):
        raise ValueError(f"no roi_align for device {features.device}")
    if rois.requires_grad:
        raise ValueError("roi_align has no gradient for the rois: detach "
                         "them (the reference's loss pools detached "
                         "proposals)")
    return _RoIAlignFn.apply(features, rois, int(pooled_size),
                             int(sampling_ratio), float(spatial_scale))


def roi_align(features: torch.Tensor, rois: torch.Tensor, *,
              pooled_size: int = 7, sampling_ratio: int = 2,
              spatial_scale: float = 1.0) -> torch.Tensor:
    """ROIAlign.  features [C, H, W], rois [R, 4] (x1, y1, x2, y2 in input
    coordinates) -> [R, C, pooled, pooled] f32."""
    return roi_align_batched(features[None], rois[None],
                             pooled_size=pooled_size,
                             sampling_ratio=sampling_ratio,
                             spatial_scale=spatial_scale)[0]


# --------------------------------------------------------------------------
# Sigmoid focal loss
# --------------------------------------------------------------------------

def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                       alpha: float = 0.25, gamma: float = 2.0,
                       reduction: str = "sum") -> torch.Tensor:
    """Focal loss for dense detection: logits [*, K], targets [*, K] in
    {0, 1}; `alpha` < 0 leaves out the class weighting; reduction "sum",
    "mean" or anything else for none."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


def optax_sigmoid_ce(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable sigmoid cross entropy."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
