"""Mask R-CNN-style two-stage detector in PyTorch: inference.

Counterpart of `cloudtik_tpu/models/maskrcnn.py`: the same configs,
anchors, parameter tree and static-shape stages (C4 backbone feature, RPN,
top-K proposals, ROI box and mask heads).  `roi_heads` pools every
proposal of every image twice with ROIAlign (the roi and mask sizes), one
launch of the Hopper ROIAlign kernel each; the kernel reads the bf16 NHWC
feature map through its strides and widens it in registers, which gives
the numbers of the JAX `f.astype(f32)` with no f32 copy.  `detect` ends in
one launch of the Hopper NMS kernel for the batch (see `models/ssd.py`
`select` for why the port's NMS stands in for the JAX `nms_reference`).

The RPN flattens its NHWC outputs in (h, w, anchor) order, the order of
`anchors`; `fc1` reads each pooled ROI flattened as (C, P, P) and the mask
head the [B*K, P, P, C] transpose, as in JAX.  `_rpn_targets`,
`_roi_targets`, `_crop_gt_masks` and `loss_fn` come with the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.models import resnet as R
from cloudtik_tpu_torch.models import ssd as S
from cloudtik_tpu_torch.ops.conv import conv_kernel_init, conv_nhwc
from cloudtik_tpu_torch.ops.detection import roi_align_batched

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    num_classes: int = 81            # incl. background 0
    image_size: int = 512
    backbone: str = "resnet50"
    feature_stage: int = 2           # C4: stride 16
    anchor_scales: Tuple[float, ...] = (0.1, 0.2, 0.4)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_channels: int = 256
    num_proposals: int = 128         # static proposal count after top-K
    roi_pool: int = 7
    mask_pool: int = 14
    head_dim: int = 1024
    max_boxes: int = 32              # padded gt per image
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    roi_pos_iou: float = 0.5
    variances: Tuple[float, float] = (0.1, 0.2)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def anchors_per_cell(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)

    def backbone_config(self) -> R.ResNetConfig:
        return R.config(self.backbone, image_size=self.image_size,
                        dtype=self.dtype, param_dtype=self.param_dtype)

    def feature_size(self) -> int:
        s = -(-self.image_size // 2)
        s = -(-s // 2)
        for stage in range(self.feature_stage + 1):
            if stage > 0:
                s = max(1, (s + 1) // 2)
        return s

    def feature_width(self) -> int:
        return self.backbone_config().stage_widths[self.feature_stage]


PRESETS: Dict[str, MaskRCNNConfig] = {
    "maskrcnn_resnet50": MaskRCNNConfig(),
    "tiny": MaskRCNNConfig(num_classes=5, image_size=64, backbone="tiny",
                           feature_stage=1, rpn_channels=32,
                           num_proposals=16, head_dim=64, max_boxes=8,
                           mask_pool=7),
}


def config(name: str, **overrides) -> MaskRCNNConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


def anchors(cfg: MaskRCNNConfig) -> np.ndarray:
    """[N, 4] normalized cxcywh f32 over the single feature map."""
    fs = cfg.feature_size()
    cy, cx = np.meshgrid((np.arange(fs) + 0.5) / fs,
                         (np.arange(fs) + 0.5) / fs, indexing="ij")
    cells = []
    for s in cfg.anchor_scales:
        for r in cfg.anchor_ratios:
            w, h = s * np.sqrt(r), s / np.sqrt(r)
            cells.append(np.stack(
                [cx, cy, np.full_like(cx, w), np.full_like(cy, h)],
                axis=-1).reshape(-1, 4))
    return np.stack(cells, axis=1).reshape(-1, 4).astype(np.float32)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: MaskRCNNConfig,
                device: DeviceLike = None) -> Params:
    """Same tree, shapes and dtypes as the JAX `init_params`; draws come
    from `generator` (on `device`)."""
    dev = resolve_device(device)
    pdt = cfg.param_dtype
    params: Params = {
        "backbone": R.init_params(generator, cfg.backbone_config(), dev)}
    params["backbone"].pop("fc")
    w = cfg.feature_width()
    a = cfg.anchors_per_cell

    def conv(kh, kw, ci, co):
        return conv_kernel_init(generator, kh, kw, ci, co, pdt, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=pdt, device=dev)

    def dense(i, o):
        t = torch.empty((i, o), dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (t * (2.0 / i) ** 0.5).to(pdt)

    params["rpn"] = {
        "conv": conv(3, 3, w, cfg.rpn_channels),
        "conv_bias": zeros(cfg.rpn_channels),
        "obj": conv(1, 1, cfg.rpn_channels, a), "obj_bias": zeros(a),
        "box": conv(1, 1, cfg.rpn_channels, a * 4), "box_bias": zeros(a * 4),
    }
    in_dim = w * cfg.roi_pool ** 2
    params["head"] = {
        "fc1": dense(in_dim, cfg.head_dim), "fc1_bias": zeros(cfg.head_dim),
        "fc2": dense(cfg.head_dim, cfg.head_dim),
        "fc2_bias": zeros(cfg.head_dim),
        "cls": dense(cfg.head_dim, cfg.num_classes),
        "cls_bias": zeros(cfg.num_classes),
        "box": dense(cfg.head_dim, cfg.num_classes * 4),
        "box_bias": zeros(cfg.num_classes * 4),
    }
    mc = max(cfg.rpn_channels, 64)
    params["mask"] = {
        "conv1": conv(3, 3, w, mc), "conv1_bias": zeros(mc),
        "conv2": conv(3, 3, mc, mc), "conv2_bias": zeros(mc),
        "out": conv(1, 1, mc, cfg.num_classes),
        "out_bias": zeros(cfg.num_classes),
    }
    return params


# --------------------------------------------------------------------------
# Forward pieces
# --------------------------------------------------------------------------

def backbone_feature(params: Params, images: torch.Tensor,
                     cfg: MaskRCNNConfig) -> torch.Tensor:
    """images [B, H, W, 3] -> the C4 feature [B, fs, fs, C] (model dtype);
    the backbone stops at that stage."""
    return R.forward_features(params["backbone"], images,
                              cfg.backbone_config(),
                              last_stage=cfg.feature_stage)[-1]


def rpn_forward(params: Params, feat: torch.Tensor,
                cfg: MaskRCNNConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat [B, H, W, C] -> (objectness [B, N], deltas [B, N, 4])."""
    p = params["rpn"]
    B = feat.shape[0]
    h = torch.relu(conv_nhwc(feat, p["conv"], dtype=cfg.dtype)
                   + p["conv_bias"].to(cfg.dtype))
    obj = conv_nhwc(h, p["obj"], dtype=cfg.dtype).float() \
        + p["obj_bias"].float()
    box = conv_nhwc(h, p["box"], dtype=cfg.dtype).float() \
        + p["box_bias"].float()
    return obj.reshape(B, -1), box.reshape(B, -1, 4)


def propose(obj: torch.Tensor, deltas: torch.Tensor,
            anchor_boxes: torch.Tensor,
            cfg: MaskRCNNConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K proposals per image -> (boxes_xyxy [B, K, 4] clipped to
    [0, 1], scores [B, K])."""
    boxes = S.decode_boxes(deltas, anchor_boxes, cfg).clamp(0.0, 1.0)
    scores, idx = torch.topk(obj, cfg.num_proposals, dim=-1)
    picked = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    return picked, torch.sigmoid(scores)


def roi_heads(params: Params, feat: torch.Tensor, proposals: torch.Tensor,
              cfg: MaskRCNNConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (cls_logits [B, K, num_classes], deltas [B, K, num_classes, 4],
    mask_logits [B, K, mask_pool, mask_pool, num_classes])."""
    p = params["head"]
    fs = feat.shape[1]
    # [B, C, H, W] view of the NHWC map (no copy) + pixel-coordinate rois
    fm = feat.permute(0, 3, 1, 2)
    rois = proposals * fs
    pooled = roi_align_batched(fm, rois, pooled_size=cfg.roi_pool,
                               sampling_ratio=1, spatial_scale=1.0)
    mask_pooled = roi_align_batched(fm, rois, pooled_size=cfg.mask_pool,
                                    sampling_ratio=1, spatial_scale=1.0)
    B, K = pooled.shape[:2]
    dt = cfg.dtype
    x = pooled.reshape(B, K, -1).to(dt)
    x = torch.relu(x @ p["fc1"].to(dt) + p["fc1_bias"].to(dt))
    x = torch.relu(x @ p["fc2"].to(dt) + p["fc2_bias"].to(dt))
    cls = (x @ p["cls"].to(dt)).float() + p["cls_bias"].float()
    box = (x @ p["box"].to(dt)).float() + p["box_bias"].float()
    box = box.reshape(B, K, cfg.num_classes, 4)

    m = params["mask"]
    # the mask head reads the [B*K, mp, mp, C] pooled maps (NHWC)
    mh = mask_pooled.movedim(2, -1).reshape(
        B * K, cfg.mask_pool, cfg.mask_pool, -1)
    mh = torch.relu(conv_nhwc(mh, m["conv1"], dtype=dt)
                    + m["conv1_bias"].to(dt))
    mh = torch.relu(conv_nhwc(mh, m["conv2"], dtype=dt)
                    + m["conv2_bias"].to(dt))
    logits = conv_nhwc(mh, m["out"], dtype=dt).float() \
        + m["out_bias"].float()
    return cls, box, logits.reshape(B, K, cfg.mask_pool, cfg.mask_pool,
                                    cfg.num_classes)


# --------------------------------------------------------------------------
# Inference
# --------------------------------------------------------------------------

def detect(params: Params, images, cfg: MaskRCNNConfig, *,
           score_threshold: float = 0.05, iou_threshold: float = 0.5,
           max_detections: int = 50,
           device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """images [B, H, W, 3] (moved to `device`; params must be there
    already) -> boxes [B, K, 4], scores [B, K], labels [B, K] int32 and
    mask_logits [B, P, mp, mp, num_classes] as the JAX `detect` returns
    them, plus `keep` (proposal indices, -1 where empty), the NMS inputs
    `nms_boxes` / `nms_scores`, and the `feature` map and `proposals` the
    ROI heads pooled from."""
    dev = resolve_device(device)
    images = torch.as_tensor(images, device=dev)
    # copied before any work is queued (see `ssd.detect`)
    anchor_boxes = torch.as_tensor(anchors(cfg), device=dev)
    with torch.no_grad():
        feat = backbone_feature(params, images, cfg)
        obj, deltas = rpn_forward(params, feat, cfg)
        proposals, _ = propose(obj, deltas, anchor_boxes, cfg)
        cls_logits, box_deltas, mask_logits = roi_heads(
            params, feat, proposals, cfg)
        probs = torch.softmax(cls_logits, dim=-1)
        scores, labels = probs[..., 1:].max(dim=-1)
        labels = labels + 1
        picked = box_deltas.gather(
            2, labels[..., None, None].expand(-1, -1, 1, 4))[:, :, 0, :]
        boxes = S.decode_boxes(picked, S.xyxy_to_cxcywh(proposals), cfg)
        boxes = boxes.clamp(0.0, 1.0)
        out = S.select(boxes, scores, labels.int(),
                       score_threshold=score_threshold,
                       iou_threshold=iou_threshold,
                       max_detections=max_detections)
        out.update(mask_logits=mask_logits, feature=feat,
                   proposals=proposals)
        return out
