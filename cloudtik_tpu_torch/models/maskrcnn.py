"""Mask R-CNN-style two-stage detector in PyTorch.

Counterpart of `cloudtik_tpu/models/maskrcnn.py`: the same configs,
anchors, parameter tree and static-shape stages (C4 backbone feature, RPN,
top-K proposals, ROI box and mask heads), `detect` and the training loss.
`roi_heads` pools every proposal of every image twice with ROIAlign (the
roi and mask sizes), one launch of the Hopper ROIAlign kernel each; the
kernel reads the bf16 NHWC feature map through its strides and widens it in
registers, which gives the numbers of the JAX `f.astype(f32)` with no f32
copy.  `detect` ends in one launch of the Hopper NMS kernel for the batch
(see `models/ssd.py` `select` for why the port's NMS stands in for the JAX
`nms_reference`).

The RPN flattens its NHWC outputs in (h, w, anchor) order, the order of
`anchors`; `fc1` reads each pooled ROI flattened as (C, P, P) and the mask
head the [B*K, P, P, C] transpose, as in JAX.

`loss_fn` is the reference's: RPN targets by dense IoU with every valid gt
force-claiming its best anchor, proposals from the detached objectness and
deltas, ROI targets by IoU against the proposals, and the mask loss (when
the batch has `gt_masks`) against each matched gt mask resampled into its
proposal (`_crop_gt_masks`).  The targets are computed for the whole batch
at once, the written-out `vmap` of the JAX per-image functions.  Both
ROIAlign launches of `roi_heads` carry a gradient to the backbone
(`ops/detection.py` `_RoIAlignFn`).

On a mesh (`param_logical_axes`, the reference's tree) a rank holds its
rows of the batch and pools its own proposals (both launches run on every
rank): the backbone's BN takes global statistics (ResNet's), and each of
the reference's per-image ratios is averaged over the global batch
(`collectives.batch_mean`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.models import resnet as R
from cloudtik_tpu_torch.models import ssd as S
from cloudtik_tpu_torch.ops.conv import (conv_kernel_axes,
                                         conv_kernel_init, conv_nhwc)
from cloudtik_tpu_torch.ops.detection import (box_iou, optax_sigmoid_ce,
                                              roi_align_batched)
from cloudtik_tpu_torch.parallel.collectives import batch_mean

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

    def flops_per_image(self) -> float:
        bcfg = self.backbone_config()
        f = R._forward_flops(bcfg)
        fs = self.feature_size()
        w = self.feature_width()
        a = self.anchors_per_cell
        f += 2 * (9 * w * self.rpn_channels) * fs ** 2
        f += 2 * (self.rpn_channels * a * 5) * fs ** 2
        roi = 2 * (w * self.roi_pool ** 2) * self.head_dim \
            + 2 * self.head_dim * self.head_dim \
            + 2 * self.head_dim * (self.num_classes * 5)
        f += roi * self.num_proposals
        return 3.0 * f


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


# anchors_on(cfg, device): `anchors(cfg)` on `device`, made once per config
# and device through SSD's cache
anchors_on = functools.partial(S.anchors_on, anchors_fn=anchors)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def param_logical_axes(cfg: MaskRCNNConfig) -> Params:
    """The reference's logical axes: the backbone's without its
    classifier, conv kernels for the RPN and the mask head, (embed, mlp)
    and (mlp, vocab) for the box head."""
    axes: Params = {"backbone": R.param_logical_axes(cfg.backbone_config())}
    axes["backbone"].pop("fc", None)
    axes["rpn"] = {"conv": conv_kernel_axes(), "conv_bias": ("norm",),
                   "obj": conv_kernel_axes(), "obj_bias": ("norm",),
                   "box": conv_kernel_axes(), "box_bias": ("norm",)}
    axes["head"] = {"fc1": ("embed", "mlp"), "fc1_bias": ("mlp",),
                    "fc2": ("mlp", "mlp"), "fc2_bias": ("mlp",),
                    "cls": ("mlp", "vocab"), "cls_bias": ("vocab",),
                    "box": ("mlp", "vocab"), "box_bias": ("vocab",)}
    axes["mask"] = {"conv1": conv_kernel_axes(), "conv1_bias": ("norm",),
                    "conv2": conv_kernel_axes(), "conv2_bias": ("norm",),
                    "out": conv_kernel_axes(), "out_bias": ("norm",)}
    return axes


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
# Training
# --------------------------------------------------------------------------

def _rpn_targets(gt_boxes, gt_labels, anchor_boxes, cfg):
    """gt_boxes [B, M, 4], gt_labels [B, M] -> labels [B, N] (1 pos / 0 neg
    / -1 ignore) and targets [B, N, 4] as deltas."""
    B = gt_labels.shape[0]
    n = anchor_boxes.shape[0]
    valid = gt_labels > 0
    iou = box_iou(gt_boxes, S.cxcywh_to_xyxy(anchor_boxes))   # [B, M, N]
    iou = torch.where(valid[..., None], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=1)
    best_gt = iou.argmax(dim=1)
    # padding rows claim slot n, which is sliced off
    claim = torch.where(valid, iou.argmax(dim=2), n)
    claimed = torch.zeros((B, n + 1), dtype=torch.bool,
                          device=iou.device).scatter_(1, claim, True)[:, :n]
    pos = claimed | (best_iou >= cfg.rpn_pos_iou)
    neg = ~pos & (best_iou < cfg.rpn_neg_iou)
    labels = torch.where(pos, 1, torch.where(neg, 0, -1))
    matched = gt_boxes.gather(1, best_gt[..., None].expand(-1, -1, 4))
    targets = S.encode_boxes(S.xyxy_to_cxcywh(matched), anchor_boxes, cfg)
    return labels, targets


def _roi_targets(proposals, gt_boxes, gt_labels, cfg):
    """Per-proposal class + box-delta targets, the matched gt index and
    the positive mask, each [B, K]."""
    valid = gt_labels > 0
    iou = box_iou(gt_boxes, proposals)                       # [B, M, K]
    iou = torch.where(valid[..., None], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=1)
    best_gt = iou.argmax(dim=1)
    pos = best_iou >= cfg.roi_pos_iou
    labels = torch.where(pos, gt_labels.long().gather(1, best_gt), 0)
    matched = gt_boxes.gather(1, best_gt[..., None].expand(-1, -1, 4))
    targets = S.encode_boxes(S.xyxy_to_cxcywh(matched),
                             S.xyxy_to_cxcywh(proposals), cfg)
    return labels, targets, best_gt, pos


def _crop_gt_masks(gt_masks, best_gt, proposals, pos, cfg):
    """Resample each matched gt mask into its proposal window at mask_pool
    resolution (bilinear hat weights, Wy @ mask @ Wx^T).  gt_masks
    [B, M, mh, mw] in image-normalized coords -> [B, K, mp, mp], zero where
    the proposal is not positive."""
    mh, mw = gt_masks.shape[-2:]
    mp = cfg.mask_pool
    mask = gt_masks.float().gather(
        1, best_gt[..., None, None].expand(-1, -1, mh, mw))   # [B, K, mh, mw]
    x1, y1, x2, y2 = proposals.unbind(-1)
    p = torch.arange(mp, dtype=torch.float32, device=proposals.device)

    def axis_w(start, extent, size):                         # [B, K, mp, size]
        coords = start[..., None] + (p + 0.5) * extent[..., None] - 0.5
        coords = coords.clamp(0.0, size - 1.0)
        grid = torch.arange(size, dtype=torch.float32,
                            device=proposals.device)
        return (1.0 - (coords[..., None] - grid).abs()).clamp(min=0.0)

    wy = axis_w(y1 * mh, (y2 - y1) * mh / mp, mh)
    wx = axis_w(x1 * mw, (x2 - x1) * mw / mp, mw)
    crops = wy @ mask @ wx.transpose(-1, -2)
    return torch.where(pos[..., None, None], crops, torch.zeros_like(crops))


def rpn_losses(obj: torch.Tensor, deltas: torch.Tensor,
               gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
               anchor_boxes: torch.Tensor, cfg: MaskRCNNConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN's two losses, objectness CE over the positive and negative
    anchors and smooth-L1 over the positives: (rpn_cls_loss,
    rpn_box_loss)."""
    rpn_labels, rpn_tgts = _rpn_targets(gt_boxes, gt_labels, anchor_boxes,
                                        cfg)
    pos = rpn_labels == 1
    neg = rpn_labels == 0
    n_pos = pos.sum(dim=1).clamp(min=1)
    obj_ce = optax_sigmoid_ce(obj, pos)
    zero = torch.zeros_like(obj)
    rpn_cls_loss = batch_mean(torch.where(pos | neg, obj_ce, zero).sum(dim=1)
                              / (pos | neg).sum(dim=1).clamp(min=1))
    rpn_box = S._smooth_l1(deltas - rpn_tgts).sum(-1)
    rpn_box_loss = batch_mean(torch.where(pos, rpn_box, zero).sum(dim=1)
                              / n_pos)
    return rpn_cls_loss, rpn_box_loss


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: MaskRCNNConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: images [B,H,W,3], gt_boxes [B,M,4] xyxy normalized,
    gt_labels [B,M] (0 = pad), gt_masks [B,M,mh,mw] float in {0,1}
    (optional: the mask loss is left out without it); the metrics
    detached."""
    feat = backbone_feature(params, batch["images"], cfg)
    obj, deltas = rpn_forward(params, feat, cfg)
    anchor_boxes = anchors_on(cfg, obj.device)
    gt_boxes = batch["gt_boxes"].float()
    gt_labels = batch["gt_labels"].long()
    rpn_cls_loss, rpn_box_loss = rpn_losses(obj, deltas, gt_boxes,
                                            gt_labels, anchor_boxes, cfg)

    proposals, _ = propose(obj.detach(), deltas.detach(), anchor_boxes, cfg)
    cls_logits, box_deltas, mask_logits = roi_heads(
        params, feat, proposals, cfg)

    roi_labels, roi_tgts, best_gt, roi_pos = _roi_targets(
        proposals, gt_boxes, gt_labels, cfg)
    n_roi_pos = roi_pos.sum(dim=1).clamp(min=1)
    logp = torch.log_softmax(cls_logits, dim=-1)
    roi_ce = -logp.gather(-1, roi_labels[..., None])[..., 0]
    roi_cls_loss = batch_mean(roi_ce)
    cls_idx = roi_labels.clamp(min=0)
    picked = box_deltas.gather(
        2, cls_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0, :]
    roi_box = S._smooth_l1(picked - roi_tgts).sum(-1)
    roi_box_loss = batch_mean(
        torch.where(roi_pos, roi_box, torch.zeros_like(roi_box)).sum(dim=1)
        / n_roi_pos)

    loss = rpn_cls_loss + rpn_box_loss + roi_cls_loss + roi_box_loss
    metrics = {
        "rpn_cls_loss": rpn_cls_loss, "rpn_box_loss": rpn_box_loss,
        "roi_cls_loss": roi_cls_loss, "roi_box_loss": roi_box_loss,
        "num_pos": batch_mean(roi_pos.sum(dim=1).float()),
    }
    if "gt_masks" in batch:
        mp = cfg.mask_pool
        crops = _crop_gt_masks(batch["gt_masks"], best_gt, proposals,
                               roi_pos, cfg)
        picked_masks = mask_logits.gather(
            -1, cls_idx[..., None, None, None].expand(-1, -1, mp, mp, 1)
        )[..., 0]
        m_ce = optax_sigmoid_ce(picked_masks, crops)
        mask_loss = batch_mean(
            torch.where(roi_pos[..., None, None], m_ce,
                        torch.zeros_like(m_ce)).sum(dim=(1, 2, 3))
            / (n_roi_pos * mp ** 2))
        loss = loss + mask_loss
        metrics["mask_loss"] = mask_loss
    metrics["loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


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
    anchor_boxes = anchors_on(cfg, dev)
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
