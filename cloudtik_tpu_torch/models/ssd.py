"""SSD single-shot detector on a ResNet backbone, in PyTorch: inference.

Counterpart of `cloudtik_tpu/models/ssd.py`: the same configs, anchors
(numpy), box coding, parameter tree and `forward`; `detect` decodes the
deltas and ends in greedy NMS over every anchor of every image, one launch
of the Hopper NMS kernel (`ops/detection.py`) for the batch on the card.

The JAX `detect` calls `nms_reference`, not the Pallas `nms`; both compute
`_nms_select_rows`, so the port's `detect` calls the port's `nms_batched`,
which is the kernel on the card and the plain version on the CPU.  Scores
below `score_threshold` become exactly 0.0, not -inf: such boxes stay valid
and fill the keep list in index order among their ties, as in JAX.

The class and box heads flatten their NHWC outputs in (h, w, anchor) order,
the order of `anchors`.  `match_anchors` and `loss_fn` come with the
training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.models import resnet as R
from cloudtik_tpu_torch.ops.conv import conv_kernel_init, conv_nhwc
from cloudtik_tpu_torch.ops.detection import nms_batched

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    num_classes: int = 81            # incl. background class 0 (COCO)
    image_size: int = 300
    backbone: str = "resnet34"
    backbone_stages: Tuple[int, ...] = (2, 3)
    extra_widths: Tuple[int, ...] = (512, 256, 256, 256)
    anchor_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
    scale_range: Tuple[float, float] = (0.1, 0.9)
    max_boxes: int = 64              # padded ground-truth boxes per image
    match_iou: float = 0.5
    neg_pos_ratio: float = 3.0
    variances: Tuple[float, float] = (0.1, 0.2)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def anchors_per_cell(self) -> int:
        return len(self.anchor_ratios) + 1   # + extra sqrt-scale square

    def backbone_config(self) -> R.ResNetConfig:
        return R.config(self.backbone, image_size=self.image_size,
                        dtype=self.dtype, param_dtype=self.param_dtype)

    def feature_sizes(self) -> List[int]:
        """Spatial size of each detection feature map."""
        bcfg = self.backbone_config()
        # stem conv + maxpool are both SAME/stride-2 -> two ceil-divides
        stage_size = -(-self.image_size // 2)
        stage_size = -(-stage_size // 2)
        per_stage = []
        for stage in range(len(bcfg.stage_blocks)):
            if stage > 0:
                stage_size = max(1, (stage_size + 1) // 2)
            per_stage.append(stage_size)
        sizes = [per_stage[s] for s in self.backbone_stages]
        s = sizes[-1]
        for _ in self.extra_widths:
            s = max(1, (s + 1) // 2)
            sizes.append(s)
        return sizes

    def num_anchors(self) -> int:
        return sum(s * s * self.anchors_per_cell
                   for s in self.feature_sizes())

    def feature_widths(self) -> List[int]:
        bcfg = self.backbone_config()
        return [bcfg.stage_widths[s] for s in self.backbone_stages] \
            + list(self.extra_widths)


PRESETS: Dict[str, SSDConfig] = {
    "ssd_resnet34": SSDConfig(),
    "tiny": SSDConfig(num_classes=5, image_size=64, backbone="tiny",
                      backbone_stages=(0, 1), extra_widths=(64,),
                      max_boxes=8),
}


def config(name: str, **overrides) -> SSDConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


# --------------------------------------------------------------------------
# Anchors and box coding
# --------------------------------------------------------------------------

def anchors(cfg: SSDConfig) -> np.ndarray:
    """[N, 4] normalized (cx, cy, w, h) f32 anchor boxes across all maps,
    the anchors of one cell together (cell-major order)."""
    sizes = cfg.feature_sizes()
    smin, smax = cfg.scale_range
    k = len(sizes)
    scales = [smin + (smax - smin) * i / max(k - 1, 1) for i in range(k)]
    scales.append(min(1.0, scales[-1] + (smax - smin) / max(k - 1, 1)))
    out = []
    for i, fs in enumerate(sizes):
        s = scales[i]
        s_next = math.sqrt(s * scales[i + 1])
        cy, cx = np.meshgrid(
            (np.arange(fs) + 0.5) / fs, (np.arange(fs) + 0.5) / fs,
            indexing="ij")
        whs = [(s * math.sqrt(r), s / math.sqrt(r))
               for r in cfg.anchor_ratios] + [(s_next, s_next)]
        for w, h in whs:
            cell = np.stack([cx, cy, np.full_like(cx, w),
                             np.full_like(cy, h)], axis=-1)
            out.append(cell.reshape(-1, 4))
    per_map = []
    idx = 0
    a = cfg.anchors_per_cell
    for _ in sizes:
        maps = out[idx:idx + a]
        idx += a
        per_map.append(np.stack(maps, axis=1).reshape(-1, 4))
    return np.concatenate(per_map, axis=0).astype(np.float32)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def encode_boxes(gt_cxcywh: torch.Tensor, anchor_cxcywh: torch.Tensor,
                 cfg) -> torch.Tensor:
    """SSD delta encoding with variances."""
    vc, vs = cfg.variances
    txy = (gt_cxcywh[..., :2] - anchor_cxcywh[..., :2]) \
        / anchor_cxcywh[..., 2:].clamp(min=1e-6) / vc
    twh = torch.log(gt_cxcywh[..., 2:].clamp(min=1e-6)
                    / anchor_cxcywh[..., 2:].clamp(min=1e-6)) / vs
    return torch.cat([txy, twh], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchor_cxcywh: torch.Tensor,
                 cfg) -> torch.Tensor:
    """Inverse of encode_boxes -> xyxy."""
    vc, vs = cfg.variances
    xy = deltas[..., :2] * vc * anchor_cxcywh[..., 2:] \
        + anchor_cxcywh[..., :2]
    wh = torch.exp((deltas[..., 2:] * vs).clamp(-10.0, 10.0)) \
        * anchor_cxcywh[..., 2:]
    return cxcywh_to_xyxy(torch.cat([xy, wh], dim=-1))


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: SSDConfig,
                device: DeviceLike = None) -> Params:
    """Same tree, shapes and dtypes as the JAX `init_params`; draws come
    from `generator` (on `device`)."""
    dev = resolve_device(device)
    pdt = cfg.param_dtype
    params: Params = {
        "backbone": R.init_params(generator, cfg.backbone_config(), dev)}
    params["backbone"].pop("fc")

    def conv(kh, kw, ci, co):
        return conv_kernel_init(generator, kh, kw, ci, co, pdt, device=dev)

    extras: List[Params] = []
    widths = cfg.feature_widths()
    c_in = widths[len(cfg.backbone_stages) - 1]
    for w in cfg.extra_widths:
        extras.append({"reduce": conv(1, 1, c_in, w // 2),
                       "conv": conv(3, 3, w // 2, w)})
        c_in = w
    params["extras"] = extras
    a = cfg.anchors_per_cell
    # background-biased init: softmax(bias) puts ~99% mass on class 0
    prior = 0.99
    bg_logit = float(np.log(prior / (1.0 - prior)
                            * max(cfg.num_classes - 1, 1)))
    cls_bias = np.zeros((a, cfg.num_classes), np.float32)
    cls_bias[:, 0] = bg_logit
    heads: List[Params] = []
    for w in widths:
        heads.append({
            "cls": conv(3, 3, w, a * cfg.num_classes),
            "cls_bias": torch.as_tensor(cls_bias.reshape(-1)).to(dev, pdt),
            "box": conv(3, 3, w, a * 4),
            "box_bias": torch.zeros((a * 4,), dtype=pdt, device=dev),
        })
    params["heads"] = heads
    return params


# --------------------------------------------------------------------------
# Forward and inference
# --------------------------------------------------------------------------

def forward(params: Params, images: torch.Tensor,
            cfg: SSDConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, H, W, 3] -> (cls_logits [B, N, num_classes] f32,
    box_deltas [B, N, 4] f32) over all anchors N."""
    feats = R.forward_features(params["backbone"], images,
                               cfg.backbone_config(),
                               last_stage=max(cfg.backbone_stages))
    maps = [feats[s] for s in cfg.backbone_stages]
    x = maps[-1]
    for e in params["extras"]:
        x = torch.relu(conv_nhwc(x, e["reduce"], dtype=cfg.dtype))
        x = torch.relu(conv_nhwc(x, e["conv"], stride=2, dtype=cfg.dtype))
        maps.append(x)
    cls_out, box_out = [], []
    B = images.shape[0]
    for m, h in zip(maps, params["heads"]):
        c = conv_nhwc(m, h["cls"], dtype=cfg.dtype).float() \
            + h["cls_bias"].float()
        b = conv_nhwc(m, h["box"], dtype=cfg.dtype).float() \
            + h["box_bias"].float()
        # NHWC flattened in (h, w, anchor) order, as `anchors` is
        cls_out.append(c.reshape(B, -1, cfg.num_classes))
        box_out.append(b.reshape(B, -1, 4))
    return torch.cat(cls_out, dim=1), torch.cat(box_out, dim=1)


def select(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
           *, score_threshold: float, iou_threshold: float,
           max_detections: int) -> Dict[str, torch.Tensor]:
    """The tail both detectors share: scores below the threshold set to
    exactly 0.0, one batched NMS, the kept boxes, scores and labels
    gathered (zeros where empty).  The pre-NMS boxes and scores come back
    as `nms_boxes` / `nms_scores`, so a check can hold the NMS on them."""
    scores = torch.where(scores >= score_threshold, scores,
                         torch.zeros_like(scores))
    keep = nms_batched(boxes, scores, iou_threshold=iou_threshold,
                       max_output=max_detections)
    ok = keep >= 0
    idx = keep.clamp(min=0).long()
    picked = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    return {"boxes": torch.where(ok[..., None], picked,
                                 torch.zeros_like(picked)),
            "scores": torch.where(ok, scores.gather(1, idx),
                                  torch.zeros_like(ok, dtype=scores.dtype)),
            "labels": torch.where(ok, labels.gather(1, idx),
                                  torch.zeros_like(idx, dtype=labels.dtype)),
            "keep": keep, "nms_boxes": boxes, "nms_scores": scores}


def detect(params: Params, images, cfg: SSDConfig, *,
           score_threshold: float = 0.05, iou_threshold: float = 0.5,
           max_detections: int = 100,
           device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Decode + NMS.  images [B, H, W, 3] (moved to `device`; params must
    be there already).  Returns boxes [B, K, 4] xyxy normalized, scores
    [B, K], labels [B, K] int32 (0 where empty), K = max_detections, plus
    `keep` [B, K] (anchor indices, -1 where empty) and the NMS inputs
    `nms_boxes` [B, N, 4] / `nms_scores` [B, N]."""
    dev = resolve_device(device)
    images = torch.as_tensor(images, device=dev)
    # copied before any work is queued: a copy from pageable host memory
    # waits for the stream, which would idle the card behind the host
    anchor_boxes = torch.as_tensor(anchors(cfg), device=dev)
    with torch.no_grad():
        cls_logits, box_deltas = forward(params, images, cfg)
        probs = torch.softmax(cls_logits, dim=-1)
        scores, labels = probs[..., 1:].max(dim=-1)
        labels = labels.int() + 1
        boxes = decode_boxes(box_deltas, anchor_boxes, cfg)
        return select(boxes, scores, labels,
                      score_threshold=score_threshold,
                      iou_threshold=iou_threshold,
                      max_detections=max_detections)
