"""Mask R-CNN COCO instance-segmentation training recipe.

    python -m cloudtik_tpu_torch.recipes.maskrcnn_coco

(on the CPU add `--model tiny --image-size 64 --device cpu`).

Counterpart of `examples/recipes/maskrcnn_coco.py`: `maskrcnn_spec` on
`synthetic_detection_batches` with instance masks at twice the mask head's
pooled size, through the Trainer.  Each step pools its proposals twice
through the ROIAlign kernel on the card, and both poolings carry a
gradient to the backbone.  The JAX recipe's launch line, `--batch 32
--data 8`, is 4 images a card.
"""

from __future__ import annotations

from cloudtik_tpu_torch.models import maskrcnn as M
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_detection_batches
from cloudtik_tpu_torch.train.trainer import maskrcnn_spec


def parser():
    p = recipe_argparser("maskrcnn")
    p.add_argument("--model", default="maskrcnn_resnet50")
    p.add_argument("--image-size", type=int, default=512)
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given."""
    cfg = M.config(args.model, image_size=args.image_size)
    trainer = build_recipe_trainer(maskrcnn_spec(cfg), args,
                                   optimizer=optimizer)
    data = synthetic_detection_batches(
        args.batch, cfg.image_size, cfg.num_classes, cfg.max_boxes,
        mask_size=2 * cfg.mask_pool)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps, args.batch, "img")


if __name__ == "__main__":
    main()
