"""SSD-ResNet34 COCO detection training recipe.

    python -m cloudtik_tpu_torch.recipes.ssd_coco

(on the CPU add `--model tiny --image-size 64 --device cpu`).

Counterpart of `examples/recipes/ssd_coco.py`: `ssd_spec` on
`synthetic_detection_batches` (`max_boxes` padded ground truth) through the
Trainer.  The JAX recipe's launch line, `--batch 256 --data 8`, is 32
images a card.
"""

from __future__ import annotations

from cloudtik_tpu_torch.models import ssd as S
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_detection_batches
from cloudtik_tpu_torch.train.trainer import ssd_spec


def parser():
    p = recipe_argparser("ssd_resnet34")
    p.add_argument("--model", default="ssd_resnet34")
    p.add_argument("--image-size", type=int, default=300)
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given."""
    cfg = S.config(args.model, image_size=args.image_size)
    trainer = build_recipe_trainer(ssd_spec(cfg), args, optimizer=optimizer)
    data = synthetic_detection_batches(args.batch, cfg.image_size,
                                       cfg.num_classes, cfg.max_boxes)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps, args.batch, "img")


if __name__ == "__main__":
    main()
