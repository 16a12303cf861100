"""ResNet-50 ImageNet training recipe (BASELINE config #1, img/sec).

    python -m cloudtik_tpu_torch.recipes.resnet50_imagenet

(on the CPU add `--model tiny --image-size 32 --device cpu`).

Counterpart of `examples/recipes/resnet50_imagenet.py`: `resnet_spec` on
`synthetic_image_batches` through the Trainer, one image a "token", which
reports MFU on a card it knows.  The JAX recipe's launch line, `--batch
1024 --data 8`, is 128 images a card.
"""

from __future__ import annotations

from cloudtik_tpu_torch.models import resnet as R
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_image_batches
from cloudtik_tpu_torch.train.trainer import resnet_spec


def parser():
    p = recipe_argparser("resnet50")
    p.add_argument("--model", default="resnet50")
    p.add_argument("--image-size", type=int, default=224)
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given."""
    cfg = R.config(args.model, image_size=args.image_size)
    trainer = build_recipe_trainer(resnet_spec(cfg), args,
                                   optimizer=optimizer)
    data = synthetic_image_batches(args.batch, cfg.image_size,
                                   cfg.num_classes)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps, args.batch, "img")


if __name__ == "__main__":
    main()
