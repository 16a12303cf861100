"""Diffusion UNet training recipe (BASELINE config #5, img/sec + MFU).

    python -m cloudtik_tpu_torch.recipes.sdxl_fsdp

(on the CPU add `--model tiny --device cpu`).

Counterpart of `examples/recipes/sdxl_fsdp.py`: `diffusion_spec` on
`synthetic_diffusion_batches` through the Trainer, one image a "token",
which reports MFU on a card it knows.  The JAX recipe shards every weight
over `--fsdp N`, and so does this one on a mesh of N ranks (each weight
gathered where the step reads it).  The JAX recipe's docstring has attention
"at low resolutions" run through the flash kernel, but `sdxl_mini`'s head
dims are 80 and 160, which neither the Pallas kernel (multiples of 128)
nor the Hopper one (64 and 128) takes: every attention block here, as on
the reference, runs the plain path, and no flash kernel launches.  The
JAX recipe gives no launch line; the default batch is 8.
"""

from __future__ import annotations

from cloudtik_tpu_torch.models import diffusion as U
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_diffusion_batches
from cloudtik_tpu_torch.train.trainer import diffusion_spec


def parser():
    p = recipe_argparser("sdxl")
    p.add_argument("--model", default="sdxl_mini")
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given."""
    cfg = U.config(args.model)
    trainer = build_recipe_trainer(diffusion_spec(cfg), args,
                                   optimizer=optimizer)
    data = synthetic_diffusion_batches(args.batch, cfg.image_size,
                                       cfg.in_channels)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps, args.batch, "img")


if __name__ == "__main__":
    main()
