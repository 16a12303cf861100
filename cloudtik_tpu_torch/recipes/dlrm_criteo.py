"""DLRM Criteo recipe (BASELINE config #4, examples/sec).

    python -m cloudtik_tpu_torch.recipes.dlrm_criteo

(on the CPU add `--model tiny --device cpu`).

Counterpart of `examples/recipes/dlrm_criteo.py`: `dlrm_spec` on
`synthetic_dlrm_batches` through the Trainer, one example a "token".  The
JAX recipe shards the stacked tables' rows over the mesh; on one card the
whole `criteo_terabyte` table stack (333M f32 parameters) lives on the
card, and with the mesh flags each rank holds its shard of it and gathers
the stack whole for the lookup (models/dlrm.py).  The JAX recipe gives no
launch line; the default batch is 8.
"""

from __future__ import annotations

from cloudtik_tpu_torch.models import dlrm as D
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_dlrm_batches
from cloudtik_tpu_torch.train.trainer import dlrm_spec


def parser():
    p = recipe_argparser("dlrm")
    p.add_argument("--model", default="criteo_terabyte")
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given."""
    cfg = D.config(args.model)
    trainer = build_recipe_trainer(dlrm_spec(cfg), args, optimizer=optimizer)
    data = synthetic_dlrm_batches(args.batch, cfg.num_dense, cfg.num_tables,
                                  cfg.rows_per_table)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps, args.batch, "examples")


if __name__ == "__main__":
    main()
