"""GraphSAGE node-classification training recipe.

    python -m cloudtik_tpu_torch.recipes.graphsage_nodes

(on the CPU add `--model tiny --nodes 64 --device cpu`).

Counterpart of `examples/recipes/graphsage_nodes.py`: `graphsage_spec` on
`synthetic_graph_batches` through the Trainer, one node a "token", on
fixed-fanout padded blocks of `--nodes` nodes (`--batch` is set to it).
With `--objective link_pred` each block carries `src`, `dst` and
`neg_dst` edges (half as many as nodes) drawn from a seed-0 numpy
generator, as the JAX recipe's.  With the mesh flags each rank holds its
rows of the block and reads its neighbours' rows from every rank
(models/graphsage.py).
"""

from __future__ import annotations

import numpy as np

from cloudtik_tpu_torch.models import graphsage as G
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_graph_batches
from cloudtik_tpu_torch.train.trainer import graphsage_spec


def parser():
    p = recipe_argparser("graphsage")
    p.add_argument("--model", default="graphsage")
    p.add_argument("--nodes", type=int, default=4096,
                   help="nodes per sampled block")
    p.add_argument("--objective", default="supervised",
                   choices=["supervised", "link_pred"])
    return p


def with_edges(blocks, nodes: int):
    """Each block with `src`, `dst` and `neg_dst` int32 edges (nodes // 2
    of each) from one seed-0 generator, as the JAX recipe draws them."""
    rng = np.random.default_rng(0)
    for batch in blocks:
        e = nodes // 2
        for k in ("src", "dst", "neg_dst"):
            batch[k] = rng.integers(0, nodes, (e,), dtype=np.int32)
        yield batch


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given.  Sets `args.batch` to
    `args.nodes`."""
    cfg = G.config(args.model)
    args.batch = args.nodes
    trainer = build_recipe_trainer(graphsage_spec(cfg, args.objective),
                                   args, optimizer=optimizer)
    data = synthetic_graph_batches(args.nodes, cfg.in_dim, cfg.num_classes,
                                   cfg.max_degree)
    if args.objective == "link_pred":
        data = with_edges(data, args.nodes)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps, args.nodes, "node")


if __name__ == "__main__":
    main()
