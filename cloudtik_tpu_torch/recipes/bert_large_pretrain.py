"""BERT-Large MLM pretraining recipe (BASELINE north star + config #2).

    python -m cloudtik_tpu_torch.recipes.bert_large_pretrain

(on the CPU add `--model tiny --device cpu`).

Counterpart of `examples/recipes/bert_large_pretrain.py`: `bert_spec` on
`synthetic_mlm_batches` through the Trainer, which reports MFU on a card
it knows.
"""

from __future__ import annotations

from cloudtik_tpu_torch.models import bert as B
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_mlm_batches
from cloudtik_tpu_torch.train.trainer import bert_spec


def parser():
    p = recipe_argparser("bert-large")
    p.add_argument("--model", default="bert_large")
    p.add_argument("--seq-len", type=int, default=512)
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given."""
    cfg = B.config(args.model, max_seq_len=args.seq_len)
    trainer = build_recipe_trainer(bert_spec(cfg), args,
                                   seq_len=args.seq_len,
                                   optimizer=optimizer)
    data = synthetic_mlm_batches(args.batch, args.seq_len, cfg.vocab_size)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps, args.batch, "seq")


if __name__ == "__main__":
    main()
