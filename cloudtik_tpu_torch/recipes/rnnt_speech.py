"""RNN-T speech-recognition training recipe (LibriSpeech-style shapes).

    python -m cloudtik_tpu_torch.recipes.rnnt_speech

(on the CPU add `--model tiny --max-frames 16 --max-labels 4 --device
cpu`).

Counterpart of `examples/recipes/rnnt_speech.py`: `rnnt_spec` on
`synthetic_speech_batches` through the Trainer, one frame a "token".  The
JAX recipe's launch line, `--batch 64 --data 8`, is 8 utterances a card;
the mesh flags run it as one rank of a mesh (recipes/common.py).
"""

from __future__ import annotations

from cloudtik_tpu_torch.models import rnnt as N
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_speech_batches
from cloudtik_tpu_torch.train.trainer import rnnt_spec


def parser():
    p = recipe_argparser("rnnt")
    p.add_argument("--model", default="rnnt")
    p.add_argument("--max-frames", type=int, default=256)
    p.add_argument("--max-labels", type=int, default=64)
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg) for parsed `args`; `optimizer` is an
    `OptimizerConfig`, the default unless given."""
    cfg = N.config(args.model)
    trainer = build_recipe_trainer(rnnt_spec(cfg), args,
                                   seq_len=args.max_frames,
                                   optimizer=optimizer)
    data = synthetic_speech_batches(args.batch, args.max_frames,
                                    cfg.feature_dim, cfg.vocab_size,
                                    args.max_labels)
    return trainer, data, cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, _ = build(args)
    return run_and_report(trainer, data, args.steps,
                          args.batch * args.max_frames, "frame")


if __name__ == "__main__":
    main()
