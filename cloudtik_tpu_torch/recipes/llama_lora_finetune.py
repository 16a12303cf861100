"""Llama LoRA fine-tune recipe (BASELINE config #3, seq/sec).

    python -m cloudtik_tpu_torch.recipes.llama_lora_finetune

(on the CPU add `--model tiny --device cpu`); on N cards
`torchrun --nproc-per-node N -m cloudtik_tpu_torch.recipes.llama_lora_finetune
--fsdp N` (every rank builds the same base and trains its shard of the
adapters and of each global batch).

Counterpart of `examples/recipes/llama_lora_finetune.py`: a frozen base
(random weights from seed 0, where a run would restore a checkpoint) and
rank-`--rank` adapters on wq and wv trained through the Trainer
(models/lora.py).  With `--checkpoint-dir` the trainer saves the adapters
and their optimizer state, which `tik-serve --engine --adapters-dir`
serves from `<adapters-dir>/<adapter id>`.
"""

from __future__ import annotations

import torch

from cloudtik_tpu_torch.models import transformer as T
from cloudtik_tpu_torch.models.lora import LoRAConfig, lora_spec
from cloudtik_tpu_torch.recipes.common import (build_recipe_trainer,
                                               recipe_argparser,
                                               recipe_device,
                                               run_and_report)
from cloudtik_tpu_torch.train.data import synthetic_lm_batches


def parser():
    p = recipe_argparser("llama-lora")
    p.add_argument("--model", default="tpu_1b",
                   help="llama2_7b for the full-size run")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--rank", type=int, default=16)
    return p


def build(args, optimizer=None):
    """(trainer, data, cfg, base params, LoRAConfig) for parsed `args`;
    `optimizer` is an `OptimizerConfig`, the default unless given."""
    cfg = T.config(args.model, max_seq_len=args.seq_len)
    device = recipe_device(args)
    # a base checkpoint would be restored here; synthetic init for the bench
    base = T.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device)
    lora_cfg = LoRAConfig(rank=args.rank)
    trainer = build_recipe_trainer(lora_spec(base, cfg, lora_cfg), args,
                                   seq_len=args.seq_len,
                                   optimizer=optimizer)
    data = synthetic_lm_batches(args.batch, args.seq_len, cfg.vocab_size)
    return trainer, data, cfg, base, lora_cfg


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data, *_ = build(args)
    return run_and_report(trainer, data, args.steps, args.batch, "seq")


if __name__ == "__main__":
    main()
