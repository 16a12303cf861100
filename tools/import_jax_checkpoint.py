#!/usr/bin/env python3
"""Convert the JAX package's orbax checkpoints into the PyTorch port's.

    python3 tools/import_jax_checkpoint.py SRC DST

SRC is a `cloudtik_tpu.train.checkpoint.Checkpointer` directory: a JAX
trainer's (each step holds {"params", "opt_state"}) or the LoRA trainer's
(each step holds {"params": adapters}).  Every committed step is read by
the JAX package's own `Checkpointer.restore` against a template built from
the step's orbax metadata (so any preset and optimizer configuration reads
back), params go through
`convert.params_from_jax` and optax's AdamW state through
`convert.opt_state_from_jax`, and the step is written under the same
number into DST in the port's format (`cloudtik_tpu_torch/train/
checkpoint.py`), dtypes kept (a bf16 leaf stays bf16).  DST then serves
(`tik-serve --checkpoint-dir DST`, `--adapters-dir`) and resumes
(`Trainer.maybe_resume`) in the port.  The conversion is one way and runs
where JAX is installed, on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def import_step(src, dst, step: int) -> None:
    """Read step `step` of the JAX Checkpointer `src` and write it into the
    port Checkpointer `dst`."""
    import jax

    from cloudtik_tpu_torch import convert

    meta = src._manager.item_metadata(step)["state"]
    template = jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype), meta)
    state = src.restore(template, step=step)
    unknown = set(state) - {"params", "opt_state"}
    if unknown or "params" not in state:
        raise ValueError(f"step {step}: expected a params tree (and an "
                         f"opt_state), got {sorted(state)}")
    out = {"params": convert.params_from_jax(state["params"], "cpu")}
    if "opt_state" in state:
        out["opt_state"] = convert.opt_state_from_jax(state["opt_state"],
                                                      "cpu")
    dst.save(step, out, force=True)


def import_checkpoints(src_dir: str, dst_dir: str) -> List[int]:
    """Every committed step of `src_dir` into `dst_dir`; returns the steps
    written."""
    from cloudtik_tpu.train.checkpoint import CheckpointConfig, Checkpointer
    from cloudtik_tpu_torch.train import checkpoint as port

    src = Checkpointer(CheckpointConfig(directory=src_dir))
    # keep every step: retention is the source run's business
    dst = port.Checkpointer(port.CheckpointConfig(
        directory=dst_dir, max_to_keep=0, async_save=False))
    try:
        todo = src.all_steps()
        if not todo:
            raise FileNotFoundError(f"no checkpoint under {src_dir}")
        for step in todo:
            import_step(src, dst, step)
        return todo
    finally:
        dst.close()
        src.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "import_jax_checkpoint",
        description="JAX (orbax) checkpoints -> the PyTorch port's format")
    p.add_argument("src", help="the JAX Checkpointer directory")
    p.add_argument("dst", help="the port's checkpoint directory")
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    written = import_checkpoints(os.path.expanduser(args.src),
                                 os.path.expanduser(args.dst))
    print(f"imported steps {written} into {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
