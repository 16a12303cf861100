"""LM inference recipe: KV-cache generation and a tokens/s report.

    python -m cloudtik_tpu_torch.recipes.lm_generate [--model tpu_moe_8x1b]

(on the CPU add `--model tiny --device cpu`).

Counterpart of `examples/recipes/lm_generate.py`: random weights from seed
0, a seeded random prompt of `--batch` x `--prompt-len`, one warm-up
`generate` (models/generate.py), then `--steps` timed calls, each with its
own seeded generator; one JSON line with tokens/s.  The time is taken
after the generated tokens reach the host.  Runs on one card; the mesh
flags are parsed for the shared harness and must stay 1.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from cloudtik_tpu_torch.models import generate as G
from cloudtik_tpu_torch.models import transformer as T
from cloudtik_tpu_torch.recipes.common import (mesh_config,
                                               recipe_argparser,
                                               recipe_device)


def parser():
    p = recipe_argparser("lm_generate")
    p.add_argument("--model", default="tpu_1b")
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--max-new", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if mesh_config(args) is not None:
        raise ValueError("lm_generate runs on one card: leave the mesh "
                         "flags at 1")
    device = recipe_device(args)
    cfg = T.config(args.model, max_seq_len=args.prompt_len + args.max_new)
    params = T.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)

    def run(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        # .cpu() waits for the device: the tokens are on the host
        return G.generate(params, prompt, cfg, max_new_tokens=args.max_new,
                          temperature=args.temperature, top_k=args.top_k,
                          generator=gen).cpu()

    run(1)                                  # warm-up
    t0 = time.perf_counter()
    for i in range(args.steps):
        run(2 + i)
    dt = time.perf_counter() - t0
    tokens = args.batch * args.max_new * args.steps
    result = {
        "steps": args.steps,
        "tokens_per_sec": round(tokens / dt, 2),
        "prompt_len": args.prompt_len,
        "max_new": args.max_new,
        "batch": args.batch,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
