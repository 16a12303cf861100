"""Tiny cells for the CPU tests: the real cells' files with the sizes cut
to what a test run holds, computing in bf16 over f32 master weights
(training) or bf16 weights (serving), as the real configurations do.
`exact=True` computes in float32 throughout, where the program and the
reference agree to rounding.

The limits are the tiny size's own, set as the cells' are, from readings
on the CPU (bf16; three seeds each): training's lower readings loss
<= 3.1e-4, grad1 <= 1.42e-3, change <= 7.7e-4, the control's grad1 >=
7.2e-3 and change >= 1.7e-3; serving's widest gap <= 6.9e-3, the
control's up to 0.19 (0.0 on one seed of 32 tokens).  Every planted
fault reads at least 0.036 on grad1 or 0.06 on change."""

import copy
import time

import torch

from portbench import harness

TINY = {"vocab_size": 256, "d_model": 64, "n_layers": 2, "n_heads": 4,
        "n_kv_heads": 2, "d_ff": 128, "rope_theta": 10000.0,
        "norm_eps": 1e-5, "dtype": "bfloat16", "param_dtype": "float32",
        "tie_embeddings": False, "remat": True, "remat_policy": "save_attn"}

ENGINE = {"slots": 4, "max_len": 128, "block_size": 16, "prefix_cache": True}
OUT = {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 3, "max": 12}
LIMITS = {"train": {"loss": 0.005, "grad1": 0.004, "change": 0.0015,
                    "change_median": 0.0015},
          "serve": {"widest_gap": 0.03}}
SIZES = {
    "train": {"batch": 2, "seq_len": 32},
    "open": {"engine": ENGINE, "warm_prompt_lengths": [16, 32],
             "check": {"sample_tokens": 30},
             "mix": {"loop": "open", "rate_per_s": 4.0, "block": 4,
                     "prompt": {"dist": "lognormal", "median": 20,
                                "sigma": 0.6, "min": 4, "max": 60},
                     "output": OUT}},
    "closed": {"engine": ENGINE, "warm_prompt_lengths": [16, 32],
               "check": {"sample_tokens": 30},
               "mix": {"loop": "closed", "clients": 8, "block": 8,
                       "prefix": {"templates": 2, "tokens": 32},
                       "prompt": {"dist": "uniform", "min": 4, "max": 30},
                       "output": OUT}},
}


def cell(name: str, exact: bool = False, **over):
    c = harness.load_json(harness.PB / "workloads" / f"{name}.json")
    kind = c["kind"] if c["kind"] == "train" else c["mix"]["loop"]
    c.update(copy.deepcopy(SIZES[kind]))
    c["limits"] = dict(LIMITS[c["kind"]])
    c.update(over)
    t = dict(TINY)
    if c["kind"] == "serve":
        t["param_dtype"] = "bfloat16"
    if exact:
        t["dtype"] = t["param_dtype"] = "float32"
    c["config_file"] = {"transformer": t}
    return c


def context(name: str, seed: int = 12345678901, seconds: float = 1.5,
            trace: bool = False, exact: bool = False,
            **over) -> harness.Context:
    return harness.Context(name, seed, seconds, trace, torch.device("cpu"),
                           time.monotonic(), cell=cell(name, exact, **over))


def cells(kind=None):
    bench = harness.benchmark()
    out = []
    for w in bench["workloads"]:
        c = harness.load_json(harness.PB / "workloads" / f"{w['name']}.json")
        if kind is None or c["kind"] == kind:
            out.append(w["name"])
    return out
