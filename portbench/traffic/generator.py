"""The one generator of traffic: every mix is parameters in a cell's file.

Sizes and gaps are fixed sets, the same for every seed: quantiles of the
distribution the cell names (lognormal, uniform, exponential gaps), one
set a block of requests.  The seed only orders each block and draws the
token ids, so two seeds do the same work, stretch by stretch, in another
order, and a run's spread is the system's, not the draw's.
"""

import math
import statistics
from typing import Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


def quantile_sizes(spec: Dict, n: int) -> List[int]:
    """n sizes at the mid-quantiles (i + 0.5) / n of `spec`:
    {"dist": "lognormal", "median", "sigma", "min", "max"} or
    {"dist": "uniform", "min", "max"} or {"dist": "fixed", "value"}."""
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = math.exp(math.log(spec["median"])
                         + spec["sigma"] * _NORMAL.inv_cdf(u))
        elif spec["dist"] == "uniform":
            x = spec["min"] + (spec["max"] - spec["min"]) * u
        elif spec["dist"] == "fixed":
            x = spec["value"]
        else:
            raise ValueError(f"unknown distribution {spec['dist']!r}")
        out.append(int(min(max(round(x), spec.get("min", 1)),
                           spec.get("max", 1 << 30))))
    return out


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(stream)])


def token_ids(seed: int, stream: int, n: int, vocab: int) -> List[int]:
    return rng(seed, stream).integers(0, vocab, n).tolist()


def blocked_order(n: int, block: int, seed: int, stream: int) -> List[int]:
    """An order of n = k * block items in which every block of `block`
    consecutive items takes each index of 0..block-1 once, in the seed's
    order: the same work lands in every stretch of the window, so a seed
    moves a run's tail as little as the order within a block can."""
    g = rng(seed, stream)
    return [int(i) for _ in range(n // block) for i in g.permutation(block)]


def open_loop(mix: Dict, seconds: float, seed: int, vocab: int) -> List[Dict]:
    """The requests of an open loop: due offset, prompt, output length.

    n = round(rate * seconds / block) * block requests.  The gaps are the
    exponential's mid-quantiles at the rate, the prompt and output lengths
    their distributions' (generator.quantile_sizes), each a set of
    `block` values; every block of `block` arrivals takes each of them
    once (blocked_order).  The gaps are then scaled so that the n-th
    arrival falls inside the window: the offered rate is n / seconds."""
    block, rate = mix["block"], mix["rate_per_s"]
    n = max(int(round(rate * seconds / block)), 1) * block
    gap_set = [-math.log(1 - (i + 0.5) / block) / rate
               for i in range(block)]
    gaps = np.array([gap_set[i] for i in blocked_order(n, block, seed, 1)])
    gaps *= seconds * (1 - 0.5 / n) / gaps.sum()
    offsets = np.cumsum(gaps) - gaps[0]
    plens = quantile_sizes(mix["prompt"], block)
    olens = quantile_sizes(mix["output"], block)
    p_order = blocked_order(n, block, seed, 2)
    o_order = blocked_order(n, block, seed, 3)
    ids = rng(seed, 4)
    return [{"due": float(offsets[i]),
             "prompt": ids.integers(0, vocab, plens[p_order[i]]).tolist(),
             "max_new_tokens": olens[o_order[i]]} for i in range(n)]


class ClosedLoopSource:
    """The requests of a closed loop, in order: blocks of `block` requests
    whose sizes are the same fixed set, each block in the seed's order.
    With `prefix`, each prompt starts with one of `templates` shared
    instruction prompts (drawn once from the seed), then a document."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.block = mix["block"]
        self.plens = quantile_sizes(mix["prompt"], self.block)
        self.olens = quantile_sizes(mix["output"], self.block)
        pre = mix.get("prefix")
        self.templates = [token_ids(seed, 10 + k, pre["tokens"], vocab)
                          for k in range(pre["templates"])] if pre else []
        self.ids = rng(seed, 5)
        self._order = []
        self._n = 0

    def next(self) -> Dict:
        if not self._order:
            b = self._n // self.block
            self._order = list(rng(self.seed, 100 + b).permutation(
                self.block))
        i = self._order.pop()
        body = self.ids.integers(0, self.vocab, self.plens[i]).tolist()
        if self.templates:
            body = self.templates[self._n % len(self.templates)] + body
        self._n += 1
        return {"prompt": body, "max_new_tokens": self.olens[i]}
