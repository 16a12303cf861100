"""mfu.train: the benchmark's own model FLOPs a token (the cell's file)
times the window's tokens, over the window's seconds and the card's
published dense bf16 peak (host clock; the profiled steps left out)."""

from portbench.arith.peaks import peak_flops


def read(record):
    if record.get("kind") != "train" or record["window_s"] <= 0:
        return None
    flops = record["flops_per_token"] * record["tokens_per_step"] \
        * record["steps"]
    return 100.0 * flops / record["window_s"] / peak_flops(
        record["peak_kind"])
