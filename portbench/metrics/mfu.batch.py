"""mfu.batch: model FLOPs of the tokens the window computed (prompt
tokens not served from the prefix cache, then each decoded token, each
at its position: arith/model.forward_flops) over the window's seconds
and the card's published dense bf16 peak (host clock)."""

from portbench.arith import model
from portbench.arith.peaks import peak_flops


def read(record):
    if record.get("kind") != "serve" or record.get("loop") != "closed":
        return None
    t = record["transformer"]
    flops = 0.0
    for r in record["requests"]:
        n = r.get("n_window", r["n_out"])
        if n == 0:
            continue               # its prompt may not have finished
        P = r["prompt_len"]
        flops += sum(model.forward_flops(t, p)
                     for p in range(r["prefix_tokens"], P))
        flops += sum(model.forward_flops(t, P + j) for j in range(n - 1))
    return 100.0 * flops / record["window_s"] / peak_flops(
        record["peak_kind"])
