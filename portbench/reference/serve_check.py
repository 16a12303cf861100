"""What a served model's answers are held to.

For each sampled request the reference runs once over its prompt and its
served tokens (teacher-forced) and reads, at every served token, the gap
by which that token's logit lies below the reference's best.  Greedy
decoding picks the best, so a sound program's gaps are rounding; a wrong
token, a dropped cache write or a misplaced position opens gaps of the
logits' own spread.

The reference runs layer by layer over all the sequences: each layer's
weights are read as float32 once, the hidden states of every sequence
stay on the card (a few thousand rows of d).
"""

from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import model as M


@torch.no_grad()
def teacher_logits(params: Dict, t: Dict, seqs: Sequence[List[int]],
                   starts: Sequence[int], quant: M.Quant = None,
                   device=None) -> List[torch.Tensor]:
    """Float32 logits of each sequence at positions starts[i]-1 onward
    (the positions whose next token was served): [n_served, V] each."""
    device = device or params["embed"].device
    xs = []
    for s in seqs:
        tok = torch.tensor(s, device=device)
        xs.append(params["embed"][tok].float())
    for i in range(t["n_layers"]):
        w = {k: v.float() for k, v in M.layer_weights(params, i).items()}
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[0], device=device)
            xs[j] = M.layer(t, w, x, pos, quant)
        del w
    head = M.head(params, t).float()
    out = []
    for x, st in zip(xs, starts):
        h = M.rms_norm(x[st - 1:], params["final_norm"], t["norm_eps"])
        out.append(M.mm(h, head, quant))
    return out


def served_gaps(params: Dict, t: Dict,
                requests: Sequence[Tuple[List[int], List[int]]],
                quant: M.Quant = None) -> Dict[str, float]:
    """requests: (prompt, served tokens).  Returns the widest gap over all
    served tokens, and how many tokens were compared.  With `quant`, the
    gap is that of the token the lowered precision puts first (the
    control, read at the same positions of the same tokens)."""
    seqs = [list(p) + list(o[:-1]) for p, o in requests]
    starts = [len(p) for p, _ in requests]
    exact = teacher_logits(params, t, seqs, starts)
    low = teacher_logits(params, t, seqs, starts, quant) if quant else None
    worst, n = 0.0, 0
    for j, (_, served) in enumerate(requests):
        lg = exact[j][:len(served)]
        best = lg.max(dim=-1).values
        if low is None:
            pick = torch.tensor(served, device=lg.device)
        else:
            pick = low[j][:len(served)].argmax(dim=-1)
        gap = best - lg.gather(-1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        n += len(served)
    return {"widest_gap": worst, "tokens": n}
