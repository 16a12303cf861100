"""What a training step is held to: the reference's first steps.

From the seed's initial weights and the same batches, the reference runs
the causal LM loss (mean over labels), its gradients, the clip by global
norm and optax's AdamW (bias-corrected moments, eps outside the root,
decoupled weight decay on every leaf, the learning rate of the warmup and
cosine schedule at the count before the step), in float32 with TF32 off.
Layers are recomputed in the backward pass (checkpointed one by one) and
the loss runs over sequence chunks, so the reference fits where the
program's state was.

It reports, by leaf of the port's layout: each step's loss; the norm of
the first step's clipped gradient; the norm of each leaf's change after
the last step; and the first gradient's norms, by which the comparison
leaves out leaves whose gradient is nought to rounding.
"""

import math
from typing import Callable, Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import model as M

LOSS_CHUNK = 512


def lr_at(opt: Dict, count: int) -> float:
    """Linear warmup from 0 over `warmup_steps`, then cosine decay to
    `min_lr_ratio` of the peak at `total_steps` (optax's join)."""
    peak, warm = opt["learning_rate"], opt["warmup_steps"]
    if count < warm:
        return peak * count / warm
    decay = max(opt["total_steps"] - warm, 1)
    c = min(count - warm, decay)
    alpha = opt["min_lr_ratio"]
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                   + alpha)


def merged(params: Dict, i: int, adapters: Dict, scale: float) -> Dict:
    """Layer i's weights with each adapter pair folded in:
    w + (a @ b) * scale, in float32."""
    w = M.layer_weights(params, i)
    for target, pair in (adapters or {}).items():
        delta = torch.einsum("dr,rhk->dhk", pair["a"][i].float(),
                             pair["b"][i].float())
        w[target] = w[target].float() + delta * scale
    return w


def _seq_loss(params: Dict, t: Dict, tokens: torch.Tensor,
              labels: torch.Tensor, quant: M.Quant, adapters=None,
              scale: float = 0.0):
    """(summed nll, valid labels) of one sequence, each layer and each
    loss chunk checkpointed."""
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens].float()
    for i in range(t["n_layers"]):
        def one(x, i=i):
            return M.layer(t, merged(params, i, adapters, scale), x, pos,
                           quant)
        x = checkpoint(one, x, use_reentrant=False)
    x = M.rms_norm(x, params["final_norm"], t["norm_eps"])
    head = M.head(params, t)

    def chunk(xc, lc):
        logp = torch.log_softmax(M.mm(xc, head.float(), quant), dim=-1)
        valid = lc != -100
        picked = logp.gather(-1, lc.clamp_min(0)[:, None])[:, 0]
        return -(picked * valid).sum()

    nll = torch.zeros((), device=x.device)
    for c0 in range(0, S, LOSS_CHUNK):
        nll = nll + checkpoint(chunk, x[c0:c0 + LOSS_CHUNK],
                               labels[c0:c0 + LOSS_CHUNK],
                               use_reentrant=False)
    return nll, int((labels != -100).sum())


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def leaf_paths(tree: Dict, prefix: str = ""):
    """(dotted path, leaf) of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def run_steps(params: Dict, t: Dict, opt: Dict,
              batches: Sequence[Dict[str, torch.Tensor]],
              initial: Callable[[str], torch.Tensor],
              quant: M.Quant = None, adapters: Dict = None,
              lora_scale: float = 0.0) -> Dict:
    """Train `params` (float32 leaves, changed in place) over `batches`;
    with `adapters` ({target: {"a", "b"}}, float32), train those alone
    over the frozen `params`.  `initial(path)` gives a trained leaf's
    starting value again (the harness draws it anew from the seed),
    against which the change is read."""
    M.set_exact()
    leaves = dict(leaf_paths(adapters if adapters else params))
    for v in leaves.values():
        v.requires_grad_(True)
    mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        tokens, labels = batch["tokens"], batch["labels"]
        n_valid = max(int((labels != -100).sum()), 1)
        nll_sum = 0.0
        for b in range(tokens.shape[0]):   # one row's graph at a time
            nll, _ = _seq_loss(params, t, tokens[b], labels[b], quant,
                               adapters, lora_scale)
            (nll / n_valid).backward()
            nll_sum += float(nll.detach())
        losses.append(nll_sum / n_valid)
        with torch.no_grad():
            grads = {k: v.grad for k, v in leaves.items()}
            gnorm = math.sqrt(sum(_norm(g) ** 2
                                  for g in grads.values()))
            scale = 1.0 if gnorm < opt["grad_clip_norm"] \
                else opt["grad_clip_norm"] / gnorm
            if step == 0:
                first_grad = {k: _norm(g) * scale
                              for k, g in grads.items()}
            count = step + 1
            lr = lr_at(opt, step)
            b1, b2 = opt["b1"], opt["b2"]
            bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
            for k, p in leaves.items():
                g = grads[k].mul_(scale)
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + opt["eps"])
                u.add_(p, alpha=opt["weight_decay"])
                p.add_(u, alpha=-lr)
                p.grad = None
                del g, u
    del mu, nu
    with torch.no_grad():
        change = {k: _norm(p - initial(k))
                  for k, p in leaves.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
