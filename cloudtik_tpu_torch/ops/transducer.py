"""RNN-T (transducer) loss in PyTorch.

Counterpart of `cloudtik_tpu/ops/transducer.py`: the negative log
posterior of the labels under the transducer lattice,

    alpha[t, u] = LSE(alpha[t-1, u] + blank[t-1, u],
                      alpha[t, u-1] + label[t, u-1]),

with the same conventions: log-probs in f32, emissions past a row's label
length masked to the `-1e30` sentinel, padded cells on that sentinel rather
than -inf, and `_lse` guarded by `isfinite`, so padded cells get a zero
gradient and never NaN.  Gradients come from autograd, as the reference's
come from autodiff.

The reference solves each lattice row as a (LSE, +) affine recurrence with
`lax.associative_scan` inside a `lax.scan` over t.  Eager PyTorch has
neither, and a row scan would cost about log2(U+1) launches of a dozen
ops for each of the T rows.  Here the lattice is walked by anti-diagonals
instead: both predecessors of a cell on diagonal d = t + u lie on diagonal
d - 1, so one vector step per diagonal computes a whole diagonal, T + U - 1
steps in all.  The blank and label log-probs are skewed once into
diagonal-major `[T + U, B, U + 1]` planes (cells off the lattice on the
sentinel).  The recurrence and its candidates are the reference's; only the
order of the LSEs along a row differs, by rounding.

`transducer_loss_reference` is the reference's per-cell loop, kept as the
port's own float64 numpy oracle.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG_INF = -1e30


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def _skew(x: torch.Tensor, n_diag: int) -> torch.Tensor:
    """x [B, T, U1] -> [n_diag, B, U1] with out[d, b, u] = x[b, d - u, u]
    where 0 <= d - u < T, else the sentinel."""
    B, T, U1 = x.shape
    d = torch.arange(n_diag, device=x.device)[:, None]
    u = torch.arange(U1, device=x.device)[None, :]
    t = d - u                                               # [D, U1]
    valid = (t >= 0) & (t < T)
    idx = t.clamp(0, T - 1)
    picked = x[:, idx, u.expand_as(idx)]                    # [B, D, U1]
    picked = torch.where(valid[None], picked,
                         torch.full_like(picked, _NEG_INF))
    return picked.transpose(0, 1)


def transducer_loss(log_probs: torch.Tensor, labels: torch.Tensor,
                    input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                    blank: int = 0) -> torch.Tensor:
    """Negative log posterior of `labels` under the transducer lattice.

    log_probs  [B, T, U+1, V] — log softmax of the joint network.
    labels     [B, U] int (padding arbitrary past label_lengths).
    input_lengths  [B] int in [1, T].
    label_lengths  [B] int in [0, U].
    Returns the per-example loss [B] (f32).
    """
    lp = log_probs.float()
    B, T, U1, V = lp.shape
    U = U1 - 1
    if tuple(labels.shape) != (B, U):
        raise ValueError(f"labels {tuple(labels.shape)} vs log_probs "
                         f"{tuple(lp.shape)}")
    device = lp.device
    labels = labels.long()
    input_lengths = input_lengths.long().to(device)
    label_lengths = label_lengths.long().to(device)

    lp_blank = lp[..., blank]                               # [B, T, U+1]
    lab = torch.cat([labels, torch.zeros((B, 1), dtype=labels.dtype,
                                         device=device)], dim=1)
    lp_label = torch.gather(
        lp, -1, lab[:, None, :, None].expand(B, T, U1, 1))[..., 0]
    # emissions past the true label length never advance u
    can_emit = (torch.arange(U1, device=device)[None, :]
                < label_lengths[:, None])                   # [B, U+1]
    lp_label = torch.where(can_emit[:, None, :], lp_label,
                           torch.full_like(lp_label, _NEG_INF))

    n_diag = T + U
    blank_d = _skew(lp_blank, n_diag)                       # [D, B, U+1]
    label_d = _skew(lp_label, n_diag)
    d_idx = torch.arange(n_diag, device=device)[:, None]
    u_idx = torch.arange(U1, device=device)[None, :]
    t_of = d_idx - u_idx
    on_lattice = ((t_of >= 0) & (t_of < T))[:, None, :]     # [D, 1, U+1]
    sentinel = torch.full((B, 1), _NEG_INF, device=device)

    # diagonal 0 holds the one cell (0, 0): alpha = 0
    alpha = torch.full((B, U1), _NEG_INF, device=device)
    alpha[:, 0] = 0.0
    alphas = [alpha]
    for d in range(1, n_diag):
        from_above = alpha + blank_d[d - 1]                 # (t-1, u)
        from_left = torch.cat(                              # (t, u-1)
            [sentinel, (alpha + label_d[d - 1])[:, :-1]], dim=1)
        alpha = _lse(from_above, from_left)
        alpha = torch.where(on_lattice[d], alpha,
                            torch.full_like(alpha, _NEG_INF))
        alphas.append(alpha)
    alphas = torch.stack(alphas)                            # [D, B, U+1]

    t_last = torch.clamp(input_lengths - 1, 0, T - 1)       # [B]
    u_last = torch.clamp(label_lengths, 0, U)               # [B]
    batch = torch.arange(B, device=device)
    alpha_final = alphas[t_last + u_last, batch, u_last]
    final_blank = lp_blank[batch, t_last, u_last]
    return -(alpha_final + final_blank)


def transducer_loss_reference(log_probs, labels, input_lengths,
                              label_lengths, blank: int = 0) -> np.ndarray:
    """Per-cell Python-loop lattice walk in float64 numpy (test oracle);
    takes numpy arrays or tensors, returns [B] float64."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().double().numpy() \
                if x.is_floating_point() else x.detach().cpu().numpy()
        return np.asarray(x)

    lp = host(log_probs).astype(np.float64)
    labels = host(labels)
    input_lengths, label_lengths = host(input_lengths), host(label_lengths)
    B, T, U1, V = lp.shape
    out = np.zeros((B,), np.float64)
    for b in range(B):
        Tl = int(input_lengths[b])
        Ul = int(label_lengths[b])
        alpha = np.full((Tl, Ul + 1), -np.inf)
        alpha[0, 0] = 0.0
        for t in range(Tl):
            for u in range(Ul + 1):
                cands = []
                if t > 0:
                    cands.append(alpha[t - 1, u] + lp[b, t - 1, u, blank])
                if u > 0:
                    cands.append(alpha[t, u - 1]
                                 + lp[b, t, u - 1, labels[b, u - 1]])
                if cands:
                    alpha[t, u] = np.logaddexp.reduce(cands)
        out[b] = -(alpha[Tl - 1, Ul] + lp[b, Tl - 1, Ul, blank])
    return out
