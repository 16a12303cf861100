"""Histogram gradient-boosted decision trees in PyTorch.

Counterpart of `cloudtik_tpu/models/gbdt.py`: the same `GBDTConfig`, the
same host binning (`quantile_bins` / `apply_bins`, numpy, copied here),
the same split search and the same forest arrays, saved in the same npz
format, so a forest crosses between the packages both ways.

A boosting round grows one depth-D tree level by level.  The split search
is a dense histogram per (node, feature, bin) of the gradients and
hessians, a scatter-add over `node * n_bins + bin`, then cumulative sums
over the bins and the closed-form gain's argmax over (feature, bin) for
every node of the level at once.  `n_bins` as a node's threshold means
"never right" (a node with no split of positive gain).  Trees live in
perfect-binary-tree arrays (split feature and bin per internal node, a
value per leaf), so prediction is D gathered comparisons a tree.

Where the port differs in form, not in result:

* The reference builds the histograms of all 2^depth node slots at every
  level; here level l builds its 2^l nodes, the only ones it writes.
* `_fit_softmax` vmaps the growth over K classes; here the class is a
  leading batch axis of every tensor, and the logistic and l2 objectives
  run as K = 1.
* The reference jit-compiles per shape; the port has nothing to compile.

On the card the scatter-add sums in no fixed order, so a split whose gain
ties another's to within rounding may differ from the CPU's.  A check
can grow any round on its own (`initial_scores`, `grow_round`,
`round_scores`) from the scores another device reached, and
`grow_round(gaps=[])` reports how close each split came.

Objectives: 'logistic' (binary), 'l2' (regression), 'softmax' (K
classes, one tree per class a round).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    n_trees: int = 100
    depth: int = 6
    learning_rate: float = 0.1
    n_bins: int = 64                 # <= 256 (uint8 bins)
    reg_lambda: float = 1.0
    min_child_hess: float = 1e-3
    objective: str = "logistic"      # 'logistic' | 'l2' | 'softmax'
    n_classes: int = 2               # softmax objective only


def config(**overrides) -> GBDTConfig:
    return GBDTConfig(**overrides)


# --------------------------------------------------------------------------
# Host-side binning
# --------------------------------------------------------------------------

def quantile_bins(features: np.ndarray, n_bins: int) -> np.ndarray:
    """[N, F] float -> bin edges [F, n_bins - 1] (host, numpy)."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(features, qs, axis=0).T.astype(np.float32)


def apply_bins(features: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """[N, F] float + edges [F, B-1] -> uint8 bin ids [N, F]."""
    out = np.empty(features.shape, np.uint8)
    for f in range(features.shape[1]):
        out[:, f] = np.searchsorted(edges[f], features[:, f])
    return out


# --------------------------------------------------------------------------
# Gradients
# --------------------------------------------------------------------------

def _grad_hess(scores: torch.Tensor, labels: torch.Tensor,
               objective: str) -> Tuple[torch.Tensor, torch.Tensor]:
    if objective == "logistic":
        p = torch.sigmoid(scores)
        return p - labels, torch.clamp(p * (1 - p), min=1e-6)
    if objective == "l2":
        return scores - labels, torch.ones_like(scores)
    raise ValueError(f"unknown objective {objective!r}")


# --------------------------------------------------------------------------
# Tree growth (one round, K trees at once)
# --------------------------------------------------------------------------

def _level_gains(binned_t: torch.Tensor, node_id: torch.Tensor,
                 g: torch.Tensor, h: torch.Tensor, n_nodes: int,
                 cfg: GBDTConfig) -> torch.Tensor:
    """Split gains [K, n_nodes, F * B] of one level (invalid splits at
    -inf).  binned_t [F, N], node_id/g/h [K, N]."""
    F, N = binned_t.shape
    K = g.shape[0]
    B = cfg.n_bins
    lam = cfg.reg_lambda
    seg = node_id[:, None, :] * B + binned_t[None]           # [K, F, N]

    def hist(values):                                        # [K, N]
        out = torch.zeros((K, F, n_nodes * B), dtype=values.dtype,
                          device=values.device)
        out.scatter_add_(2, seg, values[:, None, :].expand(K, F, N))
        return out.reshape(K, F, n_nodes, B).transpose(1, 2)  # [K,n,F,B]

    gl = torch.cumsum(hist(g), dim=-1)
    hl = torch.cumsum(hist(h), dim=-1)
    gt = gl[..., -1:]                                        # node totals
    ht = hl[..., -1:]
    gr = gt - gl
    hr = ht - hl
    gain = (gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam)
            - gt ** 2 / (ht + lam))
    ok = (hl >= cfg.min_child_hess) & (hr >= cfg.min_child_hess)
    # the last bin's "split" sends everything left: never valid
    ok = ok & (torch.arange(B, device=g.device) < B - 1)
    gain = torch.where(ok, gain, torch.full_like(gain, float("-inf")))
    return gain.reshape(K, n_nodes, F * B)


def _runner_up_gap(flat: torch.Tensor, best: torch.Tensor,
                   best_gain: torch.Tensor, n_bins: int) -> torch.Tensor:
    """How far the best gain stands above the runner-up's, per node,
    relative to the best (inf where the node has no usable split or no
    runner-up).  A gain equal to the best in the best's own feature (a
    threshold at an empty bin, which partitions the rows alike and sums
    to the same bits on every device) is not a runner-up; an equal gain in
    another feature is, at a gap of 0."""
    feature = torch.arange(flat.shape[-1], device=flat.device) // n_bins
    other = feature != (best // n_bins)[..., None]
    rival = (flat < best_gain[..., None]) | (
        (flat == best_gain[..., None]) & other)
    below = torch.where(rival, flat, torch.full_like(flat, float("-inf")))
    gap = (best_gain - below.max(dim=-1).values) / best_gain.abs()
    usable = (best_gain > 0) & torch.isfinite(gap)
    return torch.where(usable, gap, torch.full_like(gap, float("inf")))


def _grow_trees(binned: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                cfg: GBDTConfig, gaps: Optional[list] = None
                ) -> Dict[str, torch.Tensor]:
    """binned [N, F] int64, g/h [K, N] f32 -> K trees: split_feat /
    split_bin [K, 2^depth - 1] int32, leaf [K, 2^depth] f32.  With `gaps`,
    appends each level's [K, 2^l] `_runner_up_gap`."""
    N, F = binned.shape
    K = g.shape[0]
    B = cfg.n_bins
    lam = cfg.reg_lambda
    dev = g.device
    n_internal = 2 ** cfg.depth - 1
    split_feat = torch.zeros((K, n_internal), dtype=torch.int64, device=dev)
    split_bin = torch.full((K, n_internal), B, dtype=torch.int64,
                           device=dev)                       # never right
    node_id = torch.zeros((K, N), dtype=torch.int64, device=dev)
    binned_t = binned.t().contiguous()                       # [F, N]
    for level in range(cfg.depth):
        n_nodes = 2 ** level
        flat = _level_gains(binned_t, node_id, g, h, n_nodes, cfg)
        best = flat.argmax(dim=-1)                           # first on ties
        best_gain = flat.gather(-1, best[..., None])[..., 0]
        if gaps is not None:
            gaps.append(_runner_up_gap(flat, best, best_gain, B))
        feat = best // B
        thr = best % B
        # nodes with no usable split: route everything left (thr = B)
        thr = torch.where(best_gain > 0, thr, torch.full_like(thr, B))
        base = n_nodes - 1
        split_feat[:, base:base + n_nodes] = feat
        split_bin[:, base:base + n_nodes] = thr
        # descend the examples
        x_f = binned.gather(1, feat.gather(1, node_id).t()).t()   # [K, N]
        go_right = x_f > thr.gather(1, node_id)
        node_id = node_id * 2 + go_right.long()
    n_leaves = 2 ** cfg.depth
    G = torch.zeros((K, n_leaves), dtype=g.dtype, device=dev)
    H = torch.zeros_like(G)
    G.scatter_add_(1, node_id, g)
    H.scatter_add_(1, node_id, h)
    leaf = -cfg.learning_rate * G / (H + lam)
    return {"split_feat": split_feat.int(), "split_bin": split_bin.int(),
            "leaf": leaf}


def _trees_predict(trees: Dict[str, torch.Tensor], binned: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """K trees ([K, ...] arrays), all examples: D gathered comparisons
    -> [K, N]."""
    K = trees["leaf"].shape[0]
    N = binned.shape[0]
    node = torch.zeros((K, N), dtype=torch.int64, device=binned.device)
    feats = trees["split_feat"].long()
    bins = trees["split_bin"].long()
    for level in range(depth):
        idx = 2 ** level - 1 + node
        feat = feats.gather(1, idx)
        thr = bins.gather(1, idx)
        x_f = binned.gather(1, feat.t()).t()
        node = node * 2 + (x_f > thr).long()
    return trees["leaf"].gather(1, node)


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def _on_device(x, device: DeviceLike) -> torch.Tensor:
    """A tensor stays where it is unless a device is named; numpy goes to
    `device` (the card unless the caller asks)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def initial_scores(labels: torch.Tensor, cfg: GBDTConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(base score, targets [K, N]) for `labels` [N]: the logit of the
    positive rate (logistic), the mean (l2) or the log class priors
    (softmax, one-hot targets); K = 1 but for softmax."""
    if cfg.objective == "softmax":
        onehot = torch.nn.functional.one_hot(labels.long(),
                                             cfg.n_classes).float()
        prior = torch.clamp(onehot.mean(dim=0), 1e-4, 1.0)
        return torch.log(prior), onehot.t()                  # [K], [K, N]
    labels = labels.float()
    if cfg.objective == "logistic":
        p0 = torch.clamp(labels.mean(), 1e-4, 1 - 1e-4)
        return torch.log(p0 / (1 - p0)), labels[None]
    if cfg.objective == "l2":
        return labels.mean(), labels[None]
    raise ValueError(f"unknown objective {cfg.objective!r}")


def grow_round(binned: torch.Tensor, scores: torch.Tensor,
               targets: torch.Tensor, cfg: GBDTConfig,
               gaps: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """One boosting round: the gradients and hessians of `scores` [K, N]
    against `targets` [K, N], then K trees grown on them (`_grow_trees`;
    `gaps` receives each level's `_runner_up_gap`).  binned [N, F]
    int64."""
    if cfg.objective == "softmax":
        p = torch.softmax(scores, dim=0)                     # over classes
        g = p - targets
        h = torch.clamp(p * (1 - p), min=1e-6)
    else:
        g, h = _grad_hess(scores, targets, cfg.objective)
    return _grow_trees(binned, g, h, cfg, gaps)


def round_scores(trees: Dict[str, torch.Tensor], binned: torch.Tensor,
                 cfg: GBDTConfig) -> torch.Tensor:
    """What one round's K trees add to the scores: [K, N]."""
    return _trees_predict(trees, binned, cfg.depth)


def fit(binned, labels, cfg: GBDTConfig, *,
        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Train a forest.  binned [N, F] uint8, labels [N] (float targets,
    {0,1}, or int class ids for 'softmax'), as tensors (the forest lives
    where they do) or numpy arrays put on `device`.  Returns stacked tree
    arrays {split_feat, split_bin [T, 2^d-1], leaf [T, 2^d], base_score
    []}; the softmax objective adds a class dim ([T, K, ...], base [K])."""
    binned = _on_device(binned, device).long()
    base, targets = initial_scores(_on_device(labels, binned.device), cfg)
    K = targets.shape[0]
    scores = base.reshape(-1, 1).expand(K, binned.shape[0]).clone()
    rounds = []
    for _ in range(cfg.n_trees):
        trees = grow_round(binned, scores, targets, cfg)
        scores = scores + round_scores(trees, binned, cfg)
        rounds.append(trees)
    forest = {k: torch.stack([r[k] for r in rounds]) for k in rounds[0]}
    if cfg.objective != "softmax":
        forest = {k: v[:, 0] for k, v in forest.items()}
    forest["base_score"] = base
    return forest


def predict(forest: Dict[str, torch.Tensor], binned,
            cfg: GBDTConfig) -> torch.Tensor:
    """Raw scores: [N] (logistic/l2) or [N, K] (softmax), the trees added
    in order."""
    dev = forest["leaf"].device
    binned = torch.as_tensor(binned, device=dev).long()
    softmax = cfg.objective == "softmax"
    K = cfg.n_classes if softmax else 1
    score = forest["base_score"].reshape(-1, 1).expand(
        K, binned.shape[0]).clone()
    for i in range(forest["leaf"].shape[0]):
        tree = {k: v[i] if softmax else v[i][None]
                for k, v in forest.items() if k != "base_score"}
        score = score + _trees_predict(tree, binned, cfg.depth)
    return score.t() if softmax else score[0]


def predict_proba(forest: Dict[str, torch.Tensor], binned,
                  cfg: GBDTConfig) -> torch.Tensor:
    scores = predict(forest, binned, cfg)
    if cfg.objective == "softmax":
        return torch.softmax(scores, dim=-1)
    return torch.sigmoid(scores)


def save(path: str, forest: Dict[str, torch.Tensor],
         edges: Optional[np.ndarray] = None) -> None:
    """The JAX package's npz: one array per forest key, `__edges__` when
    the bin edges are given."""
    arrs = {k: v.detach().cpu().numpy() for k, v in forest.items()}
    if edges is not None:
        arrs["__edges__"] = edges
    np.savez(path, **arrs)


def load(path: str, device: DeviceLike = None
         ) -> Tuple[Dict[str, torch.Tensor], Optional[np.ndarray]]:
    """A forest saved by either package, on `device` (the card unless
    asked), and its bin edges (None when saved without)."""
    dev = resolve_device(device)
    data = np.load(path)
    edges = data["__edges__"] if "__edges__" in data else None
    forest = {k: torch.as_tensor(v, device=dev) for k, v in data.items()
              if k != "__edges__"}
    return forest, edges
