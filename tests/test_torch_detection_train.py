"""Port parity: the detection and vision training losses against the JAX
package's, on the `tiny` presets in f32.

Parameters come from the JAX `init_params` through `convert.py`, batches
from the JAX package's own synthetic generators.  ResNet, SSD and Mask
R-CNN `loss_fn` agree with JAX in the loss and every metric within 1e-5,
and the port's autograd gradients with `jax.grad` within 1e-4 relative L2
per leaf (f32 on both sides, sums in another order).  The targets
(`match_anchors`, `_rpn_targets`, `_roi_targets`, `_crop_gt_masks`) agree
label for label and within 1e-5, including the XLA last-writer rule where
two ground-truth boxes force-claim one anchor.  Where a discrete choice
(the mining cutoff, the top-K proposals) could flip on an f32 ulp, its gap
is asserted first, so a flip at a new seed shows as a failed
precondition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import maskrcnn as JM
from cloudtik_tpu.models import resnet as JR
from cloudtik_tpu.models import ssd as JS
from cloudtik_tpu.ops import detection as JD
from cloudtik_tpu.train import data as JDA
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import maskrcnn as TM
from cloudtik_tpu_torch.models import resnet as TR
from cloudtik_tpu_torch.models import ssd as TS
from cloudtik_tpu_torch.ops import detection as TD
from cloudtik_tpu_torch.train import trainer as TTR
from cloudtik_tpu_torch.tree import tree_leaves

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_REL_L2 = 1e-4
TARGET_TOL = 1e-5


def _params(JMod, TMod, name="tiny", seed=0):
    jcfg = JMod.config(name, dtype=jnp.float32)
    tcfg = TMod.config(name, dtype=torch.float32)
    jp = JMod.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    return jcfg, tcfg, jp, tp


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (norm if norm > 0 else 1.0)


def _check_loss_and_grads(JMod, TMod, jcfg, tcfg, jp, tp, batch):
    """The loss and every metric within LOSS_TOL; every gradient leaf
    within GRAD_REL_L2.  Returns the JAX metrics."""
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: JMod.loss_fn(p, jbatch, jcfg), has_aux=True)(jp)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, metrics = TMod.loss_fn(tp, tbatch, tcfg)
    assert set(metrics) == set(jmetrics)
    assert all(not m.requires_grad for m in metrics.values())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(want),
                                   rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    want_leaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(want_leaves)
    rel = [_rel_l2(g.numpy(), w) for g, w in zip(grads, want_leaves)]
    assert max(rel) <= GRAD_REL_L2, max(rel)
    return jmetrics


# ------------------------------------------------------------ resnet --

def test_resnet_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _params(JR, TR)
    batch = next(JDA.synthetic_image_batches(4, jcfg.image_size,
                                             jcfg.num_classes, seed=1))
    metrics = _check_loss_and_grads(JR, TR, jcfg, tcfg, jp, tp, batch)
    assert set(metrics) == {"loss", "accuracy"}


# --------------------------------------------------------------- ssd --

def _ssd_batch(jcfg, seed=1):
    return next(JDA.synthetic_detection_batches(
        2, jcfg.image_size, jcfg.num_classes, jcfg.max_boxes, seed=seed))


def _assert_mining_separated(jp, tp, jcfg, tcfg, batch):
    """Precondition: each image's hard-negative cutoff sits between two
    losses further apart than twice the port's CE differs from JAX's."""
    images = batch["images"]
    jlogits, _ = JS.forward(jp, jnp.asarray(images), jcfg)
    with torch.no_grad():
        tlogits, _ = TS.forward(tp, torch.from_numpy(images), tcfg)
    anchors = JS.anchors(jcfg)
    labels, _ = jax.vmap(lambda b, l: JS.match_anchors(
        b, l, anchors, jcfg))(jnp.asarray(batch["gt_boxes"]),
                              jnp.asarray(batch["gt_labels"]))
    labels = np.asarray(labels)
    jce = -np.take_along_axis(np.asarray(jax.nn.log_softmax(jlogits)),
                              labels[..., None], -1)[..., 0]
    tce = -torch.log_softmax(tlogits, -1).gather(
        -1, torch.tensor(labels).long()[..., None])[..., 0].numpy()
    diff = np.abs(jce - tce).max()
    for b in range(len(images)):
        pos = labels[b] > 0
        num_neg = min(int(jcfg.neg_pos_ratio * max(pos.sum(), 1)),
                      pos.size - 1)
        neg = np.sort(jce[b][~pos])[::-1]
        if num_neg < neg.size:
            assert neg[num_neg - 1] - neg[num_neg] > 2 * diff, (b, diff)


def test_ssd_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _params(JS, TS)
    batch = _ssd_batch(jcfg)
    _assert_mining_separated(jp, tp, jcfg, tcfg, batch)
    metrics = _check_loss_and_grads(JS, TS, jcfg, tcfg, jp, tp, batch)
    assert float(metrics["num_pos"]) >= 1


def _jax_match(gt_boxes, gt_labels, jcfg):
    anchors = JS.anchors(jcfg)
    labels, targets = jax.vmap(lambda b, l: JS.match_anchors(
        b, l, anchors, jcfg))(jnp.asarray(gt_boxes), jnp.asarray(gt_labels))
    return np.asarray(labels), np.asarray(targets)


def _port_match(gt_boxes, gt_labels, tcfg):
    labels, targets = TS.match_anchors(
        torch.from_numpy(gt_boxes), torch.from_numpy(gt_labels),
        TS.anchors_on(tcfg, torch.device("cpu")), tcfg)
    return labels.numpy(), targets.numpy()


def test_match_anchors_matches_jax():
    jcfg, tcfg = JS.config("tiny"), TS.config("tiny")
    batch = _ssd_batch(jcfg, seed=4)
    want = _jax_match(batch["gt_boxes"], batch["gt_labels"], jcfg)
    got = _port_match(batch["gt_boxes"], batch["gt_labels"], tcfg)
    assert got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=TARGET_TOL,
                               atol=TARGET_TOL)


def test_match_anchors_duplicate_claim_keeps_the_last_writer():
    """Three gts with one box (labels 1, 2, 3) force-claim the same anchor:
    XLA keeps the last, and so must the port; a padding row between them
    claims nothing."""
    jcfg, tcfg = JS.config("tiny"), TS.config("tiny")
    M = jcfg.max_boxes
    boxes = np.zeros((1, M, 4), np.float32)
    labels = np.zeros((1, M), np.int32)
    box = [0.31, 0.27, 0.52, 0.49]
    for m, lab in ((0, 1), (2, 2), (4, 3)):
        boxes[0, m], labels[0, m] = box, lab
    boxes[0, 5], labels[0, 5] = [0.0, 0.0, 0.2, 0.2], 4
    want = _jax_match(boxes, labels, jcfg)
    got = _port_match(boxes, labels, tcfg)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=TARGET_TOL,
                               atol=TARGET_TOL)
    # the shared anchor went to the last claimant (anchors matched by the
    # threshold alone take the first of the tied gts, as argmax does)
    iou = np.asarray(JD.box_iou(jnp.asarray(boxes[0, :1]), JS.cxcywh_to_xyxy(
        JS.anchors(jcfg))))[0]
    assert got[0][0, int(iou.argmax())] == 3


# ---------------------------------------------------------- maskrcnn --

def _planted_maskrcnn_batch(jp, jcfg, seed=1, masks=True):
    """A synthetic batch whose first three gts of each image are the JAX
    proposals shrunk by 2%, so that the ROI losses have positives; masks
    (at twice the mask head's size, as the recipe) are box interiors."""
    mask_size = 2 * jcfg.mask_pool
    batch = next(JDA.synthetic_detection_batches(
        2, jcfg.image_size, jcfg.num_classes, jcfg.max_boxes,
        mask_size=mask_size, seed=seed))
    feat = JM.backbone_feature(jp, jnp.asarray(batch["images"]), jcfg)
    obj, deltas = JM.rpn_forward(jp, feat, jcfg)
    props = np.asarray(JM.propose(obj, deltas, JM.anchors(jcfg), jcfg)[0])
    grid = (np.arange(mask_size) + 0.5) / mask_size
    for b in range(2):
        for m in range(3):
            x1, y1, x2, y2 = props[b, m]
            cx, cy, w, h = (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1
            box = np.array([cx - 0.49 * w, cy - 0.49 * h, cx + 0.49 * w,
                            cy + 0.49 * h], np.float32)
            batch["gt_boxes"][b, m] = box
            batch["gt_labels"][b, m] = 1 + (b + m) % (jcfg.num_classes - 1)
            batch["gt_masks"][b, m] = ((grid[:, None] >= box[1])
                                       & (grid[:, None] <= box[3])
                                       & (grid[None, :] >= box[0])
                                       & (grid[None, :] <= box[2]))
    if not masks:
        batch.pop("gt_masks")
    return batch


def _assert_topk_separated(jp, tp, jcfg, tcfg, images):
    """Precondition: the K-th and K+1-th objectness are further apart
    than twice the port's objectness differs from JAX's."""
    jfeat = JM.backbone_feature(jp, jnp.asarray(images), jcfg)
    jobj, _ = JM.rpn_forward(jp, jfeat, jcfg)
    with torch.no_grad():
        obj, _ = TM.rpn_forward(tp, TM.backbone_feature(
            tp, torch.from_numpy(images), tcfg), tcfg)
    k = jcfg.num_proposals
    top = -np.sort(-np.asarray(jobj), axis=1)[:, :k + 1]
    gap = np.diff(-top, axis=1).min()
    assert gap > 2 * np.abs(obj.numpy() - np.asarray(jobj)).max(), gap


@pytest.mark.parametrize("masks", [True, False])
def test_maskrcnn_loss_and_grads_match_jax(masks):
    jcfg, tcfg, jp, tp = _params(JM, TM)
    batch = _planted_maskrcnn_batch(jp, jcfg, masks=masks)
    _assert_topk_separated(jp, tp, jcfg, tcfg, batch["images"])
    metrics = _check_loss_and_grads(JM, TM, jcfg, tcfg, jp, tp, batch)
    assert float(metrics["num_pos"]) >= 3
    assert ("mask_loss" in metrics) == masks
    if masks:
        assert float(metrics["mask_loss"]) > 0


def _maskrcnn_targets_inputs():
    jcfg, tcfg, jp, tp = _params(JM, TM)
    batch = _planted_maskrcnn_batch(jp, jcfg, seed=2)
    feat = JM.backbone_feature(jp, jnp.asarray(batch["images"]), jcfg)
    obj, deltas = JM.rpn_forward(jp, feat, jcfg)
    props = np.array(JM.propose(obj, deltas, JM.anchors(jcfg), jcfg)[0])
    return jcfg, tcfg, batch, props


def test_rpn_targets_match_jax():
    jcfg, tcfg, batch, _ = _maskrcnn_targets_inputs()
    anchors = JM.anchors(jcfg)
    want = jax.vmap(lambda b, l: JM._rpn_targets(b, l, anchors, jcfg))(
        jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_labels"]))
    got = TM._rpn_targets(torch.from_numpy(batch["gt_boxes"]),
                          torch.from_numpy(batch["gt_labels"]),
                          TM.anchors_on(tcfg, torch.device("cpu")), tcfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert set(np.unique(got[0].numpy())) == {-1, 0, 1}
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=TARGET_TOL, atol=TARGET_TOL)


def test_roi_targets_and_mask_crops_match_jax():
    jcfg, tcfg, batch, props = _maskrcnn_targets_inputs()
    want = jax.vmap(lambda p, b, l: JM._roi_targets(p, b, l, jcfg))(
        jnp.asarray(props), jnp.asarray(batch["gt_boxes"]),
        jnp.asarray(batch["gt_labels"]))
    got = TM._roi_targets(torch.from_numpy(props),
                          torch.from_numpy(batch["gt_boxes"]),
                          torch.from_numpy(batch["gt_labels"]), tcfg)
    for name, g, w in zip(("labels", "targets", "best_gt", "pos"), got,
                          want):
        if name == "targets":
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TARGET_TOL, atol=TARGET_TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    labels, _, best_gt, pos = got
    assert int(pos.sum()) >= 6 and (labels[pos] > 0).all()
    wcrops = jax.vmap(lambda p, g, m, pp: JM._crop_gt_masks(
        m, g, p, pp, jcfg))(jnp.asarray(props), want[2],
                            jnp.asarray(batch["gt_masks"]), want[3])
    crops = TM._crop_gt_masks(torch.from_numpy(batch["gt_masks"]), best_gt,
                              torch.from_numpy(props), pos, tcfg)
    assert crops.shape == (2, jcfg.num_proposals, jcfg.mask_pool,
                           jcfg.mask_pool)
    np.testing.assert_allclose(crops.numpy(), np.asarray(wcrops),
                               rtol=TARGET_TOL, atol=TARGET_TOL)
    assert float(crops.max()) > 0.5


def test_maskrcnn_loss_pools_with_a_gradient_to_the_backbone():
    """The ROI losses reach the backbone through both poolings: its
    gradient with them differs from its gradient from the RPN alone."""
    jcfg, tcfg, jp, tp = _params(JM, TM)
    batch = {k: torch.from_numpy(v) for k, v in
             _planted_maskrcnn_batch(jp, jcfg).items()}
    loss, _ = TM.loss_fn(tp, batch, tcfg)
    feat = TM.backbone_feature(tp, batch["images"], tcfg)
    obj, deltas = TM.rpn_forward(tp, feat, tcfg)
    rpn = sum(TM.rpn_losses(obj, deltas, batch["gt_boxes"],
                            batch["gt_labels"].long(),
                            TM.anchors_on(tcfg, torch.device("cpu")), tcfg))
    leaves = tree_leaves(tp["backbone"])
    full = torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)
    alone = torch.autograd.grad(rpn, leaves, allow_unused=True,
                                materialize_grads=True)
    moved = [float((a - b).norm() / a.norm().clamp(min=1e-30))
             for a, b in zip(full, alone) if a.norm() > 0]
    assert moved and min(moved) > 1e-3


# ------------------------------------------------------- focal loss --

@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("alpha", [0.25, -1.0])
def test_sigmoid_focal_loss_matches_jax(reduction, alpha):
    rng = np.random.default_rng(5)
    logits = rng.normal(scale=3.0, size=(4, 6, 5)).astype(np.float32)
    targets = (rng.uniform(size=(4, 6, 5)) < 0.3).astype(np.float32)
    kw = dict(alpha=alpha, gamma=2.0, reduction=reduction)
    want = JD.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                 **kw)
    got = TD.sigmoid_focal_loss(torch.from_numpy(logits),
                                torch.from_numpy(targets), **kw)
    assert tuple(got.shape) == np.shape(want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_optax_sigmoid_ce_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(scale=10.0, size=(64,)).astype(np.float32)
    labels = rng.uniform(size=(64,)).astype(np.float32)
    want = JD.optax_sigmoid_ce(jnp.asarray(logits), jnp.asarray(labels))
    got = TD.optax_sigmoid_ce(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------------- specs --

@pytest.mark.parametrize("family,name", [
    ("resnet", "resnet50"), ("resnet", "tiny"), ("ssd", "ssd_resnet34"),
    ("ssd", "tiny"), ("maskrcnn", "maskrcnn_resnet50"),
    ("maskrcnn", "tiny")])
def test_specs_count_the_jax_flops_per_image(family, name):
    JMod, TMod = {"resnet": (JR, TR), "ssd": (JS, TS),
                  "maskrcnn": (JM, TM)}[family]
    jspec = getattr(JTR, f"{family}_spec")(JMod.config(name))
    tspec = getattr(TTR, f"{family}_spec")(TMod.config(name))
    assert tspec.flops_per_token == jspec.flops_per_token
    params = tspec.init(torch.Generator().manual_seed(0),
                        torch.device("meta"))
    want = jax.eval_shape(lambda: jspec.init(jax.random.PRNGKey(0)))
    # the same leaves (the two flatten dicts in other orders)
    assert sorted(tuple(p.shape) for p in tree_leaves(params)) == \
        sorted(w.shape for w in jax.tree.leaves(want))
