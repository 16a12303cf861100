"""Port parity: cloudtik_tpu_torch.models.maskrcnn vs the JAX Mask R-CNN.

`tiny` in f32, parameters from the JAX `init_params` through `convert.py`,
images from a numpy seed.  The RPN outputs, proposals, ROI-head outputs and
mask logits agree within 1e-4; the NMS keep indices and labels are equal;
boxes and scores agree within 1e-5.  The JAX proposals are also fed to the
port's `roi_heads`, so that a `top_k` near-tie cannot hide a ROIAlign
fault, and the objectness gap around the K-th proposal is asserted first:
a flip at a new seed shows as a failed precondition.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import maskrcnn as JM
from cloudtik_tpu.models import ssd as JS
from cloudtik_tpu.ops import detection as JD
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import maskrcnn as TM
from tests.test_torch_ssd import assert_nms_comparable

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

TOL = 1e-4
OUT_TOL = 1e-5
_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("name", sorted(JM.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JM.PRESETS[name], TM.PRESETS[name]
    for field in dataclasses.fields(JM.MaskRCNNConfig):
        want = getattr(jcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert getattr(tcfg, field.name) == want, field.name
    assert tcfg.feature_size() == jcfg.feature_size()
    assert tcfg.feature_width() == jcfg.feature_width()
    np.testing.assert_array_equal(TM.anchors(tcfg),
                                  np.asarray(JM.anchors(jcfg)))


def test_maskrcnn_resnet50_shapes():
    cfg = TM.config("maskrcnn_resnet50")
    assert (cfg.feature_size(), cfg.feature_width()) == (32, 1024)
    assert TM.anchors(cfg).shape == (9216, 4)


def test_init_params_has_the_jax_tree():
    jcfg = JM.config("tiny")
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = TM.init_params(torch.Generator().manual_seed(0),
                         TM.config("tiny"), "cpu")
    is_t = lambda x: isinstance(x, torch.Tensor)   # noqa: E731
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got, is_leaf=is_t)) \
        == jax.tree.structure(jax.tree.map(lambda t: 0, want))
    for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(got,
                                                           is_leaf=is_t)):
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32


def _setup(seed=0, batch=2):
    jcfg = JM.config("tiny", dtype=jnp.float32)
    tcfg = TM.config("tiny", dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    images = np.random.default_rng(seed).normal(
        size=(batch, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    return jcfg, tcfg, jp, tp, images


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=msg)


def test_stages_match_jax():
    jcfg, tcfg, jp, tp, images = _setup()
    jfeat = JM.backbone_feature(jp, jnp.asarray(images), jcfg)
    feat = TM.backbone_feature(tp, torch.from_numpy(images), tcfg)
    _close(feat, jfeat, msg="feature")

    jobj, jdel = JM.rpn_forward(jp, jfeat, jcfg)
    obj, deltas = TM.rpn_forward(tp, feat, tcfg)
    _close(obj, jobj, msg="objectness")
    _close(deltas, jdel, msg="rpn deltas")

    # precondition: the top-K set and its order are well separated
    k = jcfg.num_proposals
    top = -np.sort(-np.asarray(jobj), axis=1)[:, :k + 1]
    gap = np.diff(-top, axis=1).min()
    assert gap > 2 * np.abs(obj.numpy() - np.asarray(jobj)).max(), gap

    janchors = JM.anchors(jcfg)
    jprops, jpscores = JM.propose(jobj, jdel, janchors, jcfg)
    props, pscores = TM.propose(obj, deltas, torch.from_numpy(
        np.array(janchors)), tcfg)
    _close(props, jprops, msg="proposals")
    _close(pscores, jpscores, msg="proposal scores")

    want = JM.roi_heads(jp, jfeat, jprops, jcfg)
    for name, g, w in zip(("cls", "box", "mask"),
                          TM.roi_heads(tp, feat, props, tcfg), want):
        _close(g, w, msg=name)
    # the JAX proposals through the port's heads
    got = TM.roi_heads(tp, torch.from_numpy(np.array(jfeat)),
                       torch.from_numpy(np.array(jprops)), tcfg)
    for name, g, w in zip(("cls", "box", "mask"), got, want):
        _close(g, w, msg=f"{name} on the JAX proposals")


def _jax_candidates(jp, images, jcfg):
    """The JAX `detect`'s pre-NMS boxes and scores (its own functions)."""
    feat = JM.backbone_feature(jp, jnp.asarray(images), jcfg)
    obj, deltas = JM.rpn_forward(jp, feat, jcfg)
    proposals, _ = JM.propose(obj, deltas, JM.anchors(jcfg), jcfg)
    cls_logits, box_deltas, _ = JM.roi_heads(jp, feat, proposals, jcfg)
    probs = jax.nn.softmax(cls_logits, axis=-1)
    scores = probs[..., 1:].max(axis=-1)
    labels = probs[..., 1:].argmax(axis=-1) + 1
    picked = jnp.take_along_axis(
        box_deltas, labels[..., None, None].repeat(4, axis=-1),
        axis=2)[:, :, 0, :]
    boxes = jax.vmap(lambda d, p: JS.decode_boxes(
        d, JS.xyxy_to_cxcywh(p), jcfg))(picked, proposals)
    return np.asarray(jnp.clip(boxes, 0.0, 1.0)), np.asarray(scores)


@pytest.mark.parametrize("score_threshold", [0.05, 0.0])
def test_detect_matches_jax(score_threshold):
    jcfg, tcfg, jp, tp, images = _setup()
    kw = dict(score_threshold=score_threshold, iou_threshold=0.5,
              max_detections=50)
    boxes, scores = _jax_candidates(jp, images, jcfg)
    scores = np.where(scores >= score_threshold, scores, 0.0).astype(
        np.float32)
    want = JM.detect(jp, jnp.asarray(images), jcfg, **kw)
    got = TM.detect(tp, images, tcfg, device="cpu", **kw)
    assert_nms_comparable(boxes, scores, got["nms_boxes"].numpy(),
                          got["nms_scores"].numpy(), 0.5, 50)
    for b in range(len(images)):
        want_keep = np.asarray(JD.nms_reference(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
            iou_threshold=0.5, max_output=50))
        np.testing.assert_array_equal(got["keep"][b].numpy(), want_keep)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for key in ("boxes", "scores"):
        _close(got[key], want[key], OUT_TOL, key)
    _close(got["mask_logits"], want["mask_logits"], msg="mask_logits")
    assert got["mask_logits"].shape == (2, 16, 7, 7, 5)


def test_detect_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tp, images = _setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.detect(tp, images, tcfg)
