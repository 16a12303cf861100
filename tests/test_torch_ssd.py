"""Port parity: cloudtik_tpu_torch.models.ssd vs the JAX SSD.

`tiny` in f32, parameters from the JAX `init_params` through `convert.py`,
images from a numpy seed.  The pre-NMS tensors (class logits, box deltas)
agree within 1e-4; the NMS keep indices and the labels are equal; boxes and
scores agree within 1e-5.  The JAX `detect` calls `nms_reference`, the port
its own NMS (the plain version on the CPU); both are `_nms_select_rows`.

A keep list is only comparable exactly where no choice sits within the
frameworks' f32 difference of a tie.  If every score moves by at most d
between the two, a greedy choice whose winner leads the runner-up by more
than 2d is the same in both, and likewise an IoU more than 2d' from the
threshold.  `greedy_margins` measures those leads on the JAX side, and the
tests assert them against the differences they measure first, so that a
near-tie at a new seed shows as a failed precondition, not as a mystery.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import ssd as JS
from cloudtik_tpu.ops import detection as JD
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import ssd as TS

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

PRE_NMS_TOL = 1e-4
OUT_TOL = 1e-5
_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def greedy_margins(boxes, scores, iou_threshold, k):
    """Greedy NMS in float64 on one image's NMS inputs (scores already
    thresholded): the smallest lead of a winner over the best live score
    that is not its exact tie, and the smallest distance of an IoU with a
    winner from the threshold."""
    live = np.asarray(scores, np.float64)
    iou = np.asarray(JD.box_iou(jnp.asarray(boxes, jnp.float32),
                                jnp.asarray(boxes, jnp.float32)), np.float64)
    gap = margin = np.inf
    alive = np.ones(len(live), bool)
    for _ in range(k):
        if not alive.any():
            break
        m = live[alive].max()
        best = np.flatnonzero(alive & (live == m))[0]
        rest = live[alive & (live != m)]
        if rest.size:
            gap = min(gap, m - rest.max())
        margin = min(margin, np.abs(iou[best, alive] - iou_threshold).min())
        alive &= ~(iou[best] > iou_threshold)
        alive[best] = False
    return gap, margin


def assert_nms_comparable(jax_boxes, jax_scores, boxes, scores,
                          iou_threshold, k):
    """The precondition above, per image: JAX's greedy leads exceed twice
    the measured score and IoU differences (plus an f32 ulp for the IoU,
    which the two compute in another order)."""
    for b in range(len(jax_boxes)):
        d_score = np.abs(scores[b] - jax_scores[b]).max()
        d_iou = np.abs(
            np.asarray(JD.box_iou(jnp.asarray(boxes[b]),
                                  jnp.asarray(boxes[b])))
            - np.asarray(JD.box_iou(jnp.asarray(jax_boxes[b]),
                                    jnp.asarray(jax_boxes[b])))).max()
        gap, margin = greedy_margins(jax_boxes[b], jax_scores[b],
                                     iou_threshold, k)
        assert gap > 2 * d_score and margin > 2 * d_iou + 1e-7, \
            (b, gap, d_score, margin, d_iou)


@pytest.mark.parametrize("name", sorted(JS.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JS.PRESETS[name], TS.PRESETS[name]
    for field in dataclasses.fields(JS.SSDConfig):
        want = getattr(jcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert getattr(tcfg, field.name) == want, field.name
    assert tcfg.feature_sizes() == jcfg.feature_sizes()
    assert tcfg.num_anchors() == jcfg.num_anchors()
    np.testing.assert_array_equal(TS.anchors(tcfg),
                                  np.asarray(JS.anchors(jcfg)))


def test_ssd_resnet34_is_the_large_nms_shape():
    cfg = TS.config("ssd_resnet34")
    assert cfg.feature_sizes() == [19, 10, 5, 3, 2, 1]
    assert cfg.num_anchors() == 3000


def test_box_coding_matches_jax():
    jcfg = JS.config("tiny")
    rng = np.random.default_rng(4)
    anchors = np.array(JS.anchors(jcfg))
    deltas = rng.normal(size=(2,) + anchors.shape).astype(np.float32)
    want = JS.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors), jcfg)
    got = TS.decode_boxes(torch.from_numpy(deltas),
                          torch.from_numpy(anchors), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    gt = np.abs(rng.normal(size=anchors.shape)).astype(np.float32) + 0.1
    want = JS.encode_boxes(jnp.asarray(gt), jnp.asarray(anchors), jcfg)
    got = TS.encode_boxes(torch.from_numpy(gt), torch.from_numpy(anchors),
                          jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    x = rng.normal(size=50).astype(np.float32) * 2
    np.testing.assert_allclose(
        TS._smooth_l1(torch.from_numpy(x)).numpy(),
        np.asarray(JS._smooth_l1(jnp.asarray(x))), rtol=1e-6, atol=0)


def _setup(seed=0, batch=2):
    jcfg = JS.config("tiny", dtype=jnp.float32)
    tcfg = TS.config("tiny", dtype=torch.float32)
    jp = JS.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    images = np.random.default_rng(seed).normal(
        size=(batch, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    return jcfg, tcfg, jp, tp, images


def test_forward_matches_jax():
    jcfg, tcfg, jp, tp, images = _setup()
    want_cls, want_box = JS.forward(jp, jnp.asarray(images), jcfg)
    got_cls, got_box = TS.forward(tp, torch.from_numpy(images), tcfg)
    assert tuple(got_cls.shape) == (2, jcfg.num_anchors(), 5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls),
                               rtol=PRE_NMS_TOL, atol=PRE_NMS_TOL)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box),
                               rtol=PRE_NMS_TOL, atol=PRE_NMS_TOL)


def _jax_candidates(jp, images, jcfg):
    """The JAX `detect`'s pre-NMS boxes and scores (its own functions)."""
    cls_logits, box_deltas = JS.forward(jp, jnp.asarray(images), jcfg)
    probs = jax.nn.softmax(cls_logits, axis=-1)
    scores = probs[..., 1:].max(axis=-1)
    boxes = JS.decode_boxes(box_deltas, JS.anchors(jcfg), jcfg)
    return np.asarray(boxes), np.asarray(scores)


@pytest.mark.parametrize("score_threshold", [0.05, 0.0])
def test_detect_matches_jax(score_threshold):
    jcfg, tcfg, jp, tp, images = _setup()
    kw = dict(score_threshold=score_threshold, iou_threshold=0.5,
              max_detections=100)
    boxes, scores = _jax_candidates(jp, images, jcfg)
    scores = np.where(scores >= score_threshold, scores, 0.0).astype(
        np.float32)
    want = JS.detect(jp, jnp.asarray(images), jcfg, **kw)
    got = TS.detect(tp, images, tcfg, device="cpu", **kw)
    assert_nms_comparable(boxes, scores, got["nms_boxes"].numpy(),
                          got["nms_scores"].numpy(), 0.5, 100)
    for b in range(len(images)):
        want_keep = np.asarray(JD.nms_reference(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
            iou_threshold=0.5, max_output=100))
        np.testing.assert_array_equal(got["keep"][b].numpy(), want_keep)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=OUT_TOL, atol=OUT_TOL, err_msg=key)
    # scores below the threshold are exactly 0.0 and stay valid for NMS
    assert ((got["nms_scores"] == 0) == (scores == 0)).all()


def test_detect_defaults_to_the_card_and_takes_numpy():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, tcfg, _, tp, images = _setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.detect(tp, images, tcfg)
