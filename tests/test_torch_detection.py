"""Port parity: cloudtik_tpu_torch.ops.detection vs the JAX detection ops.

The port's NMS on a CPU tensor (its plain version, the semantics of
`csrc/nms.cu`) must equal the Pallas NMS in interpret mode and
`nms_reference` exactly: same keep indices, in the same order, -1-padded.
Its ROIAlign on a CPU tensor (the plain gather form) must match the Pallas
ROIAlign in interpret mode and `roi_align_reference` within 1e-5: all f32,
only the order of the sums differs.  Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.ops import detection as JD
from cloudtik_tpu_torch.ops import detection as TD

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

ROI_TOL = 1e-5


def _random_boxes(n, size=100.0, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return boxes, scores


def _jax_keeps(boxes, scores, thr, k):
    jb, js = jnp.asarray(boxes), jnp.asarray(scores)
    return (np.asarray(JD.nms(jb, js, iou_threshold=thr, max_output=k,
                              interpret=True)),
            np.asarray(JD.nms_reference(jb, js, iou_threshold=thr,
                                        max_output=k)))


def _hand_case(name):
    if name == "overlap_and_separate":
        return ([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                [0.9, 0.8, 0.7])
    return [[0, 0, 10, 10], [5, 0, 15, 10]], [0.9, 0.8]   # IoU 1/3


@pytest.mark.parametrize("case,thr,k", [
    ("overlap_and_separate", 0.5, 3), ("third_overlap", 0.5, 2),
    ("third_overlap", 0.2, 2), ("third_overlap", 0.3, 2)])
def test_nms_hand_cases(case, thr, k):
    boxes, scores = _hand_case(case)
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    got = TD.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                 iou_threshold=thr, max_output=k)
    assert got.dtype == torch.int32
    for want in _jax_keeps(boxes, scores, thr, k):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,thr,k", [(64, 0.5, 32), (64, 0.3, 64),
                                     (200, 0.3, 32), (200, 0.5, 100)])
def test_nms_random_matches_jax_exactly(n, thr, k):
    boxes, scores = _random_boxes(n, seed=n)
    got = TD.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                 iou_threshold=thr, max_output=k).numpy()
    for want in _jax_keeps(boxes, scores, thr, k):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_nms_all_zero_scores_fill_by_index(thr):
    """Thresholded-away scores are exactly 0.0 in both `detect`s: they stay
    valid and are taken in index order among their ties."""
    boxes, _ = _random_boxes(40, seed=5)
    scores = np.zeros(40, np.float32)
    got = TD.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                 iou_threshold=thr, max_output=20).numpy()
    assert got[0] == 0 and (got >= 0).sum() > 1
    for want in _jax_keeps(boxes, scores, thr, 20):
        np.testing.assert_array_equal(got, want)


def test_nms_fewer_boxes_than_outputs_pads_with_minus_one():
    boxes, scores = _random_boxes(6, seed=9)
    got = TD.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                 iou_threshold=0.5, max_output=10).numpy()
    assert (got[6:] == -1).all()
    for want in _jax_keeps(boxes, scores, 0.5, 10):
        np.testing.assert_array_equal(got, want)


def test_nms_degenerate_boxes():
    """Zero-area and inverted boxes: the union floor of 1e-9 and the
    clipped intersection decide, as in JAX."""
    boxes = np.asarray([[5, 5, 5, 5], [5, 5, 5, 5], [0, 0, 10, 10],
                        [3, 3, 1, 1], [0, 0, 10, 10], [2, 2, 2, 9]],
                       np.float32)
    scores = np.asarray([0.5, 0.5, 0.9, 0.7, 0.9, 0.1], np.float32)
    got = TD.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                 iou_threshold=0.5, max_output=6).numpy()
    for want in _jax_keeps(boxes, scores, 0.5, 6):
        np.testing.assert_array_equal(got, want)


def test_nms_batched_is_the_per_image_nms():
    per = [_random_boxes(50, seed=s) for s in (1, 2, 3)]
    boxes = torch.from_numpy(np.stack([b for b, _ in per]))
    scores = torch.from_numpy(np.stack([s for _, s in per]))
    got = TD.nms_batched(boxes, scores, iou_threshold=0.4, max_output=16)
    assert got.shape == (3, 16)
    for i, (b, s) in enumerate(per):
        np.testing.assert_array_equal(
            got[i].numpy(), _jax_keeps(b, s, 0.4, 16)[1])


def _edge_case(name):
    """(boxes, scores, iou_threshold, max_output, the keep list where the
    case states it) of the NaN, signed-zero, infinite-score and large-N
    cases: the reference's own semantics, which the kernel's sorted scan
    must keep."""
    rng = np.random.default_rng(17)
    unit = [0, 0, 1, 1]
    if name == "nan_score":      # the max is NaN at every step
        return [unit, [0, 0, 2, 2], [5, 5, 6, 6]], [0.9, np.nan, 0.5], \
            0.5, 3, [-1, -1, -1]
    if name == "nan_box":        # its IoU is NaN: it suppresses nothing
        return [unit, [np.nan, 0, 1, 1], unit], [0.5, 0.9, 0.4], 0.5, 3, \
            [1, 0, -1]
    if name == "signed_zero":    # -0.0 == 0.0: tied, the lower index wins
        return [unit, unit, unit], [-0.0, 0.0, 0.0], 0.5, 3, [0, -1, -1]
    if name == "inf_and_absent":
        boxes, _ = _random_boxes(12, seed=4)
        scores = [0.5, np.inf, -np.inf, -1e30, -5e29, -4e29, -6e29, np.inf,
                  0.0, -0.0, -1.0, 0.5]
        return boxes, scores, 0.3, 12, None
    if name == "all_absent":
        boxes, _ = _random_boxes(5, seed=6)
        return boxes, [-np.inf, -1e30, -5e29, -6e29, -np.inf], 0.5, 4, \
            [-1] * 4
    # one SSD-1200 image: 45,384 anchors, most scores thresholded to 0.0
    n = 45_384
    xy = rng.uniform(0, 0.9, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.01, 0.1, (n, 2))], 1)
    scores = np.where(rng.uniform(size=n) < 0.01, rng.uniform(0.05, 1, n),
                      0.0)
    return boxes, scores, 0.5, 100, None


@pytest.mark.parametrize("name", ["nan_score", "nan_box", "signed_zero",
                                  "inf_and_absent", "all_absent",
                                  "ssd1200_image"])
def test_nms_edge_cases_match_jax_exactly(name):
    """NaN scores and coordinates, -0.0 against +0.0, +-inf and absent
    scores, and one image of 45,384 boxes (no cap on N): the port's NMS
    equals `nms_reference` and the Pallas NMS in interpret mode."""
    boxes, scores, thr, k, stated = _edge_case(name)
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    got = TD.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                 iou_threshold=thr, max_output=k).numpy()
    if stated is not None:
        assert got.tolist() == stated
    for want in _jax_keeps(boxes, scores, thr, k):
        np.testing.assert_array_equal(got, want)
    if name == "ssd1200_image":
        assert (got >= 0).all() and (scores[got[:5]] > 0).all()


def test_nms_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        TD.nms(torch.zeros(4, 4), torch.zeros(3))


def _roi_inputs():
    rng = np.random.default_rng(7)
    features = rng.normal(size=(8, 16, 24)).astype(np.float32)
    rois = np.asarray([[2.0, 3.0, 40.0, 30.0],
                       [0.0, 0.0, 10.0, 60.0],
                       [5.5, 1.5, 22.5, 14.0],
                       [-6.0, 12.0, 30.0, 19.0]], np.float32)
    return features, rois


@pytest.mark.parametrize("pooled,sampling,scale", [
    (7, 2, 1.0), (7, 2, 0.25), (14, 1, 0.5)])
def test_roi_align_matches_jax(pooled, sampling, scale):
    features, rois = _roi_inputs()
    kw = dict(pooled_size=pooled, sampling_ratio=sampling,
              spatial_scale=scale)
    got = TD.roi_align(torch.from_numpy(features), torch.from_numpy(rois),
                       **kw)
    assert got.shape == (4, 8, pooled, pooled) and got.dtype == torch.float32
    jf, jr = jnp.asarray(features), jnp.asarray(rois)
    for want in (JD.roi_align(jf, jr, implementation="pallas",
                              interpret=True, **kw),
                 JD.roi_align_reference(jf, jr, **kw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ROI_TOL, atol=ROI_TOL)


def test_roi_align_tiny_roi_clamped_to_min_size():
    rng = np.random.default_rng(3)
    features = rng.normal(size=(2, 8, 8)).astype(np.float32)
    rois = np.asarray([[3.0, 3.0, 3.1, 3.1], [7.6, 7.6, 7.7, 7.9]],
                      np.float32)
    got = TD.roi_align(torch.from_numpy(features), torch.from_numpy(rois),
                       pooled_size=2, sampling_ratio=2)
    want = JD.roi_align(jnp.asarray(features), jnp.asarray(rois),
                        pooled_size=2, sampling_ratio=2,
                        implementation="pallas", interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROI_TOL,
                               atol=ROI_TOL)


def test_roi_align_batched_reads_an_nhwc_view():
    """The batched entry takes [B, C, H, W] with any strides: an NHWC map
    permuted in place pools as its contiguous copy does, image by image,
    and more ROIs than one gather chunk come out as one gather of all."""
    rng = np.random.default_rng(11)
    nhwc = torch.from_numpy(rng.normal(size=(2, 12, 10, 6))
                            .astype(np.float32))
    # sorted per row: x1 <= y1 <= x2 <= y2, so x2 >= x1 and y2 >= y1
    rois = torch.from_numpy(rng.uniform(0, 10, (2, TD._ROI_CHUNK + 8, 4))
                            .astype(np.float32)).sort(dim=-1).values
    view = nhwc.permute(0, 3, 1, 2)
    got = TD.roi_align_batched(view, rois, pooled_size=3, sampling_ratio=2)
    for b in range(2):
        want = TD._roi_align_image(view[b].contiguous(), rois[b], 3, 2, 1.0)
        torch.testing.assert_close(got[b], want, rtol=0, atol=0)


def test_box_iou_matches_jax():
    a, _ = _random_boxes(9, seed=1)
    b, _ = _random_boxes(7, seed=2)
    got = TD.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JD.box_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _detect_map(C=1024, dtype=torch.bfloat16):
    """The detect path's layout: an NHWC map permuted to [B, C, H, W]."""
    return torch.zeros(2, 8, 8, C, dtype=dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("pooled", [7, 14])
def test_roi_align_route_is_vector_on_the_detect_layout(pooled):
    feats = _detect_map()
    assert feats.data_ptr() % 16 == 0 and feats.stride(1) == 1
    assert TD.roi_align_route(feats, pooled, 1) == "vector"


@pytest.mark.parametrize("case", ["f32", "nchw", "c_not_multiple_of_8",
                                  "unaligned_base", "c100_nhwc"])
def test_roi_align_route_is_strided_off_the_vector_layout(case):
    """f32, an NCHW map, a 60-channel slice (aligned strides, C % 8 != 0),
    a view one channel in (base 2 bytes off 16) and a 100-channel NHWC map
    (200-byte pixels) take the strided route."""
    feats = {
        "f32": lambda: _detect_map(64, torch.float32),
        "nchw": lambda: torch.zeros(2, 64, 8, 8, dtype=torch.bfloat16),
        "c_not_multiple_of_8": lambda: _detect_map(64)[:, :60],
        "unaligned_base": lambda: _detect_map(64)[:, 1:9],
        "c100_nhwc": lambda: _detect_map(100),
    }[case]()
    if case == "unaligned_base":
        assert feats.data_ptr() % 16 == 2 and feats.shape[1] == 8
    assert TD.roi_align_route(feats, 14, 1) == "strided"
