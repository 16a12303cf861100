"""A numpy model of the order `csrc/nms.cu` walks, held to the plain NMS.

The kernel does not run the reference's argmax loop: it scans the
candidates (scores above -5e29) in sorted order, a band at a time, and
resolves each chunk of the band with suppression bitmasks.  This model
takes the same steps with the same integers: the 64-bit order key (the
score's order-preserving bits with -0.0 made +0.0, then the complemented
index), the band as the M largest keys below the last band's lowest, found
by an 8-bit radix select that stops once its bucket is taken whole, and a
chunk resolved from the IoUs against the boxes kept so far and, for each
candidate, the earlier candidates of the chunk that would suppress it, in
rounds (kept once none of those is undecided or kept, dropped once one is
kept).  Hypothesis holds it to `nms_reference_batched` on
ties, zero tiers, signed zeros, infinities, NaN, fewer boxes than outputs
and bands and chunks of a few candidates, so an order bug shows here before
the kernel runs on a card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from cloudtik_tpu_torch.ops import detection as TD

# one intra-op thread, as the port's other tests
torch.set_num_threads(1)

# csrc/nms.cu's kFirstBand, kBand and kChunk
KERNEL_FIRST_BAND, KERNEL_BAND, KERNEL_CHUNK = 512, 2048, 64
_VALID_ABOVE = np.float32(-5e29)
_ALL = np.uint64(0xFFFFFFFFFFFFFFFF)


def order_keys(scores: np.ndarray) -> np.ndarray:
    """uint64 key per box, larger first: score descending, index ascending;
    -0.0 ties +0.0."""
    u = scores.astype(np.float32).view(np.uint32).copy()
    u[u == np.uint32(0x80000000)] = 0
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    index = ~np.arange(len(scores), dtype=np.uint32)
    return (key.astype(np.uint64) << np.uint64(32)) | index.astype(np.uint64)


def band_cut(keys: np.ndarray, eligible: np.ndarray, band: int):
    """(size, lowest): the band is the eligible keys >= lowest, at most
    `band` of them, found digit by digit from the top as the kernel does."""
    prefix, pmask, rank = np.uint64(0), np.uint64(0), band
    for shift in range(56, -1, -8):
        sh = np.uint64(shift)
        sub = keys[eligible & ((keys & pmask) == prefix)]
        hist = np.bincount(((sub >> sh) & np.uint64(0xFF)).astype(np.int64),
                           minlength=256)
        if shift == 56 and hist.sum() <= band:
            return int(hist.sum()), np.uint64(0)
        from_top = np.cumsum(hist[::-1])
        digit = 255 - int(np.argmax(from_top >= rank))
        rank -= int(from_top[255 - digit] - hist[digit])
        prefix |= np.uint64(digit) << sh
        pmask |= np.uint64(0xFF) << sh
        if hist[digit] == rank:
            return band, prefix
    raise AssertionError("order keys are distinct: the last digit decides")


def iou(w: np.ndarray, c: np.ndarray) -> np.ndarray:
    """IoU of boxes c [..., 4] with boxes w [..., 4] (kept earlier),
    broadcast, f32 op by op in the reference's order; numpy's minimum /
    maximum propagate NaN as XLA's do."""
    w, c = np.moveaxis(w, -1, 0), np.moveaxis(c, -1, 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        area_w = (w[2] - w[0]) * (w[3] - w[1])
        area_c = (c[2] - c[0]) * (c[3] - c[1])
        iw = np.maximum(np.minimum(w[2], c[2]) - np.maximum(w[0], c[0]),
                        np.float32(0))
        ih = np.maximum(np.minimum(w[3], c[3]) - np.maximum(w[1], c[1]),
                        np.float32(0))
        inter = iw * ih
        return inter / np.maximum((area_w + area_c) - inter,
                                  np.float32(1e-9))


def nms_sorted_scan(boxes: np.ndarray, scores: np.ndarray, thr: float,
                    k: int, band: int = KERNEL_BAND,
                    chunk: int = KERNEL_CHUNK,
                    first_band: int = KERNEL_FIRST_BAND) -> np.ndarray:
    """One image, as csrc/nms.cu computes it: boxes [N, 4] f32, scores [N]
    f32 -> keep [k] int32.  The first band holds `first_band` keys, the
    later ones `band`."""
    boxes = boxes.astype(np.float32)
    thr = np.float32(thr)
    keep = np.full(k, -1, np.int32)
    if np.isnan(scores).any():
        return keep
    keys = order_keys(scores)
    cand = scores.astype(np.float32) > _VALID_ABOVE
    kept = []
    upper = _ALL
    band, later = first_band, band
    while len(kept) < k:
        eligible = cand & (keys < upper)
        size, lowest = band_cut(keys, eligible, band)
        members = np.sort(keys[eligible & (keys >= lowest)])[::-1]
        assert len(members) == size
        if size == 0:
            break
        for p in range(0, size, chunk):
            if len(kept) >= k:
                break
            idx = (~members[p:p + chunk].astype(np.uint32)).astype(np.int64)
            cb = boxes[idx]
            n = len(idx)
            # (a) against every box kept so far; (b) cols[c, i], i < c:
            # earlier candidate i suppresses c if kept
            undecided = ~(iou(boxes[kept][:, None], cb[None]) > thr).any(0)
            cols = (iou(cb[None, :], cb[:, None]) > thr) \
                & np.tril(np.ones((n, n), bool), -1)
            # (c) rounds: kept once no suppressor is undecided or kept,
            # dropped once one is kept
            taken = np.zeros(n, bool)
            while undecided.any():
                now = undecided & ~(cols & (taken | undecided)).any(1)
                gone = undecided & (cols & taken).any(1)
                taken |= now
                undecided &= ~(now | gone)
            kept += idx[np.nonzero(taken)[0][:k - len(kept)]].tolist()
        if size < band:
            break
        upper = members[-1]
        band = later
    keep[:len(kept)] = kept
    return keep


def _plain(boxes, scores, thr, k):
    return TD.nms_reference_batched(
        torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
        iou_threshold=thr, max_output=k)[0].numpy()


def test_order_keys_sort_as_the_argmax_takes_them():
    """+inf first, then descending scores, -0.0 tied with +0.0 by index,
    absent scores last."""
    scores = np.asarray([0.0, -0.0, np.inf, 0.5, -0.0, -np.inf, -1e30, 1.0,
                         -2.0], np.float32)
    order = np.argsort(order_keys(scores))[::-1]
    assert order.tolist() == [2, 7, 3, 0, 1, 4, 8, 6, 5]


def test_band_cut_breaks_ties_at_its_cutoff_by_index():
    scores = np.zeros(1000, np.float32)
    scores[[10, 700]] = 1.0
    keys = order_keys(scores)
    size, lowest = band_cut(keys, np.ones(1000, bool), 8)
    members = np.sort(keys[keys >= lowest])[::-1]
    assert size == 8
    assert (~members.astype(np.uint32)).tolist() == [10, 700, 0, 1, 2, 3, 4,
                                                      5]


_SCORES = st.one_of(
    st.sampled_from([0.0, -0.0, 0.25, 0.5, 0.5, 1.0, np.inf, -np.inf, np.nan,
                     -1e30, -5e29, -4e29, -6e29, -1.0]),
    st.floats(-2.0, 2.0, width=32))
_COORD = st.one_of(st.integers(0, 4).map(float),
                   st.sampled_from([0.5, np.nan, np.inf, -np.inf]))


@settings(max_examples=300, deadline=None)
@given(data=st.data(), n=st.integers(1, 24), k=st.integers(1, 12),
       thr=st.sampled_from([0.0, 0.3, 1 / 3, 0.5, 0.7]),
       band=st.integers(1, 9), first_band=st.integers(1, 9),
       chunk=st.integers(1, 5))
def test_sorted_scan_equals_the_plain_nms(data, n, k, thr, band, first_band,
                                          chunk):
    rare_nan = data.draw(st.booleans())
    scores = np.asarray(data.draw(st.lists(
        _SCORES.filter(lambda s: rare_nan or not np.isnan(s)),
        min_size=n, max_size=n)), np.float32)
    xy = np.asarray(data.draw(st.lists(_COORD, min_size=2 * n,
                                       max_size=2 * n)), np.float32)
    wh = np.asarray(data.draw(st.lists(st.integers(0, 3), min_size=2 * n,
                                       max_size=2 * n)), np.float32)
    boxes = np.concatenate([xy.reshape(n, 2), (xy + wh).reshape(n, 2)], 1)
    want = _plain(boxes, scores, thr, k)
    got = nms_sorted_scan(boxes, scores, thr, k, band=band, chunk=chunk,
                          first_band=first_band)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["one_box_many_bands", "zero_tier"])
def test_sorted_scan_at_the_kernel_band_and_chunk(case):
    """At the kernel's own sizes: 5,000 copies of one box need four bands
    (512, then 2,048 each) to find there is nothing more to keep; a zero tier of 3,000 below a few
    scored boxes is taken by index."""
    rng = np.random.default_rng(3)
    n = 5000 if case == "one_box_many_bands" else 3000
    if case == "one_box_many_bands":
        boxes = np.tile(np.asarray([[0.1, 0.1, 0.4, 0.4]], np.float32),
                        (n, 1))
        boxes[-1] = [0.6, 0.6, 0.9, 0.9]       # the last band's last box
        scores = np.zeros(n, np.float32)
        scores[17] = 0.5
    else:
        xy = rng.random((n, 2), dtype=np.float32) * np.float32(0.8)
        wh = rng.random((n, 2), dtype=np.float32) * np.float32(0.1)
        boxes = np.concatenate([xy, xy + wh], 1)
        scores = np.where(rng.random(n) < 0.02,
                          rng.random(n, dtype=np.float32), np.float32(0))
    want = _plain(boxes, scores, 0.5, 100)
    got = nms_sorted_scan(boxes, scores, 0.5, 100)
    np.testing.assert_array_equal(got, want)
    if case == "one_box_many_bands":
        assert got[:2].tolist() == [17, n - 1] and (got[2:] == -1).all()


@pytest.mark.parametrize("case", [c.name for c in chip_smoke.NMS_CASES])
def test_sorted_scan_equals_the_jax_golden(case):
    """The model at the kernel's sizes on every kernel_det case of
    `chip_smoke.py`, inputs rebuilt from the case's seed, against the JAX
    `nms_reference` keep list committed for it."""
    c = next(c for c in chip_smoke.NMS_CASES if c.name == case)
    boxes, scores = chip_smoke.make_nms_arrays(c)
    got = np.stack([nms_sorted_scan(boxes[b], scores[b], c.iou_threshold,
                                    c.K) for b in range(c.B)])
    np.testing.assert_array_equal(got, chip_smoke.golden_keep(c))
