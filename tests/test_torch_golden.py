"""The JAX golden keep lists that `chip_smoke.py` holds the NMS kernel to.

`tests/torch_golden/nms_<case>.npz` holds, for each kernel_det NMS case, its
numpy seed, its shape and the JAX `nms_reference` keep list.  Regenerated
here by `tools/export_torch_golden.py`, they must equal the committed files,
and the port's plain NMS must equal them on the inputs rebuilt from the
seed, as the kernel must on the card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cloudtik_tpu_torch.ops import detection as TD

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import export_torch_golden  # noqa: E402

# one intra-op thread, as the port's other tests
torch.set_num_threads(1)


def test_every_nms_case_has_a_committed_golden():
    names = sorted(p.name for p in chip_smoke.GOLDEN_DIR.glob("nms_*.npz"))
    assert names == sorted(f"nms_{c.name}.npz"
                           for c in chip_smoke.NMS_CASES)
    for c in chip_smoke.NMS_CASES:
        keep = chip_smoke.golden_keep(c)
        assert keep is not None and keep.shape == (c.B, c.K)
        assert keep.dtype == np.int32


def test_regenerated_goldens_equal_the_committed_ones(tmp_path):
    export_torch_golden.export(tmp_path)
    for c in chip_smoke.NMS_CASES:
        fresh = np.load(tmp_path / f"nms_{c.name}.npz")
        committed = np.load(chip_smoke.GOLDEN_DIR / f"nms_{c.name}.npz")
        assert sorted(fresh.files) == sorted(committed.files) == \
            ["iou_threshold", "keep", "seed", "shape"]
        for key in fresh.files:
            np.testing.assert_array_equal(fresh[key], committed[key],
                                          err_msg=f"{c.name}: {key}")


# kept boxes in all images, where a case pins them
KEPT = {"ssd1200_b8": 800, "many_kept": 2 * 1500}


@pytest.mark.parametrize("case", [c.name for c in chip_smoke.NMS_CASES])
def test_plain_nms_equals_the_golden(case):
    """Every kernel_det NMS case at the size the card runs it: the plain
    keep list equals the committed JAX golden and what the case states
    (nan_box keeps [1, 0, -1], signed_zero [0, -1, -1], nan_score's clean
    image keeps boxes)."""
    c = next(c for c in chip_smoke.NMS_CASES if c.name == case)
    boxes, scores = chip_smoke.make_nms_inputs(c, "cpu")
    keep = TD.nms_batched(boxes, scores, iou_threshold=c.iou_threshold,
                          max_output=c.K).numpy()
    np.testing.assert_array_equal(keep, chip_smoke.golden_keep(c))
    chip_smoke.check_nms_case(c, keep, scores.numpy())
    if case in KEPT:
        # many_kept: 1,500 kept an image, past the kernel's first band
        assert int((keep >= 0).sum()) == KEPT[case]


def test_nms_arrays_are_the_same_bits_from_the_same_seed():
    c = next(c for c in chip_smoke.NMS_CASES if c.name == "signed_zero")
    (b1, s1), (b2, s2) = (chip_smoke.make_nms_arrays(c) for _ in range(2))
    assert b1.tobytes() == b2.tobytes() and s1.tobytes() == s2.tobytes()
    # both signs of zero are there, and image 0 starts as stated
    assert (s1.view(np.uint32) == 0x80000000).any() and (s1 == 0).any()
    assert s1[0, :3].view(np.uint32).tolist() == [0x80000000, 0, 0]
