#!/usr/bin/env python3
"""JAX golden keep lists for the PyTorch port's NMS cases.

    python3 tools/export_torch_golden.py [--out tests/torch_golden]

For every NMS case of `chip_smoke.py`'s kernel_det phase, rebuilds the
case's boxes and scores from its numpy seed (`chip_smoke.make_nms_arrays`),
runs the JAX package's `nms_reference` on each image on the CPU, and writes
`nms_<case>.npz`: the seed, the shape [B, N, K], the IoU threshold and the
keep list [B, K] int32, with no box data.  `chip_smoke.py` rebuilds the same
inputs on the card and requires the kernel's keep list to equal this one.
Run it after changing a case; `tests/test_torch_golden.py` fails until the
committed files match.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def golden(c: chip_smoke.NmsCase) -> dict:
    """The arrays of one case's golden file."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cloudtik_tpu.ops import detection as JD

    boxes, scores = chip_smoke.make_nms_arrays(c)
    nms = jax.jit(functools.partial(JD.nms_reference,
                                    iou_threshold=c.iou_threshold,
                                    max_output=c.K))
    keep = np.stack([np.asarray(nms(jnp.asarray(boxes[b]),
                                    jnp.asarray(scores[b])))
                     for b in range(c.B)]).astype(np.int32)
    return {"seed": np.int64(c.seed),
            "shape": np.asarray([c.B, c.N, c.K], np.int64),
            "iou_threshold": np.float64(c.iou_threshold),
            "keep": keep}


def export(out_dir: Path, cases=chip_smoke.NMS_CASES) -> list:
    """Write one `nms_<case>.npz` per case into out_dir; returns the paths."""
    import numpy as np

    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for c in cases:
        path = out_dir / f"nms_{c.name}.npz"
        np.savez(path, **golden(c))
        paths.append(path)
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=chip_smoke.GOLDEN_DIR)
    args = p.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    for path in export(args.out):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
