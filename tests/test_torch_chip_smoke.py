"""`chip_smoke.py` rehearsed on the CPU: its serve and forward phases run
end to end at `tiny` size on the plain kernel versions, its bound
arithmetic is pinned, and without a card it fails and prints no result."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from cloudtik_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_without_a_card_it_fails_and_prints_no_result(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_serve_phase_rehearsal():
    out = chip_smoke.phase_serve("tiny", "cpu")
    assert out["greedy_b1"]["equals_direct_generate"]
    assert out["greedy_b2"]["equals_direct_generate"]
    assert out["topk_seeded"]["repeatable"]
    assert out["error_paths"] == {"bad_request": [400, 400, 400],
                                  "not_found": 404, "draining": 503}


def test_forward_main_rehearsal_takes_no_kernel_on_cpu():
    before = FA.LAUNCHES
    cfg, _, tokens, logits = chip_smoke.forward_main("tiny", 2, 16, "cpu")
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    assert tuple(tokens.shape) == (2, 16)
    assert FA.LAUNCHES == before


def test_attention_bound_at_the_main_shape():
    main = chip_smoke.ATTN_CASES[0]
    assert (main.B, main.H, main.S, main.D, main.causal) == \
        (4, 16, 2048, 128, True)
    bound_ms, bound_by, flops, nbytes = chip_smoke.attention_bound(main)
    assert flops == 4 * 4 * 16 * (2048 * 2049 // 2) * 128  # 68.75 GFLOP
    assert nbytes == 2 * 4 * 4 * 16 * 2048 * 128 + 4 * 4 * 16 * 2048
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(flops / 989e12 * 1e3)
    ragged = next(c for c in chip_smoke.ATTN_CASES
                  if c.name == "ragged_causal")
    assert chip_smoke.attention_bound(ragged)[1] == "bytes"
