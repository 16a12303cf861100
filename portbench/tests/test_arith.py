"""The frozen bound arithmetic reproduces the port's kernel table: B1's
bound 0.0695 ms, B2's 0.2086 and B3's 0.2781 (PERF.md, section 6)."""

import pytest

from portbench.arith import attention, model


def test_b1_bound_at_q_4_16_2048_128():
    b = attention.fwd_bound(4, 16, 16, 2048, 128, causal=True)
    assert b["bound_ms"] == pytest.approx(0.0695, abs=5e-5)
    assert b["bound_by"] == "operations"


def test_b2_b3_bounds_at_q_8_16_2048_128():
    b = attention.bwd_bounds(8, 16, 16, 2048, 128, causal=True)
    assert b["dq"]["bound_ms"] == pytest.approx(0.2086, abs=5e-5)
    assert b["dkv"]["bound_ms"] == pytest.approx(0.2781, abs=5e-5)


def test_gqa_reads_fewer_kv_bytes():
    mha = attention.fwd_bound(2, 32, 32, 4096, 128)
    gqa = attention.fwd_bound(2, 32, 8, 4096, 128)
    assert gqa["flops"] == mha["flops"] and gqa["bytes"] < mha["bytes"]


MISTRAL = {"vocab_size": 32768, "d_model": 4096, "n_layers": 32,
           "n_heads": 32, "n_kv_heads": 8, "d_ff": 14336}


def test_mistral_counts():
    assert model.all_params(MISTRAL) == 7_248_023_552
    l12 = dict(MISTRAL, n_layers=12)
    assert model.all_params(l12) == 2_885_783_552
    assert model.train_flops_per_token(l12, 4096) / 1e9 == \
        pytest.approx(17.72, abs=0.01)
    assert model.kv_bytes_per_token(MISTRAL) == 128 * 1024
