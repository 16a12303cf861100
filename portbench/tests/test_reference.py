"""The float32 reference agrees with the program at a tiny size on the
CPU, where both compute in float32: the forward's logits, the first
training steps, and the engine's greedy answers."""

import torch

from portbench import weights
from portbench.reference import serve_check, train_check
from portbench.tests import tiny
from portbench.traffic import train as TR


def _port_cfg(t):
    from cloudtik_tpu_torch.models import transformer as T
    kw = dict(t)
    kw["dtype"] = weights.dtype_of(kw["dtype"])
    kw["param_dtype"] = weights.dtype_of(kw["param_dtype"])
    kw["max_seq_len"] = 64
    return T, T.TransformerConfig(**kw)


def test_forward_logits_agree():
    t = dict(tiny.TINY, dtype="float32")
    T, cfg = _port_cfg(t)
    params = weights.make_params(t, 7, "cpu", torch.float32)
    tokens = torch.tensor([[3, 17, 200, 5, 9, 11, 250, 0, 1, 64]])
    want = T.forward(params, tokens, cfg)[0]
    got = serve_check.teacher_logits(params, t, [tokens[0].tolist()],
                                     [1], device="cpu")[0]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4


def test_training_steps_agree():
    ctx = tiny.context(tiny.cells("train")[0], exact=True)
    out = TR.run(ctx)
    for c in out["checks"]:
        assert c["value"] < 1e-4, c


def test_engine_answers_agree():
    from portbench.traffic import serve as SV
    for name in tiny.cells("serve"):
        res = SV.run(tiny.context(name, exact=True))
        assert res["failed"] == 0
        assert res["checks"][0]["value"] < 1e-4, res["checks"]
        assert res["record"]["gaps"]["tokens"] >= 30


def test_reference_adamw_schedule():
    opt = {"learning_rate": 3e-4, "warmup_steps": 100, "total_steps": 10000,
           "min_lr_ratio": 0.1}
    assert train_check.lr_at(opt, 0) == 0.0
    assert abs(train_check.lr_at(opt, 2) - 6e-6) < 1e-12
    assert abs(train_check.lr_at(opt, 100) - 3e-4) < 1e-12
    assert abs(train_check.lr_at(opt, 10000) - 3e-5) < 1e-12
