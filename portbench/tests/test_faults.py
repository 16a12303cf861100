"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a tiny size (the look
for a card skipped) with one fault planted in the program: a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest; a token or an answer altered where it is produced.  (No
cell runs on more than one chip, so no exchange between chips can be
left out.)
"""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

TRAIN = tiny.cells("train")
SERVE = tiny.cells("serve")


def _correct(ctx):
    out = harness.drive(ctx)
    return out["failed"] == 0 and all(harness.passes(c)
                                      for c in out["checks"]), out


@pytest.mark.parametrize("name", TRAIN)
def test_train_state_unchanged(name, monkeypatch):
    from cloudtik_tpu_torch.train import trainer as TRN

    def step(self, batch):
        grads, metrics = self._grads(batch)
        return {**metrics, "grad_norm": torch.zeros(())}
    monkeypatch.setattr(TRN.Trainer, "train_step", step)
    ok, out = _correct(tiny.context(name))
    assert not ok, out["checks"]


def _patch_loss(monkeypatch, wrap):
    """The model's loss, as the plain and the adapter specs call it."""
    from cloudtik_tpu_torch.models import lora as LO
    from cloudtik_tpu_torch.models import transformer as T
    patched = wrap(T.loss_fn)
    monkeypatch.setattr(T, "loss_fn", patched)
    monkeypatch.setattr(LO, "base_loss_fn", patched)


@pytest.mark.parametrize("name", TRAIN)
def test_train_half_batch(name, monkeypatch):
    def wrap(real):
        def half(params, batch, cfg):
            n = batch["tokens"].shape[0] // 2
            return real(params, {k: v[:n] for k, v in batch.items()}, cfg)
        return half
    _patch_loss(monkeypatch, wrap)
    ok, out = _correct(tiny.context(name))
    assert not ok, out["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_answer_altered(name, monkeypatch):
    def wrap(real):
        def shifted(params, batch, cfg):
            return real(params, {"tokens": batch["tokens"],
                                 "labels": torch.roll(batch["labels"], 1,
                                                      1)}, cfg)
        return shifted
    _patch_loss(monkeypatch, wrap)
    ok, out = _correct(tiny.context(name))
    assert not ok, out["checks"]


def _patch_decode(monkeypatch, wrap):
    from cloudtik_tpu_torch.serve import engine as E
    monkeypatch.setattr(E, "decode_step", wrap(E.decode_step))


@pytest.mark.parametrize("name", SERVE)
def test_serve_state_unchanged(name, monkeypatch):
    def wrap(real):
        def step(params, tokens, kp, vp, *a, **k):
            nxt, _, _, lengths = real(params, tokens, kp.clone(),
                                      vp.clone(), *a, **k)
            return nxt, kp, vp, lengths
        return step
    _patch_decode(monkeypatch, wrap)
    ok, out = _correct(tiny.context(name))
    assert not ok, out["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_half_batch(name, monkeypatch):
    def wrap(real):
        def step(params, tokens, kp, vp, tables, lengths, active, *a, **k):
            active = active.clone()
            active[active.shape[0] // 2:] = False
            return real(params, tokens, kp, vp, tables, lengths, active,
                        *a, **k)
        return step
    _patch_decode(monkeypatch, wrap)
    # enough load that every lane is taken
    mix = dict(tiny.cell(name)["mix"], rate_per_s=40.0, clients=16)
    ok, out = _correct(tiny.context(name, drain_s=3, mix=mix,
                                    check={"sample_tokens": 10 ** 6}))
    assert not ok, (out["failed"], out["checks"])


@pytest.mark.parametrize("name", SERVE)
def test_serve_token_altered(name, monkeypatch):
    def wrap(real):
        def step(*a, **k):
            nxt, kp, vp, lengths = real(*a, **k)
            nxt = nxt.clone()
            nxt[0] = (nxt[0] + 1) % tiny.TINY["vocab_size"]
            return nxt, kp, vp, lengths
        return step
    _patch_decode(monkeypatch, wrap)
    ok, out = _correct(tiny.context(name))
    assert not ok, out["checks"]
