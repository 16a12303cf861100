"""The port's vocab-parallel loss (`models/transformer.py`
`_chunk_stats_split`) over gloo tensor ranks against the JAX package's
cross entropy and accuracy on the whole vocab.

Each rank holds its V/t columns of one chunk's logits; the summed nll,
the valid count, the correct count and the gradient of the logits must be
the reference's (f32, 1e-6 relative; counts exact).  Equal maxima planted
in two shards must give the reference's argmax, the first index over the
whole vocab."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
V = 16
REL = 1e-6


def _inputs():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, V)).astype(np.float32)
    labels = rng.integers(0, V, (2, 5))
    # ties across the shards at t=2 (8 columns a rank) and at t=4
    logits[0, 0, [3, 12]] = 9.0
    labels[0, 0] = 3                 # the first index: correct
    logits[0, 1, [5, 13]] = 9.0
    labels[0, 1] = 13                # the later tied index: not correct
    logits[1, 2, [1, 6, 14]] = 9.0
    labels[1, 2] = 1
    logits[1, 3, [9, 10]] = 9.0      # a tie inside one shard
    labels[1, 3] = 10
    labels[1, 4] = -100
    return logits, labels


def _reference():
    logits, labels = _inputs()

    def nll(lg):
        valid = labels != -100
        safe = jnp.where(valid, labels, 0)
        logp = jax.nn.log_softmax(lg, axis=-1)
        tok = jnp.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
        return -(tok * valid).sum()

    lg = jnp.asarray(logits)
    value, grad = jax.value_and_grad(nll)(lg)
    correct = ((lg.argmax(-1) == labels) & (labels != -100)).sum()
    return (float(value), int((labels != -100).sum()), int(correct),
            np.asarray(grad))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("vocab")
    logits, labels = _inputs()
    cases = [dict(kind="vocab", name=f"tensor{n}", world=n, logits=logits,
                  labels=labels) for n in (2, 4)]
    torch.save({"cases": cases}, out / "cases.pt")
    run_ranks(["tools/torch_parallel_cases.py", str(out / "cases.pt"),
               str(out)], 4, 120, cwd=str(ROOT))
    return {c["name"]: [torch.load(out / f"{c['name']}.rank{r}.pt",
                                   weights_only=False)
                        for r in range(c["world"])] for c in cases}


@pytest.mark.parametrize("name", ["tensor2", "tensor4"])
def test_vocab_parallel_loss_is_the_references(spawned, name):
    nll, valid, correct, grad = _reference()
    for rank in spawned[name]:
        assert abs(float(rank["nll"]) - nll) <= REL * abs(nll)
        assert int(rank["valid"]) == valid
        got = rank["dlogits"].numpy()
        assert np.linalg.norm(got - grad) <= REL * np.linalg.norm(grad)


@pytest.mark.parametrize("name", ["tensor2", "tensor4"])
def test_argmax_ties_take_the_first_index_over_the_vocab(spawned, name):
    _, _, correct, _ = _reference()
    # (0,0) counts only with the first tied index, (0,1) only with a later
    # one: an argmax that took any but the first would move the count
    logits, labels = _inputs()
    assert int(np.argmax(logits[0, 0])) == 3
    assert int(np.argmax(logits[0, 1])) == 5
    for rank in spawned[name]:
        assert int(rank["correct"]) == correct
