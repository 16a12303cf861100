"""Port parity: cloudtik_tpu_torch.models.generate vs the JAX package.

`tiny` in fp32 with parameters from the JAX `init_params`: greedy tokens are
identical, `forward_step` logits agree to atol 1e-4, and the in-place cache
holds the K/V the JAX cache returns.  Sampling draws from torch's generator
(it cannot reproduce jax.random), so top-k is held by its support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import generate as JG
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import transformer as TT

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jnp.float32)
TCFG = TT.config("tiny", dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _prompt(B=2, S=8, seed=0):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, S))


def test_greedy_tokens_match_jax(params):
    jp, tp = params
    prompt = _prompt()
    want = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32), JCFG,
                                  max_new_tokens=12))
    got = TG.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=12)
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_with_eos_matches_jax(params):
    jp, tp = params
    prompt = _prompt(seed=1)
    plain = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32), JCFG,
                                   max_new_tokens=12))
    eos = int(plain[0, 3])         # a token row 0 really emits mid-stream
    want = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32), JCFG,
                                  max_new_tokens=12, eos_id=eos))
    got = TG.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=12,
                      eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 3:] == eos).all()          # padding really happened


def test_forward_step_logits_and_cache_match_jax(params):
    jp, tp = params
    prompt = _prompt(B=2, S=6, seed=2)
    nxt = _prompt(B=2, S=1, seed=3)
    jc = JG.init_cache(JCFG, 2, 10)
    tc = TG.init_cache(TCFG, 2, 10, "cpu")
    for toks in (prompt, nxt):
        jl, jc = JG.forward_step(jp, jnp.asarray(toks, jnp.int32), jc, JCFG)
        tl, tc2 = TG.forward_step(tp, torch.from_numpy(toks), tc, TCFG)
        assert tc2 is tc                       # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    assert tc["length"] == int(jc["length"]) == 7
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, rtol=1e-5)


def test_attend_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    ck = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    want = JG._attend(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), 4,
                      JCFG)
    got = TG._attend(torch.from_numpy(q), torch.from_numpy(ck),
                     torch.from_numpy(cv), 4, TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_top_k_samples_lie_in_the_top_k_set(params):
    _, tp = params
    prompt = torch.from_numpy(_prompt(B=2, S=5, seed=5))
    k, new = 5, 6
    toks = TG.generate(tp, prompt, TCFG, max_new_tokens=new,
                       temperature=0.8, top_k=k,
                       generator=torch.Generator().manual_seed(11))
    # teacher-force the sampled tokens and check each against its logits
    cache = TG.init_cache(TCFG, 2, 5 + new, "cpu")
    logits, _ = TG.forward_step(tp, prompt, cache, TCFG)
    for i in range(new):
        topk = torch.topk(logits[:, -1] / 0.8, k).indices
        assert all(toks[b, i].item() in topk[b].tolist() for b in range(2))
        logits, _ = TG.forward_step(tp, toks[:, i:i + 1], cache, TCFG)


def test_sampling_follows_the_generator(params):
    _, tp = params
    prompt = torch.from_numpy(_prompt(B=1, S=4, seed=6))

    def run(seed):
        return TG.generate(tp, prompt, TCFG, max_new_tokens=8,
                           temperature=1.0, top_k=50,
                           generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(7), run(7))
    assert any(not torch.equal(run(7), run(s)) for s in (8, 9, 10))


def test_sample_greedy_and_top_k_mask():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 0.0, 0.0, 4.0]])
    assert TG._sample(logits, None, 0.0, 0).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        assert TG._sample(logits, gen, 1.0, 1).tolist() == [1, 0]
        s = TG._sample(logits, gen, 1.0, 2).tolist()
        assert s[0] in (1, 3) and s[1] in (0, 3)


def test_generate_rejects_no_new_tokens(params):
    _, tp = params
    with pytest.raises(ValueError, match="max_new_tokens"):
        TG.generate(tp, torch.zeros(1, 2, dtype=torch.long), TCFG,
                    max_new_tokens=0)
