"""Port parity: ring attention over gloo ranks against the JAX ring on the
8-device CPU mesh, and against plain attention.

Every case runs in one spawn (`tools/torch_parallel_cases.py`, no JAX in
the workers): each rank takes its slice of the sequence, the auto rule
picks the ring under the mesh's `seq` axis, and the backward runs the
ring again with the dk/dv accumulators travelling with their blocks.
Ceilings, f32 on one intra-op thread: the output within 1e-5 relative
L2 of JAX's `ring_attention_sharded` and every gradient within 1e-4 of
`jax.grad` of it.  A ring whose backward drops one block must miss them.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cloudtik_tpu.ops.attention import reference_attention
from cloudtik_tpu.ops.ring_attention import ring_attention_sharded
from cloudtik_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REL, GRAD_REL = 1e-5, 1e-4

# name: (world, B, H, Hkv, S, D, causal, fault)
CASES = {
    "seq2_causal": (2, 2, 4, 4, 32, 16, True, None),
    "seq4_causal": (4, 2, 4, 4, 64, 16, True, None),
    "seq4_full": (4, 1, 2, 2, 32, 8, False, None),
    "seq4_gqa": (4, 2, 8, 2, 64, 16, True, None),
    "fault_drop_block": (4, 1, 2, 2, 32, 8, True, "ring_drop_block"),
}


def _inputs(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, H, S, D))]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    cases = []
    for i, (name, (world, B, H, Hkv, S, D, causal, fault)) in enumerate(
            CASES.items()):
        q, k, v, do = _inputs(B, H, Hkv, S, D, seed=i)
        cases.append(dict(kind="ring", name=name, world=world, q=q, k=k,
                          v=v, do=do, causal=causal, fault=fault))
    torch.save({"cases": cases}, out / "cases.pt")
    run_ranks(["tools/torch_parallel_cases.py", str(out / "cases.pt"),
               str(out)], 4, 120, cwd=str(ROOT))
    return {n: torch.load(out / f"{n}.rank0.pt", weights_only=False)
            for n in CASES}


def _jax_ring(name):
    world, B, H, Hkv, S, D, causal, _ = CASES[name]
    q, k, v, do = map(jnp.asarray, _inputs(B, H, Hkv, S, D,
                                           seed=list(CASES).index(name)))
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(1, world),
                ("data", "seq"))

    def loss(q, k, v):
        return (ring_attention_sharded(q, k, v, causal=causal) * do).sum()

    with jax.sharding.set_mesh(mesh):
        out = ring_attention_sharded(q, k, v, causal=causal)
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ref = reference_attention(q, k, v, causal=causal)
    return out, grads, ref


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _gaps(got, name):
    out, grads, ref = _jax_ring(name)
    return {"out": _rel(got["out"].numpy(), out),
            "out_vs_reference": _rel(got["out"].numpy(), ref),
            **{g: _rel(got[g].numpy(), w)
               for g, w in zip(("dq", "dk", "dv"), grads)}}


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("fault")])
def test_ring_matches_jax_ring_and_gradients(spawned, name):
    gaps = _gaps(spawned[name], name)
    assert gaps["out"] <= REL and gaps["out_vs_reference"] <= REL, gaps
    assert max(gaps[g] for g in ("dq", "dk", "dv")) <= GRAD_REL, gaps


def test_a_ring_backward_that_drops_a_block_is_caught(spawned):
    gaps = _gaps(spawned["fault_drop_block"], "fault_drop_block")
    assert gaps["out"] <= REL           # the forward is untouched
    assert max(gaps[g] for g in ("dq", "dk", "dv")) > GRAD_REL, gaps


def test_ring_without_a_seq_axis_raises():
    from cloudtik_tpu_torch.ops.ring_attention import ring_attention_sharded \
        as port_ring

    q = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="seq axis"):
        port_ring(q, q, q)
