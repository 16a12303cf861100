"""The port's pipeline (`cloudtik_tpu_torch/parallel/pipeline.py`) over
gloo ranks against the JAX package's `pipeline_apply` on the 8-device CPU
mesh: GPipe and 1F1B at pipe=2 and 4.

A stack of L tanh(x @ w) layers splits over the stages; the loss is
sum(y**2), plus half the summed aux where a case carries one.  All ranks
run in one spawn (`tools/torch_parallel_cases.py`, no JAX in the workers;
each case its own gloo group with a 60 s timeout; the spawn's deadline
kills every rank).  Ceilings, f32 on one intra-op thread: outputs within
1e-5 relative, gradients (the stack's and the input's) within 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cloudtik_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from cloudtik_tpu_torch.parallel import pipeline as TP
from cloudtik_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OUT_REL = 1e-5
GRAD_REL = 1e-4
SPAWN_DEADLINE_S = 120
L, D, B, T, M = 4, 16, 8, 6, 4

# name: (pipe, schedule, aux)
CASES = {f"pipe{n}_{s}{'_aux' if aux else ''}": (n, s, aux)
         for n in (2, 4) for s in ("gpipe", "1f1b") for aux in (False, True)
         if not (aux and n == 4)}


def _inputs():
    rng = np.random.default_rng(0)
    params = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    return params, x


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    params, x = _inputs()
    cases = [dict(kind="pipeline", name=name, world=n, params=params, x=x,
                  micro=M, schedule=s, aux=aux)
             for name, (n, s, aux) in CASES.items()]
    # the route gloo takes on the card, forced here on the CPU
    for name in ("pipe2_1f1b", "pipe4_gpipe"):
        cases.append({**next(c for c in cases if c["name"] == name),
                      "name": f"{name}_gathered",
                      "shift_route": "all_gather"})
    # extras ride with their microbatch: each layer adds the microbatch's
    # id, so y = L * id whatever stage runs it
    cases.append(dict(kind="pipeline", name="extras", world=2,
                      params=np.zeros((2, D, D), np.float32),
                      x=np.zeros((4, 3, D), np.float32), micro=4,
                      schedule="gpipe",
                      extras=np.repeat(np.arange(4.0)[:, None], 3, 1)))
    torch.save({"cases": cases}, out / "cases.pt")
    run_ranks(["tools/torch_parallel_cases.py", str(out / "cases.pt"),
               str(out)], 4, SPAWN_DEADLINE_S, cwd=str(ROOT))
    return {c["name"]: torch.load(out / f"{c['name']}.rank0.pt",
                                  weights_only=False) for c in cases}


def _jstage(aux):
    def stage(p_local, xm, _extras):
        def body(c, w):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, xm, p_local)
        if aux:
            return out, {"aux": (out ** 2).mean()}
        return out
    return stage


def _jax(n, schedule, aux):
    """JAX's loss, outputs and gradients on a (data=8/n, pipe=n) mesh."""
    params, x = _inputs()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8 // n, n),
                ("data", "pipe"))

    def f(p, x):
        out = jpipeline_apply(_jstage(aux), p, x, n_microbatches=M,
                              aux_init={"aux": 0.0} if aux else None,
                              schedule=schedule)
        y, a = out if aux else (out, None)
        loss = (y ** 2).sum()
        if aux:
            loss = loss + 0.5 * a["aux"]
        return loss, y

    with jax.sharding.set_mesh(mesh):
        p_s = jax.device_put(params, NamedSharding(mesh, P("pipe")))
        (loss, y), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p_s, x)
    return {"loss": np.asarray(loss), "y": np.asarray(y),
            "dparams": np.asarray(gp), "dx": np.asarray(gx)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_jax(spawned, name):
    got = spawned[name]
    want = _jax(*CASES[name])
    assert _rel(got["y"].numpy(), want["y"]) <= OUT_REL
    assert _rel(got["loss"].numpy(), want["loss"]) <= OUT_REL
    assert _rel(got["dparams"].numpy(), want["dparams"]) <= GRAD_REL
    assert _rel(got["dx"].numpy(), want["dx"]) <= GRAD_REL


@pytest.mark.parametrize("name", ["pipe2_1f1b", "pipe4_gpipe"])
def test_the_gathered_shift_is_the_p2p_one(spawned, name):
    """gloo refuses P2P on CUDA tensors, so a shift there gathers the group
    and takes its source's slot: the same numbers."""
    for k in ("y", "loss", "dparams", "dx"):
        assert torch.equal(spawned[f"{name}_gathered"][k], spawned[name][k])


@pytest.mark.parametrize("n", [2, 4])
def test_1f1b_saves_fewer_bytes_than_gpipe(spawned, n):
    """The forward of 1F1B keeps each microbatch's stage input; GPipe keeps
    every layer's residuals for every microbatch."""
    gpipe = spawned[f"pipe{n}_gpipe"]["saved_bytes"]
    onef = spawned[f"pipe{n}_1f1b"]["saved_bytes"]
    assert onef < gpipe, (onef, gpipe)


def test_aux_matches_under_both_schedules(spawned):
    for s in ("gpipe", "1f1b"):
        got = spawned[f"pipe2_{s}_aux"]
        want = _jax(2, s, True)
        assert _rel(got["loss"].numpy(), want["loss"]) <= OUT_REL
        assert _rel(got["dparams"].numpy(), want["dparams"]) <= GRAD_REL
    assert torch.allclose(spawned["pipe2_gpipe_aux"]["aux"],
                          spawned["pipe2_1f1b_aux"]["aux"], rtol=1e-6)


def test_extras_ride_with_their_microbatch(spawned):
    y = spawned["extras"]["y"].numpy()
    want = 2 * np.repeat(np.arange(4.0)[:, None], 3, 1)
    np.testing.assert_array_equal(y[..., 0], want)
    # and as the reference has it
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))
    extras = jnp.repeat(jnp.arange(4.0)[:, None], 3, 1)

    def stage(p_local, xm, pm):
        def body(c, w):
            return c + pm[..., None].astype(c.dtype), None
        out, _ = jax.lax.scan(body, xm, p_local)
        return out

    with jax.sharding.set_mesh(mesh):
        p_s = jax.device_put(jnp.zeros((2, D, D)),
                             NamedSharding(mesh, P("pipe")))
        jy = jax.jit(lambda p, x, e: jpipeline_apply(
            stage, p, x, n_microbatches=4, extras=e))(
                p_s, jnp.zeros((4, 3, D)), extras)
    np.testing.assert_array_equal(y, np.asarray(jy))


def _stage(p, xm, _extras):
    for i in range(p.shape[0]):
        xm = torch.tanh(xm @ p[i])
    return xm


def test_errors_are_the_references():
    params, x = (torch.as_tensor(a) for a in _inputs())
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        TP.pipeline_apply(_stage, params, x, n_microbatches=4,
                          schedule="interleaved")
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        jpipeline_apply(_jstage(False), jnp.asarray(params.numpy()),
                        jnp.asarray(x.numpy()), n_microbatches=4,
                        schedule="interleaved")
    with pytest.raises(ValueError, match="not divisible by n_microbatches"):
        TP.pipeline_apply(_stage, params, x[:6], n_microbatches=4)


def test_no_pipe_axis_runs_the_stack_locally():
    params, x = (torch.as_tensor(a) for a in _inputs())
    assert TP.pipe_axis_size() == 1
    y = TP.pipeline_apply(_stage, params, x, n_microbatches=2)
    torch.testing.assert_close(y, _stage(params, x, None), rtol=0, atol=0)
    jy = jpipeline_apply(_jstage(False), jnp.asarray(params.numpy()),
                         jnp.asarray(x.numpy()), n_microbatches=2)
    assert _rel(y.numpy(), np.asarray(jy)) <= OUT_REL
