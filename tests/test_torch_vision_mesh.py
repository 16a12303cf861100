"""The vision families on a mesh: ResNet, SSD, Mask R-CNN and the UNet
train through the port's `Trainer` on gloo CPU ranks as the JAX Trainer
trains them on the same CPU mesh (tests/torch_family_mesh.py has the
harness and the ceilings).

One spawn of 4 ranks runs every case: each family at data=2 x fsdp=2
(BN's statistics over the global batch, the loss a global mean); ResNet
at tensor=2 and at seq=2 against the port on one rank (a tensor rank
reads its conv columns and classifier rows gathered, a seq rank whole
images); ResNet at fsdp=2 writing per-rank checkpoint shards that a
one-rank trainer restores bit for bit; and BN with its statistics summed
in the forward only, which must miss the ceilings.
"""

import jax
import numpy as np
import pytest
import torch

from tests import torch_family_mesh as H
from cloudtik_tpu_torch.models import resnet as TR
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.train import trainer as TTR

torch.set_num_threads(1)

SPAWN_DEADLINE_S = 240
VISION = ("resnet", "ssd", "maskrcnn", "diffusion")
# name: (mesh, world) of ResNet against the port on one rank
ONE_RANK = {"resnet_tensor2": (dict(tensor=2, fsdp=1), 2),
            "resnet_seq2": (dict(seq=2, fsdp=1), 2)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("vision_mesh")
    trainers = {f: H.jax_trainer(f, H.batches(f), H.DATA2_FSDP2, 4)
                for f in VISION}
    cases = [H.case(f"{f}_data2_fsdp2", f, H.DATA2_FSDP2, 4, H.batches(f))
             for f in VISION]
    cases += [H.case(name, "resnet", mesh, world, H.batches("resnet"))
              for name, (mesh, world) in ONE_RANK.items()]
    cases.append(H.case("resnet_checkpoint_fsdp2", "resnet", dict(fsdp=2),
                        2, H.batches("resnet"),
                        checkpoint_dir=str(out / "ckpt"),
                        checkpoint_every=H.STEPS))
    cases.append(H.case("fault_bn_reduce_only", "resnet", H.DATA2_FSDP2, 4,
                        H.batches("resnet"), fault="bn_reduce_only"))
    refs = {}

    def meanwhile():
        # the UNet's JAX compile is the slowest: its one mesh, 2 steps
        for f in VISION:
            refs[f] = H.jax_fit(trainers[f], H.batches(f))
        refs["one_rank"] = H.one_rank("resnet", H.batches("resnet"))

    got = H.spawn(cases, out, 4, SPAWN_DEADLINE_S, meanwhile)
    got["refs"] = refs
    got["ckpt_dir"] = str(out / "ckpt")
    return got


@pytest.mark.parametrize("family", VISION)
def test_family_on_data2_fsdp2_matches_jax(spawned, family):
    hist, params = spawned["refs"][family]
    gaps = H.gaps(spawned[f"{family}_data2_fsdp2"], hist, params,
                  H.jax_params(family))
    assert H.within(gaps), gaps
    # gradients summed over the batch axes only
    assert spawned[f"{family}_data2_fsdp2"]["grad_sum_axes"] == [
        "data", "fsdp"]


def test_conv_and_classifier_leaves_are_sharded(spawned):
    """fsdp halves a conv kernel's input rows where they divide (not the
    3-channel stem's), and the classifier's embed rows."""
    local = spawned["resnet_data2_fsdp2"]["local"]
    assert local["stem"]["conv"] == (7, 7, 3, 16)
    assert local["stage0"][0]["conv0"] == (1, 1, 8, 16)
    assert local["fc"]["kernel"] == (64, 10)
    local = spawned["resnet_tensor2"]["local"]
    assert local["stage0"][0]["conv0"] == (1, 1, 16, 8)
    assert local["fc"]["kernel"] == (128, 5)


@pytest.mark.parametrize("name", sorted(ONE_RANK))
def test_resnet_on_tensor_and_seq_matches_one_rank(spawned, name):
    got = spawned[name]
    hist, params = spawned["refs"]["one_rank"]
    for h, o in zip(got["history"], hist):
        for k in ("loss", "grad_norm", "accuracy"):
            assert H.rel(h[k], o[k]) <= H.REL, (k, h[k], o[k])
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(params)):
        assert H.rel(a.numpy(), b.detach().numpy()) <= H.REL
    # no gradient is summed: tensor and seq ranks read the same rows
    assert got["grad_sum_axes"] == []


def test_resnet_shards_restore_on_one_rank_bit_for_bit(spawned):
    got = spawned["resnet_checkpoint_fsdp2"]
    assert got["restored_step"] == H.STEPS
    for a, b in zip(jax.tree.leaves(got["restored"]),
                    jax.tree.leaves(got["params"])):
        assert torch.equal(a, b)
    trainer = TTR.Trainer(TTR.resnet_spec(TR.config(
        "tiny", dtype=torch.float32)), TTR.TrainerConfig(
        global_batch_size=8, seq_len=1,
        optimizer=TO.OptimizerConfig(**H.OPT),
        checkpoint_dir=spawned["ckpt_dir"], checkpoint_every=1000),
        device="cpu")
    assert trainer.restore_checkpoint() == H.STEPS
    for a, b in zip(jax.tree.leaves(trainer.params),
                    jax.tree.leaves(got["params"])):
        assert torch.equal(a.detach(), b)


def test_bn_without_backward_sum_is_caught(spawned):
    hist, params = spawned["refs"]["resnet"]
    gaps = H.gaps(spawned["fault_bn_reduce_only"], hist, params,
                  H.jax_params("resnet"))
    assert not H.within(gaps), gaps


@pytest.mark.parametrize("family", VISION)
def test_param_logical_axes_equal_jax(family):
    assert H.axes_equal(family)


def test_resnet_bn_off_a_mesh_takes_the_batch_statistics():
    """Off a mesh BN is the batch's own statistics, as before."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 3, 3, 4)).astype(np.float32))
    y = TR._batch_norm(x, torch.ones(4), torch.zeros(4), 1e-5)
    mean = x.mean(dim=(0, 1, 2))
    var = x.var(dim=(0, 1, 2), unbiased=False)
    assert torch.allclose(y, (x - mean) / torch.sqrt(var + 1e-5),
                          atol=1e-6)
