"""The port's training recipes (cloudtik_tpu_torch/recipes/) run one step
on `tiny` on the CPU, as tests/test_models.py runs the JAX package's:
argparse, the trainer, the data, the one JSON result line."""

import json

import pytest
import torch

from cloudtik_tpu_torch.recipes import bert_large_pretrain, common
from cloudtik_tpu_torch.recipes import llama_lora_finetune

# one intra-op thread, as every port CPU test
torch.set_num_threads(1)

RECIPES = {"bert_large_pretrain": bert_large_pretrain,
           "llama_lora_finetune": llama_lora_finetune}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_one_step_on_tiny(name, capsys):
    result = RECIPES[name].main([
        "--model", "tiny", "--seq-len", "64", "--steps", "1", "--batch",
        "8", "--data", "1", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert result["steps"] == 1 and result["seq_per_sec"] > 0
    assert result["final_loss"] > 0 and "mfu" not in result


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_defaults_match_the_jax_recipes(name):
    args = RECIPES[name].parser().parse_args([])
    want = {"steps": 50, "batch": 8, "data": 1, "fsdp": 1, "tensor": 1,
            "seq": 1, "expert": 1, "checkpoint_dir": None,
            "checkpoint_every": 0, "log_every": 10, "device": "cuda"}
    want.update({"bert_large_pretrain": {"model": "bert_large",
                                         "seq_len": 512},
                 "llama_lora_finetune": {"model": "tpu_1b", "seq_len": 2048,
                                         "rank": 16}}[name])
    assert vars(args) == want


@pytest.mark.parametrize("axis", common.MESH_AXES)
def test_mesh_axes_other_than_one_name_roadmap_a7(axis):
    args = bert_large_pretrain.parser().parse_args(
        ["--model", "tiny", "--device", "cpu", f"--{axis}", "2"])
    with pytest.raises(ValueError, match="ROADMAP A7"):
        bert_large_pretrain.build(args)


def test_lora_recipe_builds_a_frozen_base_on_its_device():
    args = llama_lora_finetune.parser().parse_args(
        ["--model", "tiny", "--seq-len", "32", "--rank", "4", "--device",
         "cpu"])
    trainer, data, cfg, base, lora_cfg = llama_lora_finetune.build(args)
    assert cfg.max_seq_len == 32 and lora_cfg.rank == 4
    assert all(not p.requires_grad and p.device.type == "cpu"
               for p in [base["embed"], *base["layers"].values()])
    batch = next(data)
    assert batch["tokens"].shape == (8, 32)
    assert trainer.spec.flops_per_token == cfg.flops_per_token() * 4 / 6


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_defaults_to_the_card(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RECIPES[name].main(["--model", "tiny", "--steps", "1"])


def test_bert_entry_points_default_to_the_card(no_cuda):
    from cloudtik_tpu_torch.models import bert as TB
    from cloudtik_tpu_torch.train import trainer as TTR

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.init_params(torch.Generator(), TB.config("tiny"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTR.Trainer(TTR.bert_spec(TB.config("tiny")), TTR.TrainerConfig())
