"""The port's training recipes (cloudtik_tpu_torch/recipes/) run on `tiny`
on the CPU, as tests/test_models.py runs the JAX package's: argparse, the
trainer, the data, the one JSON result line."""

import json

import pytest
import torch

from cloudtik_tpu_torch.recipes import bert_large_pretrain, common
from cloudtik_tpu_torch.recipes import llama_lora_finetune
from cloudtik_tpu_torch.recipes import maskrcnn_coco, resnet50_imagenet
from cloudtik_tpu_torch.recipes import ssd_coco
from cloudtik_tpu_torch.recipes import (dlrm_criteo, graphsage_nodes,
                                        rnnt_speech, sdxl_fsdp)

# one intra-op thread, as every port CPU test
torch.set_num_threads(1)

RECIPES = {"bert_large_pretrain": bert_large_pretrain,
           "llama_lora_finetune": llama_lora_finetune}
# the vision recipes: one image a "token"
VISION = {"resnet50_imagenet": resnet50_imagenet, "ssd_coco": ssd_coco,
          "maskrcnn_coco": maskrcnn_coco}


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


def _refused_for_want_of_ranks(recipe, args):
    """A mesh flag builds the family's mesh trainer (its spec has logical
    axes); one process is refused only because the mesh needs more ranks,
    never for the family."""
    with pytest.raises(ValueError, match="devices") as refused:
        recipe.build(args)
    assert "slice" not in str(refused.value)
    assert "ROADMAP" not in str(refused.value)


@pytest.mark.parametrize("axis", common.MESH_AXES)
def test_mesh_axes_other_than_one_name_roadmap_a7(axis):
    args = bert_large_pretrain.parser().parse_args(
        ["--model", "tiny", "--device", "cpu", f"--{axis}", "2"])
    _refused_for_want_of_ranks(bert_large_pretrain, args)


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


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_recipe_two_steps_on_tiny(name, capsys):
    result = VISION[name].main(["--model", "tiny", "--device", "cpu",
                                "--steps", "2", "--batch", "2",
                                "--log-every", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert result["steps"] == 2 and result["img_per_sec"] > 0
    assert result["final_loss"] > 0 and "mfu" not in result


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_recipe_defaults_match_the_jax_recipes(name):
    args = VISION[name].parser().parse_args([])
    want = {"steps": 50, "batch": 8, "data": 1, "fsdp": 1, "tensor": 1,
            "seq": 1, "expert": 1, "checkpoint_dir": None,
            "checkpoint_every": 0, "log_every": 10, "device": "cuda"}
    want.update({"resnet50_imagenet": {"model": "resnet50",
                                       "image_size": 224},
                 "ssd_coco": {"model": "ssd_resnet34", "image_size": 300},
                 "maskrcnn_coco": {"model": "maskrcnn_resnet50",
                                   "image_size": 512}}[name])
    assert vars(args) == want


def test_vision_recipes_build_the_jax_recipes_data():
    """The builders feed what the JAX recipes feed: images at the config's
    size, SSD's `max_boxes` gts, Mask R-CNN's masks at twice the mask
    head's pooled size; one image a "token"."""
    def built(module, *argv):
        args = module.parser().parse_args(
            ["--model", "tiny", "--device", "cpu", "--batch", "2", *argv])
        return module.build(args)

    trainer, data, cfg = built(resnet50_imagenet, "--image-size", "32")
    batch = next(data)
    assert batch["images"].shape == (2, 32, 32, 3)
    assert trainer.config.seq_len == 1
    assert trainer.spec.flops_per_token == cfg.flops_per_image()
    _, data, cfg = built(ssd_coco, "--image-size", "64")
    assert next(data)["gt_boxes"].shape == (2, cfg.max_boxes, 4)
    _, data, cfg = built(maskrcnn_coco, "--image-size", "64")
    masks = next(data)["gt_masks"]
    assert masks.shape == (2, cfg.max_boxes, 2 * cfg.mask_pool,
                           2 * cfg.mask_pool)


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_mesh_axes_other_than_one_name_roadmap_a7(name):
    args = VISION[name].parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--data", "8"])
    _refused_for_want_of_ranks(VISION[name], args)


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_recipe_defaults_to_the_card(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VISION[name].main(["--model", "tiny", "--steps", "1"])


# the model-zoo recipes: argv at `tiny` on the CPU, the unit of the result
ZOO = {
    "sdxl_fsdp": (sdxl_fsdp, ["--batch", "2"], "img"),
    "dlrm_criteo": (dlrm_criteo, ["--batch", "16"], "examples"),
    "rnnt_speech": (rnnt_speech, ["--batch", "2", "--max-frames", "16",
                                  "--max-labels", "4"], "frame"),
    "graphsage_nodes": (graphsage_nodes, ["--nodes", "64"], "node"),
    "graphsage_nodes/link_pred": (graphsage_nodes, [
        "--nodes", "64", "--objective", "link_pred"], "node"),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_recipe_two_steps_on_tiny(name, capsys):
    module, argv, unit = ZOO[name]
    result = module.main(["--model", "tiny", "--device", "cpu", "--steps",
                          "2", "--log-every", "1", *argv])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert result["steps"] == 2 and result[f"{unit}_per_sec"] > 0
    assert result["final_loss"] > 0 and "mfu" not in result


@pytest.mark.parametrize("name", ["sdxl_fsdp", "dlrm_criteo", "rnnt_speech",
                                  "graphsage_nodes"])
def test_zoo_recipe_defaults_match_the_jax_recipes(name):
    args = ZOO[name][0].parser().parse_args([])
    want = {"steps": 50, "batch": 8, "data": 1, "fsdp": 1, "tensor": 1,
            "seq": 1, "expert": 1, "checkpoint_dir": None,
            "checkpoint_every": 0, "log_every": 10, "device": "cuda"}
    want.update({"sdxl_fsdp": {"model": "sdxl_mini"},
                 "dlrm_criteo": {"model": "criteo_terabyte"},
                 "rnnt_speech": {"model": "rnnt", "max_frames": 256,
                                 "max_labels": 64},
                 "graphsage_nodes": {"model": "graphsage", "nodes": 4096,
                                     "objective": "supervised"}}[name])
    assert vars(args) == want


def test_zoo_recipes_build_the_jax_recipes_data():
    """The builders feed what the JAX recipes feed, with the accounting of
    the JAX recipes: one image, example or node a "token", one frame for
    RNN-T (seq_len = --max-frames); GraphSAGE's batch is --nodes."""
    def built(module, *argv):
        args = module.parser().parse_args(
            ["--model", "tiny", "--device", "cpu", *argv])
        return args, module.build(args)

    _, (trainer, data, cfg) = built(sdxl_fsdp, "--batch", "2")
    assert next(data)["latents"].shape == (2, cfg.image_size,
                                           cfg.image_size, cfg.in_channels)
    assert trainer.config.seq_len == 1
    assert trainer.spec.flops_per_token == cfg.flops_per_image()
    _, (trainer, data, cfg) = built(dlrm_criteo, "--batch", "4")
    assert next(data)["sparse_ids"].shape == (4, cfg.num_tables)
    assert trainer.spec.flops_per_token == cfg.flops_per_example()
    _, (trainer, data, cfg) = built(rnnt_speech, "--max-frames", "20")
    assert next(data)["features"].shape == (8, 20, cfg.feature_dim)
    assert trainer.config.seq_len == 20
    args, (trainer, data, cfg) = built(graphsage_nodes, "--nodes", "32",
                                       "--objective", "link_pred")
    batch = next(data)
    assert args.batch == trainer.config.global_batch_size == 32
    assert batch["src"].shape == batch["neg_dst"].shape == (16,)
    assert trainer.spec.flops_per_token == cfg.flops_per_node()


@pytest.mark.parametrize("name", ["sdxl_fsdp", "dlrm_criteo", "rnnt_speech",
                                  "graphsage_nodes"])
def test_zoo_mesh_axes_other_than_one_name_roadmap_a7(name):
    args = ZOO[name][0].parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--fsdp", "8"])
    _refused_for_want_of_ranks(ZOO[name][0], args)


@pytest.mark.parametrize("name, argv", [
    ("dlrm_criteo", ["--batch", "16", "--data", "2"]),
    ("graphsage_nodes", ["--nodes", "32", "--fsdp", "2"])])
def test_zoo_recipe_on_two_ranks_matches_one_card(capsys, name, argv):
    """A zoo recipe under a two-rank launch (gloo, the CPU) prints its one
    JSON line on every rank, the one-card run's loss within 1e-3 relative
    (bf16 compute: the ranks sum their halves' rounded losses)."""
    from pathlib import Path

    from cloudtik_tpu_torch.parallel.launch import run_ranks

    base = ["--model", "tiny", "--steps", "2", "--log-every", "1",
            "--device", "cpu", *argv[:2]]
    one = ZOO[name][0].main(base)
    capsys.readouterr()
    outs = run_ranks(["-m", f"cloudtik_tpu_torch.recipes.{name}", *base,
                      *argv[2:]], 2, 120,
                     cwd=str(Path(__file__).resolve().parents[1]))
    for out in outs:
        got = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        assert got["steps"] == 2
        assert abs(got["final_loss"] - one["final_loss"]) <= \
            1e-3 * one["final_loss"]


@pytest.mark.parametrize("name", ["sdxl_fsdp", "dlrm_criteo", "rnnt_speech",
                                  "graphsage_nodes"])
def test_zoo_recipe_defaults_to_the_card(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ZOO[name][0].main(["--model", "tiny", "--steps", "1"])


def test_lm_generate_reports_tokens_per_second_for_moe(capsys):
    from cloudtik_tpu_torch.recipes import lm_generate

    result = lm_generate.main([
        "--model", "tiny_moe", "--prompt-len", "16", "--max-new", "8",
        "--steps", "2", "--batch", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert result["tokens_per_sec"] > 0 and result["max_new"] == 8
    args = lm_generate.parser().parse_args([])
    assert (args.model, args.prompt_len, args.max_new, args.temperature,
            args.top_k) == ("tpu_1b", 128, 128, 0.0, 0)
    with pytest.raises(ValueError, match="one card"):
        lm_generate.main(["--model", "tiny", "--device", "cpu", "--fsdp",
                          "2"])


def test_lora_recipe_on_two_ranks_matches_one_card(capsys):
    """`--fsdp 2` under a two-rank launch (gloo, the CPU): every rank trains
    its shard of the adapters and of each global batch, to the one-card
    run's losses."""
    from pathlib import Path

    from cloudtik_tpu_torch.parallel.launch import run_ranks

    argv = ["--model", "tiny", "--seq-len", "32", "--rank", "4", "--steps",
            "2", "--batch", "4", "--log-every", "1", "--device", "cpu"]
    one = llama_lora_finetune.main(argv)
    capsys.readouterr()
    outs = run_ranks(["-m", "cloudtik_tpu_torch.recipes.llama_lora_finetune",
                      *argv, "--fsdp", "2"], 2, 120,
                     cwd=str(Path(__file__).resolve().parents[1]))
    for out in outs:
        got = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        assert got["final_loss"] == one["final_loss"]


def test_tensor_recipe_on_two_ranks_matches_one_card(capsys):
    """`--tensor 2` under a two-rank launch (gloo, the CPU): each rank
    holds its heads of the base and of the adapters, to the one-card
    run's loss within 1e-3 relative.  The recipe computes in bf16, and the
    split rounds each rank's partial products to bf16 before their sum,
    where one card rounds the whole product once."""
    from pathlib import Path

    from cloudtik_tpu_torch.parallel.launch import run_ranks

    argv = ["--model", "tiny", "--seq-len", "32", "--rank", "4", "--steps",
            "2", "--batch", "4", "--log-every", "1", "--device", "cpu"]
    one = llama_lora_finetune.main(argv)
    capsys.readouterr()
    outs = run_ranks(["-m", "cloudtik_tpu_torch.recipes.llama_lora_finetune",
                      *argv, "--tensor", "2"], 2, 120,
                     cwd=str(Path(__file__).resolve().parents[1]))
    for out in outs:
        got = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        assert abs(got["final_loss"] - one["final_loss"]) <= \
            1e-3 * one["final_loss"]


def test_mesh_flags_wider_than_the_launch_are_refused():
    args = llama_lora_finetune.parser().parse_args(
        ["--model", "tiny", "--seq-len", "32", "--device", "cpu", "--data",
         "2"])
    with pytest.raises(ValueError, match="devices"):
        llama_lora_finetune.build(args)
