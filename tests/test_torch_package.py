"""The port package's own rules: it imports neither JAX nor the JAX
package, imports cleanly without CUDA, nvcc or triton, and its entry points
refuse to run off the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.device import resolve_device
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import maskrcnn as TMR
from cloudtik_tpu_torch.models import resnet as TRN
from cloudtik_tpu_torch.models import ssd as TSD
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import server as TS
from cloudtik_tpu_torch.train import trainer as TTR

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cloudtik_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_inference.py",
    ROOT / "tools" / "profile_torch_train.py",
    ROOT / "tools" / "profile_torch_detect.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    .replace(".__init__", "") for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax") \
        or top == "cloudtik_tpu"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cloudtik_tpu', 'triton')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")


@pytest.mark.parametrize("entry", [
    lambda: TT.init_params(torch.Generator(), TT.config("tiny")),
    lambda: TG.init_cache(TT.config("tiny"), 1, 4),
    lambda: convert.params_from_jax({"w": np.zeros(2, np.float32)}),
    lambda: TS.transformer_backend("tiny"),
    lambda: TTR.Trainer(TTR.transformer_spec(TT.config("tiny")),
                        TTR.TrainerConfig()),
    lambda: TRN.init_params(torch.Generator(), TRN.config("tiny")),
    lambda: TSD.init_params(torch.Generator(), TSD.config("tiny")),
    lambda: TMR.init_params(torch.Generator(), TMR.config("tiny")),
    lambda: TSD.detect({}, np.zeros((1, 64, 64, 3), np.float32),
                       TSD.config("tiny")),
    lambda: TMR.detect({}, np.zeros((1, 64, 64, 3), np.float32),
                       TMR.config("tiny")),
], ids=["init_params", "init_cache", "params_from_jax",
        "transformer_backend", "Trainer", "resnet.init_params",
        "ssd.init_params", "maskrcnn.init_params", "ssd.detect",
        "maskrcnn.detect"])
def test_entry_points_without_device_raise_off_the_card(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_server_main_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.main(["--model", "tiny", "--port", "0"])


def test_kernel_sources_ship_with_the_package():
    assert (PORT / "csrc" / "flash_fwd.cu").is_file()
    assert (PORT / "csrc" / "flash_bwd.cu").is_file()
    assert (PORT / "csrc" / "nms.cu").is_file()
    assert (PORT / "csrc" / "roi_align.cu").is_file()
    text = (ROOT / "pyproject.toml").read_text()
    assert 'cloudtik_tpu_torch = ["csrc/*.cu", "csrc/*.cuh"]' in text
