"""The port package's own rules: it imports neither JAX nor the JAX
package, imports cleanly without CUDA, nvcc or triton, and its entry points
refuse to run off the card unless the caller asks for the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.device import resolve_device
from cloudtik_tpu_torch.parallel.distributed import rank_device
from cloudtik_tpu_torch.models import diffusion as TU
from cloudtik_tpu_torch.models import dlrm as TDL
from cloudtik_tpu_torch.models import gbdt as TGB
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import graphsage as TGS
from cloudtik_tpu_torch.models import lora as TL
from cloudtik_tpu_torch.models import maskrcnn as TMR
from cloudtik_tpu_torch.models import resnet as TRN
from cloudtik_tpu_torch.models import rnnt as TN
from cloudtik_tpu_torch.models import ssd as TSD
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE
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
    ROOT / "tools" / "profile_torch_detect.py",
    ROOT / "tools" / "torch_parallel_cases.py",
    ROOT / "tools" / "probe_torch_gloo_cuda.py",
    ROOT / "tools" / "probe_torch_cuda_context.py"]
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


# The scrape path's modules (the serving runtime's telemetry, the
# prometheus runtime and collector, the SLO engine, the node exporter, the
# profiler runtime, the scaling policies, the tokenizer), imported and
# driven with `jax` and `cloudtik_tpu` blocked: a card host has no JAX
SCRAPE_PATH = (
    "cloudtik_tpu_torch.telemetry.http", "cloudtik_tpu_torch.telemetry.slo",
    "cloudtik_tpu_torch.runtimes.registry",
    "cloudtik_tpu_torch.runtimes.prometheus.runtime",
    "cloudtik_tpu_torch.runtimes.prometheus.windows",
    "cloudtik_tpu_torch.runtimes.prometheus.alerts",
    "cloudtik_tpu_torch.runtimes.prometheus.collector",
    "cloudtik_tpu_torch.runtimes.prometheus.trace_collector",
    "cloudtik_tpu_torch.runtimes.nodex.runtime",
    "cloudtik_tpu_torch.runtimes.nodex.exporter",
    "cloudtik_tpu_torch.runtimes.profiler.runtime",
    "cloudtik_tpu_torch.runtimes.serving.runtime",
    "cloudtik_tpu_torch.runtimes.discovery.sync",
    "cloudtik_tpu_torch.control.scaling_policies",
    "cloudtik_tpu_torch.train.tokenizer",
)
_BLOCKED = """
import importlib, importlib.abc, json, sys, tempfile
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'cloudtik_tpu'):
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, Block())
out = {}
for m in MODULES:
    try:
        importlib.import_module(m)
        out[m] = 'ok'
    except Exception as e:
        out[m] = repr(e)
# drive them: the rendered files, a collector cycle, the policies
from cloudtik_tpu_torch.control.scaling_policies import create_scaling_policy
from cloudtik_tpu_torch.control.state import InMemoryStateBackend, StateClient
from cloudtik_tpu_torch.runtimes.prometheus.collector import Collector
from cloudtik_tpu_torch.runtimes.prometheus.runtime import PrometheusRuntime
conf = tempfile.mkdtemp()
PrometheusRuntime({}).node_configure({'is_head': True, 'conf_dir': conf,
    'config': {'runtime': {'types': ['nodex', 'serving', 'profiler']}}})
c = Collector(conf)
c.scrape_once()
c.evaluate_alerts()
policy = create_scaling_policy('serve-demand', {}, 'head',
    state_client=StateClient(InMemoryStateBackend()))
out['driven'] = [policy.get_scaling_state().autoscaling_instructions[
    'resource_demands'], sorted(s['name'] for s in c.slo_state())]
out['loaded'] = sorted({m.split('.')[0] for m in sys.modules} & {
    'jax', 'jaxlib', 'cloudtik_tpu'})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def scrape_path_imports():
    code = f"MODULES = {SCRAPE_PATH!r}\n" + _BLOCKED
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", SCRAPE_PATH)
def test_scrape_path_imports_with_jax_blocked(module, scrape_path_imports):
    assert scrape_path_imports[module] == "ok"
    assert scrape_path_imports["loaded"] == []


def test_scrape_path_runs_with_jax_blocked(scrape_path_imports):
    demands, slos = scrape_path_imports["driven"]
    assert demands == [{"GPU": 1}]
    assert slos == ["serve-availability", "serve-tpot", "serve-ttft"]


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
    lambda: TS.engine_backend("tiny"),
    lambda: TE.DecodeEngine({}, TT.config("tiny")),
    lambda: TG.init_block_pool(TT.config("tiny"), 3, 4),
    lambda: TTR.Trainer(TTR.transformer_spec(TT.config("tiny")),
                        TTR.TrainerConfig()),
    lambda: TRN.init_params(torch.Generator(), TRN.config("tiny")),
    lambda: TSD.init_params(torch.Generator(), TSD.config("tiny")),
    lambda: TMR.init_params(torch.Generator(), TMR.config("tiny")),
    lambda: TSD.detect({}, np.zeros((1, 64, 64, 3), np.float32),
                       TSD.config("tiny")),
    lambda: TMR.detect({}, np.zeros((1, 64, 64, 3), np.float32),
                       TMR.config("tiny")),
    lambda: TL.init_lora_params(torch.Generator(), TT.config("tiny"),
                                TL.LoRAConfig()),
    lambda: TL.random_lora_params(torch.Generator(), TT.config("tiny"),
                                  TL.LoRAConfig()),
    lambda: TL.init_adapter_planes(TT.config("tiny"), TL.LoRAConfig(), 2),
    lambda: TS.engine_backend("tiny", spec_model="tiny"),
    lambda: TU.init_params(torch.Generator(), TU.config("tiny")),
    lambda: TDL.init_params(torch.Generator(), TDL.config("tiny")),
    lambda: TN.init_params(torch.Generator(), TN.config("tiny")),
    lambda: TGS.init_params(torch.Generator(), TGS.config("tiny")),
    lambda: TGB.fit(np.zeros((4, 2), np.uint8), np.zeros(4, np.float32),
                    TGB.config(n_trees=1, depth=1)),
    lambda: TTR.Trainer(TTR.dlrm_spec(TDL.config("tiny")),
                        TTR.TrainerConfig()),
    lambda: TT.init_params(torch.Generator(), TT.config("tiny_moe")),
    lambda: TS.engine_backend("tiny_moe"),
    lambda: TTR.Trainer(TTR.transformer_spec(TT.config("tiny_moe")),
                        TTR.TrainerConfig()),
    lambda: rank_device(),
], ids=["init_params", "init_cache", "params_from_jax",
        "transformer_backend", "engine_backend", "DecodeEngine",
        "init_block_pool", "Trainer", "resnet.init_params",
        "ssd.init_params", "maskrcnn.init_params", "ssd.detect",
        "maskrcnn.detect", "lora.init_lora_params",
        "lora.random_lora_params", "lora.init_adapter_planes",
        "engine_backend.spec_model", "diffusion.init_params",
        "dlrm.init_params", "rnnt.init_params", "graphsage.init_params",
        "gbdt.fit", "Trainer.dlrm_spec", "init_params.moe",
        "engine_backend.moe", "Trainer.moe", "rank_device"])
def test_entry_points_without_device_raise_off_the_card(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_server_main_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.main(["--model", "tiny", "--port", "0"])


def test_server_main_engine_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.main(["--engine", "--model", "tiny", "--port", "0"])


def test_kernel_sources_ship_with_the_package():
    assert (PORT / "csrc" / "flash_fwd.cu").is_file()
    assert (PORT / "csrc" / "flash_bwd.cu").is_file()
    assert (PORT / "csrc" / "nms.cu").is_file()
    assert (PORT / "csrc" / "roi_align.cu").is_file()
    text = (ROOT / "pyproject.toml").read_text()
    assert 'cloudtik_tpu_torch = ["csrc/*.cu", "csrc/*.cuh"]' in text
