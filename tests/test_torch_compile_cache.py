"""TIK_COMPILE_CACHE_DIR for the port: where its kernels are built.

`cloudtik_tpu_torch.utils.compile_cache` reads the reference's variable
with the reference's values and points `ops/_kernels.BUILD_DIR` at the
directory it names, so a restarted process loads the libraries an earlier
one built.  Off (or unset) keeps the checkout's own `build/torch_kernels`:
a kernel must be built somewhere.  There is no nvcc here, so a fake one (a
script that writes its `-o` file in chunks and appends to a marker) stands
in for it in the processes below: a cold directory builds and books the
compile bucket, a warm one builds nothing, and two processes building into
one directory at once leave one whole library for each source.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cloudtik_tpu.utils import compile_cache as JC
from cloudtik_tpu_torch.models import transformer as T
from cloudtik_tpu_torch.ops import _kernels
from cloudtik_tpu_torch.serve import server as S
from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                              transformer_spec)
from cloudtik_tpu_torch.utils import compile_cache as TC

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(_kernels._SIGNATURES)
# what the fake nvcc writes: 32 chunks, each a line naming the source
CHUNKS = 32


@pytest.fixture
def clean(monkeypatch, tmp_path):
    """The build directory and the applied cache restored after the test;
    TIK_HOME in the test's directory."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    monkeypatch.setattr(TC, "_applied", None)
    monkeypatch.delenv(TC.CACHE_DIR_ENV, raising=False)
    monkeypatch.setenv("TIK_HOME", str(tmp_path / "home"))
    return tmp_path


@pytest.mark.parametrize("value", [None, "off", "0", "", "none", "1",
                                   "default", "on", "/data/kcache",
                                   "~/x"])
def test_resolved_directory_is_the_references(clean, monkeypatch, value):
    if value is not None:
        monkeypatch.setenv(TC.CACHE_DIR_ENV, value)
    got, want = TC.cache_dir(), JC.cache_dir()
    if value in ("1", "default", "on"):
        # the same place under TIK_HOME, the port's entry beside XLA's
        assert got == str(clean / "home" / "cache" / "torch_kernels")
        assert os.path.dirname(got) == os.path.dirname(want)
    else:
        assert got == want
    if value == "~/x":
        assert got == os.path.expanduser("~/x")


def test_target_lands_under_the_cache_and_off_restores_the_tree(
        clean, monkeypatch):
    cache = clean / "cache"
    monkeypatch.setenv(TC.CACHE_DIR_ENV, str(cache))
    assert TC.ensure_compile_cache() == str(cache)
    assert _kernels.BUILD_DIR == cache
    for name in SOURCES:
        assert _kernels._target(name).parent == cache
    # idempotent
    assert TC.ensure_compile_cache() == str(cache)
    # off re-applies: the checkout's own directory again
    monkeypatch.setenv(TC.CACHE_DIR_ENV, "off")
    assert TC.ensure_compile_cache() is None
    assert _kernels.BUILD_DIR == _kernels.DEFAULT_BUILD_DIR
    assert _kernels.DEFAULT_BUILD_DIR == ROOT / "build" / "torch_kernels"


def test_repointing_reapplies(clean, monkeypatch):
    for name in ("a", "b", "a"):
        monkeypatch.setenv(TC.CACHE_DIR_ENV, str(clean / name))
        assert TC.ensure_compile_cache() == str(clean / name)
        assert _kernels._target("nms").parent == clean / name
    monkeypatch.setenv(TC.CACHE_DIR_ENV, "default")
    TC.ensure_compile_cache()
    assert _kernels.BUILD_DIR == clean / "home" / "cache" / "torch_kernels"


def test_unset_leaves_the_build_directory_alone(clean):
    _kernels.BUILD_DIR = clean / "chosen"
    assert TC.ensure_compile_cache() is None
    assert _kernels.BUILD_DIR == clean / "chosen"


def test_unwritable_directory_warns_and_keeps_the_tree(clean, monkeypatch,
                                                       caplog):
    blocker = clean / "a-file"
    blocker.write_text("")
    monkeypatch.setenv(TC.CACHE_DIR_ENV, str(clean / "good"))
    TC.ensure_compile_cache()
    monkeypatch.setenv(TC.CACHE_DIR_ENV, str(blocker / "cache"))
    with caplog.at_level(logging.WARNING, logger=TC.__name__):
        assert TC.ensure_compile_cache() is None
    assert "unusable" in caplog.text
    assert _kernels.BUILD_DIR == _kernels.DEFAULT_BUILD_DIR
    assert TC._applied is None


def test_trainer_applies_the_cache(clean, monkeypatch):
    monkeypatch.setenv(TC.CACHE_DIR_ENV, str(clean / "trainer"))
    Trainer(transformer_spec(T.config("tiny", dtype=torch.float32)),
            TrainerConfig(global_batch_size=2, seq_len=8), device="cpu")
    assert _kernels.BUILD_DIR == clean / "trainer"


def test_server_main_applies_the_cache(clean, monkeypatch):
    class Booted(Exception):
        pass

    def stop(*args, **kwargs):
        raise Booted

    monkeypatch.setattr(S, "transformer_backend", stop)
    monkeypatch.setenv(TC.CACHE_DIR_ENV, str(clean / "server"))
    with pytest.raises(Booted):
        S.main(["--model", "tiny", "--device", "cpu", "--port", "0"])
    assert _kernels.BUILD_DIR == clean / "server"


# ------------------------------------------------- builds in processes --

FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
source = os.path.basename(sys.argv[-1])
marker = os.environ["FAKE_NVCC_MARKER"]
with open(marker, "a") as f:
    f.write(source + "\\n")
# hold the write until this many calls have started (a race on purpose)
deadline = time.time() + 20
while (len(open(marker).read().split())
       < int(os.environ.get("FAKE_NVCC_WAIT_FOR", "0"))
       and time.time() < deadline):
    time.sleep(0.01)
with open(out, "w") as f:
    for i in range({chunks}):
        f.write(f"{{source}} chunk {{i}}\\n")
        f.flush()
        time.sleep(0.005)
print("ptxas info    : Used 32 registers")
"""

BUILD = """
import json
from cloudtik_tpu_torch.ops import _kernels
from cloudtik_tpu_torch.telemetry import goodput, stepprof
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils.compile_cache import ensure_compile_cache
ensure_compile_cache()
stepprof.install_compile_tracking()
built = _kernels.build_all()
print(json.dumps({"built": sorted(built), "dir": str(_kernels.BUILD_DIR),
                  "compile_s": goodput.LEDGER.total(goodput.BUCKET_COMPILE),
                  "compiles": ti.TRAIN_COMPILES.value()}))
"""


def _whole(path: Path, name: str) -> bool:
    return path.read_text() == "".join(f"{name}.cu chunk {i}\n"
                                       for i in range(CHUNKS))


def test_builds_share_one_cache_across_processes(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, chunks=CHUNKS))
    nvcc.chmod(0o755)
    marker = tmp_path / "calls"

    def start(cache: Path, wait_for: int = 0) -> subprocess.Popen:
        env = dict(os.environ, TIK_COMPILE_CACHE_DIR=str(cache),
                   FAKE_NVCC_MARKER=str(marker),
                   FAKE_NVCC_WAIT_FOR=str(wait_for),
                   PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
        return subprocess.Popen([sys.executable, "-c", BUILD], cwd=str(ROOT),
                                env=env, stdout=subprocess.PIPE, text=True)

    def result(proc: subprocess.Popen) -> dict:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0
        return json.loads(out.strip().splitlines()[-1])

    def calls() -> list:
        return marker.read_text().split() if marker.exists() else []

    # a cold cache: every source built through nvcc into it, and booked
    cache = tmp_path / "cache"
    first = result(start(cache))
    assert first["built"] == SOURCES and first["dir"] == str(cache)
    assert first["compile_s"] > 0 and first["compiles"] == len(SOURCES)
    assert sorted(calls()) == sorted(f"{n}.cu" for n in SOURCES)
    libs = sorted(cache.glob("lib*.so"))
    assert len(libs) == len(SOURCES)
    assert all(_whole(lib, lib.name[3:].split("-")[0]) for lib in libs)
    # a warm cache: a new process builds nothing and books nothing
    second = result(start(cache))
    assert second["built"] == [] and second["compile_s"] == 0
    assert len(calls()) == len(SOURCES)
    # two processes building into one cold cache at once: no library is
    # written until both have started every build
    shared = tmp_path / "shared"
    race = 3 * len(SOURCES)
    both = [result(p) for p in [start(shared, race), start(shared, race)]]
    assert all(b["dir"] == str(shared) and b["built"] == SOURCES
               for b in both)
    assert len(calls()) == race
    assert sorted(p.name for p in shared.iterdir()) == sorted(
        [lib.name for lib in libs] + [lib.with_suffix(".log").name
                                      for lib in libs])
    for name in SOURCES:
        (lib,) = shared.glob(f"lib{name}-*.so")
        assert _whole(lib, name)
        assert "ptxas info" in lib.with_suffix(".log").read_text()
