"""Runtime software installation: fetch/unpack/pip into TIK_RUNTIME_HOME.

Reference parity: every reference runtime ships `scripts/install.sh`
(e.g. runtime/spark/scripts/install.sh:1 — download + untar into
$RUNTIME_PATH; runtime/ai/scripts/install.sh:48-101 — pip installs) wired
into node bootstrap via commands.yaml + `cloudtik runtime install`
(scripts/runtime_scripts.py:338).  Here installation is a library the
delivery layer drives from a declarative *install spec* instead of shell:

    install:
      type: archive            # tarball/zip -> $TIK_RUNTIME_HOME/<name>/
      url: https://.../etcd-v3.5.12-linux-amd64.tar.gz
      strip_components: 1      # default 1 (GitHub-release style layout)
      sha256: ...              # optional integrity check
    install:
      type: pip                # pip install into the node's Python env
      packages: [mlflow==2.3]
    install:
      type: script             # escape hatch: arbitrary shell
      script: "curl ... | tar xz -C $TIK_RUNTIME_DIR"

Idempotency: a `.tik-installed` marker (recording the spec hash) short-
circuits repeat installs; a changed spec reinstalls.  `file://` URLs are
first-class so tests and air-gapped environments install from local
artifact mirrors.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
import urllib.request
import zipfile
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.utils.constants import tik_home


class InstallError(RuntimeError):
    pass


def runtime_home() -> str:
    """Root directory runtime software is installed under."""
    return os.path.expanduser(
        os.environ.get("TIK_RUNTIME_HOME")
        or os.path.join(tik_home(), "runtime"))


def install_dir(name: str) -> str:
    return os.path.join(runtime_home(), name)


def _marker_path(name: str) -> str:
    return os.path.join(install_dir(name), ".tik-installed")


def _spec_hash(spec: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


def is_installed(name: str, spec: Dict[str, Any]) -> bool:
    try:
        with open(_marker_path(name)) as f:
            return json.load(f).get("spec_hash") == _spec_hash(spec)
    except (OSError, ValueError):
        return False


def _write_marker(name: str, spec: Dict[str, Any]) -> None:
    with open(_marker_path(name), "w") as f:
        json.dump({"spec_hash": _spec_hash(spec),
                   "installed_at": time.time()}, f)


def _fetch(url: str, dest: str, retries: int = 3) -> None:
    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=120) as resp, \
                    open(dest, "wb") as out:
                shutil.copyfileobj(resp, out)
            return
        except OSError as e:
            last = e
            time.sleep(min(2 ** attempt, 10))
    raise InstallError(f"cannot fetch {url}: {last}")


def _verify_sha256(path: str, expected: str) -> None:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != expected.lower():
        raise InstallError(
            f"sha256 mismatch for {os.path.basename(path)}: "
            f"got {h.hexdigest()}, want {expected}")


def _strip_path(member_name: str, strip: int) -> Optional[str]:
    parts = [p for p in member_name.split("/") if p not in ("", ".")]
    if any(p == ".." for p in parts):
        return None  # refuse traversal
    parts = parts[strip:]
    return "/".join(parts) if parts else None


def _unpack_tar(archive: str, dest: str, strip: int) -> None:
    with tarfile.open(archive) as tf:
        for member in tf.getmembers():
            rel = _strip_path(member.name, strip)
            if rel is None or not (member.isfile() or member.isdir()
                                   or member.issym()):
                continue
            target = os.path.join(dest, rel)
            if member.isdir():
                os.makedirs(target, exist_ok=True)
                continue
            os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
            if member.issym():
                try:
                    os.symlink(member.linkname, target)
                except OSError:
                    pass
                continue
            src = tf.extractfile(member)
            if src is None:
                continue
            with src, open(target, "wb") as out:
                shutil.copyfileobj(src, out)
            os.chmod(target, member.mode & 0o777 or 0o644)


def _unpack_zip(archive: str, dest: str, strip: int) -> None:
    with zipfile.ZipFile(archive) as zf:
        for info in zf.infolist():
            rel = _strip_path(info.filename, strip)
            if rel is None:
                continue
            target = os.path.join(dest, rel)
            if info.is_dir():
                os.makedirs(target, exist_ok=True)
                continue
            os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
            with zf.open(info) as src, open(target, "wb") as out:
                shutil.copyfileobj(src, out)
            mode = (info.external_attr >> 16) & 0o777
            os.chmod(target, mode or 0o644)


def install_archive(name: str, spec: Dict[str, Any]) -> str:
    """Download + unpack an archive into install_dir(name); returns dir."""
    url = spec.get("url")
    if not url:
        raise InstallError(f"{name}: archive install needs a url")
    dest = install_dir(name)
    os.makedirs(dest, exist_ok=True)
    strip = int(spec.get("strip_components", 1))
    if url.startswith(("http://", "https://")) and not spec.get("sha256"):
        # An unpinned network fetch installs whatever arrives; production
        # configs should set install.sha256 for quorum-critical binaries.
        import logging
        logging.getLogger(__name__).warning(
            "%s: fetching %s without sha256 verification", name, url)
    with tempfile.TemporaryDirectory(prefix=f"tik-install-{name}-") as tmp:
        archive = os.path.join(tmp, os.path.basename(url) or "archive")
        _fetch(url, archive)
        if spec.get("sha256"):
            _verify_sha256(archive, spec["sha256"])
        if zipfile.is_zipfile(archive):
            _unpack_zip(archive, dest, strip)
        elif tarfile.is_tarfile(archive):
            _unpack_tar(archive, dest, strip)
        else:
            # single binary download
            binary = os.path.join(
                dest, "bin", spec.get("binary", os.path.basename(url)))
            os.makedirs(os.path.dirname(binary), exist_ok=True)
            shutil.copyfile(archive, binary)
            os.chmod(binary, 0o755)
    return dest


def install_pip(name: str, spec: Dict[str, Any]) -> str:
    packages = list(spec.get("packages") or [])
    if not packages:
        raise InstallError(f"{name}: pip install needs packages")
    cmd = [sys.executable, "-m", "pip", "install", "--no-input"]
    if spec.get("target"):
        cmd += ["--target", os.path.expanduser(spec["target"])]
    cmd += packages
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise InstallError(
            f"{name}: pip install failed:\n{proc.stderr[-2000:]}")
    return install_dir(name)


def install_script(name: str, spec: Dict[str, Any]) -> str:
    script = spec.get("script")
    if not script:
        raise InstallError(f"{name}: script install needs a script")
    dest = install_dir(name)
    os.makedirs(dest, exist_ok=True)
    env = dict(os.environ, TIK_RUNTIME_DIR=dest,
               TIK_RUNTIME_HOME=runtime_home())
    proc = subprocess.run(["bash", "-c", script], env=env,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise InstallError(
            f"{name}: install script failed (exit {proc.returncode}):\n"
            f"{proc.stderr[-2000:]}")
    return dest


_INSTALLERS = {
    "archive": install_archive,
    "pip": install_pip,
    "script": install_script,
}


def install(name: str, spec: Dict[str, Any]) -> str:
    """Run one install spec idempotently; returns the install dir."""
    kind = spec.get("type", "archive")
    fn = _INSTALLERS.get(kind)
    if fn is None:
        raise InstallError(
            f"{name}: unknown install type {kind!r} "
            f"(known: {sorted(_INSTALLERS)})")
    if is_installed(name, spec):
        return install_dir(name)
    dest = fn(name, spec)
    os.makedirs(install_dir(name), exist_ok=True)
    _write_marker(name, spec)
    return dest
