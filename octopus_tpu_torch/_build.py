"""Builds the port's compiled code at first use and loads it.

Three kinds, all built from the sources in ``csrc/`` into
``build/torch_kernels/`` beside the package (a directory git ignores):

* the host C++ extension (``csrc/octopus_native.cpp``, built with g++ and
  loaded as the module ``octopus_tpu_torch._native``): tandem scans, error
  model tables, CIGAR scanning, assembly, a populate's anchor jobs and the
  banded flank DP. The port requires it on every device: host modules
  call it through ``NATIVE`` and have no other form of these loops;
* the VB engines' host arithmetic (``csrc/vb_host.cpp``, g++, a plain C
  interface loaded with ctypes by ``core/models/vb_math.py``);
* the CUDA kernels (``csrc/*.cu``, built with nvcc into a shared library
  with a plain C interface, loaded with ctypes).

Each output is named by a hash of its sources, its command and the
interpreter and platform, so a changed source, or a tree copied to another
machine, rebuilds, and an unchanged one is reused. Builds run under an
``fcntl`` lock and land by an atomic rename, so parallel test workers
neither race nor load a half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import platform
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# name -> {"seconds": float, "log": str, "path": str} for builds run by this
# process (a cached output records seconds 0.0)
BUILDS: dict[str, dict] = {}


class BuildError(RuntimeError):
    pass


def build(name: str, sources: list[Path], command, suffix: str) -> Path:
    """Compile `sources` with command(out_path) unless a cached output exists."""
    h = hashlib.sha256(f"{sys.version}|{platform.platform()}".encode())
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(map(str, command(Path("OUT")))).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{suffix}"
    if out.exists():
        BUILDS.setdefault(name, {"seconds": 0.0, "log": "", "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            BUILDS.setdefault(name, {"seconds": 0.0, "log": "", "path": str(out)})
            return out
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [str(c) for c in command(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise BuildError(f"{name}: cannot run {cmd[0]}: {e}") from e
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"{name}: {' '.join(cmd)} failed:\n"
                             f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    BUILDS[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr,
                    "path": str(out)}
    return out


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit's usual home."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


_native = None
_native_error: Exception | None = None


def load_native():
    """The host extension module, or None when it cannot be built here."""
    global _native, _native_error
    if _native is None and _native_error is None:
        src = CSRC / "octopus_native.cpp"
        include = sysconfig.get_paths()["include"]
        try:
            path = build(
                "_native", [src],
                lambda out: ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                             f"-I{include}", src, "-o", out, "-lz"],
                sysconfig.get_config_var("EXT_SUFFIX") or ".so")
            modname = f"{__package__}._native"
            loader = importlib.machinery.ExtensionFileLoader(modname, str(path))
            spec = importlib.util.spec_from_file_location(modname, path,
                                                          loader=loader)
            module = importlib.util.module_from_spec(spec)
            loader.exec_module(module)
            sys.modules[modname] = module
            _native = module
        except (BuildError, ImportError, OSError) as e:
            _native_error = e
    return _native


class LazyNative:
    """The host extension, built and loaded at its first use.

    Attribute lookups reach the loaded module, looked up at each call, or
    raise require_native()'s error. Importing a module that holds one
    starts no build."""

    def __getattr__(self, name: str):
        return getattr(require_native(), name)


NATIVE = LazyNative()


def require_native():
    """The host extension, or raise with the reason it is missing."""
    module = load_native()
    if module is None:
        raise RuntimeError(f"host extension unavailable: {_native_error}")
    return module


__all__ = ["BUILD_DIR", "BUILDS", "BuildError", "NATIVE", "build",
           "load_native", "nvcc_path", "require_native"]
