"""Build and load the port's native host cores.

Two CPython extensions, compiled from the sources in this directory:

  * `_emqx_torch_speedups` (speedups.cc): the route-churn core
    (`wild_flags`, `encode_filters`, `index_dedup`, the churn handle and
    the add/delete legs) and the delivery ledger (`delivery_*`);
  * `_emqx_torch_frame` (frame.cc): the MQTT frame codec's hot surface.

Each builds with `g++ -O2 -std=c++17 -fPIC -shared` against the running
interpreter's headers (`sysconfig.get_paths()["include"]`) at first use,
never at import, into `build/emqx_tpu_torch/native/` at the repository
root. An output is keyed by a hash of its source, the flags, the
compiler and the interpreter, and lands through an atomic `os.replace`;
a file lock makes concurrent processes (pytest-xdist workers) build a
source once and share it. A missing compiler or `Python.h`, a failed
build or a failed import raises `NativeBuildError`: nothing falls back
to the Python twins. Only the `set_native_enabled` setters of
`ops/speedups.py`, `broker/delivery.py` and `framec.py` select a twin.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Dict, Sequence

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emqx_tpu_torch" / "native"
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

# module name -> source file
SOURCES: Dict[str, str] = {
    "_emqx_torch_speedups": "speedups.cc",
    "_emqx_torch_frame": "frame.cc",
}

# seconds each build took in this process (0.0 when the output was on disk)
BUILD_SECONDS: Dict[str, float] = {}

_loaded: Dict[str, object] = {}


class NativeBuildError(RuntimeError):
    pass


def compiler() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise NativeBuildError(f"C++ compiler {CXX!r} not found")
    return path


def include_dir() -> str:
    inc = sysconfig.get_paths()["include"]
    if not os.path.isfile(os.path.join(inc, "Python.h")):
        raise NativeBuildError(f"Python.h not found in {inc}")
    return inc


def compiler_version() -> str:
    out = subprocess.run([compiler(), "--version"], capture_output=True, text=True)
    return out.stdout.splitlines()[0] if out.stdout else "unknown"


def _digest(source: str, cxx: str, inc: str) -> str:
    h = hashlib.sha256()
    h.update((SRC / source).read_bytes())
    h.update(" ".join((cxx, *CXX_FLAGS, inc, sys.version)).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    cxx, inc = compiler(), include_dir()
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"{name}-{_digest(SOURCES[name], cxx, inc)}{suffix}"


def build(names: Sequence[str]) -> None:
    """Compile every named extension not yet on disk, one g++ per
    source, all started together, under a lock so that a concurrent
    process waits for the output instead of building it again."""
    cxx, inc = compiler(), include_dir()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = []
        for name in names:
            out = library_path(name)
            if out.exists():
                BUILD_SECONDS.setdefault(name, 0.0)
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, f"-I{inc}", "-o", str(tmp), str(SRC / SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((name, proc, cmd, tmp, out, time.perf_counter()))
        errors = []
        for name, proc, cmd, tmp, out, t0 in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a loader sees all or nothing
                BUILD_SECONDS[name] = time.perf_counter() - t0
    if errors:
        raise NativeBuildError("\n".join(errors))


def load(name: str):
    """The extension module `name` (a key of SOURCES), built if needed
    and imported once per process."""
    mod = _loaded.get(name)
    if mod is not None:
        return mod
    build([name])
    path = str(library_path(name))
    try:
        loader = importlib.machinery.ExtensionFileLoader(name, path)
        spec = importlib.util.spec_from_file_location(name, path, loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except ImportError as e:  # a foreign ABI, a missing symbol
        raise NativeBuildError(f"{name}: import of {path} failed: {e}") from e
    _loaded[name] = mod
    return mod


def build_all() -> Dict[str, float]:
    """Build and import both extensions; returns the seconds each build
    took (0.0 where the output was already on disk)."""
    build(sorted(SOURCES))
    for name in SOURCES:
        load(name)
    return {name: BUILD_SECONDS.get(name, 0.0) for name in SOURCES}
