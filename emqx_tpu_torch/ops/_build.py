"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with `nvcc` for `sm_90a` into one
shared library with a plain C interface, loaded with `ctypes`. Builds
happen at first use (never at import), land in `build/emqx_tpu_torch/`
at the repository root, and are keyed by a hash of the source text, the
headers in `csrc/` and the flags, so an edited source rebuilds and an
unchanged one loads from disk. A missing `nvcc` or a failed build
raises: there is no fallback to the plain PyTorch versions.

Every entry point returns the `cudaGetLastError()` of its launches;
`CudaKernel.__call__` raises on a non-zero code and counts one launch
per successful call (`launches`), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emqx_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc_path() -> str:
    """The CUDA toolkit's nvcc: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def _start(source: str):
    """Start nvcc for `source` unless its library is already built;
    returns (process, command, temp path, final path) or None."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, cmd, tmp, out


def build(sources: Sequence[str]) -> None:
    """Compile every source not yet built, one nvcc per source, all
    started together."""
    started = [j for j in (_start(s) for s in sources) if j is not None]
    errors = []
    for proc, cmd, tmp, out in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
        else:
            # atomic: a concurrent loader sees all or nothing
            os.replace(tmp, out)
    if errors:
        raise KernelBuildError("\n".join(errors))


class CudaKernel:
    """One C entry point of one `csrc/*.cu` library. Loaded at first
    call; `launches` counts the successful calls."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: List) -> None:
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def load(self):
        if self._fn is None:
            build([self.source])
            lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            raise KernelLaunchError(
                f"{self.name}: CUDA error {rc} at launch"
            )
        self.launches += 1


# every kernel of the port, by name (filled as the kernel modules import)
KERNELS: Dict[str, CudaKernel] = {}


def build_all() -> None:
    """Compile every registered kernel's source in parallel and load
    each entry point."""
    build(sorted({k.source for k in KERNELS.values()}))
    for k in KERNELS.values():
        k.load()


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
