"""Loader for the route-churn core, `_emqx_torch_speedups`
(emqx_tpu_torch/native/speedups.cc; the counterpart of the reference's
ops/speedups.py).

The extension implements the route-churn hot loops (filter wildness
scan, split+intern encoding, class-index dedup bookkeeping, the
single-pair and batched add/delete legs) against the CPython C API,
mutating the SAME dicts/lists/sets/arrays the pure-Python twins use.
It is on by default: `load()` builds it with g++ at first use and
raises `NativeBuildError` when the build or the self-probe fails. Only
`set_native_enabled(False)` selects the Python twins (`load()` then
returns None); a Router reads the setting once, at construction."""

from __future__ import annotations

from .. import native
from ..native import NativeBuildError

__all__ = ["NativeBuildError", "load", "native_enabled", "set_native_enabled"]

_enabled = True
_probed = False


def set_native_enabled(flag: bool) -> None:
    """Select the native churn core (True, the default) or its Python
    twin (False) for routers built, and table/index batches run, from
    now on."""
    global _enabled
    _enabled = bool(flag)


def native_enabled() -> bool:
    return _enabled


def load():
    """The extension module, or None when the twin is selected."""
    global _probed
    if not _enabled:
        return None
    mod = native.load("_emqx_torch_speedups")
    if not _probed:
        # a miscompiled build must raise, not serve wrong answers
        if mod.wild_flags([("a/+", 0), ("a/b", 0)]) != [True, False]:
            raise NativeBuildError("_emqx_torch_speedups failed its wild_flags probe")
        _probed = True
    return mod
