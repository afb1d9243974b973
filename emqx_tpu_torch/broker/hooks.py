"""Hook registry — the in-process extension mechanism.

Parity with the reference's emqx_hooks (apps/emqx/src/emqx_hooks.erl):
named hookpoints hold priority-ordered callback chains;
`run` stops on 'stop', `run_fold` threads an accumulator which
callbacks may replace. Hookpoint names mirror
apps/emqx/src/emqx_hookpoints.erl:41-69 so reference plugins map 1:1.

The port's own copy of emqx_tpu/broker/hooks.py.
"""

from __future__ import annotations

import bisect
from time import perf_counter
from typing import Any, Callable, Dict, List, Tuple

# Canonical hookpoints (emqx_hookpoints.erl:41-69)
HOOKPOINTS = [
    "client.connect",
    "client.connack",
    "client.connected",
    "client.disconnected",
    "client.authenticate",
    "client.authorize",
    "client.check_authz_complete",
    "client.check_authn_complete",
    "client.subscribe",
    "client.unsubscribe",
    "client.timeout",
    "client.monitored_process_down",
    "session.created",
    "session.subscribed",
    "session.unsubscribed",
    "session.resumed",
    "session.discarded",
    "session.takenover",
    "session.terminated",
    "message.publish",
    "message.puback",
    "message.delivered",
    "message.acked",
    "message.dropped",
    "message.transformation_failed",
    "schema.validation_failed",
    "delivery.dropped",
]

STOP = object()  # callback return: halt the chain (emqx_hooks 'stop')
OK = None  # continue


class Hooks:
    """Priority-ordered callback chains per hookpoint."""

    def __init__(self, strict: bool = True) -> None:
        self._hooks: Dict[str, List[Tuple[int, int, Callable]]] = {}
        self._seq = 0
        self._strict = strict
        # observability seam: per-hookpoint observers
        # fn(hookpoint, seconds, subject) called after a NON-EMPTY
        # chain run with the chain's wall time and its primary
        # argument (the flight recorder's hook tap). An empty dict —
        # the default — costs one truthiness check per run; a
        # hookpoint without an observer pays one dict probe. Keeping
        # the registration per-point lets the recorder skip the
        # per-delivery points (message.delivered/acked/puback) whose
        # call rate would otherwise dominate the timing cost.
        self.observers: Dict[str, Callable[[str, float, Any], None]] = {}
        # cb -> slow marker (bool, or zero-arg callable evaluated at
        # query time so a chain can become slow when e.g. a network
        # authz source is added after registration)
        self._slow: Dict[str, List[Tuple[Callable, Any]]] = {}

    def _check(self, name: str) -> None:
        if self._strict and name not in HOOKPOINTS:
            raise KeyError(f"unknown hookpoint {name!r}")

    def add(self, name: str, cb: Callable, priority: int = 0, slow: Any = False) -> None:
        """Register; higher priority runs first (emqx_hooks.erl:63-70
        sorts descending, ties keep registration order). `slow` marks a
        callback that may block on I/O (network authz source, out-of-
        proc exhook) — connection loops consult `has_slow` to decide
        whether the chain must run off the event loop."""
        self._check(name)
        chain = self._hooks.setdefault(name, [])
        self._seq += 1
        # sort key: -priority then insertion order
        entry = (-priority, self._seq, cb)
        bisect.insort(chain, entry, key=lambda e: (e[0], e[1]))
        # bisect.insort with key keeps chain sorted
        if slow:
            self._slow.setdefault(name, []).append((cb, slow))

    def delete(self, name: str, cb: Callable) -> None:
        # equality, not identity: `self._method` builds a FRESH bound-
        # method object on every attribute access, so `is` would never
        # match the one stored at add() time (== compares __self__ and
        # __func__; for plain functions it degrades to identity)
        chain = self._hooks.get(name, [])
        self._hooks[name] = [e for e in chain if e[2] != cb]
        if name in self._slow:
            self._slow[name] = [e for e in self._slow[name] if e[0] != cb]

    def has(self, name: str) -> bool:
        """True when any callback is registered (lets hot loops hoist
        the per-delivery chain walk; emqx runs chains unconditionally
        but BEAM call overhead is not Python call overhead)."""
        return bool(self._hooks.get(name))

    def has_slow(self, name: str) -> bool:
        """True when any registered callback may block on I/O."""
        for _cb, marker in self._slow.get(name, ()):
            if marker is True or (callable(marker) and marker()):
                return True
        return False

    def run(self, name: str, *args: Any) -> bool:
        """Run the chain; returns False if a callback returned STOP."""
        chain = self._hooks.get(name)
        if not chain:
            return True
        obs = self.observers.get(name) if self.observers else None
        if obs is None:
            for _, _, cb in chain:
                if cb(*args) is STOP:
                    return False
            return True
        ok = True
        t0 = perf_counter()
        try:
            for _, _, cb in chain:
                if cb(*args) is STOP:
                    ok = False
                    break
        finally:
            obs(name, perf_counter() - t0, args[0] if args else None)
        return ok

    def run_unobserved(self, name: str, *args: Any) -> bool:
        """run() minus the observer probe, for per-delivery hookpoints
        (message.delivered and friends — flight_recorder's
        UNTIMED_HOOKPOINTS): wide-fanout loops call the chain once PER
        DELIVERY, where even a ~100ns dict probe busts the recorder's
        <2% enabled-path budget. Semantically identical to run() for
        any hookpoint that never gets an observer."""
        for _, _, cb in self._hooks.get(name, ()):
            if cb(*args) is STOP:
                return False
        return True

    def run_fold(self, name: str, args: Tuple, acc: Any) -> Any:
        """Fold the accumulator through the chain. Callbacks receive
        (*args, acc) and return None (keep), (STOP, acc'), or acc'."""
        chain = self._hooks.get(name)
        if not chain:
            return acc
        obs = self.observers.get(name) if self.observers else None
        if obs is None:
            return self._fold(chain, args, acc)
        # the fold subject: message.publish passes the message as the
        # ACCUMULATOR (args empty), so fall back to it for correlation
        subject = args[0] if args else acc
        t0 = perf_counter()
        try:
            return self._fold(chain, args, acc)
        finally:
            obs(name, perf_counter() - t0, subject)

    @staticmethod
    def _fold(chain, args: Tuple, acc: Any) -> Any:
        for _, _, cb in chain:
            r = cb(*args, acc)
            if r is None:
                continue
            if isinstance(r, tuple) and len(r) == 2 and r[0] is STOP:
                return r[1]
            acc = r
        return acc
