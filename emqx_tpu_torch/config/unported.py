"""The config keys a node of the port refuses, because the subsystem
that serves them is not ported yet.

The reference's node serves every key of its schema. A port node
booted on the same config must never run open (an authentication
chain silently skipped) or differently (a cluster seed ignored), so
`check(cfg, n_cards)` raises `NotPortedError` for the first key whose
value is not its default-off, before any listener binds. Each error
names the key and the ROADMAP Queue 1 item that brings the subsystem:
item 8 the mesh and cluster layer, item 9 the remaining subsystems.
The management API serves the same check on its own writes
(`new_refusal`): a config update or a backup import that would turn a
refused key on answers 501 before anything is applied.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Tuple


class NotPortedError(RuntimeError):
    """A config key the port cannot serve yet."""

    def __init__(self, key: str, item: "int | str", what: str) -> None:
        super().__init__(
            f"{key}: {what} is not ported yet (ROADMAP Queue 1 item {item})"
        )
        self.key = key
        self.item = item


def _enabled(entry) -> bool:
    return isinstance(entry, dict) and entry.get("enable", True) is not False


def _plugins_enabled(install_dir: str) -> bool:
    """Whether the plugin manager's state file (plugins_state.json,
    the reference's format) has a plugin enabled at its next boot."""
    try:
        with open(os.path.join(install_dir, "plugins_state.json")) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return False
    return any(
        isinstance(st, dict) and st.get("enabled") for st in state.values()
    )


def refusals(cfg, n_cards: int) -> Iterator[Tuple[str, int, str]]:
    """(key, ROADMAP item, subsystem) for every refused key of `cfg`, in
    the reference's boot order."""
    if cfg.get("parallel.enable") and n_cards >= 2:
        yield ("parallel.enable", 8, "the multi-card mesh's admission")
    authz = cfg.get("authorization") or {}
    if any(_enabled(a) for a in cfg.get("authentication") or []):
        yield ("authentication", 9, "the authentication chain")
    if any(_enabled(s) for s in authz.get("sources") or []):
        yield ("authorization.sources", 9, "the authorization sources")
    if authz.get("no_match", "allow") != "allow":
        yield ("authorization.no_match", 9, "authorization")
    if cfg.get("file_transfer.enable"):
        yield ("file_transfer.enable", 9, "file transfer")
    if cfg.get("telemetry.enable"):
        yield ("telemetry.enable", 9, "telemetry")
    for rid, rconf in (cfg.get("rule_engine.rules") or {}).items():
        for action in rconf.get("actions") or []:
            kind = (
                action.get("function", action.get("type"))
                if isinstance(action, dict)
                else action
            )
            if kind == "bridge":
                yield (f"rule_engine.rules.{rid}.actions", 9, "the bridges")
    if cfg.get("cluster.static_seeds"):
        yield ("cluster.static_seeds", 8, "the cluster layer")
    if cfg.get("cluster.discovery_strategy") == "static":
        yield ("cluster.discovery_strategy", 8, "the cluster layer")
    if cfg.get("durable_storage.messages.backend") == "builtin_raft":
        yield (
            "durable_storage.messages.backend", 8, "DS replication",
        )
    if any(_enabled(c) for c in (cfg.get("listeners.quic") or {}).values()):
        yield ("listeners.quic", 9, "the QUIC listener")
    if cfg.get("psk_authentication.enable"):
        yield ("psk_authentication.enable", 9, "the TLS-PSK store")
    for ltype, by_name in (cfg.get("listeners") or {}).items():
        for name, lconf in (by_name or {}).items():
            if not _enabled(lconf):
                continue
            for key, what in (
                ("ssl_crl_check", "the CRL cache"),
                ("ssl_ocsp_enable", "the OCSP cache"),
            ):
                if lconf.get(key):
                    yield (f"listeners.{ltype}.{name}.{key}", 9, what)
    for gname, gconf in (cfg.get("gateway") or {}).items():
        if _enabled(gconf):
            yield (f"gateway.{gname}", 9, "the gateways")
    if cfg.get("cluster_link.enable"):
        yield ("cluster_link.enable", 9, "cluster links")
    if (cfg.get("license.key") or "default") != "default":
        yield ("license.key", 9, "license enforcement")
    install_dir = cfg.get("plugins.install_dir") or os.path.join(
        cfg.get("node.data_dir"), "plugins"
    )
    if _plugins_enabled(install_dir):
        yield ("plugins.install_dir", 9, "the plugin manager")


def check(cfg, n_cards: int) -> None:
    """Raise NotPortedError for the first refused key of `cfg`."""
    for key, item, what in refusals(cfg, n_cards):
        raise NotPortedError(key, item, what)


def new_refusal(cfg, candidate, n_cards: int):
    """The first refusal of the `candidate` config that `cfg` does not
    have already, as a NotPortedError, or None."""
    have = {key for key, _item, _what in refusals(cfg, n_cards)}
    for key, item, what in refusals(candidate, n_cards):
        if key not in have:
            return NotPortedError(key, item, what)
    return None
