"""Data backup: export/import of operator state — the
emqx_mgmt_data_backup analog.

Exports a tar.gz of JSON sections (config overrides, banned table,
API keys, rules, retained messages) with a manifest; import applies
sections additively and reports per-section counts + errors, like the
reference's export/import with a result summary
(apps/emqx_management/src/emqx_mgmt_data_backup.erl). The port's own
copy of emqx_tpu/mgmt/backup.py: the archive and its JSON sections are
the reference's, byte for byte, so an export of either package imports
into the other.
"""

from __future__ import annotations

import base64
import io
import json
import os
import tarfile
import time
from typing import Any, Dict, Optional

FORMAT_VERSION = 1


def _add_json(tar: tarfile.TarFile, name: str, obj: Any) -> None:
    data = json.dumps(obj, indent=1).encode()
    info = tarfile.TarInfo(name)
    info.size = len(data)
    info.mtime = int(time.time())
    tar.addfile(info, io.BytesIO(data))


def collect_sections(
    broker=None,
    config=None,
    rules=None,
    banned=None,
    api_keys=None,
    node_name: str = "emqx@127.0.0.1",
) -> Dict[str, Any]:
    """Snapshot live state into plain dicts. Runs ON the event loop —
    it reads live tables that the loop mutates; only the tar/gzip of
    the snapshot is safe to offload to a thread."""
    sections: Dict[str, Any] = {
        "META.json": {
            "version": FORMAT_VERSION,
            "node": node_name,
            "exported_at": time.time(),
        }
    }
    if config is not None:
        sections["config.json"] = getattr(config, "_overrides", {})
    if banned is not None:
        sections["banned.json"] = [
            {
                "as": e.who_type,
                "who": e.who,
                "by": e.by,
                "reason": e.reason,
                "until": e.until,
            }
            for e in banned.list()
        ]
    if api_keys is not None:
        sections["api_keys.json"] = api_keys.export_entries()
    if rules is not None:
        sections["rules.json"] = [
            {
                "id": rule.id,
                "sql": rule.sql,
                "actions": rule.actions,
                "enable": rule.enable,
                "description": rule.description,
            }
            for rule in rules.rules.values()
        ]
    if broker is not None:
        # snapshot MESSAGE REFS only on the loop (payload bytes are
        # immutable); the per-message base64/JSON shaping happens in
        # write_backup's thread — a 1M-entry encode must not stall it
        sections["_retained"] = list(broker.retainer.read("#"))
    return sections


def write_backup(out_dir: str, sections: Dict[str, Any]) -> str:
    """Tar+gzip a collected snapshot (thread-safe: touches no live
    state); returns the archive path."""
    os.makedirs(out_dir, exist_ok=True)
    sections = dict(sections)
    retained = sections.pop("_retained", None)
    if retained is not None:
        sections["retained.json"] = [
            {
                "topic": m.topic,
                "payload": base64.b64encode(m.payload).decode(),
                "qos": m.qos,
                "props": m.props,
            }
            for m in retained
        ]
    ts = time.strftime("%Y%m%d%H%M%S")
    path = os.path.join(out_dir, f"emqx-export-{ts}.tar.gz")
    with tarfile.open(path, "w:gz") as tar:
        for name, obj in sections.items():
            _add_json(tar, name, obj)
    return path


def export_backup(
    out_dir: str,
    broker=None,
    config=None,
    rules=None,
    banned=None,
    api_keys=None,
    node_name: str = "emqx@127.0.0.1",
) -> str:
    """Write emqx-export-<ts>.tar.gz into out_dir; returns the path."""
    return write_backup(
        out_dir,
        collect_sections(
            broker=broker, config=config, rules=rules, banned=banned,
            api_keys=api_keys, node_name=node_name,
        ),
    )


def _read_json(tar: tarfile.TarFile, name: str):
    try:
        f = tar.extractfile(name)
    except KeyError:
        return None
    return json.load(f) if f is not None else None


def read_sections(path: str) -> Dict[str, Any]:
    """Read+parse an archive (thread-safe: pure file IO)."""
    out: Dict[str, Any] = {}
    with tarfile.open(path) as tar:
        for name in (
            "META.json", "config.json", "banned.json", "api_keys.json",
            "rules.json", "retained.json",
        ):
            v = _read_json(tar, name)
            if v is not None:
                out[name] = v
    return out


def import_backup(
    path: str,
    broker=None,
    config=None,
    rules=None,
    banned=None,
    api_keys=None,
    sections: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Apply a backup additively; returns {section: imported_count,
    "errors": [...]}. Pass pre-read `sections` to apply ON the event
    loop after reading the archive off-loop."""
    report: Dict[str, Any] = {"errors": []}
    secs = sections if sections is not None else read_sections(path)
    meta = secs.get("META.json")
    if not meta or meta.get("version") != FORMAT_VERSION:
        raise ValueError("unsupported backup format")
    report["meta"] = meta
    conf = secs.get("config.json")
    if conf and config is not None:
        try:
            config.load_overrides(json.dumps(conf))
            report["config"] = len(conf)
        except Exception as e:  # noqa: BLE001
            report["errors"].append(f"config: {e}")
    for entry in secs.get("banned.json") or ():
        if banned is None:
            break
        try:
            dur = None
            if entry.get("until") is not None:
                dur = max(0.0, entry["until"] - time.time())
            banned.create(
                entry["as"], entry["who"], by=entry.get("by", "import"),
                reason=entry.get("reason", ""), duration_s=dur,
            )
            report["banned"] = report.get("banned", 0) + 1
        except Exception as e:  # noqa: BLE001
            report["errors"].append(f"banned {entry.get('who')}: {e}")
    for entry in secs.get("api_keys.json") or ():
        if api_keys is None:
            break
        try:
            api_keys.import_entry(entry)
            report["api_keys"] = report.get("api_keys", 0) + 1
        except Exception as e:  # noqa: BLE001
            report["errors"].append(f"api_key {entry.get('name')}: {e}")
    for entry in secs.get("rules.json") or ():
        if rules is None:
            break
        try:
            if entry["id"] in rules.rules:
                rules.delete_rule(entry["id"])
            rules.create_rule(
                entry["id"], entry["sql"], entry.get("actions") or [],
                enable=entry.get("enable", True),
                description=entry.get("description", ""),
            )
            report["rules"] = report.get("rules", 0) + 1
        except Exception as e:  # noqa: BLE001
            report["errors"].append(f"rule {entry.get('id')}: {e}")
    for entry in secs.get("retained.json") or ():
        if broker is None:
            break
        try:
            from ..broker.message import Message

            broker.retainer.retain(
                Message(
                    topic=entry["topic"],
                    payload=base64.b64decode(entry["payload"]),
                    qos=entry.get("qos", 0),
                    retain=True,
                    props=entry.get("props") or {},
                )
            )
            report["retained"] = report.get("retained", 0) + 1
        except Exception as e:  # noqa: BLE001
            report["errors"].append(f"retained {entry.get('topic')}: {e}")
    return report
