"""Durable sessions over DS — emqx_persistent_session_ds analog (the
port's own copy of emqx_tpu/ds/session_ds.py).

Model mirrors the reference (apps/emqx/src/emqx_persistent_session_ds.erl
+ 16 helper modules): a durable session's subscriptions live in their
OWN route table (the ps-router,
emqx_persistent_session_ds_router.erl:60-148) — not the live router —
and the session consumes messages exclusively by iterating DS streams
(stream scheduler), never from live dispatch. The broker's publish
path persists any message matching a ps-route into the `messages` DB
(the emqx_persistent_message:persist gate, emqx_broker.erl:300-311).

Positions commit per stream batch: a batch's new position becomes
durable only once every QoS>0 message in it is acked — a crash replays
from the last committed position (at-least-once, the reference's
guarantee for QoS1; QoS2 holds via packet-id dedup while the session
lives).

State (subs, positions, cfg) persists in a `sessions` KV; sessions and
their routes survive broker restarts.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..broker.message import Message
from ..broker.packet import Publish, SubOpts
from ..broker.session import Session, SessionConfig
from ..ops import topic as topic_mod
from ..ops.host_index import TopicTrie
from .api import Db
from .kvstore import open_kv
from .storage import DsIterator, Stream


def _stream_id(s: Stream) -> str:
    return f"{s.shard}:{s.generation}:{s.static_key}:{'/'.join(s.constraints)}"


class _NullLock:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_LOCK = _NullLock()


@dataclass
class _StreamState:
    stream: Stream
    filter: str
    committed: bytes  # durable resume key
    inflight_pos: Optional[bytes] = None  # candidate position
    pending_pids: Set[int] = field(default_factory=set)


class DurableSession(Session):
    """Session whose delivery source is the DS stream scheduler."""

    def __init__(self, client_id: str, cfg: Optional[SessionConfig] = None, manager=None):
        super().__init__(client_id, cfg)
        self.manager = manager
        self.is_replica = False  # peer-replicated copy; owner decides expiry
        self._streams: Dict[str, _StreamState] = {}
        # pid -> stream id (for position commit on ack)
        self._pid_stream: Dict[int, str] = {}

    # --- ack overrides: commit stream positions -------------------------

    def _ack_commit(self, pid: int) -> None:
        mgr = self.manager
        lock = mgr._lock if mgr is not None else _NULL_LOCK
        with lock:
            sid = self._pid_stream.pop(pid, None)
            if sid is None:
                return
            st = self._streams.get(sid)
            if st is None:
                return
            st.pending_pids.discard(pid)
            if not st.pending_pids and st.inflight_pos is not None:
                st.committed = st.inflight_pos
                st.inflight_pos = None
                if mgr is not None:
                    mgr.save_session(self)

    def on_puback(self, pid: int) -> bool:
        ok = super().on_puback(pid)
        if ok:
            self._ack_commit(pid)
        return ok

    def on_pubcomp(self, pid: int) -> bool:
        ok = super().on_pubcomp(pid)
        if ok:
            self._ack_commit(pid)
        return ok

    def on_reconnect(self) -> List[Publish]:
        """Resume: mem-window replay first (same-process reconnect),
        then pull whatever accumulated in DS while offline."""
        out = super().on_reconnect()
        if self.manager is not None:
            out.extend(self.manager.pump(self))
        return out


class DurableSessionManager:
    """Owns the ps-router, the persist gate, session state store, and
    the stream scheduler."""

    def __init__(self, db: Db, state_dir: str = "data/ds", broker=None):
        import os
        import threading

        os.makedirs(state_dir, exist_ok=True)
        self.db = db
        self.broker = broker
        self.kv = open_kv(os.path.join(state_dir, "sessions.kv"))
        self.ps_router = TopicTrie()  # filter words -> client ids
        self.sessions: Dict[str, DurableSession] = {}
        # serializes pump/subscribe/ack across the DS buffer thread and
        # the caller thread; asyncio sessions are pumped ON their loop
        # via call_soon_threadsafe instead (see _on_new_data)
        self._lock = threading.RLock()
        # replication callbacks (set by a replication plane, which the
        # port does not have yet): session docs fan out to peers so a
        # durable session can resume on another node
        self.on_save = None  # fn(doc)
        self.on_discard = None  # fn(client_id)
        self._load_all()
        self.db.poll(self._on_new_data)

    # --- persist gate (emqx_persistent_message:persist) -----------------

    def install(self, hooks) -> None:
        hooks.add("message.publish", self._persist_gate, priority=40)

    def _persist_gate(self, msg, acc=None):
        m = msg if isinstance(msg, Message) else acc
        if isinstance(m, Message) and self.needs_persist(m.topic):
            self.db.store_async(m)
        return None

    def needs_persist(self, topic: str) -> bool:
        return bool(self.ps_router.match(topic_mod.words(topic)))

    # --- session lifecycle ---------------------------------------------

    def open_session(
        self, client_id: str, clean_start: bool, cfg: Optional[SessionConfig] = None
    ) -> Tuple[DurableSession, bool]:
        with self._lock:
            old = self.sessions.get(client_id)
            if clean_start or old is None or old.expired():
                if old is not None:
                    self.discard_session(client_id)
                s = DurableSession(client_id, cfg, manager=self)
                self.sessions[client_id] = s
                self.save_session(s)
                return s, False
            old.connected = True
            old.disconnected_at = None
            old.is_replica = False  # failover adoption: we own it now
            return old, True

    def discard_session(self, client_id: str) -> None:
        with self._lock:
            s = self.sessions.pop(client_id, None)
            if s is None:
                return
            for flt in list(s.subscriptions):
                self._del_route(flt, client_id)
            self.kv.delete(b"sess/" + client_id.encode())
            self.kv.flush()
        if self.on_discard is not None:
            self.on_discard(client_id)

    def subscribe(
        self, session: DurableSession, flt: str, opts: SubOpts
    ) -> bool:
        """Returns True if the subscription already existed (the
        retain_handling=1 decision needs this upstream)."""
        topic_mod.validate_filter(flt)
        with self._lock:
            existed = flt in session.subscriptions
            session.subscriptions[flt] = opts
            if not existed:
                try:
                    self.ps_router.insert(topic_mod.words(flt), session.client_id)
                except KeyError:
                    pass
                # attach streams starting from NOW (new subs don't
                # replay history, matching live-subscription semantics)
                self._attach_streams(session, flt, from_now=True)
            self.save_session(session)
            return existed

    def unsubscribe(self, session: DurableSession, flt: str) -> bool:
        with self._lock:
            if flt not in session.subscriptions:
                return False
            del session.subscriptions[flt]
            self._del_route(flt, session.client_id)
            dead = [sid for sid, st in session._streams.items() if st.filter == flt]
            for sid in dead:
                del session._streams[sid]
            self.save_session(session)
            return True

    def _del_route(self, flt: str, client_id: str) -> None:
        try:
            self.ps_router.remove(topic_mod.words(flt), client_id)
        except KeyError:
            pass

    # --- stream scheduler ----------------------------------------------

    def _attach_streams(self, session: DurableSession, flt: str, from_now: bool) -> None:
        for stream in self.db.get_streams(flt):
            sid = _stream_id(stream)
            if sid in session._streams:
                continue
            committed = b""
            if from_now:
                # skip already-stored history: position at current end
                shard = self.db.storage.shards[stream.shard]
                while True:
                    rows, last = shard.scan_stream(stream, flt, committed, 0, 500)
                    if not rows:
                        break
                    committed = last
            session._streams[sid] = _StreamState(stream, flt, committed)

    def _refresh_streams(self, session: DurableSession) -> None:
        """New static keys appear as the LTS learns; pick them up
        (the reference's renew_streams)."""
        for flt in session.subscriptions:
            if flt.startswith("$share/"):
                continue
            for stream in self.db.get_streams(flt):
                sid = _stream_id(stream)
                if sid not in session._streams:
                    session._streams[sid] = _StreamState(stream, flt, b"")

    def pump(self, session: DurableSession, batch_size: int = 100) -> List[Publish]:
        """Pull due messages from all streams through the session's
        QoS machinery; returns packets to send."""
        with self._lock:
            if not session.connected:
                return []
            self._refresh_streams(session)
            out: List[Publish] = []
            changed = False
            for sid, st in session._streams.items():
                if st.pending_pids:
                    continue  # previous batch not fully acked
                pos = st.inflight_pos or st.committed
                shard = self.db.storage.shards[st.stream.shard]
                rows, last = shard.scan_stream(st.stream, st.filter, pos, 0, batch_size)
                if not rows:
                    continue
                changed = True
                opts = session.subscriptions.get(st.filter) or SubOpts()
                batch_pids: Set[int] = set()
                for _k, msg in rows:
                    before = set(session.inflight.keys())
                    pkts = session.deliver(msg, opts)
                    out.extend(pkts)
                    for pid in set(session.inflight.keys()) - before:
                        batch_pids.add(pid)
                        session._pid_stream[pid] = sid
                if batch_pids:
                    st.inflight_pos = last
                    st.pending_pids = batch_pids
                else:
                    # all QoS0 → commit immediately
                    st.committed = last
            if changed:  # idle pumps must not fsync per tick
                self.save_session(session)
            return out

    def _on_new_data(self) -> None:
        """DS flush watcher (runs on the buffer thread): push to
        connected sessions' sinks. A session with no transport sink
        isn't pumped — data waits in DS (that's the durability point).
        Sessions attached to an asyncio connection are pumped ON their
        event loop (transports and Session state are not thread-safe);
        plain sessions are pumped here under the manager lock."""
        with self._lock:
            live = [
                s
                for s in list(self.sessions.values())
                if s.connected and getattr(s, "outgoing_sink", None) is not None
            ]
        for s in live:
            loop = getattr(s, "event_loop", None)
            if loop is not None:
                try:
                    loop.call_soon_threadsafe(self._pump_to_sink, s)
                except RuntimeError:
                    pass  # loop closed; next reconnect re-wires
            else:
                self._pump_to_sink(s)

    def _pump_to_sink(self, s: DurableSession) -> None:
        with self._lock:
            if not s.connected:
                return
            pkts = self.pump(s)
            sink = getattr(s, "outgoing_sink", None)
        if pkts and sink is not None:
            sink(pkts)

    # --- persistence ----------------------------------------------------

    def session_doc(self, s: DurableSession) -> dict:
        return {
            "client_id": s.client_id,
            "created_at": s.created_at,
            "expiry": s.cfg.session_expiry_interval,
            "subs": {f: {"qos": o.qos} for f, o in s.subscriptions.items()},
            "streams": {
                sid: {
                    "shard": st.stream.shard,
                    "gen": st.stream.generation,
                    "static": st.stream.static_key,
                    "constraints": list(st.stream.constraints),
                    "filter": st.filter,
                    "committed": st.committed.hex(),
                }
                for sid, st in s._streams.items()
            },
        }

    def save_session(self, s: DurableSession) -> None:
        doc = self.session_doc(s)
        self.kv.put(b"sess/" + s.client_id.encode(), json.dumps(doc).encode())
        self.kv.flush()
        if self.on_save is not None:
            self.on_save(doc)

    def _session_from_doc(self, doc: dict) -> DurableSession:
        cfg = SessionConfig(session_expiry_interval=doc["expiry"])
        s = DurableSession(doc["client_id"], cfg, manager=self)
        s.connected = False
        s.disconnected_at = time.time()
        for f, o in doc["subs"].items():
            s.subscriptions[f] = SubOpts(qos=o["qos"])
            try:
                self.ps_router.insert(topic_mod.words(f), s.client_id)
            except KeyError:
                pass
        for sid, sd in doc.get("streams", {}).items():
            stream = Stream(
                shard=sd["shard"],
                generation=sd["gen"],
                static_key=sd["static"],
                constraints=tuple(sd["constraints"]),
            )
            s._streams[sid] = _StreamState(
                stream, sd["filter"], bytes.fromhex(sd["committed"])
            )
        return s

    def adopt_doc(self, doc: dict) -> None:
        """Apply a replicated session doc from a peer (replica upsert).
        A session CONNECTED here is locally owned — a late/stale
        broadcast must not clobber it. Replicas are marked so the local
        GC never expires them (the OWNER decides expiry; a replica's
        disconnected_at is adoption time, not a real disconnect)."""
        with self._lock:
            cur = self.sessions.get(doc["client_id"])
            if cur is not None and cur.connected:
                return
            if cur is not None:
                for flt in list(cur.subscriptions):
                    self._del_route(flt, cur.client_id)
            s = self._session_from_doc(doc)
            s.is_replica = True
            self.sessions[s.client_id] = s
            self.kv.put(
                b"sess/" + s.client_id.encode(), json.dumps(doc).encode()
            )

    def drop_replica(self, client_id: str) -> None:
        """Apply a replicated discard (no re-broadcast). A session
        CONNECTED here is locally owned — ignore the stale delete."""
        with self._lock:
            s = self.sessions.get(client_id)
            if s is not None and s.connected:
                return
            self.sessions.pop(client_id, None)
            if s is not None:
                for flt in list(s.subscriptions):
                    self._del_route(flt, client_id)
            self.kv.delete(b"sess/" + client_id.encode())

    def _load_all(self) -> None:
        for k, v in self.kv.scan(b"sess/", b"sess0"):
            doc = json.loads(v)
            s = self._session_from_doc(doc)
            self.sessions[s.client_id] = s

    def gc(self) -> int:
        """Drop expired disconnected sessions (the reference's session
        GC worker). Replicas are exempt — only the owning node may
        expire a session (its discard then replicates as sess_del)."""
        dead = [
            cid
            for cid, s in self.sessions.items()
            if s.expired() and not getattr(s, "is_replica", False)
        ]
        for cid in dead:
            self.discard_session(cid)
        return len(dead)

    def recovery_report(self) -> dict:
        """What boot-side recovery rebuilt: sessions resumed from the
        state KV (at their committed positions — at-least-once) and
        the ps-routes re-inserted from their subscriptions."""
        with self._lock:
            return {
                "sessions": len(self.sessions),
                "ps_routes": sum(
                    len(s.subscriptions) for s in self.sessions.values()
                ),
                "streams": sum(
                    len(s._streams) for s in self.sessions.values()
                ),
            }

    def close(self) -> None:
        self.db.unpoll(self._on_new_data)
        self.kv.close()

    def kill(self) -> None:
        """Simulated SIGKILL: drop the sessions KV with no fsync
        boundary — positions not yet committed replay after reboot."""
        self.db.unpoll(self._on_new_data)
        self.kv.kill()
