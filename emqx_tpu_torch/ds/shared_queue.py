"""Durable shared-subscription queues — the emqx_ds_shared_sub analog
(the port's own copy of emqx_tpu/ds/shared_queue.py).

A queue is a durable (group, topic_filter) consumer: matching messages
persist into DS through the same gate durable sessions use, and group
MEMBERS drain them cooperatively — each message goes to exactly one
member as QoS1, progress commits only when every message of a batch is
acked, and unacked work from a member that vanishes is redispatched to
the survivors. Queue state (streams + committed positions) persists in
the session KV, so consumption resumes across broker restarts — the
reference's durable queues (apps/emqx_ds_shared_sub/) built on the
leader/agent split; here the broker process IS the leader.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Dict, List, Optional, Tuple

from ..broker.message import Message
from ..broker.packet import SubOpts
from ..ops import topic as topic_mod
from .session_ds import _stream_id
from .storage import Stream

log = logging.getLogger("emqx_tpu_torch.ds.shared_queue")


class _QueueStream:
    def __init__(self, stream: Stream, committed: bytes = b""):
        self.stream = stream
        self.committed = committed
        self.inflight_pos: Optional[bytes] = None
        # msg key -> (client_id, packet_id) awaiting ack
        self.pending: Dict[bytes, Tuple[str, int]] = {}
        self.batch: Dict[bytes, Message] = {}  # keys of the open batch


class Queue:
    def __init__(self, group: str, flt: str):
        self.group = group
        self.filter = flt
        self.members: List[str] = []  # client ids, join order
        self._rr = 0
        self.streams: Dict[str, _QueueStream] = {}
        self.delivered = 0
        self.redispatched = 0

    @property
    def id(self) -> str:
        return f"{self.group}/{self.filter}"

    def next_member(self, sessions) -> Optional[str]:
        live = [
            c for c in self.members
            if (s := sessions.get(c)) is not None
            and getattr(s, "connected", False)
            and getattr(s, "outgoing_sink", None) is not None
        ]
        if not live:
            return None
        m = live[self._rr % len(live)]
        self._rr += 1
        return m


class SharedQueues:
    """The queue leader: owns declaration, membership, the drain pump,
    ack accounting, and persistence."""

    def __init__(self, manager, batch_size: int = 32):
        """manager: DurableSessionManager (provides db + kv + broker)."""
        self.manager = manager
        self.db = manager.db
        self.batch_size = batch_size
        self.queues: Dict[str, Queue] = {}
        # (client_id, packet_id) -> (queue id, stream id, msg key)
        self._acks: Dict[Tuple[str, int], Tuple[str, str, bytes]] = {}
        # serializes pump/ack/redispatch across the DS buffer thread
        # and the broker thread (same seam session_ds guards)
        self._lock = threading.RLock()
        self._load_all()
        self.db.poll(self._on_new_data)
        self._installed = False

    def install(self, hooks) -> None:
        if not self._installed:
            hooks.add("message.acked", self._on_acked)
            hooks.add("client.disconnected", self._on_member_down)
            self._installed = True

    # --- declaration / membership ---------------------------------------

    def declare(self, group: str, flt: str) -> Queue:
        topic_mod.validate_filter(flt)
        qid = f"{group}/{flt}"
        with self._lock:
            q = self.queues.get(qid)
            if q is None:
                q = Queue(group, flt)
                self.queues[qid] = q
                # route into the persist gate: matching publishes store
                try:
                    self.manager.ps_router.insert(
                        topic_mod.words(flt), f"$queue/{qid}"
                    )
                except KeyError:
                    pass
                self._save(q)
            return q

    def drop(self, group: str, flt: str) -> bool:
        with self._lock:
            q = self.queues.pop(f"{group}/{flt}", None)
            if q is None:
                return False
            # purge in-flight ack entries or they ghost until a member
            # happens to reuse the same packet id
            self._acks = {
                k: v for k, v in self._acks.items() if v[0] != q.id
            }
            try:
                self.manager.ps_router.remove(
                    topic_mod.words(q.filter), f"$queue/{q.id}"
                )
            except KeyError:
                pass
            self.manager.kv.delete(b"queue/" + q.id.encode())
            self.manager.kv.flush()
            return True

    def join(self, group: str, flt: str, session) -> Queue:
        q = self.declare(group, flt)
        with self._lock:
            if session.client_id not in q.members:
                q.members.append(session.client_id)
            self._pump_locked(q)
        return q

    def leave(self, group: str, flt: str, client_id: str) -> None:
        with self._lock:
            q = self.queues.get(f"{group}/{flt}")
            if q is None:
                return
            if client_id in q.members:
                q.members.remove(client_id)
            self._redispatch_member(q, client_id)

    def list(self) -> List[dict]:
        return [
            {
                "group": q.group,
                "topic": q.filter,
                "members": list(q.members),
                "delivered": q.delivered,
                "redispatched": q.redispatched,
            }
            for q in self.queues.values()
        ]

    # --- pump -------------------------------------------------------------

    def _refresh_streams(self, q: Queue) -> None:
        for stream in self.db.get_streams(q.filter):
            sid = _stream_id(stream)
            if sid not in q.streams:
                q.streams[sid] = _QueueStream(stream)

    def pump(self, q: Queue) -> int:
        """Drain due batches to members; returns deliveries made."""
        with self._lock:
            return self._pump_locked(q)

    def _pump_locked(self, q: Queue) -> int:
        self._refresh_streams(q)
        sessions = self.manager.broker.sessions if self.manager.broker else {}
        n = 0
        for sid, st in q.streams.items():
            if st.pending:
                continue  # batch open: wait for acks
            pos = st.inflight_pos or st.committed
            shard = self.db.storage.shards[st.stream.shard]
            rows, last = shard.scan_stream(
                st.stream, q.filter, pos, 0, self.batch_size
            )
            if not rows:
                continue
            # deliver IN ORDER and cut the batch at the first failure:
            # the commit target becomes the delivered PREFIX, so rows
            # nobody took stay beyond the position and rescan later —
            # never committed past (at-least-once)
            delivered_keys = []
            for key, msg in rows:
                if self._deliver_one(q, sid, st, key, msg, sessions) == 0:
                    break
                delivered_keys.append(key)
            n += len(delivered_keys)
            if not delivered_keys:
                st.inflight_pos = None
                st.batch = {}
                continue  # retry later
            prefix_end = delivered_keys[-1]
            st.batch = {
                k: m for k, m in rows if k <= prefix_end
            }
            st.inflight_pos = prefix_end
            if not st.pending:
                # every delivered row was an effective-QoS0 fire:
                # nothing to ack, the prefix commits now
                st.committed = prefix_end
                st.inflight_pos = None
                st.batch = {}
                self._save(q)
        return n

    def _deliver_one(self, q, sid, st, key, msg, sessions) -> int:
        # try each live member once: skip full inflight windows — a
        # QoS1 delivery that PARKS in the volatile mqueue allocates no
        # packet id, so the queue could never track (or redispatch) it
        for _ in range(max(1, len(q.members))):
            member = q.next_member(sessions)
            if member is None:
                return 0
            session = sessions[member]
            if len(session.inflight) >= session.cfg.receive_maximum:
                continue
            pkts = session.deliver(msg, SubOpts(qos=1))
            if not pkts:
                continue  # raced a disconnect (parked): next member
            pid = pkts[0].packet_id
            if pid is not None:
                st.pending[key] = (member, pid)
                self._acks[(member, pid)] = (q.id, sid, key)
            # pid None = the MESSAGE was QoS0 (eff qos min(0,1)=0):
            # fire-and-forget, commits with the prefix, no tracking
            sink = getattr(session, "outgoing_sink", None)
            if sink is not None:
                sink(pkts)
            q.delivered += 1
            return 1
        return 0

    # --- ack / failure accounting ----------------------------------------

    def _on_acked(self, client_id, pid, *extra) -> None:
        with self._lock:
            entry = self._acks.pop((client_id, pid), None)
            if entry is None:
                return
            qid, sid, key = entry
            q = self.queues.get(qid)
            if q is None:
                return
            st = q.streams.get(sid)
            if st is None:
                return
            st.pending.pop(key, None)
            if not st.pending and st.inflight_pos is not None:
                st.committed = st.inflight_pos
                st.inflight_pos = None
                st.batch = {}
                self._save(q)
                self._pump_locked(q)  # next batch immediately

    def _on_member_down(self, client_id, *extra) -> None:
        with self._lock:
            for q in self.queues.values():
                if client_id in q.members:
                    # keep membership (sessions may reconnect) but free
                    # its unacked work NOW — survivors take it over
                    self._redispatch_member(q, client_id)

    def _redispatch_member(self, q: Queue, client_id: str) -> None:
        """Caller holds self._lock."""
        sessions = self.manager.broker.sessions if self.manager.broker else {}
        for sid, st in q.streams.items():
            stale = [
                (key, entry)
                for key, entry in st.pending.items()
                if entry[0] == client_id
            ]
            for key, (member, pid) in stale:
                self._acks.pop((member, pid), None)
                del st.pending[key]
                msg = st.batch.get(key)
                if msg is None:
                    continue
                q.redispatched += 1
                if self._deliver_one(q, sid, st, key, msg, sessions) == 0:
                    # NO live member left: abandon the open batch so
                    # the next pump rescans from the COMMITTED position
                    # — silently skipping past undelivered QoS1 work
                    # would lose it (at-least-once: already-acked
                    # batch-mates may redeliver, never vanish)
                    for k2, (m2, p2) in list(st.pending.items()):
                        self._acks.pop((m2, p2), None)
                    st.pending.clear()
                    st.inflight_pos = None
                    st.batch = {}
                    break

    # --- data arrival -----------------------------------------------------

    def _on_new_data(self) -> None:
        for q in list(self.queues.values()):
            session = None
            for c in q.members:
                s = (self.manager.broker.sessions if self.manager.broker else {}).get(c)
                if s is not None and getattr(s, "event_loop", None) is not None:
                    session = s
                    break
            loop = getattr(session, "event_loop", None) if session else None
            if loop is not None:
                try:
                    loop.call_soon_threadsafe(self.pump, q)
                    continue
                except RuntimeError:
                    pass
            self.pump(q)

    # --- persistence ------------------------------------------------------

    def _save(self, q: Queue) -> None:
        doc = {
            "group": q.group,
            "filter": q.filter,
            "streams": {
                sid: {
                    "shard": st.stream.shard,
                    "gen": st.stream.generation,
                    "static": st.stream.static_key,
                    "constraints": list(st.stream.constraints),
                    "committed": st.committed.hex(),
                }
                for sid, st in q.streams.items()
            },
        }
        self.manager.kv.put(b"queue/" + q.id.encode(), json.dumps(doc).encode())
        self.manager.kv.flush()

    def _load_all(self) -> None:
        for _k, v in self.manager.kv.scan(b"queue/", b"queue0"):
            try:
                doc = json.loads(v)
            except ValueError:
                continue
            q = Queue(doc["group"], doc["filter"])
            for sid, sd in doc.get("streams", {}).items():
                stream = Stream(
                    shard=sd["shard"],
                    generation=sd["gen"],
                    static_key=sd["static"],
                    constraints=tuple(sd["constraints"]),
                )
                q.streams[sid] = _QueueStream(
                    stream, bytes.fromhex(sd["committed"])
                )
            self.queues[q.id] = q
            try:
                self.manager.ps_router.insert(
                    topic_mod.words(q.filter), f"$queue/{q.id}"
                )
            except KeyError:
                pass
