"""The broker core: subscribe/publish/dispatch over the Router
(counterpart of emqx_tpu/broker/pubsub.py for the port).

The single-node analog of the reference hot path
(apps/emqx/src/emqx_broker.erl): subscribe writes routes
(emqx_broker.erl:159-198), publish runs the 'message.publish' hook
fold, stores retained, matches routes, dedups destinations, and
dispatches to sessions (emqx_broker.erl:253-298, 726-760); shared
groups elect one member (emqx_shared_sub.erl:144-163).

Destinations in the Router are:
    client_id                 — a direct subscriber session
    ("$group", group, filter) — a shared-subscription group

Publish offers two paths:
  * publish()        — single-message cut-through via the host trie;
  * publish_batch()  — the device path: one batched match launch for
    the whole inbound batch, then the window dispatch.
Either way a fanout plan that misses the plan cache and clears
`_fanout_min_fan` resolves on the card (K5, ops/fanout.py).

Observability rides two None-seams, each one attribute read per
publish when unset: `tracer` (obs/otel.py) wraps a single publish in
`mqtt.publish` -> `broker.route` + `broker.dispatch` spans
(`_publish_traced`), and `sentinel` (obs/sentinel.py, attached by
obs.Observability) samples 1/N publishes: a sampled publish carries a
StageSpan through `_dispatch`, delivers through `_deliver_plan_timed`
(delivery-identical to `_deliver_plan`, with sub-stage clocks) and is
queued for the shadow-oracle audit.

Left out of the port for now: the durable-session tier and the rule
batcher. A device fault on a plan resolve serves the host walk
(counted, the breaker told); any other exception raises to the caller.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .. import framec
from ..chaos.faults import is_device_fault
from ..device import DeviceLike
from ..models.retainer import Retainer
from ..models.router import Router
from ..models.shared_sub import SharedSubs
from ..obs.profiler import STAGE_MARK
from ..ops import topic as topic_mod
from .caps import MqttCaps
from .hooks import Hooks
from .message import Message
from .metrics import Metrics, Stats
from .packet import Publish, SubOpts
from .session import Session

GROUP_DEST = "$group"

# subscribers per dispatch shard (ref: emqx_broker_helper.erl:60 — ≤1024
# subscribers on one topic dispatch inline, beyond that they shard)
FANOUT_SHARD = 1024

# exclusive subscriptions (ref: emqx_topic.erl:396-401 strips the
# prefix and flags is_exclusive; emqx_exclusive_subscription.erl claims)
EXCLUSIVE_PREFIX = "$exclusive/"


class ExclusiveTaken(Exception):
    """Another client holds the exclusive claim (-> RC 0x97)."""

# route match results flow through dispatch as (filter, dests) pairs;
# dests is a Dest -> refcount map owned by the Router
Pairs = Iterable[Tuple[str, Dict]]

# plans kept in the fanout cache before the oldest-inserted one evicts
FANOUT_CACHE_SIZE = 4096


class Broker:
    def __init__(
        self,
        max_levels: int = 16,
        shared_strategy: str = "random",
        hooks: Optional[Hooks] = None,
        device: DeviceLike = None,
        mesh=None,
    ):
        """`device` goes to the Router and the Retainer: None means the
        CUDA card (raising when none is present); "cpu" runs every
        kernel's plain version on the host. With `mesh` the router's
        table is sub-sharded across it (Router(mesh=...)) and the
        retainer sits on the mesh's first device."""
        self.router = Router(max_levels=max_levels, device=device, mesh=mesh)
        self.shared = SharedSubs(strategy=shared_strategy)
        self.retainer = Retainer(device=self.router.device)
        self.hooks = hooks or Hooks()
        self.metrics = Metrics()
        self.stats = Stats()
        self.sessions: Dict[str, Session] = {}
        # capability limits advertised/enforced (emqx_mqtt_caps)
        self.caps = MqttCaps()
        # exclusive-subscription claims: topic -> owning client
        # (emqx_exclusive_subscription mria set table)
        self.exclusive: Dict[str, str] = {}
        # fanout plans: matched-filter-set -> (build clock, prebuilt
        # deduped delivery lists) — the ?SUBSCRIBER-bag precomputation,
        # emqx_broker.erl:126-140. Invalidation is PER FILTER: every
        # session/subscription mutation stamps the touched filter with
        # the next clock tick, and a plan is stale only when one of ITS
        # matched filters carries a newer stamp — a subscribe on filter
        # A leaves every disjoint filter B's plan intact (the old
        # single global generation orphaned all 4096 plans broker-wide
        # on any mutation; under connect churn that meant continuous
        # 100k-entry rebuilds). Stamps persist for filters that leave —
        # deleting one would resurrect older plans referencing it.
        self._fanout_cache: Dict[tuple, tuple] = {}
        self._fanout_clock = 0
        self._filter_stamp: Dict[str, int] = {}
        # device-resolved fanout (ops/fanout.py): plan misses above
        # _fanout_min_fan dedup on device via the CSR dest store; below
        # it (or for host-resident filters) the Python walk is cheaper.
        self._fanout_min_fan = 1024
        self.router.dest_store.mem_class = Session
        self.router.fanout_opts_lookup = self._fanout_opts_lookup
        # (filter, client) subopts — mirror of ?SUBOPTION
        self.suboptions: Dict[Tuple[str, str], SubOpts] = {}
        # pipelined micro-batching dispatcher; attach with
        # enable_dispatch_engine() (broker/dispatch_engine.py)
        self.engine = None
        # live listeners (broker/server.py Server.start/stop)
        self.servers: list = []
        # external tracing seam (emqx_external_trace provider): None
        # costs one attribute check per publish
        self.tracer = None
        # publish sentinel (obs/sentinel.py): shadow-oracle audit +
        # per-stage latency attribution + SLO burn alarms. None is the
        # probe-free default — the engine pays one attribute read
        self.sentinel = None

    def enable_dispatch_engine(self, **kw):
        """Attach a DispatchEngine (pipelined async publish path):
        concurrent publishes coalesce into one kernel dispatch behind
        the generation-stamped match cache. Idempotent per broker —
        repeat calls replace the knobs by building a fresh engine."""
        from .dispatch_engine import DispatchEngine

        self.engine = DispatchEngine(self, **kw)
        return self.engine

    # --- session registry (emqx_cm-lite) --------------------------------

    def open_session(
        self, client_id: str, clean_start: bool, cfg=None
    ) -> Tuple[Session, bool]:
        """Returns (session, session_present). Clean start discards
        (emqx_cm:open_session:285-304)."""
        old = self.sessions.get(client_id)
        if clean_start or old is None or old.expired():
            if old is not None:
                self.close_session(old, discard=True)
            s = Session(client_id, cfg)
            self.sessions[client_id] = s
            self.router.dest_store.note_session(client_id, s)
            self.stats.set("sessions.count", len(self.sessions))
            self.hooks.run("session.created", client_id)
            return s, False
        old.connected = True
        self.hooks.run("session.resumed", client_id)
        return old, True

    def close_session(self, session: Session, discard: bool = False) -> None:
        """Drop a session and all its routes (emqx_broker:subscriber_down)."""
        # re-entrancy guard: an admin kick closes the transport, whose
        # teardown calls back in here — the second call must be a no-op
        # (no duplicate terminated/discarded hooks)
        if self.sessions.get(session.client_id) is not session:
            return
        # stale every plan that embeds this session: stamp each filter
        # it subscribed (per-filter, so unrelated plans survive)
        for flt in session.subscriptions:
            self._mark_fanout(topic_mod.parse_share(flt)[1])
        # sever the transport (admin kick / takeover); harmless if the
        # teardown originated from the connection itself
        closer = getattr(session, "closer", None)
        if closer is not None:
            try:
                closer()
            except Exception:
                pass
        # batch the direct-route deletes through Router.delete_routes —
        # session close IS the route-churn steady state at millions of
        # users; shared legs keep the per-filter group election
        cid = session.client_id
        pend_dels: List[Tuple[str, str]] = []
        for flt in list(session.subscriptions):
            group, real = topic_mod.parse_share(flt)
            if group is not None:
                if self.shared.unsubscribe(group, real, cid):
                    self.router.delete_route(
                        real, (GROUP_DEST, group, real)
                    )
            else:
                pend_dels.append((real, cid))
            self._release_exclusive(cid, flt)
            self.hooks.run("session.unsubscribed", cid, flt)
        if pend_dels:
            self.router.delete_routes(pend_dels)
        session.subscriptions.clear()
        self.sessions.pop(session.client_id, None)
        self.router.dest_store.note_session(session.client_id, None)
        self.stats.set("sessions.count", len(self.sessions))
        self.hooks.run(
            "session.discarded" if discard else "session.terminated",
            session.client_id,
        )

    # --- subscribe path --------------------------------------------------

    def subscribe(
        self,
        session: Session,
        flt: str,
        opts: SubOpts,
        retained_reader=None,
    ) -> List[Message]:
        """Register a subscription; returns retained messages to
        deliver (per retain_handling). `$exclusive/T` claims T for this
        client (raises ExclusiveTaken if another client holds it) and
        subscribes to the stripped topic, like the reference parse
        (emqx_topic.erl:396-401). `retained_reader` (real -> messages)
        lets a caller serve a whole SUBSCRIBE packet's retained lookups
        in one pass."""
        exclusive = flt.startswith(EXCLUSIVE_PREFIX)
        if exclusive:
            if not self.caps.exclusive_subscription:
                raise ValueError("exclusive subscriptions disabled")
            flt = flt[len(EXCLUSIVE_PREFIX):]
            if not flt:
                raise ValueError("empty exclusive topic")
        group, real = topic_mod.parse_share(flt)
        topic_mod.validate_filter(real)
        if exclusive:
            # claim only AFTER validation — a rejected subscribe must
            # not leave a claim nothing will ever release
            owner = self.exclusive.get(flt)
            if owner is not None and owner != session.client_id:
                raise ExclusiveTaken(flt)
            self.exclusive[flt] = session.client_id
        existed = flt in session.subscriptions
        session.subscriptions[flt] = opts
        self.suboptions[(flt, session.client_id)] = opts
        self._mark_fanout(real)
        if group is not None:
            if self.shared.subscribe(group, real, session.client_id):
                self.router.add_route(real, (GROUP_DEST, group, real))
        else:
            if not existed:
                self.router.add_route(real, session.client_id)
            # stamp the CSR edge with the live suboption (covers
            # resubscribe-with-new-QoS, which has no route transition)
            self.router.fanout_note_opts(real, session.client_id, opts, session)
        self.stats.set("subscriptions.count", len(self.suboptions))
        self.hooks.run("session.subscribed", session.client_id, flt, opts)
        # retained delivery: never for shared subs (MQTT-5 §4.8.2)
        if group is not None:
            return []
        if opts.retain_handling == 2 or (opts.retain_handling == 1 and existed):
            return []
        return self._read_retained(real, retained_reader)

    def _read_retained(self, real: str, reader=None) -> List[Message]:
        """Retained lookup for one just-registered filter: the
        channel's batched reader when a SUBSCRIBE-packet window is
        open, else the device halves at B=1, else the host trie."""
        if reader is not None:
            return reader(real)
        retainer = self.retainer
        if retainer.device_enabled:
            begun = retainer.retained_read_begin([real])
            return retainer.retained_read_finish(begun)[0]
        return retainer.read(real)

    def unsubscribe(self, session: Session, flt: str) -> bool:
        if flt.startswith(EXCLUSIVE_PREFIX):
            flt = flt[len(EXCLUSIVE_PREFIX):]
        if flt not in session.subscriptions:
            return False
        group, real = topic_mod.parse_share(flt)
        self._mark_fanout(real)
        self._release_exclusive(session.client_id, flt)
        del session.subscriptions[flt]
        self.suboptions.pop((flt, session.client_id), None)
        self._unsubscribe_route(session.client_id, flt)
        self.stats.set("subscriptions.count", len(self.suboptions))
        self.hooks.run("session.unsubscribed", session.client_id, flt)
        return True

    def _release_exclusive(self, client_id: str, flt: str) -> None:
        if self.exclusive.get(flt) == client_id:
            del self.exclusive[flt]

    def _unsubscribe_route(self, client_id: str, flt: str) -> None:
        group, real = topic_mod.parse_share(flt)
        if group is not None:
            if self.shared.unsubscribe(group, real, client_id):
                self.router.delete_route(real, (GROUP_DEST, group, real))
        else:
            self.router.delete_route(real, client_id)

    # --- publish path -----------------------------------------------------

    def publish(self, msg: Message) -> int:
        """Single-message cut-through (host trie). Returns deliveries.
        The fanout PLAN it executes may be device-resolved, so a sampled
        publish audits that plan (and feeds the deliver stage and the
        SLO). Unsampled cost: one attribute read; one counter tick when
        a sentinel is attached."""
        if self.tracer is not None:
            return self._publish_traced(msg)
        st = self.sentinel
        span = st.maybe_span(msg) if st is not None else None
        msg = self._pre_publish(msg)
        if msg is None:
            return 0
        if span is None:
            return self._dispatch(msg, self.router.match_pairs(msg.topic))
        clock = self.router.telemetry.clock
        gen = self.router.generation
        pairs = self.router.match_pairs(msg.topic)
        t0 = clock()
        n = self._dispatch(msg, pairs, span=span)
        span.add("deliver", clock() - t0)
        st.finish_span(span)
        st.capture_audit(
            msg.topic, tuple(f for f, _ in pairs), pairs, gen,
            span.trace_id,
        )
        return n

    def _publish_traced(self, msg: Message) -> int:
        """The external-trace leg (emqx_external_trace.erl:29-123 /
        emqx_otel_trace spans around route + dispatch); lives off the
        None-tracer hot path entirely."""
        from ..obs.otel import trace_id_of

        tr = self.tracer
        tid = trace_id_of(msg)
        root = tr.start_span("mqtt.publish", tid, None)
        root.set("mqtt.topic", msg.topic).set("mqtt.qos", msg.qos)
        if msg.from_client:
            root.set("mqtt.clientid", msg.from_client)
        try:
            out = self._pre_publish(msg)
            if out is None:
                root.set("mqtt.dropped", True)
                return 0
            rs = tr.start_span("broker.route", tid, root)
            pairs = self.router.match_pairs(out.topic)
            rs.set("broker.matched_filters", len(pairs))
            tr.finish(rs)
            ds = tr.start_span("broker.dispatch", tid, root)
            n = self._dispatch(out, pairs)
            ds.set("broker.deliveries", n)
            tr.finish(ds)
            root.set("mqtt.deliveries", n)
            return n
        finally:
            tr.finish(root)

    def publish_batch(self, msgs: Sequence[Message]) -> List[int]:
        """The device hot path: one batched match launch for the whole
        inbound publish batch, then the window dispatch. A device fault
        mid-batch fails over to the host walk (identical answers)
        instead of failing every coalesced publisher, and the attached
        engine's breaker hears about it — the same failure-domain
        contract as the pipelined engine, for the synchronous
        surface. Any other exception (a kernel that fails to build,
        a bug) raises to the caller."""
        live = [self._pre_publish(m) for m in msgs]
        topics = [m.topic for m in live if m is not None]
        router = self.router
        eng = self.engine
        try:
            filter_lists = router.match_filters_batch(topics)
        except Exception as e:
            if not is_device_fault(e):
                raise
            tel = router.telemetry
            if tel.enabled:
                tel.count("breaker_fallback_total", len(topics))
            if eng is not None:
                eng.note_device_failure(e)
            filter_lists = [router.match_filters(t) for t in topics]
        else:
            if eng is not None:
                eng.note_device_success()
        results, _meta = self.dispatch_window(live, filter_lists)
        return results

    def dispatch_window(
        self,
        lives: Sequence[Optional[Message]],
        filter_lists,
        spans: Optional[Sequence] = None,
        capture_errors: bool = False,
    ):
        """Batch-at-a-time dispatch of one coalesced window — the
        delivery half of the vectorized publish path (the engine's ring
        collect and publish_batch both land here):

          * ONE matched-filter resolution and ONE fanout-plan probe per
            unique filter set in the window, not per publish;
          * publishes sharing a plan deliver through the grouped window
            walk (_deliver_plan_window): shared-buffer writes grouped
            per SESSION across the window's messages, and each
            session's QoS bookkeeping batched into one ledger call
            (Session.deliver_many);
          * sampled publishes (spans[i] not None) take the per-publish
            timed walk at their window position, so the stage
            decomposition contract survives batching; per-topic
            delivery order is kept either way.

        `filter_lists` carries one matched-filter list per non-None
        live, in order (the match_filters_finish shape).  Returns
        (results, meta): results[i] is lives[i]'s delivery count (0
        where the hooks dropped it) or, when capture_errors, the
        exception that publish's future should fail with; meta[i] is
        (key, pairs) for the audit, shared across publishes that matched
        the same filter set. A failed run fails its publishers' results
        with the exception; nothing is served in its place."""
        fd = self.router.filter_dests
        results: List = [0] * len(lives)
        meta: List = [None] * len(lives)
        groups: Dict[tuple, List[int]] = {}
        pairs_by_key: Dict[tuple, list] = {}
        it = iter(filter_lists)
        for i, live in enumerate(lives):
            if live is None:
                continue
            flts = next(it)
            key = tuple(flts)
            g = groups.get(key)
            if g is None:
                pairs_by_key[key] = [(f, fd(f)) for f in key]
                groups[key] = g = []
            g.append(i)
            meta[i] = (key, pairs_by_key[key])
        clock = self.router.telemetry.clock
        for key, idxs in groups.items():
            pairs = pairs_by_key[key]
            # contiguous span-free publishes batch; a sampled publish
            # breaks the run so per-topic order survives
            runs: List[tuple] = []
            for i in idxs:
                if spans is not None and spans[i] is not None:
                    runs.append(("one", i))
                elif runs and runs[-1][0] == "batch":
                    runs[-1][1].append(i)
                else:
                    runs.append(("batch", [i]))
            for kind, val in runs:
                run = [val] if kind == "one" else val
                try:
                    if kind == "one":
                        span = spans[val]
                        t0 = clock()
                        results[val] = self._dispatch(lives[val], pairs, span=span)
                        span.add("deliver", clock() - t0)
                    elif len(val) == 1:
                        results[val[0]] = self._dispatch(lives[val[0]], pairs)
                    else:
                        self._dispatch_window_group(
                            [lives[i] for i in val], val, pairs, key, results
                        )
                except Exception as e:
                    if not capture_errors:
                        raise
                    for i in run:
                        results[i] = e
        return results, meta

    def _dispatch_window_group(
        self,
        msgs: List[Message],
        idxs: List[int],
        pairs: Pairs,
        key: tuple,
        results: List,
    ) -> None:
        """Deliver a run of window publishes that share one matched
        filter set: shared-group election stays per message (each
        message elects its own member), the fanout plan resolves ONCE,
        and the direct fan walks the window grouped by session."""
        tel = self.router.telemetry
        shared_counts = [
            self._dispatch_shared_local(m, pairs, key) for m in msgs
        ]
        entry = self._fanout_cache.get(key)
        if entry is not None and self._plan_entry_fresh(entry, key):
            if tel.enabled:
                tel.count("fanout_plan_hits", len(msgs))
            fast = self._entry_split(entry)
        else:
            # the first publish pays the miss; the rest of the window
            # would have hit — keep the counters per-publish-equivalent
            if tel.enabled:
                tel.count(
                    "fanout_plan_stale" if entry is not None
                    else "fanout_plan_misses"
                )
                if len(msgs) > 1:
                    tel.count("fanout_plan_hits", len(msgs) - 1)
            clock = self._fanout_clock
            plan = self._resolve_plan(key, pairs)
            fast = self._split_plan(plan)
            self._fanout_cache_put(key, entry, clock, plan, fast)
        counts = [0] * len(msgs)
        self._fanout_window(msgs, fast, counts)
        nd_total = 0
        for j, i in enumerate(idxs):
            nd = counts[j]
            nd_total += nd
            self._account_dispatch(msgs[j], shared_counts[j] + nd)
            results[i] = shared_counts[j] + nd
        if nd_total:
            self.metrics.inc("messages.delivered", nd_total)

    def _pre_publish(self, msg: Message) -> Optional[Message]:
        self.metrics.inc("messages.received")
        out = self.hooks.run_fold("message.publish", (), msg)
        if out is None or out.headers.get("allow_publish") is False:
            # a hook that intercepted the message (delayed-publish
            # store) is not a drop — it re-enters publish later
            if out is None or not out.headers.get("intercepted"):
                self.metrics.inc("messages.dropped")
                self.hooks.run("message.dropped", msg, "publish_denied")
            return None
        if out.retain:
            self.retainer.retain(out)
        return out

    def _dispatch(self, msg: Message, pairs: Pairs, span=None) -> int:
        # the matched-filter key is the cache identity for BOTH plan
        # families (shared legs + direct plan); build it once per
        # dispatch instead of once per consumer. A sampled publish
        # carries its StageSpan through here so the delivery walk
        # decomposes into DELIVERY_STAGES sub-stages; the span=None
        # path is the unsampled hot path unchanged.
        pairs = pairs if isinstance(pairs, list) else list(pairs)
        key = tuple(flt for flt, _ in pairs)
        if span is None:
            n = self._dispatch_shared_local(msg, pairs, key)
        else:
            clock = self.router.telemetry.clock
            t0 = clock()
            n = self._dispatch_shared_local(msg, pairs, key)
            # shared-group election rides the generic fan walk bucket
            span.add_sub("dispatch_loop", clock() - t0)
        nd = self._dispatch_direct(msg, pairs, key, span)
        if nd:
            self.metrics.inc("messages.delivered", nd)
        self._account_dispatch(msg, n + nd)
        return n + nd

    # --- fanout-plan cache (per-filter stamp invalidation) ---------------

    def _mark_fanout(self, real: str) -> None:
        """Stamp one (share-stripped) filter with the next clock tick:
        every cached plan whose matched set contains it is now stale;
        every other plan stays live."""
        self._fanout_clock += 1
        self._filter_stamp[real] = self._fanout_clock

    def _plan_entry_fresh(self, entry: tuple, filters) -> bool:
        """A plan built at entry's clock is stale only if one of ITS
        matched filters mutated since — len(filters) dict probes, not a
        global compare, so disjoint-filter churn never orphans it."""
        clock = entry[0]
        stamp = self._filter_stamp
        for f in filters:
            s = stamp.get(f)
            if s is not None and s > clock:
                return False
        return True

    def _plan_fresh(self, key: tuple) -> bool:
        """True when a current plan is cached for this filter set (the
        dispatch engine's probe before launching a device resolve)."""
        entry = self._fanout_cache.get(key)
        return entry is not None and self._plan_entry_fresh(entry, key)

    def _store_plan(self, key: tuple, clock: int, plan) -> None:
        self._fanout_cache_put(
            key, self._fanout_cache.get(key), clock, plan,
            self._split_plan(plan),
        )

    def _shared_group_dests(self, pairs: Pairs, key: tuple):
        """(group, real) legs in a match result. Cached per filter-set:
        scanning a 100k-dest fan for the (rare) group tuples on every
        publish cost more than the whole delivery loop."""
        skey = ("$shared", key)
        entry = self._fanout_cache.get(skey)
        if entry is not None and self._plan_entry_fresh(entry, key):
            return entry[1]
        clock = self._fanout_clock
        groups = []
        for _flt, dests in pairs:
            for dest in dests:
                if (
                    isinstance(dest, tuple)
                    and dest
                    and dest[0] == GROUP_DEST
                ):
                    groups.append((dest[1], dest[2]))
        self._fanout_cache_put(skey, entry, clock, groups)
        return groups

    def _fanout_cache_put(self, key, entry, clock, value, fast=None) -> None:
        """Insert a clock-stamped plan. A stale entry overwrites in
        place; at capacity ONE oldest-inserted entry evicts (O(1)
        FIFO) — never a wholesale clear. Direct-plan entries carry
        their derived broadcast split as a third element; shared-leg
        entries stay (clock, value)."""
        cache = self._fanout_cache
        if entry is None and len(cache) >= FANOUT_CACHE_SIZE:
            del cache[next(iter(cache))]
            tel = self.router.telemetry
            if tel.enabled:
                tel.count("fanout_plan_evictions_total")
        cache[key] = (clock, value) if fast is None else (clock, value, fast)

    def _account_dispatch(self, msg: Message, n: int) -> None:
        if n == 0:
            self.metrics.inc("messages.dropped.no_subscribers")
            self.hooks.run("message.dropped", msg, "no_subscribers")

    def _dispatch_shared_local(
        self, msg: Message, pairs: Pairs, key: tuple
    ) -> int:
        # snapshot via the cached plan: delivery hooks/sinks below may
        # (un)subscribe mid-iteration, which stamps the plan's filters
        # but leaves this list intact
        n = 0
        for group, real in self._shared_group_dests(pairs, key):
            # redispatch loop: a stale member (session gone) must not
            # eat the message — re-elect excluding it
            # (emqx_shared_sub:dispatch/4 retry + redispatch,
            # emqx_shared_sub.erl:149-163,217-244)
            tried: tuple = ()
            while True:
                member = self.shared.pick(
                    group,
                    real,
                    msg.topic,
                    from_client=msg.from_client,
                    exclude=tried,
                )
                if member is None:
                    break
                got = self._deliver_to(member, f"$share/{group}/{real}", msg)
                if got:
                    self.metrics.inc("messages.delivered", got)
                    n += got
                    break
                tried = tried + (member,)
        return n

    def _dispatch_direct(
        self, msg: Message, pairs: Pairs, key: tuple, span=None
    ) -> int:
        """Dedup direct destinations across matched filters (aggre/1,
        emqx_broker.erl:408-424): one delivery per client, max granted
        QoS wins — then execute a cached fanout PLAN. Identical
        filter-sets share one plan (keyed by matched filters, not the
        topic: a wildcard's whole topic space reuses it), stamped with
        the build clock and rebuilt lazily when one of ITS filters
        mutates — the precomputed ?SUBSCRIBER-bag read of
        emqx_broker.erl:726-760 rather than a per-publish suboption
        scan. Rebuilds above `_fanout_min_fan` run the device
        dedup/max-QoS kernel (ops/fanout.py); host-resident filter sets
        and small fans take the Python walk. Direct-plan cache entries
        carry a derived BROADCAST SPLIT (see _split_plan) built once
        per plan so the per-subscriber hot loop skips every
        per-delivery option test the plan already answers."""
        tel = self.router.telemetry
        t0 = tel.clock() if span is not None else 0.0
        entry = self._fanout_cache.get(key)
        if entry is not None and self._plan_entry_fresh(entry, key):
            if tel.enabled:
                tel.count("fanout_plan_hits")
            fast = self._entry_split(entry)
            if span is not None:
                span.add_sub("plan_resolve", tel.clock() - t0)
            return self._fanout(msg, fast, span)
        if tel.enabled:
            tel.count("fanout_plan_stale" if entry is not None
                      else "fanout_plan_misses")
        clock = self._fanout_clock
        plan = self._resolve_plan(key, pairs)
        fast = self._split_plan(plan)
        self._fanout_cache_put(key, entry, clock, plan, fast)
        if span is not None:
            span.add_sub("plan_resolve", tel.clock() - t0)
        return self._fanout(msg, fast, span)

    def _entry_split(self, entry: tuple) -> tuple:
        """A cached direct-plan entry's broadcast split. An entry
        written as (clock, plan) — a plan replaced in place, as the
        audit tests corrupt one — derives its split from the plan
        actually installed, so the served deliveries follow that plan
        and the audit judges it."""
        try:
            return entry[2]
        except IndexError:
            return self._split_plan(entry[1])

    @staticmethod
    def _split_plan(plan: tuple) -> tuple:
        """(bcast, rest, other): partition a plan's mem entries ONCE at
        build time into the trivially-broadcastable set — QoS 0 grant,
        no no_local, no retain-as-published, no QoS upgrade: their
        delivery is connected-check + shared-buffer write regardless of
        the message — and the rest, which keep the full per-delivery
        option walk. Everything that can invalidate the split
        (subscription/session mutations) already stamps the plan's
        filters, so the split lives exactly as long as its plan. The
        plan itself stays the oracle (mem, other) shape — audits and
        device/host equality checks never see the split."""
        mem, other = plan
        bcast = []
        rest = []
        for e in mem:
            opts = e[2]
            if (
                opts.qos == 0
                and not opts.no_local
                and not opts.retain_as_published
                and not e[1].cfg.upgrade_qos
            ):
                bcast.append(e)
            else:
                rest.append(e)
        return bcast, rest, other

    def _fanout_opts_lookup(self, flt: str, dest):
        """The CSR store's live-suboption seam (lazy segment rebuild):
        same reads as the oracle — suboptions for the word, sessions
        for the registry note."""
        opts = self.suboptions.get((flt, dest))
        if opts is None:
            return None
        return opts, self.sessions.get(dest)

    def _resolve_plan(self, key: tuple, pairs: Pairs) -> tuple:
        """Build the (mem, other) plan for a matched filter set — the
        device kernel when eligible, else the host oracle walk. The two
        are identical by contract (tests/test_torch_broker.py). A
        device fault on either half serves the host walk, counted, and
        the attached engine's breaker hears about the link; any other
        exception raises to the caller."""
        router = self.router
        tel = router.telemetry
        eng = self.engine
        try:
            handle = router.resolve_fanout_begin(key, min_fan=self._fanout_min_fan)
            if handle is not None:
                plan = router.resolve_fanout_finish(handle)
        except Exception as e:
            if not is_device_fault(e):
                raise
            if tel.enabled:
                tel.count("fanout_host_fallback_total")
            if eng is not None:
                eng.note_device_failure(e)
            return self._build_fanout_plan(pairs)
        if handle is None:
            return self._build_fanout_plan(pairs)
        if tel.enabled:
            tel.count("fanout_resolves_dispatch_total")
        if eng is not None:
            eng.note_device_success()
        return plan

    def _build_fanout_plan(self, pairs: Pairs) -> tuple:
        """(mem_entries, other_entries): mem = live in-memory sessions
        eligible for the shared-packet QoS0 fast loop; other = durable
        or exotic sessions that always take session.deliver. Entries
        carry the session OBJECT — any mutation that could stale it
        bumps the fanout generation, orphaning every older stamp."""
        best: Dict[str, Tuple[str, SubOpts]] = {}
        subopts = self.suboptions
        for flt, dests in pairs:
            for dest in tuple(dests):
                if isinstance(dest, tuple) and dest and dest[0] == GROUP_DEST:
                    continue  # shared legs handled by group election
                opts = subopts.get((flt, dest))
                if opts is None:
                    continue
                cur = best.get(dest)
                if cur is None or opts.qos > cur[1].qos:
                    best[dest] = (flt, opts)
        mem: list = []
        other: list = []
        for client, (flt, opts) in best.items():
            session = self.sessions.get(client)
            if session is None:
                continue
            if session.__class__ is Session:
                mem.append((client, session, opts))
            else:
                other.append((client, flt, opts))
        return mem, other

    def _fanout(self, msg: Message, fast: tuple, span=None) -> int:
        """Wide-fanout sharding (the 1024 rule) over a split plan
        (_split_plan's (bcast, rest, other)): shard 0 delivers inline;
        later shards are scheduled as separate event-loop turns so a
        100k-subscriber topic cannot stall the loop for one long
        dispatch (the reference parallelizes shards across broker-pool
        workers, emqx_broker.erl:643-672,753-760). Returns deliveries
        INITIATED — deferred shards count at plan time.

        A sampled publish (span) takes the TIMED inline shard
        (_deliver_plan_timed — delivery-identical, sub-stage accounting
        added) and stamps its fan size; deferred shards always run the
        plain loop (they execute outside the span's deliver wall, so
        timing them would break sum-to-wall)."""
        bcast, rest, other = fast
        total = len(bcast) + len(rest) + len(other)
        pkt_cache: Dict[bool, tuple] = {}  # retain -> (pkt, (pkt,))
        if span is not None:
            span.fan += total
        if total <= FANOUT_SHARD:
            if span is not None:
                return self._deliver_plan_timed(
                    msg, fast, 0, total, pkt_cache, span
                )
            return self._deliver_plan(msg, fast, 0, total, pkt_cache)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if span is not None:
            n = self._deliver_plan_timed(
                msg, fast, 0, FANOUT_SHARD, pkt_cache, span
            )
        else:
            n = self._deliver_plan(msg, fast, 0, FANOUT_SHARD, pkt_cache)
        for i in range(FANOUT_SHARD, total, FANOUT_SHARD):
            hi = min(i + FANOUT_SHARD, total)
            if loop is None:
                n += self._deliver_plan(msg, fast, i, hi, pkt_cache)
            else:
                loop.call_soon(
                    self._deliver_plan, msg, fast, i, hi, pkt_cache
                )
                n += hi - i
        return n

    def _fanout_window(
        self, msgs: List[Message], fast: tuple, counts: List[int]
    ) -> None:
        """_fanout's window twin: shard the SESSION axis — each shard
        delivers the whole window's messages to a slice of the fan, so
        shard size shrinks with window width to keep per-turn delivery
        work bounded by the same ~FANOUT_SHARD write budget. counts[j]
        accumulates msgs[j]'s deliveries; deferred shards credit at
        plan time, exactly like _fanout's `hi - i`."""
        bcast, rest, other = fast
        total = len(bcast) + len(rest) + len(other)
        W = len(msgs)
        wctx: dict = {}
        per_shard = max(1, FANOUT_SHARD // W)
        if total <= per_shard:
            self._deliver_plan_window(msgs, fast, 0, total, wctx, counts)
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        self._deliver_plan_window(msgs, fast, 0, per_shard, wctx, counts)
        for i in range(per_shard, total, per_shard):
            hi = min(i + per_shard, total)
            if loop is None:
                self._deliver_plan_window(msgs, fast, i, hi, wctx, counts)
            else:
                loop.call_soon(
                    self._deliver_plan_window, msgs, fast, i, hi, wctx
                )
                step = hi - i
                for j in range(W):
                    counts[j] += step

    def _deliver_plan_window(
        self,
        msgs: List[Message],
        fast: tuple,
        lo: int,
        hi: int,
        wctx: dict,
        counts: Optional[List[int]] = None,
    ) -> None:
        """_deliver_plan's window twin: deliver a WINDOW of messages to
        split-plan slice [lo, hi), grouped by session instead of by
        message. The broadcast leg serializes the whole window into ONE
        joined buffer per protocol version and lands it with ONE socket
        write per subscriber; sessions that need real QoS bookkeeping
        take ONE Session.deliver_many (one batched ledger reserve) for
        the window instead of W deliver calls. Per-session packet order
        is submission order — the same per-topic ordering contract as W
        sequential _deliver_plan walks. counts is None on deferred
        shards (already credited at plan time)."""
        bcast, rest, other = fast
        mark = STAGE_MARK
        mark.stage = "dispatch_loop"
        run_hook = self.hooks.has("message.delivered")
        hooks_run = self.hooks.run_unobserved
        W = len(msgs)
        nb = len(bcast)
        if lo < nb:
            mark.stage = "session_write"
            pkts0 = wctx.get("pkts0")
            if pkts0 is None:
                pkts0 = []
                for m in msgs:
                    p = Publish(
                        topic=m.topic,
                        payload=m.payload,
                        qos=0,
                        retain=False,
                        packet_id=None,
                        props=dict(m.props),
                    )
                    p._wire = {}  # opt into serialize memoization
                    pkts0.append(p)
                wctx["pkts0"] = pkts0
                wctx["ptuple0"] = tuple(pkts0)
            ptuple0 = wctx["ptuple0"]
            wget = wctx.get
            last_ver = None
            data = None
            hit = 0
            for client, s, opts in bcast[lo:min(hi, nb)]:
                if s.connected:
                    sb = s.outgoing_sink_bytes
                    if sb is not None:
                        ver = s.sink_proto_ver
                        if ver is not last_ver:
                            data = wget(("b0", ver))
                            if data is None:
                                data = b"".join(
                                    framec.serialize(p, ver) for p in pkts0
                                )
                                wctx[("b0", ver)] = data
                            last_ver = ver
                        if run_hook:
                            for m in msgs:
                                hooks_run("message.delivered", client, m)
                        sb(data)
                        hit += 1
                        continue
                    if run_hook:
                        for m in msgs:
                            hooks_run("message.delivered", client, m)
                    sink = s.outgoing_sink
                    if sink is not None:
                        sink(ptuple0)
                    hit += 1
                    continue
                # disconnected broadcast subscriber: one batched
                # offline-queue decision for the whole window
                packets = s.deliver_many([(m, opts) for m in msgs])
                if run_hook:
                    for m in msgs:
                        hooks_run("message.delivered", client, m)
                if packets:
                    sink = s.outgoing_sink
                    if sink is not None:
                        sink(packets)
                hit += 1
            if counts is not None and hit:
                for j in range(W):
                    counts[j] += hit
            mark.stage = "dispatch_loop"
        m_end = nb + len(rest)
        if hi > nb and lo < m_end:
            for client, s, opts in rest[max(lo - nb, 0):min(hi, m_end) - nb]:
                nl = opts.no_local
                items = []
                idx_js = []
                for j, m in enumerate(msgs):
                    if nl and m.from_client == client:
                        continue
                    items.append((m, opts))
                    idx_js.append(j)
                if not items:
                    continue
                packets = s.deliver_many(items)
                if run_hook:
                    for m, _o in items:
                        hooks_run("message.delivered", client, m)
                if packets:
                    sink = s.outgoing_sink
                    if sink is not None:
                        sink(packets)
                if counts is not None:
                    for j in idx_js:
                        counts[j] += 1
        if hi > m_end:
            sessions_get = self.sessions.get
            for client, _flt, opts in other[max(lo - m_end, 0):hi - m_end]:
                session = sessions_get(client)
                if session is None:
                    continue
                nl = opts.no_local
                for j, m in enumerate(msgs):
                    if nl and m.from_client == client:
                        continue
                    # durable/exotic sessions keep the per-message
                    # deliver: subclasses override it (persist gates)
                    packets = session.deliver(m, opts)
                    if run_hook:
                        hooks_run("message.delivered", client, m)
                    if packets:
                        sink = getattr(session, "outgoing_sink", None)
                        if sink is not None:
                            sink(packets)
                    if counts is not None:
                        counts[j] += 1
        mark.stage = ""

    def _shared_pkt(self, msg: Message, retain: bool, pkt_cache) -> tuple:
        pkt = Publish(
            topic=msg.topic,
            payload=msg.payload,
            qos=0,
            retain=retain,
            packet_id=None,
            props=dict(msg.props),
        )
        pkt._wire = {}  # opt into serialize memoization
        cached = (pkt, (pkt,))
        pkt_cache[retain] = cached
        return cached

    def _deliver_plan(
        self,
        msg: Message,
        fast: tuple,
        lo: int,
        hi: int,
        pkt_cache: Dict[bool, tuple],
    ) -> int:
        """Deliver split-plan slice [lo, hi). The broadcast leg is THE
        delivery hot loop at scale (fanout_100k: every delivery is a
        plain QoS0 subscriber) so it carries nothing per-subscriber
        but: connected check, sink read, shared-buffer write — the
        option tests (no_local/QoS/upgrade/retain-as-published) were
        answered once at plan-split time, and the wire bytes serialize
        once per protocol version for the WHOLE fanout
        (framec.serialize memoizes on the shared packet)."""
        bcast, rest, other = fast
        n = 0
        # profiler stage marks (obs/profiler.STAGE_MARK): one store per
        # LEG, read by the sampling thread to bucket stacks. The bcast
        # leg is serialize+socket-write by construction, so it samples
        # as session_write; the mixed legs sample as dispatch_loop.
        mark = STAGE_MARK
        mark.stage = "dispatch_loop"
        run_hook = self.hooks.has("message.delivered")
        # per-delivery hookpoints are untimed by contract (obs/
        # flight_recorder UNTIMED_HOOKPOINTS): the probe-free runner
        # keeps the recorder's cost off the per-subscriber loop
        hooks_run = self.hooks.run_unobserved
        fr = msg.from_client
        mq = msg.qos
        nb = len(bcast)
        if lo < nb:
            mark.stage = "session_write"
            cached = pkt_cache.get(False)
            if cached is None:
                cached = self._shared_pkt(msg, False, pkt_cache)
            pkt_tuple = cached[1]
            cache_get = pkt_cache.get
            last_ver = None
            data = None
            for client, s, opts in bcast[lo:min(hi, nb)]:
                if s.connected:
                    sb = s.outgoing_sink_bytes
                    if sb is not None:
                        # bytes fast path: one buffer per proto
                        # version, written to every socket; version
                        # runs are contiguous in practice so the
                        # common case is two attribute reads + a call
                        ver = s.sink_proto_ver
                        if ver is not last_ver:
                            data = cache_get((ver, False))
                            if data is None:
                                data = framec.serialize(cached[0], ver)
                                pkt_cache[(ver, False)] = data
                            last_ver = ver
                        if run_hook:
                            hooks_run("message.delivered", client, msg)
                        sb(data)
                        n += 1
                        continue
                    if run_hook:
                        hooks_run("message.delivered", client, msg)
                    sink = s.outgoing_sink
                    if sink is not None:
                        sink(pkt_tuple)
                    n += 1
                    continue
                # disconnected broadcast subscriber: the session's own
                # deliver decides (offline queue / expiry), same as the
                # generic leg
                packets = s.deliver(msg, opts)
                if run_hook:
                    hooks_run("message.delivered", client, msg)
                if packets:
                    sink = s.outgoing_sink
                    if sink is not None:
                        sink(packets)
                n += 1
            mark.stage = "dispatch_loop"
        m = nb + len(rest)
        if hi > nb and lo < m:
            for client, s, opts in rest[max(lo - nb, 0):min(hi, m) - nb]:
                if opts.no_local and fr == client:
                    continue
                if (
                    s.connected
                    and (mq == 0 or opts.qos == 0)
                    and not s.cfg.upgrade_qos
                ):
                    retain = msg.retain if opts.retain_as_published else False
                    cached = pkt_cache.get(retain)
                    if cached is None:
                        cached = self._shared_pkt(msg, retain, pkt_cache)
                    if run_hook:
                        hooks_run("message.delivered", client, msg)
                    sb = s.outgoing_sink_bytes
                    if sb is not None:
                        ver = s.sink_proto_ver
                        data = pkt_cache.get((ver, retain))
                        if data is None:
                            data = framec.serialize(cached[0], ver)
                            pkt_cache[(ver, retain)] = data
                        sb(data)
                    else:
                        sink = s.outgoing_sink
                        if sink is not None:
                            sink(cached[1])
                    n += 1
                    continue
                packets = s.deliver(msg, opts)
                if run_hook:
                    hooks_run("message.delivered", client, msg)
                if packets:
                    sink = s.outgoing_sink
                    if sink is not None:
                        sink(packets)
                n += 1
        if hi > m:
            for client, flt, opts in other[max(lo - m, 0):hi - m]:
                session = self.sessions.get(client)
                if session is None:
                    continue
                if opts.no_local and fr == client:
                    continue
                packets = session.deliver(msg, opts)
                if run_hook:
                    hooks_run("message.delivered", client, msg)
                if packets:
                    sink = getattr(session, "outgoing_sink", None)
                    if sink is not None:
                        sink(packets)
                n += 1
        mark.stage = ""
        return n

    def _deliver_plan_timed(
        self,
        msg: Message,
        fast: tuple,
        lo: int,
        hi: int,
        pkt_cache: Dict[bool, tuple],
        span,
    ) -> int:
        """_deliver_plan with sub-stage accounting, run ONLY for the
        inline shard of a sampled publish (1/sample_n) — the unsampled
        hot loop above stays untouched. Delivery semantics are
        mirror-identical by contract (tests/test_torch_obs.py drives
        both against the same plan and asserts identical sink output);
        the additions are clock pairs around the write calls
        (session_write: serialize + sink/socket writes) and the
        session.deliver calls (ack_sweep: QoS1/2 inflight
        bookkeeping), with dispatch_loop taking the residual of the
        measured leg wall — so the three sub-stages sum to this
        shard's wall exactly."""
        clock = self.router.telemetry.clock
        t_leg = clock()
        sw = 0.0  # session_write accumulator
        ack = 0.0  # ack_sweep accumulator
        bcast, rest, other = fast
        n = 0
        run_hook = self.hooks.has("message.delivered")
        hooks_run = self.hooks.run_unobserved
        fr = msg.from_client
        mq = msg.qos
        nb = len(bcast)
        if lo < nb:
            cached = pkt_cache.get(False)
            if cached is None:
                cached = self._shared_pkt(msg, False, pkt_cache)
            pkt_tuple = cached[1]
            cache_get = pkt_cache.get
            last_ver = None
            data = None
            for client, s, opts in bcast[lo:min(hi, nb)]:
                if s.connected:
                    sb = s.outgoing_sink_bytes
                    if sb is not None:
                        if run_hook:
                            hooks_run("message.delivered", client, msg)
                        t0 = clock()
                        ver = s.sink_proto_ver
                        if ver is not last_ver:
                            data = cache_get((ver, False))
                            if data is None:
                                data = framec.serialize(cached[0], ver)
                                pkt_cache[(ver, False)] = data
                            last_ver = ver
                        sb(data)
                        sw += clock() - t0
                        n += 1
                        continue
                    if run_hook:
                        hooks_run("message.delivered", client, msg)
                    sink = s.outgoing_sink
                    if sink is not None:
                        t0 = clock()
                        sink(pkt_tuple)
                        sw += clock() - t0
                    n += 1
                    continue
                t0 = clock()
                packets = s.deliver(msg, opts)
                ack += clock() - t0
                if run_hook:
                    hooks_run("message.delivered", client, msg)
                if packets:
                    sink = s.outgoing_sink
                    if sink is not None:
                        t0 = clock()
                        sink(packets)
                        sw += clock() - t0
                n += 1
        m = nb + len(rest)
        if hi > nb and lo < m:
            for client, s, opts in rest[max(lo - nb, 0):min(hi, m) - nb]:
                if opts.no_local and fr == client:
                    continue
                if (
                    s.connected
                    and (mq == 0 or opts.qos == 0)
                    and not s.cfg.upgrade_qos
                ):
                    retain = msg.retain if opts.retain_as_published else False
                    cached = pkt_cache.get(retain)
                    if cached is None:
                        cached = self._shared_pkt(msg, retain, pkt_cache)
                    if run_hook:
                        hooks_run("message.delivered", client, msg)
                    t0 = clock()
                    sb = s.outgoing_sink_bytes
                    if sb is not None:
                        ver = s.sink_proto_ver
                        data = pkt_cache.get((ver, retain))
                        if data is None:
                            data = framec.serialize(cached[0], ver)
                            pkt_cache[(ver, retain)] = data
                        sb(data)
                    else:
                        sink = s.outgoing_sink
                        if sink is not None:
                            sink(cached[1])
                    sw += clock() - t0
                    n += 1
                    continue
                t0 = clock()
                packets = s.deliver(msg, opts)
                ack += clock() - t0
                if run_hook:
                    hooks_run("message.delivered", client, msg)
                if packets:
                    sink = s.outgoing_sink
                    if sink is not None:
                        t0 = clock()
                        sink(packets)
                        sw += clock() - t0
                n += 1
        if hi > m:
            for client, flt, opts in other[max(lo - m, 0):hi - m]:
                session = self.sessions.get(client)
                if session is None:
                    continue
                if opts.no_local and fr == client:
                    continue
                t0 = clock()
                packets = session.deliver(msg, opts)
                ack += clock() - t0
                if run_hook:
                    hooks_run("message.delivered", client, msg)
                if packets:
                    sink = getattr(session, "outgoing_sink", None)
                    if sink is not None:
                        t0 = clock()
                        sink(packets)
                        sw += clock() - t0
                n += 1
        span.add_sub("session_write", sw)
        span.add_sub("ack_sweep", ack)
        span.add_sub(
            "dispatch_loop", max(0.0, clock() - t_leg - sw - ack)
        )
        return n

    def _deliver_to(
        self, client_id: str, share_filter: str, msg: Message
    ) -> int:
        """Shared-group leg: subopts key is the full $share filter."""
        session = self.sessions.get(client_id)
        if session is None:
            return 0
        opts = session.subscriptions.get(share_filter)
        if opts is None:
            return 0
        packets = session.deliver(msg, opts)
        self.hooks.run_unobserved("message.delivered", client_id, msg)
        if packets:
            sink = getattr(session, "outgoing_sink", None)
            if sink is not None:
                sink(packets)
        return 1
