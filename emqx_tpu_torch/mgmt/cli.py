"""`emqx ctl` analog: a command registry + dispatcher
(apps/emqx_ctl/src/emqx_ctl.erl registry; command impls from
apps/emqx_management/src/emqx_mgmt_cli.erl).

Commands take (ctl, args) and return output text. Unknown commands and
`help` print usage, like `emqx ctl` with no args lists all commands.

The port's own copy of emqx_tpu/mgmt/cli.py: each command prints the
reference's text for the same argv and state. `plugins`, `gateways`
and `license` run over subsystems the port has not ported yet; each
prints one `error:` line naming its ROADMAP Queue 1 item (9b.8, 9b.5,
9b.7), from the `NotPortedError` it raises.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Tuple

from ..broker.message import Message
from ..broker.packet import SubOpts
from ..config.unported import NotPortedError
from . import views


class Ctl:
    def __init__(
        self,
        broker,
        config=None,
        rules=None,
        banned=None,
        node_name: str = "emqx@127.0.0.1",
        listeners=None,
        obs=None,
    ):
        self.broker = broker
        self.config = config
        self.rules = rules
        self.banned = banned
        self.node_name = node_name
        self.listeners = listeners
        self.obs = obs
        self.started_at = time.time()
        self._cmds: Dict[str, Tuple[Callable, str]] = {}
        self._register_builtin()

    def register(self, name: str, fn: Callable, usage: str) -> None:
        """Plugin seam: apps register their own ctl commands
        (emqx_ctl:register_command)."""
        self._cmds[name] = (fn, usage)

    def unregister(self, name: str) -> None:
        self._cmds.pop(name, None)

    def run(self, argv: List[str]) -> str:
        if not argv or argv[0] in ("help", "--help"):
            lines = ["Usage: ctl <command> [args...]", ""]
            for name in sorted(self._cmds):
                lines.append(f"  {self._cmds[name][1]}")
            return "\n".join(lines)
        name, *args = argv
        ent = self._cmds.get(name)
        if ent is None:
            return f"unknown command: {name!r} (try 'help')"
        try:
            return ent[0](args)
        except NotPortedError as e:
            return f"error: {e}"
        except (IndexError, KeyError, ValueError) as e:
            return f"error: {e}\nusage: {ent[1]}"

    # --- builtin commands -------------------------------------------------

    def _register_builtin(self) -> None:
        reg = self.register
        reg("status", self._status, "status                  # broker status")
        reg("broker", self._broker, "broker                  # broker overview")
        reg("metrics", self._metrics, "metrics                 # all counters")
        reg("stats", self._stats, "stats                   # all gauges")
        reg("cluster", self._cluster, "cluster status          # membership view")
        reg(
            "clients",
            self._clients,
            "clients list | show <clientid> | kick <clientid>",
        )
        reg(
            "subscriptions",
            self._subscriptions,
            "subscriptions list | show <clientid> | add <clientid> <topic> <qos>"
            " | del <clientid> <topic>",
        )
        reg("topics", self._topics, "topics list | show <topic>")
        reg("publish", self._publish, "publish <topic> <payload> [qos] [retain]")
        reg(
            "retainer",
            self._retainer,
            "retainer info | topics | clean [topic]",
        )
        reg("rules", self._rules, "rules list | show <id> | delete <id>")
        reg(
            "banned",
            self._banned,
            "banned list | add <as> <who> [seconds] | del <as> <who>",
        )
        reg(
            "plugins",
            self._plugins,
            "plugins list | start <name> | stop <name>",
        )
        reg("gateways", self._gateways, "gateways list")
        reg("listeners", self._listeners, "listeners               # active listeners")
        reg("license", self._license, "license info | update <key>")
        reg(
            "flight",
            self._flight,
            "flight status | events [n] | snapshot [reason] | snapshots",
        )
        reg(
            "sentinel",
            self._sentinel,
            "sentinel status | audit | slo | stages | exemplars",
        )
        reg(
            "profile",
            self._profile,
            "profile status | start | stop | arm [s] | stacks [stage] "
            "| collapsed [stage] | lag",
        )
        reg(
            "mesh",
            self._mesh,
            "mesh scope              # per-dispatch mesh decomposition",
        )

    def _mesh(self, args) -> str:
        """emqx ctl mesh — the mesh microscope (obs/mesh_scope.py):
        per-dispatch stage decomposition, collective-cost ledger,
        per-chip occupancy."""
        scope = getattr(
            getattr(self.broker.router, "device_table", None), "scope", None
        )
        if scope is None:
            return "mesh scope not attached (tpu_mesh_scope_enable)"
        sub = args[0] if args else "scope"
        if sub != "scope":
            raise ValueError(f"bad subcommand {sub!r}")
        st = scope.status()
        d = st["decomp"]
        lines = [
            f"{'dispatches':<22}: {st['dispatches']} "
            f"(1/{st['sample_n']} sampled, {st['splits_sampled']} splits, "
            f"{st['split_skipped']} skipped)",
            f"{'decomp in-band':<22}: {d['in_band']}/"
            f"{d['in_band'] + d['out_of_band']} "
            f"(tol {d['tolerance']:g}, last ratio {d['last_ratio']})",
        ]
        for nchips, stages in st["stages"].items():
            wall = st["wall"][nchips]
            lines.append(
                f"nchips={nchips}  wall p50/p99 ms: "
                f"{wall['p50_ms']} / {wall['p99_ms']}  "
                f"(stage/wall {st['stage_wall_ratio'][nchips]})"
            )
            for stage, h in stages.items():
                lines.append(
                    f"  {stage:<20}: p50 {h['p50_ms']}ms  "
                    f"p99 {h['p99_ms']}ms  n={h['count']}"
                )
        c = st["collective"]
        lines.append(
            f"{'gather bytes':<22}: {c['gather_bytes_total']} total "
            f"({c['gather_bytes_last']} last)"
        )
        lines.append(
            f"{'occupancy last':<22}: {c['occupancy_last']}"
        )
        if st["shard_skew"] is not None:
            sk = st["shard_skew"]
            lines.append(
                f"{'shard skew hits':<22}: min {sk['min']} / "
                f"med {sk['median']} / max {sk['max']}"
            )
        for chip, ratio in st["chips"].items():
            lines.append(f"{'  chip ' + chip:<22}: busy {ratio}")
        return "\n".join(lines)

    def _profile(self, args) -> str:
        """emqx ctl profile — the delivery-path microscope
        (obs/profiler.py): continuous sampling profiler control, top
        stacks per delivery sub-stage, collapsed flamegraph text, and
        the event-loop lag ticker."""
        prof = getattr(self.obs, "profiler", None) if self.obs else None
        if prof is None:
            return "profiler not wired"
        sub = args[0] if args else "status"
        if sub == "status":
            st = prof.status()
            lines = [
                f"{'running':<22}: {st['running']} ({st['hz']:g} Hz)",
                f"{'samples':<22}: {st['samples_total']} wall / "
                f"{st['cpu_samples_total']} cpu",
                f"{'unique stacks':<22}: {st['unique_stacks']} "
                f"(overflow {st['overflow_total']})",
                f"{'arms':<22}: {st['arms_total']}",
            ]
            for stage, n in st["stage_samples"].items():
                lines.append(f"{'  stage ' + stage:<22}: {n}")
            return "\n".join(lines)
        if sub == "start":
            return "started" if prof.start() else "already running"
        if sub == "stop":
            prof.stop()
            return "stopped"
        if sub == "arm":
            seconds = float(args[1]) if len(args) > 1 else 10.0
            prof.arm_for(seconds)
            return f"armed for {seconds:g}s"
        if sub == "stacks":
            stage = args[1] if len(args) > 1 else None
            rows = prof.top_stacks(stage=stage, n=10)
            if not rows:
                return "(no samples)"
            out = []
            for r in rows:
                out.append(
                    f"[{r['stage'] or 'other'}] wall={r['wall_samples']} "
                    f"cpu={r['cpu_samples']}"
                )
                out.append("    " + " <- ".join(reversed(r["stack"])))
            return "\n".join(out)
        if sub == "collapsed":
            stage = args[1] if len(args) > 1 else None
            return prof.collapsed(stage=stage) or "(no samples)"
        if sub == "lag":
            ll = getattr(self.obs, "loop_lag", None)
            if ll is None:
                return "loop-lag monitor not wired"
            st = ll.status()
            lag = st["lag"]
            return "\n".join(
                [
                    f"{'running':<22}: {st['running']} "
                    f"(interval {st['interval_s']:g}s)",
                    f"{'ticks':<22}: {st['ticks_total']}",
                    f"{'lag p50/p99 ms':<22}: "
                    f"{lag.get('p50_ms', 0)} / {lag.get('p99_ms', 0)}",
                ]
            )
        raise ValueError(f"bad subcommand {sub!r}")

    def _sentinel(self, args) -> str:
        """emqx ctl sentinel — publish-path watchdog: shadow-audit
        verdicts, quarantine state, stage p99s, SLO burn rates
        (obs/sentinel.py)."""
        st = getattr(self.broker, "sentinel", None)
        if st is None:
            return "publish sentinel not attached"
        sub = args[0] if args else "status"
        full = st.status()
        if sub == "status":
            lines = [
                f"{'sampling':<22}: 1/{st.sample_n}" if st.sample_n
                else f"{'sampling':<22}: off",
                f"{'quarantine':<22}: "
                f"{'on' if full['quarantine_enabled'] else 'off'}"
                f" ({len(full['quarantined_filters'])} filters held)",
            ]
            a = full["audit"]
            lines.append(
                f"{'audit':<22}: {a['total']} checked, {a['clean']} clean, "
                f"{a['divergence']} diverged, {a['skipped_stale']} skipped"
            )
            for name, s in full["slo"].items():
                if not isinstance(s, dict):
                    continue
                lines.append(
                    f"{'slo ' + name:<22}: fast {s['fast_burn']}x / "
                    f"slow {s['slow_burn']}x"
                    f"{' BREACHED' if s['breached'] else ''}"
                )
            return "\n".join(lines)
        if sub == "audit":
            return json.dumps(full["audit"], indent=1, default=str)
        if sub == "slo":
            return json.dumps(full["slo"], indent=1, default=str)
        if sub == "stages":
            stages = full["stages"]["stages"]
            out = [f"sampled publishes: {full['stages']['sampled_publishes']}"]
            for stage, snap in stages.items():
                out.append(
                    f"{stage:<10}: p50 {snap['p50_ms']}ms  "
                    f"p99 {snap['p99_ms']}ms  (n={snap['count']})"
                )
            return "\n".join(out)
        if sub == "exemplars":
            return json.dumps(
                full["stages"]["exemplars"], indent=1, default=str
            )
        raise ValueError(f"bad subcommand {sub!r}")

    def _flight(self, args) -> str:
        """emqx ctl flight — black-box recorder status, ring tail,
        manual snapshots, bundle listing (obs/flight_recorder)."""
        fl = getattr(self.obs, "flight", None) if self.obs else None
        if fl is None:
            return "flight recorder not enabled"
        sub = args[0] if args else "status"
        if sub == "status":
            st = fl.status()
            return "\n".join(
                f"{k:<22}: {v}"
                for k, v in st.items()
                if k not in ("rules", "events")
            )
        if sub == "events":
            n = int(args[1]) if len(args) > 1 else 20
            out = []
            for e in fl.recorder.recent(n):
                kv = ""
                if e["attrs"]:
                    kv = " " + " ".join(
                        f"{k}={v}" for k, v in e["attrs"].items()
                    )
                tid = f" trace={e['trace_id']}" if e["trace_id"] else ""
                out.append(f"{e['ts_ns']} [{e['kind']}]{tid}{kv}")
            return "\n".join(out) or "(no events)"
        if sub == "snapshot":
            reason = args[1] if len(args) > 1 else "manual"
            return f"ok: {fl.snapshot(reason=reason)}"
        if sub == "snapshots":
            rows = fl.store.list()
            return "\n".join(
                f"{r['name']}  {r['size']}B" for r in rows
            ) or "(no snapshots)"
        raise ValueError(f"bad subcommand {sub!r}")

    def _license(self, args) -> str:
        """emqx ctl license (emqx_license_cli.erl)."""
        raise NotPortedError("ctl license", *views.NOT_PORTED["license"])

    def _status(self, args) -> str:
        up = int(time.time() - self.started_at)
        return (
            f"Node {self.node_name} is started\n"
            f"emqx 0.1.0 is running, uptime {up}s"
        )

    def _broker(self, args) -> str:
        st = self.broker.stats
        return "\n".join(
            [
                f"sysdescr  : emqx-tpu broker",
                f"node      : {self.node_name}",
                f"sessions  : {st.val('sessions.count')}",
                f"subscriptions : {st.val('subscriptions.count')}",
                f"uptime    : {int(time.time() - self.started_at)}s",
            ]
        )

    def _metrics(self, args) -> str:
        return "\n".join(
            f"{k:<40} : {v}" for k, v in sorted(self.broker.metrics.all().items())
        )

    def _stats(self, args) -> str:
        return "\n".join(
            f"{k:<40} : {v}" for k, v in sorted(self.broker.stats.all().items())
        )

    def _cluster(self, args) -> str:
        """emqx ctl cluster on a single node: the reference's text with
        no ClusterNode, whatever the subcommand (the membership,
        partition and heal views are item 8's)."""
        return f"running nodes: {[self.node_name]} (standalone)"

    def _clients(self, args) -> str:
        sub = args[0] if args else "list"
        if sub == "list":
            return "\n".join(
                f"Client(clientid={s.client_id}, connected={s.connected}, "
                f"subscriptions={len(s.subscriptions)})"
                for s in self.broker.sessions.values()
            ) or "(none)"
        cid = args[1]
        s = self.broker.sessions.get(cid)
        if s is None:
            return f"client {cid!r} not found"
        if sub == "show":
            return (
                f"Client(clientid={s.client_id}, connected={s.connected}, "
                f"created_at={s.created_at}, subscriptions={len(s.subscriptions)}, "
                f"mqueue={len(s.mqueue)}, inflight={len(s.inflight)})"
            )
        if sub == "kick":
            self.broker.close_session(s, discard=True)
            return f"ok, kicked {cid}"
        raise ValueError(f"bad subcommand {sub!r}")

    def _subscriptions(self, args) -> str:
        sub = args[0] if args else "list"
        if sub == "list":
            return "\n".join(
                f"{cid} -> {flt} (qos{o.qos})"
                for (flt, cid), o in self.broker.suboptions.items()
            ) or "(none)"
        if sub == "show":
            cid = args[1]
            s = self.broker.sessions.get(cid)
            if s is None:
                return f"client {cid!r} not found"
            return "\n".join(
                f"{flt} (qos{o.qos})" for flt, o in s.subscriptions.items()
            ) or "(none)"
        if sub == "add":
            cid, flt, qos = args[1], args[2], int(args[3])
            s = self.broker.sessions.get(cid)
            if s is None:
                return f"client {cid!r} not found"
            self.broker.subscribe(s, flt, SubOpts(qos=qos))
            return "ok"
        if sub == "del":
            cid, flt = args[1], args[2]
            s = self.broker.sessions.get(cid)
            if s is None:
                return f"client {cid!r} not found"
            self.broker.unsubscribe(s, flt)
            return "ok"
        raise ValueError(f"bad subcommand {sub!r}")

    def _topics(self, args) -> str:
        sub = args[0] if args else "list"
        pairs = views.routes_view(self.broker, self.node_name)
        if sub == "list":
            return "\n".join(f"{t} -> {n}" for t, n in pairs) or "(none)"
        if sub == "show":
            t = args[1]
            hits = [(f, n) for f, n in pairs if f == t]
            return "\n".join(f"{f} -> {n}" for f, n in hits) or f"{t!r} not routed"
        raise ValueError(f"bad subcommand {sub!r}")

    def _publish(self, args) -> str:
        topic, payload = args[0], args[1]
        qos = int(args[2]) if len(args) > 2 else 0
        retain = len(args) > 3 and args[3] in ("1", "true", "retain")
        n = self.broker.publish(
            Message(topic=topic, payload=payload.encode(), qos=qos, retain=retain)
        )
        return f"ok, delivered to {n} subscribers"

    def _retainer(self, args) -> str:
        sub = args[0] if args else "info"
        ret = self.broker.retainer
        if sub == "info":
            return f"retained messages: {len(ret)}"
        if sub == "topics":
            return "\n".join(m.topic for m in ret.read("#")) or "(none)"
        if sub == "clean":
            flt = args[1] if len(args) > 1 else "#"
            msgs = ret.read(flt)
            for m in msgs:
                ret.retain(Message(topic=m.topic, payload=b"", retain=True))
            return f"cleaned {len(msgs)} retained messages"
        raise ValueError(f"bad subcommand {sub!r}")

    def _rules(self, args) -> str:
        if self.rules is None:
            return "rule engine not attached"
        sub = args[0] if args else "list"
        if sub == "list":
            return "\n".join(
                f"Rule(id={r.id}, enabled={r.enable}, sql={r.sql!r})"
                for r in self.rules.rules.values()
            ) or "(none)"
        rid = args[1]
        if sub == "show":
            r = self.rules.rules.get(rid)
            if r is None:
                return f"rule {rid!r} not found"
            return json.dumps(
                {
                    "id": r.id,
                    "sql": r.sql,
                    "enable": r.enable,
                    "actions": r.actions,
                    "matched": r.metrics.matched,
                },
                indent=2,
            )
        if sub == "delete":
            return "ok" if self.rules.delete_rule(rid) else f"rule {rid!r} not found"
        raise ValueError(f"bad subcommand {sub!r}")

    def _banned(self, args) -> str:
        if self.banned is None:
            return "banned table not attached"
        sub = args[0] if args else "list"
        if sub == "list":
            return "\n".join(
                f"banned {e.who_type} {e.who!r} by {e.by} until "
                f"{'forever' if e.until is None else e.until}"
                for e in self.banned.list()
            ) or "(none)"
        if sub == "add":
            dur = float(args[3]) if len(args) > 3 else None
            self.banned.create(args[1], args[2], by="cli", duration_s=dur)
            return "ok"
        if sub == "del":
            ok = self.banned.delete(args[1], args[2])
            return "ok" if ok else "not found"
        raise ValueError(f"bad subcommand {sub!r}")

    def _plugins(self, args) -> str:
        raise NotPortedError("ctl plugins", *views.NOT_PORTED["plugins"])

    def _gateways(self, args) -> str:
        raise NotPortedError("ctl gateways", *views.NOT_PORTED["gateways"])

    def _listeners(self, args) -> str:
        if self.listeners is not None:
            ls = self.listeners.info()
        else:
            ls = views.listeners_view(self.broker)
        if not ls:
            return "(no live listeners)"
        return "\n".join(
            f"{l['id']}\n  listen_on : {l['bind']}\n  running   : "
            f"{str(l['running']).lower()}\n  current_conns : "
            f"{l['current_connections']}"
            for l in ls
        )
