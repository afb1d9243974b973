"""Node boot of the port: one broker node built from its config file
(the port's copy of emqx_tpu/boot.py, the emqx_machine analog).

    python -m emqx_tpu_torch.boot -c etc/emqx.conf -c override.conf [--device cpu]

`Node` wires every ported subsystem from one checked config in the
reference's order and stops them in reverse:

    0 native cores (g++) and, on the card, the CUDA kernels (nvcc)
    1 broker: caps, persistent retainer, fanout and churn knobs, the
      dispatch engine with every tpu_* knob and its warm-up, the
      retained device leg over `tpu_retained_shards`, the native gates
    2 the auth pipeline: the ban list checked at CONNECT (0x8C) and
      flapping detection (off, as in the reference); the authn chains
      and authz sources are not ported (their keys are refused)
    3 feature modules (delayed, rewrite, auto_subscribe)
    4 rule engine (batched WHERE, the config's rules)
    5 durable tier (WAL compaction and the recovery report)
    6 observability, 6b the DS shard fail-stop alarm and flight hook
    7b chaos engine, armed but not run
    8 listeners (tcp, ssl, ws, wss)
    12 the management API at `api.bind`, when `api.enable` is on (its
      routes over unported subsystems answer 501)
    13 the ctl command surface, always, as `node.ctl`

Every build runs in steps 0-1, before a listener binds, and a failed
build fails `start()`. The node runs on the CUDA card unless the caller
passes device="cpu" (`--device cpu`); without a card `Node()` raises.
The config tree is the reference's, so any config the reference accepts
parses here to the same document; the keys whose subsystem is not
ported yet (config/unported.py: authentication, gateways, the
cluster, ...) make `start()` raise NotPortedError before anything
binds. `etc/emqx.conf` boots as it is, with the API on.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import time
from typing import List, Optional

from .device import DeviceLike, resolve

log = logging.getLogger("emqx_tpu_torch.boot")


class Node:
    def __init__(
        self,
        config_files: Optional[List[str]] = None,
        config_text: str = "",
        device: DeviceLike = None,
    ):
        from .config.config import Config
        from .config.default_schema import broker_schema

        self.device = resolve(device)
        self.config = Config.load(
            broker_schema(), files=config_files or (), text=config_text
        )
        self.broker = None
        self.listeners = None
        self.obs = None
        self.rules = None
        self.durable_mgr = None
        self.durable_db = None
        self.ds_recovery = None
        self.chaos = None
        self.auth = None
        self.mgmt = None
        self.ctl = None
        self.modules: list = []
        self.build_seconds: dict = {}
        # seconds from start() to the end of each boot step
        self.boot_steps: dict = {}
        self._stopping = False

    # --- boot order ------------------------------------------------------

    def _n_cards(self) -> int:
        if self.device.type != "cuda":
            return 1
        import torch

        return torch.cuda.device_count()

    async def start(self) -> None:
        from .config.unported import check

        t0 = time.perf_counter()
        steps = self.boot_steps

        def step(name: str) -> None:
            steps[name] = time.perf_counter() - t0

        cfg = self.config
        check(cfg, self._n_cards())
        data_dir = cfg.get("node.data_dir")
        os.makedirs(data_dir, exist_ok=True)
        node_name = cfg.get("node.name")

        # 0. the native cores (route churn, delivery ledger, frame and
        # JSON codecs, the WAL engine) and the card's kernels build at
        # BOOT, never inside the first subscribe storm or publish
        from . import native

        self.build_seconds = native.build_all()
        if self.device.type == "cuda":
            import emqx_tpu_torch.broker.pubsub  # noqa: F401  (every kernel)

            from .ops import _build

            _build.build_all()
        step("build")

        # 1. broker core (+ caps from the mqtt zone config)
        from .broker.caps import MqttCaps
        from .broker.pubsub import Broker
        from .models.retainer import PersistentRetainer

        if cfg.get("parallel.enable"):
            log.warning(
                "parallel.enable set but one card does not build a mesh "
                "-- running single-device"
            )
        broker = Broker(
            shared_strategy=cfg.get("broker.shared_subscription_strategy"),
            device=self.device,
        )
        broker.caps = MqttCaps(
            max_packet_size=cfg.get("mqtt.max_packet_size"),
            max_clientid_len=cfg.get("mqtt.max_clientid_len"),
            max_topic_levels=cfg.get("mqtt.max_topic_levels"),
            max_qos_allowed=cfg.get("mqtt.max_qos_allowed"),
            max_topic_alias=cfg.get("mqtt.max_topic_alias"),
            retain_available=cfg.get("mqtt.retain_available"),
            wildcard_subscription=cfg.get("mqtt.wildcard_subscription"),
            shared_subscription=cfg.get("mqtt.shared_subscription"),
            exclusive_subscription=cfg.get("mqtt.exclusive_subscription"),
        )
        if cfg.get("retainer.enable"):
            broker.retainer = PersistentRetainer(
                os.path.join(data_dir, "retained"),
                max_retained=cfg.get("retainer.max_retained_messages") or 1_000_000,
                device=self.device,
            )
        broker._fanout_cap = cfg.get("broker.perf.tpu_fanout_cache_size")
        broker._fanout_device = cfg.get("broker.perf.tpu_fanout_enable")
        broker._fanout_min_fan = cfg.get("broker.perf.tpu_fanout_min_fan")
        broker.router._churn_reserve = cfg.get("broker.perf.tpu_churn_reserve")
        if cfg.get("broker.perf.tpu_match_enable"):
            broker.enable_dispatch_engine(
                queue_depth=cfg.get("broker.perf.tpu_dispatch_queue_depth"),
                deadline_ms=cfg.get("broker.perf.tpu_dispatch_deadline_ms"),
                pipeline_depth=cfg.get("broker.perf.tpu_pipeline_depth"),
                match_cache_size=cfg.get("broker.perf.tpu_match_cache_size"),
                breaker_enable=cfg.get("broker.perf.tpu_breaker_enable"),
                breaker_threshold=cfg.get("broker.perf.tpu_breaker_threshold"),
                breaker_deadline_ms=cfg.get("broker.perf.tpu_breaker_deadline_ms"),
                probe_backoff_ms=cfg.get("broker.perf.tpu_breaker_probe_backoff_ms"),
                probe_backoff_max_ms=cfg.get(
                    "broker.perf.tpu_breaker_probe_backoff_max_ms"
                ),
                queue_max_depth=cfg.get("broker.perf.tpu_queue_max_depth"),
                queue_policy=cfg.get("broker.perf.tpu_queue_policy"),
                queue_deadline_ms=cfg.get("broker.perf.tpu_queue_deadline_ms"),
                queue_low_watermark=cfg.get("broker.perf.tpu_queue_low_watermark"),
                transfer_chunk_kb=cfg.get("broker.perf.tpu_transfer_chunk_kb"),
                aot_warm=cfg.get("broker.perf.tpu_aot_warm"),
                gc_guard=cfg.get("broker.perf.tpu_gc_guard"),
            )
            # serve readiness: the link probe (K12) sizes the transfer
            # chunk and every launch-shape bucket runs once
            broker.engine.warmup()
        # retained-match device leg (K8), over tpu_retained_shards
        # sub-tables; the host trie walk stays the oracle
        if getattr(broker, "retainer", None) is not None and cfg.get(
            "broker.perf.tpu_retained_enable"
        ):
            broker.retainer.enable_device(
                telemetry=broker.router.telemetry,
                n_shards=cfg.get("broker.perf.tpu_retained_shards") or 1,
            )
        # the three process-global native gates
        from .broker.delivery import set_native_enabled as set_delivery_native
        from .framec import set_native_enabled as set_frame_native
        from .jsonc import set_native_enabled as set_json_native

        set_json_native(bool(cfg.get("broker.perf.json_native")))
        set_frame_native(bool(cfg.get("broker.perf.frame_native")))
        set_delivery_native(bool(cfg.get("broker.perf.tpu_delivery_native")))
        self.broker = broker
        step("broker")

        # 2. auth pipeline: the ban list the API and ctl administer
        from .auth.bridge import AuthPipeline

        self.auth = AuthPipeline()
        self.auth.install(broker.hooks)

        # 3. feature modules
        from .modules import AutoSubscribe, DelayedPublish, TopicRewrite

        if cfg.get("delayed.enable"):
            d = DelayedPublish(
                broker, max_delayed_messages=cfg.get("delayed.max_delayed_messages")
            )
            d.enable()
            self.modules.append(d)
        rw_rules = cfg.get("rewrite")
        if rw_rules:
            rw = TopicRewrite(broker, rw_rules)
            rw.enable()
            self.modules.append(rw)
        auto_topics = cfg.get("auto_subscribe.topics")
        if auto_topics:
            a = AutoSubscribe(broker, auto_topics)
            a.enable()
            self.modules.append(a)
        step("modules")

        # 4. rule engine
        from .rules.engine import RuleEngine

        self.rules = RuleEngine(
            broker, ignore_sys=cfg.get("rule_engine.ignore_sys_message")
        )
        self.rules.batch_where_enabled = bool(
            cfg.get("broker.perf.tpu_rule_where_enable")
        )
        self.rules.install(broker.hooks)
        for rid, rconf in (cfg.get("rule_engine.rules") or {}).items():
            self.rules.create_rule(
                rid,
                rconf["sql"],
                rconf.get("actions") or [],
                enable=rconf.get("enable", True),
                description=rconf.get("description", ""),
            )
        step("rules")

        # 5. durable sessions (+ storage): the Db open replays every
        # shard WAL and the manager resumes durable sessions at their
        # committed positions; compact a bloated WAL now so the next
        # restart's replay stays bounded
        if cfg.get("durable_sessions.enable"):
            from .ds import Db
            from .ds.session_ds import DurableSessionManager

            ds_dir = cfg.get("durable_storage.messages.data_dir") or os.path.join(
                data_dir, "ds"
            )
            self.durable_db = Db(
                "messages",
                data_dir=ds_dir,
                n_shards=cfg.get("durable_storage.messages.n_shards"),
            )
            self.durable_mgr = DurableSessionManager(
                self.durable_db, state_dir=ds_dir
            )
            broker.enable_durable(self.durable_mgr)
            compacted = self.durable_db.maybe_compact()
            self.ds_recovery = {
                "db": self.durable_db.recovery_report(),
                "sessions": self.durable_mgr.recovery_report(),
                "compacted_shards": compacted,
            }
            rep = self.ds_recovery["db"]
            log.info(
                "durable tier recovered: %d shard(s) in %.1fms, "
                "%d session(s) resumed%s",
                len(rep["shards"]),
                rep["open_ms"],
                self.ds_recovery["sessions"]["sessions"],
                f", compacted {compacted}" if compacted else "",
            )
            step("durable")

        # 6. observability ($SYS, alarms, traces, slow subs, sentinel,
        # flight recorder, prometheus)
        from .obs import Observability

        self.obs = Observability(
            broker,
            node_name=node_name,
            trace_dir=os.path.join(data_dir, "trace"),
            flight_dir=os.path.join(data_dir, "flight"),
            config=cfg,
        )
        self.obs.start(cfg.get("sys_topics.sys_heartbeat_interval") / 1000.0)

        # 6b. durable-tier failure domain: a shard fail-stop raises the
        # ds_shard_failed alarm and snapshots a flight bundle
        if self.durable_db is not None:
            obs = self.obs

            def _on_shard_failed(shard_id: int, exc: BaseException) -> None:
                obs.alarms.ensure(
                    f"ds_shard_failed_{shard_id}",
                    details={"shard": shard_id, "error": str(exc)},
                    message=f"durable shard {shard_id} fail-stopped: {exc}",
                )
                if obs.flight is not None:
                    obs.flight.maybe_trigger(
                        "ds_shard_failed",
                        {"shard": shard_id, "error": str(exc)},
                    )

            self.durable_db.storage.on_shard_failed = _on_shard_failed
        step("observability")

        # 7b. chaos scenario engine: ARMED on this node's broker and
        # sentinel, not run (the soak runs standalone:
        # python -m emqx_tpu_torch.chaos)
        if cfg.get("chaos.enable"):
            from .chaos.engine import ChaosEngine

            self.chaos = ChaosEngine(
                broker,
                self.obs,
                sessions=cfg.get("chaos.sessions"),
                groups=cfg.get("chaos.groups"),
                zipf_s=cfg.get("chaos.zipf_s"),
                storm_chunk=cfg.get("chaos.storm_chunk"),
                sample_n=cfg.get("chaos.audit_sample_n"),
            )

        # 8. listeners
        from .broker.listeners import Listeners

        self.listeners = Listeners(broker, config=cfg)
        lconf = cfg.get("listeners")
        if not any((lconf or {}).get(t) for t in ("tcp", "ssl", "ws", "wss")):
            lconf = {"tcp": {"default": {"bind": "0.0.0.0:1883"}}}
        # every enabled listener; a failed bind fails the boot
        for ltype, by_name in lconf.items():
            for name, lc in (by_name or {}).items():
                if lc.get("enabled", lc.get("enable", True)):
                    await self.listeners.start(ltype, name, lc)
                    steps.setdefault("first_listener", time.perf_counter() - t0)
        step("listeners")

        # 12. management API (its routes over the subsystems the port
        # lacks answer 501)
        if cfg.get("api.enable"):
            from .broker.listeners import parse_bind
            from .mgmt.api import ManagementApi

            self.mgmt = ManagementApi(
                broker,
                config=cfg,
                rules=self.rules,
                banned=self.auth.banned,
                node_name=node_name,
                obs=self.obs,
                backup_dir=os.path.join(data_dir, "backup"),
                listeners=self.listeners,
                n_cards=self._n_cards(),
            )
            host, port = parse_bind(cfg.get("api.bind"))
            await self.mgmt.start(host, port)
            step("api")

        # 13. ctl command surface (emqx ctl analog)
        from .mgmt.cli import Ctl

        self.ctl = Ctl(
            broker,
            config=cfg,
            rules=self.rules,
            banned=self.auth.banned,
            node_name=node_name,
            listeners=self.listeners,
            obs=self.obs,
        )
        log.info("node %s started on %s", node_name, self.device)

    async def stop(self) -> None:
        """Stop in reverse boot order: the management API, listeners
        (every port released), modules, the dispatch engine (its
        in-flight batches land and the card's streams go idle),
        observability, the durable tier and the retained store."""
        if self._stopping:
            return
        self._stopping = True
        if self.mgmt is not None:
            await self.mgmt.stop()
        if self.listeners is not None:
            await self.listeners.stop_all()
        for m in reversed(self.modules):
            m.disable()
        broker = self.broker
        eng = getattr(broker, "engine", None)
        if eng is not None and not eng.closed:
            await eng.stop()
        if self.obs is not None:
            self.obs.stop()
        if self.durable_mgr is not None:
            self.durable_mgr.close()
        if self.durable_db is not None:
            self.durable_db.close()
        retainer = getattr(broker, "retainer", None)
        if retainer is not None and hasattr(retainer, "close"):
            retainer.close()
        log.info("node stopped")

    async def run_forever(self) -> None:
        """Start, then park until SIGINT/SIGTERM; graceful stop."""
        await self.start()
        stop_ev = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop_ev.set)
            except NotImplementedError:
                pass
        try:
            await stop_ev.wait()
        finally:
            await self.stop()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="emqx_tpu_torch broker node")
    ap.add_argument("-c", "--config", action="append", default=[],
                    help="config file (repeatable; later override earlier)")
    ap.add_argument(
        "--device", default=None,
        help="torch device of the kernels: the CUDA card by default, "
        "'cpu' for the plain PyTorch versions",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    node = Node(config_files=args.config, device=args.device)
    asyncio.run(node.run_forever())


if __name__ == "__main__":
    main()
