"""Root config schema for the broker — emqx_schema.erl analog (the
port's copy of emqx_tpu/config/default_schema.py: the same keys, types
and defaults).

Mirrors the reference's root set (apps/emqx/src/emqx_schema.erl roots()
:204 and emqx_conf_schema node/cluster roots) at the granularity the
runtime actually reads; zones overlay the `mqtt` root per
emqx_zone_schema.
"""

from __future__ import annotations

from .schema import (
    Array,
    Bool,
    Bytesize,
    Duration,
    Enum,
    Field,
    Float,
    Int,
    Map,
    String,
    Struct,
    Union,
)


def mqtt_struct(sparse: bool = False) -> Struct:
    """The zone-overridable MQTT behavior root (emqx_schema `mqtt`).
    `sparse=True` builds the zone-overlay variant: same fields, no
    default filling (absence = inherit global)."""
    return Struct(
        sparse=sparse,
        fields={
            "max_packet_size": Field(Bytesize(), default=1 << 20),
            "max_clientid_len": Field(Int(min=23, max=65535), default=65535),
            "max_topic_levels": Field(Int(min=1, max=65535), default=128),
            "max_topic_alias": Field(Int(min=0, max=65535), default=65535),
            "max_qos_allowed": Field(Int(min=0, max=2), default=2),
            "retain_available": Field(Bool(), default=True),
            "wildcard_subscription": Field(Bool(), default=True),
            "shared_subscription": Field(Bool(), default=True),
            "exclusive_subscription": Field(Bool(), default=False),
            "ignore_loop_deliver": Field(Bool(), default=False),
            "keepalive_multiplier": Field(Float(), default=1.5),
            "max_inflight": Field(Int(min=1, max=65535), default=32),
            "max_awaiting_rel": Field(Int(min=0), default=100),
            "await_rel_timeout": Field(Duration(), default=300_000),
            "max_mqueue_len": Field(Int(min=0), default=1000),
            "mqueue_priorities": Field(Map(Int(min=1, max=255)), default=None),
            "mqueue_default_priority": Field(
                Enum("highest", "lowest"), default="lowest"
            ),
            "mqueue_store_qos0": Field(Bool(), default=True),
            "upgrade_qos": Field(Bool(), default=False),
            "session_expiry_interval": Field(Duration(), default=7_200_000),
            "message_expiry_interval": Field(Duration(), default=float("inf")),
            "server_keepalive": Field(Int(min=1), default=None),
            "idle_timeout": Field(Duration(), default=15_000),
            "retry_interval": Field(Duration(), default=30_000),
            "use_username_as_clientid": Field(Bool(), default=False),
            "peer_cert_as_clientid": Field(Bool(), default=False),
        }
    )


def listener_struct() -> Struct:
    return Struct(
        {
            "enable": Field(Bool(), default=True),
            "bind": Field(String(), default="0.0.0.0:1883"),
            "max_connections": Field(
                Union(Int(min=1), Enum("infinity")), default="infinity"
            ),
            "max_conn_rate": Field(Int(min=1), default=None),
            "mountpoint": Field(String(), default=""),
            "zone": Field(String(), default="default"),
            "acceptors": Field(Int(min=1), default=16),
            "proxy_protocol": Field(Bool(), default=False),
            "tcp_backlog": Field(Int(min=1), default=1024),
            # ws/wss upgrade path (emqx: listeners.ws.default.websocket.mqtt_path)
            "path": Field(String(), default="/mqtt"),
            "ssl_certfile": Field(String(), default=None),
            "ssl_keyfile": Field(String(), default=None),
            "ssl_cacertfile": Field(String(), default=None),
            "ssl_verify": Field(Enum("verify_none", "verify_peer"), default="verify_none"),
            # CRL revocation checking for mTLS listeners (ref:
            # apps/emqx/src/emqx_crl_cache.erl wired through the
            # listener ssl opts' enable_crl_check)
            "ssl_crl_check": Field(Bool(), default=False),
            "ssl_crl_cache_urls": Field(Array(String()), default=[]),
            "ssl_crl_refresh_interval": Field(Duration(), default=900),
            # OCSP responder cache for the listener certificate (ref:
            # emqx_ocsp_cache.erl; stapling itself is served on the
            # QUIC TLS stack — CPython's ssl has no server-side
            # stapling hook, so TCP-TLS surfaces status via the API)
            "ssl_ocsp_enable": Field(Bool(), default=False),
            "ssl_ocsp_responder_url": Field(String(), default=None),
            "ssl_ocsp_issuer_certfile": Field(String(), default=None),
            "ssl_ocsp_refresh_interval": Field(Duration(), default=3600),
        }
    )


def limiter_bucket() -> Struct:
    return Struct(
        {
            "rate": Field(Union(Float(), Enum("infinity")), default="infinity"),
            "burst": Field(Union(Float(), Enum("infinity")), default=0),
        }
    )


def broker_schema() -> Struct:
    """Root schema: the full checked document."""
    return Struct(
        {
            "node": Field(
                Struct(
                    {
                        "name": Field(String(), default="emqx@127.0.0.1"),
                        "cookie": Field(String(), default="emqxsecretcookie"),
                        "data_dir": Field(String(), default="data"),
                        "broker_pool_size": Field(Int(min=1), default=16),
                        "process_limit": Field(Int(min=1), default=2_097_152),
                        "max_ports": Field(Int(min=1), default=1_048_576),
                        "role": Field(Enum("core", "replicant"), default="core"),
                    }
                )
            ),
            "cluster": Field(
                Struct(
                    {
                        "name": Field(String(), default="emqxcl"),
                        "discovery_strategy": Field(
                            Enum("manual", "static", "dns"), default="manual"
                        ),
                        "static_seeds": Field(Array(String()), default=[]),
                        "autoheal": Field(Bool(), default=True),
                        # minority posture during a partition: "degrade"
                        # serves local sessions with routes frozen;
                        # "isolate" additionally refuses remote
                        # publishes/route writes until rejoin
                        "partition_policy": Field(
                            Enum("degrade", "isolate"), default="degrade"
                        ),
                        "autoclean": Field(Duration(), default=86_400_000),
                    }
                )
            ),
            "mqtt": Field(mqtt_struct()),
            "zones": Field(Map(mqtt_struct(sparse=True)), default={}),
            # multi-chip scale-out: shard the route-match table over a
            # (dp, sub) device mesh (SURVEY.md §2.5 / §7 stage 6).
            # sub=0 means "all devices not used by dp".
            "parallel": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "dp": Field(Int(min=1), default=1),
                        "sub": Field(Int(min=0), default=0),
                    }
                )
            ),
            "listeners": Field(
                Struct(
                    {
                        "tcp": Field(Map(listener_struct()), default={}),
                        "ssl": Field(Map(listener_struct()), default={}),
                        "ws": Field(Map(listener_struct()), default={}),
                        "wss": Field(Map(listener_struct()), default={}),
                        "quic": Field(Map(listener_struct()), default={}),
                    }
                )
            ),
            "broker": Field(
                Struct(
                    {
                        "enable_session_registry": Field(Bool(), default=True),
                        "session_locking_strategy": Field(
                            Enum("local", "leader", "quorum", "all"), default="quorum"
                        ),
                        "shared_subscription_strategy": Field(
                            Enum(
                                "random",
                                "round_robin",
                                "round_robin_per_group",
                                "sticky",
                                "local",
                                "hash_clientid",
                                "hash_topic",
                            ),
                            default="round_robin",
                        ),
                        "shared_dispatch_ack_enabled": Field(Bool(), default=False),
                        "perf": Field(
                            Struct(
                                {
                                    # routing schema choice (emqx_router v1/v2)
                                    "routing_schema": Field(
                                        Enum("v1", "v2"), default="v2"
                                    ),
                                    "trie_compaction": Field(Bool(), default=True),
                                    # TPU offload knobs (ours)
                                    "tpu_match_enable": Field(Bool(), default=True),
                                    "tpu_batch_window_ms": Field(Duration(), default=1),
                                    "tpu_min_batch": Field(Int(min=1), default=64),
                                    # new device workloads (r14):
                                    # retained-match cuckoo probe over
                                    # stored topic names (the inverse
                                    # of routing), batched rule WHERE
                                    # mask evaluation over coalesced
                                    # publish batches, and the native
                                    # JSON codec behind the jsonc seam
                                    "tpu_retained_enable": Field(
                                        Bool(), default=False
                                    ),
                                    "tpu_retained_shards": Field(
                                        Int(min=1), default=1
                                    ),
                                    "tpu_rule_where_enable": Field(
                                        Bool(), default=False
                                    ),
                                    "json_native": Field(
                                        Bool(), default=True
                                    ),
                                    # native wire-frame codec behind
                                    # the framec seam (r19): PUBLISH/
                                    # ack/SUBACK encode+decode in C,
                                    # Python codec for everything else
                                    "frame_native": Field(
                                        Bool(), default=True
                                    ),
                                    # native delivery ledger (r19):
                                    # per-session inflight-window,
                                    # packet-id and queue-overflow
                                    # bookkeeping in native/speedups.cc
                                    # delivery_* legs (Python twin when
                                    # off or unavailable)
                                    "tpu_delivery_native": Field(
                                        Bool(), default=True
                                    ),
                                    # pipelined dispatch engine
                                    # (broker/dispatch_engine.py): the
                                    # micro-batch closes at queue_depth
                                    # topics or the sub-ms deadline,
                                    # whichever first; pipeline_depth
                                    # bounds dispatched-but-unfetched
                                    # batches (double-buffer = 2)
                                    "tpu_dispatch_queue_depth": Field(
                                        Int(min=1), default=64
                                    ),
                                    "tpu_dispatch_deadline_ms": Field(
                                        Float(), default=0.5
                                    ),
                                    "tpu_pipeline_depth": Field(
                                        Int(min=1), default=2
                                    ),
                                    # transfer-pipelined dispatch
                                    # (ops/transfer.py): chunk bound on
                                    # a ring slot's device->host result
                                    # buffer, KB — 0 auto-sizes from
                                    # the link probe at engine warmup
                                    # (RTT x bandwidth, the BDP);
                                    # aot_warm pre-traces every kernel
                                    # shape bucket at warmup so no
                                    # production dispatch pays an XLA
                                    # retrace; gc_guard keeps cyclic-
                                    # collector pauses out of the
                                    # launch/collect critical sections
                                    "tpu_transfer_chunk_kb": Field(
                                        Int(min=0), default=0
                                    ),
                                    "tpu_aot_warm": Field(
                                        Bool(), default=True
                                    ),
                                    # mesh admission floor: with
                                    # parallel.enable, tables holding
                                    # fewer rows per shard than this
                                    # serve on the mesh's first device
                                    # instead of paying N-chip launch+
                                    # combine overhead (the EMQX core/
                                    # replicant split, device-style);
                                    # 0 always shards
                                    "tpu_mesh_min_rows_per_shard": Field(
                                        Int(min=0), default=65536
                                    ),
                                    "tpu_gc_guard": Field(
                                        Bool(), default=True
                                    ),
                                    # generation-stamped caches: 0
                                    # disables the topic->pairs match
                                    # cache; the fanout-plan cache cap
                                    # replaces the old hardwired 4096
                                    "tpu_match_cache_size": Field(
                                        Int(min=0), default=8192
                                    ),
                                    "tpu_fanout_cache_size": Field(
                                        Int(min=1), default=4096
                                    ),
                                    # device-resolved fanout
                                    # (ops/fanout.py): plan-cache
                                    # misses dedup on the TPU when the
                                    # gathered fan reaches min_fan;
                                    # below it the host walk is cheaper
                                    # than a kernel dispatch
                                    "tpu_fanout_enable": Field(
                                        Bool(), default=True
                                    ),
                                    "tpu_fanout_min_fan": Field(
                                        Int(min=0), default=1024
                                    ),
                                    # native churn core (native/
                                    # speedups.cc): rows the single-add
                                    # reserve pre-pass grows for at
                                    # once — bigger = rarer reserve
                                    # stalls on subscribe storms,
                                    # smaller = tighter memory on tiny
                                    # brokers
                                    "tpu_churn_reserve": Field(
                                        Int(min=1), default=512
                                    ),
                                    # device failure domain (broker/
                                    # dispatch_engine.py): N consecutive
                                    # device failures (or batches past
                                    # the per-batch deadline) trip the
                                    # breaker into host-degraded
                                    # service; a bounded-exponential-
                                    # backoff canary probe resyncs and
                                    # verifies device state before
                                    # closing it
                                    "tpu_breaker_enable": Field(
                                        Bool(), default=True
                                    ),
                                    "tpu_breaker_threshold": Field(
                                        Int(min=1), default=4
                                    ),
                                    "tpu_breaker_deadline_ms": Field(
                                        Float(), default=250.0
                                    ),
                                    "tpu_breaker_probe_backoff_ms": Field(
                                        Float(), default=100.0
                                    ),
                                    "tpu_breaker_probe_backoff_max_ms": Field(
                                        Float(), default=5000.0
                                    ),
                                    # admission control (the emqx_olp /
                                    # emqx_limiter analog for the device
                                    # link): bounded dispatch queue with
                                    # shed (fail fast, counted) or block
                                    # (await capacity) overload policy,
                                    # and a per-publish queue deadline
                                    # so a wedged device can never hang
                                    # publishers. low watermark 0 =
                                    # auto (max_depth / 2)
                                    "tpu_queue_max_depth": Field(
                                        Int(min=1), default=8192
                                    ),
                                    "tpu_queue_policy": Field(
                                        Enum("shed", "block"),
                                        default="shed",
                                    ),
                                    "tpu_queue_deadline_ms": Field(
                                        Float(), default=1000.0
                                    ),
                                    "tpu_queue_low_watermark": Field(
                                        Int(min=0), default=0
                                    ),
                                    # publish sentinel (obs/sentinel):
                                    # 1/sample_n served publishes get a
                                    # stage span + a deferred
                                    # shadow-oracle audit (0 disables
                                    # sampling); quarantine moves
                                    # diverging filters to the
                                    # host-walk fallback until the next
                                    # clean table sync
                                    "tpu_audit_sample_n": Field(
                                        Int(min=0), default=1024
                                    ),
                                    "tpu_audit_quarantine": Field(
                                        Bool(), default=True
                                    ),
                                    # sentinel warmup exclusion: the
                                    # first N sampled spans (XLA
                                    # compile warmup) are exemplar'd
                                    # but kept out of the serve-stage
                                    # histograms and SLO (0 disables)
                                    "tpu_warmup_sample_skip": Field(
                                        Int(min=0), default=2
                                    ),
                                    # SLO objectives: publish-latency
                                    # threshold + success targets, with
                                    # fast/slow burn-rate windows (the
                                    # multiwindow alerting shape)
                                    "tpu_slo_publish_p99_ms": Field(
                                        Float(), default=50.0
                                    ),
                                    "tpu_slo_publish_target": Field(
                                        Float(), default=0.999
                                    ),
                                    "tpu_slo_audit_target": Field(
                                        Float(), default=0.999
                                    ),
                                    "tpu_slo_fast_window_s": Field(
                                        Float(), default=300.0
                                    ),
                                    "tpu_slo_slow_window_s": Field(
                                        Float(), default=3600.0
                                    ),
                                    "tpu_slo_burn_threshold": Field(
                                        Float(), default=10.0
                                    ),
                                    # delivery-path microscope
                                    # (obs/profiler): continuous
                                    # sampling profiler (off by
                                    # default — flight bundles
                                    # auto-arm it), queue-stage
                                    # sub-decomposition, and the
                                    # event-loop lag ticker
                                    "tpu_profiler_enable": Field(
                                        Bool(), default=False
                                    ),
                                    "tpu_profiler_hz": Field(
                                        Float(), default=100.0
                                    ),
                                    "tpu_delivery_stages": Field(
                                        Bool(), default=True
                                    ),
                                    "tpu_loop_lag_interval_ms": Field(
                                        Float(), default=100.0
                                    ),
                                    # mesh microscope (obs/mesh_scope):
                                    # per-dispatch stage decomposition
                                    # + collective-cost ledger; the
                                    # sample knob paces the combine-
                                    # probe re-measure (1/N dispatches)
                                    "tpu_mesh_scope_enable": Field(
                                        Bool(), default=True
                                    ),
                                    "tpu_mesh_scope_sample_n": Field(
                                        Int(min=1), default=64
                                    ),
                                }
                            )
                        ),
                        "routing": Field(
                            Struct(
                                {
                                    "batch_sync": Field(
                                        Struct(
                                            {
                                                "enable_on": Field(
                                                    Enum("none", "core", "replicant", "both"),
                                                    default="both",
                                                ),
                                                "max_batch_size": Field(
                                                    Int(min=1), default=1000
                                                ),
                                            }
                                        )
                                    ),
                                }
                            )
                        ),
                    }
                )
            ),
            "force_shutdown": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=True),
                        "max_mailbox_size": Field(Int(min=0), default=1000),
                        "max_heap_size": Field(Bytesize(), default=32 << 20),
                    }
                )
            ),
            "force_gc": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=True),
                        "count": Field(Int(min=0), default=16000),
                        "bytes": Field(Bytesize(), default=16 << 20),
                    }
                )
            ),
            "flapping_detect": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "max_count": Field(Int(min=1), default=15),
                        "window_time": Field(Duration(), default=60_000),
                        "ban_time": Field(Duration(), default=300_000),
                    }
                )
            ),
            "limiter": Field(
                Struct(
                    {
                        "max_conn_rate": Field(
                            Union(Float(), Enum("infinity")), default="infinity"
                        ),
                        "messages_rate": Field(
                            Union(Float(), Enum("infinity")), default="infinity"
                        ),
                        "bytes_rate": Field(
                            Union(Float(), Enum("infinity")), default="infinity"
                        ),
                        "client": Field(Map(limiter_bucket()), default={}),
                    }
                )
            ),
            "authentication": Field(Array(Struct({}, open=True)), default=[]),
            "authorization": Field(
                Struct(
                    {
                        "no_match": Field(Enum("allow", "deny"), default="allow"),
                        "deny_action": Field(
                            Enum("ignore", "disconnect"), default="ignore"
                        ),
                        "cache": Field(
                            Struct(
                                {
                                    "enable": Field(Bool(), default=True),
                                    "max_size": Field(Int(min=1), default=32),
                                    "ttl": Field(Duration(), default=60_000),
                                }
                            )
                        ),
                        "sources": Field(Array(Struct({}, open=True)), default=[]),
                    }
                )
            ),
            "retainer": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=True),
                        "msg_expiry_interval": Field(Duration(), default=0),
                        "max_payload_size": Field(Bytesize(), default=1 << 20),
                        "max_retained_messages": Field(Int(min=0), default=0),
                        "delivery_rate": Field(
                            Union(Float(), Enum("infinity")), default="infinity"
                        ),
                    }
                )
            ),
            "delayed": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=True),
                        "max_delayed_messages": Field(Int(min=0), default=0),
                    }
                )
            ),
            "rewrite": Field(Array(Struct({}, open=True)), default=[]),
            "auto_subscribe": Field(
                Struct({"topics": Field(Array(Struct({}, open=True)), default=[])})
            ),
            "rule_engine": Field(
                Struct(
                    {
                        "ignore_sys_message": Field(Bool(), default=True),
                        "jq_function_default_timeout": Field(Duration(), default=10_000),
                        "rules": Field(Map(Struct({}, open=True)), default={}),
                    }
                )
            ),
            "durable_sessions": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "batch_size": Field(Int(min=1), default=100),
                        "idle_poll_interval": Field(Duration(), default=100),
                        "heartbeat_interval": Field(Duration(), default=5000),
                        "session_gc_interval": Field(Duration(), default=600_000),
                    }
                )
            ),
            "durable_storage": Field(
                Struct(
                    {
                        "messages": Field(
                            Struct(
                                {
                                    "backend": Field(
                                        Enum("builtin_local", "builtin_raft"),
                                        default="builtin_local",
                                    ),
                                    "n_shards": Field(Int(min=1), default=4),
                                    "replication_factor": Field(Int(min=1), default=3),
                                    "data_dir": Field(String(), default=None),
                                }
                            )
                        ),
                    }
                )
            ),
            "sys_topics": Field(
                Struct(
                    {
                        "sys_msg_interval": Field(Duration(), default=60_000),
                        "sys_heartbeat_interval": Field(Duration(), default=30_000),
                    }
                )
            ),
            "log": Field(
                Struct(
                    {
                        "level": Field(
                            Enum("debug", "info", "notice", "warning", "error"),
                            default="warning",
                        ),
                        "to": Field(Enum("console", "file", "both"), default="console"),
                        "file": Field(String(), default="log/emqx.log"),
                    }
                )
            ),
            "prometheus": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "port": Field(Int(min=1, max=65535), default=9100),
                    }
                )
            ),
            "telemetry": Field(Struct({"enable": Field(Bool(), default=False)})),
            # License / connection-quota enforcement (ref:
            # apps/emqx_license/src/emqx_license_schema.erl key_license)
            "license": Field(
                Struct(
                    {
                        "key": Field(String(), default="default"),
                        "public_key": Field(String(), default=None),
                        "connection_low_watermark": Field(
                            String(), default="75%"
                        ),
                        "connection_high_watermark": Field(
                            String(), default="80%"
                        ),
                    }
                )
            ),
            # TLS-PSK identity store (ref: apps/emqx_psk/src/emqx_psk.erl
            # psk_authentication root: enable + init_file of
            # identity:hex-psk lines); consumed by QUIC listeners
            "psk_authentication": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "init_file": Field(String(), default=None),
                        "separator": Field(String(), default=":"),
                    }
                )
            ),
            "file_transfer": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "max_file_size": Field(Bytesize(), default=256 << 20),
                        "segments_ttl": Field(Duration(), default=300_000),
                    }
                )
            ),
            # gateway.<type> = per-gateway config (emqx_gateway conf root)
            "gateway": Field(Map(Struct({}, open=True)), default={}),
            # cluster.links analog, flattened to its own root
            "cluster_link": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "links": Field(Array(Struct({}, open=True)), default=[]),
                    }
                )
            ),
            "plugins": Field(
                Struct({"install_dir": Field(String(), default=None)})
            ),
            "api": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=True),
                        "bind": Field(String(), default="0.0.0.0:18083"),
                        "api_keys": Field(Array(Struct({}, open=True)), default=[]),
                    }
                )
            ),
            # chaos scenario engine (chaos/): million-session soak +
            # fault catalog judged by the sentinel. `enable` only ARMS
            # the engine on a booted node (the soak itself runs via
            # `python -m emqx_tpu_torch.chaos`)
            "chaos": Field(
                Struct(
                    {
                        "enable": Field(Bool(), default=False),
                        "sessions": Field(Int(min=1), default=1_000_000),
                        "victim_sessions": Field(Int(min=0), default=20_000),
                        "groups": Field(Int(min=1), default=None),
                        "zipf_s": Field(Float(), default=1.2),
                        "storm_chunk": Field(Int(min=1), default=256),
                        "audit_sample_n": Field(Int(min=1), default=64),
                        "baseline_seconds": Field(Float(), default=20.0),
                        "report_path": Field(
                            String(), default="SOAK.json"
                        ),
                    }
                )
            ),
        }
    )
