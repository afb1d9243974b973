"""The port's node boot held against the reference's on the CPU: the
config tree (the same documents and the same SchemaErrors over a
corpus), `Node(device="cpu")` against `emqx_tpu.boot.Node` on the same
configs (broker knobs, caps, engine parameters, retainer, rules, the
durable recovery, listeners), the same client script over TCP, the
mounted listener, WebSocket and WSS (chip_smoke.py phase 14's clients),
cross-boots of one data directory by the other package in both
directions, the keys the port refuses before anything binds, the
listener limits, the OLP shedder and the eviction holds on both
packages' servers, and the sharded retained index's shards and reads."""

import asyncio
import importlib
import json
import shutil
import socket
import ssl
import subprocess
import time
from pathlib import Path

import pytest
import torch

from emqx_tpu.boot import Node as RefNode
from emqx_tpu.config import Config as RConfig
from emqx_tpu.config import SchemaError as RSchemaError
from emqx_tpu.config import broker_schema as r_schema
from emqx_tpu.ds import metrics as JDM
from emqx_tpu.ops import retained as JRI
from emqx_tpu_torch.boot import Node as PortNode
from emqx_tpu_torch.config import Config as TConfig
from emqx_tpu_torch.config import SchemaError as TSchemaError
from emqx_tpu_torch.config import broker_schema as t_schema
from emqx_tpu_torch.config.unported import NotPortedError
from emqx_tpu_torch.device import NoCudaDevice
from emqx_tpu_torch.ds import metrics as TDM
from emqx_tpu_torch.ops import retained as TRI

import chip_smoke as cs
from tests.test_broker_e2e import MiniClient

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_node(**kw):
    return PortNode(device="cpu", **kw)


def _reset_ds_ledgers():
    for m in (JDM.DS_METRICS, TDM.DS_METRICS):
        with m._lock:
            for k in m.counters:
                m.counters[k] = 0
            for k in m.gauges:
                m.gauges[k] = 0.0
            m.injected.clear()


# --- the config tree ------------------------------------------------------------

# tests/test_boot.py's configs, as JSON documents
BOOT_FULL = {
    "node": {"name": "boot-test@127.0.0.1", "data_dir": "d"},
    "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}},
                  "ws": {"default": {"bind": "127.0.0.1:0"}}},
    "api": {"enable": True, "bind": "127.0.0.1:0"},
    "delayed": {"enable": True},
    "rewrite": [{"action": "all", "source_topic": "old/#",
                 "re": "^old/(.+)$", "dest_topic": "new/$1"}],
    "auto_subscribe": {"topics": [{"topic": "inbox/${clientid}"}]},
    "gateway": {"stomp": {"bind": "127.0.0.1:0"}},
    "durable_sessions": {"enable": True},
    "rule_engine": {"rules": {"r1": {"sql": 'SELECT * FROM "t/#"', "actions": []}}},
}
BOOT_AUTH = {
    "node": {"name": "auth-boot@127.0.0.1", "data_dir": "d"},
    "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}}},
    "authentication": [{"mechanism": "password_based", "backend": "fixed",
                        "users": {"alice": "pw1"}, "superusers": []}],
    "authorization": {"no_match": "deny", "sources": [
        {"type": "file", "rules": [{"permission": "allow", "action": "all",
                                    "topic": "ok/#"}]}]},
}
ZONES = """
mqtt { max_inflight = 64, retry_interval = 30s }
zones.iot { max_inflight = 8, max_mqueue_len = 10, keepalive_multiplier = 2.5 }
zones.slow { retry_interval = 2m, await_rel_timeout = 1h }
"""
DURATIONS = """
mqtt.retry_interval = 15s
mqtt.await_rel_timeout = 5m
mqtt.max_packet_size = 1MB
retainer.max_payload_size = 64KB
sys_topics.sys_heartbeat_interval = 500ms
broker.perf.tpu_breaker_deadline_ms = 125.5
"""
LAYER_BASE = """
node { name = "base@h", data_dir = "base" }
listeners.tcp.default.bind = "0.0.0.0:1883"
broker.perf { tpu_retained_enable = true, tpu_retained_shards = 4 }
cluster.name = ${node.name}
"""
LAYER_OVER = """
node.data_dir = "over"
listeners.tcp.default { bind = "127.0.0.1:1884", mountpoint = "m/" }
broker.perf.tpu_retained_shards = 2
"""

# (id, files: [(name, text)] or REPO paths, text, ok)
CONFIG_CASES = [
    ("etc_emqx_conf", [REPO / "etc" / "emqx.conf"], "", True),
    ("etc_emqx_conf_api_off", [REPO / "etc" / "emqx.conf",
                               ("api_off.conf", "api.enable = false")], "", True),
    ("boot_full", [], json.dumps(BOOT_FULL), True),
    ("boot_auth", [], json.dumps(BOOT_AUTH), True),
    ("boot_minimal", [], json.dumps({"node": {"data_dir": "d2"}, "api": {"enable": False},
                                     "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}}}}),
     True),
    ("phase14", [], cs.p14_config("d", cs.P14_SIZES, wss=("c.crt", "c.key")), True),
    ("zones", [], ZONES, True),
    ("durations_sizes", [], DURATIONS, True),
    # the HOCON subset has no include directive: later files override
    # earlier ones (a substitution resolves within its own file)
    ("layered_files", [("base.conf", LAYER_BASE), ("over.conf", LAYER_OVER)], "", True),
    ("bad_unknown_root", [], "nope = 1", False),
    ("bad_listener_key", [], 'listeners.tcp.m { bind = "127.0.0.1:0", messages_rate = 9 }',
     False),
    ("bad_int", [], "mqtt.max_inflight = many", False),
    ("bad_enum", [], 'broker.perf.tpu_queue_policy = "drop"', False),
    ("bad_duration", [], 'mqtt.retry_interval = "15 parsecs"', False),
    ("bad_bytesize", [], 'mqtt.max_packet_size = "lots"', False),
    ("bad_bool", [], 'retainer.enable = "perhaps"', False),
    ("bad_min", [], "durable_storage.messages.n_shards = 0", False),
    ("bad_unresolved_substitution", [], "cluster.name = ${nowhere.at.all}", False),
    ("bad_syntax", [], "mqtt { max_inflight = ", False),
]
ZONE_READS = [(z, k) for z in (None, "iot", "slow", "other")
              for k in ("max_inflight", "max_mqueue_len", "retry_interval",
                        "await_rel_timeout", "keepalive_multiplier")]


def _parse(config_cls, schema, error_cls, files, text):
    """("ok", document, zone reads) or (error class name, message):
    SchemaError for a value the schema refuses, HoconError for text
    the parser refuses."""
    try:
        c = config_cls.load(schema(), files=files, text=text)
    except error_cls as e:
        return ("SchemaError", str(e))
    except ValueError as e:
        return (type(e).__name__, str(e))
    return ("ok", c.to_dict(), [c.get_zone(z, k, None) for z, k in ZONE_READS])


@pytest.mark.parametrize("case", CONFIG_CASES, ids=[c[0] for c in CONFIG_CASES])
def test_config_tree_parses_as_the_reference(case, tmp_path):
    _id, files, text, ok = case
    paths = []
    for f in files:
        if isinstance(f, tuple):
            p = tmp_path / f[0]
            p.write_text(f[1])
            f = p
        paths.append(str(f))
    ref = _parse(RConfig, r_schema, RSchemaError, paths, text)
    port = _parse(TConfig, t_schema, TSchemaError, paths, text)
    assert port == ref
    assert (ref[0] == "ok") == ok, ref[:2]


# --- boots of the same configs ----------------------------------------------------

ENGINE_KNOBS = ("queue_depth", "deadline_s", "pipeline_depth", "breaker_enabled",
                "breaker_threshold", "breaker_deadline_s", "probe_backoff_s",
                "probe_backoff_max_s", "queue_max_depth", "queue_policy",
                "queue_deadline_s", "queue_low_watermark", "aot_warm", "gc_guard")


def _no_ms(x):
    if isinstance(x, dict):
        return {k: _no_ms(v) for k, v in x.items() if not k.endswith("_ms")}
    if isinstance(x, list):
        return [_no_ms(v) for v in x]
    return x


def node_facts(node):
    """What a booted node's config must have wired, comparable across
    the two packages."""
    b = node.broker
    e = b.engine
    ret = b.retainer
    idx = getattr(ret, "_index", None)
    return {
        "fanout": (b._fanout_cap, b._fanout_device, b._fanout_min_fan,
                   b.router._churn_reserve),
        "caps": dict(vars(b.caps)),
        "engine": None if e is None else {k: getattr(e, k) for k in ENGINE_KNOBS},
        "match_cache": None if b.router.match_cache is None else b.router.match_cache.capacity,
        "retainer": (type(ret).__name__, ret.max_retained,
                     None if idx is None else getattr(idx, "n_shards", 1)),
        "rules": sorted(node.rules.rules), "batch_where": node.rules.batch_where_enabled,
        "ds_recovery": _no_ms(node.ds_recovery if node.durable_db else None),
        "listeners": sorted(f"{t}:{n}" for t, n in node.listeners._live),
        "modules": [type(m).__name__ for m in node.modules],
        "chaos": None if node.chaos is None else (
            node.chaos.sessions, node.chaos.fleet.groups, node.chaos.zipf_s,
            node.chaos.storm_chunk, node.chaos.sample_n),
        "sentinel": (node.obs.sentinel.sample_n, node.obs.sentinel.quarantine_enabled),
    }


KNOBS = {
    "broker": {"shared_subscription_strategy": "random", "perf": {
        "tpu_dispatch_queue_depth": 32, "tpu_dispatch_deadline_ms": 2.0,
        "tpu_pipeline_depth": 3, "tpu_match_cache_size": 1024,
        "tpu_fanout_cache_size": 512, "tpu_fanout_enable": False,
        "tpu_fanout_min_fan": 16, "tpu_churn_reserve": 64,
        "tpu_breaker_enable": False, "tpu_breaker_threshold": 7,
        "tpu_breaker_deadline_ms": 99.0, "tpu_breaker_probe_backoff_ms": 20.0,
        "tpu_breaker_probe_backoff_max_ms": 400.0, "tpu_queue_max_depth": 256,
        "tpu_queue_policy": "block", "tpu_queue_deadline_ms": 50.0,
        "tpu_queue_low_watermark": 8, "tpu_transfer_chunk_kb": 64,
        "tpu_aot_warm": False, "tpu_gc_guard": False, "tpu_audit_sample_n": 3,
        "tpu_retained_enable": True, "tpu_retained_shards": 3}},
    "mqtt": {"max_qos_allowed": 1, "retain_available": False, "max_topic_levels": 9,
             "wildcard_subscription": False},
    "retainer": {"max_retained_messages": 777},
    "delayed": {"enable": False},
}


def _boot_confs(d):
    base = {"node": {"data_dir": str(d)}, "api": {"enable": False},
            "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}}}}
    return {
        "minimal": base,
        "knobs": dict(base, **KNOBS, chaos={"enable": True, "sessions": 500, "groups": 7}),
        "match_off": dict(base, broker={"perf": {"tpu_match_enable": False}},
                          retainer={"enable": False}),
        "phase14": json.loads(cs.p14_config(str(d), cs.P14_SIZES)),
    }


@pytest.mark.parametrize("name", ["minimal", "knobs", "match_off", "phase14"])
async def test_node_boots_as_the_reference(name, tmp_path):
    facts = []
    for cls, sub in ((RefNode, "ref"), (_port_node, "port")):
        conf = _boot_confs(tmp_path / sub)[name]
        node = cls(config_text=json.dumps(conf))
        await node.start()
        try:
            facts.append(node_facts(node))
        finally:
            await node.stop()
    assert facts[1] == facts[0]


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    crt, key = d / "srv.crt", d / "srv.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(crt), "-days", "1", "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True)
    return str(crt), str(key)


SCRIPT_SZ = dict(cs.P14_SIZES, ret=1000, tcp=24, mounted=6, ws=8, wss=4)


def _retain_names(node, msg_cls, n):
    for i, name in enumerate(cs.retained_names(n // cs.N_RET_PER_GROUP,
                                               cs.N_RET_PER_GROUP, 0)):
        node.broker.retainer.retain(msg_cls(topic=name, payload=b"%d" % i, qos=i % 3,
                                            retain=True))


async def _client_script(node, msg_cls, wss_ctx):
    """Phase 14's listener clients against `node`: connect, subscribe,
    publish through every listener type, settle; every client's
    deliveries and acks, and the retained store's r/+ answers."""
    _retain_names(node, msg_cls, SCRIPT_SZ["ret"])
    cl = cs.p14_clients(node, SCRIPT_SZ, wss_ctx)
    due = await cs.p14_listener_load(node, SCRIPT_SZ, cl, {}, {})
    await cs.settle([c for _k, c, _a, _kw in cl], due)
    out = {c.cid: (sorted(c.got), c.acks) for _k, c, _a, _kw in cl}
    for _k, c, _a, _kw in cl:
        await c.close()
    rules = {rid: (r.metrics.matched, r.metrics.passed, r.metrics.actions_success)
             for rid, r in sorted(node.rules.rules.items())}
    return out, rules, sorted((m.topic, m.payload) for m in node.broker.retainer.read("r/+"))


async def test_same_client_script_over_every_listener_type(tmp_path, certs):
    from emqx_tpu.broker.message import Message as RMessage
    from emqx_tpu_torch.broker.message import Message as TMessage

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    results = []
    for cls, msg, sub in ((RefNode, RMessage, "ref"), (_port_node, TMessage, "port")):
        node = cls(config_text=cs.p14_config(str(tmp_path / sub), SCRIPT_SZ, wss=certs))
        await node.start()
        try:
            assert sorted(f"{t}:{n}" for t, n in node.listeners._live) == [
                "tcp:default", "tcp:mounted", "ws:default", "wss:default"]
            results.append(await _client_script(node, msg, ctx))
        finally:
            await node.stop()
    (ref, ref_rules, ref_ret), (port, port_rules, port_ret) = results
    assert port_rules == ref_rules and port_ret == ref_ret
    assert sorted(port) == sorted(ref)
    for cid in ref:
        assert port[cid] == ref[cid], cid
    # every listener type delivered, the mountpoint stripped on the way out
    by_kind = {k: sum(len(ref[c][0]) for c in ref if c.startswith(k))
               for k in ("tc", "mc", "wc", "sc")}
    assert min(by_kind.values()) > 0, by_kind
    assert ("t/x/0", ) == tuple(t for t, *_ in ref["mc0"][0] if t.startswith("t/"))[:1]
    assert any(t.startswith("m/mc") for t, *_ in ref["tc0"][0])


# --- cross-boots over one data_dir --------------------------------------------------


def _pkg(name):
    root = "emqx_tpu" if name == "ref" else "emqx_tpu_torch"
    return (importlib.import_module(f"{root}.broker.message").Message,
            importlib.import_module(f"{root}.broker.packet").SubOpts,
            importlib.import_module(f"{root}.broker.session").SessionConfig)


def _cross_conf(d):
    return json.dumps({"node": {"data_dir": str(d)}, "api": {"enable": False},
                       "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}}},
                       "durable_sessions": {"enable": True},
                       "broker": {"perf": {"tpu_retained_enable": True,
                                           "tpu_retained_shards": 2}}})


def _node_cls(name):
    return RefNode if name == "ref" else _port_node


async def _write_dir(name, d):
    """Boot `name`'s node over `d`: durable sessions with undelivered
    QoS-1 messages, retained names; stop."""
    Message, SubOpts, SessionConfig = _pkg(name)
    node = _node_cls(name)(config_text=_cross_conf(d))
    await node.start()
    try:
        b = node.broker
        for k in range(3):
            s, _ = b.open_session(f"dur{k}", True, SessionConfig(session_expiry_interval=3600))
            b.subscribe(s, f"dur/{k}/+", SubOpts(qos=1))
        for n in range(24):
            b.publish(Message(topic=f"dur/{n % 3}/m{n}", payload=b"p%d" % n, qos=1,
                              from_client=f"p{n}"))
        node.durable_db.buffer.flush_now()
        for i in range(300):
            b.retainer.retain(Message(topic=f"dev/{i % 30}/{i // 30}/state",
                                      payload=b"r%d" % i, qos=i % 3, retain=True))
    finally:
        await node.stop()


async def _read_dir(name, d):
    """Boot `name`'s node over `d`: the recovery report (times left out),
    the retained answers through the device index's halves, and each
    durable session's pumped messages."""
    Message, SubOpts, SessionConfig = _pkg(name)
    node = _node_cls(name)(config_text=_cross_conf(d))
    await node.start()
    try:
        rec = _no_ms(node.ds_recovery)
        ret = node.broker.retainer
        flts = ["dev/+/0/state", "dev/3/#", "+/5/+/state", "dev/7/2/state", "dev/+/+/nope"]
        answers = [sorted((m.topic, bytes(m.payload), m.qos) for m in a)
                   for a in ret.retained_read_finish(ret.retained_read_begin(flts))]
        got = {}
        b = node.broker
        for k in range(3):
            s, present = b.open_session(f"dur{k}", False,
                                        SessionConfig(session_expiry_interval=3600))
            s.connected = True
            got[k] = (present, sorted(bytes(p.payload) for p in node.durable_mgr.pump(s)))
        return rec, answers, got, len(ret)
    finally:
        await node.stop()


@pytest.mark.parametrize("writer", ["ref", "port"])
async def test_cross_boot_over_one_data_dir(writer, tmp_path):
    _reset_ds_ledgers()
    src = tmp_path / "src"
    await _write_dir(writer, src)
    out = {}
    for reader in ("ref", "port"):
        d = tmp_path / reader
        shutil.copytree(src, d)
        out[reader] = await _read_dir(reader, d)
    assert out["port"] == out["ref"]
    rec, answers, got, n_ret = out["ref"]
    assert rec["sessions"]["sessions"] == 3 and n_ret == 300
    assert all(present and msgs for present, msgs in got.values())
    assert answers[0] and answers[1]


# --- the keys the port refuses before anything binds -----------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


REFUSED = [
    ("authentication", {"authentication": [{"backend": "fixed", "users": {}}]}, 9),
    ("authorization.sources", {"authorization": {"sources": [{"type": "file"}]}}, 9),
    ("authorization.no_match", {"authorization": {"no_match": "deny"}}, 9),
    ("file_transfer.enable", {"file_transfer": {"enable": True}}, 9),
    ("telemetry.enable", {"telemetry": {"enable": True}}, 9),
    ("rule_engine.rules.r1.actions", {"rule_engine": {"rules": {"r1": {
        "sql": 'SELECT * FROM "t/#"', "actions": [{"function": "bridge"}]}}}}, 9),
    ("cluster.static_seeds", {"cluster": {"static_seeds": ["n2@127.0.0.1:4370"]}}, 8),
    ("cluster.discovery_strategy", {"cluster": {"discovery_strategy": "static"}}, 8),
    ("durable_storage.messages.backend",
     {"durable_storage": {"messages": {"backend": "builtin_raft"}}}, 8),
    ("parallel.enable", {"parallel": {"enable": True}}, 8),
    ("listeners.quic", {"listeners": {"quic": {"default": {"bind": "127.0.0.1:0"}}}}, 9),
    ("psk_authentication.enable", {"psk_authentication": {"enable": True}}, 9),
    ("listeners.ssl.s.ssl_crl_check", {"listeners": {"ssl": {"s": {
        "bind": "127.0.0.1:0", "ssl_crl_check": True}}}}, 9),
    ("listeners.ssl.s.ssl_ocsp_enable", {"listeners": {"ssl": {"s": {
        "bind": "127.0.0.1:0", "ssl_ocsp_enable": True}}}}, 9),
    ("gateway.stomp", {"gateway": {"stomp": {"bind": "127.0.0.1:0"}}}, 9),
    ("cluster_link.enable", {"cluster_link": {"enable": True}}, 9),
    ("license.key", {"license": {"key": "some-key"}}, 9),
    ("plugins.install_dir", {}, 9),
]


@pytest.mark.parametrize("key,conf,item", REFUSED, ids=[r[0] for r in REFUSED])
async def test_refused_key_raises_before_any_bind(key, conf, item, tmp_path, monkeypatch):
    port = _free_port()
    d = tmp_path / "d"
    full = {"node": {"data_dir": str(d)}, "api": {"enable": False},
            "listeners": {"tcp": {"default": {"bind": f"127.0.0.1:{port}"}}}}
    for k, v in conf.items():
        full[k] = dict(full.get(k) or {}, **v) if isinstance(v, dict) else v
    if key == "plugins.install_dir":
        (d / "plugins").mkdir(parents=True)
        (d / "plugins" / "plugins_state.json").write_text(json.dumps({"p": {"enabled": True}}))
    if key == "parallel.enable":
        # a mesh needs two cards; on one card the node warns and serves
        monkeypatch.setattr(PortNode, "_n_cards", lambda self: 2)
    node = _port_node(config_text=json.dumps(full))
    with pytest.raises(NotPortedError) as ei:
        await node.start()
    assert (ei.value.key, ei.value.item) == (key, item)
    assert f"item {item}" in str(ei.value)
    assert node.listeners is None and node.broker is None
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    await node.stop()


async def test_parallel_on_one_card_serves_single_device(tmp_path):
    node = _port_node(config_text=json.dumps({
        "node": {"data_dir": str(tmp_path)}, "api": {"enable": False},
        "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}}},
        "parallel": {"enable": True, "dp": 2}}))
    await node.start()
    try:
        assert node.broker.router.mesh is None
    finally:
        await node.stop()


def test_node_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: Node() serves on it")
    with pytest.raises(NoCudaDevice):
        PortNode(config_text="api.enable = false")


def test_boot_cli_parses_config_files(tmp_path, monkeypatch):
    """`python -m emqx_tpu_torch.boot -c etc/emqx.conf -c override` boots
    etc/emqx.conf with the API on (the override moves only the data
    directory); run_forever is stubbed."""
    from emqx_tpu_torch import boot

    over = tmp_path / "over.conf"
    over.write_text(f'node.data_dir = "{tmp_path}"')
    seen = []

    async def run_forever(self):
        seen.append((self.device.type, self.config.get("api.enable"),
                     self.config.get("listeners.ws.default.path")))

    monkeypatch.setattr(boot.Node, "run_forever", run_forever)
    boot.main(["-c", str(REPO / "etc" / "emqx.conf"), "-c", str(over), "--device", "cpu"])
    assert seen == [("cpu", True, "/mqtt")]


# --- limits, OLP shedding and eviction holds on both packages -----------------------

PKGS = ["emqx_tpu", "emqx_tpu_torch"]


def _limiter(pkg):
    return importlib.import_module(f"{pkg}.broker.limiter")


def _server(pkg, **kw):
    broker = importlib.import_module(f"{pkg}.broker.pubsub").Broker(
        **({"device": "cpu"} if pkg == "emqx_tpu_torch" else {}))
    return importlib.import_module(f"{pkg}.broker.server").Server(broker=broker, port=0, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_token_bucket_and_chain(pkg):
    L = _limiter(pkg)
    b = L.TokenBucket(rate=10.0, burst=5.0)
    assert b.peek(15.0) == 0.0
    b.take(15.0)
    assert 0.0 < b.peek(1.0) <= 0.1 + 1e-6
    time.sleep(0.12)
    assert b.peek(1.0) == 0.0
    assert L.TokenBucket(rate=float("inf")).peek(1e12) == 0.0
    fast, slow = L.TokenBucket(rate=1000.0), L.TokenBucket(rate=1.0, burst=1.0)
    lim = L.Limiter([fast, slow])
    assert lim.check(2.0) == 0.0
    before = fast.tokens
    assert lim.check(2.0) > 0.0
    assert fast.tokens >= before - 1e-9
    s = L.LoadShedder(threshold=0.05)
    assert not s.overloaded
    s.force(True)
    assert s.overloaded
    s.force(None)
    s.lag_ewma = 0.2
    assert s.overloaded


@pytest.mark.parametrize("pkg", PKGS)
async def test_conn_rate_gate(pkg):
    L = _limiter(pkg)
    server = _server(pkg, limits=L.ListenerLimits(max_conn_rate=2))
    await server.start()
    port = server.listen_addr[1]
    c1, c2, c3 = MiniClient(port), MiniClient(port), MiniClient(port)
    assert (await c1.connect("c1")).code == 0
    assert (await c2.connect("c2")).code == 0
    with pytest.raises((ConnectionError, asyncio.TimeoutError)):
        await asyncio.wait_for(c3.connect("c3"), timeout=1.0)
    assert server.broker.metrics.val("listener.conn_rate_limited") == 1
    await server.stop()


@pytest.mark.parametrize("pkg", PKGS)
async def test_publish_rate_backpressure(pkg):
    L = _limiter(pkg)
    server = _server(pkg, limits=L.ListenerLimits(messages_rate=100))
    await server.start()
    port = server.listen_addr[1]
    sub, pub = MiniClient(port), MiniClient(port)
    await sub.connect("sub")
    await sub.subscribe("t/#", qos=0)
    await pub.connect("pub")
    t0 = time.monotonic()
    for _ in range(120):
        await pub.publish("t/x", b"p", qos=0)
    for _ in range(120):
        await asyncio.wait_for(sub.inbox.get(), timeout=5.0)
    assert time.monotonic() - t0 >= 0.15
    await server.stop()


@pytest.mark.parametrize("pkg", PKGS)
async def test_olp_sheds_new_connections_and_eviction_holds(pkg):
    L = _limiter(pkg)
    shedder = L.LoadShedder()
    server = _server(pkg, shedder=shedder)
    await server.start()
    port = server.listen_addr[1]
    keep = MiniClient(port)
    assert (await keep.connect("keep")).code == 0
    shedder.force(True)
    with pytest.raises((ConnectionError, asyncio.TimeoutError)):
        await asyncio.wait_for(MiniClient(port).connect("fresh"), timeout=1.0)
    assert shedder.shed_count == 1
    await keep.subscribe("a/b", qos=0)
    shedder.force(None)
    # two holds: releasing one keeps the gate shut
    server.evict_hold()
    server.evict_hold()
    server.evict_release()
    assert server.evicting
    with pytest.raises((ConnectionError, asyncio.TimeoutError)):
        await asyncio.wait_for(MiniClient(port).connect("held"), timeout=1.0)
    assert server.broker.metrics.val("eviction.conn_rejected") == 1
    server.evict_release()
    assert (await MiniClient(port).connect("ok")).code == 0
    await server.stop()


# --- the sharded retained index -----------------------------------------------------


def test_sharded_retained_index_shards_and_reads():
    names = list(cs.retained_names(20, 25, 5)) + ["a/b", "a/b/c", "x", "dev/1/1/state/deep"]
    ref = JRI.ShardedRetainedIndex(n_shards=3)
    port = TRI.ShardedRetainedIndex(n_shards=3, device="cpu")
    for n in names:
        assert port.add(n) == ref.add(n)
        assert port.shard_index(n) == ref._fnv(n) % 3
    for n in names[::7]:
        ref.remove(n)
        port.remove(n)
    assert len(port) == len(ref)
    assert [len(s) for s in port.shards] == [len(s) for s in ref.shards]
    flts = ["dev/+/3/state", "dev/4/#", "+/2/+/state", "a/#", "#", "$SYS/#",
            "dev/1/+/nope", "+/+/+/+/deep"]
    want = ref.read_finish(ref.read_begin(flts))
    got = port.read_finish(port.read_begin(flts))
    assert [None if x is None else sorted(x) for x in got] == \
        [None if x is None else sorted(x) for x in want]
