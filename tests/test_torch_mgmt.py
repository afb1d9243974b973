"""The port's management layer held against the reference's on the CPU:
the same seeded script, over real HTTP sockets, against
`emqx_tpu.mgmt.ManagementApi`/`Ctl` on an `emqx_tpu` Broker and against
the port's on `Broker(device="cpu")`, with equal status codes and
bodies. The cases mirror tests/test_mgmt.py, tests/test_obs_api.py,
tests/test_xla_telemetry_api.py and test_audit_and_backup_roundtrip;
a sweep sends one request to every route of the reference's table; the
routes over subsystems the port has not ported answer 501 naming their
ROADMAP item; the ban list refuses a CONNECT over TCP with 0x8C on both
packages; a backup archive crosses in both directions; ctl prints the
same text; a viewer's mutating call gets 403; and nodes booted on
etc/emqx.conf answer one script alike.

Normalised before a comparison, through chip_smoke.py's one table
(`API_VOLATILE`, each field with its reason, and `CTL_VOLATILE`), which
the card's phase 14 uses too: values that come from secrets, uuid4 or
the wall clock."""

import asyncio
import base64
import importlib
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from tests.test_broker_e2e import MiniClient
from tests.test_mgmt import http_req

REPO = Path(__file__).resolve().parents[1]
NODE = "n1@host"

@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One package's classes: "ref" (emqx_tpu) or "port"."""

    def __init__(self, name):
        self.name = name
        self.root = "emqx_tpu" if name == "ref" else "emqx_tpu_torch"

    def mod(self, name):
        return importlib.import_module(f"{self.root}.{name}")

    def broker(self):
        cls = self.mod("broker.pubsub").Broker
        return cls() if self.name == "ref" else cls(device="cpu")

    @property
    def Message(self):
        return self.mod("broker.message").Message

    @property
    def SubOpts(self):
        return self.mod("broker.packet").SubOpts


SIDES = (Side("ref"), Side("port"))


class Ctx:
    """One script's run on one side: the broker, the API, the record."""

    def __init__(self, side, tmp, with_obs=False, with_rules=True, with_banned=True,
                 broker=None, node=None):
        self.side = side
        self.out = []
        self.inboxes = {}
        self.port = None
        self.token = None
        self.basic = None
        if node is not None:  # a booted node's API
            self.broker, self.mgmt, self.obs = node.broker, node.mgmt, None
            self.banned, self.rules = node.mgmt.banned, node.rules
            return
        self.broker = broker if broker is not None else side.broker()
        self.banned = side.mod("auth.banned").Banned() if with_banned else None
        self.rules = None
        if with_rules:
            self.rules = side.mod("rules.engine").RuleEngine(self.broker)
            self.rules.install(self.broker.hooks)
        self.obs = None
        if with_obs:
            self.obs = side.mod("obs").Observability(
                self.broker, node_name=NODE, trace_dir=str(tmp / "trace"),
                flight_dir=str(tmp / "flight"))
        self.mgmt = side.mod("mgmt").ManagementApi(
            self.broker, rules=self.rules, banned=self.banned, obs=self.obs,
            node_name=NODE, backup_dir=str(tmp / "bk"))

    async def start(self):
        if self.mgmt.http.listen_addr is None:
            await self.mgmt.start()
        self.port = self.mgmt.http.listen_addr[1]
        _, login = await http_req(self.port, "POST", "/api/v5/login",
                                  {"username": "admin", "password": "public"})
        self.token = login["token"]

    async def stop(self):
        await self.mgmt.stop()
        if self.obs is not None:
            self.obs.stop()

    async def call(self, method, path, body=None, auth="token", record=True):
        kw = {}
        if auth == "token":
            kw["token"] = self.token
        elif auth == "basic":
            kw["basic"] = self.basic
        elif isinstance(auth, tuple):
            kw["basic"] = auth
        st, out = await http_req(self.port, method, path, body, **kw)
        if record:
            self.out.append((method, path, st, cs.norm_body(out)))
        return st, out

    async def raw(self, method, path, auth=True):
        """(status, content type, text) of a request answered in text."""
        reader, writer = await asyncio.open_connection("127.0.0.1", self.port)
        head = f"{method} {path} HTTP/1.1\r\nhost: x\r\nconnection: close\r\n"
        if auth:
            head += f"authorization: Bearer {self.token}\r\n"
        writer.write((head + "\r\n").encode())
        raw = await reader.read(-1)
        writer.close()
        top, _, body = raw.partition(b"\r\n\r\n")
        lines = top.decode().split("\r\n")
        ctype = next(x.split(":", 1)[1].strip() for x in lines if x.startswith("content-type"))
        rec = (method, path, int(lines[0].split()[1]), ctype, body.decode())
        self.out.append(rec)
        return rec

    def note(self, label, value):
        self.out.append((label, cs.norm_body(value)))

    def sess(self, cid, subs=(), qos=0):
        s, _ = self.broker.open_session(cid, clean_start=True)
        inbox = self.inboxes.setdefault(cid, [])
        s.outgoing_sink = lambda pkts: inbox.extend(pkts)
        for flt in subs:
            self.broker.subscribe(s, flt, self.side.SubOpts(qos=qos))
        return s, inbox

    def got(self, cid):
        return [(p.topic, bytes(p.payload), p.qos, bool(p.retain))
                for p in self.inboxes.get(cid, [])]


async def run_both(script, tmp_path, **kw):
    outs = []
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        ctx = Ctx(side, d, **kw)
        await ctx.start()
        try:
            await script(ctx)
        finally:
            await ctx.stop()
        outs.append(ctx.out)
    return outs


# --- the cases of tests/test_mgmt.py ------------------------------------------


async def s_status_unauthenticated(c):
    await c.raw("GET", "/status", auth=False)


async def s_auth_required_and_login(c):
    await c.call("GET", "/api/v5/clients", auth=None)
    await c.call("POST", "/api/v5/login", {"username": "admin", "password": "wrong"}, auth=None)
    await c.call("POST", "/api/v5/login", {"username": "admin", "password": "public"},
                 auth=None)
    await c.call("GET", "/api/v5/clients")
    await c.call("GET", "/api/v5/clients", auth=("nobody", "x"))


async def s_api_key_basic_auth(c):
    _, created = await c.call("POST", "/api/v5/api_key", {"name": "ci"})
    c.basic = (created["api_key"], created["api_secret"])
    await c.call("GET", "/api/v5/metrics", auth="basic")
    await c.call("GET", "/api/v5/api_key", auth="basic")
    await c.call("POST", "/api/v5/api_key", {"name": "ci"})
    await c.call("POST", "/api/v5/api_key", {})
    await c.call("DELETE", "/api/v5/api_key/ci")
    await c.call("GET", "/api/v5/metrics", auth="basic")
    await c.call("DELETE", "/api/v5/api_key/ci")


async def s_clients_and_subscriptions_views(c):
    c.sess("alpha", subs=["t/1", "t/+"])
    c.sess("beta", subs=["x/#"])
    for path in ("/api/v5/clients", "/api/v5/clients?like_clientid=alp",
                 "/api/v5/clients/alpha", "/api/v5/clients/alpha/subscriptions",
                 "/api/v5/subscriptions?match_topic=x/y/z",
                 "/api/v5/subscriptions?clientid=alpha", "/api/v5/subscriptions?qos=0",
                 "/api/v5/subscriptions?topic=t/1", "/api/v5/subscriptions?qos=x",
                 "/api/v5/clients?conn_state=connected"):
        await c.call("GET", path)
    await c.call("DELETE", "/api/v5/clients/beta")
    c.note("beta gone", "beta" not in c.broker.sessions)
    await c.call("GET", "/api/v5/clients/beta")
    await c.call("GET", "/api/v5/clients/beta/subscriptions")


async def s_subscribe_unsubscribe_via_api(c):
    c.sess("dev1")
    await c.call("POST", "/api/v5/clients/dev1/subscribe", {"topic": "cmd/+", "qos": 1})
    c.broker.publish(c.side.Message(topic="cmd/go", payload=b"x"))
    await c.call("POST", "/api/v5/clients/dev1/unsubscribe", {"topic": "cmd/+"})
    c.broker.publish(c.side.Message(topic="cmd/go", payload=b"y"))
    await c.call("POST", "/api/v5/clients/nobody/unsubscribe", {"topic": "cmd/+"})
    await c.call("POST", "/api/v5/clients/dev1/unsubscribe", {})
    c.note("dev1", c.got("dev1"))


async def s_publish_api_and_topics(c):
    c.sess("listener", subs=["news/#"])
    await c.call("POST", "/api/v5/publish", {"topic": "news/a", "payload": "hello"})
    await c.call("POST", "/api/v5/publish", {
        "topic": "news/b", "payload": base64.b64encode(b"\x00\x01").decode(),
        "payload_encoding": "base64", "qos": 1, "retain": True})
    await c.call("POST", "/api/v5/publish/bulk", [
        {"topic": "news/c", "payload": "1"}, {"topic": "nobody/listens", "payload": "2"}])
    await c.call("GET", "/api/v5/topics")
    await c.call("GET", "/api/v5/topics?topic=news/%23")
    await c.call("POST", "/api/v5/publish", {"topic": "bad/+/wild", "payload": "x"})
    await c.call("POST", "/api/v5/publish/bulk", [{"payload": "no topic"}])
    c.note("listener", c.got("listener"))


async def s_metrics_stats_nodes(c):
    c.sess("c1", subs=["a/b"])
    c.broker.publish(c.side.Message(topic="a/b", payload=b"m"))
    for path in ("/api/v5/metrics", "/api/v5/stats", "/api/v5/nodes",
                 f"/api/v5/nodes/{NODE}", "/api/v5/nodes/self", "/api/v5/nodes/other"):
        await c.call("GET", path)


async def s_banned_crud(c):
    await c.call("POST", "/api/v5/banned", {"as": "clientid", "who": "evil", "reason": "spam"})
    c.note("check", c.banned.check("evil") is not None)
    await c.call("POST", "/api/v5/banned", {"as": "username", "who": "bob", "until": 4e9})
    await c.call("POST", "/api/v5/banned", {"as": "shoe", "who": "x"})
    await c.call("POST", "/api/v5/banned", {"who": "x"})
    await c.call("GET", "/api/v5/banned")
    await c.call("DELETE", "/api/v5/banned/clientid/evil")
    c.note("check", c.banned.check("evil") is not None)
    await c.call("DELETE", "/api/v5/banned/clientid/evil")


async def s_rules_crud_and_test(c):
    await c.call("POST", "/api/v5/rules", {
        "id": "r1", "sql": 'SELECT payload FROM "sensors/+"',
        "actions": [{"function": "republish", "args": {"topic": "out/t"}}]})
    c.sess("watcher", subs=["out/t"])
    c.broker.publish(c.side.Message(topic="sensors/1", payload=b'{"v":1}'))
    await c.call("GET", "/api/v5/rules/r1")
    await c.call("GET", "/api/v5/rules")
    await c.call("PUT", "/api/v5/rules/r1", {"enable": False})
    await c.call("PUT", "/api/v5/rules/nope", {"enable": False})
    await c.call("POST", "/api/v5/rule_test", {
        "sql": 'SELECT payload.x FROM "t"', "context": {"topic": "t", "payload": '{"x": 42}'}})
    await c.call("POST", "/api/v5/rule_test", {
        "sql": 'SELECT * FROM "t" WHERE payload.x > 50',
        "context": {"topic": "t", "payload": '{"x": 42}'}})
    await c.call("POST", "/api/v5/rule_test", {"context": {}})
    await c.call("POST", "/api/v5/rules", {"sql": "NOT VALID SQL"})
    await c.call("POST", "/api/v5/rules", {"id": "r2"})
    await c.call("DELETE", "/api/v5/rules/r1")
    await c.call("GET", "/api/v5/rules/r1")
    await c.call("DELETE", "/api/v5/rules/r1")
    c.note("watcher", c.got("watcher"))


async def s_retainer_api(c):
    c.broker.publish(c.side.Message(topic="cfg/a", payload=b"keep", retain=True, qos=1))
    c.broker.publish(c.side.Message(topic="cfg/b/c", payload=b"k2", retain=True))
    await c.call("GET", "/api/v5/mqtt/retainer/messages")
    await c.call("GET", "/api/v5/mqtt/retainer/message/cfg/a")
    await c.call("GET", "/api/v5/mqtt/retainer/message/cfg/b/c")
    await c.call("DELETE", "/api/v5/mqtt/retainer/message/cfg/a")
    await c.call("GET", "/api/v5/mqtt/retainer/message/cfg/a")
    await c.call("DELETE", "/api/v5/mqtt/retainer/message/cfg/a")


async def s_pagination(c):
    for i in range(25):
        c.sess(f"c{i:02}")
    for q in ("limit=10&page=3", "limit=10&page=1", "limit=0&page=0", "page=abc",
              "limit=100000"):
        await c.call("GET", f"/api/v5/clients?{q}")


async def s_kick_closes_live_tcp_connection(c):
    server = c.side.mod("broker.server").Server(c.broker, port=0)
    await server.start()
    try:
        cl = MiniClient(server.listen_addr[1])
        await cl.connect("victim")
        await c.call("GET", "/api/v5/clients/victim")
        await c.call("DELETE", "/api/v5/clients/victim")
        c.note("gone", "victim" not in c.broker.sessions)
        c.note("eof", await asyncio.wait_for(cl.reader.read(-1), 2.0))
    finally:
        await server.stop()


async def s_api_subscribe_delivers_retained(c):
    c.broker.publish(c.side.Message(topic="cfg/x", payload=b"saved", retain=True))
    c.broker.publish(c.side.Message(topic="cfg/y", payload=b"s2", retain=True, qos=1))
    c.sess("late")
    await c.call("POST", "/api/v5/clients/late/subscribe", {"topic": "cfg/#", "qos": 1})
    c.note("late", c.got("late"))
    await c.call("POST", "/api/v5/clients/late/subscribe", {"qos": 1})
    await c.call("POST", "/api/v5/clients/late/subscribe", {"topic": "a/#/b"})
    await c.call("POST", "/api/v5/clients/nobody/subscribe", {"topic": "a/b"})
    await c.call("GET", "/api/v5/clients?page=abc")


async def s_encoded_slash_stays_inside_path_segment(c):
    c.broker.open_session("tenant/dev1", True)
    await c.call("GET", "/api/v5/clients/tenant%2Fdev1")
    await c.call("DELETE", "/api/v5/clients/tenant%2Fdev1")
    c.note("gone", "tenant/dev1" not in c.broker.sessions)


async def s_methods_and_bodies(c):
    await c.call("PATCH", "/api/v5/clients")
    await c.call("GET", "/api/v5/nowhere")
    st, _ = await http_req(c.port, "POST", "/api/v5/publish", None, token=c.token)
    c.note("empty body", st)
    reader, writer = await asyncio.open_connection("127.0.0.1", c.port)
    writer.write(b"POST /api/v5/publish HTTP/1.1\r\nhost: x\r\ncontent-length: 5\r\n"
                 b"authorization: Bearer " + c.token.encode() + b"\r\nconnection: close"
                 b"\r\n\r\n{bad}")
    raw = await reader.read(-1)
    writer.close()
    c.note("bad json", raw.split(b"\r\n\r\n", 1)[1].decode())
    await c.raw("GET", "/")
    await c.raw("GET", "/dashboard", auth=False)


MGMT_CASES = {
    "status_unauthenticated": s_status_unauthenticated,
    "auth_required_and_login": s_auth_required_and_login,
    "api_key_basic_auth": s_api_key_basic_auth,
    "clients_and_subscriptions_views": s_clients_and_subscriptions_views,
    "subscribe_unsubscribe_via_api": s_subscribe_unsubscribe_via_api,
    "publish_api_and_topics": s_publish_api_and_topics,
    "metrics_stats_nodes": s_metrics_stats_nodes,
    "banned_crud": s_banned_crud,
    "rules_crud_and_test": s_rules_crud_and_test,
    "retainer_api": s_retainer_api,
    "pagination": s_pagination,
    "kick_closes_live_tcp_connection": s_kick_closes_live_tcp_connection,
    "api_subscribe_delivers_retained": s_api_subscribe_delivers_retained,
    "encoded_slash_stays_inside_path_segment": s_encoded_slash_stays_inside_path_segment,
    "methods_and_bodies": s_methods_and_bodies,
}


@pytest.mark.parametrize("case", list(MGMT_CASES))
async def test_api_script_equals_the_reference(case, tmp_path):
    ref, port = await run_both(MGMT_CASES[case], tmp_path)
    assert port == ref
    assert ref  # the script recorded something


# --- the obs routes (tests/test_obs_api.py, tests/test_xla_telemetry_api.py) ----


async def s_prometheus_scrape(c):
    c.sess("c1", subs=["a/#"])
    c.broker.publish(c.side.Message(topic="a/b", payload=b"z"))
    _m, _p, st, ctype, text = await c.raw("GET", "/api/v5/prometheus/stats")
    c.out.pop()
    # the emqx_cluster_* families come with the cluster layer (ROADMAP
    # Queue 1 item 8b); the emqx_xla_* ones carry each package's numbers
    fams = sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                   if ln and not ln.startswith(("#", "emqx_xla_", "emqx_cluster_"))})
    vals = sorted(ln for ln in text.splitlines() if ln.startswith(("emqx_sessions_count",
                                                                   "emqx_messages_received")))
    c.note("scrape", [st, ctype, fams, vals])


async def s_alarms_api(c):
    c.obs.alarms.activate("cpu_high", {"v": 1}, "cpu high")
    await c.call("GET", "/api/v5/alarms?activated=true")
    c.obs.alarms.deactivate("cpu_high")
    await c.call("GET", "/api/v5/alarms?activated=false")
    await c.call("GET", "/api/v5/alarms")
    await c.call("DELETE", "/api/v5/alarms")
    await c.call("GET", "/api/v5/alarms?activated=false")


async def s_slow_subs_api(c):
    c.obs.slow_subs.track("c9", "t/slow", 800.0)
    await c.call("GET", "/api/v5/slow_subscriptions")
    await c.call("DELETE", "/api/v5/slow_subscriptions")
    await c.call("GET", "/api/v5/slow_subscriptions")


async def s_trace_api(c):
    await c.call("POST", "/api/v5/trace", {"name": "tr1", "type": "clientid", "clientid": "devX"})
    await c.call("GET", "/api/v5/trace")
    c.broker.publish(c.side.Message(topic="a/b", payload=b"z", from_client="devX"))
    await c.call("PUT", "/api/v5/trace/tr1/stop")
    _m, _p, st, _ct, text = await c.raw("GET", "/api/v5/trace/tr1/log")
    c.out.pop()
    c.note("log", [st, "PUBLISH" in text and "a/b" in text])
    await c.call("DELETE", "/api/v5/trace/tr1")
    await c.call("DELETE", "/api/v5/trace/tr1")
    await c.call("POST", "/api/v5/trace", {"name": "bad", "type": "nope", "filter": "x"})


async def s_flight_and_sentinel(c):
    await c.call("POST", "/api/v5/xla/flight/snapshot", {"reason": "ops"})
    st, lst = await c.call("GET", "/api/v5/xla/flight/snapshots")
    await c.call("GET", f"/api/v5/xla/flight/snapshots/{lst['data'][0]['name']}", record=False)
    await c.call("GET", "/api/v5/xla/flight/snapshots/nope")
    st, fl = await c.call("GET", "/api/v5/xla/flight?limit=0", record=False)
    c.note("flight", [st, sorted(fl)])
    await c.call("GET", "/api/v5/xla/flight?limit=x")
    st, sn = await c.call("GET", "/api/v5/xla/sentinel", record=False)
    c.note("sentinel", [st, sorted(sn)])
    await c.call("GET", "/api/v5/xla/profile?top=x")
    await c.call("GET", "/api/v5/xla/profile?arm=x")
    st, prof = await c.call("GET", "/api/v5/xla/profile", record=False)
    c.note("profile", [st, sorted(prof)])


OBS_CASES = {
    "prometheus_scrape": s_prometheus_scrape,
    "alarms_api": s_alarms_api,
    "slow_subs_api": s_slow_subs_api,
    "trace_api": s_trace_api,
    "flight_and_sentinel": s_flight_and_sentinel,
}


@pytest.mark.parametrize("case", list(OBS_CASES))
async def test_obs_route_script_equals_the_reference(case, tmp_path):
    ref, port = await run_both(OBS_CASES[case], tmp_path, with_obs=True)
    assert port == ref


def _scrape_value(text, rx):
    m = re.search(rx, text)
    return int(m.group(1)) if m else None


@pytest.mark.parametrize("dispatch", [False, True])
async def test_xla_telemetry_and_scrape_agree(dispatch, tmp_path):
    """GET /api/v5/xla/telemetry and the scrape serve one collector's
    numbers on each package, and the dispatch counts equal the
    reference's (the latencies and table bytes are each package's own)."""
    seen = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        c = Ctx(side, d, with_obs=True)
        await c.start()
        try:
            if dispatch:
                c.broker.router.add_routes([(f"s{i}/+/m/#", f"d{i}") for i in range(24)])
                c.broker.router.match_filters_batch([f"s{i}/a/m/x" for i in range(8)])
            st, body = await c.call("GET", "/api/v5/xla/telemetry")
            _m, _p, st2, _ct, text = await c.raw("GET", "/api/v5/prometheus/stats")
        finally:
            await c.stop()
        assert st == st2 == 200 and body["enabled"] is True
        hash_n = body["dispatch"].get("hash", {}).get("count", 0)
        scraped = _scrape_value(
            text, r'emqx_xla_dispatch_duration_seconds_count\{[^}]*leg="hash"\} (\d+)')
        assert scraped == (hash_n if dispatch else None)
        assert ("emqx_xla_device_table_bytes" in text) == dispatch
        seen[side.name] = (sorted(body), sorted(body["dispatch"]),
                           body["counters"].get("dispatch_batches_total", 0), hash_n,
                           body["gauges"].get("device_table_bytes", 0) > 0)
    assert seen["port"] == seen["ref"]
    assert seen["ref"][2] == (1 if dispatch else 0)


# --- every route of the reference's table ------------------------------------------

# (method, path, ROADMAP item) of a request to each route the port answers 501
NOT_PORTED_ROUTES = [
    ("GET", "/api/v5/gateways", "9b.5"),
    ("GET", "/api/v5/gateways/stomp", "9b.5"),
    ("PUT", "/api/v5/gateways/stomp", "9b.5"),
    ("DELETE", "/api/v5/gateways/stomp", "9b.5"),
    ("GET", "/api/v5/plugins", "9b.8"),
    ("POST", "/api/v5/plugins/install", "9b.8"),
    ("PUT", "/api/v5/plugins/p1/start", "9b.8"),
    ("PUT", "/api/v5/plugins/p1/stop", "9b.8"),
    ("DELETE", "/api/v5/plugins/p1", "9b.8"),
    ("GET", "/api/v5/bridges", "9b.3"),
    ("GET", "/api/v5/bridges/b1", "9b.3"),
    ("GET", "/api/v5/license", "9b.7"),
    ("POST", "/api/v5/license", "9b.7"),
    ("PUT", "/api/v5/license/setting", "9b.7"),
    ("POST", "/api/v5/load_rebalance/purge/start", "8b"),
    ("POST", "/api/v5/load_rebalance/purge/stop", "8b"),
    ("POST", "/api/v5/load_rebalance/evacuation/start", "8b"),
    ("POST", "/api/v5/load_rebalance/evacuation/stop", "8b"),
    ("GET", "/api/v5/load_rebalance/status", "8b"),
    ("PUT", "/api/v5/sso/ldap", "9b.1"),
    ("PUT", "/api/v5/sso/oidc", "9b.1"),
    ("POST", "/api/v5/sso/login/ldap", "9b.1"),
    ("POST", "/api/v5/sso/login/oidc", "9b.1"),
    ("GET", "/api/v5/sso/oidc/login_url", "9b.1"),
    ("GET", "/api/v5/sso/oidc/callback?code=c&state=s", "9b.1"),
]
# what the reference answers on the same request (a standalone
# ManagementApi: no gateway registry, plugin manager, bridges, license
# checker or evacuation; the booted reference node has all of them)
REF_ANSWERS = {
    "9b.5": {200, 404}, "9b.8": {200, 404}, "9b.3": {200, 404}, "9b.7": {404},
    "8b": {200, 400, 404}, "9b.1": {200, 401, 404},
}


@pytest.mark.parametrize("method,path,item", NOT_PORTED_ROUTES,
                         ids=[f"{m} {p}" for m, p, _ in NOT_PORTED_ROUTES])
async def test_not_ported_route_answers_501_naming_its_item(method, path, item, tmp_path):
    answers = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        c = Ctx(side, d)
        await c.start()
        try:
            body = {"package": "x.tar.gz"} if "install" in path else {}
            answers[side.name] = await c.call(method, path, body)
        finally:
            await c.stop()
    st, body = answers["port"]
    assert st == 501 and body["code"] == "NOT_PORTED"
    assert body["message"].endswith(f"is not ported yet (ROADMAP Queue 1 item {item})")
    assert answers["ref"][0] in REF_ANSWERS[item], answers["ref"]


def _sweep_requests():
    """One request per route of the reference's table, in its order,
    with its path parameters filled in."""
    from emqx_tpu.broker.pubsub import Broker
    from emqx_tpu.mgmt import ManagementApi

    fill = {"{node}": NODE, "{clientid}": "c1", "{path...}": "mqtt/max_qos_allowed",
            "{as}": "clientid", "{who}": "evil", "{name}": "x", "{backend}": "nope",
            "{id}": "r1", "{topic...}": "cfg/a"}
    bodies = {
        ("POST", "/api/v5/clients/{clientid}/subscribe"): {"topic": "cfg/#"},
        ("POST", "/api/v5/clients/{clientid}/unsubscribe"): {"topic": "cfg/#"},
        ("POST", "/api/v5/publish"): {"topic": "a/b", "payload": "p"},
        ("POST", "/api/v5/publish/bulk"): [{"topic": "a/b", "payload": "q"}],
        ("PUT", "/api/v5/configs/{path...}"): {"value": 1},
        ("POST", "/api/v5/banned"): {"as": "clientid", "who": "evil"},
        ("POST", "/api/v5/api_key"): {"name": "k"},
        ("PUT", "/api/v5/sso/{backend}"): {},
        ("POST", "/api/v5/rules"): {"id": "r1", "sql": 'SELECT * FROM "a/#"'},
        ("PUT", "/api/v5/rules/{id}"): {"enable": False},
        ("POST", "/api/v5/rule_test"): {"sql": 'SELECT * FROM "t"', "context": {"topic": "t"}},
        ("POST", "/api/v5/trace"): {"name": "t1", "type": "topic", "topic": "a/#"},
        ("POST", "/api/v5/mqtt/topic_metrics"): {"topic": "a/b"},
        ("POST", "/api/v5/data/import"): {"filename": "emqx-export-none.tar.gz"},
        ("POST", "/api/v5/xla/flight/snapshot"): {"reason": "sweep"},
    }
    api = ManagementApi(Broker(), obs=object(), license=object())
    out = []
    for rt in api.http._routes:
        path = rt.pattern
        for k, v in fill.items():
            path = path.replace(k, v)
        out.append((rt.method, rt.pattern, path, bodies.get((rt.method, rt.pattern))))
    return out


# answered in text, or with a body whose values are each package's own
SWEEP_TEXT = {"/status", "/", "/dashboard", "/api/v5/prometheus/stats",
              "/api/v5/trace/{name}/log"}
SWEEP_SHAPE = {"/api/v5/xla/telemetry", "/api/v5/xla/flight", "/api/v5/xla/sentinel",
               "/api/v5/xla/profile", "/api/v5/swagger.json", "/api/v5/xla/flight/snapshots",
               "/api/v5/monitor", "/api/v5/monitor_current"}


async def _sweep(c, requests, not_ported):
    c.sess("c1", subs=["a/#"])
    c.broker.publish(c.side.Message(topic="cfg/a", payload=b"keep", retain=True))
    for method, pattern, path, body in requests:
        if (method, path) in not_ported:
            continue
        if pattern in SWEEP_TEXT:
            _m, _p, st, ctype, text = await c.raw(method, path, auth=pattern != "/status")
            c.out.pop()
            c.out.append((method, pattern, st, ctype, bool(text)))
        elif pattern in SWEEP_SHAPE:
            st, out = await c.call(method, path, body, record=False)
            c.out.append((method, pattern, st, sorted(out) if isinstance(out, dict)
                          else type(out).__name__))
        else:
            await c.call(method, path, body)
    # last, so that the audit above holds the same entries on both
    for method, pattern, path, body in requests:
        if (method, path) in not_ported and c.side.name == "port":
            st, out = await c.call(method, path, body, record=False)
            c.out.append(("501", method, pattern, st, out["code"]))


async def test_every_route_of_the_reference_answers_alike(tmp_path):
    requests = _sweep_requests()
    np_paths = {(m, p.split("?")[0]) for m, p, _ in NOT_PORTED_ROUTES}
    # the port's table is the reference's (its license routes always)
    from emqx_tpu.mgmt.api import ManagementApi as RApi
    from emqx_tpu_torch.mgmt.api import ManagementApi as TApi
    from emqx_tpu.broker.pubsub import Broker as RB
    from emqx_tpu_torch.broker.pubsub import Broker as TB

    ref_table = [(r.method, r.pattern)
                 for r in RApi(RB(), obs=object(), license=object()).http._routes]
    port_table = [(r.method, r.pattern)
                  for r in TApi(TB(device="cpu"), obs=object()).http._routes]
    assert port_table == ref_table
    # every route of a not-ported family, and the OIDC flow's two routes
    # (the sweep's {backend} is one the reference does not know)
    families = {"gateways", "plugins", "bridges", "license", "load_rebalance"}
    not_ported = {(m, p) for m, pat, p, _b in requests
                  if pat.split("/")[3:4] and pat.split("/")[3] in families
                  or p.startswith("/api/v5/sso/oidc/")}
    assert {(m, p) for m, p in np_paths if "{" not in p
            and (m, p) in {(m2, p2) for m2, _x, p2, _b in requests}} <= not_ported
    ref, port = await run_both(lambda c: _sweep(c, requests, not_ported), tmp_path,
                               with_obs=True)
    answered_501 = [r[1:] for r in port if r[0] == "501"]
    assert answered_501 == [(m, pat, 501, "NOT_PORTED") for m, pat, p, _b in requests
                            if (m, p) in not_ported]
    assert [r for r in port if r[0] != "501"] == ref
    assert len(ref) + len(not_ported) == len(requests)


# --- the ban list at CONNECT -----------------------------------------------------


async def _connect_codes(side, tmp_path, flapping):
    from emqx_tpu.broker.packet import MQTT_V5

    broker = side.broker()
    pipe = side.mod("auth.bridge").AuthPipeline()
    if flapping:
        pipe.flapping.enable = True
        pipe.flapping.max_count = 2
    pipe.install(broker.hooks)
    server = side.mod("broker.server").Server(broker, port=0)
    await server.start()
    c = Ctx(side, tmp_path, broker=broker)
    c.banned = c.mgmt.banned = pipe.banned
    c.ctl = side.mod("mgmt").Ctl(broker, banned=pipe.banned)
    await c.start()
    codes = []

    async def connect(cid):
        cl = MiniClient(server.listen_addr[1], ver=MQTT_V5)
        ack = await cl.connect(cid)
        codes.append((cid, ack.code))
        await cl.close()
        await asyncio.sleep(0.05)

    try:
        await connect("good")
        await c.call("POST", "/api/v5/banned", {"as": "clientid", "who": "evil"})
        await connect("evil")
        c.note("ctl add", c.ctl.run(["banned", "add", "clientid_re", "bot-*"]))
        await connect("bot-7")
        await c.call("DELETE", "/api/v5/banned/clientid/evil")
        await connect("evil")
        if flapping:
            for _ in range(4):
                await connect("flappy")
            await c.call("GET", "/api/v5/banned")
        c.note("ctl list", cs.norm_text(c.ctl.run(["banned", "list"])))
        c.note("auth failures", broker.metrics.val("client.auth.failure"))
    finally:
        await c.stop()
        await server.stop()
    return codes, c.out


@pytest.mark.parametrize("flapping", [False, True])
async def test_ban_list_refuses_connect_with_0x8c(flapping, tmp_path):
    out = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        out[side.name] = await _connect_codes(side, d, flapping)
    assert out["port"] == out["ref"]
    codes = out["ref"][0]
    assert codes[:4] == [("good", 0), ("evil", 0x8C), ("bot-7", 0x8C), ("evil", 0)]
    if flapping:
        assert [code for cid, code in codes if cid == "flappy"] == [0, 0, 0, 0x8C]


# --- ctl ---------------------------------------------------------------------------

CTL_SCRIPT = [
    [], ["help"], ["nope"], ["status"], ["broker"], ["metrics"], ["stats"],
    ["cluster"], ["cluster", "status"],
    ["subscriptions", "add", "dev1", "t/+", "1"], ["subscriptions", "add", "ghost", "t/+", "1"],
    ["subscriptions", "add", "dev1"], ["subscriptions", "list"],
    ["subscriptions", "show", "dev1"], ["subscriptions", "show", "ghost"],
    ["publish", "t/x", "hi"], ["publish", "keep/me", "r", "1", "retain"], ["publish"],
    ["clients", "list"], ["clients", "show", "dev1"], ["clients", "show", "ghost"],
    ["clients", "bogus", "dev1"],
    ["topics", "list"], ["topics", "show", "t/+"], ["topics", "show", "zz"], ["topics", "x"],
    ["retainer", "info"], ["retainer", "topics"], ["retainer", "clean", "none/#"],
    ["retainer", "clean"], ["retainer", "x"],
    ["rules", "list"], ["rules", "show", "r1"], ["rules", "show", "zz"],
    ["rules", "delete", "r1"], ["rules", "delete", "r1"], ["rules", "x", "y"],
    ["banned", "add", "clientid", "evil"], ["banned", "add", "clientid", "tmp", "60"],
    ["banned", "list"], ["banned", "del", "clientid", "evil"],
    ["banned", "del", "clientid", "evil"], ["banned", "add", "shoe", "x"],
    ["listeners"],
    ["flight"], ["flight", "status"], ["flight", "events", "5"], ["flight", "snapshot", "ops"],
    ["flight", "snapshots"], ["flight", "x"],
    ["sentinel"], ["sentinel", "audit"], ["sentinel", "slo"], ["sentinel", "stages"],
    ["sentinel", "exemplars"], ["sentinel", "x"],
    ["profile"], ["profile", "stacks"], ["profile", "collapsed"], ["profile", "lag"],
    ["profile", "x"],
    ["mesh"], ["mesh", "scope"],
    ["subscriptions", "del", "dev1", "t/+"], ["clients", "kick", "dev1"],
    ["clients", "kick", "dev1"],
]
# ctl commands over subsystems the port lacks: one error line each
CTL_NOT_PORTED = {"plugins": "9b.8", "gateways": "9b.5", "license": "9b.7"}


async def test_ctl_prints_the_reference_text(tmp_path):
    outs = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        c = Ctx(side, d, with_obs=True)
        c.rules.create_rule("r1", 'SELECT * FROM "t/#"', [])
        c.sess("dev1")
        server = side.mod("broker.server").Server(c.broker, port=0)
        await server.start()
        ctl = side.mod("mgmt").Ctl(c.broker, rules=c.rules, banned=c.banned, obs=c.obs,
                                   node_name=NODE)
        try:
            lines = [(argv, cs.norm_text(ctl.run(argv)).replace(str(d), "<dir>"))
                     for argv in CTL_SCRIPT]
            ctl.register("hello", lambda args: f"hi {args[0]}", "hello <name>")
            lines.append((["hello", "world"], ctl.run(["hello", "world"])))
            lines.append((["hello"], ctl.run(["hello"])))
            lines.append(("inbox", c.got("dev1")))
            outs[side.name] = lines
            if side.name == "port":
                for cmd, item in CTL_NOT_PORTED.items():
                    for argv in ([cmd], [cmd, "list"], [cmd, "info"]):
                        text = ctl.run(argv)
                        assert text.startswith("error: ") and "\n" not in text, text
                        assert text.endswith(f"(ROADMAP Queue 1 item {item})")
        finally:
            await server.stop()
            c.obs.stop()
    lines = [x for x in outs["ref"] if x[0] != ["listeners"]]
    assert [x for x in outs["port"] if x[0] != ["listeners"]] == lines
    # the listener's bound port is each run's own
    lst = [re.sub(r":\d+", ":<port>", t) for (a, t) in (x for x in outs["ref"] if
                                                          x[0] == ["listeners"])]
    assert [re.sub(r":\d+", ":<port>", t) for (a, t) in
            (x for x in outs["port"] if x[0] == ["listeners"])] == lst


# --- RBAC --------------------------------------------------------------------------


async def s_rbac(c):
    c.mgmt.add_user("watch", "pw", role="viewer")
    _, login = await c.call("POST", "/api/v5/login", {"username": "watch", "password": "pw"},
                            auth=None)
    admin = c.token
    c.token = login["token"]
    await c.call("GET", "/api/v5/clients")
    await c.call("POST", "/api/v5/publish", {"topic": "a", "payload": "x"})
    await c.call("POST", "/api/v5/banned", {"as": "clientid", "who": "x"})
    await c.call("DELETE", "/api/v5/api_key/x")
    await c.call("PUT", "/api/v5/configs/mqtt", {"value": {}})
    await c.call("POST", "/api/v5/gateways", {})
    await c.call("PUT", "/api/v5/gateways/stomp", {})
    c.token = admin
    c.note("viewer role", [c.mgmt._user_roles["watch"]])
    try:
        c.mgmt.add_user("x", "y", role="root")
    except ValueError as e:
        c.note("bad role", str(e))
    try:
        c.mgmt.api_keys.create("k", role="root")
    except ValueError as e:
        c.note("bad key role", str(e))
    k = c.mgmt.api_keys.create("ro", role="viewer")
    c.basic = (k["api_key"], k["api_secret"])
    await c.call("GET", "/api/v5/stats", auth="basic")
    await c.call("DELETE", "/api/v5/api_key/ro", auth="basic")
    await c.call("GET", "/api/v5/audit")


async def test_viewer_mutations_get_403(tmp_path):
    ref, port = await run_both(s_rbac, tmp_path)
    assert port == ref
    assert [r[2] for r in ref if r[:2] == ("POST", "/api/v5/publish")] == [403]


# --- audit and backup ---------------------------------------------------------------


def _fill_state(c):
    """Rules, bans, an API key, retained messages and a config override."""
    c.rules.create_rule("r1", 'SELECT * FROM "a/#"', [],
                        description="kept")
    c.rules.create_rule("r2", 'SELECT payload.v FROM "t/#" WHERE payload.v > 3',
                        [{"function": "republish", "args": {"topic": "out/${topic}"}}],
                        enable=False)
    c.banned.create("clientid", "badguy", reason="test")
    c.banned.create("username", "tmp", duration_s=3600)
    key = c.mgmt.api_keys.create("backup-key", desc="d")
    for i in range(6):
        c.broker.publish(c.side.Message(topic=f"keep/{i}", payload=b"v%d" % i,
                                        retain=True, qos=i % 3,
                                        props={"User-Property": [["k", str(i)]]}))
    return key


def _state_of(c):
    return {
        "rules": sorted((r.id, r.sql, r.enable, r.description, json.dumps(r.actions))
                        for r in c.rules.rules.values()),
        "banned": sorted((e.who_type, e.who, e.by, e.reason, e.until is None)
                         for e in c.banned.list()),
        "keys": sorted((k["name"], k["desc"], k["enable"]) for k in c.mgmt.api_keys.list()),
        "retained": sorted((m.topic, bytes(m.payload), m.qos, json.dumps(m.props))
                           for m in c.broker.retainer.read("#")),
    }


async def test_audit_and_backup_roundtrip(tmp_path):
    """test_transform_backup.py's roundtrip on each package: export,
    import into a fresh broker, and the audit of the REST mutations."""
    seen = {}
    for side in SIDES:
        backup = side.mod("mgmt.backup")
        d = tmp_path / side.name
        d.mkdir()
        a = Ctx(side, d)
        key = _fill_state(a)
        path = backup.export_backup(str(d / "bk"), broker=a.broker, rules=a.rules,
                                    banned=a.banned, api_keys=a.mgmt.api_keys)
        (d / "b").mkdir()
        b = Ctx(side, d / "b")
        report = backup.import_backup(path, broker=b.broker, rules=b.rules, banned=b.banned,
                                      api_keys=b.mgmt.api_keys)
        assert b.mgmt.api_keys.verify(key["api_key"], key["api_secret"])
        await a.start()
        try:
            _, out = await a.call("POST", "/api/v5/data/export")
            _, files = await a.call("GET", "/api/v5/data/files")
            assert out["filename"] in files["files"]
            await a.call("POST", "/api/v5/banned", {"as": "clientid", "who": "late"})
            await a.call("POST", "/api/v5/data/import", {"filename": "../x"})
            await a.call("POST", "/api/v5/data/import", {})
            await a.call("GET", "/api/v5/audit")
            await a.call("GET", "/api/v5/audit?actor=admin&via=api&limit=1")
        finally:
            await a.stop()
        seen[side.name] = (cs.norm_body(report), _state_of(b), a.out)
    assert seen["port"] == seen["ref"]
    report = seen["ref"][0]
    assert report["errors"] == [] and report["banned"] == 2 and report["rules"] == 2
    assert report["retained"] == 6 and report["api_keys"] == 1


def _archive_members(path):
    import tarfile

    with tarfile.open(path) as tar:
        return {m.name: tar.extractfile(m).read() for m in tar.getmembers()}


@pytest.mark.parametrize("writer", ["ref", "port"])
async def test_backup_archive_crosses_between_the_packages(writer, tmp_path):
    """An export of one package's API imports into the other's through
    POST /api/v5/data/import and gives the same API answers; the JSON
    sections are byte for byte the ones the other package writes."""
    by = {s.name: s for s in SIDES}
    reader = "port" if writer == "ref" else "ref"
    (tmp_path / "w").mkdir()
    w = Ctx(by[writer], tmp_path / "w")
    key = _fill_state(w)
    await w.start()
    try:
        _, out = await w.call("POST", "/api/v5/data/export")
    finally:
        await w.stop()
    src = tmp_path / "w" / "bk" / out["filename"]
    # the same state written by the other package: equal sections
    (tmp_path / "o").mkdir()
    o = Ctx(by[reader], tmp_path / "o")
    _fill_state(o)
    other = by[reader].mod("mgmt.backup").export_backup(
        str(tmp_path / "o" / "bk"), broker=o.broker, rules=o.rules, banned=o.banned,
        api_keys=o.mgmt.api_keys, node_name=NODE)
    a, b = _archive_members(src), _archive_members(other)
    assert set(a) == set(b)
    for name in ("rules.json", "retained.json"):
        assert a[name] == b[name], name
    for name in ("banned.json", "api_keys.json", "META.json"):
        assert cs.norm_body(json.loads(a[name])) == cs.norm_body(json.loads(b[name])), name
    answers = {}
    for side in SIDES:
        d = tmp_path / f"r_{side.name}"
        d.mkdir()
        r = Ctx(side, d)
        (d / "bk").mkdir()
        shutil.copy(src, d / "bk" / src.name)
        await r.start()
        try:
            await r.call("POST", "/api/v5/data/import", {"filename": src.name})
            for path in ("/api/v5/rules", "/api/v5/banned", "/api/v5/api_key",
                         "/api/v5/mqtt/retainer/messages", "/api/v5/mqtt/retainer/message/keep/4"):
                await r.call("GET", path)
            assert r.mgmt.api_keys.verify(key["api_key"], key["api_secret"])
            r.basic = (key["api_key"], key["api_secret"])
            await r.call("GET", "/api/v5/stats", auth="basic")
            r.note("state", _state_of(r))
        finally:
            await r.stop()
        answers[side.name] = r.out
    assert answers["port"] == answers["ref"]


async def test_config_writes_that_turn_on_a_refused_key_answer_501(tmp_path):
    """A config PUT or a backup import whose result turns on a key the
    port's boot refuses answers 501 naming that key's item and applies
    nothing; the reference applies it."""
    from emqx_tpu_torch.boot import Node

    conf = json.dumps({"node": {"data_dir": str(tmp_path / "n")},
                       "api": {"enable": True, "bind": "127.0.0.1:0"},
                       "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}}}})
    node = Node(config_text=conf, device="cpu")
    await node.start()
    try:
        c = Ctx(Side("port"), tmp_path, node=node)
        await c.start()
        st, body = await c.call("PUT", "/api/v5/configs/telemetry/enable", {"value": True})
        assert st == 501 and "telemetry.enable" in body["message"]
        assert node.config.get("telemetry.enable") is False
        st, body = await c.call("PUT", "/api/v5/configs/mqtt/max_qos_allowed", {"value": 1})
        assert st == 200 and node.config.get("mqtt.max_qos_allowed") == 1
        st, body = await c.call("PUT", "/api/v5/configs/mqtt/max_qos_allowed",
                                {"value": "many"})
        assert st == 400 and body["code"] == "UPDATE_FAILED"
        # an archive whose config section turns the gateways on
        import io
        import tarfile

        bk = tmp_path / "n" / "backup"
        bk.mkdir(parents=True, exist_ok=True)
        with tarfile.open(bk / "emqx-export-refused.tar.gz", "w:gz") as tar:
            for name, obj in (("META.json", {"version": 1, "node": NODE, "exported_at": 0}),
                              ("config.json", {"gateway": {"stomp": {"bind": "127.0.0.1:0"}}}),
                              ("banned.json", [{"as": "clientid", "who": "x", "by": "t",
                                                "reason": "", "until": None}])):
                data = json.dumps(obj).encode()
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
        st, body = await c.call("POST", "/api/v5/data/import",
                                {"filename": "emqx-export-refused.tar.gz"})
        assert st == 501 and "gateway.stomp" in body["message"]
        assert "item 9" in body["message"]
        assert node.auth.banned.list() == [] and not node.config.get("gateway")
    finally:
        await node.stop()


# --- the booted nodes on etc/emqx.conf -------------------------------------------


def _bind_override(tmp_path, name):
    p = tmp_path / f"{name}_binds.conf"
    p.write_text(json.dumps({
        "node": {"data_dir": str(tmp_path / name)},
        "api": {"bind": "127.0.0.1:0"},
        "listeners": {"tcp": {"default": {"bind": "127.0.0.1:0"}},
                      "ws": {"default": {"bind": "127.0.0.1:0"}}}}))
    return str(p)


async def s_booted(c, node):
    from emqx_tpu.broker.packet import MQTT_V5

    await c.raw("GET", "/status", auth=False)
    tcp = node.listeners.get("tcp", "default").listen_addr[1]
    cl = MiniClient(tcp, ver=MQTT_V5)
    await cl.connect("dev1")
    await cl.subscribe("t/#", qos=1)
    await c.call("POST", "/api/v5/publish", {"topic": "t/1", "payload": "a", "qos": 1})
    await c.call("POST", "/api/v5/publish/bulk", [
        {"topic": f"t/{i}", "payload": str(i)} for i in range(4)])
    got = []
    for _ in range(5):
        p = await cl.expect(object)
        got.append((p.topic, bytes(p.payload)))
    c.note("dev1", sorted(got))
    for path in ("/api/v5/nodes", "/api/v5/clients", "/api/v5/subscriptions", "/api/v5/topics",
                 "/api/v5/stats", "/api/v5/configs/mqtt/max_qos_allowed",
                 "/api/v5/configs/api/enable", "/api/v5/mqtt/retainer/messages",
                 "/api/v5/alarms", "/api/v5/cluster", "/api/v5/file_transfer/files",
                 "/api/v5/xla/sentinel?cluster=true", "/api/v5/rules", "/api/v5/sso",
                 "/api/v5/sso/running"):
        await c.call("GET", path)
    st, lst = await c.call("GET", "/api/v5/listeners", record=False)
    c.note("listeners", [st, sorted((x["id"], x.get("type")) for x in lst)])
    await c.call("POST", "/api/v5/banned", {"as": "clientid", "who": "evil"})
    bad = MiniClient(tcp, ver=MQTT_V5)
    c.note("banned connack", (await bad.connect("evil")).code)
    await bad.close()
    await c.call("DELETE", "/api/v5/clients/dev1")
    for argv in (["status"], ["broker"], ["banned", "list"], ["clients", "list"],
                 ["topics", "list"], ["retainer", "info"], ["cluster"], ["rules", "list"]):
        c.note(" ".join(argv), cs.norm_text(node.ctl.run(argv)))
    await cl.close()


async def test_booted_nodes_on_etc_emqx_conf_answer_alike(tmp_path):
    """`Node(config_files=["etc/emqx.conf", <binds>])` boots with the API
    on, on both packages, and answers one script alike."""
    from emqx_tpu.boot import Node as RNode
    from emqx_tpu_torch.boot import Node as TNode

    outs = {}
    for side, cls in ((SIDES[0], RNode), (SIDES[1], lambda **kw: TNode(device="cpu", **kw))):
        node = cls(config_files=[str(REPO / "etc" / "emqx.conf"),
                                 _bind_override(tmp_path, side.name)])
        await node.start()
        try:
            assert node.config.get("api.enable") is True and node.mgmt is not None
            # the dashboard monitor is the flight recorder's monitor series
            assert node.obs.flight.monitor is node.mgmt.monitor is not None
            c = Ctx(side, tmp_path, node=node)
            await c.start()
            await s_booted(c, node)
            outs[side.name] = c.out
        finally:
            await node.stop()
    assert outs["port"] == outs["ref"]


# --- chip_smoke.py phase 14's API script, rehearsed on the CPU ---------------------

P14_SMALL = {"routes": 4096, "live": 256, "wide": 80, "filters": 8, "durable": 4,
             "ret": 2000, "tcp": 16, "mounted": 4, "ws": 4, "windows": 2, "window": 128,
             "dur_pubs": 16, "ret_wave": 64, "api_pubs": 4, "api_bulk": 2,
             "api_bulk_n": 32, "api_gets": 4}


def test_phase14_script_with_the_api_answers_alike_twice(tmp_path):
    """Phase 14 boots etc/emqx.conf with its config over it, the API on,
    and holds the card's run against a CPU run; two CPU runs of its
    script at a small size must already agree, API answers and ctl
    texts included."""
    sz = dict(cs.P14_SIZES, **P14_SMALL)
    runs = [cs.jsonable(cs.boot_run("cpu", str(tmp_path / f"r{i}" / "d"), 8, sz)[0])
            for i in range(2)]
    assert runs[1] == runs[0]
    api = {tuple(r[:2]): r[2:] for r in runs[0]["api"] if r[0] != "ctl"}
    assert api[("CONNECT", "evil14")] == [0x8C]
    assert api[("GET", "/api/v5/gateways")][0] == 501
    report = runs[0]["api_import"][1][3]
    assert report["errors"] == [] and report["rules"] == 3 and report["retained"] > 2000
