"""/api/v5 REST management API over a live broker — the
emqx_management analog (apps/emqx_management/src/emqx_mgmt_api_*.erl:
clients, subscriptions, topics, publish, metrics, stats, nodes,
configs, banned, api_key; retainer API from
apps/emqx_retainer/src/emqx_retainer_api.erl; rules API from
apps/emqx_rule_engine/src/emqx_rule_engine_api*.erl; dashboard login
from apps/emqx_dashboard).

Auth model: POST /api/v5/login issues a bearer token (dashboard
users, default admin/public); programmatic access uses API keys via
HTTP basic auth (emqx_mgmt_auth.erl). /status and /login are the only
unauthenticated routes.

The port's own copy of emqx_tpu/mgmt/api.py, with every route of the
reference's table. The routes over a subsystem the port has not ported
yet raise `NotPortedError` naming its ROADMAP Queue 1 item, which the
HTTP server answers with 501 (NOT_PORTED): the gateways (item 9b.5),
the plugins (9b.8), the bridges (9b.3), the license (9b.7), node purge
and evacuation (8b), and SSO over LDAP or OIDC (9b.1). A config update
or a backup import that would turn on a key the boot refuses
(config/unported.py) answers 501 the same way, before anything is
applied. `POST /api/v5/publish/bulk` is `Broker.publish_batch`: one
batched match on the card.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import os
import secrets
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..broker.message import Message
from ..broker.packet import SubOpts
from ..config.unported import NotPortedError, new_refusal
from ..ops import topic as topic_mod
from . import views
from .http import HttpServer, Request, Response

TOKEN_TTL = 3600.0


def not_ported(req: Request) -> NotPortedError:
    """The 501 of a route under views.NOT_PORTED, named by its family."""
    item, what = views.NOT_PORTED[req.path.split("/")[3]]
    return NotPortedError(f"{req.method} {req.path}", item, what)


def _hash_pw(pw: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", pw.encode(), salt, 10_000)


def _paginate(items: List[Any], query: Dict[str, str]) -> Dict[str, Any]:
    try:
        page = max(1, int(query.get("page", "1")))
        limit = max(1, min(10_000, int(query.get("limit", "100"))))
    except ValueError:
        raise ValueError("page/limit must be integers") from None
    start = (page - 1) * limit
    return {
        "data": items[start : start + limit],
        "meta": {
            "page": page,
            "limit": limit,
            "count": len(items),
            "hasnext": start + limit < len(items),
        },
    }


class ApiKeys:
    """API key store (apps/emqx_management/src/emqx_mgmt_auth.erl)."""

    def __init__(self) -> None:
        self._keys: Dict[str, Dict[str, Any]] = {}  # api_key -> record

    def create(
        self,
        name: str,
        desc: str = "",
        enable: bool = True,
        expired_at: Optional[float] = None,
        role: str = "administrator",
    ) -> Dict[str, Any]:
        if any(r["name"] == name for r in self._keys.values()):
            raise ValueError(f"api key name exists: {name}")
        if role not in ("administrator", "viewer"):
            # the reference's dashboard RBAC roles (emqx_dashboard_rbac)
            raise ValueError(f"unknown role {role!r}")
        api_key = secrets.token_urlsafe(12)
        api_secret = secrets.token_urlsafe(24)
        salt = secrets.token_bytes(16)
        self._keys[api_key] = {
            "name": name,
            "desc": desc,
            "enable": enable,
            "expired_at": expired_at,
            "created_at": time.time(),
            "role": role,
            "salt": salt,
            "secret_hash": _hash_pw(api_secret, salt),
        }
        # the secret is returned exactly once, at creation
        return {
            "name": name, "api_key": api_key, "api_secret": api_secret,
            "role": role,
        }

    def role_of(self, api_key: str) -> str:
        r = self._keys.get(api_key)
        return (r or {}).get("role", "administrator")

    def verify(self, api_key: str, api_secret: str) -> bool:
        r = self._keys.get(api_key)
        if r is None or not r["enable"]:
            return False
        if r["expired_at"] is not None and time.time() > r["expired_at"]:
            return False
        return hmac.compare_digest(r["secret_hash"], _hash_pw(api_secret, r["salt"]))

    def export_entries(self) -> List[Dict[str, Any]]:
        """Serializable entries (hashed secrets only) for data backup."""
        return [
            {
                "api_key": k,
                "name": v["name"],
                "desc": v["desc"],
                "enable": v["enable"],
                "expired_at": v["expired_at"],
                "created_at": v["created_at"],
                "salt": base64.b64encode(v["salt"]).decode(),
                "secret_hash": base64.b64encode(v["secret_hash"]).decode(),
            }
            for k, v in self._keys.items()
        ]

    def import_entry(self, entry: Dict[str, Any]) -> None:
        """Restore one exported entry, preserving the name-uniqueness
        invariant create() enforces. Re-importing the SAME key record
        is an idempotent upsert (disaster-recovery replays)."""
        for k, r in self._keys.items():
            if r["name"] == entry["name"] and k != entry["api_key"]:
                raise ValueError(f"api key name exists: {entry['name']}")
        self._keys[entry["api_key"]] = {
            "name": entry["name"],
            "desc": entry.get("desc", ""),
            "enable": entry.get("enable", True),
            "expired_at": entry.get("expired_at"),
            "created_at": entry.get("created_at", time.time()),
            "salt": base64.b64decode(entry["salt"]),
            "secret_hash": base64.b64decode(entry["secret_hash"]),
        }

    def delete(self, name: str) -> bool:
        for k, r in list(self._keys.items()):
            if r["name"] == name:
                del self._keys[k]
                return True
        return False

    def list(self) -> List[Dict[str, Any]]:
        return [
            {
                "name": r["name"],
                "api_key": k,
                "desc": r["desc"],
                "enable": r["enable"],
                "expired_at": r["expired_at"],
                "created_at": r["created_at"],
            }
            for k, r in self._keys.items()
        ]


class ManagementApi:
    """Binds the REST surface to a broker (and optional subsystems)."""

    def __init__(
        self,
        broker,
        config=None,
        rules=None,
        banned=None,
        node_name: str = "emqx@127.0.0.1",
        obs=None,  # Observability bundle (obs.Observability)
        backup_dir: str = "data/backup",
        listeners=None,  # broker.listeners.Listeners manager
        n_cards: int = 1,  # the cards the node serves (config refusals)
    ):
        from .audit import AuditLog

        self.broker = broker
        self.config = config
        self.rules = rules
        self.banned = banned
        self.obs = obs
        self.listeners = listeners
        self.n_cards = n_cards
        self.node_name = node_name
        self.backup_dir = backup_dir
        self.started_at = time.time()
        self.http = HttpServer()
        self.api_keys = ApiKeys()
        self.audit = AuditLog()
        self.http.after.append(self._audit_mw)
        from . import dashboard

        dashboard.install(self)
        # dashboard users (default admin/public, like the reference)
        self._users: Dict[str, Tuple[bytes, bytes]] = {}
        self._user_roles: Dict[str, str] = {}
        self.add_user("admin", "public")
        self._tokens: Dict[str, Tuple[str, float]] = {}
        from .sso import SsoManager

        self.sso = SsoManager()
        self.http.before.append(self._auth_mw)
        self._register_routes()

    # --- auth -------------------------------------------------------------

    def add_user(self, username: str, password: str,
                 role: str = "administrator") -> None:
        if role not in ("administrator", "viewer"):
            raise ValueError(f"unknown role {role!r}")
        salt = secrets.token_bytes(16)
        self._users[username] = (salt, _hash_pw(password, salt))
        self._user_roles[username] = role

    def _auth_mw(self, req: Request) -> Optional[Response]:
        if req.path in ("/status", "/", "/dashboard") or (
            req.method,
            req.path,
        ) == ("POST", "/api/v5/login"):
            return None
        if req.path.startswith("/api/v5/sso/login/") or req.path in (
            "/api/v5/sso/oidc/callback",
            "/api/v5/sso/oidc/login_url",
            "/api/v5/sso/running",
        ):
            return None  # SSO entry points, like /login itself
        auth = req.headers.get("authorization", "")
        if auth.startswith("Bearer "):
            tok = auth[7:]
            ent = self._tokens.get(tok)
            if ent and time.time() < ent[1]:
                req.principal = ent[0]
                req.role = self._user_roles.get(ent[0], "administrator")
                return self._enforce_role(req)
        elif auth.startswith("Basic "):
            try:
                user, _, pw = (
                    base64.b64decode(auth[6:]).decode("utf-8").partition(":")
                )
            except Exception:
                return Response.error(401, "BAD_USERNAME_OR_PWD", "bad basic auth")
            if self.api_keys.verify(user, pw):
                req.principal = f"api_key:{user}"
                req.role = self.api_keys.role_of(user)
                return self._enforce_role(req)
        return Response.error(401, "UNAUTHORIZED", "missing or invalid credentials")

    def _enforce_role(self, req: Request) -> Optional[Response]:
        """RBAC (emqx_dashboard_rbac): viewers are read-only — every
        mutating method is denied, not just hidden."""
        if req.role == "viewer" and req.method != "GET" and req.path not in (
            "/api/v5/logout",
        ):
            return Response.error(
                403, "NOT_ALLOWED", "viewer role is read-only"
            )
        return None

    def _login(self, req: Request):
        body = req.json() or {}
        user, pw = body.get("username", ""), body.get("password", "")
        ent = self._users.get(user)
        if ent is None or not hmac.compare_digest(ent[1], _hash_pw(pw, ent[0])):
            return Response.error(401, "BAD_USERNAME_OR_PWD", "bad credentials")
        now = time.time()
        self._tokens = {t: e for t, e in self._tokens.items() if e[1] > now}
        tok = secrets.token_urlsafe(32)
        self._tokens[tok] = (user, now + TOKEN_TTL)
        return {"token": tok, "version": "5", "license": {"edition": "opensource"}}

    # --- lifecycle --------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        addr = await self.http.start(host, port)
        self._monitor().start()  # dashboard rate sampling
        return addr

    async def stop(self) -> None:
        if getattr(self, "monitor", None) is not None:
            self.monitor.stop()
        await self.http.stop()

    # --- route table ------------------------------------------------------

    def _register_routes(self) -> None:
        r = self.http.route
        r("GET", "/status", self._status)
        r("POST", "/api/v5/login", self._login)
        r("GET", "/api/v5/nodes", self._nodes)
        r("GET", "/api/v5/nodes/{node}", self._node_one)
        r("GET", "/api/v5/metrics", lambda q: self.broker.metrics.all())
        r("GET", "/api/v5/stats", lambda q: self.broker.stats.all())
        r("GET", "/api/v5/clients", self._clients)
        r("GET", "/api/v5/clients/{clientid}", self._client_one)
        r("DELETE", "/api/v5/clients/{clientid}", self._client_kick)
        r("GET", "/api/v5/clients/{clientid}/subscriptions", self._client_subs)
        r("POST", "/api/v5/clients/{clientid}/subscribe", self._client_subscribe)
        r("POST", "/api/v5/clients/{clientid}/unsubscribe", self._client_unsubscribe)
        r("GET", "/api/v5/subscriptions", self._subscriptions)
        r("GET", "/api/v5/topics", self._topics)
        r("POST", "/api/v5/publish", self._publish)
        r("POST", "/api/v5/publish/bulk", self._publish_bulk)
        r("GET", "/api/v5/configs", self._config_all)
        r("GET", "/api/v5/configs/{path...}", self._config_get)
        r("PUT", "/api/v5/configs/{path...}", self._config_put)
        r("GET", "/api/v5/banned", self._banned_list)
        r("POST", "/api/v5/banned", self._banned_create)
        r("DELETE", "/api/v5/banned/{as}/{who}", self._banned_delete)
        r("GET", "/api/v5/api_key", lambda q: self.api_keys.list())
        r("POST", "/api/v5/api_key", self._api_key_create)
        r("DELETE", "/api/v5/api_key/{name}", self._api_key_delete)
        # ref: apps/emqx_license/src/emqx_license_http_api.erl (the
        # reference's node always has a license checker)
        r("GET", "/api/v5/license", self._license_info)
        r("POST", "/api/v5/license", self._license_update)
        r("PUT", "/api/v5/license/setting", self._license_setting)
        # dashboard SSO (ref: apps/emqx_dashboard_sso)
        r("GET", "/api/v5/sso", lambda q: self.sso.info())
        r("GET", "/api/v5/sso/running", lambda q: self.sso.running())
        r("PUT", "/api/v5/sso/{backend}", self._sso_update)
        r("DELETE", "/api/v5/sso/{backend}", self._sso_delete)
        r("POST", "/api/v5/sso/login/{backend}", self._sso_login)
        r("GET", "/api/v5/sso/oidc/login_url", self._sso_oidc_login_url)
        r("GET", "/api/v5/sso/oidc/callback", self._sso_oidc_callback)
        r("GET", "/api/v5/rules", self._rules_list)
        r("POST", "/api/v5/rules", self._rules_create)
        r("GET", "/api/v5/rules/{id}", self._rules_one)
        r("PUT", "/api/v5/rules/{id}", self._rules_update)
        r("DELETE", "/api/v5/rules/{id}", self._rules_delete)
        r("POST", "/api/v5/rule_test", self._rule_test)
        if self.obs is not None:
            # obs routes exist only when the layer is wired; otherwise
            # the dispatcher's plain 404 answers for them
            r("GET", "/api/v5/prometheus/stats", self._prometheus)
            r("GET", "/api/v5/alarms", self._alarms_list)
            r("DELETE", "/api/v5/alarms", self._alarms_clear)
            r("GET", "/api/v5/slow_subscriptions", self._slow_subs)
            r("DELETE", "/api/v5/slow_subscriptions", self._slow_subs_clear)
            r("GET", "/api/v5/trace", self._trace_list)
            r("POST", "/api/v5/trace", self._trace_create)
            r("DELETE", "/api/v5/trace/{name}", self._trace_delete)
            r("PUT", "/api/v5/trace/{name}/stop", self._trace_stop)
            r("GET", "/api/v5/trace/{name}/log", self._trace_log)
            # flight recorder (black-box diagnostics): status + ring
            # tail, manual snapshot trigger, bundle list/download
            r("GET", "/api/v5/xla/flight", self._flight_status)
            r("POST", "/api/v5/xla/flight/snapshot", self._flight_snapshot)
            r("GET", "/api/v5/xla/flight/snapshots", self._flight_snapshots)
            r(
                "GET", "/api/v5/xla/flight/snapshots/{name}",
                self._flight_snapshot_one,
            )
            # delivery-path microscope: sampling-profiler status, top
            # stacks per sub-stage, collapsed flamegraph text
            r("GET", "/api/v5/xla/profile", self._xla_profile)
        # kernel telemetry reads the router's always-on collector, so
        # it is live even without the obs bundle wired
        r("GET", "/api/v5/xla/telemetry", self._xla_telemetry)
        # publish sentinel: audit verdicts, stage attribution, SLO burn
        # state; ?cluster=true rolls the whole membership up over RPC
        r("GET", "/api/v5/xla/sentinel", self._xla_sentinel)
        r("GET", "/api/v5/audit", self._audit_list)
        r("GET", "/api/v5/file_transfer/files", self._ft_files)
        r("GET", "/api/v5/gateways", self._gateways_list)
        r("GET", "/api/v5/gateways/{name}", self._gateway_one)
        r("PUT", "/api/v5/gateways/{name}", self._gateway_put)
        r("DELETE", "/api/v5/gateways/{name}", self._gateway_delete)
        r("GET", "/api/v5/listeners", self._listeners_list)
        r("POST", "/api/v5/listeners/{id}/stop", self._listener_stop)
        r("POST", "/api/v5/listeners/{id}/start", self._listener_start)
        r("GET", "/api/v5/cluster", self._cluster_view)
        r("GET", "/api/v5/plugins", self._plugins_list)
        r("GET", "/api/v5/bridges", self._bridges_list)
        r("GET", "/api/v5/bridges/{name}", self._bridge_one)
        r("GET", "/api/v5/swagger.json", self._swagger)
        r("GET", "/api/v5/monitor", self._monitor_window)
        r("GET", "/api/v5/monitor_current", self._monitor_current)
        r("GET", "/api/v5/mqtt/topic_metrics", self._topic_metrics_list)
        r("POST", "/api/v5/mqtt/topic_metrics", self._topic_metrics_add)
        r(
            "DELETE", "/api/v5/mqtt/topic_metrics/{topic...}",
            self._topic_metrics_del,
        )
        r("POST", "/api/v5/load_rebalance/purge/start", self._purge_start)
        r("POST", "/api/v5/load_rebalance/purge/stop", self._purge_stop)
        r("POST", "/api/v5/plugins/install", self._plugin_install)
        r("PUT", "/api/v5/plugins/{name}/start", self._plugin_start)
        r("PUT", "/api/v5/plugins/{name}/stop", self._plugin_stop)
        r("DELETE", "/api/v5/plugins/{name}", self._plugin_delete)
        r("POST", "/api/v5/load_rebalance/evacuation/start", self._evac_start)
        r("POST", "/api/v5/load_rebalance/evacuation/stop", self._evac_stop)
        r("GET", "/api/v5/load_rebalance/status", self._evac_status)
        r("POST", "/api/v5/data/export", self._data_export)
        r("GET", "/api/v5/data/files", self._data_files)
        r("POST", "/api/v5/data/import", self._data_import)
        r("GET", "/api/v5/mqtt/retainer/messages", self._retained_list)
        r("GET", "/api/v5/mqtt/retainer/message/{topic...}", self._retained_one)
        r("DELETE", "/api/v5/mqtt/retainer/message/{topic...}", self._retained_delete)

    # --- handlers ---------------------------------------------------------

    def _audit_mw(self, req: Request, resp) -> None:
        """Record every mutating API call with its outcome
        (emqx_audit: intercepted at the REST layer)."""
        if req.method in ("POST", "PUT", "DELETE") and req.path != "/api/v5/login":
            self.audit.record(
                getattr(req, "principal", "?"),
                "api",
                f"{req.method} {req.path}",
                result="ok" if resp.status < 400 else "failed",
                code=resp.status,
            )

    # --- gateways / listeners / cluster -----------------------------------

    def _gateways_list(self, req: Request):
        raise not_ported(req)

    def _gateway_one(self, req: Request):
        raise not_ported(req)

    def _gateway_put(self, req: Request):
        raise not_ported(req)

    def _gateway_delete(self, req: Request):
        raise not_ported(req)

    def _listeners_list(self, req: Request):
        if self.listeners is not None:
            return self.listeners.info()
        return views.listeners_view(self.broker)

    def _split_listener_id(self, req: Request):
        lid = req.params["id"]
        if ":" not in lid:
            raise ValueError("listener id is <type>:<name>")
        return lid.split(":", 1)

    async def _listener_stop(self, req: Request):
        if self.listeners is None:
            return Response.error(404, "NOT_FOUND", "no listener manager")
        ltype, name = self._split_listener_id(req)
        ok = await self.listeners.stop(ltype, name)
        return (204, None) if ok else Response.error(
            404, "NOT_FOUND", req.params["id"]
        )

    async def _listener_start(self, req: Request):
        if self.listeners is None:
            return Response.error(404, "NOT_FOUND", "no listener manager")
        ltype, name = self._split_listener_id(req)
        conf = req.json() or self.listeners.conf_of(ltype, name)
        if conf is None:
            return Response.error(
                404, "NOT_FOUND", f"no stored config for {req.params['id']}"
            )
        srv = await self.listeners.start(ltype, name, conf)
        return {"id": srv.name, "bind": f"{srv.listen_addr[0]}:{srv.listen_addr[1]}"}

    def _cluster_view(self, req: Request):
        # a single node: the reference's answer with no ClusterNode
        return {"name": "standalone", "nodes": [self.node_name]}

    def _swagger(self, q):
        """OpenAPI 3 document generated from the live route table
        (emqx_dashboard_swagger analog: the spec IS the router, so it
        cannot drift from the implementation)."""
        paths: Dict[str, Dict[str, Any]] = {}
        for rt in self.http._routes:
            parts = []
            params = []
            for seg in rt.pattern.split("/"):
                if seg.startswith("{") and seg.endswith("}"):
                    name = seg[1:-1]
                    if name.endswith("..."):
                        name = name[:-3]
                    params.append(name)
                    parts.append("{" + name + "}")
                else:
                    parts.append(seg)
            path = "/".join(parts)
            doc = (getattr(rt.handler, "__doc__", None) or "").strip()
            op = {
                "summary": doc.split("\n")[0] if doc else rt.pattern,
                "tags": [path.split("/")[3] if path.count("/") >= 3 else "misc"],
                "parameters": [
                    {
                        "name": p,
                        "in": "path",
                        "required": True,
                        "schema": {"type": "string"},
                    }
                    for p in params
                ],
                "responses": {"200": {"description": "OK"}},
                "security": [{"basicAuth": []}, {"bearerAuth": []}],
            }
            paths.setdefault(path, {})[rt.method.lower()] = op
        return {
            "openapi": "3.0.0",
            "info": {
                "title": "EMQX-TPU Management API",
                "version": "5.0",
            },
            "components": {
                "securitySchemes": {
                    "basicAuth": {"type": "http", "scheme": "basic"},
                    "bearerAuth": {"type": "http", "scheme": "bearer"},
                }
            },
            "paths": paths,
        }

    # --- topic metrics (emqx_topic_metrics) ----------------------------

    def _monitor(self):
        if getattr(self, "monitor", None) is None:
            from ..obs.monitor import Monitor

            self.monitor = Monitor(self.broker)
            # flight snapshot bundles carry the monitor series tail
            fl = getattr(self.obs, "flight", None)
            if fl is not None and fl.monitor is None:
                fl.monitor = self.monitor
        return self.monitor

    def _monitor_window(self, req: Request):
        """Sampled rate window (emqx_dashboard_monitor)."""
        latest = None
        if req is not None and req.query.get("latest"):
            try:
                latest = int(req.query["latest"])
            except ValueError:
                return Response.error(400, "BAD_REQUEST", "bad latest")
        m = self._monitor()
        if not m.samples:
            m.sample()
        return m.window(latest)

    def _monitor_current(self, q):
        return self._monitor().current()

    def _topic_metrics(self):
        if getattr(self, "topic_metrics", None) is None:
            # share the obs bundle's registry when wired, so the REST
            # surface and the Prometheus scrape serve one instance
            tm = getattr(self.obs, "topic_metrics", None)
            if tm is None:
                from ..obs.topic_metrics import TopicMetrics

                tm = TopicMetrics(self.broker)
            self.topic_metrics = tm
        return self.topic_metrics

    def _topic_metrics_list(self, q):
        return self._topic_metrics().list()

    def _topic_metrics_add(self, req: Request):
        body = req.json() or {}
        topic = body.get("topic", "")
        try:
            self._topic_metrics().register(topic)
        except (ValueError, OverflowError) as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        return self._topic_metrics().metrics(topic)

    def _topic_metrics_del(self, req: Request):
        if not self._topic_metrics().deregister(req.params["topic"]):
            return Response.error(404, "NOT_FOUND", "topic not registered")
        return Response(204)

    # --- rebalance purge (emqx_node_rebalance_purge) --------------------

    def _purge_start(self, req: Request):
        raise not_ported(req)

    def _purge_stop(self, req: Request):
        raise not_ported(req)

    def _bridges_list(self, req: Request):
        raise not_ported(req)

    def _bridge_one(self, req: Request):
        raise not_ported(req)

    def _plugins_list(self, req: Request):
        raise not_ported(req)

    def _plugin_install(self, req: Request):
        raise not_ported(req)

    def _plugin_start(self, req: Request):
        raise not_ported(req)

    def _plugin_stop(self, req: Request):
        raise not_ported(req)

    def _plugin_delete(self, req: Request):
        raise not_ported(req)

    def _ft_files(self, req: Request):
        # no file transfer (its keys are refused): the reference's
        # answer with no FileTransfer
        return _paginate([], req.query)

    def _evac_start(self, req: Request):
        raise not_ported(req)

    def _evac_stop(self, req: Request):
        raise not_ported(req)

    def _evac_status(self, req: Request):
        raise not_ported(req)

    def _audit_list(self, req: Request):
        return _paginate(
            self.audit.list(
                actor=req.query.get("actor"),
                via=req.query.get("via"),
            ),
            req.query,
        )

    async def _data_export(self, req: Request):
        from .backup import collect_sections, write_backup

        # snapshot ON the loop (reads live tables), tar+gzip OFF it
        sections = collect_sections(
            broker=self.broker,
            config=self.config,
            rules=self.rules,
            banned=self.banned,
            api_keys=self.api_keys,
            node_name=self.node_name,
        )
        path = await asyncio.to_thread(write_backup, self.backup_dir, sections)
        return {"filename": os.path.basename(path), "path": path}

    def _data_files(self, req: Request):
        try:
            files = sorted(
                f for f in os.listdir(self.backup_dir)
                if f.startswith("emqx-export-")
            )
        except OSError:
            files = []
        return {"files": files}

    async def _data_import(self, req: Request):
        from .backup import import_backup

        body = req.json() or {}
        fname = body.get("filename")
        if not fname:
            raise ValueError("filename required")
        if "/" in fname or fname.startswith("."):
            raise ValueError("bad filename")
        path = os.path.join(self.backup_dir, fname)
        if not os.path.isfile(path):
            return Response.error(404, "NOT_FOUND", fname)
        from .backup import read_sections

        # archive IO off-loop; state mutation ON the loop
        sections = await asyncio.to_thread(read_sections, path)
        conf = sections.get("config.json")
        if conf and self.config is not None:
            # a section that would turn a refused key on applies nothing
            from ..config.config import Config

            merged = Config(self.config.schema, self.config.to_dict())
            merged.load_overrides(json.dumps(conf))
            refused = new_refusal(self.config, merged, self.n_cards)
            if refused is not None:
                raise refused
        return import_backup(
            path,
            broker=self.broker,
            config=self.config,
            rules=self.rules,
            banned=self.banned,
            api_keys=self.api_keys,
            sections=sections,
        )

    def _status(self, req: Request) -> Response:
        return Response.text(
            f"Node {self.node_name} is started\nemqx is running"
        )

    def _node_info(self) -> Dict[str, Any]:
        return {
            "node": self.node_name,
            "node_status": "running",
            "uptime": int((time.time() - self.started_at) * 1000),
            "version": "0.1.0",
            "edition": "Opensource",
            "connections": sum(
                1 for s in self.broker.sessions.values() if s.connected
            ),
            "live_connections": sum(
                1 for s in self.broker.sessions.values() if s.connected
            ),
            "cluster_members": [self.node_name],
        }

    def _nodes(self, req: Request):
        return [self._node_info()]

    def _node_one(self, req: Request):
        info = self._node_info()
        if req.params["node"] not in (self.node_name, "self"):
            return Response.error(404, "NOT_FOUND", req.params["node"])
        return info

    def _client_info(self, s) -> Dict[str, Any]:
        return {
            "clientid": s.client_id,
            "connected": s.connected,
            "created_at": s.created_at,
            "subscriptions_cnt": len(s.subscriptions),
            "mqueue_len": len(s.mqueue),
            "inflight_cnt": len(s.inflight),
            "mqueue_dropped": s.dropped,
            "expiry_interval": s.cfg.session_expiry_interval,
        }

    def _clients(self, req: Request):
        items = [self._client_info(s) for s in self.broker.sessions.values()]
        like = req.query.get("like_clientid")
        if like:
            items = [c for c in items if like in c["clientid"]]
        if "conn_state" in req.query:
            want = req.query["conn_state"] == "connected"
            items = [c for c in items if c["connected"] == want]
        return _paginate(items, req.query)

    def _get_session(self, req: Request):
        return self.broker.sessions.get(req.params["clientid"])

    def _client_one(self, req: Request):
        s = self._get_session(req)
        if s is None:
            return Response.error(404, "CLIENTID_NOT_FOUND", req.params["clientid"])
        return self._client_info(s)

    def _client_kick(self, req: Request):
        s = self._get_session(req)
        if s is None:
            return Response.error(404, "CLIENTID_NOT_FOUND", req.params["clientid"])
        self.broker.close_session(s, discard=True)
        return 204, None

    def _client_subs(self, req: Request):
        s = self._get_session(req)
        if s is None:
            return Response.error(404, "CLIENTID_NOT_FOUND", req.params["clientid"])
        return [
            {"topic": flt, "qos": o.qos, "clientid": s.client_id}
            for flt, o in s.subscriptions.items()
        ]

    def _client_subscribe(self, req: Request):
        s = self._get_session(req)
        if s is None:
            return Response.error(404, "CLIENTID_NOT_FOUND", req.params["clientid"])
        body = req.json() or {}
        try:
            flt = body["topic"]
            opts = SubOpts(qos=int(body.get("qos", 0)))
            retained = self.broker.subscribe(s, flt, opts)
        except (KeyError, ValueError) as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        views.deliver_retained(self.broker, s, retained, opts)
        return {"clientid": s.client_id, "topic": flt, "qos": opts.qos}

    def _client_unsubscribe(self, req: Request):
        s = self._get_session(req)
        if s is None:
            return Response.error(404, "CLIENTID_NOT_FOUND", req.params["clientid"])
        body = req.json() or {}
        try:
            self.broker.unsubscribe(s, body["topic"])
        except (KeyError, ValueError) as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        return 204, None

    def _subscriptions(self, req: Request):
        items = [
            {"clientid": cid, "topic": flt, "qos": opts.qos}
            for (flt, cid), opts in self.broker.suboptions.items()
        ]
        if "clientid" in req.query:
            items = [x for x in items if x["clientid"] == req.query["clientid"]]
        if "topic" in req.query:
            items = [x for x in items if x["topic"] == req.query["topic"]]
        if "qos" in req.query:
            try:
                want_qos = int(req.query["qos"])
            except ValueError:
                raise ValueError("qos must be an integer") from None
            items = [x for x in items if x["qos"] == want_qos]
        if "match_topic" in req.query:
            t = topic_mod.words(req.query["match_topic"])
            items = [
                x
                for x in items
                if topic_mod.match(
                    t, topic_mod.words(topic_mod.parse_share(x["topic"])[1])
                )
            ]
        return _paginate(items, req.query)

    def _topics(self, req: Request):
        """Cluster route table view (emqx_mgmt_api_topics)."""
        routes = [
            {"topic": flt, "node": node}
            for (flt, node) in views.routes_view(self.broker, self.node_name)
        ]
        if "topic" in req.query:
            routes = [x for x in routes if x["topic"] == req.query["topic"]]
        return _paginate(routes, req.query)

    def _msg_from_body(self, body: Dict[str, Any]) -> Message:
        payload = body.get("payload", "")
        if body.get("payload_encoding") == "base64":
            data = base64.b64decode(payload)
        else:
            data = payload.encode("utf-8") if isinstance(payload, str) else payload
        topic_mod.validate_name(body["topic"])
        return Message(
            topic=body["topic"],
            payload=data,
            qos=int(body.get("qos", 0)),
            retain=bool(body.get("retain", False)),
            props=body.get("properties", {}) or {},
        )

    def _publish(self, req: Request):
        try:
            msg = self._msg_from_body(req.json() or {})
        except (KeyError, ValueError) as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        n = self.broker.publish(msg)
        return {"id": msg.id, "delivered": n}

    def _publish_bulk(self, req: Request):
        try:
            msgs = [self._msg_from_body(b) for b in (req.json() or [])]
        except (KeyError, ValueError) as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        counts = self.broker.publish_batch(msgs)
        return [
            {"id": m.id, "delivered": n} for m, n in zip(msgs, counts)
        ]

    def _config_all(self, req: Request):
        if self.config is None:
            return Response.error(404, "NO_CONFIG", "no config attached")
        return self.config.to_dict()

    def _config_get(self, req: Request):
        if self.config is None:
            return Response.error(404, "NO_CONFIG", "no config attached")
        path = req.params["path"].replace("/", ".")
        try:
            return {"value": self.config.get(path)}
        except KeyError:
            return Response.error(404, "CONFIG_PATH_NOT_FOUND", path)

    def _config_put(self, req: Request):
        if self.config is None:
            return Response.error(404, "NO_CONFIG", "no config attached")
        path = req.params["path"].replace("/", ".")
        body = req.json()
        try:
            self._check_config_update(path, body["value"])
            self.config.update(path, body["value"])
        except KeyError:
            return Response.error(400, "BAD_REQUEST", "body must be {\"value\": ...}")
        except NotPortedError:
            raise
        except Exception as e:
            return Response.error(400, "UPDATE_FAILED", str(e))
        return {"value": self.config.get(path)}

    def _check_config_update(self, path: str, value) -> None:
        """Raise NotPortedError if the update would turn a refused key
        on (tried on a copy: nothing is applied)."""
        from ..config.config import Config, UpdateError

        trial = Config(self.config.schema, self.config.to_dict())
        try:
            trial.update(path, value)
        except UpdateError:
            return  # the real update raises the reference's error
        refused = new_refusal(self.config, trial, self.n_cards)
        if refused is not None:
            raise refused

    def _banned_list(self, req: Request):
        if self.banned is None:
            return _paginate([], req.query)
        items = [
            {
                "as": e.who_type,
                "who": e.who,
                "by": e.by,
                "reason": e.reason,
                "until": e.until,
            }
            for e in self.banned.list()
        ]
        return _paginate(items, req.query)

    # --- dashboard SSO (emqx_dashboard_sso) ---------------------------

    def _sso_update(self, req: Request):
        from .sso import SsoError

        try:
            b = self.sso.update(req.params["backend"], req.json() or {})
        except SsoError as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        return b.info()

    def _sso_delete(self, req: Request):
        if not self.sso.delete(req.params["backend"]):
            return Response.error(404, "NOT_FOUND", "no such sso backend")
        return Response(204)

    def _sso_login(self, req: Request):
        from .sso import not_ported as sso_not_ported

        name = req.params["backend"]
        if name in ("ldap", "oidc"):
            raise sso_not_ported(name)
        return Response.error(404, "NOT_FOUND", f"sso {name} not running")

    def _sso_oidc_login_url(self, req: Request):
        from .sso import not_ported as sso_not_ported

        raise sso_not_ported("oidc")

    def _sso_oidc_callback(self, req: Request):
        from .sso import not_ported as sso_not_ported

        raise sso_not_ported("oidc")

    def _license_info(self, req: Request):
        raise not_ported(req)

    def _license_update(self, req: Request):
        raise not_ported(req)

    def _license_setting(self, req: Request):
        raise not_ported(req)

    def _banned_create(self, req: Request):
        if self.banned is None:
            return Response.error(404, "NO_BANNED", "banned table not attached")
        b = req.json() or {}
        try:
            until = b.get("until")
            duration = (
                None if until is None else max(0.0, float(until) - time.time())
            )
            self.banned.create(
                b["as"],
                b["who"],
                by=b.get("by", req.principal or "mgmt_api"),
                reason=b.get("reason", ""),
                duration_s=duration,
            )
        except KeyError as e:
            return Response.error(400, "BAD_REQUEST", f"missing field {e}")
        except ValueError as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        return 201, b

    def _banned_delete(self, req: Request):
        if self.banned is None or not self.banned.delete(
            req.params["as"], req.params["who"]
        ):
            return Response.error(404, "NOT_FOUND", req.params["who"])
        return 204, None

    def _api_key_create(self, req: Request):
        b = req.json() or {}
        try:
            return 201, self.api_keys.create(
                b["name"],
                desc=b.get("desc", ""),
                enable=b.get("enable", True),
                expired_at=b.get("expired_at"),
            )
        except KeyError:
            return Response.error(400, "BAD_REQUEST", "missing name")
        except ValueError as e:
            return Response.error(400, "NAME_EXISTS", str(e))

    def _api_key_delete(self, req: Request):
        if not self.api_keys.delete(req.params["name"]):
            return Response.error(404, "NOT_FOUND", req.params["name"])
        return 204, None

    # --- rules ------------------------------------------------------------

    def _rule_info(self, rule) -> Dict[str, Any]:
        return {
            "id": rule.id,
            "sql": rule.sql,
            "enable": rule.enable,
            "description": rule.description,
            "actions": rule.actions,
            "metrics": {
                "matched": rule.metrics.matched,
                "passed": rule.metrics.passed,
                "failed": rule.metrics.failed,
                "no_result": rule.metrics.no_result,
                "actions.success": rule.metrics.actions_success,
                "actions.failed": rule.metrics.actions_failed,
            },
        }

    def _rules_list(self, req: Request):
        if self.rules is None:
            return _paginate([], req.query)
        return _paginate(
            [self._rule_info(r) for r in self.rules.rules.values()], req.query
        )

    def _rules_create(self, req: Request):
        if self.rules is None:
            return Response.error(404, "NO_RULES", "rule engine not attached")
        b = req.json() or {}
        try:
            rule = self.rules.create_rule(
                sql=b["sql"],
                actions=b.get("actions", []),
                rule_id=b.get("id") or f"rule_{uuid.uuid4().hex[:8]}",
                enable=b.get("enable", True),
                description=b.get("description", ""),
            )
        except KeyError:
            return Response.error(400, "BAD_REQUEST", "missing sql")
        except Exception as e:
            return Response.error(400, "BAD_SQL", str(e))
        return 201, self._rule_info(rule)

    def _rules_one(self, req: Request):
        rule = self.rules.rules.get(req.params["id"]) if self.rules else None
        if rule is None:
            return Response.error(404, "NOT_FOUND", req.params["id"])
        return self._rule_info(rule)

    def _rules_update(self, req: Request):
        if self.rules is None:
            return Response.error(404, "NO_RULES", "rule engine not attached")
        b = req.json() or {}
        try:
            rule = self.rules.update_rule(req.params["id"], **b)
        except KeyError:
            return Response.error(404, "NOT_FOUND", req.params["id"])
        except Exception as e:
            return Response.error(400, "BAD_SQL", str(e))
        return self._rule_info(rule)

    def _rules_delete(self, req: Request):
        if self.rules is None or not self.rules.delete_rule(req.params["id"]):
            return Response.error(404, "NOT_FOUND", req.params["id"])
        return 204, None

    def _rule_test(self, req: Request):
        """Dry-run a SQL statement against a test context
        (emqx_rule_sqltester)."""
        if self.rules is None:
            return Response.error(404, "NO_RULES", "rule engine not attached")
        b = req.json() or {}
        try:
            out = self.rules.test_sql(b["sql"], b.get("context", {}))
        except KeyError:
            return Response.error(400, "BAD_REQUEST", "missing sql")
        except Exception as e:
            return Response.error(400, "BAD_SQL", str(e))
        if out is None:
            return Response.error(412, "SQL_NOT_MATCH", "no match")
        return out

    # --- retainer ---------------------------------------------------------

    # --- observability (obs layer: prometheus/alarms/slow_subs/trace) ----
    # (routes only registered when self.obs is wired)

    def _prometheus(self, req: Request):
        return Response(
            status=200,
            body=self.obs.prometheus_text().encode(),
            content_type="text/plain; version=0.0.4",
        )

    def _flight(self):
        return getattr(self.obs, "flight", None)

    def _flight_status(self, req: Request):
        """Flight-recorder status + recent ring events (black-box
        tail; ?limit= bounds the event count, default 100)."""
        fl = self._flight()
        if fl is None:
            return {"enabled": False}
        try:
            limit = max(0, int(req.query.get("limit", "100")))
        except ValueError:
            return Response.error(400, "BAD_REQUEST", "bad limit")
        out = fl.status()
        out["events"] = fl.recorder.recent(limit)
        return out

    def _flight_snapshot(self, req: Request):
        """Manual snapshot trigger: freeze the ring and persist a
        bundle now (no cooldown — the operator asked)."""
        fl = self._flight()
        if fl is None:
            return Response.error(404, "NOT_FOUND", "flight recorder not enabled")
        body = req.json() or {}
        path = fl.snapshot(
            reason=str(body.get("reason", "manual")),
            details={"requested_by": getattr(req, "principal", "?")},
        )
        return 201, {"path": path, "name": os.path.basename(path)}

    def _flight_snapshots(self, req: Request):
        fl = self._flight()
        if fl is None:
            return Response.error(404, "NOT_FOUND", "flight recorder not enabled")
        return _paginate(fl.store.list(), req.query)

    def _flight_snapshot_one(self, req: Request):
        fl = self._flight()
        if fl is None:
            return Response.error(404, "NOT_FOUND", "flight recorder not enabled")
        try:
            return fl.store.read(req.params["name"])
        except KeyError:
            return Response.error(404, "NOT_FOUND", req.params["name"])

    def _xla_telemetry(self, req: Request):
        """Runtime view of the kernel-telemetry collector: dispatch
        percentiles per leg, recompile/shape-bucket state, DeviceTable
        gauges — the same numbers the emqx_xla_* Prometheus families
        render (obs/kernel_telemetry.py snapshot())."""
        tel = getattr(self.broker.router, "telemetry", None)
        if tel is None:
            return {"enabled": False}
        out = tel.snapshot()
        st = getattr(self.broker, "sentinel", None)
        if st is not None:
            # per-stage publish attribution + exemplar topic/trace ids
            # for the sampled publishes (obs/sentinel.py)
            out["publish_stages"] = st.stage_snapshot()
        eng = getattr(self.broker, "engine", None)
        if eng is not None:
            # device failure domain: breaker state machine + admission
            # control, straight off the engine (dispatch_engine.status)
            es = eng.status()
            out["dispatch_engine"] = {
                "breaker": es["breaker"],
                "admission": es["admission"],
                "coalesce_factor": es["coalesce_factor"],
                # device-occupancy timeline: per-slot launch->land
                # spans, gaps, and the ring busy-ratio
                "ring": es.get("ring"),
            }
        ll = getattr(self.obs, "loop_lag", None)
        if ll is not None:
            # co-tenant scheduling delay, measured on its own ticker so
            # the delivery sub-stages never absorb it
            out["loop_lag"] = ll.status()
        scope = getattr(
            getattr(self.broker.router, "device_table", None), "scope", None
        )
        if scope is not None:
            # mesh microscope: per-dispatch stage decomposition +
            # collective-cost ledger (obs/mesh_scope.py)
            out["mesh_scope"] = scope.status()
        return out

    def _xla_profile(self, req: Request):
        """GET /api/v5/xla/profile — the delivery-path microscope
        (obs/profiler.py): sampler status + top stacks per delivery
        sub-stage. `?format=collapsed` returns flamegraph.pl
        collapsed-stack text (scope with `&stage=<sub-stage>`,
        `&which=cpu` for on-CPU samples); `?arm=<seconds>` arms the
        sampler for a bounded window before answering; `?top=N` sizes
        the per-stage stack lists."""
        prof = getattr(self.obs, "profiler", None)
        if prof is None:
            return Response.error(404, "NOT_FOUND", "profiler not wired")
        arm = req.query.get("arm")
        if arm is not None:
            try:
                prof.arm_for(float(arm))
            except ValueError:
                return Response.error(400, "BAD_REQUEST", f"bad arm: {arm}")
        which = req.query.get("which", "wall")
        stage = req.query.get("stage") or None
        if req.query.get("format") == "collapsed":
            return Response.text(
                prof.collapsed(stage=stage, which=which) + "\n"
            )
        try:
            top_n = int(req.query.get("top", "10"))
        except ValueError:
            return Response.error(400, "BAD_REQUEST", "bad top")
        out = prof.snapshot(top_n=top_n)
        ll = getattr(self.obs, "loop_lag", None)
        if ll is not None:
            out["loop_lag"] = ll.status()
        return out

    def _xla_sentinel(self, req: Request):
        """GET /api/v5/xla/sentinel — the publish-path watchdog state:
        shadow-audit counters + recent divergences, quarantine set,
        stage histograms, SLO burn rates. On a single node
        `?cluster=true` answers the local state, as the reference does
        with no ClusterNode."""
        st = getattr(self.broker, "sentinel", None)
        if st is None:
            return {"enabled": False}
        return st.status()

    def _alarms_list(self, req: Request):
        which = "all"
        if req.query.get("activated") == "true":
            which = "activated"
        elif req.query.get("activated") == "false":
            which = "deactivated"
        return _paginate(self.obs.alarms.get_alarms(which), req.query)

    def _alarms_clear(self, req: Request):
        self.obs.alarms.delete_all_deactivated()
        return Response(status=204)

    def _slow_subs(self, req: Request):
        return _paginate(self.obs.slow_subs.topk(), req.query)

    def _slow_subs_clear(self, req: Request):
        self.obs.slow_subs.clear()
        return Response(status=204)

    def _trace_list(self, req: Request):
        return self.obs.traces.list()

    def _trace_create(self, req: Request):
        body = req.json() or {}
        ttype = body.get("type", "")
        flt = body.get(ttype) or body.get("filter", "")
        try:
            self.obs.traces.create(
                name=body.get("name", ""),
                type=ttype,
                filter=flt,
                formatter=body.get("formatter", "text"),
                end_at=body.get("end_at"),
            )
        except ValueError as e:
            return Response.error(400, "BAD_REQUEST", str(e))
        return Response.json({"name": body.get("name", "")}, status=200)

    def _trace_delete(self, req: Request):
        try:
            self.obs.traces.delete(req.params["name"])
        except KeyError:
            return Response.error(404, "NOT_FOUND", req.params["name"])
        return Response(status=204)

    def _trace_stop(self, req: Request):
        try:
            self.obs.traces.stop_trace(req.params["name"])
        except KeyError:
            return Response.error(404, "NOT_FOUND", req.params["name"])
        return {"name": req.params["name"], "status": "stopped"}

    def _trace_log(self, req: Request):
        try:
            return Response.text(self.obs.traces.read_log(req.params["name"]))
        except KeyError:
            return Response.error(404, "NOT_FOUND", req.params["name"])

    def _retained_info(self, m: Message) -> Dict[str, Any]:
        return {
            "topic": m.topic,
            "qos": m.qos,
            "payload": base64.b64encode(m.payload).decode(),
            "publish_at": m.timestamp,
            "from_clientid": m.from_client,
        }

    def _retained_list(self, req: Request):
        msgs = self.broker.retainer.read("#")
        return _paginate([self._retained_info(m) for m in msgs], req.query)

    def _retained_one(self, req: Request):
        msgs = self.broker.retainer.read(req.params["topic"])
        exact = [m for m in msgs if m.topic == req.params["topic"]]
        if not exact:
            return Response.error(404, "NOT_FOUND", req.params["topic"])
        return self._retained_info(exact[0])

    def _retained_delete(self, req: Request):
        t = req.params["topic"]
        if not [m for m in self.broker.retainer.read(t) if m.topic == t]:
            return Response.error(404, "NOT_FOUND", t)
        # retained delete = empty-payload retain (MQTT semantics)
        self.broker.retainer.retain(Message(topic=t, payload=b"", retain=True))
        return 204, None
