"""Rule engine runtime — emqx_rule_engine / emqx_rule_runtime analog
(the port's own copy of emqx_tpu/rules/engine.py).

Rules are indexed by their FROM topic filters in the SAME matcher
structure the router uses (the reference shares emqx_topic_index
between router and ?RULE_TOPIC_INDEX, apps/emqx_rule_engine/src/
emqx_rule_engine.erl:230-231,537,545 — BASELINE config #5). On
'message.publish' the engine matches the message topic against the
rule index (host trie for singles; the engine also exposes
`match_rules_batch` so the broker's device batch path can fold rule
matching into the same device dispatch), evaluates WHERE, binds the
SELECT fields, and feeds the result to the rule's actions.

Actions: console (debug log), republish (back into the broker with
placeholder-templated topic/payload/qos), function (any callable —
the bridge/action hookup point).
"""

from __future__ import annotations

import logging
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .. import jsonc
from ..broker.message import Message
from ..jsonc import dumps as _json_dumps, loads as _json_loads
from ..native import NativeBuildError
from ..ops import topic as topic_mod
from ..ops.host_index import TopicTrie
from . import events as ev
from .funcs import FUNCS, _str
from .sql import Select, SqlError, parse

log = logging.getLogger("emqx_tpu_torch.rules")

_UNDEF = object()


# --- expression evaluation ---------------------------------------------


def _get_path(env: Dict[str, Any], path: List[str]) -> Any:
    cur: Any = env
    for i, seg in enumerate(path):
        if seg == "*":
            return cur
        if isinstance(cur, (bytes, str)) and i >= 1:
            # payload.* auto-decodes JSON payloads (reference behavior)
            try:
                cur = _json_loads(cur if isinstance(cur, str) else cur.decode())
            except NativeBuildError:
                raise
            except Exception:
                return None
        if isinstance(cur, dict):
            cur = cur.get(seg, _UNDEF)
            if cur is _UNDEF:
                return None
        elif isinstance(cur, list):
            try:
                cur = cur[int(seg) - 1]
            except (ValueError, IndexError):
                return None
        else:
            return None
    if isinstance(cur, bytes):
        # strict-else-bytes keeps binary payloads LOSSLESS end to end:
        # a valid-utf8 payload round-trips through str (decode/encode
        # are inverse), an invalid one stays bytes for the binary
        # consumers (schema_decode of avro/protobuf wire payloads) —
        # 'replace' corrupted them irreversibly
        try:
            cur = cur.decode("utf-8")
        except UnicodeDecodeError:
            pass
    return cur


def _like(s: Any, pat: str) -> bool:
    rx = re.escape(pat).replace("%", ".*").replace("_", ".")
    return re.fullmatch(rx, _str(s)) is not None


def _eq(a: Any, b: Any) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if isinstance(a, (int, float)) or isinstance(b, (int, float)):
        try:
            return float(a) == float(b)
        except (TypeError, ValueError):
            return False
    return a == b


def eval_expr(e: Any, env: Dict[str, Any]) -> Any:
    op = e[0]
    if op == "lit":
        return e[1]
    if op == "path":
        return _get_path(env, e[1])
    if op == "index":
        obj = eval_expr(e[1], env)
        idx = eval_expr(e[2], env)
        if isinstance(obj, dict):
            return obj.get(_str(idx))
        if isinstance(obj, list):
            try:
                return obj[int(idx) - 1]
            except (ValueError, IndexError):
                return None
        return None
    if op == "and":
        return bool(eval_expr(e[1], env)) and bool(eval_expr(e[2], env))
    if op == "or":
        return bool(eval_expr(e[1], env)) or bool(eval_expr(e[2], env))
    if op == "not":
        return not bool(eval_expr(e[1], env))
    if op == "neg":
        return -eval_expr(e[1], env)
    if op in ("=", "!=", ">", "<", ">=", "<="):
        a, b = eval_expr(e[1], env), eval_expr(e[2], env)
        if op == "=":
            return _eq(a, b)
        if op == "!=":
            return not _eq(a, b)
        try:
            if op == ">":
                return a > b
            if op == "<":
                return a < b
            if op == ">=":
                return a >= b
            return a <= b
        except TypeError:
            return False
    if op in ("+", "-", "*", "/", "div", "mod"):
        a, b = eval_expr(e[1], env), eval_expr(e[2], env)
        if op == "+" and (isinstance(a, str) or isinstance(b, str)):
            return _str(a) + _str(b)
        try:
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a / b
            if op == "div":
                return int(a) // int(b)
            return int(a) % int(b)
        except (TypeError, ZeroDivisionError):
            return None
    if op == "in":
        v = eval_expr(e[1], env)
        return any(_eq(v, eval_expr(x, env)) for x in e[2])
    if op == "like":
        return _like(eval_expr(e[1], env), e[2])
    if op == "isnull":
        return eval_expr(e[1], env) is None
    if op == "case":
        for c, v in e[1]:
            if bool(eval_expr(c, env)):
                return eval_expr(v, env)
        return eval_expr(e[2], env)
    if op == "call":
        fn = FUNCS.get(e[1])
        if fn is None:
            raise SqlError(f"unknown function {e[1]!r}")
        if getattr(fn, "_wants_env", False):
            # message-context accessors (clientid(), payload(path), …)
            # read the event env directly, like the reference's
            # closure-over-message builtins (emqx_rule_funcs.erl:317-396)
            return fn(env, *(eval_expr(a, env) for a in e[2]))
        return fn(*(eval_expr(a, env) for a in e[2]))
    raise SqlError(f"bad expr node {op!r}")


def _public_env(env: Dict[str, Any]) -> Dict[str, Any]:
    # engine-internal keys (_proc_dict, _kv_store, _republish_depth)
    # must never appear in rows: a bare `SELECT *` republish would
    # otherwise serialize the whole engine-wide kv store into the
    # published payload
    return {k: v for k, v in env.items() if not k.startswith("_")}


def select_fields(sel: Select, env: Dict[str, Any]) -> Dict[str, Any]:
    """Bind the SELECT list; '*' keeps the (public) env."""
    if not sel.fields:
        return _public_env(env)
    out: Dict[str, Any] = {}
    for expr, alias in sel.fields:
        if expr == ("path", ["*"]):
            out.update(_public_env(env))
            continue
        val = eval_expr(expr, env)
        name = alias or (expr[1][-1] if expr[0] == "path" else "value")
        out[name] = val
    return out


_PLACEHOLDER = re.compile(r"\$\{([^}]+)\}")


def render_template(tpl: str, env: Dict[str, Any]) -> str:
    """${path.to.field} placeholder substitution (emqx_placeholder)."""
    return _PLACEHOLDER.sub(
        lambda m: _str(_get_path(env, m.group(1).split("."))), tpl
    )


# --- rules --------------------------------------------------------------


@dataclass
class RuleMetrics:
    matched: int = 0
    passed: int = 0
    failed: int = 0
    no_result: int = 0
    actions_success: int = 0
    actions_failed: int = 0


@dataclass
class Rule:
    id: str
    sql: str
    select: Select
    actions: List[Dict[str, Any]] = field(default_factory=list)
    enable: bool = True
    description: str = ""
    metrics: RuleMetrics = field(default_factory=RuleMetrics)
    created_at: float = field(default_factory=time.time)


class RuleEngine:
    def __init__(self, broker=None, ignore_sys: bool = True):
        self.broker = broker
        self.ignore_sys = ignore_sys
        self.rules: Dict[str, Rule] = {}
        # FROM-filter index, shared matcher shape with the router
        # (?RULE_TOPIC_INDEX analog)
        self._index = TopicTrie()
        self._event_rules: Dict[str, Set[str]] = {}  # event topic -> rule ids
        self._installed = False
        # named action providers: kind -> fn(args, row, env)
        self.action_providers: Dict[str, Any] = {}
        # per-rule proc dicts + engine-wide kv store (see apply_rule)
        self._proc_dicts: Dict[str, Dict[str, Any]] = {}
        self._kv_store: Dict[str, Any] = {}
        # batched WHERE leg (rules/batch_where.py): inside an open
        # batch_window(), vectorizable WHERE predicates defer into one
        # columnar mask evaluation at window close; everything else
        # (foreach, uncompilable predicates, fallback rows) re-runs
        # through eval_expr — the oracle — counted, never silently
        # wrong
        self.batch_where_enabled = False
        # the codec is built here, where a failed build raises, and not
        # on the first payload.* read, whose decode sits inside the
        # WHERE's catch-all (a failed codec there would read None)
        if jsonc.native_enabled():
            jsonc.load()
        self.telemetry = None  # KernelTelemetry handle (emqx_xla_rule_*)
        self._win_envs: Optional[List[Dict[str, Any]]] = None
        self._win_groups: Optional[Dict[str, Tuple[Rule, List[int]]]] = None
        self.where_stats = {
            "windows": 0,
            "batch_rows": 0,
            "fallback_rows": 0,
            "uncompiled_rows": 0,
        }

    # --- CRUD -----------------------------------------------------------

    def create_rule(
        self,
        rule_id: str,
        sql: str,
        actions: Optional[List[Dict[str, Any]]] = None,
        enable: bool = True,
        description: str = "",
    ) -> Rule:
        if rule_id in self.rules:
            raise ValueError(f"rule {rule_id!r} exists")
        sel = parse(sql)
        rule = Rule(rule_id, sql, sel, actions or [], enable, description)
        self.rules[rule_id] = rule
        for f in sel.froms:
            if ev.is_event_topic(f):
                self._event_rules.setdefault(f, set()).add(rule_id)
            else:
                self._index.insert(topic_mod.words(f), (rule_id, f))
        return rule

    def delete_rule(self, rule_id: str) -> bool:
        rule = self.rules.pop(rule_id, None)
        if rule is None:
            return False
        for f in rule.select.froms:
            if ev.is_event_topic(f):
                self._event_rules.get(f, set()).discard(rule_id)
            else:
                self._index.remove(topic_mod.words(f), (rule_id, f))
        # the proc dict dies with the rule (the reference's erlang
        # proc dict dies with the rule's process); a later rule that
        # reuses the id must start clean
        self._proc_dicts.pop(rule_id, None)
        return True

    def update_rule(self, rule_id: str, **kw) -> Rule:
        old = self.rules.get(rule_id)
        if old is None:
            raise KeyError(rule_id)
        sql = kw.get("sql", old.sql)
        parse(sql)  # validate BEFORE touching the live rule
        actions = kw.get("actions", old.actions)
        enable = kw.get("enable", old.enable)
        desc = kw.get("description", old.description)
        self.delete_rule(rule_id)
        return self.create_rule(rule_id, sql, actions, enable, desc)

    # --- matching -------------------------------------------------------

    def match_rules(self, topic: str) -> List[Rule]:
        # a rule with several FROM filters matching the same topic
        # still fires once (the reference dedups by rule id)
        seen = set()
        out = []
        for rid, _f in self._index.match(topic_mod.words(topic)):
            if rid in seen or rid not in self.rules:
                continue
            seen.add(rid)
            rule = self.rules[rid]
            if rule.enable:
                out.append(rule)
        return out

    def match_rules_batch(self, topics: Sequence[str]) -> List[List[Rule]]:
        """Batch-shaped API so the broker's device dispatch can carry
        rule matching in the same batch (config #5)."""
        return [self.match_rules(t) for t in topics]

    # --- evaluation -----------------------------------------------------

    MAX_REPUBLISH_DEPTH = 8

    def on_message_publish(self, msg: Message, acc=None):
        """'message.publish' hook body (emqx_rule_events.erl:80,118)."""
        if self.ignore_sys and msg.topic.startswith("$SYS/"):
            return None
        depth = int(msg.headers.get("republish_depth", 0))
        if depth >= self.MAX_REPUBLISH_DEPTH:
            log.warning("republish loop cut at depth %d on %s", depth, msg.topic)
            return None
        env = ev.message_event(msg)
        env["_republish_depth"] = depth
        by = msg.headers.get("republish_by")
        if self._win_envs is not None:
            # open batch window: defer WHERE-bearing single-row rules
            # into the columnar drain; foreach and WHERE-less rules
            # apply immediately (nothing to vectorize)
            ei = None
            for rule in self.match_rules(msg.topic):
                if by is not None and rule.id == by:
                    continue
                sel = rule.select
                if sel.foreach is not None or sel.where is None:
                    self.apply_rule(rule, env)
                    continue
                rule.metrics.matched += 1
                if ei is None:
                    ei = len(self._win_envs)
                    self._win_envs.append(env)
                self._win_groups.setdefault(rule.id, (rule, []))[1].append(ei)
            return None
        for rule in self.match_rules(msg.topic):
            if by is not None and rule.id == by:
                continue  # a rule never re-triggers itself
            self.apply_rule(rule, env)
        return None

    def on_event(self, event_topic: str, env: Dict[str, Any]) -> None:
        for rid in self._event_rules.get(event_topic, ()):
            rule = self.rules.get(rid)
            if rule is not None and rule.enable:
                self.apply_rule(rule, env)

    def _bind_env(self, rule: Rule, env: Dict[str, Any]) -> Dict[str, Any]:
        # proc_dict is scoped PER RULE (the reference's erlang proc
        # dict belongs to the evaluating process — rules must not see
        # each other's values); kv_store is engine-wide like the
        # reference's node-global ets (ADVICE r4)
        # a COPY per rule: the caller reuses one env across matching
        # rules, and injecting per-rule state into the shared dict
        # would hand every later rule the first rule's proc dict
        env = dict(env)
        env["_proc_dict"] = self._proc_dicts.setdefault(rule.id, {})
        env["_kv_store"] = self._kv_store
        return env

    def apply_rule(self, rule: Rule, env: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
        rule.metrics.matched += 1
        env = self._bind_env(rule, env)
        try:
            sel = rule.select
            rows: List[Dict[str, Any]]
            if sel.foreach is not None:
                coll = eval_expr(sel.foreach[0], env)
                if not isinstance(coll, list):
                    rule.metrics.no_result += 1
                    return None
                alias = sel.foreach[1] or "item"
                rows = []
                for item in coll:
                    ienv = {**env, alias: item, "item": item}
                    if sel.incase is not None and not bool(eval_expr(sel.incase, ienv)):
                        continue
                    if sel.where is not None and not bool(eval_expr(sel.where, ienv)):
                        continue
                    rows.append(select_fields(sel, ienv))
                if not rows:
                    rule.metrics.no_result += 1
                    return None
            else:
                if sel.where is not None and not bool(eval_expr(sel.where, env)):
                    rule.metrics.no_result += 1
                    return None
                rows = [select_fields(sel, env)]
            rule.metrics.passed += 1
        except NativeBuildError:  # a codec that cannot build is no rule's fault
            raise
        except Exception:
            rule.metrics.failed += 1
            log.exception("rule %s evaluation failed", rule.id)
            return None
        for row in rows:
            self._run_actions(rule, row, env)
        return rows

    def _finish_rule(self, rule: Rule, env: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
        """Post-WHERE half of apply_rule for a single-row rule whose
        predicate already passed; env must be _bind_env-bound."""
        try:
            rows = [select_fields(rule.select, env)]
            rule.metrics.passed += 1
        except NativeBuildError:
            raise
        except Exception:
            rule.metrics.failed += 1
            log.exception("rule %s evaluation failed", rule.id)
            return None
        for row in rows:
            self._run_actions(rule, row, env)
        return rows

    def _apply_where_row(self, rule: Rule, env: Dict[str, Any]) -> None:
        """Per-row escalation for a batch-windowed rule: evaluate the
        WHERE through eval_expr (the oracle) and finish. `matched` was
        counted at enqueue time."""
        env = self._bind_env(rule, env)
        try:
            if not bool(eval_expr(rule.select.where, env)):
                rule.metrics.no_result += 1
                return
        except NativeBuildError:
            raise
        except Exception:
            rule.metrics.failed += 1
            log.exception("rule %s evaluation failed", rule.id)
            return
        self._finish_rule(rule, env)

    # --- batched WHERE window (rules/batch_where.py) --------------------

    @contextmanager
    def batch_window(self):
        """Defer WHERE evaluation for every 'message.publish' rule hit
        inside the window into one columnar mask drain at close. The
        broker's coalesced publish paths (publish_batch, the dispatch
        engine's _flush) open this around their _pre_publish fold.
        Nested windows are no-ops (the outermost drains)."""
        if not self.batch_where_enabled or self._win_envs is not None:
            yield
            return
        self._win_envs = []
        self._win_groups = {}
        try:
            yield
        finally:
            self._drain_window()

    def _drain_window(self) -> None:
        envs, self._win_envs = self._win_envs, None
        groups, self._win_groups = self._win_groups, None
        if not groups:
            return
        import numpy as np

        from .batch_where import ColumnBatch, compile_where

        tel = self.telemetry
        if tel is None and self.broker is not None:
            tel = getattr(self.broker.router, "telemetry", None)
        if tel is not None and not getattr(tel, "enabled", False):
            tel = None
        t0 = time.perf_counter()
        batch = ColumnBatch(envs)
        st = self.where_stats
        st["windows"] += 1
        n_vec = n_fb = n_unc = 0
        for rule, idxs in groups.values():
            comp = getattr(rule, "_where_compiled", _UNDEF)
            if comp is _UNDEF:
                comp = compile_where(rule.select.where)
                rule._where_compiled = comp
            if comp is None:
                n_unc += len(idxs)
                for i in idxs:
                    self._apply_where_row(rule, envs[i])
                continue
            ix = np.asarray(idxs, dtype=np.int64)
            try:
                mask, fb = comp.eval(batch, ix)
            except NativeBuildError:
                raise
            except Exception:
                log.exception(
                    "rule %s batched WHERE failed; per-row fallback", rule.id
                )
                n_fb += len(idxs)
                for i in idxs:
                    self._apply_where_row(rule, envs[i])
                continue
            n_vec += len(idxs)
            for j, i in enumerate(idxs):
                if fb[j]:
                    n_fb += 1
                    self._apply_where_row(rule, envs[i])
                elif mask[j]:
                    self._finish_rule(rule, self._bind_env(rule, envs[i]))
                else:
                    rule.metrics.no_result += 1
        st["batch_rows"] += n_vec
        st["fallback_rows"] += n_fb
        st["uncompiled_rows"] += n_unc
        if tel is not None:
            tel.count("rule_where_batch_rows_total", n_vec)
            tel.count("rule_where_fallback_rows_total", n_fb)
            tel.count("rule_where_uncompiled_rows_total", n_unc)
            tel.observe_family(
                "rule_where_batch_seconds", time.perf_counter() - t0
            )

    def _run_actions(self, rule: Rule, row: Dict[str, Any], env: Dict[str, Any]) -> None:
        for action in rule.actions:
            try:
                self._run_action({**action, "_rule_id": rule.id}, row, env)
                rule.metrics.actions_success += 1
            except NativeBuildError:
                raise
            except Exception:
                rule.metrics.actions_failed += 1
                log.exception("rule %s action %s failed", rule.id, action)

    def _run_action(self, action: Dict[str, Any], row: Dict[str, Any], env: Dict[str, Any]) -> None:
        kind = action.get("function", action.get("type", "console"))
        if kind == "console":
            log.info("[rule console] %s", _json_dumps(row, default=_str))
        elif kind == "republish":
            args = action.get("args", {})
            tpl_env = {**env, **row}
            topic = render_template(args.get("topic", "republish/${topic}"), tpl_env)
            payload_tpl = args.get("payload", "${payload}")
            payload = render_template(payload_tpl, tpl_env) if payload_tpl else _json_dumps(row, default=_str)
            qos_raw = args.get("qos", 0)
            qos = int(render_template(str(qos_raw), tpl_env)) if isinstance(qos_raw, str) else qos_raw
            if self.broker is None:
                raise RuntimeError("republish without a broker")
            out = Message(
                topic=topic,
                payload=payload.encode() if isinstance(payload, str) else payload,
                qos=qos,
                retain=bool(args.get("retain", False)),
                from_client=f"rule:{action.get('_rule_id', '')}",
            )
            # loop guards: a rule never re-triggers itself, and chains
            # across rules are depth-capped (the reference marks
            # republished messages and warns on loops)
            out.headers["republish_by"] = action.get("_rule_id")
            out.headers["republish_depth"] = int(env.get("_republish_depth", 0)) + 1
            self.broker.publish(out)
        elif callable(kind):
            kind(row, env)
        elif kind in self.action_providers:
            # registered providers (bridges register "bridge" here —
            # the actions-v2 seam of emqx_bridge_v2:send_message)
            self.action_providers[kind](action.get("args", {}), row, env)
        else:
            raise ValueError(f"unknown action {kind!r}")

    # --- wiring + dry run ----------------------------------------------

    def install(self, hooks) -> None:
        if self._installed:
            return
        hooks.add("message.publish", self._hook_cb, priority=50)
        if self.broker is not None:
            # coalesced publish paths probe this handle to open the
            # batched-WHERE window around their _pre_publish fold
            self.broker.rule_batcher = self
        self._installed = True

    def uninstall(self, hooks) -> None:
        """Undo install: the hook leaves 'message.publish' and the
        broker's coalesced paths stop opening the window."""
        if not self._installed:
            return
        hooks.delete("message.publish", self._hook_cb)
        if self.broker is not None and getattr(self.broker, "rule_batcher", None) is self:
            self.broker.rule_batcher = None
        self._installed = False

    def _hook_cb(self, msg, acc=None):
        # run_fold('message.publish', (), msg): single arg is the acc
        m = msg if isinstance(msg, Message) else acc
        if isinstance(m, Message):
            self.on_message_publish(m)
        return None

    def test_sql(self, sql: str, env: Dict[str, Any]) -> Optional[Any]:
        """Dry-run (emqx_rule_sqltester analog): returns the bound
        SELECT result or None if WHERE filtered it out."""
        sel = parse(sql)
        tmp = Rule("$test", sql, sel)
        rows = self.apply_rule(tmp, env)
        if rows is None:
            return None
        return rows[0] if sel.foreach is None else rows
