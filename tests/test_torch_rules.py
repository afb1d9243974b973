"""The port's rule engine (emqx_tpu_torch/rules) and JSON codec
(emqx_tpu_torch/jsonc.py over native/json.cc) held against emqx_tpu's
on the same seeded inputs, exact (ints, strings, bools, bytes and the
floats of eval_expr, which run the same Python arithmetic):

  * the SQL parser's ASTs and errors on the SQL of tests/test_rules.py
    and tests/test_batch_where.py;
  * the FUNCS table: the same names, each deterministic function's
    result or exception on seeded arguments (with the clock frozen),
    `random`, `uuid_v4*` and the `now_*` family by type and shape;
  * compile_where's masks and fallback masks on test_batch_where.py's
    corpus and on a seeded one with containers, non-utf8 payloads and
    integers past 2^53;
  * RuleEngine rows, metrics, where_stats and republish chains through
    a port Broker(device="cpu") against the reference Broker, through
    publish_batch, the dispatch engine's flush and Broker.publish
    (chip_smoke.rules_run, phase 12's set-up at a small size), and the
    batched window against the per-row oracle;
  * the codec's bytes and JSON_METRICS deltas against the reference's,
    its byte parity with stdlib (chip_smoke.json_parity), and a build
    that fails raising NativeBuildError;
  * convert.rule_specs / rules_from_specs carrying rules across.
"""

import copy
import json
import math
import random
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
from emqx_tpu import jsonc as JJ
from emqx_tpu.broker.message import Message as JMessage
from emqx_tpu.broker.packet import SubOpts as JSubOpts
from emqx_tpu.broker.pubsub import Broker as JBroker
from emqx_tpu.rules import RuleEngine as JRuleEngine
from emqx_tpu.rules import batch_where as JB
from emqx_tpu.rules import engine as JE
from emqx_tpu.rules import events as JEV
from emqx_tpu.rules import funcs as JF
from emqx_tpu.rules import sql as JS
from emqx_tpu.transform import MessageTransformation as JMT
from emqx_tpu.transform import SchemaRegistry as JReg
from emqx_tpu.transform import SchemaValidation as JSV
from emqx_tpu_torch import convert
from emqx_tpu_torch import jsonc as TJ
from emqx_tpu_torch import native
from emqx_tpu_torch.broker.message import Message as TMessage
from emqx_tpu_torch.rules import batch_where as TB
from emqx_tpu_torch.rules import engine as TE
from emqx_tpu_torch.rules import events as TEV
from emqx_tpu_torch.rules import funcs as TF
from emqx_tpu_torch.rules import sql as TS
from test_batch_where import COMPILABLE, UNCOMPILABLE, _VALUES
from test_rule_funcs_parity import CASES

REF = SimpleNamespace(Broker=JBroker, Message=JMessage, SubOpts=JSubOpts,
                      RuleEngine=JRuleEngine, SchemaRegistry=JReg,
                      SchemaValidation=JSV, MessageTransformation=JMT)
PORT = cs.PortImpl()

# phase 12's set-up at a size the CPU runs in a second or two
SMALL = {"n_rules": 200, "n_hot": 8, "n_republish": 2, "batch": 128, "n_cold_pubs": 32,
         "n_wide_pubs": 2, "n_batches": 4, "n_routes": 2048,
         "subs": {"hot": 2, "wide": 8, "out": 2, "cold": 16}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the SQL parser -----------------------------------------------------------------

SQLS = [
    'SELECT * FROM "t/#"',
    'SELECT payload.x AS x, clientid FROM "a/+", "b/#" WHERE x > 1',
    'SELECT a + b AS v FROM "t"',
    'SELECT a div b AS v FROM "t"',
    'SELECT a mod b AS v FROM "t"',
    'SELECT * FROM "t" WHERE (qos > 0 AND topic LIKE \'up/%\') OR retain',
    'SELECT payload.temp.hi AS hi, payload.tags[2] AS t2 FROM "t"',
    "SELECT CASE WHEN qos = 0 THEN 'zero' WHEN qos IN (1, 2) THEN 'up' "
    "ELSE 'other' END AS k FROM \"t\"",
    "SELECT upper(concat('a', 'b')) AS v FROM \"t\"",
    "SELECT nth(2, split('a,b,c', ',')) AS v FROM \"t\"",
    "SELECT nth_topic_level(2, topic) AS v FROM \"t\"",
    "SELECT topic_match(topic, 't/+') AS v FROM \"t\"",
    "SELECT coalesce(nope, 'd') AS v FROM \"t\"",
    "SELECT strlen('hello') AS v FROM \"t\"",
    "SELECT regex_extract('v=42;', 'v=(\\d+)') AS v FROM \"t\"",
    "SELECT map_get('k', json_decode('{\"k\": 3}')) AS v FROM \"t\"",
    'SELECT * FROM "dev/+/up"',
    'SELECT payload.v AS v FROM "t" WHERE payload.v > 10',
    'SELECT * FROM "up/#" WHERE qos = 0',
    'SELECT clientid FROM "$events/client_connected"',
    'SELECT payload.x + 1 AS y FROM "t"',
    'SELECT * FROM "t" WHERE false',
    "SELECT schema_decode('sensor', payload) as s, topic FROM \"ingest/#\"",
    'FOREACH payload.sensors AS s DO s.name, s.value FROM "t" INCASE s.value > 0',
    'FOREACH payload.sensors AS s DO s.name AS name, s.v AS v FROM "t" WHERE qos = 0',
    'SELECT -payload.x AS n, NOT payload.f AS nf FROM "t" WHERE payload.x <> 3',
    "SELECT 1.5e3 AS f, undefined AS u, null AS n FROM \"t\"",
    'SELECT payload.x AS x FROM "t/#" WHERE payload.x > 2',
    "SELECT clientid FROM \"t/#\" WHERE lower(topic) LIKE 't/%'",
    'SELECT qos FROM "t/#"',
    'SELECT qos FROM "t/#" WHERE qos >= 0',
] + [f'SELECT * FROM "t/#" WHERE {p}' for p in COMPILABLE + UNCOMPILABLE] + [
    s for _rid, s, _a, _e, _d in cs.rules_specs(40, 8, 2)[-10:]]

BAD_SQLS = [
    "SELECT FROM x",
    'SELECT * FROM "t" WHERE (1 = ',
    'SELECT * FROM "t" WHERE',
    "SELECT * FROM",
    'SELECT a AS FROM "t"',
    'SELECT * FROM "t" WHERE x ~ 1',
    "DELETE FROM t",
    'SELECT * FROM "t" WHERE \'unterminated',
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the type's name and message: the classes differ by package
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("sql", SQLS)
def test_parse_equals_reference(sql):
    got, want = TS.parse(sql), JS.parse(sql)
    assert got == want
    assert type(got).__name__ == type(want).__name__ == "Select"


@pytest.mark.parametrize("sql", BAD_SQLS)
def test_parse_errors_equal_reference(sql):
    got, want = _outcome(TS.parse, sql), _outcome(JS.parse, sql)
    assert got == want and got[0] == "err", (got, want)


# --- the FUNCS table ----------------------------------------------------------------

# checked for type and shape only: the rest are deterministic with the
# clock frozen
SHAPE_ONLY = {"random", "uuid_v4", "uuid_v4_no_hyphen", "now_rfc3339", "now_timestamp"}
FROZEN_NOW = 1_722_860_000.123456

_POOL = [0, 1, -1, 2, 3, 7, 16, 64, -5, 2.5, -0.5, 1e-3, float("nan"), float("inf"),
         True, False, None, "", "a", "abc", "a,b,c", "t/1/x", "t/+", "t/#", "5", "2.5",
         "é漢", "hello world", "  pad  ", "%s-%d", "${k}", "utc", "+08:00", "Z",
         "second", "millisecond", "1970-01-01T00:00:00Z", '{"k": 3}', "[1,2]", ".k",
         "k", "\\d+", "(a)(b)?", b"\x00\xff", b"bytes", b'{"k": 1}', [1, 2, 3],
         ["a", "b"], [], {"k": 1, "j": "v"}, {}]


def test_funcs_names_equal_reference():
    assert sorted(TF.FUNCS) == sorted(JF.FUNCS)
    assert len(TF.FUNCS) > 150
    assert sorted(n for n, f in TF.FUNCS.items() if getattr(f, "_wants_env", False)) \
        == sorted(n for n, f in JF.FUNCS.items() if getattr(f, "_wants_env", False))


def _canon(x):
    """A comparable form: floats by their bits (NaN equals NaN), the
    rest by type name and value, recursively."""
    if isinstance(x, float):
        return ("f", struct.pack("<d", x))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_canon(v) for v in x])
    if isinstance(x, dict):
        return ("d", [(_canon(k), _canon(v)) for k, v in x.items()])
    if isinstance(x, (str, bytes, int, bool, type(None))):
        return (type(x).__name__, x)
    return (type(x).__name__, repr(x))


def _env(side, kv, pd):
    Message, ev = (TMessage, TEV) if side == "port" else (JMessage, JEV)
    msg = Message(topic="t/1/x", payload=b'{"k": 1, "arr": [1, 2]}', qos=1,
                  from_client="c1", id="0123456789abcdef", timestamp=FROZEN_NOW,
                  headers={"username": "u1", "peerhost": "10.0.0.1"},
                  props={"User-Property": {"a": "b"}})
    env = ev.message_event(msg)
    env["_kv_store"], env["_proc_dict"] = kv, pd
    return env


def _inverse_args():
    """Arguments the decoders accept: the reference encoders' output."""
    f = JF.FUNCS
    words = ("hello", "é漢 x" * 9, "")
    terms = ({"a": [1, 2.5, "s"]}, 7, -(2**40), "str", b"b", [True, None], 10**30)
    return {
        "gunzip": [(f["gzip"](w),) for w in words],
        "unzip": [(f["zip"](w),) for w in words],
        "zip_uncompress": [(f["zip_compress"](w),) for w in words],
        "term_decode": [(f["term_encode"](t),) for t in terms],
        "range": [(1, 5), (0, 0), (3, 1), ("2", 4.5)],
    }


INVERSE_ARGS = _inverse_args()


def _arg_tuples(name, rng, n=24):
    out = [tuple(args) for nm, args, _exp in CASES if nm == name]
    out += INVERSE_ARGS.get(name, [])
    for _ in range(n):
        k = int(rng.integers(0, 5))
        out.append(tuple(_POOL[int(i)] for i in rng.integers(0, len(_POOL), k)))
    return out


@pytest.mark.parametrize("name", sorted(JF.FUNCS))
def test_func_equals_reference(name, monkeypatch):
    """Each function on its test_rule_funcs_parity.py cases and on 24
    seeded argument tuples (0-4 values of a pool): the same result or
    the same exception type and message, call for call; the proc-dict
    and kv-store functions on state that evolves alike."""
    monkeypatch.setattr(time, "time", lambda: FROZEN_NOW)
    rng = np.random.default_rng(sum(name.encode()) * 7919)
    tf, jf = TF.FUNCS[name], JF.FUNCS[name]
    env_fn = getattr(jf, "_wants_env", False)
    assert getattr(tf, "_wants_env", False) == env_fn
    states = {side: ({}, {}) for side in ("port", "ref")}
    for args in _arg_tuples(name, rng):
        got = []
        for side, fn in (("port", tf), ("ref", jf)):
            a = copy.deepcopy(args)
            if env_fn:
                a = (_env(side, *states[side]),) + a
            random.seed(11)
            res = _outcome(fn, *a)
            got.append((res[0], _canon(res[1]) if res[0] == "ok" else res[1:]))
        if name in SHAPE_ONLY:
            (ks, vs), (kr, vr) = got
            assert ks == kr, (name, args, got)
            if ks == "ok":
                assert vs[0] == vr[0], (name, args, got)
                if vs[0] == "str":
                    assert len(vs[1]) == len(vr[1]), (name, args, got)
            continue
        assert got[0] == got[1], (name, args, got)
    assert states["port"] == states["ref"]


@pytest.mark.parametrize("name", sorted(SHAPE_ONLY))
def test_nondeterministic_func_shapes(name):
    for fn in (TF.FUNCS[name], JF.FUNCS[name]):
        v = fn()
        if name == "random":
            assert isinstance(v, float) and 0.0 <= v < 1.0
        elif name == "uuid_v4":
            assert isinstance(v, str) and len(v) == 36 and v.count("-") == 4
        elif name == "uuid_v4_no_hyphen":
            assert isinstance(v, str) and len(v) == 32 and int(v, 16) >= 0
        elif name == "now_timestamp":
            assert isinstance(v, int) and abs(v - time.time()) < 5
        else:
            assert isinstance(v, str) and v[:2] == "20" and v[10] == "T"


# --- compiled WHERE -----------------------------------------------------------------

# predicates of the seeded corpus, besides test_batch_where.py's: the
# payload itself (raw bytes stay bytes: the OTHER lane), big integers
EXTRA_PREDS = [
    "payload = 'abc'",
    "payload IS NULL",
    "payload != 'x'",
    "payload.x > 9007199254740992",
    "payload.y IN (1, 'a', true, null)",
    "payload.x >= 2.5 AND NOT payload.flag OR payload.s <= 'b'",
    "payload.arr[2] = 1",
    "payload.x",
]


def _where(parse, pred):
    return parse(f'SELECT * FROM "t/#" WHERE {pred}').where


def _envs_from(rows):
    """Each side's envs from (topic, payload bytes, qos) rows."""
    envs = {}
    for side, Message, ev in (("port", TMessage, TEV), ("ref", JMessage, JEV)):
        envs[side] = [ev.message_event(Message(topic=t, payload=p, qos=q, id=f"m{i}",
                                               timestamp=1.7e9))
                      for i, (t, p, q) in enumerate(rows)]
    return envs


def _test_batch_where_corpus():
    # test_batch_where._rand_env's draws, its payload bytes by stdlib
    # (the reference's codec writes the same bytes)
    rng = random.Random(1405)
    rows = []
    for _ in range(400):
        payload = {}
        for key in ("x", "y", "s", "flag"):
            if rng.random() < 0.85:
                payload[key] = rng.choice(_VALUES)
        topic = rng.choice(["t/a", "t/b"])
        rows.append((topic, json.dumps(payload, default=str).encode(),
                     rng.choice([0, 1, 2])))
    return rows


def _seeded_corpus(seed=17, n=400):
    rng = np.random.default_rng(seed)
    values = [0, 1, -1, 5, 2.5, -0.0, float("nan"), 2**53, 2**53 + 1, -(2**53) - 1,
              9007199254740993, 10**40, -(10**30), True, False, None, "alpha", "5",
              "2.5", "", "b", "é", [1, 2], [], {"k": 1}, {}, [[1]]]
    rows = []
    for i in range(n):
        kind = int(rng.integers(0, 10))
        if kind == 0:  # not utf-8: the payload stays bytes
            payload = bytes(rng.integers(128, 256, int(rng.integers(1, 9))).tolist())
        elif kind == 1:
            payload = b"abc" if i % 2 else b"[1, 2, 3]"
        else:
            doc = {k: values[int(rng.integers(0, len(values)))]
                   for k in ("x", "y", "s", "flag", "arr") if rng.random() < 0.85}
            payload = json.dumps(doc).encode()
        rows.append(("t/a", payload, int(rng.integers(0, 3))))
    return rows


# a literal past 2^53 would lie in a float lane: the compiler refuses it
REFUSED = ["payload.x = 9007199254740993", "payload.x < -9007199254740993"]
CORPORA = {"test_batch_where": _test_batch_where_corpus, "seeded": _seeded_corpus}
PREDS = COMPILABLE + UNCOMPILABLE + EXTRA_PREDS + REFUSED


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("pred", PREDS)
def test_compile_where_masks_equal_reference(pred, corpus):
    """The same predicates compile; on the corpus the mask and the
    fallback mask equal the reference's lane for lane, and every lane
    not in the fallback mask equals the port's eval_expr."""
    envs = _envs_from(CORPORA[corpus]())
    tw, jw = _where(TS.parse, pred), _where(JS.parse, pred)
    tc, jc = TB.compile_where(tw), JB.compile_where(jw)
    assert (tc is None) == (jc is None)
    if tc is None:
        assert pred in UNCOMPILABLE + REFUSED
        return
    ix = np.arange(len(envs["port"]), dtype=np.int64)
    mask, fb = tc.eval(TB.ColumnBatch(envs["port"]), ix)
    jmask, jfb = jc.eval(JB.ColumnBatch(envs["ref"]), ix)
    assert mask.dtype == jmask.dtype and fb.dtype == jfb.dtype
    assert mask.tolist() == jmask.tolist() and fb.tolist() == jfb.tolist()
    for i, env in enumerate(envs["port"]):
        if not fb[i]:
            try:
                want = bool(TE.eval_expr(tw, env))
            except Exception:
                want = False
            assert bool(mask[i]) == want, (pred, i, env["payload"])
    if corpus == "seeded" and pred == "payload = 'abc'":
        assert fb.any()  # the non-utf8 payloads took the fallback lane


def test_compile_where_subset_of_rows():
    """An index subset (the rows a rule matched) evaluates the same
    lanes as the whole batch at those rows, on both sides."""
    envs = _envs_from(_seeded_corpus(5, 200))
    ix = np.arange(0, 200, 3, dtype=np.int64)
    for pred in COMPILABLE:
        got = TB.compile_where(_where(TS.parse, pred)).eval(TB.ColumnBatch(envs["port"]), ix)
        want = JB.compile_where(_where(JS.parse, pred)).eval(JB.ColumnBatch(envs["ref"]), ix)
        assert [a.tolist() for a in got] == [a.tolist() for a in want], pred


@pytest.mark.parametrize("sql", [s for s in SQLS if " WHERE " in s and "FOREACH" not in s])
def test_eval_expr_equals_reference(sql):
    """eval_expr and select_fields of the SQL over the seeded corpus:
    the same values (floats by their bits) or the same exceptions."""
    envs = _envs_from(_seeded_corpus(23, 120))
    ts, js = TS.parse(sql), JS.parse(sql)
    for te, je in zip(envs["port"], envs["ref"]):
        got = _outcome(TE.eval_expr, ts.where, te)
        want = _outcome(JE.eval_expr, js.where, je)
        assert _canon(got) == _canon(want), (sql, te["payload"])
        got = _outcome(TE.select_fields, ts, te)
        want = _outcome(JE.select_fields, js, je)
        assert _canon(got) == _canon(want), (sql, te["payload"])


def test_render_template_equals_reference():
    envs = _envs_from(_seeded_corpus(29, 60))
    for tpl in ("out/${topic}", "${payload.x}-${payload.s}", "${qos}", "${nope.x}",
                "${payload.arr.1}", "plain", "${clientid}/${id}"):
        for te, je in zip(envs["port"], envs["ref"]):
            assert TE.render_template(tpl, te) == JE.render_template(tpl, je)


# --- the engine through the brokers -------------------------------------------------

PATHS = ("batch", "engine", "single", "both")


@pytest.mark.parametrize("batched", [True, False], ids=["window", "per_row"])
@pytest.mark.parametrize("path", PATHS)
def test_engine_through_broker_equals_reference(path, batched):
    """Phase 12's set-up (validation, transformation, config 5's rules
    with capture and republish actions, hot/cold/wide/out subscribers,
    route and subscriber churn between batches) at a small size: the
    port's CPU broker and the reference's give the same rule metrics,
    captured rows, where_stats, governance and broker counters and
    per-client deliveries."""
    port = cs.rules_run(PORT, "cpu", path, batched, 3, SMALL)
    ref = cs.rules_run(REF, None, path, batched, 3, SMALL)
    assert cs.rules_differences(port, ref) == []
    pw = {k: port[0].engine.where_stats[k] for k in cs.WHERE_STATS_KEYS}
    assert pw == {k: ref[0].engine.where_stats[k] for k in cs.WHERE_STATS_KEYS}
    windowed = batched and path != "single"
    assert pw["windows"] == (SMALL["n_batches"] if windowed else 0)
    assert pw["uncompiled_rows"] == pw["fallback_rows"] == 0
    if windowed:
        assert pw["batch_rows"] > 0
    state = port[0].state()
    assert state["broker"]["schema_validation.failed"] > 0
    assert sum(c for c, _ in port[1].summary().values()) > 0
    assert all(len(state["rows"][f"hot{i}"]) for i in range(SMALL["n_republish"]))


def test_window_against_per_row_oracle():
    """What phase 12 holds on the card, on the CPU: the batched window
    through both coalesced paths against Broker.publish with per-row
    eval_expr: equal in everything phase 12 compares."""
    card = cs.rules_run(PORT, "cpu", "both", True, 5, SMALL)
    oracle = cs.rules_run(PORT, "cpu", "single", False, 5, SMALL)
    assert cs.rules_differences(card, oracle) == []
    assert card[0].engine.where_stats["windows"] == SMALL["n_batches"]


def _chain(side, path, batched):
    """Two rules that republish into each other's FROM plus one that
    republishes onto its own: the self-skip and the depth cap."""
    import asyncio

    broker = side.Broker(max_levels=8, device="cpu") if side is PORT else side.Broker(max_levels=8)
    eng = side.RuleEngine(broker)
    eng.batch_where_enabled = batched
    eng.install(broker.hooks)
    convert.rules_from_specs(eng, [
        ("ping", "SELECT payload.n AS n FROM \"p/#\" WHERE payload.n >= 0",
         [{"function": "republish", "args": {"topic": "q/${topic}", "payload": "${payload}"}}],
         True, ""),
        ("pong", "SELECT * FROM \"q/#\" WHERE qos = 0",
         [{"function": "republish", "args": {"topic": "p/back"}}], True, ""),
        ("self", "SELECT * FROM \"s/#\" WHERE qos >= 0",
         [{"function": "republish", "args": {"topic": "s/again"}}], True, ""),
        ("bad", "SELECT * FROM \"p/#\" WHERE payload.n > 1",
         [{"function": "no_such_action"}], True, ""),
    ])
    got = []
    s, _ = broker.open_session("w", True)
    s.outgoing_sink = lambda pkts: got.extend((p.topic, bytes(p.payload)) for p in pkts)
    for flt in ("p/#", "q/#", "s/#"):
        broker.subscribe(s, flt, side.SubOpts(qos=0))
    msgs = [side.Message(topic=t, payload=json.dumps({"n": n}).encode(), id=f"c{n}",
                         timestamp=1.7e9)
            for n, t in enumerate(("p/a", "s/a", "p/b", "q/z"))]
    if path == "batch":
        broker.publish_batch(msgs)
    elif path == "engine":
        async def run():
            de = broker.enable_dispatch_engine(queue_depth=len(msgs))
            await de.submit_many(msgs)
            await de.stop()

        asyncio.run(run())
    else:
        for m in msgs:
            broker.publish(m)
    metrics = {rid: vars(r.metrics).copy() for rid, r in eng.rules.items()}
    return metrics, sorted(got), {k: eng.where_stats[k] for k in cs.WHERE_STATS_KEYS}


@pytest.mark.parametrize("batched", [True, False], ids=["window", "per_row"])
@pytest.mark.parametrize("path", ("batch", "engine", "single"))
def test_republish_chains_equal_reference(path, batched):
    got, want = _chain(PORT, path, batched), _chain(REF, path, batched)
    assert got == want
    metrics = got[0]
    assert metrics["ping"]["matched"] > 2 and metrics["self"]["matched"] == 1
    assert metrics["bad"]["actions_failed"] > 0


@pytest.mark.parametrize("side", ["port", "ref"])
def test_where_rates_runs_both_legs(side):
    """Phase 12 (d)'s bench_rules_where at a small size: both legs run,
    agree on every metric, and stay inside the columnar mask."""
    batched, per_row, rows = cs.where_rates(PORT if side == "port" else REF, 1,
                                            {"n_rules": 200, "n_hot": 8, "batch": 64},
                                            turns=2)
    assert rows == 8 * 64 and len(batched) == len(per_row) == 2
    assert all(r > 0 for r in batched + per_row)


def test_governed_toggle_never_doubles_a_hook():
    """Phase 12 (d)'s on/off turns: every 'on' turn runs each hook
    once (the same rule matches a turn), every 'off' turn none."""
    sizes = dict(SMALL, n_batches=1)
    gov, _sink, _r, _d = cs.rules_run(PORT, "cpu", "batch", True, 3, sizes)
    rng = np.random.default_rng(5)
    batch = [PORT.Message(topic=t, payload=p, id=i, timestamp=ts, from_client="pub")
             for t, p, i, ts in cs.rules_batch(rng, 9, 64, 8, 2, sizes["n_rules"] - sizes["n_hot"])]

    def matched():
        return sum(r.metrics.matched for r in gov.engine.rules.values())

    deltas = []
    for on in (True, False, False, True, True, False):
        (gov.attach if on else gov.detach)()
        before, dropped = matched(), gov.broker.metrics.val("messages.dropped")
        gov.broker.publish_batch(batch)
        deltas.append((matched() - before,
                       gov.broker.metrics.val("messages.dropped") - dropped))
    on_turns = {deltas[i] for i in (0, 3, 4)}
    assert len(on_turns) == 1 and next(iter(on_turns))[0] > 0
    assert all(deltas[i][0] == 0 for i in (1, 2, 5))


def test_json_rates_runs():
    rates = cs.json_rates(TJ, n=5)
    assert sorted(rates) == ["native_dumps_per_s", "native_loads_per_s",
                             "stdlib_dumps_per_s", "stdlib_loads_per_s"]
    assert all(v > 0 for v in rates.values())


def test_rule_specs_round_trip():
    """convert.rule_specs of a reference engine loads into a port engine
    (and back) with the same rules, in order."""
    specs = cs.rules_specs(60, 6, 2) + [
        ("off", 'SELECT * FROM "x/#"', [{"function": "console"}], False, "disabled")]
    ref = JRuleEngine()
    assert convert.rules_from_specs(ref, specs) == len(specs)
    port = TE.RuleEngine()
    assert convert.rules_from_specs(port, convert.rule_specs(ref)) == len(specs)
    assert convert.rule_specs(port) == convert.rule_specs(ref) == [
        (r, s, list(a), e, d) for r, s, a, e, d in specs]
    back = JRuleEngine()
    convert.rules_from_specs(back, convert.rule_specs(port))
    for t in ("hot/t", "cold/3/t", "x/1", "nomatch"):
        assert [r.id for r in port.match_rules(t)] == [r.id for r in ref.match_rules(t)] \
            == [r.id for r in back.match_rules(t)]
    with pytest.raises(ValueError):
        convert.rules_from_specs(port, specs[:1])


# --- the JSON codec -----------------------------------------------------------------

DUMPS_KWARGS = {
    "plain": {},
    "compact": {"separators": (",", ":")},
    "default": {"default": str},
    "compact_default": {"separators": (",", ":"), "default": repr},
    "sort_keys": {"sort_keys": True},
    "indent": {"indent": 2},
    "spaced": {"separators": (", ", ": ")},
    "ascii_off": {"ensure_ascii": False},
}


def _docs(seed):
    docs = cs.json_docs(np.random.default_rng(seed), 120)
    # the default= leg's inputs, and an int dict key (native refuses,
    # stdlib coerces)
    docs += [{"b": b"\x00raw", "set": {1}}, [1, {"t": (1, 2)}], {1: "a", "k": {2: None}}]
    return docs


def _metrics_delta(mod, fn):
    before = mod.JSON_METRICS.snapshot()
    out = fn()
    after = mod.JSON_METRICS.snapshot()
    return out, {k: after[k] - before[k] for k in before if k != "native_enabled"}


def _replayed(native_call, kwargs=None):
    """1 where the reference's rules (emqx_tpu/jsonc.py) send a call to
    stdlib: kwargs outside the native surface, or the native leg
    raising TypeError or ValueError."""
    if kwargs and (kwargs.keys() - {"separators", "default"} or kwargs.get(
            "separators") not in (None, (",", ":"))):
        return 1
    try:
        native_call()
    except (TypeError, ValueError):
        return 1
    return 0


def _assert_deltas(dt, dj, op, replayed):
    """The port's counters moved by the reference's rules; the
    reference's equal them where its own codec is built for this
    interpreter, and in their sum where it serves stdlib."""
    assert dt == {f"native_{o}": int(o == op and not replayed) for o in ("loads", "dumps")} | {
        f"fallback_{o}": int(o == op and bool(replayed)) for o in ("loads", "dumps")}
    if JJ._mod is not None and JJ._enabled:
        assert dj == dt
    else:
        assert sum(dj.values()) == sum(dt.values()) == 1


@pytest.mark.parametrize("kw", sorted(DUMPS_KWARGS))
def test_dumps_bytes_and_metrics_equal_reference(kw):
    kwargs = DUMPS_KWARGS[kw]
    mod = TJ.load()
    for d in _docs(41):
        got, dt = _metrics_delta(TJ, lambda: _outcome(lambda: TJ.dumps(d, **kwargs)))
        want, dj = _metrics_delta(JJ, lambda: _outcome(lambda: JJ.dumps(d, **kwargs)))
        assert got == want, (kw, d)
        assert got == _outcome(lambda: json.dumps(d, **kwargs))
        compact = 1 if kwargs.get("separators") else 0
        _assert_deltas(dt, dj, "dumps", _replayed(
            lambda: mod.dumps(d, compact, kwargs.get("default")), kwargs))


def _wires(seed):
    docs = cs.json_docs(np.random.default_rng(seed), 120)
    wires = [json.dumps(d) for d in docs] + [json.dumps(d, separators=(",", ":")).encode()
                                              for d in docs]
    return wires + ['{"a": 1,}', "[1, 2", "NaN", "-Infinity", '"\\ud800"', '"\\u00e9"',
                    "  {\"k\" : [ ] }  ", "01", "1e400", "-0", '{"a": 1, "a": 2}',
                    b"\xff\xfe", "", "tru", '"\x01"', bytearray(b"[true]")]


def test_loads_values_and_metrics_equal_reference():
    mod = TJ.load()
    for w in _wires(43):
        got, dt = _metrics_delta(TJ, lambda: _outcome(TJ.loads, w))
        want, dj = _metrics_delta(JJ, lambda: _outcome(JJ.loads, w))
        assert _canon(got) == _canon(want), w
        assert _canon(got) == _canon(_outcome(json.loads, w)), w
        _assert_deltas(dt, dj, "loads", _replayed(lambda: mod.loads(w)))


def test_json_parity_with_stdlib():
    """chip_smoke.json_parity, phase 12 (a)'s check, on the CPU build."""
    delta = cs.json_parity(TJ, cs.json_docs(np.random.default_rng(0), 100))
    assert delta["native_loads"] == 2 * 104 and delta["fallback_dumps"] == 5


def test_set_native_enabled_is_the_only_way_to_stdlib(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_NO_JSONC", "1")
    _, d = _metrics_delta(TJ, lambda: (TJ.dumps({"a": [1]}), TJ.loads("[1]")))
    assert d == {"native_loads": 1, "native_dumps": 1, "fallback_loads": 0,
                 "fallback_dumps": 0}
    TJ.set_native_enabled(False)
    try:
        out, d = _metrics_delta(TJ, lambda: (TJ.dumps({"a": [1]}), TJ.loads("[1]")))
        assert out == ('{"a": [1]}', [1]) and TJ.JSON_METRICS.snapshot()["native_enabled"] == 0
        assert d == {"native_loads": 0, "native_dumps": 0, "fallback_loads": 1,
                     "fallback_dumps": 1}
    finally:
        TJ.set_native_enabled(True)
    assert TJ.native_enabled() and TJ.JSON_METRICS.snapshot()["native_enabled"] == 1


def test_json_families_render_like_reference():
    assert [ln.split("{")[0] for ln in TJ.JSON_METRICS.prometheus_lines("n@h")] == \
        [ln.split("{")[0] for ln in JJ.JSON_METRICS.prometheus_lines("n@h")]


@pytest.fixture
def fresh_json(monkeypatch, tmp_path):
    """An empty build directory and the codec not loaded, for this test
    only."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(TJ, "_mod", None)
    return tmp_path


def _json_raises():
    for call in (TJ.load, lambda: TJ.loads(b"{}"), lambda: TJ.dumps([1])):
        with pytest.raises(native.NativeBuildError):
            call()
    assert TJ._mod is None


def test_json_missing_compiler_raises(fresh_json, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(fresh_json / "no-such-g++"))
    _json_raises()


HOT_WHERE = 'SELECT payload.x FROM "hot/#" WHERE payload.x > 1'


@pytest.fixture
def cpu_broker():
    """A port Broker(device="cpu"), made before fresh_json empties the
    build directory."""
    from emqx_tpu_torch.broker.pubsub import Broker as TBroker

    return TBroker(max_levels=8, device="cpu")


def test_rule_engine_with_a_failed_codec_raises(cpu_broker, fresh_json, monkeypatch):
    """A codec that cannot build raises where the engine is made, and a
    payload.* read never turns it into None: not in eval_expr, not in
    a batched WHERE, not in a publish through an engine made while the
    codec was off."""
    monkeypatch.setattr(native, "CXX", str(fresh_json / "no-such-g++"))
    broker = cpu_broker
    with pytest.raises(native.NativeBuildError):
        TE.RuleEngine(broker)
    env = {"payload": b'{"x": 3}'}
    where = TS.parse(HOT_WHERE).where
    with pytest.raises(native.NativeBuildError):
        TE.eval_expr(where, env)
    with pytest.raises(native.NativeBuildError):
        TB.compile_where(where).eval(TB.ColumnBatch([env]), np.arange(1))
    TJ.set_native_enabled(False)
    try:
        engine = TE.RuleEngine(broker)
    finally:
        TJ.set_native_enabled(True)
    engine.create_rule("r", HOT_WHERE, [])
    engine.install(broker.hooks)
    for batched in (False, True):
        engine.batch_where_enabled = batched
        with pytest.raises(native.NativeBuildError):
            broker.publish_batch([TMessage(topic="hot/a", payload=b'{"x": 3}')])
    m = engine.rules["r"].metrics
    assert (m.passed, m.failed, m.no_result) == (0, 0, 0) and TJ._mod is None


def test_json_bad_source_raises_with_the_compiler_log(fresh_json, monkeypatch):
    src = fresh_json / "src"
    src.mkdir()
    text = (native.SRC / "json.cc").read_text()
    (src / "json.cc").write_text(text.replace("PyMODINIT_FUNC", "this is not C++;\nPyMODINIT_FUNC"))
    monkeypatch.setattr(native, "SRC", src)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        TJ.load()
    _json_raises()
    assert not list((fresh_json / "build").glob("*.tmp"))


def test_json_failed_probe_raises(fresh_json, monkeypatch):
    src = fresh_json / "src"
    src.mkdir()
    text = (native.SRC / "json.cc").read_text()
    # a codec that writes `fals` for true: builds, imports, fails the probe
    bad = text.replace('w_puts(w, "true", 4)', 'w_puts(w, "fals", 4)')
    assert bad != text
    (src / "json.cc").write_text(bad)
    monkeypatch.setattr(native, "SRC", src)
    with pytest.raises(native.NativeBuildError, match="probe"):
        TJ.load()
    _json_raises()


def test_json_built_under_the_port_name():
    mod = TJ.load()
    assert mod.__name__ == "_emqx_torch_json"
    assert str(native.library_path("_emqx_torch_json")).startswith(str(native.BUILD_DIR))
    assert mod.dumps({"k": [1.5, None]}, 1, None) == '{"k":[1.5,null]}'
    assert math.isnan(mod.loads("NaN"))
