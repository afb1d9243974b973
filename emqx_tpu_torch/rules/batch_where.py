"""Batched WHERE evaluation — columnar masks over coalesced publishes
(the port's own copy of emqx_tpu/rules/batch_where.py).

The rule engine's WHERE clause runs per message per rule through the
tree-walking `eval_expr` interpreter. Under the dispatch engine's
coalesced publish batches that cost is rules x messages interpreter
walks per flush. This module compiles the *vectorizable predicate
subset* — and/or/not, the six comparisons, IN over literal lists,
IS NULL, and bare-value truthiness, over `("path", ...)` /
`("lit", ...)` atoms — into mask evaluation over a columnar view of
the whole batch:

  * each distinct path is extracted ONCE per batch into typed columns
    (kind tag + float value + interned string id), shared by every
    rule in the window — the payload JSON decode that `eval_expr`
    repeats per rule per row happens once per row;
  * each rule's predicate then evaluates as a handful of numpy
    vector ops over those columns, one lane per queued message.

Exactness contract: the compiled mask must agree with `eval_expr`
bit-for-bit or the row must land in the *fallback mask* and re-run
through `eval_expr` (the oracle). The compiler refuses anything
outside the subset (function calls, LIKE, arithmetic, CASE, index
expressions) — those rules evaluate per-row, counted, never silently
wrong. Rows whose values defy the columnar encoding (containers,
non-utf8 bytes, integers beyond 2^53 where float lanes would lie)
are tagged `_K_OTHER` and fall back per-row the same way.

Replicated `eval_expr` semantics, per lane:

  * `=` — bool identity first (True never equals 1), float equality
    for numbers, num<->str float coercion (unparseable -> False),
    interned-id equality for strings, None = None -> True;
  * `> < >= <=` — numeric compare over num/bool lanes, lexicographic
    compare over str lanes via a shared sorted-rank table, every
    mixed pairing -> False (eval_expr's TypeError -> False);
  * `IN` — OR of `=` against each literal;
  * truthiness — Python bool() of the lane value.

The columnar layout is deliberately the device-ready form (tag +
f64 + id lanes); the evaluator stays host numpy, so the leg launches
nothing and adds no shape bucket to the device path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .engine import _get_path

# lane kind tags: the column encoding's type system
_K_NONE = 0  # missing / None
_K_BOOL = 1  # value in .num (0.0 / 1.0)
_K_NUM = 2  # value in .num
_K_STR = 3  # interned id in .sid; float coercion in .snum/.snum_ok
_K_OTHER = 4  # containers, raw bytes, |int| > 2^53 — per-row fallback

_MAX_SAFE_INT = 2**53  # beyond this a float64 lane would lie


class _Column:
    """Typed columnar encoding of one extracted path over a batch."""

    __slots__ = ("kind", "num", "sid", "snum", "snum_ok", "tru")

    def __init__(self, n: int):
        self.kind = np.zeros(n, np.int8)
        self.num = np.zeros(n, np.float64)
        self.sid = np.zeros(n, np.int32)
        self.snum = np.zeros(n, np.float64)
        self.snum_ok = np.zeros(n, bool)
        self.tru = np.zeros(n, bool)


class _Operand:
    """One comparison operand over the selected rows — column slices
    for paths, broadcastable scalars for literals."""

    __slots__ = ("kind", "num", "sid", "snum", "snum_ok", "tru")


_UNSET = object()


class ColumnBatch:
    """Shared columnar view of a window's rule-eval environments.

    Columns extract lazily (first rule that references a path pays the
    walk) and are shared across every rule in the window; the payload
    JSON document decodes at most once per row regardless of how many
    `payload.*` paths the window's rules reference."""

    def __init__(self, envs: List[Dict[str, Any]]):
        self.envs = envs
        self._cols: Dict[Tuple[str, ...], _Column] = {}
        self._pdocs: List[Any] = [_UNSET] * len(envs)
        # one intern table for the whole batch: equal strings get equal
        # ids across every column AND literal, so `=` is id equality
        self._intern: Dict[str, int] = {}
        self._ranks: Optional[np.ndarray] = None
        self._ranks_v = -1

    def intern(self, s: str) -> int:
        i = self._intern.get(s)
        if i is None:
            i = self._intern[s] = len(self._intern) + 1
        return i

    def ranks(self) -> np.ndarray:
        """sid -> lexicographic rank, so ordered string compares are
        integer compares. Rebuilt when the intern table grew (a later
        rule's literal); id 0 (non-string lanes) maps to rank 0 —
        harmless, those lanes are masked out of the string branch."""
        if self._ranks_v != len(self._intern):
            r = np.zeros(len(self._intern) + 1, np.int64)
            for rank, s in enumerate(sorted(self._intern)):
                r[self._intern[s]] = rank
            self._ranks = r
            self._ranks_v = len(self._intern)
        return self._ranks

    def operand(self, path: Tuple[str, ...], idxs: np.ndarray) -> _Operand:
        c = self._cols.get(path)
        if c is None:
            c = self._cols[path] = self._extract(path)
        o = _Operand()
        o.kind = c.kind[idxs]
        o.num = c.num[idxs]
        o.sid = c.sid[idxs]
        o.snum = c.snum[idxs]
        o.snum_ok = c.snum_ok[idxs]
        o.tru = c.tru[idxs]
        return o

    def _payload_doc(self, i: int) -> Any:
        doc = self._pdocs[i]
        if doc is _UNSET:
            raw = self.envs[i].get("payload")
            from ..jsonc import loads
            from ..native import NativeBuildError

            try:
                doc = loads(raw if isinstance(raw, str) else raw.decode())
            except NativeBuildError:
                raise
            except Exception:
                doc = None
            self._pdocs[i] = doc
        return doc

    def _extract(self, path: Tuple[str, ...]) -> _Column:
        lp = list(path)
        col = _Column(len(self.envs))
        # payload.* walks share the per-row decoded document; the
        # sub-walk from the decoded root is step-for-step identical to
        # _get_path's walk through the raw payload (nested JSON-string
        # levels still decode inside _get_path)
        deep_payload = len(lp) > 1 and lp[0] == "payload"
        sub = lp[1:]
        for i, env in enumerate(self.envs):
            if deep_payload:
                doc = self._payload_doc(i)
                v = (
                    _get_path(doc, sub)
                    if isinstance(doc, (dict, list))
                    else None
                )
            else:
                v = _get_path(env, lp)
            if v is None:
                continue  # _K_NONE, all-zero lanes
            if isinstance(v, bool):
                col.kind[i] = _K_BOOL
                col.num[i] = 1.0 if v else 0.0
                col.tru[i] = v
            elif isinstance(v, (int, float)):
                if isinstance(v, int) and (
                    v > _MAX_SAFE_INT or v < -_MAX_SAFE_INT
                ):
                    col.kind[i] = _K_OTHER
                else:
                    col.kind[i] = _K_NUM
                    col.num[i] = float(v)
                    col.tru[i] = v != 0
            elif isinstance(v, str):
                col.kind[i] = _K_STR
                col.sid[i] = self.intern(v)
                col.tru[i] = len(v) > 0
                try:
                    col.snum[i] = float(v)
                    col.snum_ok[i] = True
                except ValueError:
                    pass
            else:
                col.kind[i] = _K_OTHER  # containers, raw bytes, ...
        return col


def _as_mask(x, n: int) -> np.ndarray:
    """Normalize a (possibly scalar, from lit-lit folds) predicate
    result to a bool[n] mask."""
    a = np.asarray(x, dtype=bool)
    if a.ndim == 0:
        return np.full(n, bool(a))
    return a


def _veq(a: _Operand, b: _Operand, n: int) -> np.ndarray:
    """Vector `_eq`: bool identity, float equality, num<->str
    coercion, interned-string equality, None = None."""
    abool = np.equal(a.kind, _K_BOOL)
    bbool = np.equal(b.kind, _K_BOOL)
    res = abool & bbool & np.equal(a.num, b.num)
    nb = ~(abool | bbool)
    anum = np.equal(a.kind, _K_NUM)
    bnum = np.equal(b.kind, _K_NUM)
    astr = np.equal(a.kind, _K_STR)
    bstr = np.equal(b.kind, _K_STR)
    res = res | (nb & anum & bnum & np.equal(a.num, b.num))
    res = res | (nb & anum & bstr & b.snum_ok & np.equal(a.num, b.snum))
    res = res | (nb & astr & bnum & a.snum_ok & np.equal(a.snum, b.num))
    res = res | (nb & astr & bstr & np.equal(a.sid, b.sid))
    res = res | (nb & np.equal(a.kind, _K_NONE) & np.equal(b.kind, _K_NONE))
    return _as_mask(res, n)


_ORD = {
    ">": np.greater,
    "<": np.less,
    ">=": np.greater_equal,
    "<=": np.less_equal,
}


def _vord(op: str, a: _Operand, b: _Operand, batch: ColumnBatch, n: int) -> np.ndarray:
    """Vector ordered compare: num/bool lanes numerically, str lanes
    by lexicographic rank; every mixed pairing is False (eval_expr
    catches the TypeError)."""
    cmp = _ORD[op]
    numa = np.equal(a.kind, _K_NUM) | np.equal(a.kind, _K_BOOL)
    numb = np.equal(b.kind, _K_NUM) | np.equal(b.kind, _K_BOOL)
    res = numa & numb & cmp(a.num, b.num)
    strs = np.equal(a.kind, _K_STR) & np.equal(b.kind, _K_STR)
    if np.any(strs):
        r = batch.ranks()
        res = res | (strs & cmp(r[a.sid], r[b.sid]))
    return _as_mask(res, n)


def _fb_other(a: _Operand, n: int) -> np.ndarray:
    return _as_mask(np.equal(a.kind, _K_OTHER), n)


# A loader materializes one operand for the selected rows.
_Loader = Callable[[ColumnBatch, np.ndarray], _Operand]


def _compile_operand(e: Any) -> Optional[_Loader]:
    if e[0] == "path":
        path = tuple(e[1])
        if "*" in path:
            return None  # '*' returns the env itself — not a lane

        def load_path(batch: ColumnBatch, idxs: np.ndarray) -> _Operand:
            return batch.operand(path, idxs)

        return load_path
    if e[0] == "lit":
        v = e[1]
        o = _Operand()
        o.num = 0.0
        o.sid = 0
        o.snum = 0.0
        o.snum_ok = False
        o.tru = False
        sval: Optional[str] = None
        if v is None:
            o.kind = _K_NONE
        elif isinstance(v, bool):
            o.kind = _K_BOOL
            o.num = 1.0 if v else 0.0
            o.tru = v
        elif isinstance(v, (int, float)):
            if isinstance(v, int) and (
                v > _MAX_SAFE_INT or v < -_MAX_SAFE_INT
            ):
                return None  # float lane would lie — not compilable
            o.kind = _K_NUM
            o.num = float(v)
            o.tru = v != 0
        elif isinstance(v, str):
            o.kind = _K_STR
            o.tru = len(v) > 0
            sval = v
            try:
                o.snum = float(v)
                o.snum_ok = True
            except ValueError:
                pass
        else:
            return None

        def load_lit(batch: ColumnBatch, idxs: np.ndarray) -> _Operand:
            if sval is not None:
                o.sid = batch.intern(sval)
            return o

        return load_lit
    return None


# A node evaluates to (mask, fallback) over the selected rows; the
# mask is authoritative only off the fallback rows (and kept False on
# them), fallback rows re-run through eval_expr.
_Node = Callable[[ColumnBatch, np.ndarray, int], Tuple[np.ndarray, np.ndarray]]


def _compile_bool(e: Any) -> Optional[_Node]:
    op = e[0]
    if op in ("path", "lit"):
        ld = _compile_operand(e)
        if ld is None:
            return None

        def truthy(batch, idxs, n):
            o = ld(batch, idxs)
            fb = _fb_other(o, n)
            return _as_mask(o.tru, n) & ~fb, fb

        return truthy
    if op in ("and", "or"):
        ca = _compile_bool(e[1])
        if ca is None:
            return None
        cb = _compile_bool(e[2])
        if cb is None:
            return None
        if op == "and":

            def band(batch, idxs, n):
                ma, xa = ca(batch, idxs, n)
                mb, xb = cb(batch, idxs, n)
                # eval_expr evaluates the left first: a False left
                # short-circuits, so a fallback-only-on-the-right row
                # with a clean False left stays vectorized
                fb = xa | (ma & xb)
                return ma & mb & ~fb, fb

            return band

        def bor(batch, idxs, n):
            ma, xa = ca(batch, idxs, n)
            mb, xb = cb(batch, idxs, n)
            fb = xa | (~ma & xb)
            return (ma | mb) & ~fb, fb

        return bor
    if op == "not":
        cg = _compile_bool(e[1])
        if cg is None:
            return None

        def bnot(batch, idxs, n):
            m, x = cg(batch, idxs, n)
            return ~m & ~x, x

        return bnot
    if op in ("=", "!=", ">", "<", ">=", "<="):
        la = _compile_operand(e[1])
        lb = _compile_operand(e[2])
        if la is None or lb is None:
            return None
        if op in ("=", "!="):
            neg = op == "!="

            def ceq(batch, idxs, n):
                a = la(batch, idxs)
                b = lb(batch, idxs)
                fb = _fb_other(a, n) | _fb_other(b, n)
                m = _veq(a, b, n)
                if neg:
                    m = ~m
                return m & ~fb, fb

            return ceq

        def cord(batch, idxs, n):
            a = la(batch, idxs)
            b = lb(batch, idxs)
            fb = _fb_other(a, n) | _fb_other(b, n)
            return _vord(op, a, b, batch, n) & ~fb, fb

        return cord
    if op == "in":
        la = _compile_operand(e[1])
        if la is None:
            return None
        elems = []
        for x in e[2]:
            if x[0] != "lit":
                return None
            lx = _compile_operand(x)
            if lx is None:
                return None
            elems.append(lx)

        def cin(batch, idxs, n):
            a = la(batch, idxs)
            fb = _fb_other(a, n)
            m = np.zeros(n, bool)
            for lx in elems:
                m = m | _veq(a, lx(batch, idxs), n)
            return m & ~fb, fb

        return cin
    if op == "isnull":
        ld = _compile_operand(e[1])
        if ld is None:
            return None

        def cnull(batch, idxs, n):
            o = ld(batch, idxs)
            # _K_OTHER lanes hold a real (non-None) value: IS NULL is
            # False there with no fallback needed
            return _as_mask(np.equal(o.kind, _K_NONE), n), np.zeros(n, bool)

        return cnull
    return None


class CompiledWhere:
    """A WHERE predicate compiled to columnar mask evaluation."""

    __slots__ = ("_node",)

    def __init__(self, node: _Node):
        self._node = node

    def eval(
        self, batch: ColumnBatch, idxs: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(mask, fallback) over the selected rows: mask rows passed
        WHERE, fallback rows must re-run through eval_expr."""
        return self._node(batch, idxs, len(idxs))


def compile_where(expr: Any) -> Optional[CompiledWhere]:
    """Compile a WHERE expression tree, or None when any node falls
    outside the vectorizable subset (the caller then evaluates the
    whole predicate per-row, counted as uncompiled)."""
    if expr is None:
        return None
    node = _compile_bool(expr)
    return CompiledWhere(node) if node is not None else None
