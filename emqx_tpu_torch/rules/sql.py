"""Rule SQL dialect — parser for the rulesql-equivalent language (the
port's own copy of emqx_tpu/rules/sql.py).

The reference parses rule SQL with the `rulesql` dep (SURVEY.md §2.6:
SQL over event topics, evaluated by emqx_rule_runtime). Grammar
implemented here (the dialect EMQX rules actually use):

    SELECT <expr> [AS alias] {, ...} | *
    FROM   "topic/filter" {, "t2"}
    [WHERE <condition>]
    [FOREACH <expr> [AS alias]] — FOREACH form: iterate an array field

Expressions: literals (ints, floats, 'single-quoted strings', true,
false, null, undefined), dotted/bracket paths (payload.temp.hi,
headers['x']), arithmetic + - * / div mod, comparisons = != <> > < >=
<=, logical AND OR NOT, IN (...), LIKE 'pat%', IS [NOT] NULL, CASE
WHEN, function calls (bound at eval time from rules.funcs).

Parse result is an AST of plain tuples evaluated by engine.eval_expr.
"""

from __future__ import annotations

import re
from typing import Any, List, NamedTuple, Optional, Tuple


class SqlError(ValueError):
    pass


class Select(NamedTuple):
    fields: List[Tuple[Any, Optional[str]]]  # (expr, alias) — [] means '*'
    froms: List[str]
    where: Optional[Any]
    foreach: Optional[Tuple[Any, Optional[str]]]  # (expr, alias)
    incase: Optional[Any]


# --- tokenizer ----------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+([eE][+-]?\d+)?|\d+)
  | (?P<dqstr>"(?:[^"\\]|\\.)*")
  | (?P<sqstr>'(?:[^'\\]|\\.)*')
  | (?P<name>[A-Za-z_\$][A-Za-z0-9_\$]*)
  | (?P<op><>|!=|>=|<=|=|>|<|\+|-|\*|/|\(|\)|\[|\]|,|\.)
    """,
    re.X,
)

KEYWORDS = {
    "select", "from", "where", "as", "and", "or", "not", "in", "like",
    "is", "null", "case", "when", "then", "else", "end", "foreach",
    "do", "incase", "div", "mod", "true", "false", "undefined",
}


class _Tok(NamedTuple):
    kind: str  # num | str | name | kw | op
    val: Any


def _tokenize(src: str) -> List[_Tok]:
    out: List[_Tok] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise SqlError(f"bad token at {src[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "num":
            t = m.group()
            out.append(_Tok("num", float(t) if "." in t or "e" in t.lower() else int(t)))
        elif m.lastgroup == "dqstr":
            out.append(_Tok("str", _unquote(m.group())))
        elif m.lastgroup == "sqstr":
            out.append(_Tok("str", _unquote(m.group())))
        elif m.lastgroup == "name":
            low = m.group().lower()
            if low in KEYWORDS:
                out.append(_Tok("kw", low))
            else:
                out.append(_Tok("name", m.group()))
        else:
            out.append(_Tok("op", m.group()))
    return out


def _unquote(s: str) -> str:
    # only quote chars and backslash unescape; \d etc. stay literal
    # (regex patterns travel through SQL strings intact)
    return re.sub(r"\\(['\"\\])", r"\1", s[1:-1])


# --- parser -------------------------------------------------------------


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[_Tok]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise SqlError("unexpected end of SQL")
        self.i += 1
        return t

    def expect_kw(self, kw: str) -> None:
        t = self.next()
        if t.kind != "kw" or t.val != kw:
            raise SqlError(f"expected {kw.upper()}, got {t.val!r}")

    def accept_kw(self, kw: str) -> bool:
        t = self.peek()
        if t is not None and t.kind == "kw" and t.val == kw:
            self.i += 1
            return True
        return False

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t is not None and t.kind == "op" and t.val == op:
            self.i += 1
            return True
        return False

    # SELECT ... FROM ... [WHERE ...]
    def parse_select(self) -> Select:
        foreach = None
        if self.accept_kw("foreach"):
            fe = self.parse_expr()
            falias = None
            if self.accept_kw("as"):
                falias = self._name()
            foreach = (fe, falias)
            # FOREACH ... DO <fields> — DO acts as the select list
            fields = []
            if self.accept_kw("do"):
                fields = self._field_list()
        else:
            self.expect_kw("select")
            fields = self._field_list()
        self.expect_kw("from")
        froms = [self._from_topic()]
        while self.accept_op(","):
            froms.append(self._from_topic())
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        incase = None
        if self.accept_kw("incase"):
            incase = self.parse_expr()
        if self.peek() is not None:
            raise SqlError(f"trailing tokens at {self.peek().val!r}")
        return Select(fields, froms, where, foreach, incase)

    def _field_list(self) -> List[Tuple[Any, Optional[str]]]:
        if self.accept_op("*"):
            return []
        fields = [self._field()]
        while self.accept_op(","):
            if self.accept_op("*"):
                fields.append((("path", ["*"]), None))
                continue
            fields.append(self._field())
        return fields

    def _field(self) -> Tuple[Any, Optional[str]]:
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self._name()
        return (e, alias)

    def _name(self) -> str:
        t = self.next()
        if t.kind not in ("name", "str"):
            raise SqlError(f"expected name, got {t.val!r}")
        return t.val

    def _from_topic(self) -> str:
        t = self.next()
        if t.kind != "str":
            raise SqlError(f"FROM expects a quoted topic, got {t.val!r}")
        return t.val

    # precedence-climbing expression parser
    def parse_expr(self) -> Any:
        return self._or()

    def _or(self):
        left = self._and()
        while self.accept_kw("or"):
            left = ("or", left, self._and())
        return left

    def _and(self):
        left = self._not()
        while self.accept_kw("and"):
            left = ("and", left, self._not())
        return left

    def _not(self):
        if self.accept_kw("not"):
            return ("not", self._not())
        return self._cmp()

    def _cmp(self):
        left = self._add()
        t = self.peek()
        if t is None:
            return left
        if t.kind == "op" and t.val in ("=", "!=", "<>", ">", "<", ">=", "<="):
            self.i += 1
            op = "!=" if t.val == "<>" else t.val
            return (op, left, self._add())
        if t.kind == "kw" and t.val == "in":
            self.i += 1
            if not self.accept_op("("):
                raise SqlError("IN expects (...)")
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            if not self.accept_op(")"):
                raise SqlError("IN missing ')'")
            return ("in", left, items)
        if t.kind == "kw" and t.val == "like":
            self.i += 1
            pat = self.next()
            if pat.kind != "str":
                raise SqlError("LIKE expects a string pattern")
            return ("like", left, pat.val)
        if t.kind == "kw" and t.val == "is":
            self.i += 1
            neg = self.accept_kw("not")
            self.expect_kw("null")
            return ("isnull", left) if not neg else ("not", ("isnull", left))
        return left

    def _add(self):
        left = self._mul()
        while True:
            t = self.peek()
            if t is not None and t.kind == "op" and t.val in ("+", "-"):
                self.i += 1
                left = (t.val, left, self._mul())
            else:
                return left

    def _mul(self):
        left = self._unary()
        while True:
            t = self.peek()
            if t is not None and (
                (t.kind == "op" and t.val in ("*", "/"))
                or (t.kind == "kw" and t.val in ("div", "mod"))
            ):
                self.i += 1
                left = (t.val, left, self._unary())
            else:
                return left

    def _unary(self):
        if self.accept_op("-"):
            return ("neg", self._unary())
        return self._postfix()

    def _postfix(self):
        e = self._primary()
        while True:
            if self.accept_op("."):
                t = self.next()
                if t.kind not in ("name", "kw", "num"):
                    raise SqlError(f"bad path segment {t.val!r}")
                seg = str(t.val)
                if e[0] == "path":
                    e = ("path", e[1] + [seg])
                else:
                    e = ("index", e, ("lit", seg))
            elif self.accept_op("["):
                idx = self.parse_expr()
                if not self.accept_op("]"):
                    raise SqlError("missing ']'")
                if e[0] == "path" and idx[0] == "lit":
                    e = ("path", e[1] + [idx[1]])
                else:
                    e = ("index", e, idx)
            else:
                return e

    def _primary(self):
        t = self.next()
        if t.kind == "num":
            return ("lit", t.val)
        if t.kind == "str":
            return ("lit", t.val)
        if t.kind == "kw":
            if t.val == "true":
                return ("lit", True)
            if t.val == "false":
                return ("lit", False)
            if t.val in ("null", "undefined"):
                return ("lit", None)
            if t.val == "case":
                return self._case()
            raise SqlError(f"unexpected keyword {t.val!r}")
        if t.kind == "op" and t.val == "(":
            e = self.parse_expr()
            if not self.accept_op(")"):
                raise SqlError("missing ')'")
            return e
        if t.kind == "name":
            if self.accept_op("("):
                args = []
                if not self.accept_op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                    if not self.accept_op(")"):
                        raise SqlError("missing ')' in call")
                return ("call", t.val.lower(), args)
            return ("path", [t.val])
        raise SqlError(f"unexpected token {t.val!r}")

    def _case(self):
        # CASE WHEN c THEN v [WHEN...] [ELSE d] END
        arms = []
        default = ("lit", None)
        while self.accept_kw("when"):
            c = self.parse_expr()
            self.expect_kw("then")
            v = self.parse_expr()
            arms.append((c, v))
        if self.accept_kw("else"):
            default = self.parse_expr()
        self.expect_kw("end")
        return ("case", arms, default)


def parse(sql: str) -> Select:
    return _Parser(_tokenize(sql)).parse_select()
