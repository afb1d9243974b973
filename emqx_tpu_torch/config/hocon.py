"""HOCON-subset parser — the config file syntax of the reference.

The reference loads HOCON via the `hocon` dep (SURVEY.md §5 config:
HOCON files → emqx_config:init_load → typed maps). This is a clean
implementation of the subset EMQX configs actually use:

  * objects `{}`, arrays `[]`, root braces optional
  * dotted key paths (`a.b.c = 1` ≡ `a { b { c = 1 } }`)
  * `=` / `:` separators; object values may omit the separator
  * `,` or newline element separators; trailing commas ok
  * comments `#` and `//`
  * quoted strings with escapes, triple-quoted raw strings
  * unquoted value strings (`15s`, `100MB`, `node@host`)
  * duplicate object keys deep-merge; later scalar wins
  * substitutions `${a.b}` / optional `${?a.b}` (resolved against the
    whole document after parse; env fallback `${?ENV_VAR}`)
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple


class HoconError(ValueError):
    pass


_NUM_RE = re.compile(r"^-?\d+(\.\d+)?([eE][+-]?\d+)?$")


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    # --- low-level ------------------------------------------------------

    def _err(self, msg: str):
        line = self.text.count("\n", 0, self.pos) + 1
        raise HoconError(f"line {line}: {msg}")

    def _skip_ws(self, newlines: bool = True) -> None:
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "#" or self.text.startswith("//", self.pos):
                nl = self.text.find("\n", self.pos)
                self.pos = self.n if nl < 0 else nl
            elif c in " \t\r" or (newlines and c == "\n"):
                self.pos += 1
            else:
                return

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    # --- tokens ---------------------------------------------------------

    def _quoted(self) -> str:
        if self.text.startswith('"""', self.pos):
            end = self.text.find('"""', self.pos + 3)
            if end < 0:
                self._err("unterminated triple-quoted string")
            s = self.text[self.pos + 3 : end]
            self.pos = end + 3
            return s
        assert self._peek() == '"'
        self.pos += 1
        out = []
        while True:
            if self.pos >= self.n:
                self._err("unterminated string")
            c = self.text[self.pos]
            if c == '"':
                self.pos += 1
                return "".join(out)
            if c == "\\":
                self.pos += 1
                e = self.text[self.pos]
                out.append(
                    {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "/": "/"}.get(
                        e, e
                    )
                )
                if e == "u":
                    out[-1] = chr(int(self.text[self.pos + 1 : self.pos + 5], 16))
                    self.pos += 4
                self.pos += 1
            else:
                out.append(c)
                self.pos += 1

    def _key(self) -> List[str]:
        """Returns the key as a path: quoted keys are literal (no dot
        splitting, per HOCON), unquoted dotted keys are paths."""
        self._skip_ws()
        if self._peek() == '"':
            return [self._quoted()]
        m = re.match(r"[A-Za-z0-9_\-\.\$@]+", self.text[self.pos :])
        if not m:
            self._err(f"expected key, got {self._peek()!r}")
        self.pos += m.end()
        return m.group(0).split(".")

    # --- values ---------------------------------------------------------

    def parse_root(self) -> Dict[str, Any]:
        self._skip_ws()
        if self._peek() == "{":
            v = self._object()
        else:
            v = self._object(root=True)
        self._skip_ws()
        if self.pos < self.n:
            self._err("trailing content")
        return v

    def _object(self, root: bool = False) -> Dict[str, Any]:
        if not root:
            assert self._peek() == "{"
            self.pos += 1
        obj: Dict[str, Any] = {}
        while True:
            self._skip_ws()
            if self.pos >= self.n:
                if root:
                    return obj
                self._err("unterminated object")
            if self._peek() == "}":
                if root:
                    self._err("unexpected '}'")
                self.pos += 1
                return obj
            if self._peek() == ",":
                self.pos += 1
                continue
            key = self._key()
            self._skip_ws(newlines=False)
            c = self._peek()
            if c in "=:":
                self.pos += 1
                self._skip_ws(newlines=False)
                val = self._value()
            elif c == "{":
                val = self._object()
            elif c == "+" and self.text.startswith("+=", self.pos):
                self.pos += 2
                self._skip_ws(newlines=False)
                val = _Append(self._value())
            else:
                self._err(f"expected '=', ':' or '{{' after key {key!r}")
            _merge_path(obj, key, val)

    def _array(self) -> List[Any]:
        assert self._peek() == "["
        self.pos += 1
        out: List[Any] = []
        while True:
            self._skip_ws()
            if self.pos >= self.n:
                self._err("unterminated array")
            if self._peek() == "]":
                self.pos += 1
                return out
            if self._peek() == ",":
                self.pos += 1
                continue
            out.append(self._value())

    def _value(self) -> Any:
        self._skip_ws(newlines=False)
        c = self._peek()
        if c == "{":
            return self._object()
        if c == "[":
            return self._array()
        if c == '"':
            s = self._quoted()
            # adjacent-string concat not needed for our configs
            return s
        if self.text.startswith("${", self.pos):
            end = self.text.find("}", self.pos)
            if end < 0:
                self._err("unterminated substitution")
            expr = self.text[self.pos + 2 : end]
            self.pos = end + 1
            return _Subst(expr.lstrip("?"), optional=expr.startswith("?"))
        # unquoted: until newline, comma, }, ], or comment
        m = re.match(r"[^\n,\}\]#]*", self.text[self.pos :])
        raw = m.group(0)
        # stop at // comment
        sl = raw.find("//")
        if sl >= 0:
            raw = raw[:sl]
        self.pos += len(raw)
        raw = raw.strip()
        if raw == "":
            self._err("empty value")
        return _coerce(raw)


class _Subst:
    def __init__(self, path: str, optional: bool):
        self.path = path
        self.optional = optional


class _Append:
    def __init__(self, value: Any):
        self.value = value


def _coerce(raw: str) -> Any:
    if raw == "true":
        return True
    if raw == "false":
        return False
    if raw == "null":
        return None
    if _NUM_RE.match(raw):
        f = float(raw)
        return int(raw) if f.is_integer() and "." not in raw and "e" not in raw.lower() else f
    return raw


def _merge_path(obj: Dict[str, Any], path: List[str], val: Any) -> None:
    for p in path[:-1]:
        nxt = obj.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            obj[p] = nxt
        obj = nxt
    last = path[-1]
    old = obj.get(last)
    if isinstance(old, dict) and isinstance(val, dict):
        for k, v in val.items():
            _merge_path(old, [k], v)
    elif isinstance(val, _Append):
        base = old if isinstance(old, list) else []
        obj[last] = base + [val.value]
    else:
        obj[last] = val


def _resolve(node: Any, root: Dict[str, Any], stack: Tuple[str, ...] = ()) -> Any:
    if isinstance(node, dict):
        return {
            k: r
            for k, v in node.items()
            if (r := _resolve(v, root, stack)) is not _MISSING
        }
    if isinstance(node, list):
        return [r for v in node if (r := _resolve(v, root, stack)) is not _MISSING]
    if isinstance(node, _Subst):
        if node.path in stack:
            raise HoconError(
                f"substitution cycle: {' -> '.join(stack + (node.path,))}"
            )
        cur: Any = root
        for p in node.path.split("."):
            if isinstance(cur, dict) and p in cur:
                cur = cur[p]
            else:
                cur = _MISSING
                break
        if cur is not _MISSING:
            return _resolve(cur, root, stack + (node.path,))
        env = os.environ.get(node.path)
        if env is not None:
            return _coerce(env)
        if node.optional:
            return _MISSING
        raise HoconError(f"unresolved substitution ${{{node.path}}}")
    return node


_MISSING = object()


def loads(text: str) -> Dict[str, Any]:
    raw = _Parser(text).parse_root()
    return _resolve(raw, raw)


def load(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return loads(f.read())
