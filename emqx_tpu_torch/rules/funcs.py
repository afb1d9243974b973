"""Builtin rule functions — emqx_rule_funcs analog (the port's own copy
of emqx_tpu/rules/funcs.py).

Full-parity table of the reference's exported builtins
(apps/emqx_rule_engine/src/emqx_rule_funcs.erl:25-283 exports;
string/bit helpers delegate to apps/emqx_utils/src/emqx_variform_bif.erl,
date helpers to emqx_utils_calendar.erl): type conversion, string,
arithmetic/trig, bitwise + subbits, map/array, JSON + Erlang external
term format, time/tz formatting, compression, hashing/encoding/UUID,
topic, conditional, redis/sql arg shaping, proc-dict + kv-store state,
message-context accessors, and a practical jq subset.
"""

from __future__ import annotations

import base64
import hashlib
from .. import jsonc as json  # codec seam: native, stdlib replay per call
import math
import os
import re
import struct
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional

from ..ops import topic as topic_mod


def _num(x: Any) -> float:
    if isinstance(x, bool):
        return 1.0 if x else 0.0
    if isinstance(x, (int, float)):
        return x
    return float(x)


def _str(x: Any) -> str:
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    if isinstance(x, bool):
        return "true" if x else "false"
    if x is None:
        return ""
    if isinstance(x, (dict, list)):
        return json.dumps(x)
    return str(x)


FUNCS: Dict[str, Callable[..., Any]] = {}


def func(name: str):
    def deco(f):
        FUNCS[name] = f
        return f

    return deco


# --- type conversion / checks ------------------------------------------

FUNCS["str"] = _str
FUNCS["str_utf8"] = _str
FUNCS["int"] = lambda x: int(_num(x))
FUNCS["float"] = _num
FUNCS["bool"] = lambda x: x in (True, "true", 1)
FUNCS["num"] = _num
FUNCS["is_null"] = lambda x: x is None
FUNCS["is_not_null"] = lambda x: x is not None
FUNCS["is_str"] = lambda x: isinstance(x, str)
FUNCS["is_num"] = lambda x: isinstance(x, (int, float)) and not isinstance(x, bool)
FUNCS["is_int"] = lambda x: isinstance(x, int) and not isinstance(x, bool)
FUNCS["is_float"] = lambda x: isinstance(x, float)
FUNCS["is_bool"] = lambda x: isinstance(x, bool)
FUNCS["is_map"] = lambda x: isinstance(x, dict)
FUNCS["is_array"] = lambda x: isinstance(x, list)

# --- arithmetic ---------------------------------------------------------

FUNCS["abs"] = lambda x: abs(_num(x))
FUNCS["ceil"] = lambda x: math.ceil(_num(x))
FUNCS["floor"] = lambda x: math.floor(_num(x))
FUNCS["round"] = lambda x: round(_num(x))
FUNCS["sqrt"] = lambda x: math.sqrt(_num(x))
FUNCS["exp"] = lambda x: math.exp(_num(x))
FUNCS["power"] = lambda x, y: _num(x) ** _num(y)
FUNCS["log"] = lambda x: math.log(_num(x))
FUNCS["log10"] = lambda x: math.log10(_num(x))
FUNCS["log2"] = lambda x: math.log2(_num(x))
FUNCS["mod"] = lambda x, y: int(_num(x)) % int(_num(y))
FUNCS["range"] = lambda a, b: list(range(int(_num(a)), int(_num(b)) + 1))
FUNCS["random"] = lambda: __import__("random").random()

# --- strings ------------------------------------------------------------

FUNCS["lower"] = lambda s: _str(s).lower()
FUNCS["upper"] = lambda s: _str(s).upper()
FUNCS["trim"] = lambda s: _str(s).strip()
FUNCS["ltrim"] = lambda s: _str(s).lstrip()
FUNCS["rtrim"] = lambda s: _str(s).rstrip()
FUNCS["reverse"] = lambda s: _str(s)[::-1]
FUNCS["strlen"] = lambda s: len(_str(s))
FUNCS["substr"] = lambda s, start, *n: (
    _str(s)[int(start) :] if not n else _str(s)[int(start) : int(start) + int(n[0])]
)
FUNCS["concat"] = lambda *xs: "".join(_str(x) for x in xs)
FUNCS["regex_match"] = lambda s, p: re.search(p, _str(s)) is not None
FUNCS["regex_replace"] = lambda s, p, r: re.sub(p, r, _str(s))
FUNCS["regex_extract"] = lambda s, p: (
    (m := re.search(p, _str(s))) and (m.group(1) if m.groups() else m.group(0)) or ""
)
FUNCS["ascii"] = lambda s: ord(_str(s)[0])
FUNCS["join_to_string"] = lambda sep, xs: _str(sep).join(_str(x) for x in xs)
FUNCS["tokens"] = lambda s, sep: [p for p in _str(s).split(_str(sep)) if p]

# --- maps / arrays ------------------------------------------------------

FUNCS["map_get"] = lambda key, m, *d: (m or {}).get(_str(key), d[0] if d else None)
FUNCS["map_put"] = lambda key, val, m: {**(m or {}), _str(key): val}
FUNCS["map_keys"] = lambda m: list((m or {}).keys())
FUNCS["map_values"] = lambda m: list((m or {}).values())
FUNCS["map_to_entries"] = lambda m: [
    {"key": k, "value": v} for k, v in (m or {}).items()
]
FUNCS["mget"] = FUNCS["map_get"]
FUNCS["mput"] = FUNCS["map_put"]
FUNCS["nth"] = lambda n, xs: xs[int(n) - 1] if 0 < int(n) <= len(xs) else None
FUNCS["length"] = lambda xs: len(xs)
FUNCS["first"] = lambda xs: xs[0] if xs else None
FUNCS["last"] = lambda xs: xs[-1] if xs else None
FUNCS["contains"] = lambda x, xs: x in xs


# --- JSON ---------------------------------------------------------------


@func("json_decode")
def _json_decode(s):
    if isinstance(s, (dict, list)):
        return s
    if isinstance(s, bytes):
        s = s.decode("utf-8", "replace")
    return json.loads(s)


FUNCS["json_encode"] = lambda x: json.dumps(x, separators=(",", ":"))

# --- time ---------------------------------------------------------------


# --- hashing / encoding -------------------------------------------------

FUNCS["md5"] = lambda s: hashlib.md5(_b(s)).hexdigest()
FUNCS["sha"] = lambda s: hashlib.sha1(_b(s)).hexdigest()
FUNCS["sha256"] = lambda s: hashlib.sha256(_b(s)).hexdigest()
FUNCS["base64_encode"] = lambda s: base64.b64encode(_b(s)).decode()
FUNCS["base64_decode"] = lambda s: base64.b64decode(_str(s)).decode("utf-8", "replace")
FUNCS["hexstr"] = lambda s: _b(s).hex()
FUNCS["bitsize"] = lambda s: len(_b(s)) * 8
FUNCS["bytesize"] = lambda s: len(_b(s))
FUNCS["byteszie"] = FUNCS["bytesize"]  # reference's typo'd alias
FUNCS["uuid_v4"] = lambda: str(uuid.uuid4())
FUNCS["crc32"] = lambda s: __import__("zlib").crc32(_b(s))


def _b(x: Any) -> bytes:
    if isinstance(x, bytes):
        return x
    return _str(x).encode()


# --- topic helpers ------------------------------------------------------

FUNCS["topic_match"] = lambda t, f: topic_mod.match(
    topic_mod.words(_str(t)), topic_mod.words(_str(f))
)


@func("nth_topic_level")
def _nth_level(n, t):
    ws = topic_mod.words(_str(t))
    n = int(n)
    return ws[n - 1] if 0 < n <= len(ws) else None


FUNCS["topic_levels"] = lambda t: topic_mod.words(_str(t))

# --- conditional --------------------------------------------------------

FUNCS["iif"] = lambda c, a, b: a if c in (True, "true") else b

# --- schema registry (emqx_schema_registry_serde rule functions) --------


def _schema_registry():
    from ..transform.registry import default_registry

    return default_registry()


@func("schema_decode")
def _schema_decode(name, payload):
    data = payload.encode() if isinstance(payload, str) else bytes(payload)
    return _schema_registry().check_payload(_str(name), data)


@func("schema_encode")
def _schema_encode(name, value):
    return _schema_registry().encode_payload(_str(name), value)


@func("schema_check")
def _schema_check(name, payload):
    try:
        data = payload.encode() if isinstance(payload, str) else bytes(payload)
        _schema_registry().check_payload(_str(name), data)
        return True
    except Exception:
        return False


# ======================================================================
# Full-parity additions (VERDICT r3 item 7): the remaining reference
# exports, table-driven-tested in tests/test_rule_funcs_parity.py.
# ======================================================================

# --- trig / math (emqx_rule_funcs.erl math section) ---------------------

for _name in ("acos", "acosh", "asin", "asinh", "atan", "atanh", "cos",
              "cosh", "sin", "sinh", "tan", "tanh"):
    FUNCS[_name] = (lambda f: lambda x: f(_num(x)))(getattr(math, _name))
FUNCS["fmod"] = lambda x, y: math.fmod(_num(x), _num(y))
def _erl_div(x, y):
    # Erlang div truncates toward ZERO (Python // floors)
    a, b = int(_num(x)), int(_num(y))
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


FUNCS["div"] = _erl_div
FUNCS["eq"] = lambda x, y: x == y
FUNCS["null"] = lambda: None

# --- bitwise + subbits --------------------------------------------------

FUNCS["bitand"] = lambda x, y: int(_num(x)) & int(_num(y))
FUNCS["bitor"] = lambda x, y: int(_num(x)) | int(_num(y))
FUNCS["bitxor"] = lambda x, y: int(_num(x)) ^ int(_num(y))
FUNCS["bitnot"] = lambda x: ~int(_num(x))
FUNCS["bitsl"] = lambda x, n: int(_num(x)) << int(_num(n))
FUNCS["bitsr"] = lambda x, n: int(_num(x)) >> int(_num(n))


@func("subbits")
def _subbits(data, *args):
    """subbits(Bits, Len) / (Bits, Start, Len[, Type[, Signedness[,
    Endianness]]]) — 1-based bit offsets, like the reference
    (emqx_rule_funcs.erl:596-707). Type: integer|float|bits."""
    raw = _b(data)
    if len(args) == 1:
        start, length = 1, int(args[0])
        typ, signed, endian = "integer", "unsigned", "big"
    else:
        start, length = int(args[0]), int(args[1])
        typ = _str(args[2]) if len(args) > 2 else "integer"
        signed = _str(args[3]) if len(args) > 3 else "unsigned"
        endian = _str(args[4]) if len(args) > 4 else "big"
    nbits = len(raw) * 8
    if start < 1 or length < 0 or start - 1 + length > nbits:
        return None
    whole = int.from_bytes(raw, "big")
    chunk = (whole >> (nbits - (start - 1) - length)) & ((1 << length) - 1)
    if typ == "bits":
        # bit-exact slice, returned as bytes (pad to byte boundary)
        nbytes = (length + 7) // 8
        return (chunk << (nbytes * 8 - length)).to_bytes(nbytes, "big")
    if endian == "little":
        # Erlang bit-syntax little-endian: the FIRST 8 bits of the
        # stream are the least-significant byte; a trailing partial
        # byte is most significant (<<16#12, 16#3:4>> :12/little ->
        # 16#312). Byte-padding then swapping diverges for lengths
        # that aren't a multiple of 8.
        nfull, rbits = divmod(length, 8)
        val = 0
        stream = chunk
        if rbits:
            partial = stream & ((1 << rbits) - 1)
            stream >>= rbits
            val = partial << (8 * nfull)
        for i in range(nfull):
            byte = (stream >> (8 * (nfull - 1 - i))) & 0xFF
            val |= byte << (8 * i)
        chunk = val
    if typ == "float":
        if length == 32:
            return struct.unpack(">f", chunk.to_bytes(4, "big"))[0]
        if length == 64:
            return struct.unpack(">d", chunk.to_bytes(8, "big"))[0]
        return None
    if length and signed == "signed" and chunk >= 1 << (length - 1):
        chunk -= 1 << length
    return chunk


# --- strings ------------------------------------------------------------


@func("float2str")
def _float2str(x, precision):
    # float_to_binary(F, [{decimals, P}, compact]) trims trailing zeros
    # but keeps at least one decimal
    s = f"{_num(x):.{int(precision)}f}"
    if "." in s:
        s = s.rstrip("0")
        if s.endswith("."):
            s += "0"
    return s


def _pad(s, n, position="trailing", char=" "):
    s, n, char = _str(s), int(n), _str(char) or " "
    fill = n - len(s)
    if fill <= 0:
        return s
    pad = (char * fill)[:fill]
    if position == "leading":
        return pad + s
    if position == "both":
        left = fill // 2
        return (char * left)[:left] + s + (char * (fill - left))[: fill - left]
    return s + pad


FUNCS["pad"] = _pad


@func("replace")
def _replace(s, pat, rep, where="all"):
    s, pat, rep = _str(s), _str(pat), _str(rep)
    if where == "leading":
        return s.replace(pat, rep, 1)
    if where == "trailing":
        i = s.rfind(pat)
        return s if i < 0 else s[:i] + rep + s[i + len(pat):]
    return s.replace(pat, rep)


@func("find")
def _find(s, sub, direction="leading"):
    s, sub = _str(s), _str(sub)
    i = s.rfind(sub) if _str(direction) == "trailing" else s.find(sub)
    return s[i:] if i >= 0 else ""


@func("split")
def _split(s, sep=" ", mode=None):
    s, sep = _str(s), _str(sep)
    mode = _str(mode) if mode is not None else None
    if mode is None:
        return [p for p in s.split(sep) if p != ""]
    if mode == "notrim":
        return s.split(sep)
    if mode == "leading_notrim":
        return s.split(sep, 1)
    if mode == "leading":
        return [p for p in s.split(sep, 1) if p != ""]
    if mode == "trailing_notrim":
        return s.rsplit(sep, 1)
    if mode == "trailing":
        return [p for p in s.rsplit(sep, 1) if p != ""]
    return [p for p in s.split(sep) if p != ""]


@func("rm_prefix")
def _rm_prefix(s, prefix):
    s, prefix = _str(s), _str(prefix)
    return s[len(prefix):] if s.startswith(prefix) else s


@func("sprintf_s")
def _sprintf_s(fmt, args=None):
    """Erlang io_lib:format subset: ~s ~ts ~p ~w ~b ~n ~~."""
    out, i, ai = [], 0, 0
    fmt = _str(fmt)
    args = list(args or [])
    while i < len(fmt):
        c = fmt[i]
        if c != "~":
            out.append(c)
            i += 1
            continue
        i += 1
        spec = fmt[i] if i < len(fmt) else ""
        if spec == "t" and i + 1 < len(fmt):
            i += 1
            spec = fmt[i]
        i += 1
        if spec == "~":
            out.append("~")
        elif spec == "n":
            out.append("\n")
        elif spec == "s":
            out.append(_str(args[ai])); ai += 1
        elif spec in ("p", "w"):
            a = args[ai]; ai += 1
            out.append(json.dumps(a) if isinstance(a, (dict, list)) else _str(a))
        elif spec in ("b", "B"):
            out.append(str(int(_num(args[ai])))); ai += 1
        else:
            out.append(spec)
    return "".join(out)


FUNCS["sprintf"] = lambda fmt, *xs: _sprintf_s(fmt, list(xs))


@func("unescape")
def _unescape(s):
    """C-style escapes (emqx_variform_bif.erl:291-345): \\n \\t \\r
    \\b \\f \\v \\' \\" \\? \\a \\\\ and \\xHH hex."""
    src = _str(s)
    out, i = [], 0
    simple = {"\\": "\\", "n": "\n", "t": "\t", "r": "\r", "b": "\b",
              "f": "\f", "v": "\v", "'": "'", '"': '"', "?": "?",
              "a": "\a"}
    while i < len(src):
        c = src[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        if i + 1 >= len(src):
            raise ValueError("dangling backslash")
        n = src[i + 1]
        if n in simple:
            out.append(simple[n])
            i += 2
        elif n == "x":
            j = i + 2
            while j < len(src) and src[j] in "0123456789abcdefABCDEF":
                j += 1
            if j == i + 2:
                raise ValueError("invalid hex escape")
            out.append(chr(int(src[i + 2 : j], 16)))
            i = j
        else:
            raise ValueError(f"unrecognized escape \\{n}")
    return "".join(out)


@func("str_utf16_le")
def _str_utf16_le(s):
    return _str(s).encode("utf-16-le")


# --- hex ----------------------------------------------------------------

FUNCS["bin2hexstr"] = lambda b, prefix=None: (
    (_str(prefix) if prefix is not None else "") + _b(b).hex().upper()
)


@func("hexstr2bin")
def _hexstr2bin(s, prefix=None):
    s = _str(s)
    if prefix is not None and s.startswith(_str(prefix)):
        s = s[len(_str(prefix)):]
    return bytes.fromhex(s)


FUNCS["sqlserver_bin2hexstr"] = lambda b: "0x" + _b(b).hex().upper()

# --- compression --------------------------------------------------------

def _zcompress(data, wbits):
    # zlib.compress() grew its wbits kwarg in 3.11; compressobj works on 3.10
    co = zlib.compressobj(wbits=wbits)
    return co.compress(data) + co.flush()


FUNCS["gzip"] = lambda s: _zcompress(_b(s), wbits=31)
FUNCS["gunzip"] = lambda s: zlib.decompress(_b(s), wbits=31)
FUNCS["zip"] = lambda s: _zcompress(_b(s), wbits=-15)  # raw deflate
FUNCS["unzip"] = lambda s: zlib.decompress(_b(s), wbits=-15)
FUNCS["zip_compress"] = lambda s: zlib.compress(_b(s))  # zlib-wrapped
FUNCS["zip_uncompress"] = lambda s: zlib.decompress(_b(s))

# --- maps / arrays ------------------------------------------------------

FUNCS["map_new"] = lambda: {}
FUNCS["map_size"] = lambda m: len(m or {})


@func("map")
def _map(x):
    if isinstance(x, dict):
        return x
    if isinstance(x, (bytes, str)):
        v = json.loads(_str(x))
        if not isinstance(v, dict):
            raise ValueError("map(): JSON is not an object")
        return v
    if isinstance(x, list):
        return {
            _str(k): v
            for k, v in (
                (e[0], e[1]) if isinstance(e, (list, tuple))
                else (e.get("key"), e.get("value"))
                for e in x
            )
        }
    raise ValueError("map(): bad argument")


@func("sublist")
def _sublist(*args):
    if len(args) == 2:
        n, xs = args
        return list(xs)[: int(n)]
    start, n, xs = args  # 1-based start like lists:sublist/3
    return list(xs)[int(start) - 1 : int(start) - 1 + int(n)]


FUNCS["is_empty"] = lambda x: (
    x is None or x == "" or x == b"" or x == [] or x == {}
)
FUNCS["is_null_var"] = lambda x: x is None or x == "undefined"
FUNCS["is_not_null_var"] = lambda x: not FUNCS["is_null_var"](x)


@func("coalesce_ne")
def _coalesce_ne(*xs):
    vals = xs[0] if len(xs) == 1 and isinstance(xs[0], list) else xs
    for v in vals:
        if v is not None and v != "" and v != b"":
            return v
    return None


@func("coalesce")
def _coalesce(*xs):
    vals = xs[0] if len(xs) == 1 and isinstance(xs[0], list) else xs
    for v in vals:
        if v is not None:
            return v
    return None


# --- redis / sql arg shaping --------------------------------------------


@func("map_to_redis_hset_args")
def _map_to_redis_hset_args(payload):
    """Flatten a map to [field, value, ...] for HSET (floats get
    6-decimal compact formatting, emqx_rule_funcs.erl:901-938)."""
    if isinstance(payload, (str, bytes)):
        try:
            payload = json.loads(_str(payload))
        except Exception:
            return []
    if not isinstance(payload, dict):
        return []
    out = []
    for k, v in payload.items():
        if isinstance(v, bool):
            out += [_str(k), "true" if v else "false"]
        elif isinstance(v, float):
            out += [_str(k), _float2str(v, 6)]
        elif isinstance(v, (int, str, bytes)):
            out += [_str(k), _str(v)]
    return out


def _quote_sql(v):
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return _str(v)
    if isinstance(v, (list, dict)):
        v = json.dumps(v)
    return "'" + _str(v).replace("'", "''") + "'"


FUNCS["join_to_sql_values_string"] = lambda xs: ", ".join(
    _quote_sql(x) for x in xs
)

# --- Erlang external term format (term_to_binary parity) ----------------


def _etf_encode(x) -> bytes:
    def enc(v):
        if v is None:
            return b"\x77\x09undefined"  # SMALL_ATOM_UTF8
        if v is True:
            return b"\x77\x04true"
        if v is False:
            return b"\x77\x05false"
        if isinstance(v, int):
            if 0 <= v <= 255:
                return b"\x61" + bytes([v])
            if -(1 << 31) <= v < (1 << 31):
                return b"\x62" + struct.pack(">i", v)
            # SMALL_BIG_EXT
            sign = 1 if v < 0 else 0
            mag = abs(v)
            nb = (mag.bit_length() + 7) // 8
            return b"\x6e" + bytes([nb, sign]) + mag.to_bytes(nb, "little")
        if isinstance(v, float):
            return b"\x46" + struct.pack(">d", v)
        if isinstance(v, str):
            v = v.encode()
        if isinstance(v, bytes):
            return b"\x6d" + struct.pack(">I", len(v)) + v
        if isinstance(v, (list, tuple)):
            if not v:
                return b"\x6a"  # NIL
            return (
                b"\x6c" + struct.pack(">I", len(v))
                + b"".join(enc(e) for e in v) + b"\x6a"
            )
        if isinstance(v, dict):
            return b"\x74" + struct.pack(">I", len(v)) + b"".join(
                enc(k) + enc(val) for k, val in v.items()
            )
        raise ValueError(f"term_encode: unsupported {type(v).__name__}")

    return b"\x83" + enc(x)


def _etf_decode(data: bytes):
    buf = memoryview(_b(data))
    if not buf or buf[0] != 0x83:
        raise ValueError("not an external term")

    def dec(pos):
        tag = buf[pos]
        pos += 1
        if tag == 0x61:
            return buf[pos], pos + 1
        if tag == 0x62:
            return struct.unpack_from(">i", buf, pos)[0], pos + 4
        if tag == 0x6E:
            nb, sign = buf[pos], buf[pos + 1]
            mag = int.from_bytes(bytes(buf[pos + 2 : pos + 2 + nb]), "little")
            return (-mag if sign else mag), pos + 2 + nb
        if tag == 0x46:
            return struct.unpack_from(">d", buf, pos)[0], pos + 8
        if tag in (0x77, 0x73):  # SMALL_ATOM_UTF8 / SMALL_ATOM
            n = buf[pos]
            name = bytes(buf[pos + 1 : pos + 1 + n]).decode()
            v = {"true": True, "false": False, "undefined": None}.get(
                name, name
            )
            return v, pos + 1 + n
        if tag in (0x76, 0x64):  # ATOM_UTF8 / ATOM_EXT (2-byte len)
            n = struct.unpack_from(">H", buf, pos)[0]
            name = bytes(buf[pos + 2 : pos + 2 + n]).decode()
            v = {"true": True, "false": False, "undefined": None}.get(
                name, name
            )
            return v, pos + 2 + n
        if tag == 0x6D:
            n = struct.unpack_from(">I", buf, pos)[0]
            return bytes(buf[pos + 4 : pos + 4 + n]), pos + 4 + n
        if tag == 0x6A:
            return [], pos
        if tag == 0x6C:
            n = struct.unpack_from(">I", buf, pos)[0]
            pos += 4
            out = []
            for _ in range(n):
                v, pos = dec(pos)
                out.append(v)
            tail, pos = dec(pos)
            if tail != []:
                out.append(tail)  # improper list: keep the tail
            return out, pos
        if tag == 0x6B:  # STRING_EXT: list of small ints
            n = struct.unpack_from(">H", buf, pos)[0]
            return list(bytes(buf[pos + 2 : pos + 2 + n])), pos + 2 + n
        if tag == 0x74:
            n = struct.unpack_from(">I", buf, pos)[0]
            pos += 4
            out = {}
            for _ in range(n):
                k, pos = dec(pos)
                v, pos = dec(pos)
                if isinstance(k, bytes):
                    k = k.decode("utf-8", "replace")
                out[k] = v
            return out, pos
        raise ValueError(f"term_decode: unsupported tag {tag}")

    v, _pos = dec(1)
    return v


FUNCS["term_encode"] = _etf_encode
FUNCS["term_decode"] = _etf_decode

# --- time / timezone ----------------------------------------------------

_UNIT_S = {"second": 1, "millisecond": 10**3, "microsecond": 10**6,
           "nanosecond": 10**9}


def _unit_mult(unit) -> int:
    u = _str(unit) if unit is not None else "second"
    if u not in _UNIT_S:
        raise ValueError(f"bad time unit {u!r}")
    return _UNIT_S[u]


@func("timezone_to_offset_seconds")
def _tz_offset(tz):
    tz = _str(tz)
    if tz in ("Z", "z", "utc", "UTC", ""):
        return 0
    if tz == "local":
        # altzone is the DST-adjusted offset; hardcoding +3600 breaks
        # half-hour-DST zones (Lord Howe)
        if time.daylight and time.localtime().tm_isdst:
            return -time.altzone
        return -time.timezone
    m = re.fullmatch(r"([+-])(\d{2}):?(\d{2})(?::?(\d{2}))?", tz)
    if not m:
        raise ValueError(f"bad timezone {tz!r}")
    sign = -1 if m.group(1) == "-" else 1
    return sign * (
        int(m.group(2)) * 3600 + int(m.group(3)) * 60 + int(m.group(4) or 0)
    )


FUNCS["timezone_to_second"] = _tz_offset


def _fmt_epoch(epoch, unit_mult: int, offset_s: int, fmt: str) -> str:
    """emqx_utils_calendar format tokens: %Y %m %d %H %M %S %N(ns)
    %3N(ms) %6N(us) %z(+0800) %:z(+08:00). Integer arithmetic
    throughout — nanosecond epochs (~1e18) lose digits past float53."""
    whole, rem = divmod(int(epoch), unit_mult)
    frac_ns = rem * (10**9 // unit_mult)
    t = time.gmtime(whole + offset_s)
    sign = "+" if offset_s >= 0 else "-"
    oh, om = divmod(abs(offset_s) // 60, 60)
    reps = {
        "%Y": f"{t.tm_year:04d}", "%m": f"{t.tm_mon:02d}",
        "%d": f"{t.tm_mday:02d}", "%H": f"{t.tm_hour:02d}",
        "%M": f"{t.tm_min:02d}", "%S": f"{t.tm_sec:02d}",
        "%6N": f"{frac_ns // 1000:06d}", "%3N": f"{frac_ns // 1000000:03d}",
        "%N": f"{frac_ns:09d}",
        "%:z": f"{sign}{oh:02d}:{om:02d}", "%z": f"{sign}{oh:02d}{om:02d}",
    }
    out = fmt
    for k in ("%6N", "%3N", "%N", "%:z", "%z", "%Y", "%m", "%d", "%H",
              "%M", "%S"):
        out = out.replace(k, reps[k])
    return out


@func("format_date")
def _format_date(unit, offset, fmt, epoch=None):
    mult = _unit_mult(unit)
    if epoch is None:
        epoch = int(time.time() * mult)
    off = offset if isinstance(offset, int) else _tz_offset(offset)
    return _fmt_epoch(int(_num(epoch)), mult, off, _str(fmt))


@func("date_to_unix_ts")
def _date_to_unix_ts(unit, *args):
    """(unit, fmt, input) or (unit, offset, fmt, input)."""
    mult = _unit_mult(unit)
    if len(args) == 2:
        fmt, inp = args
        offset = None
    else:
        offset, fmt, inp = args
    fmt, inp = _str(fmt), _str(inp)
    # translate the calendar tokens to a regex, capture parts
    token_re = {
        "%Y": r"(?P<Y>\d{4})", "%m": r"(?P<m>\d{1,2})",
        "%d": r"(?P<d>\d{1,2})", "%H": r"(?P<H>\d{1,2})",
        "%M": r"(?P<M>\d{1,2})", "%S": r"(?P<S>\d{1,2})",
        "%6N": r"(?P<us>\d{1,6})", "%3N": r"(?P<ms>\d{1,3})",
        "%N": r"(?P<ns>\d{1,9})",
        "%:z": r"(?P<tz>Z|[+-]\d{2}:\d{2})",
        "%z": r"(?P<tz>Z|[+-]\d{4})",
    }
    pat = ""
    i = 0
    while i < len(fmt):
        for tok in ("%6N", "%3N", "%:z", "%N", "%z", "%Y", "%m", "%d",
                    "%H", "%M", "%S"):
            if fmt.startswith(tok, i):
                pat += token_re[tok]
                i += len(tok)
                break
        else:
            pat += re.escape(fmt[i])
            i += 1
    m = re.fullmatch(pat, inp)
    if not m:
        raise ValueError(f"date {inp!r} does not match format {fmt!r}")
    g = m.groupdict()
    import calendar as _cal

    base = _cal.timegm((
        int(g.get("Y") or 1970), int(g.get("m") or 1), int(g.get("d") or 1),
        int(g.get("H") or 0), int(g.get("M") or 0), int(g.get("S") or 0),
        0, 0, 0,
    ))
    # integer nanoseconds: float arithmetic loses digits past 2^53
    # (nanosecond epochs are ~1e18)
    ns = 0
    if g.get("ns"):
        ns = int(g["ns"])
    elif g.get("us"):
        ns = int(g["us"]) * 1000
    elif g.get("ms"):
        ns = int(g["ms"]) * 1_000_000
    tz = g.get("tz")
    if tz:
        base -= _tz_offset(tz)
    out = base * mult + ns * mult // 10**9
    if offset is not None and not tz:
        off_s = offset if isinstance(offset, int) else _tz_offset(offset)
        out -= int(off_s) * mult
    return out


@func("rfc3339_to_unix_ts")
def _rfc3339_to_unix_ts(s, unit=None):
    import calendar as _cal

    mult = _unit_mult(unit)
    m = re.fullmatch(
        r"(\d{4})-(\d{2})-(\d{2})[Tt ]"
        r"(\d{2}):(\d{2}):(\d{2})(?:[.,](\d{1,9}))?"
        r"(Z|z|[+-]\d{2}:?\d{2})?",
        _str(s),
    )
    if not m:
        raise ValueError(f"bad RFC3339 datetime {s!r}")
    y, mo, d, h, mi, sec, frac, tz = m.groups()
    base = _cal.timegm(
        (int(y), int(mo), int(d), int(h), int(mi), int(sec), 0, 0, 0)
    )
    if tz and tz not in ("Z", "z"):
        base -= _tz_offset(tz)
    # exact integer nanoseconds (float timestamp() loses sub-us digits)
    ns = int(frac.ljust(9, "0")) if frac else 0
    return base * mult + ns * mult // 10**9


@func("unix_ts_to_rfc3339")
def _unix_ts_to_rfc3339(epoch, unit=None):
    mult = _unit_mult(unit)
    fmt = {1: "%Y-%m-%dT%H:%M:%S",
           10**3: "%Y-%m-%dT%H:%M:%S.%3N",
           10**6: "%Y-%m-%dT%H:%M:%S.%6N",
           10**9: "%Y-%m-%dT%H:%M:%S.%N"}[mult]
    off = _tz_offset("local")
    return _fmt_epoch(int(_num(epoch)), mult, off, fmt) + _fmt_epoch(
        0, 1, off, "%:z"
    )


@func("now_rfc3339")
def _now_rfc3339(unit=None):
    mult = _unit_mult(unit)
    return _unix_ts_to_rfc3339(int(time.time() * mult), unit)


FUNCS["now_timestamp"] = lambda unit=None: int(
    time.time() * _unit_mult(unit)
)


@func("mongo_date")
def _mongo_date(ts=None, unit=None):
    if ts is None:
        ms = int(time.time() * 1000)
    elif unit is not None:
        ms = int(_num(ts)) * 1000 // _unit_mult(unit)
    else:
        ms = int(_num(ts))  # bare timestamp is milliseconds
    iso = _fmt_epoch(ms, 1000, 0, "%Y-%m-%dT%H:%M:%S.%3N+00:00")
    return f"ISODate({iso})"


# --- UUID / hashing -----------------------------------------------------

FUNCS["uuid_v4_no_hyphen"] = lambda: uuid.uuid4().hex


@func("hash")
def _hash(alg, data):
    alg = _str(alg).lower()
    alg = {"sha1": "sha1", "sha": "sha1"}.get(alg, alg)
    return hashlib.new(alg, _b(data)).hexdigest()


# --- topic --------------------------------------------------------------


@func("contains_topic")
def _contains_topic(filters, topic):
    # exact-name membership; wildcard semantics live in
    # contains_topic_match (emqx_rule_funcs.erl contains_topic/2)
    want = _str(topic)
    for f in filters or []:
        name = f.get("topic") if isinstance(f, dict) else f
        if _str(name) == want:
            return True
    return False


@func("contains_topic_match")
def _contains_topic_match(filters, topic):
    t = topic_mod.words(_str(topic))
    for f in filters or []:
        name = f.get("topic") if isinstance(f, dict) else f
        if topic_mod.match(t, topic_mod.words(_str(name))):
            return True
    return False


# --- state: proc dict + kv store ---------------------------------------
# The reference scopes the proc dict to the evaluating rule's process
# (emqx_rule_funcs proc_dict over erlang:put/get) — rules must not
# observe each other's values — while kv_store is node-global ets.
# Both therefore resolve through the ENV the engine passes (ADVICE
# r4): apply_rule injects "_proc_dict" (per rule id) and "_kv_store"
# (per engine). The module-level fallbacks only serve direct FUNCS
# calls outside an engine (tests/tools).

_PROC_DICT: Dict[str, Any] = {}
_KV_STORE: Dict[str, Any] = {}


def _env_state(env, key, fallback):
    d = env.get(key)
    return d if d is not None else fallback


def env_func(name: str):
    """Register an env-aware func (the engine prepends the event env;
    also used by the message-context accessors below)."""

    def deco(f):
        f._wants_env = True
        FUNCS[name] = f
        return f

    return deco


@env_func("proc_dict_get")
def _proc_dict_get(env, k):
    return _env_state(env, "_proc_dict", _PROC_DICT).get(_str(k))


@env_func("proc_dict_put")
def _proc_dict_put(env, k, v):
    _env_state(env, "_proc_dict", _PROC_DICT)[_str(k)] = v


@env_func("proc_dict_del")
def _proc_dict_del(env, k):
    _env_state(env, "_proc_dict", _PROC_DICT).pop(_str(k), None)


@env_func("kv_store_get")
def _kv_store_get(env, k, *d):
    return _env_state(env, "_kv_store", _KV_STORE).get(
        _str(k), d[0] if d else None
    )


@env_func("kv_store_put")
def _kv_store_put(env, k, v):
    _env_state(env, "_kv_store", _KV_STORE)[_str(k)] = v


@env_func("kv_store_del")
def _kv_store_del(env, k):
    _env_state(env, "_kv_store", _KV_STORE).pop(_str(k), None)

# --- system -------------------------------------------------------------

FUNCS["getenv"] = lambda name: os.environ.get("EMQXVAR_" + _str(name))

# --- message-context accessors (engine passes env via _wants_env) -------


@env_func("msgid")
def _msgid(env):
    return env.get("id")


@env_func("qos")
def _qos(env):
    return env.get("qos")


@env_func("topic")
def _topic(env, n=None):
    t = env.get("topic")
    if n is None or t is None:
        return t
    ws = topic_mod.words(_str(t))
    n = int(n)
    return ws[n - 1] if 0 < n <= len(ws) else None


@env_func("flags")
def _flags(env):
    return env.get("flags") or {}


@env_func("flag")
def _flag(env, name):
    return (env.get("flags") or {}).get(_str(name))


@env_func("clientid")
def _clientid(env):
    return env.get("clientid") or env.get("from")


@env_func("username")
def _username(env):
    return env.get("username")


@env_func("peerhost")
def _peerhost(env):
    return env.get("peerhost")


FUNCS["clientip"] = FUNCS["peerhost"]


@env_func("payload")
def _payload(env, path=None):
    p = env.get("payload")
    if path is None:
        return p
    if isinstance(p, (str, bytes)):
        try:
            p = json.loads(_str(p))
        except Exception:
            return None
    for key in _str(path).split("."):
        if not isinstance(p, dict):
            return None
        p = p.get(key)
    return p


# --- jq (practical subset of the optional jq port) ----------------------


@func("jq")
def _jq(prog, data, _timeout_ms=None):
    """Subset: identity, field paths, array iteration/index, pipes,
    select(.path OP literal). Anything else raises (like the reference
    throws jq_exception on errors)."""
    if isinstance(data, (str, bytes)):
        data = json.loads(_str(data))

    def apply(term, inputs):
        term = term.strip()
        if term in (".", ""):
            return inputs
        m = re.fullmatch(
            r"select\(\s*\.([\w.]*)\s*(==|!=|>|<|>=|<=)\s*(.+?)\s*\)", term
        )
        if m:
            path, op, lit = m.groups()
            lit = json.loads(lit)
            out = []
            for v in inputs:
                cur = v
                for k in filter(None, path.split(".")):
                    cur = cur.get(k) if isinstance(cur, dict) else None
                ok = {
                    "==": cur == lit, "!=": cur != lit,
                    ">": cur is not None and cur > lit,
                    "<": cur is not None and cur < lit,
                    ">=": cur is not None and cur >= lit,
                    "<=": cur is not None and cur <= lit,
                }[op]
                if ok:
                    out.append(v)
            return out
        # path expression: .a.b[0].c[] ...
        if not re.fullmatch(r"\.(?:[\w]+|\[\d*\])(?:\.?[\w]+|\[\d*\])*|\.", term):
            raise ValueError(f"jq: unsupported program {term!r}")
        out = inputs
        for step in re.findall(r"\.?([\w]+)|\[(\d*)\]", term):
            key, idx = step
            nxt = []
            for v in out:
                if key:
                    nxt.append(v.get(key) if isinstance(v, dict) else None)
                elif idx == "":
                    if isinstance(v, list):
                        nxt.extend(v)
                elif isinstance(v, list) and int(idx) < len(v):
                    nxt.append(v[int(idx)])
            out = nxt
        return out

    results = [data]
    for part in _str(prog).split("|"):
        results = apply(part, results)
    return results
