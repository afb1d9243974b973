// _emqx_torch_json — jiffy-class JSON codec for the broker's payload path.
//
// The reference broker leans on jiffy (a C NIF) for every rule/bridge
// payload decode; this is the same move for the Python port: a CPython
// extension that parses/serializes JSON in one C call, no Python-level
// scanner dispatch, no intermediate token objects.  SIMD-free but
// allocation-disciplined:
//
//   * decode builds PyObjects directly off the input buffer — the
//     common no-escape string is ONE PyUnicode_DecodeUTF8 over the raw
//     span, and object keys (the dominant allocation in telemetry
//     payload mixes, where every message repeats the same field names)
//     come from a 1024-entry direct-mapped key cache, so steady-state
//     decodes of a homogeneous stream allocate values only;
//   * encode writes into one growable byte buffer (doubling, reused
//     stack seed of 4KB covers typical payloads without any malloc),
//     floats go through PyOS_double_to_string('r') — the SAME
//     shortest-repr algorithm stdlib json uses, so output is
//     byte-identical to json.dumps on the supported surface;
//   * semantics mirror stdlib defaults (ensure_ascii=True escaping,
//     NaN/Infinity literals accepted+emitted, last duplicate key wins,
//     str-keyed objects).  Anything outside the supported surface
//     (non-str dict keys, exotic kwargs) raises and the Python seam
//     (emqx_tpu_torch/jsonc.py) replays it on stdlib — slower, never wrong.
//
// Exports (byte parity held by tests/test_torch_rules.py):
//   loads(s)                    s: str | bytes | bytearray
//   dumps(obj, compact, default)  compact: 0/1, default: callable|None

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>

// ---------------------------------------------------------------------------
// decode

struct Parser {
  const char *p;
  const char *end;
  const char *start;
  int depth;
};

static const int MAX_DEPTH = 1000;

// direct-mapped key cache: repeated object keys across a payload
// stream resolve to the SAME PyUnicode object without re-decoding.
struct KeySlot {
  PyObject *obj;   // owned
  uint32_t hash;
  uint8_t len;
  char bytes[64];
};
static KeySlot key_cache[1024];

static inline uint32_t fnv1a(const char *s, Py_ssize_t n) {
  uint32_t h = 0x811C9DC5u;
  for (Py_ssize_t i = 0; i < n; i++) {
    h ^= (uint8_t)s[i];
    h *= 16777619u;
  }
  return h;
}

static void err_at(Parser *ps, const char *msg) {
  PyErr_Format(PyExc_ValueError, "%s: char %zd", msg,
               (Py_ssize_t)(ps->p - ps->start));
}

static inline void skip_ws(Parser *ps) {
  const char *p = ps->p;
  while (p < ps->end &&
         (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
    p++;
  ps->p = p;
}

static PyObject *parse_value(Parser *ps);

// decode a JSON string body starting AFTER the opening quote; leaves
// ps->p after the closing quote.  as_key enables the key cache.
static PyObject *parse_string(Parser *ps, int as_key) {
  const char *start = ps->p;
  const char *p = start;
  const char *end = ps->end;
  // fast scan: most strings have no escapes and no control bytes
  while (p < end && *p != '"' && *p != '\\' && (uint8_t)*p >= 0x20) p++;
  if (p >= end) {
    PyErr_SetString(PyExc_ValueError, "unterminated string");
    return NULL;
  }
  if (*p == '"') {
    Py_ssize_t n = p - start;
    ps->p = p + 1;
    if (as_key && n > 0 && n <= 64) {
      uint32_t h = fnv1a(start, n);
      KeySlot *slot = &key_cache[h & 1023];
      if (slot->obj && slot->hash == h && slot->len == (uint8_t)n &&
          memcmp(slot->bytes, start, (size_t)n) == 0) {
        Py_INCREF(slot->obj);
        return slot->obj;
      }
      PyObject *s = PyUnicode_DecodeUTF8(start, n, NULL);
      if (s == NULL) return NULL;
      Py_XDECREF(slot->obj);
      Py_INCREF(s);
      slot->obj = s;
      slot->hash = h;
      slot->len = (uint8_t)n;
      memcpy(slot->bytes, start, (size_t)n);
      return s;
    }
    return PyUnicode_DecodeUTF8(start, n, NULL);
  }
  if ((uint8_t)*p < 0x20) {
    PyErr_SetString(PyExc_ValueError, "control character in string");
    return NULL;
  }
  // slow path: escapes.  Accumulate UTF-8 bytes (lone \uD800-class
  // escapes encode as WTF-8 and decode with surrogatepass, matching
  // stdlib's tolerance for lone surrogates).
  Py_ssize_t cap = (end - start) + 8;
  char *buf = (char *)PyMem_Malloc((size_t)cap);
  if (buf == NULL) return PyErr_NoMemory();
  Py_ssize_t n = p - start;
  memcpy(buf, start, (size_t)n);
  int saw_surrogate = 0;
  while (p < end && *p != '"') {
    if ((uint8_t)*p >= 0x20 && *p != '\\') {
      buf[n++] = *p++;
      continue;
    }
    if ((uint8_t)*p < 0x20) {
      PyMem_Free(buf);
      PyErr_SetString(PyExc_ValueError, "control character in string");
      return NULL;
    }
    p++;  // consume backslash
    if (p >= end) goto bad_escape;
    char c = *p++;
    switch (c) {
      case '"': buf[n++] = '"'; break;
      case '\\': buf[n++] = '\\'; break;
      case '/': buf[n++] = '/'; break;
      case 'b': buf[n++] = '\b'; break;
      case 'f': buf[n++] = '\f'; break;
      case 'n': buf[n++] = '\n'; break;
      case 'r': buf[n++] = '\r'; break;
      case 't': buf[n++] = '\t'; break;
      case 'u': {
        if (end - p < 4) goto bad_escape;
        uint32_t cp = 0;
        for (int i = 0; i < 4; i++) {
          char h = p[i];
          cp <<= 4;
          if (h >= '0' && h <= '9') cp |= (uint32_t)(h - '0');
          else if (h >= 'a' && h <= 'f') cp |= (uint32_t)(h - 'a' + 10);
          else if (h >= 'A' && h <= 'F') cp |= (uint32_t)(h - 'A' + 10);
          else goto bad_escape;
        }
        p += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 &&
            p[0] == '\\' && p[1] == 'u') {
          uint32_t lo = 0;
          int ok = 1;
          for (int i = 0; i < 4; i++) {
            char h = p[2 + i];
            lo <<= 4;
            if (h >= '0' && h <= '9') lo |= (uint32_t)(h - '0');
            else if (h >= 'a' && h <= 'f') lo |= (uint32_t)(h - 'a' + 10);
            else if (h >= 'A' && h <= 'F') lo |= (uint32_t)(h - 'A' + 10);
            else { ok = 0; break; }
          }
          if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            p += 6;
          }
        }
        // encode cp as (W)UTF-8
        if (cp < 0x80) {
          buf[n++] = (char)cp;
        } else if (cp < 0x800) {
          buf[n++] = (char)(0xC0 | (cp >> 6));
          buf[n++] = (char)(0x80 | (cp & 0x3F));
        } else if (cp < 0x10000) {
          if (cp >= 0xD800 && cp <= 0xDFFF) saw_surrogate = 1;
          buf[n++] = (char)(0xE0 | (cp >> 12));
          buf[n++] = (char)(0x80 | ((cp >> 6) & 0x3F));
          buf[n++] = (char)(0x80 | (cp & 0x3F));
        } else {
          buf[n++] = (char)(0xF0 | (cp >> 18));
          buf[n++] = (char)(0x80 | ((cp >> 12) & 0x3F));
          buf[n++] = (char)(0x80 | ((cp >> 6) & 0x3F));
          buf[n++] = (char)(0x80 | (cp & 0x3F));
        }
        break;
      }
      default: goto bad_escape;
    }
  }
  if (p >= end) {
    PyMem_Free(buf);
    PyErr_SetString(PyExc_ValueError, "unterminated string");
    return NULL;
  }
  ps->p = p + 1;
  {
    PyObject *s = PyUnicode_DecodeUTF8(
        buf, n, saw_surrogate ? "surrogatepass" : NULL);
    PyMem_Free(buf);
    return s;
  }
bad_escape:
  PyMem_Free(buf);
  PyErr_SetString(PyExc_ValueError, "invalid \\escape");
  return NULL;
}

// exact powers of ten: both the mantissa (< 2^53) and 10^|e| (e <= 22)
// are exactly representable, so one multiply/divide below is correctly
// rounded — bit-identical to strtod (Clinger's fast path)
static const double _pow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    1e22};

static PyObject *parse_number(Parser *ps) {
  const char *start = ps->p;
  const char *p = start;
  const char *end = ps->end;
  int is_float = 0, neg = 0, ndig = 0, frac = 0, eexp = 0, eneg = 0;
  unsigned long long mant = 0;
  if (p < end && *p == '-') { neg = 1; p++; }
  // int part: '0' or [1-9][0-9]*
  if (p >= end) goto bad;
  if (*p == '0') {
    p++;
    ndig = 1;
  } else if (*p >= '1' && *p <= '9') {
    while (p < end && *p >= '0' && *p <= '9') {
      if (ndig < 19) mant = mant * 10 + (unsigned)(*p - '0');
      ndig++;
      p++;
    }
  } else {
    goto bad;
  }
  if (p < end && *p == '.') {
    is_float = 1;
    p++;
    if (p >= end || *p < '0' || *p > '9') goto bad;
    while (p < end && *p >= '0' && *p <= '9') {
      if (ndig < 19) mant = mant * 10 + (unsigned)(*p - '0');
      ndig++;
      frac++;
      p++;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    is_float = 1;
    p++;
    if (p < end && (*p == '+' || *p == '-')) eneg = (*p++ == '-');
    if (p >= end || *p < '0' || *p > '9') goto bad;
    while (p < end && *p >= '0' && *p <= '9') {
      if (eexp < 100000) eexp = eexp * 10 + (*p - '0');
      p++;
    }
  }
  ps->p = p;
  if (is_float && ndig <= 15) {
    int e = (eneg ? -eexp : eexp) - frac;
    if (e >= -22 && e <= 22) {
      double d = (double)mant;
      d = e >= 0 ? d * _pow10[e] : d / _pow10[-e];
      return PyFloat_FromDouble(neg ? -d : d);
    }
  }
  if (!is_float) {
    Py_ssize_t n = p - start;
    if (n < 19) {  // fits a long long without overflow checks
      long long v = 0;
      const char *q = start;
      int neg = 0;
      if (*q == '-') { neg = 1; q++; }
      for (; q < p; q++) v = v * 10 + (*q - '0');
      return PyLong_FromLongLong(neg ? -v : v);
    }
    {
      char tmp[64];
      if (n >= (Py_ssize_t)sizeof(tmp)) {
        // arbitrary-precision ints beyond 63 digits: go through str
        PyObject *s = PyUnicode_FromStringAndSize(start, n);
        if (s == NULL) return NULL;
        PyObject *v = PyLong_FromUnicodeObject(s, 10);
        Py_DECREF(s);
        return v;
      }
      memcpy(tmp, start, (size_t)n);
      tmp[n] = 0;
      return PyLong_FromString(tmp, NULL, 10);
    }
  }
  {
    // the span [start,p) was grammar-validated above; parse a bounded
    // NUL-terminated copy (the input buffer need not be NUL-terminated)
    char tmp[512];
    Py_ssize_t n = p - start;
    if (n >= (Py_ssize_t)sizeof(tmp)) goto bad;
    memcpy(tmp, start, (size_t)n);
    tmp[n] = 0;
    double d = PyOS_string_to_double(tmp, NULL, NULL);
    if (d == -1.0 && PyErr_Occurred()) return NULL;
    return PyFloat_FromDouble(d);
  }
bad:
  PyErr_SetString(PyExc_ValueError, "invalid number");
  return NULL;
}

static PyObject *parse_value(Parser *ps) {
  skip_ws(ps);
  if (ps->p >= ps->end) {
    PyErr_SetString(PyExc_ValueError, "unexpected end of input");
    return NULL;
  }
  char c = *ps->p;
  switch (c) {
    case '{': {
      if (++ps->depth > MAX_DEPTH) {
        ps->depth--;
        PyErr_SetString(PyExc_ValueError, "too deeply nested");
        return NULL;
      }
      ps->p++;
      // presized for the telemetry-object shape: skips the lazy
      // first-insert table allocation PyDict_New would do
      PyObject *d = _PyDict_NewPresized(4);
      if (d == NULL) { ps->depth--; return NULL; }
      skip_ws(ps);
      if (ps->p < ps->end && *ps->p == '}') {
        ps->p++;
        ps->depth--;
        return d;
      }
      for (;;) {
        skip_ws(ps);
        if (ps->p >= ps->end || *ps->p != '"') {
          PyErr_SetString(PyExc_ValueError,
                          "expected string object key");
          goto obj_fail;
        }
        ps->p++;
        PyObject *k = parse_string(ps, 1);
        if (k == NULL) goto obj_fail;
        skip_ws(ps);
        if (ps->p >= ps->end || *ps->p != ':') {
          Py_DECREF(k);
          PyErr_SetString(PyExc_ValueError, "expected ':'");
          goto obj_fail;
        }
        ps->p++;
        PyObject *v = parse_value(ps);
        if (v == NULL) { Py_DECREF(k); goto obj_fail; }
        int rc = PyDict_SetItem(d, k, v);
        Py_DECREF(k);
        Py_DECREF(v);
        if (rc < 0) goto obj_fail;
        skip_ws(ps);
        if (ps->p >= ps->end) {
          PyErr_SetString(PyExc_ValueError, "unterminated object");
          goto obj_fail;
        }
        if (*ps->p == ',') { ps->p++; continue; }
        if (*ps->p == '}') { ps->p++; break; }
        PyErr_SetString(PyExc_ValueError, "expected ',' or '}'");
        goto obj_fail;
      }
      ps->depth--;
      return d;
    obj_fail:
      ps->depth--;
      Py_DECREF(d);
      return NULL;
    }
    case '[': {
      if (++ps->depth > MAX_DEPTH) {
        ps->depth--;
        PyErr_SetString(PyExc_ValueError, "too deeply nested");
        return NULL;
      }
      ps->p++;
      PyObject *lst = PyList_New(0);
      if (lst == NULL) { ps->depth--; return NULL; }
      skip_ws(ps);
      if (ps->p < ps->end && *ps->p == ']') {
        ps->p++;
        ps->depth--;
        return lst;
      }
      for (;;) {
        PyObject *v = parse_value(ps);
        if (v == NULL) goto arr_fail;
        int rc = PyList_Append(lst, v);
        Py_DECREF(v);
        if (rc < 0) goto arr_fail;
        skip_ws(ps);
        if (ps->p >= ps->end) {
          PyErr_SetString(PyExc_ValueError, "unterminated array");
          goto arr_fail;
        }
        if (*ps->p == ',') { ps->p++; continue; }
        if (*ps->p == ']') { ps->p++; break; }
        PyErr_SetString(PyExc_ValueError, "expected ',' or ']'");
        goto arr_fail;
      }
      ps->depth--;
      return lst;
    arr_fail:
      ps->depth--;
      Py_DECREF(lst);
      return NULL;
    }
    case '"':
      ps->p++;
      return parse_string(ps, 0);
    case 't':
      if (ps->end - ps->p >= 4 && memcmp(ps->p, "true", 4) == 0) {
        ps->p += 4;
        Py_RETURN_TRUE;
      }
      break;
    case 'f':
      if (ps->end - ps->p >= 5 && memcmp(ps->p, "false", 5) == 0) {
        ps->p += 5;
        Py_RETURN_FALSE;
      }
      break;
    case 'n':
      if (ps->end - ps->p >= 4 && memcmp(ps->p, "null", 4) == 0) {
        ps->p += 4;
        Py_RETURN_NONE;
      }
      break;
    case 'N':
      if (ps->end - ps->p >= 3 && memcmp(ps->p, "NaN", 3) == 0) {
        ps->p += 3;
        return PyFloat_FromDouble(Py_NAN);
      }
      break;
    case 'I':
      if (ps->end - ps->p >= 8 && memcmp(ps->p, "Infinity", 8) == 0) {
        ps->p += 8;
        return PyFloat_FromDouble(Py_HUGE_VAL);
      }
      break;
    case '-':
      if (ps->end - ps->p >= 9 && memcmp(ps->p, "-Infinity", 9) == 0) {
        ps->p += 9;
        return PyFloat_FromDouble(-Py_HUGE_VAL);
      }
      return parse_number(ps);
    default:
      if (c >= '0' && c <= '9') return parse_number(ps);
      break;
  }
  err_at(ps, "invalid JSON value");
  return NULL;
}

static PyObject *json_loads(PyObject *Py_UNUSED(self), PyObject *arg) {
  const char *buf;
  Py_ssize_t len;
  Py_buffer view = {0};
  if (PyUnicode_Check(arg)) {
    buf = PyUnicode_AsUTF8AndSize(arg, &len);
    if (buf == NULL) return NULL;
  } else if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) == 0) {
    buf = (const char *)view.buf;
    len = view.len;
  } else {
    return NULL;  // TypeError from GetBuffer
  }
  Parser ps = {buf, buf + len, buf, 0};
  PyObject *v = parse_value(&ps);
  if (v != NULL) {
    skip_ws(&ps);
    if (ps.p != ps.end) {
      Py_DECREF(v);
      v = NULL;
      PyErr_SetString(PyExc_ValueError, "trailing data after JSON value");
    }
  }
  if (view.obj) PyBuffer_Release(&view);
  return v;
}

// ---------------------------------------------------------------------------
// encode

struct Writer {
  char *buf;
  Py_ssize_t len;
  Py_ssize_t cap;
  char seed[4096];
  int heap;
};

static int w_grow(Writer *w, Py_ssize_t need) {
  Py_ssize_t cap = w->cap;
  while (cap < w->len + need) cap *= 2;
  char *nb;
  if (w->heap) {
    nb = (char *)PyMem_Realloc(w->buf, (size_t)cap);
    if (nb == NULL) { PyErr_NoMemory(); return -1; }
  } else {
    nb = (char *)PyMem_Malloc((size_t)cap);
    if (nb == NULL) { PyErr_NoMemory(); return -1; }
    memcpy(nb, w->buf, (size_t)w->len);
    w->heap = 1;
  }
  w->buf = nb;
  w->cap = cap;
  return 0;
}

static inline int w_reserve(Writer *w, Py_ssize_t need) {
  if (w->len + need > w->cap) return w_grow(w, need);
  return 0;
}

static inline int w_putc(Writer *w, char c) {
  if (w_reserve(w, 1) < 0) return -1;
  w->buf[w->len++] = c;
  return 0;
}

static inline int w_puts(Writer *w, const char *s, Py_ssize_t n) {
  if (w_reserve(w, n) < 0) return -1;
  memcpy(w->buf + w->len, s, (size_t)n);
  w->len += n;
  return 0;
}

static const char HEX[] = "0123456789abcdef";

// minimal itoa: snprintf("%lld") costs more than the rest of a small
// object's encode combined
static inline int w_put_ll(Writer *w, long long x) {
  char tmp[24];
  char *e = tmp + sizeof(tmp), *q = e;
  unsigned long long u =
      x < 0 ? (unsigned long long)(-(x + 1)) + 1 : (unsigned long long)x;
  do { *--q = (char)('0' + (u % 10)); u /= 10; } while (u);
  if (x < 0) *--q = '-';
  return w_puts(w, q, e - q);
}

// Shortest-repr fast path for the telemetry float mix (sensor values
// rounded to <= 2 decimals).  For |d| in [1e-4, 1e13) repr() formats
// positionally, and ulp(d) < 10^-k across that whole range, so at
// most ONE k-decimal string round-trips: if nearest-grid r/10^k == d
// exactly, that string IS the unique shortest repr for the minimal
// such k.  Everything else (more digits, ties at 0, sci-notation
// magnitudes) falls through to PyOS_double_to_string.
static int w_put_double_fast(Writer *w, double d) {
  double ad = d < 0 ? -d : d;
  if (!(ad >= 1e-4 && ad < 1e13)) return 0;  // 0.0/-0.0 excluded too
  static const double scale[3] = {1.0, 10.0, 100.0};
  for (int k = 0; k < 3; k++) {
    double sd = d * scale[k];
    long long r = (long long)(sd < 0 ? sd - 0.5 : sd + 0.5);
    if ((double)r / scale[k] != d) continue;
    char tmp[24];
    char *e = tmp + sizeof(tmp), *q = e;
    unsigned long long u =
        r < 0 ? (unsigned long long)(-(r + 1)) + 1 : (unsigned long long)r;
    int nd = 0;
    do { *--q = (char)('0' + (u % 10)); u /= 10; nd++; } while (u);
    while (nd <= k) { *--q = '0'; nd++; }  // 0.07 -> digits "07"
    Py_ssize_t n = e - q;
    Py_ssize_t ip = n - k;  // integer-part digit count
    Py_ssize_t need = n + 2 + (k == 0 ? 2 : 1);
    if (w_reserve(w, need) < 0) return -1;
    char *o = w->buf + w->len;
    if (r < 0) *o++ = '-';
    memcpy(o, q, (size_t)ip); o += ip;
    *o++ = '.';
    if (k == 0) *o++ = '0';
    else { memcpy(o, q + ip, (size_t)k); o += k; }
    w->len = o - w->buf;
    return 1;
  }
  return 0;
}

static int write_string(Writer *w, PyObject *s) {
  if (PyUnicode_READY(s) < 0) return -1;
  Py_ssize_t n = PyUnicode_GET_LENGTH(s);
  int kind = PyUnicode_KIND(s);
  const void *data = PyUnicode_DATA(s);
  // worst case every char becomes \uXXXX (6 bytes) + quotes
  if (w_reserve(w, 6 * n + 2) < 0) return -1;
  char *o = w->buf + w->len;
  *o++ = '"';
  if (kind == PyUnicode_1BYTE_KIND) {
    const uint8_t *in = (const uint8_t *)data;
    for (Py_ssize_t i = 0; i < n; i++) {
      uint8_t c = in[i];
      if (c >= 0x20 && c < 0x7F && c != '"' && c != '\\') {
        *o++ = (char)c;
      } else if (c == '"' || c == '\\') {
        *o++ = '\\';
        *o++ = (char)c;
      } else if (c == '\n') { *o++ = '\\'; *o++ = 'n'; }
      else if (c == '\t') { *o++ = '\\'; *o++ = 't'; }
      else if (c == '\r') { *o++ = '\\'; *o++ = 'r'; }
      else if (c == '\b') { *o++ = '\\'; *o++ = 'b'; }
      else if (c == '\f') { *o++ = '\\'; *o++ = 'f'; }
      else {  // control or latin-1 >= 0x7F: ensure_ascii escape
        *o++ = '\\'; *o++ = 'u'; *o++ = '0'; *o++ = '0';
        *o++ = HEX[c >> 4]; *o++ = HEX[c & 15];
      }
    }
  } else {
    for (Py_ssize_t i = 0; i < n; i++) {
      Py_UCS4 c = PyUnicode_READ(kind, data, i);
      if (c >= 0x20 && c < 0x7F && c != '"' && c != '\\') {
        *o++ = (char)c;
      } else if (c == '"' || c == '\\') {
        *o++ = '\\';
        *o++ = (char)c;
      } else if (c == '\n') { *o++ = '\\'; *o++ = 'n'; }
      else if (c == '\t') { *o++ = '\\'; *o++ = 't'; }
      else if (c == '\r') { *o++ = '\\'; *o++ = 'r'; }
      else if (c == '\b') { *o++ = '\\'; *o++ = 'b'; }
      else if (c == '\f') { *o++ = '\\'; *o++ = 'f'; }
      else if (c < 0x10000) {
        *o++ = '\\'; *o++ = 'u';
        *o++ = HEX[(c >> 12) & 15]; *o++ = HEX[(c >> 8) & 15];
        *o++ = HEX[(c >> 4) & 15]; *o++ = HEX[c & 15];
      } else {  // non-BMP: surrogate pair, like stdlib ensure_ascii
        Py_UCS4 v = c - 0x10000;
        Py_UCS4 hi = 0xD800 + (v >> 10), lo = 0xDC00 + (v & 0x3FF);
        *o++ = '\\'; *o++ = 'u';
        *o++ = HEX[(hi >> 12) & 15]; *o++ = HEX[(hi >> 8) & 15];
        *o++ = HEX[(hi >> 4) & 15]; *o++ = HEX[hi & 15];
        *o++ = '\\'; *o++ = 'u';
        *o++ = HEX[(lo >> 12) & 15]; *o++ = HEX[(lo >> 8) & 15];
        *o++ = HEX[(lo >> 4) & 15]; *o++ = HEX[lo & 15];
      }
    }
  }
  *o++ = '"';
  w->len = o - w->buf;
  return 0;
}

static int write_value(Writer *w, PyObject *v, int compact,
                       PyObject *dflt, int depth) {
  if (depth > MAX_DEPTH) {
    PyErr_SetString(PyExc_ValueError,
                    "too deeply nested (or circular reference)");
    return -1;
  }
  if (v == Py_None) return w_puts(w, "null", 4);
  if (v == Py_True) return w_puts(w, "true", 4);
  if (v == Py_False) return w_puts(w, "false", 5);
  if (PyUnicode_Check(v)) return write_string(w, v);
  if (PyLong_Check(v)) {
    int overflow = 0;
    long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (!overflow && !(x == -1 && PyErr_Occurred()))
      return w_put_ll(w, x);
    PyErr_Clear();
    PyObject *s = PyObject_Str(v);
    if (s == NULL) return -1;
    Py_ssize_t n;
    const char *buf = PyUnicode_AsUTF8AndSize(s, &n);
    int rc = buf ? w_puts(w, buf, n) : -1;
    Py_DECREF(s);
    return rc;
  }
  if (PyFloat_Check(v)) {
    double d = PyFloat_AS_DOUBLE(v);
    if (std::isnan(d)) return w_puts(w, "NaN", 3);
    if (std::isinf(d))
      return d > 0 ? w_puts(w, "Infinity", 8)
                   : w_puts(w, "-Infinity", 9);
    int fr = w_put_double_fast(w, d);
    if (fr) return fr < 0 ? -1 : 0;
    char *r = PyOS_double_to_string(d, 'r', 0, Py_DTSF_ADD_DOT_0, NULL);
    if (r == NULL) return -1;
    int rc = w_puts(w, r, (Py_ssize_t)strlen(r));
    PyMem_Free(r);
    return rc;
  }
  if (PyDict_Check(v)) {
    if (w_putc(w, '{') < 0) return -1;
    PyObject *k, *val;
    Py_ssize_t pos = 0;
    int first = 1;
    while (PyDict_Next(v, &pos, &k, &val)) {
      if (!PyUnicode_Check(k)) {
        // non-str keys (int/float coercion etc.): the seam's stdlib
        // fallback reproduces stdlib behavior exactly
        PyErr_SetString(PyExc_TypeError, "non-str dict key");
        return -1;
      }
      if (!first && w_putc(w, ',') < 0) return -1;
      if (!first && !compact && w_putc(w, ' ') < 0) return -1;
      first = 0;
      if (write_string(w, k) < 0) return -1;
      if (w_putc(w, ':') < 0) return -1;
      if (!compact && w_putc(w, ' ') < 0) return -1;
      if (write_value(w, val, compact, dflt, depth + 1) < 0) return -1;
    }
    return w_putc(w, '}');
  }
  if (PyList_Check(v) || PyTuple_Check(v)) {
    if (w_putc(w, '[') < 0) return -1;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(v);
    PyObject **items = PySequence_Fast_ITEMS(v);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (i) {
        if (w_putc(w, ',') < 0) return -1;
        if (!compact && w_putc(w, ' ') < 0) return -1;
      }
      if (write_value(w, items[i], compact, dflt, depth + 1) < 0)
        return -1;
    }
    return w_putc(w, ']');
  }
  if (dflt != Py_None && dflt != NULL) {
    PyObject *sub = PyObject_CallFunctionObjArgs(dflt, v, NULL);
    if (sub == NULL) return -1;
    int rc = write_value(w, sub, compact, dflt, depth + 1);
    Py_DECREF(sub);
    return rc;
  }
  PyErr_Format(PyExc_TypeError,
               "Object of type %.100s is not JSON serializable",
               Py_TYPE(v)->tp_name);
  return -1;
}

static PyObject *json_dumps(PyObject *Py_UNUSED(self), PyObject *args) {
  PyObject *obj, *dflt;
  int compact;
  if (!PyArg_ParseTuple(args, "OiO", &obj, &compact, &dflt)) return NULL;
  Writer w;
  w.buf = w.seed;
  w.len = 0;
  w.cap = (Py_ssize_t)sizeof(w.seed);
  w.heap = 0;
  PyObject *out = NULL;
  if (write_value(&w, obj, compact, dflt, 0) == 0) {
    // ensure_ascii escaping makes the buffer pure ASCII: build the
    // compact str directly instead of running the UTF-8 decoder
    out = PyUnicode_New(w.len, 127);
    if (out != NULL)
      memcpy(PyUnicode_1BYTE_DATA(out), w.buf, (size_t)w.len);
  }
  if (w.heap) PyMem_Free(w.buf);
  return out;
}

// ---------------------------------------------------------------------------

static PyMethodDef JsonMethods[] = {
    {"loads", json_loads, METH_O,
     "Parse a JSON document (str/bytes/bytearray)."},
    {"dumps", json_dumps, METH_VARARGS,
     "Serialize obj to a JSON str: dumps(obj, compact, default)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef jsonmodule = {
    PyModuleDef_HEAD_INIT, "_emqx_torch_json",
    "jiffy-class JSON codec (native leg of emqx_tpu_torch/jsonc.py)", -1,
    JsonMethods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__emqx_torch_json(void) {
  return PyModule_Create(&jsonmodule);
}
