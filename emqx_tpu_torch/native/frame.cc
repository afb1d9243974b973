// MQTT wire-frame codec hot loops (_emqx_torch_frame).
//
// The jiffy-class leg for the wire path: the reference broker spends
// real CPU in emqx_frame:serialize/parse for exactly three packet
// shapes — PUBLISH, the PUBACK family and SUBACK — so this module
// implements only that surface, byte-identical to the Python codec in
// emqx_tpu_torch/broker/frame.py, and REFUSES everything else:
//
//   * encode_*: property-free packets only (v5 gets the empty `\x00`
//     property block the Python codec writes for props={}); anything
//     carrying properties stays on the Python serializer;
//   * decode: returns None (incomplete), False (outside the native
//     surface — caller re-parses on the Python state machine), or the
//     field tuple; malformed input raises ValueError and the seam
//     replays the Python parser so callers see the exact FrameError
//     (message, reason code) the contract promises.
//
// emqx_tpu_torch/framec.py is the ONLY caller; it holds the
// counted-fallback ledger and the byte-parity probe that rejects a
// miscompiled build at load (raising, never falling back).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

// packet types (broker/packet.py Type)
constexpr int kPublish = 3;
constexpr int kPuback = 4;
constexpr int kPubrec = 5;
constexpr int kPubrel = 6;
constexpr int kPubcomp = 7;
constexpr int kSuback = 9;

constexpr int64_t kMaxRemainingLen = 268435455;  // 4-byte varint max

static int varint_len(int64_t n) {
  if (n < 0x80) return 1;
  if (n < 0x4000) return 2;
  if (n < 0x200000) return 3;
  return 4;
}

static void put_varint(uint8_t *out, int64_t n, int len) {
  for (int i = 0; i < len; i++) {
    uint8_t b = n & 0x7F;
    n >>= 7;
    out[i] = n ? (b | 0x80) : b;
  }
}

static PyObject *err(const char *msg) {
  PyErr_SetString(PyExc_ValueError, msg);
  return nullptr;
}

// fixed header + body as one exact allocation
static PyObject *fixed(int ptype, int flags, const uint8_t *a, Py_ssize_t na,
                       const uint8_t *b, Py_ssize_t nb) {
  int64_t rl = (int64_t)na + nb;
  if (rl > kMaxRemainingLen) return err("varint out of range");
  int vl = varint_len(rl);
  PyObject *out = PyBytes_FromStringAndSize(nullptr, 1 + vl + rl);
  if (!out) return nullptr;
  uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
  *p++ = (uint8_t)((ptype << 4) | flags);
  put_varint(p, rl, vl);
  p += vl;
  if (na) memcpy(p, a, na);
  if (nb) memcpy(p + na, b, nb);
  return out;
}

// --- encoders ---------------------------------------------------------

// encode_publish(topic, payload, qos, retain, dup, packet_id, v5)
// property-free PUBLISH; packet_id is None for qos 0
static PyObject *encode_publish(PyObject *, PyObject *args) {
  PyObject *topic_o, *payload_o, *pid_o;
  int qos, retain, dup, v5;
  if (!PyArg_ParseTuple(args, "OOiiiOi", &topic_o, &payload_o, &qos, &retain,
                        &dup, &pid_o, &v5))
    return nullptr;
  if (!PyUnicode_Check(topic_o)) return err("topic must be str");
  Py_ssize_t tlen;
  const char *topic = PyUnicode_AsUTF8AndSize(topic_o, &tlen);
  if (!topic) return nullptr;
  if (tlen > 0xFFFF) return err("string too long");
  Py_buffer pay;
  if (PyObject_GetBuffer(payload_o, &pay, PyBUF_SIMPLE) < 0) return nullptr;
  long pid = -1;
  if (qos) {
    if (pid_o == Py_None) {
      PyBuffer_Release(&pay);
      return err("qos>0 PUBLISH without packet id");
    }
    pid = PyLong_AsLong(pid_o);
    if (pid == -1 && PyErr_Occurred()) {
      PyBuffer_Release(&pay);
      return nullptr;
    }
  }
  int flags = (dup ? 0x8 : 0) | ((qos & 0x3) << 1) | (retain ? 1 : 0);
  // head: 2-byte topic length + topic + optional pid + optional empty
  // props — small and bounded, so one stack buffer covers it
  uint8_t head[2 + 0xFFFF + 2 + 1];
  Py_ssize_t n = 0;
  head[n++] = (uint8_t)(tlen >> 8);
  head[n++] = (uint8_t)tlen;
  memcpy(head + n, topic, tlen);
  n += tlen;
  if (qos) {
    head[n++] = (uint8_t)((pid >> 8) & 0xFF);
    head[n++] = (uint8_t)(pid & 0xFF);
  }
  if (v5) head[n++] = 0;  // _props_bytes({}) == b"\x00"
  PyObject *out =
      fixed(kPublish, flags, head, n, (const uint8_t *)pay.buf, pay.len);
  PyBuffer_Release(&pay);
  return out;
}

// encode_puback(ptype, packet_id, code, v5) — PUBACK/PUBREC/PUBREL/
// PUBCOMP with no properties; the v5 reason code is appended only when
// nonzero (the Python codec's `if v5 and (code or props)` shape)
static PyObject *encode_puback(PyObject *, PyObject *args) {
  int ptype, pid, code, v5;
  if (!PyArg_ParseTuple(args, "iiii", &ptype, &pid, &code, &v5))
    return nullptr;
  if (ptype < kPuback || ptype > kPubcomp) return err("bad ack packet type");
  int flags = (ptype == kPubrel) ? 0x2 : 0;
  uint8_t body[3];
  Py_ssize_t n = 0;
  body[n++] = (uint8_t)((pid >> 8) & 0xFF);
  body[n++] = (uint8_t)(pid & 0xFF);
  if (v5 && code) body[n++] = (uint8_t)code;
  return fixed(ptype, flags, body, n, nullptr, 0);
}

// encode_suback(packet_id, codes, v5) — codes already packed to bytes
// by the seam (bytes(pkt.codes) raises on out-of-range like Python)
static PyObject *encode_suback(PyObject *, PyObject *args) {
  int pid, v5;
  PyObject *codes_o;
  if (!PyArg_ParseTuple(args, "iOi", &pid, &codes_o, &v5)) return nullptr;
  Py_buffer codes;
  if (PyObject_GetBuffer(codes_o, &codes, PyBUF_SIMPLE) < 0) return nullptr;
  uint8_t head[3];
  Py_ssize_t n = 0;
  head[n++] = (uint8_t)((pid >> 8) & 0xFF);
  head[n++] = (uint8_t)(pid & 0xFF);
  if (v5) head[n++] = 0;  // empty property block
  PyObject *out =
      fixed(kSuback, 0, head, n, (const uint8_t *)codes.buf, codes.len);
  PyBuffer_Release(&codes);
  return out;
}

// --- decoder ----------------------------------------------------------

struct Rd {
  const uint8_t *p;
  Py_ssize_t pos, end;
  bool trunc;
  bool need(Py_ssize_t n) {
    if (end - pos < n) {
      trunc = true;
      return false;
    }
    return true;
  }
  int u8() {
    if (!need(1)) return -1;
    return p[pos++];
  }
  int u16() {
    if (!need(2)) return -1;
    int v = (p[pos] << 8) | p[pos + 1];
    pos += 2;
    return v;
  }
};

// decode(buf, v5, max_packet_size) -> None | False | tuple
//   PUBLISH: (3, topic, payload, qos, retain, dup, pid|None, consumed)
//   PUBACK..PUBCOMP: (ptype, pid, code, consumed)
//   SUBACK: (9, pid, codes_bytes, consumed)
// None = need more bytes; False = outside the native surface (v5
// non-empty properties, other packet types) — caller falls back to the
// Python parser; ValueError = malformed (caller replays Python for the
// exact FrameError).
static PyObject *decode(PyObject *, PyObject *args) {
  PyObject *buf_o;
  int v5;
  long max_packet;
  if (!PyArg_ParseTuple(args, "Oil", &buf_o, &v5, &max_packet))
    return nullptr;
  Py_buffer view;
  if (PyObject_GetBuffer(buf_o, &view, PyBUF_SIMPLE) < 0) return nullptr;
  const uint8_t *buf = (const uint8_t *)view.buf;
  Py_ssize_t len = view.len;
  PyObject *ret = nullptr;
  bool incomplete = false, unsupported = false;
  do {
    if (len < 2) {
      incomplete = true;
      break;
    }
    // remaining-length varint (same bounds walk as Parser._try_parse_one)
    int64_t rl = 0, mult = 1;
    Py_ssize_t i = 1;
    for (;;) {
      if (i >= len) {
        incomplete = true;
        break;
      }
      uint8_t b = buf[i];
      rl += (int64_t)(b & 0x7F) * mult;
      i += 1;
      if (!(b & 0x80)) break;
      if (i > 4) {
        PyBuffer_Release(&view);
        return err("remaining length varint too long");
      }
      mult <<= 7;
    }
    if (incomplete) break;
    if (i + rl > max_packet) {
      PyBuffer_Release(&view);
      return err("packet too large");
    }
    if (len < i + rl) {
      incomplete = true;
      break;
    }
    int ptype = buf[0] >> 4, flags = buf[0] & 0x0F;
    Rd r{buf + i, 0, (Py_ssize_t)rl, false};
    Py_ssize_t consumed = i + rl;
    if (ptype == kPublish) {
      int qos = (flags >> 1) & 0x3;
      if (qos == 3) {
        PyBuffer_Release(&view);
        return err("invalid QoS 3");
      }
      int tlen = r.u16();
      if (tlen < 0 || !r.need(tlen)) {
        PyBuffer_Release(&view);
        return err("truncated packet");
      }
      const uint8_t *traw = r.p + r.pos;
      r.pos += tlen;
      if (memchr(traw, 0, tlen)) {
        PyBuffer_Release(&view);
        return err("NUL in UTF-8 string");
      }
      long pid = -1;
      if (qos) {
        pid = r.u16();
        if (pid < 0) {
          PyBuffer_Release(&view);
          return err("truncated packet");
        }
      }
      if (v5) {
        // only the empty property block is native; anything else is
        // the Python property codec's job
        int pl = r.u8();
        if (pl < 0) {
          PyBuffer_Release(&view);
          return err("truncated packet");
        }
        if (pl != 0) {
          unsupported = true;
          break;
        }
      }
      PyObject *topic =
          PyUnicode_DecodeUTF8((const char *)traw, tlen, nullptr);
      if (!topic) {
        PyBuffer_Release(&view);
        return nullptr;  // UnicodeDecodeError (a ValueError) -> replay
      }
      PyObject *payload = PyBytes_FromStringAndSize(
          (const char *)(r.p + r.pos), r.end - r.pos);
      if (!payload) {
        Py_DECREF(topic);
        PyBuffer_Release(&view);
        return nullptr;
      }
      PyObject *pid_obj;
      if (qos) {
        pid_obj = PyLong_FromLong(pid);
      } else {
        pid_obj = Py_None;
        Py_INCREF(pid_obj);
      }
      ret = Py_BuildValue("(iNNiiiNn)", kPublish, topic, payload, qos,
                          (flags & 1) ? 1 : 0, (flags & 8) ? 1 : 0, pid_obj,
                          consumed);
    } else if (ptype >= kPuback && ptype <= kPubcomp) {
      if (ptype == kPubrel && flags != 0x2) {
        PyBuffer_Release(&view);
        return err("bad PUBREL flags");
      }
      int pid = r.u16();
      if (pid < 0) {
        PyBuffer_Release(&view);
        return err("truncated packet");
      }
      int code = 0;
      if (v5 && r.pos < r.end) {
        code = r.u8();
        if (r.pos < r.end) {
          int pl = r.u8();
          if (pl != 0) {
            unsupported = true;  // properties -> Python codec
            break;
          }
        }
      }
      if (r.pos < r.end) {
        PyBuffer_Release(&view);
        return err("trailing bytes in packet");
      }
      ret = Py_BuildValue("(iiin)", ptype, pid, code, consumed);
    } else if (ptype == kSuback) {
      int pid = r.u16();
      if (pid < 0) {
        PyBuffer_Release(&view);
        return err("truncated packet");
      }
      if (v5) {
        int pl = r.u8();
        if (pl < 0) {
          PyBuffer_Release(&view);
          return err("truncated packet");
        }
        if (pl != 0) {
          unsupported = true;
          break;
        }
      }
      PyObject *codes = PyBytes_FromStringAndSize(
          (const char *)(r.p + r.pos), r.end - r.pos);
      if (!codes) {
        PyBuffer_Release(&view);
        return nullptr;
      }
      ret = Py_BuildValue("(iiNn)", kSuback, pid, codes, consumed);
    } else {
      unsupported = true;  // CONNECT/SUBSCRIBE/... stay on Python
    }
  } while (false);
  PyBuffer_Release(&view);
  if (incomplete) Py_RETURN_NONE;
  if (unsupported) Py_RETURN_FALSE;
  return ret;
}

static PyMethodDef Methods[] = {
    {"encode_publish", encode_publish, METH_VARARGS,
     "encode_publish(topic, payload, qos, retain, dup, packet_id, v5) "
     "-> wire bytes (property-free PUBLISH)"},
    {"encode_puback", encode_puback, METH_VARARGS,
     "encode_puback(ptype, packet_id, code, v5) -> wire bytes"},
    {"encode_suback", encode_suback, METH_VARARGS,
     "encode_suback(packet_id, codes, v5) -> wire bytes"},
    {"decode", decode, METH_VARARGS,
     "decode(buf, v5, max_packet_size) -> None | False | field tuple"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef Module = {PyModuleDef_HEAD_INIT, "_emqx_torch_frame",
                                    "MQTT wire-frame codec hot loops", -1,
                                    Methods};

}  // namespace

PyMODINIT_FUNC PyInit__emqx_torch_frame(void) { return PyModule_Create(&Module); }
