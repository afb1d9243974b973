// _emqx_torch_speedups — CPython C extension for the route-churn hot loops.
//
// The reference broker sustains ~500k route inserts/s on the BEAM
// (apps/emqx/src/emqx_broker_bench.erl:64-66 InsertRps); matching that
// through a Python router means the per-route string work (split,
// vocab intern, wildcard classification) and the per-route dict
// bookkeeping cannot run as CPython bytecode.  This module implements
// exactly those loops against the CPython C API, operating on the
// SAME dict/list/set objects the pure-python fallbacks use — there is
// no duplicated state, so either implementation can take any batch.
//
// Functions:
//   wild_flags(pairs)        -> list[bool]   (filter wildness per pair)
//   encode_filters(...)      -> encoded arrays + word tuples (interning)
//   index_dedup(...)         -> class-index dedup/bucket bookkeeping
//
// Build: g++ at first use (emqx_tpu_torch/native/__init__.py), loaded
// via importlib ExtensionFileLoader from emqx_tpu_torch/ops/speedups.py;
// a failed build raises, and only the set_native_enabled setters select
// the pure-python twins.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// wild_flags(pairs: list[(filter, dest)]) -> list[bool]
//
// A filter is wild iff some '/'-delimited word is exactly "+" or "#"
// (emqx_topic.erl:65-77).  One UTF-8 scan per filter, no split.

static bool word_wild_scan(const char *s, Py_ssize_t n) {
  Py_ssize_t i = 0;
  while (i <= n) {
    // word = s[i..j) up to next '/' or end
    Py_ssize_t j = i;
    while (j < n && s[j] != '/') j++;
    if (j - i == 1 && (s[i] == '+' || s[i] == '#')) return true;
    if (j >= n) break;
    i = j + 1;
    if (i == n) {  // trailing '/': final empty word, not wild
      break;
    }
  }
  return false;
}

static PyObject *wild_flags(PyObject *, PyObject *args) {
  PyObject *pairs;
  if (!PyArg_ParseTuple(args, "O", &pairs)) return nullptr;
  PyObject *seq = PySequence_Fast(pairs, "pairs must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return nullptr;
  }
  for (Py_ssize_t k = 0; k < n; k++) {
    PyObject *pair = PySequence_Fast_GET_ITEM(seq, k);
    PyObject *flt;
    if (PyTuple_Check(pair) && PyTuple_GET_SIZE(pair) >= 1) {
      flt = PyTuple_GET_ITEM(pair, 0);
    } else {
      flt = PySequence_GetItem(pair, 0);
      if (!flt) {
        Py_DECREF(seq);
        Py_DECREF(out);
        return nullptr;
      }
      Py_DECREF(flt);  // borrowed-enough: pair keeps it alive
    }
    Py_ssize_t len;
    const char *s = PyUnicode_AsUTF8AndSize(flt, &len);
    if (!s) {
      Py_DECREF(seq);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject *b = word_wild_scan(s, len) ? Py_True : Py_False;
    Py_INCREF(b);
    PyList_SET_ITEM(out, k, b);
  }
  Py_DECREF(seq);
  return out;
}

// ---------------------------------------------------------------------
// encode_filters(filters, vocab, L)
//   -> (ws_list, ids_bytes, plen_bytes, hh_bytes, rw_bytes)
//
// Mirrors FilterTable.add_bulk's string pass + Vocab interning
// bit-for-bit: trailing '#' strips to has_hash, '+' encodes as PLUS=1
// without interning, every other word get-or-creates an id in
// ids_dict/words_dict (recycling from free_list first) and bumps its
// refcount in refs_dict.  Too-deep rows (prefix > L) emit plen=-1 and
// touch nothing.  ids_bytes is int32[B,L] row-major (0-padded is NOT
// done here — caller pads with OOV via numpy where plen>=0).

static const int32_t kPlus = 1;  // vocab.PLUS

struct Buf {
  Py_buffer b{};
  bool ok = false;
  bool get(PyObject *o, int flags = PyBUF_CONTIG) {
    ok = o && PyObject_GetBuffer(o, &b, flags) == 0;
    return ok;
  }
  ~Buf() {
    if (ok) PyBuffer_Release(&b);
  }
};

struct Ref {
  PyObject *p = nullptr;
  ~Ref() { Py_XDECREF(p); }
};


static PyObject *encode_filters(PyObject *, PyObject *args) {
  PyObject *filters, *vocab;
  int L;
  if (!PyArg_ParseTuple(args, "OOi", &filters, &vocab, &L)) return nullptr;
  // fetch vocab state through the object so next_id can be written
  // back on EVERY exit — a partial batch must never leave created
  // words ahead of a stale _next (id aliasing)
  Ref r_ids, r_words, r_vfree, r_refs;
  r_ids.p = PyObject_GetAttrString(vocab, "_ids");
  r_words.p = PyObject_GetAttrString(vocab, "_words");
  r_vfree.p = PyObject_GetAttrString(vocab, "_free");
  r_refs.p = PyObject_GetAttrString(vocab, "_refs");
  if (!r_ids.p || !r_words.p || !r_vfree.p || !r_refs.p) return nullptr;
  PyObject *ids_dict = r_ids.p, *words_dict = r_words.p,
           *free_list = r_vfree.p;
  int64_t next_id;
  {
    PyObject *nobj = PyObject_GetAttrString(vocab, "_next");
    if (!nobj) return nullptr;
    next_id = PyLong_AsLongLong(nobj);
    Py_DECREF(nobj);
  }
  Py_buffer refs_buf;
  if (PyObject_GetBuffer(r_refs.p, &refs_buf, PyBUF_CONTIG) < 0)
    return nullptr;
  int64_t *refs = (int64_t *)refs_buf.buf;
  Py_ssize_t refs_cap = refs_buf.len / (Py_ssize_t)sizeof(int64_t);
  PyObject *seq = PySequence_Fast(filters, "filters must be a sequence");
  if (!seq) {
    PyBuffer_Release(&refs_buf);
    return nullptr;
  }
  Py_ssize_t B = PySequence_Fast_GET_SIZE(seq);

  PyObject *ws_list = PyList_New(B);
  PyObject *ids_b = PyBytes_FromStringAndSize(nullptr, B * (Py_ssize_t)L * 4);
  PyObject *plen_b = PyBytes_FromStringAndSize(nullptr, B * 4);
  PyObject *hh_b = PyBytes_FromStringAndSize(nullptr, B);
  PyObject *rw_b = PyBytes_FromStringAndSize(nullptr, B);
  if (!ws_list || !ids_b || !plen_b || !hh_b || !rw_b) goto fail;
  {
    int32_t *ids_p = (int32_t *)PyBytes_AS_STRING(ids_b);
    int32_t *plen_p = (int32_t *)PyBytes_AS_STRING(plen_b);
    uint8_t *hh_p = (uint8_t *)PyBytes_AS_STRING(hh_b);
    uint8_t *rw_p = (uint8_t *)PyBytes_AS_STRING(rw_b);
    memset(ids_p, 0, B * (size_t)L * 4);
    // immortal split separator (created once per process)
    static PyObject *g_sep = nullptr;
    if (!g_sep) {
      g_sep = PyUnicode_InternFromString("/");
      if (!g_sep) goto fail;
    }

    for (Py_ssize_t k = 0; k < B; k++) {
      PyObject *flt = PySequence_Fast_GET_ITEM(seq, k);
      if (!PyUnicode_Check(flt)) {
        PyErr_SetString(PyExc_TypeError, "filter must be str");
        goto fail;
      }
      PyObject *ws = PyUnicode_Split(flt, g_sep, -1);
      if (!ws) goto fail;
      Py_ssize_t nw = PyList_GET_SIZE(ws);
      PyObject *last = PyList_GET_ITEM(ws, nw - 1);
      int hh = (PyUnicode_GetLength(last) == 1 &&
                PyUnicode_ReadChar(last, 0) == '#');
      Py_ssize_t plen = hh ? nw - 1 : nw;
      PyObject *ws_tuple = PyList_AsTuple(ws);
      Py_DECREF(ws);
      if (!ws_tuple) goto fail;
      PyList_SET_ITEM(ws_list, k, ws_tuple);  // steals
      if (plen > L) {
        plen_p[k] = -1;
        hh_p[k] = (uint8_t)hh;
        rw_p[k] = 0;
        continue;
      }
      int rw = (hh && plen == 0);
      int32_t *row = ids_p + (size_t)k * L;
      for (Py_ssize_t i = 0; i < plen; i++) {
        PyObject *w = PyTuple_GET_ITEM(ws_tuple, i);
        if (PyUnicode_GetLength(w) == 1 && PyUnicode_ReadChar(w, 0) == '+') {
          row[i] = kPlus;
          if (i == 0) rw = 1;
          continue;
        }
        PyObject *wid = PyDict_GetItemWithError(ids_dict, w);  // borrowed
        int64_t id;
        if (wid) {
          id = PyLong_AsLongLong(wid);
        } else {
          if (PyErr_Occurred()) goto fail;
          // new word: recycle from free_list, else next_id++
          PyObject *idobj;
          Py_ssize_t nf = PyList_GET_SIZE(free_list);
          if (nf > 0) {
            idobj = PyList_GET_ITEM(free_list, nf - 1);
            Py_INCREF(idobj);
            if (PyList_SetSlice(free_list, nf - 1, nf, nullptr) < 0) {
              Py_DECREF(idobj);
              goto fail;
            }
            id = PyLong_AsLongLong(idobj);
          } else {
            id = next_id++;
            idobj = PyLong_FromLongLong(id);
            if (!idobj) goto fail;
          }
          if (PyDict_SetItem(ids_dict, w, idobj) < 0 ||
              PyDict_SetItem(words_dict, idobj, w) < 0) {
            Py_DECREF(idobj);
            goto fail;
          }
          Py_DECREF(idobj);
        }
        row[i] = (int32_t)id;
        // refcount bump on the flat id-indexed array (caller pre-grew)
        if (id < 0 || id >= refs_cap) {
          PyErr_SetString(PyExc_ValueError, "refs array too small");
          goto fail;
        }
        refs[id]++;
      }
      plen_p[k] = (int32_t)plen;
      hh_p[k] = (uint8_t)hh;
      rw_p[k] = (uint8_t)rw;
    }
  }
  {
    PyObject *nv = PyLong_FromLongLong(next_id);
    if (nv) {
      PyObject_SetAttrString(vocab, "_next", nv);
      Py_DECREF(nv);
    }
    PyObject *out = Py_BuildValue("(NNNNN)", ws_list, ids_b, plen_b, hh_b,
                                  rw_b);
    PyBuffer_Release(&refs_buf);
    Py_DECREF(seq);
    return out;
  }
fail : {
  // keep _next consistent even on a partial batch (see fetch comment)
  PyObject *etype, *eval, *etb;
  PyErr_Fetch(&etype, &eval, &etb);
  PyObject *nv = PyLong_FromLongLong(next_id);
  if (nv) {
    PyObject_SetAttrString(vocab, "_next", nv);
    Py_DECREF(nv);
  }
  PyErr_Restore(etype, eval, etb);
}
  PyBuffer_Release(&refs_buf);
  Py_DECREF(seq);
  Py_XDECREF(ws_list);
  Py_XDECREF(ids_b);
  Py_XDECREF(plen_b);
  Py_XDECREF(hh_b);
  Py_XDECREF(rw_b);
  return nullptr;
}

// ---------------------------------------------------------------------
// index_dedup(flts, cids_buf, rows, bucket_of, bucket_rows, row_bucket,
//             bucket_free, residual_set, nb0)
//   -> (new_idx: list[int], new_bids: list[int], nb, any_residual)
//
// The per-row dict/set bookkeeping of ClassIndex.add_rows: residual
// routing for cid<0 rows, dedup against bucket_of (string keys),
// bucket allocation from the free list (appending None placeholders
// to bucket_rows for fresh ids — caller extends its parallel arrays
// from nb0 to nb afterwards).

static PyObject *index_dedup(PyObject *, PyObject *args) {
  PyObject *flts, *cids_obj, *rows, *bucket_of, *bucket_rows, *row_bucket,
      *bucket_free, *residual;
  long nb0_l;
  if (!PyArg_ParseTuple(args, "OOOO!O!OO!O!l", &flts, &cids_obj, &rows,
                        &PyDict_Type, &bucket_of, &PyList_Type, &bucket_rows,
                        &row_bucket, &PyList_Type, &bucket_free,
                        &PySet_Type, &residual, &nb0_l))
    return nullptr;
  Py_buffer cb;
  if (PyObject_GetBuffer(cids_obj, &cb, PyBUF_CONTIG_RO) < 0) return nullptr;
  const int64_t *cids = (const int64_t *)cb.buf;
  Py_buffer rbb;
  if (PyObject_GetBuffer(row_bucket, &rbb, PyBUF_CONTIG) < 0) {
    PyBuffer_Release(&cb);
    return nullptr;
  }
  int64_t *rowbkt = (int64_t *)rbb.buf;
  PyObject *fseq = PySequence_Fast(flts, "flts must be a sequence");
  PyObject *rseq = PySequence_Fast(rows, "rows must be a sequence");
  PyObject *new_idx = PyList_New(0);
  PyObject *new_bids = PyList_New(0);
  long nb = nb0_l;
  int any_residual = 0;
  if (!fseq || !rseq || !new_idx || !new_bids) goto fail;
  {
    Py_ssize_t B = PySequence_Fast_GET_SIZE(fseq);
    if ((Py_ssize_t)(cb.len / (Py_ssize_t)sizeof(int64_t)) < B ||
        PySequence_Fast_GET_SIZE(rseq) < B) {
      PyErr_SetString(PyExc_ValueError, "length mismatch");
      goto fail;
    }
    for (Py_ssize_t i = 0; i < B; i++) {
      PyObject *row = PySequence_Fast_GET_ITEM(rseq, i);  // borrowed int
      if (cids[i] < 0) {
        if (PySet_Add(residual, row) < 0) goto fail;
        any_residual = 1;
        continue;
      }
      PyObject *f = PySequence_Fast_GET_ITEM(fseq, i);
      PyObject *bid = PyDict_GetItemWithError(bucket_of, f);  // borrowed
      if (bid) {
        // duplicate filter: join the existing bucket's row set
        long b = PyLong_AsLong(bid);
        PyObject *rs = PyList_GET_ITEM(bucket_rows, b);
        if (PySet_Check(rs)) {
          if (PySet_Add(rs, row) < 0) goto fail;
        } else if (PyObject_RichCompareBool(rs, row, Py_NE) == 1) {
          PyObject *ns = PySet_New(nullptr);
          if (!ns || PySet_Add(ns, rs) < 0 || PySet_Add(ns, row) < 0) {
            Py_XDECREF(ns);
            goto fail;
          }
          PyList_SetItem(bucket_rows, b, ns);
        }
        rowbkt[PyLong_AsLong(row)] = b;
        continue;
      }
      if (PyErr_Occurred()) goto fail;
      long b;
      PyObject *bobj;
      Py_ssize_t nf = PyList_GET_SIZE(bucket_free);
      if (nf > 0) {
        bobj = PyList_GET_ITEM(bucket_free, nf - 1);
        Py_INCREF(bobj);
        if (PyList_SetSlice(bucket_free, nf - 1, nf, nullptr) < 0) {
          Py_DECREF(bobj);
          goto fail;
        }
        b = PyLong_AsLong(bobj);
        Py_INCREF(row);
        PyList_SetItem(bucket_rows, b, row);
      } else {
        b = nb++;
        bobj = PyLong_FromLong(b);
        if (!bobj || PyList_Append(bucket_rows, row) < 0) {
          Py_XDECREF(bobj);
          goto fail;
        }
      }
      if (PyDict_SetItem(bucket_of, f, bobj) < 0) {
        Py_DECREF(bobj);
        goto fail;
      }
      Py_DECREF(bobj);
      rowbkt[PyLong_AsLong(row)] = b;
      PyObject *iobj = PyLong_FromSsize_t(i);
      if (!iobj || PyList_Append(new_idx, iobj) < 0) {
        Py_XDECREF(iobj);
        goto fail;
      }
      Py_DECREF(iobj);
      PyObject *b2 = PyLong_FromLong(b);
      if (!b2 || PyList_Append(new_bids, b2) < 0) {
        Py_XDECREF(b2);
        goto fail;
      }
      Py_DECREF(b2);
    }
  }
  PyBuffer_Release(&cb);
  PyBuffer_Release(&rbb);
  Py_DECREF(fseq);
  Py_DECREF(rseq);
  return Py_BuildValue("(NNlO)", new_idx, new_bids, nb,
                       any_residual ? Py_True : Py_False);
fail:
  PyBuffer_Release(&cb);
  PyBuffer_Release(&rbb);
  Py_XDECREF(fseq);
  Py_XDECREF(rseq);
  Py_XDECREF(new_idx);
  Py_XDECREF(new_bids);
  return nullptr;
}

// ---------------------------------------------------------------------
// The route-churn core: one C pass over a (filter, dest) pair batch
// against the router's own dicts/lists/sets/arrays, in BOTH
// directions:
//
//   make_churn_handle(router)              -> capsule
//   add_routes_core(handle|router, pairs)  -> (fresh, need_rebuild)
//   del_routes_core(handle|router, pairs)  -> (vanished, removed_rows)
//
// A ChurnHandle caches the entire attribute fetch — every
// dict/list/set object (strong refs; those containers are mutated in
// place and never rebound) plus raw buffer views of every numpy
// array — so the per-call setup of a ONE-pair batch is ~zero and the
// single-row add/delete paths ride the same core as 1000-row storms.
// The buffers pin the CURRENT arrays: the Router drops the handle
// whenever an array can be REPLACED (the _reserve_native growth
// pre-pass, an index rebuild, any python-fallback mutation) — writing
// through a stale handle would mutate orphaned arrays.
//
// Wrapper contract (Router enforces before an ADD call):
//   * table free-list holds >= len(pairs) rows (no growth mid-call)
//   * vocab._refs covers next_id + worst-case new words
//   * index bucket arrays pre-grown by len(pairs); slot table
//     pre-grown so the batch cannot cross the bulk load factor
// Deletes need no pre-pass: they only append to the free lists.
// add returns need_rebuild=True when an eviction walk exhausted
// MAX_KICKS (the carried key is left unseated; the caller must
// _rebuild, which re-places every bucket from its records, then
// recreate the handle).

static const uint32_t kH1Seed = 0x811C9DC5u, kH1Cls = 0x9E3779B1u,
                      kH1Mul = 16777619u;
static const uint32_t kFpSeed = 0x2545F491u, kFpCls = 0x85EBCA6Bu,
                      kFpXor = 0xC2B2AE35u, kFpMul = 0x27D4EB2Fu;
static const uint32_t kAltMul = 0x9E3779B9u;
static const int kBucketW = 4, kMaxKicks = 512;

static const char *kHandleName = "emqx_tpu_torch.churn_handle";
static uint64_t g_cache_serial = 0;  // word-cache epoch allocator

static PyObject *sep_str() {  // immortal '/' (lazy, once per process)
  static PyObject *g = nullptr;
  if (!g) g = PyUnicode_InternFromString("/");
  return g;
}

struct ChurnHandle {
  // router stores (strong refs)
  PyObject *exact_t = nullptr, *wild_t = nullptr, *deep_t = nullptr,
           *exact_row = nullptr, *filter_row = nullptr,
           *row_filter = nullptr, *exact_deep = nullptr,
           *trie_pending_f = nullptr, *trie_pending_r = nullptr,
           *deep_trie = nullptr;
  // table
  PyObject *tab = nullptr, *tab_free = nullptr, *tab_fstr = nullptr,
           *tab_filters = nullptr, *tab_dirty = nullptr;
  Buf words, plen, hh, rw, active;
  long L = 0;
  // vocab
  PyObject *voc = nullptr, *voc_ids = nullptr, *voc_words = nullptr,
           *voc_free = nullptr;
  Buf refs;
  // index (optional; null when router.index is None)
  PyObject *ix = nullptr, *skel_packed = nullptr, *bucket_of = nullptr,
           *bucket_rows = nullptr, *bucket_free = nullptr,
           *bkt_ws = nullptr, *residual = nullptr, *dirty_slots = nullptr;
  Buf row_bucket, bkt_cid, bkt_h1, bkt_fp, bkt_slot, class_buckets, s_fp,
      s_bucket, s_probe;
  long n_buckets = 0;

  // dest-store feed (router.dest_store.pending_rows): fresh pairs'
  // rows are marked pending a segment rebuild directly from the core
  // (the lazy storm feed — Router._fanout_flush rebuilds at resolve)
  PyObject *pending_rows = nullptr;
  // cached scalars (read once at build, written back only when they
  // change — the handle contract guarantees no other writer while the
  // handle is live, so the cache IS the truth between calls)
  int64_t next_id = 0;      // vocab._next
  int64_t next_written = 0; // last value written back
  long count_cache = 0;     // table._count
  long gen_cache = 0;       // table.generation
  long live_cache = 0;      // ix._live
  uint64_t cache_serial = 0;  // word-cache epoch (bumped on release)
  uint64_t last_skel = 0;   // single-entry skeleton -> class cache
  long last_cid = -1;
  bool skel_valid = false;

  // per-call state (reset at the top of each core call; calls hold
  // the GIL and never reenter)
  long count_delta = 0, live_delta = 0;
  Py_ssize_t tab_taken = 0;  // rows consumed off tab_free's tail
  Py_ssize_t voc_taken = 0;  // ids consumed off voc_free's tail
  Py_ssize_t bkt_taken = 0;  // bids consumed off bucket_free's tail
  bool any_residual = false, need_rebuild = false;
  bool dirty_grew = false;    // appended to table.dirty this call
  bool deep_changed = false;  // deep/exact-deep stores changed

  void reset_call() {
    count_delta = live_delta = 0;
    tab_taken = voc_taken = bkt_taken = 0;
    any_residual = need_rebuild = false;
    dirty_grew = deep_changed = false;
  }

  ~ChurnHandle() {
    for (PyObject *o :
         {exact_t, wild_t, deep_t, exact_row, filter_row, row_filter,
          exact_deep, trie_pending_f, trie_pending_r, deep_trie, tab,
          tab_free, tab_fstr, tab_filters, tab_dirty, voc, voc_ids,
          voc_words, voc_free, pending_rows, ix, skel_packed, bucket_of,
          bucket_rows, bucket_free, bkt_ws, residual, dirty_slots})
      Py_XDECREF(o);
  }
};

// acquire a contiguous buffer view of `o.name` (the buffer itself
// keeps the array alive; no separate object ref needed)
static bool get_buf_attr(PyObject *o, const char *name, Buf &b) {
  PyObject *a = PyObject_GetAttrString(o, name);
  if (!a) return false;
  bool ok = b.get(a, PyBUF_CONTIG);
  Py_DECREF(a);
  return ok;
}

static ChurnHandle *handle_build(PyObject *router) {
  ChurnHandle *h = new ChurnHandle();
#define GETH(field, obj, name)                                 \
  if (!((h->field) = PyObject_GetAttrString((obj), (name)))) { \
    delete h;                                                  \
    return nullptr;                                            \
  }
  GETH(exact_t, router, "_exact");
  GETH(wild_t, router, "_wild");
  GETH(deep_t, router, "_deep");
  GETH(exact_row, router, "_exact_row");
  GETH(filter_row, router, "_filter_row");
  GETH(row_filter, router, "_row_filter");
  GETH(exact_deep, router, "_exact_deep");
  GETH(trie_pending_f, router, "_trie_pending_f");
  GETH(trie_pending_r, router, "_trie_pending_r");
  GETH(deep_trie, router, "_deep_trie");
  GETH(tab, router, "table");
  GETH(tab_free, h->tab, "_free");
  GETH(tab_fstr, h->tab, "_fstr");
  GETH(tab_filters, h->tab, "_filters");
  GETH(tab_dirty, h->tab, "dirty");
  GETH(voc, h->tab, "vocab");
  GETH(voc_ids, h->voc, "_ids");
  GETH(voc_words, h->voc, "_words");
  GETH(voc_free, h->voc, "_free");
  {
    PyObject *lobj = PyObject_GetAttrString(h->tab, "max_levels");
    if (!lobj) {
      delete h;
      return nullptr;
    }
    h->L = PyLong_AsLong(lobj);
    Py_DECREF(lobj);
  }
  if (!get_buf_attr(h->tab, "words", h->words) ||
      !get_buf_attr(h->tab, "prefix_len", h->plen) ||
      !get_buf_attr(h->tab, "has_hash", h->hh) ||
      !get_buf_attr(h->tab, "root_wild", h->rw) ||
      !get_buf_attr(h->tab, "active", h->active) ||
      !get_buf_attr(h->voc, "_refs", h->refs)) {
    delete h;
    return nullptr;
  }
  {
    PyObject *nobj = PyObject_GetAttrString(h->voc, "_next");
    if (!nobj) {
      delete h;
      return nullptr;
    }
    h->next_id = h->next_written = PyLong_AsLongLong(nobj);
    Py_DECREF(nobj);
    PyObject *cobj = PyObject_GetAttrString(h->tab, "_count");
    if (!cobj) {
      delete h;
      return nullptr;
    }
    h->count_cache = PyLong_AsLong(cobj);
    Py_DECREF(cobj);
    PyObject *gobj = PyObject_GetAttrString(h->tab, "generation");
    if (!gobj) {
      delete h;
      return nullptr;
    }
    h->gen_cache = PyLong_AsLong(gobj);
    Py_DECREF(gobj);
    PyObject *ds = PyObject_GetAttrString(router, "dest_store");
    if (!ds) {
      delete h;
      return nullptr;
    }
    h->pending_rows = PyObject_GetAttrString(ds, "pending_rows");
    Py_DECREF(ds);
    if (!h->pending_rows) {
      delete h;
      return nullptr;
    }
  }
  h->cache_serial = ++g_cache_serial;
  PyObject *ixo = PyObject_GetAttrString(router, "index");
  if (!ixo) {
    delete h;
    return nullptr;
  }
  if (ixo == Py_None) {
    Py_DECREF(ixo);
    return h;
  }
  h->ix = ixo;  // steals the new ref
  GETH(skel_packed, h->ix, "_skel_packed");
  GETH(bucket_of, h->ix, "_bucket_of");
  GETH(bucket_rows, h->ix, "_bucket_rows");
  GETH(bucket_free, h->ix, "_bucket_free");
  GETH(bkt_ws, h->ix, "_bkt_ws");
  GETH(residual, h->ix, "residual_rows");
  GETH(dirty_slots, h->ix, "dirty_slots");
#undef GETH
  {
    PyObject *nb = PyObject_GetAttrString(h->ix, "n_buckets");
    if (!nb) {
      delete h;
      return nullptr;
    }
    h->n_buckets = PyLong_AsLong(nb);
    Py_DECREF(nb);
  }
  PyObject *slots = PyObject_GetAttrString(h->ix, "slots");
  if (!slots) {
    delete h;
    return nullptr;
  }
  bool ok = get_buf_attr(h->ix, "_row_bucket", h->row_bucket) &&
            get_buf_attr(h->ix, "_bkt_cid", h->bkt_cid) &&
            get_buf_attr(h->ix, "_bkt_h1", h->bkt_h1) &&
            get_buf_attr(h->ix, "_bkt_fp", h->bkt_fp) &&
            get_buf_attr(h->ix, "_bkt_slot", h->bkt_slot) &&
            get_buf_attr(h->ix, "_class_buckets", h->class_buckets) &&
            get_buf_attr(slots, "fp", h->s_fp) &&
            get_buf_attr(slots, "bucket", h->s_bucket) &&
            get_buf_attr(slots, "probe", h->s_probe);
  Py_DECREF(slots);
  if (!ok) {
    delete h;
    return nullptr;
  }
  PyObject *lobj = PyObject_GetAttrString(h->ix, "_live");
  if (!lobj) {
    delete h;
    return nullptr;
  }
  h->live_cache = PyLong_AsLong(lobj);
  Py_DECREF(lobj);
  return h;
}

static void handle_capsule_free(PyObject *cap) {
  auto *h = (ChurnHandle *)PyCapsule_GetPointer(cap, kHandleName);
  delete h;
}

static PyObject *make_churn_handle(PyObject *, PyObject *args) {
  PyObject *router;
  if (!PyArg_ParseTuple(args, "O", &router)) return nullptr;
  ChurnHandle *h = handle_build(router);
  if (!h) return nullptr;
  PyObject *cap = PyCapsule_New(h, kHandleName, handle_capsule_free);
  if (!cap) {
    delete h;
    return nullptr;
  }
  return cap;
}

// a core entry's first arg is either a churn-handle capsule (fast) or
// the router itself (transient fetch — built and torn down in-call)
static ChurnHandle *resolve_handle(PyObject *arg, bool *transient) {
  if (PyCapsule_CheckExact(arg)) {
    *transient = false;
    return (ChurnHandle *)PyCapsule_GetPointer(arg, kHandleName);
  }
  *transient = true;
  return handle_build(arg);
}

// write scalar state back even on failure, keeping counters coherent
// with whatever prefix of the batch landed (exception-safe). The
// cached values ARE the truth while the handle is live, so unchanged
// scalars cost nothing.
static void write_back_scalars(ChurnHandle &st) {
  bool had_err = PyErr_Occurred() != nullptr;
  PyObject *et = nullptr, *ev = nullptr, *tb = nullptr;
  if (had_err) PyErr_Fetch(&et, &ev, &tb);
  if (st.next_id != st.next_written) {
    PyObject *v = PyLong_FromLongLong(st.next_id);
    if (v) {
      if (PyObject_SetAttrString(st.voc, "_next", v) == 0)
        st.next_written = st.next_id;
      Py_DECREF(v);
    }
  }
  if (st.count_delta) {
    st.count_cache += st.count_delta;
    PyObject *nv = PyLong_FromLong(st.count_cache);
    if (nv) {
      PyObject_SetAttrString(st.tab, "_count", nv);
      Py_DECREF(nv);
    }
  }
  if (st.dirty_grew) {
    // same bump discipline as the python paths: one generation tick
    // per call that changed the filter set (match caches only need
    // CHANGE, not a count)
    st.gen_cache += 1;
    PyObject *nv = PyLong_FromLong(st.gen_cache);
    if (nv) {
      PyObject_SetAttrString(st.tab, "generation", nv);
      Py_DECREF(nv);
    }
  }
  if (st.ix) {
    if (st.live_delta) {
      st.live_cache += st.live_delta;
      PyObject *nv = PyLong_FromLong(st.live_cache);
      if (nv) {
        PyObject_SetAttrString(st.ix, "_live", nv);
        Py_DECREF(nv);
      }
    }
    if (st.any_residual)
      PyObject_SetAttrString(st.ix, "residual_dirty", Py_True);
  }
  if (had_err) PyErr_Restore(et, ev, tb);
}

// word-id cache: entries OWN their key bytes and are tagged with the
// handle's cache serial, so hits persist ACROSS calls (the single-row
// add path gets the same hot-word locality as a storm batch) while
// staying correct for multiple routers (distinct serials) and word-id
// recycling (the delete core bumps the serial whenever it releases an
// id, which O(1)-invalidates every entry).  A hit costs one FNV hash
// + memcmp — no PyUnicode allocation, no dict probe.
struct WordCacheEntry {
  uint64_t serial;  // owning handle's word-cache epoch (0 = empty)
  int32_t len;
  int64_t id;
  char buf[44];
};
static const int kWCBits = 13, kWCSize = 1 << kWCBits;
static WordCacheEntry g_wcache[kWCSize];

static inline uint32_t fnv1a(const char *s, Py_ssize_t n) {
  uint32_t h = 0x811C9DC5u;
  for (Py_ssize_t i = 0; i < n; i++) h = (h ^ (uint8_t)s[i]) * 16777619u;
  return h;
}

// place (fp, bid) into the cuckoo table starting from bucket b1.
// Mirrors hash_index._evict_insert (same LCG walk); maintains probe
// words, _bkt_slot and dirty_slots inline.  Returns false when the
// walk exhausts (carried key unseated -> caller sets need_rebuild).
static bool core_place(ChurnHandle &st, uint32_t h1, uint32_t fp,
                       int32_t bid) {
  uint32_t mask = (uint32_t)st.n_buckets - 1;
  uint32_t *sfp = (uint32_t *)st.s_fp.b.buf;
  int32_t *sbkt = (int32_t *)st.s_bucket.b.buf;
  uint32_t *sprobe = (uint32_t *)st.s_probe.b.buf;
  int64_t *bslot = (int64_t *)st.bkt_slot.b.buf;
  uint32_t b1 = h1 & mask;
  uint32_t b2 = b1 ^ (((fp | 1u) * kAltMul) & mask);
  auto write = [&](long slot, uint32_t f, int32_t id) -> bool {
    sfp[slot] = f;
    sbkt[slot] = id;
    long b = slot / kBucketW, lane = slot % kBucketW;
    uint32_t byte = f >> 24;
    if (byte == 0) byte = 1;
    sprobe[b] = (sprobe[b] & ~(0xFFu << (8 * lane))) | (byte << (8 * lane));
    bslot[id] = slot;
    PyObject *s = PyLong_FromLong(slot);
    if (!s) return false;
    int rc = PyList_Append(st.dirty_slots, s);
    Py_DECREF(s);
    return rc == 0;
  };
  for (uint32_t b : {b1, b2}) {
    long base = (long)b * kBucketW;
    for (int lane = 0; lane < kBucketW; lane++) {
      if (sbkt[base + lane] < 0) return write(base + lane, fp, bid);
    }
  }
  // both full: evict along the alternate-bucket walk
  uint32_t seed = (b1 * 0x9E3779B1u + fp);
  uint32_t cur = b1;
  for (int k = 0; k < kMaxKicks; k++) {
    seed = seed * 1103515245u + 12345u;
    int lane = (int)((seed >> 16) % kBucketW);
    long s = (long)cur * kBucketW + lane;
    uint32_t vfp = sfp[s];
    int32_t vbid = sbkt[s];
    if (!write(s, fp, bid)) return false;  // py error -> caller sees
    fp = vfp;
    bid = vbid;
    cur = cur ^ (((fp | 1u) * kAltMul) & mask);
    long base = (long)cur * kBucketW;
    for (int l2 = 0; l2 < kBucketW; l2++) {
      if (sbkt[base + l2] < 0) return write(base + l2, fp, bid);
    }
  }
  bslot[bid] = -1;  // carried key unseated; rebuild re-places all
  st.need_rebuild = true;
  return true;  // not a python error
}

// index one freshly-encoded row.  `rowobj` is the row's PyLong, `r`
// its value; wrow/plen/hh/rw describe the encoded filter.
static bool core_index_add(ChurnHandle &st, PyObject *flt, PyObject *rowobj,
                           long r, const int32_t *wrow, long plen, bool hh,
                           bool rw) {
  if (!st.ix) return true;
  int64_t *rowbkt = (int64_t *)st.row_bucket.b.buf;
  if (plen > 32) {
    if (PySet_Add(st.residual, rowobj) < 0) return false;
    st.any_residual = true;
    return true;
  }
  PyObject *bidobj = PyDict_GetItemWithError(st.bucket_of, flt);
  if (!bidobj && PyErr_Occurred()) return false;
  if (bidobj) {  // same filter string indexed under another row
    long bid = PyLong_AsLong(bidobj);
    PyObject *rs = PyList_GET_ITEM(st.bucket_rows, bid);
    if (PySet_Check(rs)) {
      if (PySet_Add(rs, rowobj) < 0) return false;
    } else if (PyObject_RichCompareBool(rs, rowobj, Py_NE) == 1) {
      PyObject *ns = PySet_New(nullptr);
      if (!ns || PySet_Add(ns, rs) < 0 || PySet_Add(ns, rowobj) < 0) {
        Py_XDECREF(ns);
        return false;
      }
      PyList_SetItem(st.bucket_rows, bid, ns);  // steals ns, frees rs
    }
    rowbkt[r] = bid;
    return true;
  }
  uint64_t pm = 0;
  for (long i = 0; i < plen; i++) {
    if (wrow[i] == kPlus) pm |= 1ull << i;
  }
  uint64_t skel = (uint64_t)plen | ((uint64_t)hh << 6) | (pm << 7);
  long cid;
  if (st.skel_valid && st.last_skel == skel) {
    // single-entry skeleton cache: real tables have FEW skeletons, so
    // storms and single-row adds alike hit this (invalidated on class
    // retirement)
    cid = st.last_cid;
  } else {
    PyObject *skelobj = PyLong_FromUnsignedLongLong(skel);
    if (!skelobj) return false;
    PyObject *cidobj = PyDict_GetItemWithError(st.skel_packed, skelobj);
    Py_DECREF(skelobj);
    if (cidobj) {
      cid = PyLong_AsLong(cidobj);
    } else {
      if (PyErr_Occurred()) return false;
      // new skeleton: let python allocate the class (meta arrays etc.)
      PyObject *res = PyObject_CallMethod(
          st.ix, "_class_of", "lOOK", plen, hh ? Py_True : Py_False,
          rw ? Py_True : Py_False, (unsigned long long)pm);
      if (!res) return false;
      if (res == Py_None) {
        Py_DECREF(res);
        if (PySet_Add(st.residual, rowobj) < 0) return false;
        st.any_residual = true;
        return true;
      }
      cid = PyLong_AsLong(res);
      Py_DECREF(res);
    }
    st.last_skel = skel;
    st.last_cid = cid;
    st.skel_valid = true;
  }
  // device hash — bit-identical to hash_index._hash_host
  uint32_t h1 = kH1Seed ^ ((uint32_t)cid * kH1Cls);
  uint32_t fp = kFpSeed + (uint32_t)cid * kFpCls;
  for (long i = 0; i < st.L; i++) {
    uint32_t x = 0;
    if (i < plen && wrow[i] != kPlus) x = (uint32_t)wrow[i] + 1;
    h1 = (h1 ^ x) * kH1Mul;
    fp = (fp ^ (x * kFpXor)) * kFpMul;
  }
  // allocate a bucket record (bare row — set allocated only on share)
  long bid;
  Py_ssize_t nfree = PyList_GET_SIZE(st.bucket_free) - st.bkt_taken;
  if (nfree > 0) {
    // consume off the free tail; ONE truncation at write-back
    PyObject *bobj = PyList_GET_ITEM(st.bucket_free, nfree - 1);
    st.bkt_taken++;
    bid = PyLong_AsLong(bobj);
    Py_INCREF(rowobj);
    PyList_SetItem(st.bucket_rows, bid, rowobj);
    Py_INCREF(flt);
    PyList_SetItem(st.bkt_ws, bid, flt);
    if (PyDict_SetItem(st.bucket_of, flt, bobj) < 0) return false;
  } else {
    bid = PyList_GET_SIZE(st.bkt_ws);
    if (PyList_Append(st.bkt_ws, flt) < 0 ||
        PyList_Append(st.bucket_rows, rowobj) < 0)
      return false;
    PyObject *bobj = PyLong_FromLong(bid);
    if (!bobj) return false;
    if (PyDict_SetItem(st.bucket_of, flt, bobj) < 0) {
      Py_DECREF(bobj);
      return false;
    }
    Py_DECREF(bobj);
  }
  rowbkt[r] = bid;
  if ((Py_ssize_t)(st.bkt_cid.b.len / 4) <= bid) {
    PyErr_SetString(PyExc_ValueError, "bucket arrays not pre-grown");
    return false;
  }
  ((int32_t *)st.bkt_cid.b.buf)[bid] = (int32_t)cid;
  ((uint32_t *)st.bkt_h1.b.buf)[bid] = h1;
  ((uint32_t *)st.bkt_fp.b.buf)[bid] = fp;
  ((int64_t *)st.bkt_slot.b.buf)[bid] = -1;
  ((int64_t *)st.class_buckets.b.buf)[cid] += 1;
  st.live_delta += 1;
  return core_place(st, h1, fp, (int32_t)bid);
}

// word boundaries of one filter (byte offsets into its utf8 form)
struct WordSpan {
  int32_t off;
  int32_t len;
};
static const int kMaxWords = 72;  // > L(<=32) + 1; deeper goes DEEP path

// scan a filter's utf8 bytes once: word spans + wildness
static int scan_words(const char *s, Py_ssize_t n, WordSpan *spans,
                      bool *wild_out) {
  int nw = 0;
  bool wild = false;
  Py_ssize_t i = 0;
  for (;;) {
    Py_ssize_t j = i;
    while (j < n && s[j] != '/') j++;
    if (nw < kMaxWords) {
      spans[nw].off = (int32_t)i;
      spans[nw].len = (int32_t)(j - i);
    }
    nw++;
    if (j - i == 1 && (s[i] == '+' || s[i] == '#')) wild = true;
    if (j >= n) break;
    i = j + 1;
    if (i > n) break;
  }
  *wild_out = wild;
  return nw;
}

// encode one fresh filter into a table row.  Returns 1 ok, 0 deep
// (plen > L; no row consumed), -1 python error.  On ok, *rowobj_out
// is a BORROWED ref (owned by tab_dirty after append).
static int core_add_row(ChurnHandle &st, PyObject *flt, const char *s,
                        const WordSpan *spans, int nw, PyObject **rowobj_out,
                        long *r_out, const int32_t **wrow_out,
                        long *plen_out, bool *hh_out, bool *rw_out) {
  bool hh = spans[nw - 1].len == 1 && s[spans[nw - 1].off] == '#';
  long plen = hh ? nw - 1 : nw;
  if (plen > st.L || nw > kMaxWords) return 0;
  Py_ssize_t nfree = PyList_GET_SIZE(st.tab_free) - st.tab_taken;
  if (nfree <= 0) {
    PyErr_SetString(PyExc_ValueError, "table free-list not pre-grown");
    return -1;
  }
  PyObject *rowobj = PyList_GET_ITEM(st.tab_free, nfree - 1);  // borrowed
  long r = PyLong_AsLong(rowobj);
  if (r < 0 && PyErr_Occurred()) return -1;
  st.tab_taken++;
  int32_t *wrow = (int32_t *)st.words.b.buf + (size_t)r * st.L;
  int64_t *refs = (int64_t *)st.refs.b.buf;
  Py_ssize_t refs_cap = st.refs.b.len / 8;
  bool rw = hh && plen == 0;
  for (long i = 0; i < st.L; i++) wrow[i] = 0;
  for (long i = 0; i < plen; i++) {
    const char *wp = s + spans[i].off;
    int wl = spans[i].len;
    if (wl == 1 && wp[0] == '+') {
      wrow[i] = kPlus;
      if (i == 0) rw = true;
      continue;
    }
    // word cache: hit avoids the PyUnicode alloc + dict probe
    uint32_t h = fnv1a(wp, wl);
    WordCacheEntry *e = &g_wcache[h & (kWCSize - 1)];
    int64_t id;
    if (e->serial == st.cache_serial && e->len == wl &&
        memcmp(e->buf, wp, wl) == 0) {
      id = e->id;
    } else {
      PyObject *w = PyUnicode_DecodeUTF8(wp, wl, nullptr);
      if (!w) return -1;
      PyObject *wid = PyDict_GetItemWithError(st.voc_ids, w);
      if (wid) {
        id = PyLong_AsLongLong(wid);
        Py_DECREF(w);
      } else {
        if (PyErr_Occurred()) {
          Py_DECREF(w);
          return -1;
        }
        PyObject *idobj;
        Py_ssize_t vfree = PyList_GET_SIZE(st.voc_free) - st.voc_taken;
        if (vfree > 0) {
          idobj = PyList_GET_ITEM(st.voc_free, vfree - 1);  // borrowed
          Py_INCREF(idobj);
          st.voc_taken++;
          id = PyLong_AsLongLong(idobj);
        } else {
          id = st.next_id++;
          idobj = PyLong_FromLongLong(id);
          if (!idobj) {
            Py_DECREF(w);
            return -1;
          }
        }
        if (PyDict_SetItem(st.voc_ids, w, idobj) < 0 ||
            PyDict_SetItem(st.voc_words, idobj, w) < 0) {
          Py_DECREF(idobj);
          Py_DECREF(w);
          return -1;
        }
        Py_DECREF(idobj);
        Py_DECREF(w);
      }
      if (wl <= (int)sizeof(e->buf)) {
        memcpy(e->buf, wp, wl);
        e->len = wl;
        e->serial = st.cache_serial;
        e->id = id;
      }
    }
    if (id < 0 || id >= refs_cap) {
      PyErr_SetString(PyExc_ValueError, "refs array not pre-grown");
      return -1;
    }
    refs[id]++;
    wrow[i] = (int32_t)id;
  }
  ((int32_t *)st.plen.b.buf)[r] = (int32_t)plen;
  ((uint8_t *)st.hh.b.buf)[r] = hh;
  ((uint8_t *)st.rw.b.buf)[r] = rw;
  ((uint8_t *)st.active.b.buf)[r] = 1;
  // lazy words tuple: store only the string; filter_words() splits on
  // first host use
  Py_INCREF(flt);
  PyList_SetItem(st.tab_fstr, r, flt);
  if (PyList_Append(st.tab_dirty, rowobj) < 0) return -1;
  st.count_delta += 1;
  st.dirty_grew = true;
  *rowobj_out = rowobj;  // kept alive by tab_dirty
  *r_out = r;
  *wrow_out = wrow;
  *plen_out = plen;
  *hh_out = hh;
  *rw_out = rw;
  return 1;
}

// RAII owner for a transiently-built handle (capsule handles persist)
struct HandleScope {
  ChurnHandle *h = nullptr;
  bool transient = false;
  ~HandleScope() {
    if (transient) delete h;
  }
};

static PyObject *g_one() {  // cached small int 1
  static PyObject *o = nullptr;
  if (!o) o = PyLong_FromLong(1);
  return o;
}

// one (flt, dest) pair through the add leg. `pair`/`fresh_list` (when
// non-null) collect the first-appear transition for the bulk API;
// *fresh_out reports it either way. A fresh pair whose filter has a
// table row is marked pending in the dest store's lazy storm feed
// right here (Router._fanout_flush rebuilds the segment at the next
// resolve). Returns 0 ok, -1 python error.
static int add_one_pair(ChurnHandle &st, PyObject *pair, PyObject *flt,
                        PyObject *dest, PyObject *fresh_list,
                        bool *fresh_out) {
  *fresh_out = false;
  PyObject *one = g_one();
  if (!one) return -1;
  Py_ssize_t slen;
  const char *s = PyUnicode_AsUTF8AndSize(flt, &slen);
  if (!s) return -1;
  WordSpan spans[kMaxWords];
  bool wild;
  int nw = scan_words(s, slen, spans, &wild);
  PyObject *dests;
  if (wild) {
    dests = PyDict_GetItemWithError(st.wild_t, flt);
    if (!dests && !PyErr_Occurred() && PyDict_GET_SIZE(st.deep_t))
      dests = PyDict_GetItemWithError(st.deep_t, flt);
  } else {
    dests = PyDict_GetItemWithError(st.exact_t, flt);
  }
  if (!dests && PyErr_Occurred()) return -1;
  if (!dests) {
    // fresh filter: register {dest: 1} directly (fused first bump),
    // encode a row, index it
    dests = PyDict_New();
    if (!dests || PyDict_SetItem(dests, dest, one) < 0 ||
        PyDict_SetItem(wild ? st.wild_t : st.exact_t, flt, dests) < 0) {
      Py_XDECREF(dests);
      return -1;
    }
    Py_DECREF(dests);  // owned by the table dict now
    *fresh_out = true;
    if (fresh_list && PyList_Append(fresh_list, pair) < 0) return -1;
    PyObject *rowobj;
    long r, plen;
    const int32_t *wrow;
    bool hhf, rwf;
    int rc = core_add_row(st, flt, s, spans,
                          nw > kMaxWords ? kMaxWords : nw, &rowobj, &r,
                          &wrow, &plen, &hhf, &rwf);
    if (rc < 0) return -1;
    if (rc == 0 || nw > kMaxWords) {
      // too deep for the flattened table
      st.deep_changed = true;
      if (wild) {
        PyObject *wst;
        if (nw > kMaxWords) {
          // spans truncated: fall back to python split
          PyObject *meth = PyObject_CallMethod(flt, "split", "s", "/");
          if (!meth || !PyList_Check(meth)) {
            Py_XDECREF(meth);
            return -1;
          }
          wst = PyList_AsTuple(meth);
          Py_DECREF(meth);
          if (!wst) return -1;
        } else {
          wst = PyTuple_New(nw);
          if (!wst) return -1;
          for (int i = 0; i < nw; i++) {
            PyObject *w = PyUnicode_DecodeUTF8(s + spans[i].off,
                                               spans[i].len, nullptr);
            if (!w) {
              Py_DECREF(wst);
              return -1;
            }
            PyTuple_SET_ITEM(wst, i, w);
          }
        }
        // migrate dest dict to the deep store + deep trie
        Py_INCREF(dests);
        if (PyDict_DelItem(st.wild_t, flt) < 0 ||
            PyDict_SetItem(st.deep_t, flt, dests) < 0) {
          Py_DECREF(dests);
          Py_DECREF(wst);
          return -1;
        }
        Py_DECREF(dests);
        PyObject *res =
            PyObject_CallMethod(st.deep_trie, "insert", "OO", wst, flt);
        Py_DECREF(wst);
        if (!res) return -1;
        Py_DECREF(res);
      } else {
        if (PySet_Add(st.exact_deep, flt) < 0) return -1;
      }
    } else {
      if (PyDict_SetItem(wild ? st.filter_row : st.exact_row, flt,
                         rowobj) < 0)
        return -1;
      // row -> filter string (flat list indexed by row)
      Py_INCREF(flt);
      if (PyList_SetItem(st.row_filter, r, flt) < 0) return -1;
      if (wild) {
        // pending trie insert in string form (drained lazily)
        if (PyList_Append(st.trie_pending_f, flt) < 0 ||
            PyList_Append(st.trie_pending_r, rowobj) < 0)
          return -1;
      }
      if (!core_index_add(st, flt, rowobj, r, wrow, plen, hhf, rwf))
        return -1;
      if (PySet_Add(st.pending_rows, rowobj) < 0) return -1;
    }
    return 0;  // first dest already registered
  }
  // dest refcount bump on an existing filter
  PyObject *cnt = PyDict_GetItemWithError(dests, dest);
  if (!cnt && PyErr_Occurred()) return -1;
  if (!cnt) {
    if (PyDict_SetItem(dests, dest, one) < 0) return -1;
    *fresh_out = true;
    if (fresh_list && PyList_Append(fresh_list, pair) < 0) return -1;
    // existing filter, new dest: mark its row pending a segment
    // rebuild (host-resident filters have no row — fallback covers)
    PyObject *rowobj = PyDict_GetItemWithError(
        wild ? st.filter_row : st.exact_row, flt);
    if (!rowobj && PyErr_Occurred()) return -1;
    if (rowobj && PySet_Add(st.pending_rows, rowobj) < 0) return -1;
  } else {
    long c = PyLong_AsLong(cnt);
    if (c == -1 && PyErr_Occurred()) return -1;
    PyObject *nc = PyLong_FromLong(c + 1);
    if (!nc || PyDict_SetItem(dests, dest, nc) < 0) {
      Py_XDECREF(nc);
      return -1;
    }
    Py_DECREF(nc);
  }
  return 0;
}

// truncate the consumed free-list tails (once per call, not per row)
static bool truncate_taken(ChurnHandle &st) {
  bool ok = true;
  if (st.tab_taken) {
    Py_ssize_t nf = PyList_GET_SIZE(st.tab_free);
    if (PyList_SetSlice(st.tab_free, nf - st.tab_taken, nf, nullptr) < 0)
      ok = false;
  }
  if (st.voc_taken) {
    Py_ssize_t nf = PyList_GET_SIZE(st.voc_free);
    if (PyList_SetSlice(st.voc_free, nf - st.voc_taken, nf, nullptr) < 0)
      ok = false;
  }
  if (st.bkt_taken) {
    Py_ssize_t nf = PyList_GET_SIZE(st.bucket_free);
    if (PyList_SetSlice(st.bucket_free, nf - st.bkt_taken, nf, nullptr) < 0)
      ok = false;
  }
  return ok;
}

static PyObject *add_routes_core(PyObject *, PyObject *args) {
  PyObject *hobj, *pairs;
  if (!PyArg_ParseTuple(args, "OO!", &hobj, &PyList_Type, &pairs))
    return nullptr;
  HandleScope hs;
  hs.h = resolve_handle(hobj, &hs.transient);
  if (!hs.h) return nullptr;
  ChurnHandle &st = *hs.h;
  st.reset_call();
  // the first-appear pair list is ALWAYS collected: the dest store's
  // storm feed reads it, so there is no uncollected fast path
  Ref fresh;
  fresh.p = PyList_New(0);
  if (!fresh.p) return nullptr;

  // --- single mutation pass over the pairs ---------------------------
  Py_ssize_t n = PyList_GET_SIZE(pairs);
  bool fail = false;
  for (Py_ssize_t k = 0; k < n && !fail; k++) {
    PyObject *pair = PyList_GET_ITEM(pairs, k);
    if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) < 2) {
      PyErr_SetString(PyExc_TypeError, "pair must be a 2-tuple");
      fail = true;
      break;
    }
    bool fresh_flag;
    if (add_one_pair(st, pair, PyTuple_GET_ITEM(pair, 0),
                     PyTuple_GET_ITEM(pair, 1), fresh.p,
                     &fresh_flag) < 0)
      fail = true;
  }
  if (!truncate_taken(st)) fail = true;
  // --- write back scalar state (even on failure: keep consistent) ----
  write_back_scalars(st);
  if (fail) return nullptr;
  return Py_BuildValue("(OO)", fresh.p,
                       st.need_rebuild ? Py_True : Py_False);
}

// add_route_core(handle, flt, dest) -> flags int — the
// allocation-free single-pair entry (the broker's per-subscribe hot
// path, METH_FASTCALL: no arg tuple, no pair tuple, no batch list, no
// result tuple; generation bump and dest-store pending mark happen
// in-core). Flag bits:
//   1 fresh pair (first appearance — fire on_dest_added)
//   2 need_rebuild (caller must ix._rebuild + recreate the handle)
//   8 deep stores changed (caller bumps Router._aux_gen)
static PyObject *add_route_core(PyObject *, PyObject *const *args,
                                Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError,
                    "add_route_core(handle, flt, dest)");
    return nullptr;
  }
  HandleScope hs;
  hs.h = resolve_handle(args[0], &hs.transient);
  if (!hs.h) return nullptr;
  ChurnHandle &st = *hs.h;
  st.reset_call();
  bool fresh = false;
  bool fail =
      add_one_pair(st, nullptr, args[1], args[2], nullptr, &fresh) < 0;
  if (!truncate_taken(st)) fail = true;
  write_back_scalars(st);
  if (fail) return nullptr;
  return PyLong_FromLong((fresh ? 1 : 0) | (st.need_rebuild ? 2 : 0) |
                         (st.deep_changed ? 8 : 0));
}

// ---------------------------------------------------------------------
// del_routes_core(handle|router, pairs) -> (vanished, removed_rows)
//
// The batched delete leg — Router.delete_routes' entire write path in
// one C pass, bit-identical in visible state to the python
// delete_route loop: dest refcount decrement, last-ref dest removal,
// and on a filter's last dest the full teardown — class-index
// un-index (cuckoo slot vacate + probe-word refresh, bucket
// retire/demote, class retirement via ix._retire_class), filter-table
// tombstone (vocab release by word id, free-list recycle, dirty
// append), and a DEFERRED host-trie removal (appended to the same
// ordered pending list the adds use, row encoded as -(row+1);
// _host_trie drains inserts and removals in arrival order, the mria
// route-delete visibility seam).  Returns:
//   vanished     — the (flt, dest) pairs whose LAST reference dropped
//                  (the wrapper feeds the dest store + fires
//                  on_dest_removed from this list)
//   removed_rows — table rows freed because their filter lost its
//                  last dest (the wrapper batch-frees their CSR
//                  segments via DestStore.free_rows)

// recompute one bucket's packed probe word from its four lanes
// (mirror of hash_index._refresh_probe)
static void refresh_probe_c(ChurnHandle &st, long b) {
  uint32_t *sfp = (uint32_t *)st.s_fp.b.buf;
  int32_t *sbkt = (int32_t *)st.s_bucket.b.buf;
  uint32_t *sprobe = (uint32_t *)st.s_probe.b.buf;
  long base = b * kBucketW;
  uint32_t w = 0;
  for (int l = 0; l < kBucketW; l++) {
    if (sbkt[base + l] >= 0) {
      uint32_t byte = sfp[base + l] >> 24;
      if (byte == 0) byte = 1;
      w |= byte << (8 * l);
    }
  }
  sprobe[b] = w;
}

// un-index one row (mirror of ClassIndex.remove_row). Returns false
// on python error.
static bool core_index_remove(ChurnHandle &st, PyObject *rowobj, long r) {
  if (!st.ix) return true;
  int disc = PySet_Discard(st.residual, rowobj);
  if (disc < 0) return false;
  if (disc == 1) {
    st.any_residual = true;  // residual mask must re-upload
    return true;
  }
  int64_t *rowbkt = (int64_t *)st.row_bucket.b.buf;
  long bid = (long)rowbkt[r];
  if (bid < 0) {
    PyErr_Format(PyExc_AssertionError, "row %ld not indexed", r);
    return false;
  }
  rowbkt[r] = -1;
  PyObject *rs = PyList_GET_ITEM(st.bucket_rows, bid);  // borrowed
  if (PySet_Check(rs)) {
    if (PySet_Discard(rs, rowobj) < 0) return false;
    Py_ssize_t nleft = PySet_GET_SIZE(rs);
    if (nleft == 1) {
      // demote back to the bare-int form (python parity)
      PyObject *it = PyObject_GetIter(rs);
      if (!it) return false;
      PyObject *sole = PyIter_Next(it);
      Py_DECREF(it);
      if (!sole) {
        if (!PyErr_Occurred())
          PyErr_SetString(PyExc_RuntimeError, "empty bucket set");
        return false;
      }
      PyList_SetItem(st.bucket_rows, bid, sole);  // steals sole
      return true;
    }
    if (nleft > 0) return true;  // bucket still shared
  } else {
    int ne = PyObject_RichCompareBool(rs, rowobj, Py_NE);
    if (ne < 0) return false;
    if (ne == 1) return true;  // stale/foreign row: bucket not ours
  }
  // bucket dies: vacate the cuckoo slot, retire the record
  PyObject *ws = PyList_GET_ITEM(st.bkt_ws, bid);  // borrowed
  PyObject *key;
  bool key_owned = false;
  if (PyUnicode_Check(ws)) {
    key = ws;
  } else {
    PyObject *sep = sep_str();
    if (!sep) return false;
    key = PyUnicode_Join(sep, ws);
    if (!key) return false;
    key_owned = true;
  }
  int64_t *bslot = (int64_t *)st.bkt_slot.b.buf;
  long slot = (long)bslot[bid];
  if (slot >= 0) {
    ((int32_t *)st.s_bucket.b.buf)[slot] = -1;  // cuckoo: plain delete
    // zero the fingerprint too: phase 2 trusts fp matches (see
    // hash_index.remove_row)
    ((uint32_t *)st.s_fp.b.buf)[slot] = 0;
    refresh_probe_c(st, slot / kBucketW);
    PyObject *s = PyLong_FromLong(slot);
    if (!s) {
      if (key_owned) Py_DECREF(key);
      return false;
    }
    int rc = PyList_Append(st.dirty_slots, s);
    Py_DECREF(s);
    if (rc < 0) {
      if (key_owned) Py_DECREF(key);
      return false;
    }
  }
  st.live_delta -= 1;
  int rc = PyDict_DelItem(st.bucket_of, key);
  if (key_owned) Py_DECREF(key);
  if (rc < 0) return false;
  Py_INCREF(Py_None);
  PyList_SetItem(st.bkt_ws, bid, Py_None);
  PyObject *bobj = PyLong_FromLong(bid);
  if (!bobj) return false;
  rc = PyList_Append(st.bucket_free, bobj);
  Py_DECREF(bobj);
  if (rc < 0) return false;
  int32_t cid = ((int32_t *)st.bkt_cid.b.buf)[bid];
  int64_t *cb = (int64_t *)st.class_buckets.b.buf;
  cb[cid] -= 1;
  if (cb[cid] == 0) {
    // rare: last bucket of a skeleton — python owns class retirement
    PyObject *res =
        PyObject_CallMethod(st.ix, "_retire_class", "l", (long)cid);
    if (!res) return false;
    Py_DECREF(res);
    st.skel_valid = false;  // the cached skeleton may be this class
  }
  return true;
}

// tombstone one table row (mirror of FilterTable.remove), releasing
// vocab refs by word id instead of re-splitting the filter string.
static bool core_table_remove(ChurnHandle &st, PyObject *rowobj, long r) {
  int32_t *wrow = (int32_t *)st.words.b.buf + (size_t)r * st.L;
  long plen = ((int32_t *)st.plen.b.buf)[r];
  int64_t *refs = (int64_t *)st.refs.b.buf;
  for (long i = 0; i < plen; i++) {
    int32_t id = wrow[i];
    if (id == kPlus) continue;
    refs[id] -= 1;
    if (refs[id] == 0) {
      // word's last reference: recycle its id (vocab.release); a
      // recycled id may be re-assigned to a DIFFERENT word, so the
      // word cache must forget everything it knew
      st.cache_serial = ++g_cache_serial;
      PyObject *idobj = PyLong_FromLong(id);
      if (!idobj) return false;
      PyObject *w = PyDict_GetItemWithError(st.voc_words, idobj);
      if (!w) {
        Py_DECREF(idobj);
        if (!PyErr_Occurred())
          PyErr_Format(PyExc_KeyError, "vocab id %d", (int)id);
        return false;
      }
      Py_INCREF(w);
      int rc = PyDict_DelItem(st.voc_ids, w);
      Py_DECREF(w);
      if (rc < 0 || PyDict_DelItem(st.voc_words, idobj) < 0) {
        Py_DECREF(idobj);
        return false;
      }
      rc = PyList_Append(st.voc_free, idobj);
      Py_DECREF(idobj);
      if (rc < 0) return false;
    }
  }
  for (long i = 0; i < st.L; i++) wrow[i] = 0;  // OOV
  ((int32_t *)st.plen.b.buf)[r] = 0;
  ((uint8_t *)st.hh.b.buf)[r] = 0;
  ((uint8_t *)st.rw.b.buf)[r] = 0;
  ((uint8_t *)st.active.b.buf)[r] = 0;
  Py_INCREF(Py_None);
  PyList_SetItem(st.tab_filters, r, Py_None);
  Py_INCREF(Py_None);
  PyList_SetItem(st.tab_fstr, r, Py_None);
  if (PyList_Append(st.tab_free, rowobj) < 0 ||
      PyList_Append(st.tab_dirty, rowobj) < 0)
    return false;
  st.count_delta -= 1;
  st.dirty_grew = true;
  return true;
}

// full teardown of a table-resident filter's row: row->filter clear,
// class-index un-index, table tombstone, removed-rows collect
// (`removed_rows` may be null — the single-pair entry reports the row
// through its packed return instead). `rowobj` stays owned by caller.
static bool core_remove_row_full(ChurnHandle &st, PyObject *rowobj,
                                 PyObject *removed_rows) {
  long r = PyLong_AsLong(rowobj);
  if (r < 0 && PyErr_Occurred()) return false;
  Py_INCREF(Py_None);
  if (PyList_SetItem(st.row_filter, r, Py_None) < 0) return false;
  if (!core_index_remove(st, rowobj, r)) return false;
  if (!core_table_remove(st, rowobj, r)) return false;
  if (removed_rows) return PyList_Append(removed_rows, rowobj) == 0;
  return true;
}

// one (flt, dest) pair through the delete leg. Bulk callers pass the
// collector lists; the single-pair entry passes nulls and reads the
// out params. Returns 0 ok, -1 python error.
static int del_one_pair(ChurnHandle &st, PyObject *pair, PyObject *flt,
                        PyObject *dest, PyObject *vanished_list,
                        PyObject *removed_list, bool *vanished_out,
                        long *freed_row_out) {
  *vanished_out = false;
  *freed_row_out = -1;
  Py_ssize_t slen;
  const char *s = PyUnicode_AsUTF8AndSize(flt, &slen);
  if (!s) return -1;
  bool wild = word_wild_scan(s, slen);
  bool deep = false;
  PyObject *dests;
  if (wild) {
    dests = PyDict_GetItemWithError(st.wild_t, flt);
    if (!dests && !PyErr_Occurred() && PyDict_GET_SIZE(st.deep_t)) {
      dests = PyDict_GetItemWithError(st.deep_t, flt);
      deep = true;
    }
  } else {
    dests = PyDict_GetItemWithError(st.exact_t, flt);
  }
  if (!dests) return PyErr_Occurred() ? -1 : 0;  // unknown: no-op
  PyObject *cnt = PyDict_GetItemWithError(dests, dest);
  if (!cnt) return PyErr_Occurred() ? -1 : 0;  // not routed: no-op
  long c = PyLong_AsLong(cnt);
  if (c == -1 && PyErr_Occurred()) return -1;
  if (c > 1) {  // refcounted duplicate: decrement only
    PyObject *nc = PyLong_FromLong(c - 1);
    if (!nc || PyDict_SetItem(dests, dest, nc) < 0) {
      Py_XDECREF(nc);
      return -1;
    }
    Py_DECREF(nc);
    return 0;
  }
  // last reference: the (flt, dest) pair vanishes
  if (PyDict_DelItem(dests, dest) < 0) return -1;
  *vanished_out = true;
  if (vanished_list && PyList_Append(vanished_list, pair) < 0) return -1;
  if (PyDict_GET_SIZE(dests) != 0) {
    // other dests remain: mark the surviving filter's row pending a
    // segment rebuild (the lazy storm feed's delete half; deep
    // filters have no row — the host fallback covers them)
    if (!deep) {
      PyObject *rowobj = PyDict_GetItemWithError(
          wild ? st.filter_row : st.exact_row, flt);
      if (!rowobj && PyErr_Occurred()) return -1;
      if (rowobj && PySet_Add(st.pending_rows, rowobj) < 0) return -1;
    }
    return 0;
  }
  // the filter's LAST dest vanished: remove the filter itself
  if (!wild) {
    if (PyDict_DelItem(st.exact_t, flt) < 0) return -1;
    PyObject *rowobj = PyDict_GetItemWithError(st.exact_row, flt);
    if (!rowobj && PyErr_Occurred()) return -1;
    if (rowobj) {
      Py_INCREF(rowobj);
      if (PyDict_DelItem(st.exact_row, flt) < 0 ||
          !core_remove_row_full(st, rowobj, removed_list)) {
        Py_DECREF(rowobj);
        return -1;
      }
      *freed_row_out = PyLong_AsLong(rowobj);
      Py_DECREF(rowobj);
    } else {
      // too-deep exact topic: host-only store (aux-gen via wrapper)
      int disc = PySet_Discard(st.exact_deep, flt);
      if (disc < 0) return -1;
      if (disc) st.deep_changed = true;
    }
    return 0;
  }
  if (deep) {
    if (PyDict_DelItem(st.deep_t, flt) < 0) return -1;
    st.deep_changed = true;
    // rare path: python split + deep-trie removal
    PyObject *lst = PyObject_CallMethod(flt, "split", "s", "/");
    if (!lst) return -1;
    PyObject *wst = PyList_AsTuple(lst);
    Py_DECREF(lst);
    if (!wst) return -1;
    PyObject *res =
        PyObject_CallMethod(st.deep_trie, "remove", "OO", wst, flt);
    Py_DECREF(wst);
    if (!res) return -1;
    Py_DECREF(res);
    return 0;
  }
  if (PyDict_DelItem(st.wild_t, flt) < 0) return -1;
  PyObject *rowobj = PyDict_GetItemWithError(st.filter_row, flt);
  if (!rowobj) {
    if (!PyErr_Occurred())
      PyErr_Format(PyExc_KeyError, "filter row missing");
    return -1;
  }
  Py_INCREF(rowobj);
  if (PyDict_DelItem(st.filter_row, flt) < 0 ||
      !core_remove_row_full(st, rowobj, removed_list)) {
    Py_DECREF(rowobj);
    return -1;
  }
  long r = PyLong_AsLong(rowobj);
  Py_DECREF(rowobj);
  *freed_row_out = r;
  // deferred host-trie removal: same ordered pending list as the
  // adds, row encoded -(row+1); _host_trie drains in arrival order
  PyObject *neg = PyLong_FromLong(-r - 1);
  if (!neg) return -1;
  if (PyList_Append(st.trie_pending_f, flt) < 0 ||
      PyList_Append(st.trie_pending_r, neg) < 0) {
    Py_DECREF(neg);
    return -1;
  }
  Py_DECREF(neg);
  return 0;
}

static PyObject *del_routes_core(PyObject *, PyObject *args) {
  PyObject *hobj, *pairs;
  if (!PyArg_ParseTuple(args, "OO!", &hobj, &PyList_Type, &pairs))
    return nullptr;
  HandleScope hs;
  hs.h = resolve_handle(hobj, &hs.transient);
  if (!hs.h) return nullptr;
  ChurnHandle &st = *hs.h;
  st.reset_call();
  Ref vanished, removed_rows;
  vanished.p = PyList_New(0);
  removed_rows.p = PyList_New(0);
  if (!vanished.p || !removed_rows.p) return nullptr;

  Py_ssize_t n = PyList_GET_SIZE(pairs);
  bool fail = false;
  for (Py_ssize_t k = 0; k < n && !fail; k++) {
    PyObject *pair = PyList_GET_ITEM(pairs, k);
    if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) < 2) {
      PyErr_SetString(PyExc_TypeError, "pair must be a 2-tuple");
      fail = true;
      break;
    }
    bool van;
    long freed;
    if (del_one_pair(st, pair, PyTuple_GET_ITEM(pair, 0),
                     PyTuple_GET_ITEM(pair, 1), vanished.p,
                     removed_rows.p, &van, &freed) < 0)
      fail = true;
  }
  write_back_scalars(st);
  if (fail) return nullptr;
  return Py_BuildValue("(OO)", vanished.p, removed_rows.p);
}

// del_route_core(handle, flt, dest) -> packed int — the
// allocation-free single-pair delete (unsubscribe hot path,
// METH_FASTCALL). Low bits mirror add_route_core where they apply,
// high bits carry the freed row:
//   1 pair vanished   2 row freed (id in bits 8+)
//   4 dirty grew      8 deep stores changed
static PyObject *del_route_core(PyObject *, PyObject *const *args,
                                Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError,
                    "del_route_core(handle, flt, dest)");
    return nullptr;
  }
  HandleScope hs;
  hs.h = resolve_handle(args[0], &hs.transient);
  if (!hs.h) return nullptr;
  ChurnHandle &st = *hs.h;
  st.reset_call();
  bool van;
  long freed;
  bool fail = del_one_pair(st, nullptr, args[1], args[2], nullptr,
                           nullptr, &van, &freed) < 0;
  write_back_scalars(st);
  if (fail) return nullptr;
  long flags = (van ? 1 : 0) | (freed >= 0 ? 2 : 0) |
               (st.dirty_grew ? 4 : 0) | (st.deep_changed ? 8 : 0);
  if (freed >= 0) flags |= freed << 8;
  return PyLong_FromLong(flags);
}

// ---------------------------------------------------------------------
// delivery ledger (delivery_*) — the per-session QoS bookkeeping of
// broker/session.py as slot arrays behind one capsule handle (the
// churn-engine discipline): inflight window entries (packet id, phase,
// dup, sent_at) in insertion order, packet-id allocation with the
// exact wraparound walk of Session.alloc_packet_id, and the
// priority-aware mqueue overflow decision over a (prio, qos) shadow of
// the Python deque.  Messages stay on the Python side (Session.inflight
// maps pid -> message); this engine owns only the numeric state, and
// broker/delivery.py holds the bit-exact Python twin the parity tests
// fuzz against.  Config scalars (receive_maximum, max_mqueue_len,
// priority flag) ride each call so the Python SessionConfig stays the
// single source of truth.

// phase codes: 0 awaiting PUBACK, 1 awaiting PUBREC, 2 awaiting PUBCOMP
struct DEnt {
  int32_t pid;
  int8_t phase;
  int8_t dup;
  double sent_at;
};

struct DSlot {
  bool used = false;
  int32_t next_pid = 1;
  std::vector<DEnt> infl;       // insertion order (OrderedDict analog)
  std::vector<uint16_t> q;      // prio << 2 | qos, from qhead
  size_t qhead = 0;
};

struct DeliveryLedger {
  std::vector<DSlot> slots;
  std::vector<int32_t> freelist;
};

static const char *kDeliveryName = "emqx_tpu_torch.delivery_ledger";

static void delivery_capsule_free(PyObject *cap) {
  delete (DeliveryLedger *)PyCapsule_GetPointer(cap, kDeliveryName);
}

static PyObject *delivery_make_handle(PyObject *, PyObject *) {
  auto *l = new DeliveryLedger();
  PyObject *cap = PyCapsule_New(l, kDeliveryName, delivery_capsule_free);
  if (!cap) {
    delete l;
    return nullptr;
  }
  return cap;
}

static DeliveryLedger *dledger(PyObject *cap) {
  return (DeliveryLedger *)PyCapsule_GetPointer(cap, kDeliveryName);
}

static DSlot *dslot(PyObject *cap, long slot) {
  DeliveryLedger *l = dledger(cap);
  if (!l) return nullptr;
  if (slot < 0 || (size_t)slot >= l->slots.size() ||
      !l->slots[slot].used) {
    PyErr_SetString(PyExc_ValueError, "bad delivery slot");
    return nullptr;
  }
  return &l->slots[slot];
}

static PyObject *delivery_open(PyObject *, PyObject *args) {
  PyObject *cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  DeliveryLedger *l = dledger(cap);
  if (!l) return nullptr;
  int32_t slot;
  if (!l->freelist.empty()) {
    slot = l->freelist.back();
    l->freelist.pop_back();
  } else {
    slot = (int32_t)l->slots.size();
    l->slots.emplace_back();
  }
  DSlot &s = l->slots[slot];
  s.used = true;
  s.next_pid = 1;
  s.infl.clear();
  s.q.clear();
  s.qhead = 0;
  return PyLong_FromLong(slot);
}

static PyObject *delivery_close(PyObject *, PyObject *args) {
  PyObject *cap;
  long slot;
  if (!PyArg_ParseTuple(args, "Ol", &cap, &slot)) return nullptr;
  DeliveryLedger *l = dledger(cap);
  if (!l) return nullptr;
  if (slot >= 0 && (size_t)slot < l->slots.size() && l->slots[slot].used) {
    DSlot &s = l->slots[slot];
    s.used = false;
    s.infl.clear();
    s.infl.shrink_to_fit();
    s.q.clear();
    s.q.shrink_to_fit();
    s.qhead = 0;
    l->freelist.push_back((int32_t)slot);
  }
  Py_RETURN_NONE;
}

// the exact wraparound walk of Session.alloc_packet_id: advance
// next_pid per CANDIDATE (occupied or not); -1 when all 65535 taken
static int32_t d_alloc_pid(DSlot &s) {
  for (int i = 0; i < 0xFFFF; i++) {
    int32_t pid = s.next_pid;
    s.next_pid = pid % 0xFFFF + 1;
    bool taken = false;
    for (const DEnt &e : s.infl)
      if (e.pid == pid) {
        taken = true;
        break;
      }
    if (!taken) return pid;
  }
  return -1;
}

static long d_reserve_one(DSlot &s, long qos, double now, long recv_max) {
  if ((long)s.infl.size() >= recv_max) return 0;
  int32_t pid = d_alloc_pid(s);
  if (pid < 0) return -1;
  s.infl.push_back(DEnt{pid, (int8_t)(qos == 1 ? 0 : 1), 0, now});
  return pid;
}

// delivery_reserve(handle, slot, qos, now, recv_max) -> pid | 0 (window
// full); raises RuntimeError when every packet id is inflight
static PyObject *delivery_reserve(PyObject *, PyObject *const *args,
                                  Py_ssize_t nargs) {
  if (nargs != 5) {
    PyErr_SetString(PyExc_TypeError,
                    "delivery_reserve(handle, slot, qos, now, recv_max)");
    return nullptr;
  }
  long slot = PyLong_AsLong(args[1]);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  DSlot *s = dslot(args[0], slot);
  if (!s) return nullptr;
  long qos = PyLong_AsLong(args[2]);
  double now = PyFloat_AsDouble(args[3]);
  long recv_max = PyLong_AsLong(args[4]);
  if (PyErr_Occurred()) return nullptr;
  long pid = d_reserve_one(*s, qos, now, recv_max);
  if (pid < 0) {
    PyErr_SetString(PyExc_RuntimeError, "no free packet id");
    return nullptr;
  }
  return PyLong_FromLong(pid);
}

// delivery_reserve_many(handle, slots, qoses, now, recv_maxes) -> list
// of pids (0 = that session's window is full) — the one-call-per-
// dispatch-window leg the batched QoS fanout rides
static PyObject *delivery_reserve_many(PyObject *, PyObject *args) {
  PyObject *cap, *slots_o, *qoses_o, *rmax_o;
  double now;
  if (!PyArg_ParseTuple(args, "OOOdO", &cap, &slots_o, &qoses_o, &now,
                        &rmax_o))
    return nullptr;
  DeliveryLedger *l = dledger(cap);
  if (!l) return nullptr;
  PyObject *slots = PySequence_Fast(slots_o, "slots must be a sequence");
  if (!slots) return nullptr;
  PyObject *qoses = PySequence_Fast(qoses_o, "qoses must be a sequence");
  if (!qoses) {
    Py_DECREF(slots);
    return nullptr;
  }
  PyObject *rmaxes = PySequence_Fast(rmax_o, "recv_maxes must be a sequence");
  if (!rmaxes) {
    Py_DECREF(slots);
    Py_DECREF(qoses);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(slots);
  PyObject *out = PyList_New(n);
  if (!out) goto fail;
  for (Py_ssize_t i = 0; i < n; i++) {
    long slot = PyLong_AsLong(PySequence_Fast_GET_ITEM(slots, i));
    long qos = PyLong_AsLong(PySequence_Fast_GET_ITEM(qoses, i));
    long rmax = PyLong_AsLong(PySequence_Fast_GET_ITEM(rmaxes, i));
    if (PyErr_Occurred()) goto fail;
    if (slot < 0 || (size_t)slot >= l->slots.size() ||
        !l->slots[slot].used) {
      PyErr_SetString(PyExc_ValueError, "bad delivery slot");
      goto fail;
    }
    long pid = d_reserve_one(l->slots[slot], qos, now, rmax);
    if (pid < 0) {
      PyErr_SetString(PyExc_RuntimeError, "no free packet id");
      goto fail;
    }
    PyObject *v = PyLong_FromLong(pid);
    if (!v) goto fail;
    PyList_SET_ITEM(out, i, v);
  }
  Py_DECREF(slots);
  Py_DECREF(qoses);
  Py_DECREF(rmaxes);
  return out;
fail:
  Py_DECREF(slots);
  Py_DECREF(qoses);
  Py_DECREF(rmaxes);
  Py_XDECREF(out);
  return nullptr;
}

// delivery_ack(handle, slot, pid, kind) -> 1 | 0; kind 0 PUBACK
// (phase 0, delete), 1 PUBREC (phase 1 -> 2), 2 PUBCOMP (phase 2,
// delete).  Order-preserving erase keeps retry iteration identical to
// the OrderedDict walk.
static PyObject *delivery_ack(PyObject *, PyObject *const *args,
                              Py_ssize_t nargs) {
  if (nargs != 4) {
    PyErr_SetString(PyExc_TypeError,
                    "delivery_ack(handle, slot, pid, kind)");
    return nullptr;
  }
  long slot = PyLong_AsLong(args[1]);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  DSlot *s = dslot(args[0], slot);
  if (!s) return nullptr;
  long pid = PyLong_AsLong(args[2]);
  long kind = PyLong_AsLong(args[3]);
  if (PyErr_Occurred()) return nullptr;
  for (size_t i = 0; i < s->infl.size(); i++) {
    if (s->infl[i].pid != pid) continue;
    if (s->infl[i].phase != (int8_t)kind) return PyLong_FromLong(0);
    if (kind == 1) {
      s->infl[i].phase = 2;
    } else {
      s->infl.erase(s->infl.begin() + i);
    }
    return PyLong_FromLong(1);
  }
  return PyLong_FromLong(0);
}

// delivery_forget(handle, slot, pid) -> 1 | 0: unconditional removal
// (the transport's drop-too-large path pops the window entry whatever
// its phase)
static PyObject *delivery_forget(PyObject *, PyObject *const *args,
                                 Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError,
                    "delivery_forget(handle, slot, pid)");
    return nullptr;
  }
  long slot = PyLong_AsLong(args[1]);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  DSlot *s = dslot(args[0], slot);
  if (!s) return nullptr;
  long pid = PyLong_AsLong(args[2]);
  if (PyErr_Occurred()) return nullptr;
  for (size_t i = 0; i < s->infl.size(); i++) {
    if (s->infl[i].pid == pid) {
      s->infl.erase(s->infl.begin() + i);
      return PyLong_FromLong(1);
    }
  }
  return PyLong_FromLong(0);
}

// delivery_retry_due(handle, slot, now, interval) -> [(pid, phase)]:
// entries past the retry interval, stamped sent_at=now / dup=1 in
// insertion order (Session.retry)
static PyObject *delivery_retry_due(PyObject *, PyObject *args) {
  PyObject *cap;
  long slot;
  double now, interval;
  if (!PyArg_ParseTuple(args, "Oldd", &cap, &slot, &now, &interval))
    return nullptr;
  DSlot *s = dslot(cap, slot);
  if (!s) return nullptr;
  PyObject *out = PyList_New(0);
  if (!out) return nullptr;
  for (DEnt &e : s->infl) {
    if (now - e.sent_at < interval) continue;
    e.sent_at = now;
    e.dup = 1;
    PyObject *t = Py_BuildValue("(ii)", (int)e.pid, (int)e.phase);
    if (!t || PyList_Append(out, t) < 0) {
      Py_XDECREF(t);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(t);
  }
  return out;
}

// delivery_touch_all(handle, slot, now) -> [(pid, phase)]: reconnect
// replay — every entry restamped sent_at=now (dup stays as-is, the
// replay packets carry dup themselves), insertion order
static PyObject *delivery_touch_all(PyObject *, PyObject *args) {
  PyObject *cap;
  long slot;
  double now;
  if (!PyArg_ParseTuple(args, "Old", &cap, &slot, &now)) return nullptr;
  DSlot *s = dslot(cap, slot);
  if (!s) return nullptr;
  PyObject *out = PyList_New(s->infl.size());
  if (!out) return nullptr;
  for (size_t i = 0; i < s->infl.size(); i++) {
    DEnt &e = s->infl[i];
    e.sent_at = now;
    PyObject *t = Py_BuildValue("(ii)", (int)e.pid, (int)e.phase);
    if (!t) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, t);
  }
  return out;
}

// delivery_enqueue(handle, slot, prio, qos, max_len, has_prios) ->
// packed decision over the (prio, qos) shadow queue, mirroring
// Session._enqueue's overflow + priority-insert walk exactly:
//   bits 0..1  action: 0 drop incoming, 1 admit, 2 admit after
//              evicting the victim
//   bits 2..31 insert index (post-eviction queue coordinates)
//   bits 32+   victim index (action 2, pre-eviction coordinates)
static PyObject *delivery_enqueue(PyObject *, PyObject *const *args,
                                  Py_ssize_t nargs) {
  if (nargs != 6) {
    PyErr_SetString(
        PyExc_TypeError,
        "delivery_enqueue(handle, slot, prio, qos, max_len, has_prios)");
    return nullptr;
  }
  long slot = PyLong_AsLong(args[1]);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  DSlot *s = dslot(args[0], slot);
  if (!s) return nullptr;
  long prio = PyLong_AsLong(args[2]);
  long qos = PyLong_AsLong(args[3]);
  long max_len = PyLong_AsLong(args[4]);
  long has_prios = PyLong_AsLong(args[5]);
  if (PyErr_Occurred()) return nullptr;
  uint16_t *q = s->q.data() + s->qhead;
  long n = (long)(s->q.size() - s->qhead);
  long action = 1, victim = -1;
  if (n >= max_len) {
    // 1) a QoS0 victim of <= incoming priority, scanned from the
    // tail; 2) else a strictly-lower-priority tail entry; 3) else
    // the incoming message is the lowest-value item — drop it
    for (long i = n - 1; i >= 0; i--) {
      if ((q[i] & 0x3) == 0 && (long)(q[i] >> 2) <= prio) {
        victim = i;
        break;
      }
    }
    if (victim < 0 && n > 0 && (long)(q[n - 1] >> 2) < prio)
      victim = n - 1;
    if (victim < 0) return PyLong_FromLongLong(0);
    s->q.erase(s->q.begin() + s->qhead + victim);
    q = s->q.data() + s->qhead;
    n -= 1;
    action = 2;
  }
  long idx = n;
  if (has_prios && n > 0) {
    while (idx > 0 && (long)(q[idx - 1] >> 2) < prio) idx--;
  }
  s->q.insert(s->q.begin() + s->qhead + idx,
              (uint16_t)(((prio & 0x3FFF) << 2) | (qos & 0x3)));
  long long packed = action | ((long long)idx << 2);
  if (action == 2) packed |= ((long long)victim << 32);
  return PyLong_FromLongLong(packed);
}

// delivery_popleft(handle, slot) -> 1 | 0: the shadow of every
// mqueue.popleft() (drain / expiry pops)
static PyObject *delivery_popleft(PyObject *, PyObject *const *args,
                                  Py_ssize_t nargs) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "delivery_popleft(handle, slot)");
    return nullptr;
  }
  long slot = PyLong_AsLong(args[1]);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  DSlot *s = dslot(args[0], slot);
  if (!s) return nullptr;
  if (s->qhead >= s->q.size()) return PyLong_FromLong(0);
  s->qhead += 1;
  if (s->qhead > 1024 && s->qhead * 2 > s->q.size()) {
    s->q.erase(s->q.begin(), s->q.begin() + s->qhead);
    s->qhead = 0;
  }
  return PyLong_FromLong(1);
}

// delivery_window_len(handle, slot) -> live inflight-window size
static PyObject *delivery_window_len(PyObject *, PyObject *const *args,
                                     Py_ssize_t nargs) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "delivery_window_len(handle, slot)");
    return nullptr;
  }
  long slot = PyLong_AsLong(args[1]);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  DSlot *s = dslot(args[0], slot);
  if (!s) return nullptr;
  return PyLong_FromLong((long)s->infl.size());
}

// delivery_dump(handle, slot) -> (next_pid, [(pid, phase, dup,
// sent_at)], [(prio, qos)]) — the full observable state the parity
// fuzzer diffs against the Python twin
static PyObject *delivery_dump(PyObject *, PyObject *args) {
  PyObject *cap;
  long slot;
  if (!PyArg_ParseTuple(args, "Ol", &cap, &slot)) return nullptr;
  DSlot *s = dslot(cap, slot);
  if (!s) return nullptr;
  PyObject *infl = PyList_New(s->infl.size());
  if (!infl) return nullptr;
  for (size_t i = 0; i < s->infl.size(); i++) {
    const DEnt &e = s->infl[i];
    PyObject *t = Py_BuildValue("(iiid)", (int)e.pid, (int)e.phase,
                                (int)e.dup, e.sent_at);
    if (!t) {
      Py_DECREF(infl);
      return nullptr;
    }
    PyList_SET_ITEM(infl, i, t);
  }
  Py_ssize_t qn = (Py_ssize_t)(s->q.size() - s->qhead);
  PyObject *qd = PyList_New(qn);
  if (!qd) {
    Py_DECREF(infl);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < qn; i++) {
    uint16_t v = s->q[s->qhead + i];
    PyObject *t = Py_BuildValue("(ii)", (int)(v >> 2), (int)(v & 0x3));
    if (!t) {
      Py_DECREF(infl);
      Py_DECREF(qd);
      return nullptr;
    }
    PyList_SET_ITEM(qd, i, t);
  }
  return Py_BuildValue("(iNN)", (int)s->next_pid, infl, qd);
}

// ---------------------------------------------------------------------

static PyMethodDef Methods[] = {
    {"wild_flags", wild_flags, METH_VARARGS,
     "wild_flags(pairs) -> list[bool]"},
    {"encode_filters", encode_filters, METH_VARARGS,
     "encode_filters(filters, ids, words, refs, free, next_id, L)"},
    {"index_dedup", index_dedup, METH_VARARGS,
     "index_dedup(flts, cids, rows, bucket_of, bucket_rows, row_bucket, "
     "bucket_free, residual, nb0)"},
    {"make_churn_handle", make_churn_handle, METH_VARARGS,
     "make_churn_handle(router) -> capsule (cached write-path state)"},
    {"add_routes_core", add_routes_core, METH_VARARGS,
     "add_routes_core(handle_or_router, pairs) -> (fresh, need_rebuild)"},
    {"add_route_core", (PyCFunction)(void (*)(void))add_route_core,
     METH_FASTCALL,
     "add_route_core(handle_or_router, flt, dest) -> packed int "
     "(1 fresh | 2 need_rebuild | 4 dirty_grew | 8 deep_changed | "
     "(row+1) << 8)"},
    {"del_routes_core", del_routes_core, METH_VARARGS,
     "del_routes_core(handle_or_router, pairs) -> "
     "(vanished, removed_rows)"},
    {"del_route_core", (PyCFunction)(void (*)(void))del_route_core,
     METH_FASTCALL,
     "del_route_core(handle_or_router, flt, dest) -> packed int "
     "(1 vanished | 2 row_freed | 4 dirty_grew | 8 deep_changed | "
     "row << 8)"},
    {"delivery_make_handle", delivery_make_handle, METH_NOARGS,
     "delivery_make_handle() -> capsule (per-process delivery ledger)"},
    {"delivery_open", delivery_open, METH_VARARGS,
     "delivery_open(handle) -> slot"},
    {"delivery_close", delivery_close, METH_VARARGS,
     "delivery_close(handle, slot)"},
    {"delivery_reserve", (PyCFunction)(void (*)(void))delivery_reserve,
     METH_FASTCALL,
     "delivery_reserve(handle, slot, qos, now, recv_max) -> pid | 0"},
    {"delivery_reserve_many", delivery_reserve_many, METH_VARARGS,
     "delivery_reserve_many(handle, slots, qoses, now, recv_maxes) -> "
     "list[pid | 0]"},
    {"delivery_ack", (PyCFunction)(void (*)(void))delivery_ack,
     METH_FASTCALL,
     "delivery_ack(handle, slot, pid, kind) -> 1 | 0"},
    {"delivery_forget", (PyCFunction)(void (*)(void))delivery_forget,
     METH_FASTCALL, "delivery_forget(handle, slot, pid) -> 1 | 0"},
    {"delivery_retry_due", delivery_retry_due, METH_VARARGS,
     "delivery_retry_due(handle, slot, now, interval) -> "
     "[(pid, phase)]"},
    {"delivery_touch_all", delivery_touch_all, METH_VARARGS,
     "delivery_touch_all(handle, slot, now) -> [(pid, phase)]"},
    {"delivery_enqueue", (PyCFunction)(void (*)(void))delivery_enqueue,
     METH_FASTCALL,
     "delivery_enqueue(handle, slot, prio, qos, max_len, has_prios) -> "
     "packed int (action | idx << 2 | victim << 32)"},
    {"delivery_popleft", (PyCFunction)(void (*)(void))delivery_popleft,
     METH_FASTCALL, "delivery_popleft(handle, slot) -> 1 | 0"},
    {"delivery_window_len",
     (PyCFunction)(void (*)(void))delivery_window_len, METH_FASTCALL,
     "delivery_window_len(handle, slot) -> int"},
    {"delivery_dump", delivery_dump, METH_VARARGS,
     "delivery_dump(handle, slot) -> (next_pid, infl, queue)"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef Module = {PyModuleDef_HEAD_INIT, "_emqx_torch_speedups",
                                    "route-churn hot loops", -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit__emqx_torch_speedups(void) { return PyModule_Create(&Module); }
