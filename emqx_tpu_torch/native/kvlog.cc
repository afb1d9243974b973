// kvlog — ordered KV store: WAL + memtable, C ABI for ctypes (the
// port's own copy of the reference package's kvlog.cc, built by this
// directory's __init__.py as `libemqx_torch_kv`).
//
// The native storage engine backing the durable-storage layer, the
// stand-in for the reference's rocksdb NIF (erlang-rocksdb, used by
// emqx_ds_storage_layer.erl:140,252,282-294).
// Design: append-only write-ahead log on disk, replayed into an
// ordered in-memory table (std::map) on open; puts/deletes append a
// record then apply; `compact` rewrites the log to the live set;
// range scans walk the ordered map. Durability boundary = kv_flush
// (fflush+fsync), called by the storage layer at batch boundaries —
// the same contract the reference gets from rocksdb WAL.
//
// WAL format v2 (parity with emqx_tpu_torch/ds/kvstore.py PyKv — same
// on-disk bytes): the file opens with an 8-byte magic "EKVWAL2\n",
// then CRC-framed records, little-endian:
//   [u32 crc][u32 klen][u32 vlen][key bytes][val bytes]
// vlen==0xFFFFFFFF → tombstone (no val bytes); crc is CRC-32 (zlib
// polynomial 0xEDB88320, init/xorout 0xFFFFFFFF — bit-identical to
// Python's zlib.crc32) over klen||vlen||key||val. Replay stops at the
// last VERIFIED record: short/oversized headers count torn_records,
// CRC mismatches count crc_failures, and the unverified tail is
// truncated — rocksdb's WAL-checksum contract. Headerless files are
// v1 (length-framed): replayed under the old rules, then rewritten to
// v2 by an immediate compaction so every store is one format.
//
// C ABI kept minimal and allocation-disciplined: kv_get copies into a
// store-owned scratch buffer valid until the next call on the same
// handle from the same thread is fine for our single-Python-thread use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#ifdef _WIN32
#define EXPORT extern "C" __declspec(dllexport)
#else
#define EXPORT extern "C" __attribute__((visibility("default")))
#include <fcntl.h>
#include <unistd.h>
#endif

namespace {

constexpr uint32_t kTombstone = 0xFFFFFFFFu;
const char kMagic[8] = {'E', 'K', 'V', 'W', 'A', 'L', '2', '\n'};

struct Store {
  std::map<std::string, std::string> table;
  FILE* wal = nullptr;
  std::string path;
  std::mutex mu;
  std::string scratch;  // get() result buffer
  uint64_t wal_records = 0;
  uint64_t torn_records = 0;   // length-invalid tails cut at replay
  uint64_t crc_failures = 0;   // checksum-invalid tails cut at replay
  uint64_t upgraded = 0;       // v1 files rewritten to v2 at open/reopen
};

// CRC-32, zlib polynomial — bit-identical to Python's zlib.crc32 so
// the two engines verify each other's files. Incremental: feed the
// previous return value back as `crc` (start at 0).
struct CrcTab {
  uint32_t t[256];
  CrcTab() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
  }
};

uint32_t crc32z(uint32_t crc, const void* buf, size_t n) {
  static const CrcTab tab;
  const unsigned char* p = static_cast<const unsigned char*>(buf);
  crc ^= 0xFFFFFFFFu;
  while (n--) crc = tab.t[(crc ^ *p++) & 0xFFu] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

void put_u32le(unsigned char* p, uint32_t v) {
  p[0] = v & 0xFFu;
  p[1] = (v >> 8) & 0xFFu;
  p[2] = (v >> 16) & 0xFFu;
  p[3] = (v >> 24) & 0xFFu;
}

uint32_t get_u32le(const unsigned char* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

bool append_record(FILE* f, const char* k, uint32_t klen, const char* v,
                   uint32_t vlen_field, uint32_t vlen_real) {
  unsigned char hdr[12];
  put_u32le(hdr + 4, klen);
  put_u32le(hdr + 8, vlen_field);
  uint32_t c = crc32z(0, hdr + 4, 8);
  if (klen) c = crc32z(c, k, klen);
  if (vlen_real) c = crc32z(c, v, vlen_real);
  put_u32le(hdr, c);
  if (fwrite(hdr, 1, 12, f) != 12) return false;
  if (klen && fwrite(k, 1, klen, f) != klen) return false;
  if (vlen_real && fwrite(v, 1, vlen_real, f) != vlen_real) return false;
  return true;
}

void fsync_dir(const std::string& path) {
#ifndef _WIN32
  // rename durability: the parent directory's pages must go down too
  std::string dir = ".";
  auto pos = path.find_last_of('/');
  if (pos == 0) {
    dir = "/";
  } else if (pos != std::string::npos) {
    dir = path.substr(0, pos);
  }
  int fd = ::open(dir.c_str(), O_RDONLY);
  if (fd >= 0) {
    fsync(fd);
    ::close(fd);
  }
#endif
}

// Replays the WAL into the memtable, truncating the unverified tail.
// Returns -1 on error, 0 when the store is v2 (or fresh), 1 when a
// non-empty v1 file replayed and needs the upgrade rewrite.
int replay(Store* s) {
  FILE* f = fopen(s->path.c_str(), "rb");
  if (!f) return 0;  // fresh store
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size == 0) {
    fclose(f);
    return 0;
  }
  char head[8];
  bool v2 = size >= 8 && fread(head, 1, 8, f) == 8 &&
            memcmp(head, kMagic, 8) == 0;
  long good = 0;  // offset after the last verified record
  std::vector<char> kbuf, vbuf;
  if (v2) {
    good = 8;
    for (;;) {
      unsigned char hdr[12];
      size_t got = fread(hdr, 1, 12, f);
      if (got < 12) {
        if (got) s->torn_records++;
        break;
      }
      uint32_t crc = get_u32le(hdr);
      uint32_t klen = get_u32le(hdr + 4);
      uint32_t vlen = get_u32le(hdr + 8);
      uint32_t vreal = (vlen == kTombstone) ? 0 : vlen;
      // bounded header validation: a garbage length must fail here,
      // never inside a multi-GB allocation
      uint64_t remaining = static_cast<uint64_t>(size - ftell(f));
      if (static_cast<uint64_t>(klen) + vreal > remaining) {
        s->torn_records++;
        break;
      }
      kbuf.resize(klen);
      vbuf.resize(vreal);
      if (klen && fread(kbuf.data(), 1, klen, f) != klen) {
        s->torn_records++;
        break;
      }
      if (vreal && fread(vbuf.data(), 1, vreal, f) != vreal) {
        s->torn_records++;
        break;
      }
      uint32_t c = crc32z(0, hdr + 4, 8);
      if (klen) c = crc32z(c, kbuf.data(), klen);
      if (vreal) c = crc32z(c, vbuf.data(), vreal);
      if (c != crc) {
        // never deserialize an unverified record — and nothing after
        // it either: the frame boundary itself is untrusted now
        s->crc_failures++;
        break;
      }
      std::string key(kbuf.data(), klen);
      if (vlen == kTombstone) {
        s->table.erase(key);
      } else {
        s->table[std::move(key)] = std::string(vbuf.data(), vreal);
      }
      s->wal_records++;
      good = ftell(f);
    }
  } else {
    // legacy v1 (length-framed, un-checksummed): best-effort replay,
    // bound-checked, kept only so pre-v2 data dirs open
    fseek(f, 0, SEEK_SET);
    for (;;) {
      unsigned char hdr[8];
      size_t got = fread(hdr, 1, 8, f);
      if (got < 8) {
        if (got) s->torn_records++;
        break;
      }
      uint32_t klen = get_u32le(hdr);
      uint32_t vlen = get_u32le(hdr + 4);
      uint32_t vreal = (vlen == kTombstone) ? 0 : vlen;
      uint64_t remaining = static_cast<uint64_t>(size - ftell(f));
      if (static_cast<uint64_t>(klen) + vreal > remaining) {
        s->torn_records++;
        break;
      }
      kbuf.resize(klen);
      if (klen && fread(kbuf.data(), 1, klen, f) != klen) {
        s->torn_records++;
        break;
      }
      std::string key(kbuf.data(), klen);
      if (vlen == kTombstone) {
        s->table.erase(key);
      } else {
        vbuf.resize(vreal);
        if (vreal && fread(vbuf.data(), 1, vreal, f) != vreal) {
          s->torn_records++;
          break;
        }
        s->table[std::move(key)] = std::string(vbuf.data(), vreal);
      }
      s->wal_records++;
      good = ftell(f);
    }
  }
  fclose(f);
  // cut the unverified tail so future appends don't land after garbage
  if (good < size) {
#ifndef _WIN32
    if (truncate(s->path.c_str(), good) != 0) return -1;
#endif
  }
  // a v1 file whose every record was torn away is just empty
  return (!v2 && good > 0) ? 1 : 0;
}

// Rewrite the WAL to the live table in v2 format. Caller holds no
// lock during open (single-threaded) or s->mu via kv_compact.
int do_compact(Store* s) {
  std::string tmp = s->path + ".compact";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  if (fwrite(kMagic, 1, 8, f) != 8) {
    fclose(f);
    return -1;
  }
  for (auto& kv : s->table) {
    if (!append_record(f, kv.first.data(),
                       static_cast<uint32_t>(kv.first.size()),
                       kv.second.data(),
                       static_cast<uint32_t>(kv.second.size()),
                       static_cast<uint32_t>(kv.second.size()))) {
      fclose(f);
      return -1;
    }
  }
  if (fflush(f) != 0) {
    fclose(f);
    return -1;
  }
#ifndef _WIN32
  fsync(fileno(f));
#endif
  fclose(f);
  if (s->wal) fclose(s->wal);
  s->wal = nullptr;
  if (rename(tmp.c_str(), s->path.c_str()) != 0) return -1;
  fsync_dir(s->path);
  s->wal = fopen(s->path.c_str(), "ab");
  s->wal_records = s->table.size();
  return s->wal ? 0 : -1;
}

}  // namespace

EXPORT void* kv_open(const char* path) {
  auto* s = new Store();
  s->path = path;
  // a stray compaction tmp means the process died before the rename —
  // the swap never happened, so the tmp is dead weight
  remove((s->path + ".compact").c_str());
  int rv = replay(s);
  if (rv < 0) {
    delete s;
    return nullptr;
  }
  s->wal = fopen(path, "ab");
  if (!s->wal) {
    delete s;
    return nullptr;
  }
  fseek(s->wal, 0, SEEK_END);
  if (ftell(s->wal) == 0) {
    // fresh (or fully-truncated) file: stamp the v2 magic
    if (fwrite(kMagic, 1, 8, s->wal) != 8) {
      fclose(s->wal);
      delete s;
      return nullptr;
    }
  }
  if (rv == 1) {
    if (do_compact(s) != 0) {
      if (s->wal) fclose(s->wal);
      delete s;
      return nullptr;
    }
    s->upgraded++;
  }
  return s;
}

EXPORT int kv_put(void* h, const char* k, uint32_t klen, const char* v,
                  uint32_t vlen) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (!append_record(s->wal, k, klen, v, vlen, vlen)) return -1;
  s->table[std::string(k, klen)] = std::string(v, vlen);
  s->wal_records++;
  return 0;
}

EXPORT int kv_delete(void* h, const char* k, uint32_t klen) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (!append_record(s->wal, k, klen, nullptr, kTombstone, 0)) return -1;
  s->table.erase(std::string(k, klen));
  s->wal_records++;
  return 0;
}

// Returns value length, or -1 if missing. *out points at store-owned
// memory valid until the next mutating call.
EXPORT int64_t kv_get(void* h, const char* k, uint32_t klen,
                      const char** out) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->table.find(std::string(k, klen));
  if (it == s->table.end()) return -1;
  s->scratch = it->second;
  *out = s->scratch.data();
  return static_cast<int64_t>(s->scratch.size());
}

EXPORT uint64_t kv_count(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->table.size();
}

// --- range scan ---------------------------------------------------------
// Iterator over [start, end); end empty = to the end of the keyspace.
// Snapshot semantics: the iterator copies matching keys at creation
// (cheap relative to message payloads; isolates scans from writers).

struct Iter {
  std::vector<std::pair<std::string, std::string>> items;
  size_t pos = 0;
};

EXPORT void* kv_scan(void* h, const char* start, uint32_t slen,
                     const char* end, uint32_t elen, uint64_t limit) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto* it = new Iter();
  std::string sk(start, slen), ek(end, elen);
  auto lo = s->table.lower_bound(sk);
  auto hi = elen ? s->table.lower_bound(ek) : s->table.end();
  for (auto p = lo; p != hi; ++p) {
    if (limit && it->items.size() >= limit) break;
    it->items.emplace_back(p->first, p->second);
  }
  return it;
}

// Fills key/val pointers; returns 0 on ok, -1 when exhausted. Pointers
// are owned by the iterator, valid until kv_iter_free.
EXPORT int kv_iter_next(void* ih, const char** k, uint64_t* klen,
                        const char** v, uint64_t* vlen) {
  auto* it = static_cast<Iter*>(ih);
  if (it->pos >= it->items.size()) return -1;
  auto& kv = it->items[it->pos++];
  *k = kv.first.data();
  *klen = kv.first.size();
  *v = kv.second.data();
  *vlen = kv.second.size();
  return 0;
}

EXPORT void kv_iter_free(void* ih) { delete static_cast<Iter*>(ih); }

EXPORT int kv_flush(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (fflush(s->wal) != 0) return -1;
#ifndef _WIN32
  if (fsync(fileno(s->wal)) != 0) return -1;
#endif
  return 0;
}

// Rewrite the WAL to contain only the live table (GC of tombstones and
// overwrites) — the rocksdb-compaction analog.
EXPORT int kv_compact(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return do_compact(s);
}

EXPORT uint64_t kv_wal_records(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->wal_records;
}

EXPORT uint64_t kv_torn_records(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->torn_records;
}

EXPORT uint64_t kv_crc_failures(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->crc_failures;
}

EXPORT uint64_t kv_upgraded(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->upgraded;
}

// Recovery-path reopen: drop the handle and the memtable, then
// rebuild from the file exactly as a fresh process would — replay,
// CRC verification, torn-tail truncation. Per-store torn/crc counters
// reflect the LAST replay's verdict (the Python wrapper folds the
// deltas into the process-global ledger). Returns 0 ok, -1 error.
EXPORT int kv_reopen(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->wal) {
    // drain buffered appends so replay sees them; the handle may be
    // past a failed fsync, so best-effort only
    fclose(s->wal);
    s->wal = nullptr;
  }
  remove((s->path + ".compact").c_str());
  s->table.clear();
  s->wal_records = 0;
  s->torn_records = 0;
  s->crc_failures = 0;
  s->upgraded = 0;
  int rv = replay(s);
  if (rv < 0) return -1;
  s->wal = fopen(s->path.c_str(), "ab");
  if (!s->wal) return -1;
  fseek(s->wal, 0, SEEK_END);
  if (ftell(s->wal) == 0) {
    if (fwrite(kMagic, 1, 8, s->wal) != 8) return -1;
  }
  if (rv == 1) {
    if (do_compact(s) != 0) return -1;
    s->upgraded++;
  }
  return 0;
}

EXPORT void kv_close(void* h) {
  auto* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (s->wal) {
      // graceful shutdown IS a durability boundary: buffered appends
      // must be on disk before the handle goes away
      fflush(s->wal);
#ifndef _WIN32
      fsync(fileno(s->wal));
#endif
      fclose(s->wal);
    }
  }
  delete s;
}

EXPORT void kv_kill(void* h) {
  // simulated SIGKILL: release the store with NO fsync boundary
  auto* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (s->wal) fclose(s->wal);
    s->wal = nullptr;
  }
  delete s;
}
