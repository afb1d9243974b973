#!/usr/bin/env python3
"""Time variants of the packed_match.cu kernel (K9, K10, K13 packed, K11,
K13 counts) on one card.

    python3 tools/packed_variants.py [--rounds N] [NAME=CONST:VALUE[,CONST:VALUE] ...]

Each variant is `emqx_tpu_torch/ops/csrc/packed_match.cu` with some of
its `constexpr int` constants (PT, TT, TG, BR, MIN_BLOCKS) changed, or
with the matrix's runs written by a bulk asynchronous copy from shared
memory (the variant `bulk`, the source patched by `bulk_source`: one
`cp.async.bulk` a topic's run where the output's rows are 16-byte
aligned, in place of each thread's 16-byte streaming store), built
with nvcc for sm_90a into `build/var/NAME/` (in parallel, with
`-Xptxas -v`) and loaded with ctypes beside this tree's own kernel.
The registers of the three forms of `packed_pass` (the bitmap, the
counts and the matrix) are printed for every variant and for this
tree's source (`this`). On phase 9's full-width inputs
(`chip_smoke.forms_inputs`: a 2,097,152-row table and 1,024 topics,
seed 3, as `tools/wrapper_ab.py` times them) every variant is first
held equal to the plain version, then K9 (the first DENSE_B topics),
K10 and K11 (one tile) and K13 packed and counts (the eight tiles of a
(2, 4) mesh on the card) are timed with `chip_smoke.run_ms` in turns,
this tree's kernel first in every round; a variant's counts launch
includes its entry's zero fill, as the wrappers' do. Prints one line a
kernel and variant (device_ms, enqueue_ms a round), then the card's
name and power limit. With no NAME given, VARIANTS.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "emqx_tpu_torch" / "ops" / "csrc"
VARIANTS = {
    "br8": {"BR": 8},
    "br4": {"BR": 4},
    "bulk": {},
    "tt128": {"TT": 128},
    "tt64": {"TT": 64},
    "tt512": {"TT": 512},
    "tg16": {"TG": 16},
    "pt128": {"PT": 128, "MIN_BLOCKS": 8},
    "pt512": {"PT": 512, "MIN_BLOCKS": 2},
    "min5": {"MIN_BLOCKS": 5},
    "min6": {"MIN_BLOCKS": 6},
}


# The bulk variant: the matrix's runs of a topic tile are expanded into
# a shared byte buffer [TT][PT] after the tile's barrier, then thread t
# copies topic t's run to the output with one cp.async.bulk (its size,
# n_rows, a multiple of 16 where the rows are aligned) and waits for the
# copies' reads before the buffer is written again. Unaligned outputs
# and dead blocks keep the streaming stores.
BULK_STORE = """
__device__ __forceinline__ void store_bytes_bulk(const PackedArgs& a, long long row0,
                                                 long long col0, int nt, int n_rows,
                                                 const uint32_t* buf, uint8_t* s_b) {
  if (!a.out_vec) {
    store_bytes(a, row0, col0, nt, n_rows, buf);
    return;
  }
  for (int e = threadIdx.x; e < nt * PIECES; e += PT) {
    const int t = e / PIECES, r = BR * (e - t * PIECES);
    const uint32_t bits = buf[t * OS + r / 32] >> (r % 32);
    uint32_t v[BR / 4];
#pragma unroll
    for (int j = 0; j < BR / 4; ++j) v[j] = nibble_bytes(bits >> (4 * j) & 0xfu);
#pragma unroll
    for (int j = 0; j < BR / 4; ++j)
      reinterpret_cast<uint32_t*>(s_b + t * PT + r)[j] = v[j];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  uint8_t* out = reinterpret_cast<uint8_t*>(a.out);
  for (int t = threadIdx.x; t < nt; t += PT) {
    const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(s_b + t * PT));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(out + (row0 + t) * a.out_w + col0), "r"(src), "r"(n_rows)
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  __syncthreads();
}

"""


def bulk_source(text):
    """packed_match.cu with the bulk variant's matrix stores."""
    for old, new in (
        ("template <int FORM>\n__global__", BULK_STORE + "template <int FORM>\n__global__"),
        ("sizeof(int) * (size_t(TT) * L + size_t(TT) * OS);",
         "sizeof(int) * (size_t(TT) * L + size_t(TT) * OS) + size_t(TT) * PT;"),
        ("store_bytes(a, t_dst + t0, r0, nt, n_rows, s_out);",
         "store_bytes_bulk(a, t_dst + t0, r0, nt, n_rows, s_out, "
         "reinterpret_cast<uint8_t*>(s_out + TT * OS));"),
    ):
        if text.count(old) != 1:
            raise ValueError(f"bulk: no single {old!r} in packed_match.cu")
        text = text.replace(old, new)
    return text


def parse(specs):
    """NAME=CONST:VALUE,CONST:VALUE -> {NAME: {CONST: VALUE}}."""
    out = {}
    for spec in specs:
        name, _, body = spec.partition("=")
        out[name] = {k: int(v) for k, v in (kv.split(":") for kv in body.split(","))}
    return out


def build(variants, nvcc, flags):
    """Compile every variant in parallel; returns {name: ctypes library}."""
    src = (CSRC / "packed_match.cu").read_text()
    procs = {}
    for name, consts in variants.items():
        d = ROOT / "build" / "var" / name
        d.mkdir(parents=True, exist_ok=True)
        text = bulk_source(src) if name == "bulk" else src
        for k, v in consts.items():
            text, n = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};", text)
            if n != 1:
                raise ValueError(f"{name}: no constant {k}")
        (d / "packed_match.cu").write_text(text)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "packed_match.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        print(f"variant {name} {variants[name]}: registers {registers(log)}", flush=True)
        libs[name] = ctypes.CDLL(str(ROOT / "build" / "var" / name / "lib.so"))
    return libs


FORMS = {"ILi0E": "bitmap", "ILi1E": "counts", "ILi2E": "matrix"}


def registers(log):
    """-Xptxas -v's registers of each form of packed_pass: {form: n}."""
    out = {}
    for fn, regs in re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                               log, re.S):
        for key, form in FORMS.items():
            if "packed_pass" in fn and key in fn:
                out[form] = int(regs)
    return out


class Entry:
    """A variant's C entry, called as the wrapper calls CudaKernel."""

    def __init__(self, lib, symbol, argtypes):
        self.fn = getattr(lib, symbol)
        self.fn.argtypes = argtypes
        self.fn.restype = ctypes.c_int

    def __call__(self, *args):
        rc = self.fn(*args)
        if rc:
            raise RuntimeError(f"CUDA error {rc} at launch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("packed_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops import match as M

    variants = parse(args.variants) if args.variants else VARIANTS
    libs = build({"this": {}, **variants}, _build.nvcc_path(), _build.NVCC_FLAGS)
    del libs["this"]  # built for its registers; timed through the wrappers
    _build.build_all()
    entries = {name: (Entry(lib, "emqx_match_packed", M._PACKED_ARGTYPES),
                      Entry(lib, "emqx_match_counts", M._PACKED_ARGTYPES),
                      Entry(lib, "emqx_match_dense", M._DENSE_ARGTYPES))
               for name, lib in libs.items()}

    dev = torch.device("cuda", torch.cuda.current_device())
    mods = {m: importlib.import_module(f"emqx_tpu_torch.{m}") for m in (
        "models.router", "ops.match", "parallel.mesh", "parallel.sharded_match")}
    _snap, _enc, f, t, (mesh, fm, tm), (want10, want13) = C.forms_inputs(mods, dev)
    b, n = int(t.ids.shape[0]), int(f.words.shape[0])
    S = mods["parallel.sharded_match"]
    counts_k, packed_k, _apply = S.make_sharded_kernels(mesh)
    tiles = mesh.tile_table(0)
    want11 = M.match_counts_ref(f, t)
    small = M.EncodedTopics(*(x[:C.DENSE_B] for x in t))
    want9 = M.match_dense_ref(f, small)

    def k9(entry):
        def fn():
            out = torch.empty((C.DENSE_B, n), dtype=torch.bool, device=dev)
            entry(*M._forms_args(f, small, n, C.DENSE_B), out.data_ptr(), _build.raw_stream(dev))
            return out
        return fn

    want13c = torch.zeros(b, dtype=torch.int32, device=dev)
    S.dense_tiles_ref(M.FORM_COUNTS, fm, tm, S._tiles(mesh, 0), n // 4, b // 2, want13c)

    def k10(entry):
        def fn():
            out = torch.empty((b, n // 32), dtype=torch.uint32, device=dev)
            M.launch_packed(entry, f, t, n, b, None, 1, out, n // 32)
            return out
        return fn

    def k13(entry):
        def fn():
            out = torch.empty((b, n // 32), dtype=torch.uint32, device=dev)
            M.launch_packed(entry, fm, tm, n // 4, b // 2, tiles, 8, out, n // 32)
            return out
        return fn

    def k11(entry):
        def fn():
            out = torch.empty(b, dtype=torch.int32, device=dev)
            M.launch_packed(entry, f, t, n, b, None, 1, out, b)
            return out
        return fn

    def k13c(entry):
        def fn():
            out = torch.empty(b, dtype=torch.int32, device=dev)
            M.launch_packed(entry, fm, tm, n // 4, b // 2, tiles, 8, out, b)
            return out
        return fn

    # name: (this tree's wrapper, a variant's call, the entry's mode, want)
    cases = {
        f"K9, B={C.DENSE_B} over {n} rows": (lambda: M.match_dense(f, small), k9, 2, want9),
        f"K10, B={b} over {n} rows": (lambda: M.match_packed(f, t), k10, 0, want10),
        f"K13 packed, (2, 4) on one card, B={b}": (lambda: packed_k((fm,), (tm,)), k13, 0,
                                                    want13),
        f"K11, B={b} over {n} rows": (lambda: M.match_counts(f, t), k11, 1, want11),
        f"K13 counts, (2, 4) on one card, B={b}": (lambda: counts_k((fm,), (tm,)), k13c, 1,
                                                    want13c),
    }
    for name, (this, make, mode, want) in cases.items():
        fns = {"this": this, **{v: make(e[mode]) for v, e in entries.items()}}
        for fn in fns.values():
            C.max_abs_err([C.u32(fn())], [want])
        times = {k: [] for k in fns}
        for _ in range(args.rounds):
            for k, fn in fns.items():
                times[k].append(C.run_ms(fn))
        for k, v in times.items():
            print(f"{name} {k}: device_ms {[round(d, 6) for d, _ in v]} "
                  f"enqueue_ms {[round(e, 6) for _, e in v]}", flush=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
