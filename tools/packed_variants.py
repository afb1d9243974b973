#!/usr/bin/env python3
"""Time variants of the packed_match.cu kernel (K10, K13 packed, K11, K13
counts) on one card.

    python3 tools/packed_variants.py [--rounds N] [NAME=CONST:VALUE[,CONST:VALUE] ...]

Each variant is `emqx_tpu_torch/ops/csrc/packed_match.cu` with some of
its `constexpr int` constants (PT, TT, TG, MIN_BLOCKS) changed, built
with nvcc for sm_90a into `build/var/NAME/` (in parallel, with
`-Xptxas -v`) and loaded with ctypes beside this tree's own kernel.
The registers of both modes of `packed_pass` (the bitmap and the
counts) are printed for every variant and for this tree's source
(`this`). On phase 9's full-width inputs (`chip_smoke.forms_inputs`: a
2,097,152-row table and 1,024 topics, seed 3, as `tools/wrapper_ab.py`
times them) every variant is first held equal to the plain version,
then K10 and K11 (one tile) and K13 packed and counts (the eight tiles
of a (2, 4) mesh on the card) are timed with `chip_smoke.run_ms` in
turns, this tree's kernel first in every round; a variant's counts
launch includes its entry's zero fill, as the wrappers' do. Prints one
line a kernel and variant (device_ms, enqueue_ms a round), then the
card's name and power limit. With no NAME given, VARIANTS.
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
    "tt128": {"TT": 128},
    "tt64": {"TT": 64},
    "tt512": {"TT": 512},
    "tg16": {"TG": 16},
    "pt128": {"PT": 128, "MIN_BLOCKS": 8},
    "pt512": {"PT": 512, "MIN_BLOCKS": 2},
    "min5": {"MIN_BLOCKS": 5},
    "min6": {"MIN_BLOCKS": 6},
}


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
        text = src
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


def registers(log):
    """-Xptxas -v's registers of each mode of packed_pass: {mode: n}."""
    out = {}
    for fn, regs in re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                               log, re.S):
        if "packed_pass" in fn:
            out["counts" if "ILb1E" in fn else "bitmap"] = int(regs)
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
                      Entry(lib, "emqx_match_counts", M._PACKED_ARGTYPES))
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
