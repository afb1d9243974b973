"""The port's CSR destination table and its kernels (emqx_tpu_torch.
ops.fanout) held against emqx_tpu.ops.fanout on the same seeded inputs:
the plain versions of K5 `resolve_fanout` and of the fused K6/K7 sync
(`fanout_sync`, and `scatter_segs`/`scatter_edges` at the reference's
batches) against the JAX programs, exactly; the DestStore's arrays
after one operation sequence; the device mirror's sync; and the K12
probe plus the transfer-chunk cap it feeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.models import router as JR
from emqx_tpu.ops import fanout as JF
from emqx_tpu.ops import transfer as JT
from emqx_tpu_torch.convert import fanout_state_from_numpy
from emqx_tpu_torch.device import to_device
from emqx_tpu_torch.models import router as TR
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import fanout as TF
from emqx_tpu_torch.ops import transfer as TT
from emqx_tpu_torch.ops.table import pad_pow2_batches

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side in worker processes; keep
    torch's CPU ops to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return to_device(np.asarray(a), CPU)


# --- random CSR states -------------------------------------------------------


def _random_state(rng, n_rows, n_clients, max_len, exact_fan=None):
    """A consistent CSR state: each row's segment is a contiguous run
    of the edge pool (with gaps between runs), edges mix live clients
    (QoS 0-2, repeats across rows, so ties), tombstones, shared legs
    (client -1 + SHARED_BIT) and SKIP edges; some rows are empty. With
    `exact_fan`, the matched rows' lengths are forced to sum to it."""
    lens = rng.integers(0, max_len + 1, n_rows)
    lens[rng.random(n_rows) < 0.2] = 0
    offs = np.zeros(n_rows, np.int64)
    pos = 0
    for r in range(n_rows):
        pos += int(rng.integers(0, 4))  # free gap
        offs[r] = pos
        pos += int(lens[r])
    n_edges = pos + 8
    client = rng.integers(0, n_clients, n_edges).astype(np.int32)
    opts = rng.integers(0, 3, n_edges).astype(np.int32)
    kind = rng.random(n_edges)
    client[kind < 0.08] = -1  # tombstone
    shared = (kind >= 0.08) & (kind < 0.14)
    client[shared] = -1
    opts[shared] = JF.SHARED_BIT
    skip = (kind >= 0.14) & (kind < 0.22)
    opts[skip] |= JF.SKIP_BIT
    n_match = min(n_rows, int(rng.integers(1, 9)))
    rows = rng.choice(n_rows, n_match, replace=False).astype(np.int32)
    if exact_fan is not None:
        # re-lay the matched rows so their fan is exactly exact_fan
        per = np.full(n_match, exact_fan // n_match)
        per[: exact_fan % n_match] += 1
        base = n_edges
        for r, ln in zip(rows, per):
            offs[r] = base
            lens[r] = ln
            base += int(ln)
        extra = base - n_edges
        client = np.concatenate(
            [client, rng.integers(0, n_clients, extra).astype(np.int32)]
        )
        opts = np.concatenate([opts, rng.integers(0, 3, extra).astype(np.int32)])
    m = 1 << max(2, (n_match - 1).bit_length())
    rows_p = np.full(m, -1, np.int32)
    rows_p[:n_match] = rows
    return (
        offs.astype(np.int32), lens.astype(np.int32), client, opts, rows_p,
        int(lens[rows].sum()),
    )


# (seed, n_rows, n_clients, max_len, exact_fan): wide/sparse clients,
# few clients (QoS ties everywhere), a fan exactly at its max_fan bucket
CASES = [
    (0, 32, 64, 12, None),
    (1, 64, 8, 20, None),
    (2, 16, 256, 40, None),
    (3, 48, 16, 10, 96),
    (4, 24, 32, 30, 128),
]


@pytest.mark.parametrize("seed,n_rows,n_clients,max_len,exact_fan", CASES)
def test_resolve_fanout_equals_reference(seed, n_rows, n_clients, max_len, exact_fan):
    rng = np.random.default_rng(seed)
    seg_off, seg_len, client, opts, rows, fan = _random_state(
        rng, n_rows, n_clients, max_len, exact_fan
    )
    max_fan = JF.fan_bucket(max(fan, 64))
    if exact_fan is not None:
        assert fan == max_fan  # the fan fills its bucket exactly
    assert TF.fan_bucket(max(fan, 64)) == max_fan
    j_out, j_n, j_total = JF.resolve_fanout(
        jnp.asarray(seg_off), jnp.asarray(seg_len), jnp.asarray(client),
        jnp.asarray(opts), jnp.asarray(rows),
        n_clients=n_clients, max_fan=max_fan,
    )
    st = fanout_state_from_numpy(seg_off, seg_len, client, opts, "cpu")
    t_out, t_n, t_total = TF.resolve_fanout(
        *st, _t(rows), n_clients=n_clients, max_fan=max_fan
    )
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert int(t_n) == int(j_n) and int(t_total) == int(j_total) == fan
    # the plan is a dedup: every surviving client once, max QoS
    win = t_out.numpy()[t_out.numpy() >= 0]
    assert len(set(client[win].tolist())) == len(win) == int(t_n)


def test_resolve_fanout_sequence_on_one_scratch_equals_reference():
    """K5's persistent tables: 24 seeded calls on one FanoutScratch, the
    clients shared across calls (every call sees stale keys of earlier
    epochs for the same clients), the client count growing (the scratch
    then grows and starts cleared, as FanoutDeviceState grows it), and
    the epoch forced to its last value (the next call clears the tables
    and restarts at epoch 1). Every call equals the reference program."""
    rng = np.random.default_rng(11)
    schedule = [16] * 8 + [48] * 8 + [200] * 8
    scratch = None
    clears = []
    for k, n_clients in enumerate(schedule):
        seg_off, seg_len, client, opts, rows, fan = _random_state(
            rng, 40, n_clients, 16
        )
        max_fan = JF.fan_bucket(max(fan, 64))
        if scratch is None or scratch.capacity < n_clients:
            scratch = TF.FanoutScratch(1 << (n_clients - 1).bit_length(), CPU)
        if k == 12:
            scratch.epoch = TF.EPOCH_LIMIT - 1
        epoch, clear = scratch.next_epoch()
        if clear:
            clears.append(k)
        j_out, j_n, j_total = JF.resolve_fanout(
            jnp.asarray(seg_off), jnp.asarray(seg_len), jnp.asarray(client),
            jnp.asarray(opts), jnp.asarray(rows),
            n_clients=n_clients, max_fan=max_fan,
        )
        st = fanout_state_from_numpy(seg_off, seg_len, client, opts, "cpu")
        t_out, t_n, t_total = TF.resolve_fanout(
            *st, _t(rows), n_clients=n_clients, max_fan=max_fan, scratch=scratch
        )
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out), err_msg=f"call {k}")
        assert int(t_n) == int(j_n) and int(t_total) == int(j_total) == fan
        assert scratch.epoch == epoch
        if k == 12:
            assert epoch == TF.EPOCH_LIMIT and not clear
    # fresh at 0, grown at 8 and 16, the wrap at 13
    assert clears == [0, 8, 13, 16]


def test_resolve_fanout_refuses_a_scratch_too_small():
    rng = np.random.default_rng(3)
    seg_off, seg_len, client, opts, rows, fan = _random_state(rng, 16, 64, 8)
    st = fanout_state_from_numpy(seg_off, seg_len, client, opts, "cpu")
    scratch = TF.FanoutScratch(32, CPU)
    with pytest.raises(ValueError, match="exceeds the scratch"):
        TF.resolve_fanout(*st, _t(rows), n_clients=64, max_fan=64, scratch=scratch)
    assert scratch.epoch == 0


@pytest.mark.parametrize("seed,n_ids", [(0, 7), (1, 1500)])
def test_scatter_segs_and_edges_equal_reference(seed, n_ids):
    rng = np.random.default_rng(seed)
    n = 4096
    a0 = rng.integers(-5, 1000, n).astype(np.int32)
    b0 = rng.integers(-5, 1000, n).astype(np.int32)
    ids = np.unique(rng.integers(0, n, n_ids).astype(np.int32))
    # one id past the end: JAX drops it, the port must too
    ids = np.concatenate([ids, np.int32([n + 3])])
    idx = pad_pow2_batches(ids, TF.SYNC_BATCH)
    va = rng.integers(0, 1 << 20, idx.shape).astype(np.int32)
    vb = rng.integers(0, 1 << 20, idx.shape).astype(np.int32)
    # padding repeats the last id with the same values (host discipline)
    last = len(ids) - 1
    flat_a, flat_b = va.reshape(-1), vb.reshape(-1)
    flat_a[last:] = flat_a[last]
    flat_b[last:] = flat_b[last]
    for t_fn, j_fn in ((TF.scatter_segs, JF._scatter_segs),
                       (TF.scatter_edges, JF._scatter_edges)):
        ja, jb = j_fn(jnp.asarray(a0), jnp.asarray(b0), jnp.asarray(idx),
                      jnp.asarray(va), jnp.asarray(vb))
        ta, tb = _t(a0), _t(b0)
        t_fn(ta, tb, _t(idx), _t(va), _t(vb))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# (n_rows, n_edges, ids past the end): rows only, edges only, both; one
# entry a side, one batch, one past a batch, three batches; ids past the
# tables' ends, which the reference drops
SYNC_CASES = [
    (40, 0, 0), (0, 40, 0), (30, 50, 0), (1, 1, 0), (1024, 1024, 0),
    (1025, 1025, 0), (3000, 3000, 0), (20, 30, 2),
]


@pytest.mark.parametrize("n_rows,n_edges,past", SYNC_CASES)
def test_fanout_sync_ref_equals_reference(n_rows, n_edges, past):
    """The fused sync's plain version, from one unpadded staged buffer,
    against the reference's `_scatter_segs` + `_scatter_edges` on the
    same ids padded by pad_pow2_batches, as the mirror sync stages them."""
    rng = np.random.default_rng(n_rows * 7 + n_edges + past)
    n_cap, e_cap = 4096, 8192
    dev0 = [rng.integers(-5, 1000, n).astype(np.int32)
            for n in (n_cap, n_cap, e_cap, e_cap)]
    # host truth, with room past the device tables for the ids past them
    host = [rng.integers(-1, 1 << 20, n + 16).astype(np.int32)
            for n in (n_cap, n_cap, e_cap, e_cap)]

    def ids(n, cap):
        got = rng.choice(cap, n - past if n else 0, replace=False)
        extra = cap + rng.choice(16, past if n else 0, replace=False)
        return np.sort(np.concatenate([got, extra])).astype(np.int32)

    rows, edges = ids(n_rows, n_cap), ids(n_edges, e_cap)
    want = [jnp.asarray(a) for a in dev0]
    for k, (sel, fn) in enumerate(((rows, JF._scatter_segs), (edges, JF._scatter_edges))):
        if len(sel):
            idx = pad_pow2_batches(sel, TF.SYNC_BATCH)
            want[2 * k], want[2 * k + 1] = fn(
                want[2 * k], want[2 * k + 1], jnp.asarray(idx),
                jnp.asarray(host[2 * k][idx]), jnp.asarray(host[2 * k + 1][idx]))
    staged = TF.stage_delta(rows, edges, *host, CPU)
    assert staged.shape == (3 * (len(rows) + len(edges)),)  # no padding
    got = [_t(a) for a in dev0]
    TF.fanout_sync_ref(*got, staged, len(rows), len(edges))
    via_wrapper = [_t(a) for a in dev0]
    TF.fanout_sync(*via_wrapper, staged, len(rows), len(edges))
    for g, v, w in zip(got, via_wrapper, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))


# --- the DestStore and its device mirror ---------------------------------------


class _Opts:
    def __init__(self, qos, nl=False, rap=False, rh=0):
        self.qos = qos
        self.no_local = nl
        self.retain_as_published = rap
        self.retain_handling = rh


def _drive(store, rng_seed, sess):
    """One seeded op sequence over a DestStore: appends past segment
    capacity (relocation), tombstones past the compaction threshold,
    option upgrades, a pending-row rebuild, row frees and reuse, client
    registry growth and session notes."""
    rng = np.random.default_rng(rng_seed)
    store.ensure_rows(64)
    live = {r: [] for r in range(48)}
    # one hot row: 80 appends, then tombstones until it compacts
    for i in range(80):
        store.add(0, f"h{i}", JF.SKIP_BIT, "f0")
    for i in range(70):
        store.remove(0, f"h{i}")
    live[0] = [f"h{i}" for i in range(70, 80)]
    for step in range(900):
        r = int(rng.integers(0, 48))
        op = rng.random()
        if op < 0.55:
            if rng.random() < 0.1:
                d = ("$group", f"g{r}", f"f{r}")
                store.add(r, d, JF.SHARED_BIT, f"f{r}")
            else:
                d = f"c{int(rng.integers(0, 1500))}"
                store.add(r, d, JF.SKIP_BIT, f"f{r}")
            if d not in live[r]:
                live[r].append(d)
        elif op < 0.8 and live[r]:
            d = live[r].pop(int(rng.integers(0, len(live[r]))))
            store.remove(r, d)
        elif op < 0.92 and live[r]:
            d = live[r][int(rng.integers(0, len(live[r])))]
            if isinstance(d, str):
                store.set_opts(r, d, _Opts(int(rng.integers(0, 3)),
                                           bool(rng.random() < 0.2)), sess)
        elif op < 0.95:
            store.pending_rows.add(r)
            store.set_row(
                r, f"f{r}", dict.fromkeys(live[r], 1),
                lambda f, d: (_Opts(1, rap=True), sess) if d.endswith("7") else None,
            )
            store.pending_rows.discard(r)
        elif op < 0.98:
            store.free_row(r)
            live[r] = []
        else:
            for x in rng.integers(0, 48, 3):
                store.free_row(int(x))
                live[int(x)] = []
        if step % 97 == 0:
            store.note_session(f"c{int(rng.integers(0, 1500))}", None)


def test_dest_store_arrays_equal_reference():
    js = JF.DestStore(edge_capacity=64, row_capacity=16, client_capacity=16)
    ts = TF.DestStore(edge_capacity=64, row_capacity=16, client_capacity=16)
    _drive(js, 7, None)
    _drive(ts, 7, None)
    for name in ("seg_off", "seg_len", "seg_cap", "seg_live",
                 "edge_client", "edge_opts", "client_alive", "client_mem"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name), name)
    assert ts.edge_dest == js.edge_dest
    assert ts.edge_flt == js.edge_flt
    assert ts.client_row == js.client_row
    assert ts._free_segs == js._free_segs and ts._end == js._end
    assert sorted(set(ts.dirty_rows)) == sorted(set(js.dirty_rows))
    assert sorted(set(ts.dirty_edges)) == sorted(set(js.dirty_edges))
    assert js.edge_capacity > 64 and js.row_capacity == 64  # grew
    assert ts.seg_len[0] < 80  # the hot row compacted
    assert js.stats() == ts.stats()


def test_device_mirror_syncs_to_host_truth():
    """Full upload, then fused K6/K7 delta syncs after churn, then growth's
    re-upload: the mirror equals the host arrays after every sync, and a
    begun resolve keeps the tensors it read."""
    ts = TF.DestStore(edge_capacity=64, row_capacity=16, client_capacity=16)
    js = JF.DestStore(edge_capacity=64, row_capacity=16, client_capacity=16)
    tdev = TF.FanoutDeviceState(ts, device="cpu")
    jdev = JF.FanoutDeviceState(js)
    for seed in (1, 2, 3):
        _drive(ts, seed, None)
        _drive(js, seed, None)
        grew = ts.grew
        tdev.sync()
        jdev.sync()
        for t, j in zip(tdev.tensors(), (jdev._seg_off, jdev._seg_len,
                                         jdev._edge_client, jdev._edge_opts)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(tdev.tensors()[0].numpy(), ts.seg_off)
        np.testing.assert_array_equal(tdev.tensors()[2].numpy(), ts.edge_client)
        if not grew:
            assert not ts.dirty_rows and not ts.dirty_edges
    rows = [r for r in range(48) if ts.seg_len[r]][:5]
    h = tdev.resolve_begin(rows, ts.fan_of(rows))
    kept = h[3]
    ts._grow_edges(ts.edge_capacity * 2)
    tdev.sync()  # growth: new tensors; the handle still holds the old
    assert kept[2].shape[0] * 2 == tdev.tensors()[2].shape[0]
    win, fan = tdev.resolve_finish(h)
    jh = jdev.resolve_begin(rows, js.fan_of(rows))
    jwin, jfan = jdev.resolve_finish(jh)
    np.testing.assert_array_equal(win, jwin)
    assert fan == jfan


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_fanout_sync_refuses_negative_counts(device):
    """A negative count would point the edge columns before the staged
    buffer; the wrapper refuses it on either path."""
    z = [torch.zeros(n, dtype=torch.int32, device=device) for n in (8, 8, 16, 16, 9)]
    with pytest.raises(ValueError, match="negative"):
        TF.fanout_sync(*z, -1, 4)


def test_delta_syncs_launch_once_and_equal_reference(monkeypatch):
    """Three churn rounds with no pool growth: each sync is one call of
    the fused wrapper and leaves the mirror equal to the reference
    mirror and to the host arrays; a sync with nothing dirty calls no
    wrapper."""
    calls = []
    real = TF.fanout_sync

    def counted(*a):
        calls.append(a[-2:])
        real(*a)

    monkeypatch.setattr(TF, "fanout_sync", counted)
    caps = dict(edge_capacity=1 << 14, row_capacity=64, client_capacity=2048)
    ts, js = TF.DestStore(**caps), JF.DestStore(**caps)
    tdev = TF.FanoutDeviceState(ts, device="cpu")
    jdev = JF.FanoutDeviceState(js)
    tdev.sync()  # the first sync is a full upload
    jdev.sync()
    assert calls == []
    for seed in (1, 2, 3):
        _drive(ts, seed, None)
        _drive(js, seed, None)
        assert not ts.grew and ts.dirty_rows and ts.dirty_edges
        n_r, n_e = len(set(ts.dirty_rows)), len(set(ts.dirty_edges))
        assert tdev.sync() == jdev.sync() == n_r + n_e
        assert calls.pop() == (n_r, n_e) and calls == []
        for t, j, h in zip(tdev.tensors(), (jdev._seg_off, jdev._seg_len,
                                            jdev._edge_client, jdev._edge_opts),
                           (ts.seg_off, ts.seg_len, ts.edge_client, ts.edge_opts)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            np.testing.assert_array_equal(t.numpy(), h)
    assert tdev.sync() == 0 and calls == []


# --- K12 and the transfer-chunk cap -----------------------------------------------


def test_probe_link_and_chunk_cap_equal_reference():
    x = torch.tensor([0.5, -2.0], dtype=torch.float32)
    assert TT.add_one(x).tolist() == [1.5, -1.0]
    buf = torch.arange(5, dtype=torch.int32)
    assert TT.add_one(buf).tolist() == [1, 2, 3, 4, 5]
    rtt, bw = TT.probe_link("cpu", probes=2)
    assert rtt > 0 and bw > 0
    kb = TT.auto_chunk_kb(rtt, bw)
    assert kb == JT.auto_chunk_kb(rtt, bw)
    jt = JR.DeviceTable(JR.FilterTable(max_levels=4))
    tt = TR.DeviceTable(TR.FilterTable(max_levels=4), device="cpu")
    for chunk_kb in (0, 8, 64, 300, 4096):
        jt.transfer_chunk_hits = JT.chunk_hits(chunk_kb)
        tt.transfer_chunk_hits = TT.chunk_hits(chunk_kb)
        assert tt.transfer_chunk_hits == jt.transfer_chunk_hits
        for mh in (1024, 4096, 8192, 65536, 1 << 20):
            assert tt._cap_hits(mh) == jt._cap_hits(mh), (chunk_kb, mh)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n,off", [(1, 0), ((1 << 18) + 3, 0), ((1 << 18) + 3, 1)])
def test_add_one_plain_equals_reference(dtype, n, off):
    """K12's plain version against the reference's `x + 1` in int32 and
    float32: the scalar, an odd length (2^18 + 3) and the same from a
    view one element in."""
    x = np.random.default_rng(n + off).uniform(-1e6, 1e6, n + off).astype(dtype)
    got = TT.add_one(torch.from_numpy(x)[off:])
    want = np.asarray(jnp.asarray(x[off:]) + 1)
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), want)


# --- a failed build is never replaced by a plain version ---------------------------


def _failing_nvcc(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # non-CPU tensors take the kernel path; meta tensors stand in for
    # CUDA ones, with a stand-in stream
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda _d=None: type("S", (), {"cuda_stream": 0})(),
    )


@pytest.mark.parametrize(
    "which", ["resolve_fanout", "scatter_segs", "fanout_sync", "probe_add_one"])
def test_failed_kernel_build_raises_without_plain_fallback(which, monkeypatch, tmp_path):
    _failing_nvcc(monkeypatch, tmp_path)
    # scatter_segs is the fused sync's kernel with no edges
    k = _build.KERNELS["fanout_sync" if which == "scatter_segs" else which]
    monkeypatch.setattr(k, "_fn", None)

    def _never(*_a, **_k):
        raise AssertionError("plain version ran in place of the kernel")

    for name in ("resolve_fanout_ref", "scatter_cols_ref", "fanout_sync_ref"):
        monkeypatch.setattr(TF, name, _never)
    monkeypatch.setattr(TT, "add_one_ref", _never)
    meta = torch.device("meta")

    def z(n):
        return torch.zeros(n, dtype=torch.int32, device=meta)

    with pytest.raises(_build.KernelBuildError, match="no sm_90a"):
        if which == "resolve_fanout":
            TF.resolve_fanout(z(8), z(8), z(16), z(16), z(4),
                              n_clients=8, max_fan=64)
        elif which == "scatter_segs":
            TF.scatter_segs(z(8), z(8), z((1, 4)), z((1, 4)), z((1, 4)))
        elif which == "fanout_sync":
            TF.fanout_sync(z(8), z(8), z(16), z(16), z(9), 2, 1)
        else:
            TT.add_one(torch.zeros(4, dtype=torch.float32, device=meta))
    assert k.launches == 0
