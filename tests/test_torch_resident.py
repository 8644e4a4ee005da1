"""The resident rung ladder of the port's device CMVM search, on the CPU.

Between rungs the search state stays on the device (``torch_search``'s
carry and ``_transition``), each finished lane's final digits are fetched
once, and each (O, B) group's emission runs on a background worker. None of
it may change a decision: the resident and the host-state ladders
(``DA4ML_JAX_DEVICE_RESIDENT=0``) give the same programs, op for op, and
both equal the JAX package's ``solve_jax_many``. The host replay
(``_substitute_np``, ``_replay_digits``) equals the JAX package's, and every
finished lane's fetched digits equal the replay of its records. Inputs are
made with numpy from seeds; equality is exact. Narrow integer kernels only:
no test here builds an executor.
"""

import threading

import numpy as np
import pytest

from da4ml_tpu.cmvm import jax_search as js
from da4ml_tpu_torch.cmvm import torch_search as ts
from da4ml_tpu_torch.ir.types import QInterval
from da4ml_tpu_torch.telemetry import metrics as tm

#: the reference's grid-edge shapes (tests/test_bucket_parity.py), whose
#: ladders span several rungs
GRID_EDGES = [(7, 6, 3), (9, 5, 4), (12, 12, 5), (16, 12, 5)]


def random_kernel(rng, n_in, n_out, bits):
    mag = rng.integers(0, 2**bits, (n_in, n_out)).astype(np.float64)
    return mag * rng.choice([-1.0, 1.0], (n_in, n_out))


def ops_sig(p):
    return [[(o.id0, o.id1, o.opcode, o.data, tuple(o.qint), o.latency, o.cost) for o in st.ops] for st in p.stages]


def assert_identical(a, b):
    np.testing.assert_array_equal(np.asarray(a.kernel, np.float64), np.asarray(b.kernel, np.float64))
    assert float(a.cost) == float(b.cost) and ops_sig(a) == ops_sig(b)


def lane(kernel, method='wmc'):
    n = kernel.shape[0]
    return ts._Lane(kernel, [QInterval(-128.0, 127.0, 1.0)] * n, [0.0] * n, method)


def assert_replayed(finished):
    """Every finished lane's fetched digits equal the replay of its records
    from its last host state, and nothing lies above its last slot."""
    assert finished
    for E0, rec, n_applied, n_in_max, cur, O, B, E in finished:
        want = ts._replay_digits(E0, rec, n_applied, n_in_max, cur, O, B)
        assert np.array_equal(E[:cur], want[:cur]) and not E[cur:].any() and not want[cur:].any()


@pytest.fixture
def metrics():
    """Metrics on and empty for the test; the registry and the switch as
    they were afterwards."""
    was = tm.metrics_on()
    tm.enable_metrics()
    tm.reset_metrics()
    yield
    tm.reset_metrics()
    if not was:
        tm.disable_metrics()


@pytest.fixture
def jax_metrics_off():
    """The JAX package's metrics off for the test (another test may have left
    them on; its solve would then count compiles into that registry), as
    they were afterwards."""
    from da4ml_tpu.telemetry import metrics as jm

    was = jm.metrics_on()
    jm.disable_metrics()
    yield
    if was:
        jm.enable_metrics()


def value(snap, name):
    return snap.get(name, {}).get('value', 0)


def solve_both(monkeypatch, kernels, **kw):
    """(resident, host-state) solves of one batch, the switch by its
    environment variable, with each solve's finished lanes."""
    out = []
    for flag in ('1', '0'):
        monkeypatch.setenv('DA4ML_JAX_DEVICE_RESIDENT', flag)
        with ts.record_finished() as finished:
            out.append((ts.solve_torch_many(kernels, device='cpu', **kw), finished))
    monkeypatch.delenv('DA4ML_JAX_DEVICE_RESIDENT')
    return out


# ---------------------------------------------------------------------------
# the host replay, the oracle
# ---------------------------------------------------------------------------


def random_records(rng, n_in_max: int, n_rec: int, B: int) -> np.ndarray:
    """Records in device slot space: record t creates slot n_in_max + t from
    two earlier slots; a third of them same-row (i == j) pairs, the others in
    either operand order (negative shifts)."""
    rec = np.zeros((n_rec, 4), np.int32)
    for t in range(n_rec):
        slots = np.r_[np.arange(n_in_max), n_in_max + np.arange(t)]
        i = int(rng.choice(slots))
        j = i if rng.random() < 1 / 3 else int(rng.choice(slots))
        s = int(rng.integers(1 if i == j else 0, B))
        rec[t] = (min(i, j), max(i, j), int(rng.integers(0, 2)), s if i < j else -s)
    return rec


@pytest.mark.parametrize('seed,n_in_max,O,B,n_rec,d', [(0, 8, 4, 6, 12, 0), (1, 16, 8, 5, 30, 4), (2, 4, 3, 8, 20, 7),
                                                       (3, 32, 2, 4, 40, 1)])  # fmt: skip
def test_replay_equals_the_reference(seed, n_in_max, O, B, n_rec, d):
    """The port's ``_substitute_np`` and ``_replay_digits`` equal the JAX
    package's on random trit digits and records, i == j chains and negative
    shifts among them, from slot 0 and from a prefix of ``d`` records."""
    rng = np.random.default_rng(seed)
    E0 = np.zeros((n_in_max, O, B), np.int8)
    E0[:] = rng.choice([-1, 0, 0, 1], size=E0.shape)
    E0[0, :, :] = 1  # a run of equal digits: same-row chains
    rec = random_records(rng, n_in_max, n_rec, B)
    assert (rec[:, 0] == rec[:, 1]).any() and (rec[:, 3] < 0).any()
    n_slots = n_in_max + n_rec
    want = js._replay_digits(E0, rec, 0, n_in_max, n_slots, O, B)
    assert np.array_equal(ts._replay_digits(E0, rec, 0, n_in_max, n_slots, O, B), want)
    # a prefix start: the state as of record d, then the rest
    E_d = js._replay_digits(E0, rec[:d], 0, n_in_max, n_in_max + d, O, B)
    assert np.array_equal(ts._replay_digits(E_d, rec, d, n_in_max, n_slots, O, B), want)
    # step by step
    Ep = np.zeros_like(want)
    Ep[:n_in_max] = E0
    Ej = Ep.copy()
    for t, (id0, id1, sub, shift) in enumerate(rec.tolist()):
        i, j, s = (id0, id1, shift) if shift >= 0 else (id1, id0, -shift)
        Ep[n_in_max + t] = ts._substitute_np(Ep, sub, s, i, j)
        Ej[n_in_max + t] = js._substitute_np(Ej, sub, s, i, j)
        assert np.array_equal(Ep, Ej), t
    assert np.array_equal(Ep, want)


# ---------------------------------------------------------------------------
# resident against host-state against the JAX package
# ---------------------------------------------------------------------------


def test_resident_equals_host_state_and_jax(rng, monkeypatch, jax_metrics_off):
    """Resident == host-state op for op on the grid-edge shapes, and both
    equal the JAX package's ``solve_jax_many``; every finished lane's
    fetched digits equal the replay of its records, in both ladders."""
    kernels = [random_kernel(rng, *s) for s in GRID_EDGES]
    (resident, fin_r), (host, fin_h) = solve_both(monkeypatch, kernels)
    ref = js.solve_jax_many(kernels)
    for k, r, h, j in zip(kernels, resident, host, ref):
        np.testing.assert_array_equal(np.asarray(r.kernel, np.float64), k)
        assert_identical(r, h)
        assert float(r.cost) == float(j.cost)
        assert [[(o.id0, o.id1, o.opcode, o.data) for o in st.ops] for st in r.stages] == [
            [(o.id0, o.id1, o.opcode, o.data) for o in st.ops] for st in j.stages
        ]
    assert_replayed(fin_r)
    assert_replayed(fin_h)
    assert sorted(f[4] for f in fin_r) == sorted(f[4] for f in fin_h)


def test_resident_traffic_and_metrics(rng, monkeypatch, metrics):
    """A multi-rung lane chains on the device: the resident solve counts
    ``sched.device_resident_rungs`` (0 on the host-state one), uploads under
    half the host-state bytes and fetches fewer, at the same program."""
    kernel = random_kernel(rng, 16, 12, 5)
    snaps, sols = [], []
    for flag in ('1', '0'):
        monkeypatch.setenv('DA4ML_JAX_DEVICE_RESIDENT', flag)
        tm.reset_metrics()
        sols.append(ts.solve_torch_many([kernel], device='cpu')[0])
        snaps.append(tm.metrics_snapshot())
    assert_identical(*sols)
    res, host = snaps
    assert value(res, 'sched.device_resident_rungs') > 0 and value(host, 'sched.device_resident_rungs') == 0
    assert value(res, 'sched.rungs') == value(host, 'sched.rungs')
    assert value(res, 'sched.upload_bytes') < value(host, 'sched.upload_bytes') / 2
    assert value(res, 'sched.fetch_bytes') < value(host, 'sched.fetch_bytes')


@pytest.mark.parametrize('flag', [None, '1', '0', 'false', 'off', 'yes'])
def test_the_switches_read_as_the_reference_reads_them(monkeypatch, flag):
    """``DA4ML_JAX_DEVICE_RESIDENT`` and ``DA4ML_JAX_ASYNC_EMIT``: unset or
    any other value on, ``0``/``false``/``off`` off, as the JAX package
    reads them."""
    for name in ('DA4ML_JAX_DEVICE_RESIDENT', 'DA4ML_JAX_ASYNC_EMIT'):
        if flag is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, flag)
    on = flag not in ('0', 'false', 'off')
    assert ts._device_resident_enabled() == js._device_resident_enabled() == on
    assert ts._async_emit_enabled() == on


def test_prefix_lanes_resident_equals_host_state(rng, monkeypatch):
    """Beam-fork lanes (decision prefixes, full-capacity records) at
    ``quality='search'``: resident == host-state; the replay of a prefix
    lane starts after its prefix records."""
    kernels = [random_kernel(rng, 8, 6, 3), random_kernel(rng, 6, 5, 3)]
    (resident, fin_r), (host, fin_h) = solve_both(monkeypatch, kernels, quality='search')
    for r, h in zip(resident, host):
        assert_identical(r, h)
    assert any(f[2] > 0 for f in fin_r), 'no prefix lane finished'
    assert_replayed(fin_r)
    assert_replayed(fin_h)


@pytest.mark.parametrize('budget,spills', [(1, False), (2 << 20, True)])
def test_chunked_rungs_and_the_spill(rng, monkeypatch, budget, spills):
    """A device budget that splits rungs into chunks: with one lane a chunk
    the carry is never kept across a chunked rung; with a budget that keeps
    the first rungs whole and splits a later one, the carry spills to host
    state first. Both equal the host-state ladder op for op."""
    kernels = [random_kernel(rng, *s) for s in GRID_EDGES]
    kernels = kernels[2:] if spills else kernels
    base = ts.solve_torch_many(kernels, device='cpu')
    monkeypatch.setattr(ts, 'DEVICE_BUDGET', budget)
    fetched = []
    real = ts._fetch_carry
    monkeypatch.setattr(ts, '_fetch_carry', lambda outs, pos: fetched.append(len(pos)) or real(outs, pos))
    (resident, fin_r), (host, _) = solve_both(monkeypatch, kernels)
    for b, r, h in zip(base, resident, host):
        assert_identical(r, h)
        assert_identical(r, b)
    assert bool(fetched) == spills, fetched
    assert_replayed(fin_r)


def test_pmax_safety_net_drops_the_carry(monkeypatch):
    """Lanes that fill the last, clamped rung (``PMAX`` slots) finish on the
    host: the carry they leave is dropped, not fetched, and the results
    equal the host-state ladder's."""
    monkeypatch.setattr(ts, 'PMAX', 18)
    rng = np.random.default_rng(0)
    kernels = [rng.integers(0, 4, (9, 2)).astype(np.float64) * rng.choice([-1.0, 1.0], (9, 2)) for _ in range(2)]
    fetched = []
    real = ts._fetch_carry
    monkeypatch.setattr(ts, '_fetch_carry', lambda outs, pos: fetched.append(len(pos)) or real(outs, pos))
    before = ts.search_stats['pmax_host_fallbacks']
    monkeypatch.delenv('DA4ML_JAX_DEVICE_RESIDENT', raising=False)
    resident = ts.solve_single_lanes([lane(k) for k in kernels], -1, -1, device='cpu')
    assert ts.search_stats['pmax_host_fallbacks'] > before and not fetched
    monkeypatch.setenv('DA4ML_JAX_DEVICE_RESIDENT', '0')
    host = ts.solve_single_lanes([lane(k) for k in kernels], -1, -1, device='cpu')
    for k, r, h in zip(kernels, resident, host):
        r, h = ts._as_comb(r), ts._as_comb(h)
        np.testing.assert_array_equal(np.asarray(r.kernel, np.float64), k)
        assert [(o.id0, o.id1, o.opcode, o.data, tuple(o.qint)) for o in r.ops] == [
            (o.id0, o.id1, o.opcode, o.data, tuple(o.qint)) for o in h.ops
        ]


def test_a_resident_input_on_another_device_raises():
    """No fallback: a rung's resident inputs must lie on its device."""
    import torch

    spec = ts._KernelSpec(16, 8, 2, -1, -1)
    E = torch.zeros((1, 16, 8, 2), dtype=torch.int8)
    args = (E, torch.zeros((1, 16, 3)), torch.zeros((1, 16)), np.full(1, 16, np.int32), np.zeros(1, np.int32))
    out = ts.rung_inputs(*args, spec, device='cpu', copy=False)
    assert out[0] is E  # taken as it is, no defensive copy
    with pytest.raises(ValueError, match='resident input lies on cpu'):
        ts.rung_inputs(*args, spec, device='meta', copy=False)


# ---------------------------------------------------------------------------
# asynchronous emission
# ---------------------------------------------------------------------------


def group_kernels(rng):
    """Kernels of three canonical (O, B) groups."""
    return [random_kernel(rng, 6, 4, 2), random_kernel(rng, 6, 12, 5), random_kernel(rng, 5, 20, 3)]


def test_async_emission_equals_serial(rng, monkeypatch, metrics):
    """Emission on the worker gives the serial programs; it counts one
    ``emit.async_batches`` a group (every solve here has more than one) and
    a wait for each; the worker is the one ``da4ml-emit`` thread."""
    kernels = group_kernels(rng)
    lanes = [lane(k) for k in kernels]
    for ln in lanes:
        ts._prepare_lane(ln)
    n_groups = len({(ts.canon_dim(ln.csd.shape[1], 8), ts.canon_dim(ln.csd.shape[2], 2)) for ln in lanes})
    assert n_groups > 1
    threads = []
    real = ts._emit_group
    monkeypatch.setattr(ts, '_emit_group', lambda *a: threads.append(threading.current_thread().name) or real(*a))
    got = ts.solve_single_lanes([lane(k) for k in kernels], -1, -1, device='cpu')
    snap = tm.metrics_snapshot()
    assert value(snap, 'emit.async_batches') == n_groups and snap['emit.async_wait_s']['count'] == n_groups
    assert len(threads) == n_groups and all(t.startswith('da4ml-emit') for t in threads)
    monkeypatch.setenv('DA4ML_JAX_ASYNC_EMIT', '0')
    tm.reset_metrics()
    threads.clear()
    serial = ts.solve_single_lanes([lane(k) for k in kernels], -1, -1, device='cpu')
    assert value(tm.metrics_snapshot(), 'emit.async_batches') == 0
    assert threads == [threading.current_thread().name] * n_groups
    for g, s in zip(got, serial):
        g, s = ts._as_comb(g), ts._as_comb(s)
        assert [(o.id0, o.id1, o.opcode, o.data, tuple(o.qint)) for o in g.ops] == [
            (o.id0, o.id1, o.opcode, o.data, tuple(o.qint)) for o in s.ops
        ]


def test_one_group_emits_in_series(rng, metrics):
    """A solve of one (O, B) group emits on the calling thread."""
    ts.solve_single_lanes([lane(random_kernel(rng, 6, 4, 2))], -1, -1, device='cpu')
    assert value(tm.metrics_snapshot(), 'emit.async_batches') == 0


def test_an_emission_error_reaches_the_caller(rng, monkeypatch):
    """An exception in the emission worker is raised by the solve, and the
    worker is shut down."""
    real = ts._emit_group
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError('emission failed')
        return real(*a)

    monkeypatch.setattr(ts, '_emit_group', failing)
    with pytest.raises(RuntimeError, match='emission failed'):
        ts.solve_single_lanes([lane(k) for k in group_kernels(rng)], -1, -1, device='cpu')
    assert not [t for t in threading.enumerate() if t.name.startswith('da4ml-emit')]


# ---------------------------------------------------------------------------
# the flagship
# ---------------------------------------------------------------------------


def test_flagship_fast_rung_calls(monkeypatch, metrics):
    """The flagship at ``'fast'`` on the CPU: 19 rung calls, of which the 10
    after the first rung of each of the 9 groups take their state from the
    carry; 6 groups emitted on the worker (the three solves of two groups);
    the JAX package's program."""
    import hashlib

    from da4ml_tpu_torch.entry import flagship_comb
    from test_torch_pipeline import _chip_smoke

    monkeypatch.setattr('da4ml_tpu_torch.entry._FLAGSHIP', {})
    calls = []
    real = ts.cse_rung
    monkeypatch.setattr(ts, 'cse_rung', lambda *a, **k: calls.append(k.get('copy', True)) or real(*a, **k))
    comb = flagship_comb(backend='torch', device='cpu')
    snap = tm.metrics_snapshot()
    assert len(calls) == value(snap, 'sched.rungs') == 19
    assert value(snap, 'sched.device_resident_rungs') == 10 == calls.count(False)
    assert value(snap, 'sched.bucket_groups') == 9 and value(snap, 'emit.async_batches') == 6
    digest = hashlib.sha256(comb.to_binary().astype('<i4').tobytes()).hexdigest()
    assert digest == _chip_smoke().QUALITY_DIGESTS['fast']
