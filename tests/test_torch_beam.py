"""The port's quality search (``quality='search'|'max'|SearchSpec``) against
the JAX package's, on the CPU.

Carried from ``tests/test_beam_search.py``: the presets, the rankers and
``top_candidates`` equal the JAX package's; the port's host beam equals the
JAX package's host beam, and the port's device beam (torch ops, run with
``device='cpu'``) equals both, fork for fork; ``solve_torch_many`` with a
quality equals ``solve_jax_many`` op for op; the trace export, the trainer,
the counters, the host-backend degrade, the tracer's ``solver_options`` and
``convert --quality`` follow the reference; K2's plain version on
full-capacity rung classes equals the JAX package's ``top4`` rung. Inputs
are made with numpy from a seed and handed to both packages; every
comparison is exact.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from da4ml_tpu.cmvm import api as japi
from da4ml_tpu.cmvm import jax_search as js
from da4ml_tpu.cmvm import search as jsearch
from da4ml_tpu.cmvm import heuristics as jheur
from da4ml_tpu.cmvm.search import beam as jbeam
from da4ml_tpu.cmvm.state import create_state as jcreate_state
from da4ml_tpu.cmvm.state import update_state as jupdate_state
from da4ml_tpu.ir import QInterval as JQInterval
from da4ml_tpu_torch.cmvm import api, search, torch_beam
from da4ml_tpu_torch.cmvm import heuristics as theur
from da4ml_tpu_torch.cmvm import torch_search as ts
from da4ml_tpu_torch.cmvm.search import beam as tbeam
from da4ml_tpu_torch.cmvm.state import create_state, update_state
from da4ml_tpu_torch.ir.types import QInterval

ROOT = Path(__file__).resolve().parents[1]
RANKER = ROOT / 'examples' / 'search_traces' / 'ranker.json'


def random_kernel(rng, n_dim, bits, n_out=None):
    n_out = n_dim if n_out is None else n_out
    mag = rng.integers(0, 2**bits, (n_dim, n_out)).astype(np.float64)
    return mag * rng.choice([-1.0, 1.0], (n_dim, n_out))


def ops_sig(p):
    return [[(o.id0, o.id1, o.opcode, o.data) for o in st.ops] for st in p.stages]


def assert_exact(sol, kernel):
    np.testing.assert_array_equal(np.asarray(sol.kernel, np.float64), kernel)


def kernels_of(seed: int):
    """Four kernels of 4-8 inputs and 3 bits: one canonical (O, B) class,
    so the JAX side compiles few programs."""
    rng = np.random.default_rng(seed)
    return [random_kernel(rng, 4, 3), random_kernel(rng, 6, 3), random_kernel(rng, 6, 3, 5), random_kernel(rng, 8, 3, 6)]


# ---------------------------------------------------------------------------
# spec, rankers, heuristics
# ---------------------------------------------------------------------------


def test_presets_and_resolution_equal_reference():
    assert {k: v.to_dict() for k, v in search.QUALITY_PRESETS.items()} == {
        k: v.to_dict() for k, v in jsearch.QUALITY_PRESETS.items()
    }
    for q in (None, 'fast', 'search', 'max', {'beam': 3, 'depth': 2, 'focus': 0}):
        assert search.resolve_quality(q).to_dict() == jsearch.resolve_quality(q).to_dict()
        assert search.resolve_quality(q).is_fast == jsearch.resolve_quality(q).is_fast
    s = search.resolve_quality('search')
    assert search.resolve_quality(s) is s and search.SearchSpec.from_dict(s.to_dict()) == s
    for bad, err in (('bogus', ValueError), (3, TypeError), ({'beam': 2, 'bogus_key': 1}, ValueError)):
        with pytest.raises(err):
            search.resolve_quality(bad)
        with pytest.raises(err):
            jsearch.resolve_quality(bad)
    for kw in ({'beam': 0}, {'portfolio': ('nope',)}, {'depth': -1}, {'n_restarts': 0}, {'ranker': ''}):
        with pytest.raises(ValueError):
            search.SearchSpec(**kw)


@pytest.mark.parametrize(
    'quality',
    [None, 'fast', 'search', 'max', {'beam': 4, 'depth': 1, 'focus': 2}, {'portfolio': ['mc'], 'n_restarts': 2}],
)
def test_quality_key_round_trips(quality):
    key = search.quality_key(quality)
    assert key == jsearch.quality_key(quality)
    if key is None:
        assert search.resolve_quality(quality).is_fast
    else:
        spec = search.SearchSpec.from_dict(key)
        assert search.quality_key(spec) == search.quality_key(spec.to_dict()) == key


def test_learned_ranker_folded_bit_equal():
    got, want = search.LearnedRanker.load(RANKER), jsearch.LearnedRanker.load(RANKER)
    (wg, bg), (ww, bw) = got.folded(), want.folded()
    assert wg.tobytes() == ww.tobytes() and np.float64(bg).tobytes() == np.float64(bw).tobytes()
    X = np.random.default_rng(3).normal(size=(16, len(search.FEATURE_NAMES)))
    assert got.predict(X).tobytes() == want.predict(X).tobytes()
    assert got.to_dict() == want.to_dict()
    assert torch_beam._learned_fold(got)[0].tobytes() == js._learned_fold(want)[0].tobytes()
    assert isinstance(search.get_ranker('cost'), search.CostRanker)


@pytest.mark.parametrize('method', ['mc', 'wmc', 'mc-dc', 'wmc-dc', 'mc-pdc', 'wmc-pdc'])
def test_top_candidates_equal_reference(rng, method):
    """Every state of a greedy trajectory: the port's top candidates equal
    the JAX package's, and their head is ``select_pair``'s pair."""
    kernel = random_kernel(rng, 7, 4)
    lats = [float(i % 3) for i in range(7)]
    st = create_state(kernel, [QInterval(-128.0, 127.0, 1.0)] * 7, lats)
    jst = jcreate_state(kernel, [JQInterval(-128.0, 127.0, 1.0)] * 7, lats)
    steps = 0
    while st.freq_stat and steps < 64:
        got = theur.top_candidates(st, method, 5)
        want = jheur.top_candidates(jst, method, 5)
        assert [(tuple(p), c, sc, n, d) for p, c, sc, n, d in got] == [(tuple(p), c, sc, n, d) for p, c, sc, n, d in want]
        pair = theur.select_pair(st, method)
        if pair.id0 == -1:
            break
        assert got and got[0][0] == pair
        update_state(st, pair, -1, -1)
        jupdate_state(jst, jheur.select_pair(jst, method), -1, -1)
        steps += 1
    assert steps > 0
    assert theur.top_candidates(st, 'dummy', 3) == []


# ---------------------------------------------------------------------------
# host beam and device beam, fork for fork
# ---------------------------------------------------------------------------


def _beam_lanes(mod, qint):
    """``tests/test_beam_search.py``'s fuzz lane set: six methods' worth of
    lanes, pow2-edge dims, a restart permutation, heterogeneous qintervals
    and latencies, and a duplicate lane."""
    rng = np.random.default_rng(42)

    def lane(kern, method, perm=None, qints=None, lats=None):
        n = kern.shape[0]
        return mod._Lane(kern, qints or [qint(-128.0, 127.0, 1.0)] * n, lats or [0.0] * n, method, perm=perm)

    het_q = [qint(-(2.0**e), 2.0**e - 2.0**-2, 2.0**-2) for e in range(2, 8)]
    lanes = [
        lane(random_kernel(rng, 6, 4), 'wmc'),
        lane(random_kernel(rng, 7, 3, 5), 'mc'),
        lane(random_kernel(rng, 9, 4, 5), 'wmc-dc'),
        lane(random_kernel(rng, 12, 5, 12), 'wmc'),
        lane(random_kernel(rng, 6, 4), 'wmc', perm=rng.permutation(6)),
        lane(random_kernel(rng, 6, 3), 'mc-pdc', qints=list(het_q), lats=[float(i % 3) for i in range(6)]),
        lane(random_kernel(rng, 5, 4), 'mc-dc', lats=[float(i % 2) for i in range(5)]),
        lane(random_kernel(rng, 5, 3, 7), 'wmc-pdc', lats=[float(i % 4) for i in range(5)]),
    ]
    lanes.append(lanes[0])  # duplicate: must share its expansion
    return lanes


def _assert_same_forks(got, want):
    assert len(got) == len(want) > 0
    for (gi, gl, gm), (wi, wl, wm) in zip(got, want):
        assert gi == wi
        assert gl.prefix.key == wl.prefix.key
        assert gl.prefix.qmeta.tobytes() == wl.prefix.qmeta.tobytes()
        assert gl.prefix.lat.tobytes() == wl.prefix.lat.tobytes()
        assert gm == wm


BEAMS = [(3, 2), (5, 1), (2, 3)]


@pytest.mark.parametrize('beam,depth', BEAMS)
def test_host_beam_equals_reference(beam, depth):
    spec = search.SearchSpec(beam=beam, depth=depth)
    got = tbeam.expand_beam_lanes(_beam_lanes(ts, QInterval), spec, -1, -1)
    want = jbeam.expand_beam_lanes(_beam_lanes(js, JQInterval), jsearch.SearchSpec(beam=beam, depth=depth), -1, -1)
    _assert_same_forks(got, want)
    assert len({fl.prefix.key for i, fl, _ in got if i == 0}) > 1, 'lane 0 must fork more than one trajectory'


@pytest.mark.parametrize('beam,depth', BEAMS)
def test_device_beam_equals_host_beams(beam, depth):
    """The device beam, run as torch ops on the CPU, equals the port's host
    beam and the JAX package's host beam under CostRanker, and counts its
    forks and prunes."""
    spec = search.SearchSpec(beam=beam, depth=depth)
    before = dict(ts.search_stats)
    dev = torch_beam._device_beam_expand(_beam_lanes(ts, QInterval), spec, -1, -1, device='cpu')
    delta = {k: ts.search_stats[k] - before[k] for k in ('fork_lanes', 'device_forks', 'lanes_expanded')}
    assert delta == {'fork_lanes': len(dev), 'device_forks': delta['device_forks'], 'lanes_expanded': 8}
    assert delta['device_forks'] >= len({fl.prefix.key for _, fl, _ in dev})
    _assert_same_forks(dev, tbeam.expand_beam_lanes(_beam_lanes(ts, QInterval), spec, -1, -1))
    want = jbeam.expand_beam_lanes(_beam_lanes(js, JQInterval), jsearch.SearchSpec(beam=beam, depth=depth), -1, -1)
    _assert_same_forks(dev, want)


def test_device_beam_sized_carry_and_adder_sizes():
    """Adder and carry sizes set: the fork step's f32 cost and the replay's
    f64 metadata agree with the host beam."""
    spec = search.SearchSpec(beam=4, depth=2)
    lanes = _beam_lanes(ts, QInterval)[:4]
    dev = torch_beam._device_beam_expand(lanes, spec, 3, 8, device='cpu')
    _assert_same_forks(dev, tbeam.expand_beam_lanes(_beam_lanes(ts, QInterval)[:4], spec, 3, 8))


# ---------------------------------------------------------------------------
# full solves against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('quality', ['search', 'max', 'spec'])
def test_quality_solve_equals_jax(tmp_path, monkeypatch, quality):
    """``solve_torch_many`` equals ``solve_jax_many`` op for op in both
    stages, is exact, and is never worse than ``'fast'``; under
    ``DA4ML_SEARCH_TRACE_DIR`` both export the same trace records."""
    from da4ml_tpu.cmvm.search.trace import load_trace_dir as jload
    from da4ml_tpu_torch.cmvm.search.trace import load_trace_dir

    q = search.SearchSpec(beam=3, depth=2, focus=0) if quality == 'spec' else quality
    jq = jsearch.SearchSpec(beam=3, depth=2, focus=0) if quality == 'spec' else quality
    kernels = kernels_of(11)[:2] if quality == 'max' else kernels_of(11)
    monkeypatch.setenv('DA4ML_SEARCH_TRACE_DIR', str(tmp_path / 'port'))
    got = ts.solve_torch_many(kernels, quality=q, device='cpu')
    monkeypatch.setenv('DA4ML_SEARCH_TRACE_DIR', str(tmp_path / 'ref'))
    want = js.solve_jax_many(kernels, quality=jq)
    monkeypatch.delenv('DA4ML_SEARCH_TRACE_DIR')
    fast = ts.solve_torch_many(kernels, device='cpu')
    for k, g, w, f in zip(kernels, got, want, fast):
        assert_exact(g, k)
        assert ops_sig(g) == ops_sig(w) and float(g.cost) == float(w.cost)
        assert float(g.cost) <= float(f.cost)
    records = load_trace_dir(tmp_path / 'port')
    assert records and records == jload(tmp_path / 'ref')
    for r in records:
        assert len(r['features']) == 5 and isinstance(r['chosen'], bool) and isinstance(r['final_cost_delta'], float)


def test_fast_and_none_unchanged():
    kernels = kernels_of(12)[:3]
    base = ts.solve_torch_many(kernels, device='cpu')
    for q in ('fast', None, search.QUALITY_PRESETS['fast'], {'beam': 1}):
        for b, f in zip(base, ts.solve_torch_many(kernels, quality=q, device='cpu')):
            assert ops_sig(b) == ops_sig(f)


def test_quality_deterministic():
    kernels = kernels_of(13)[:3]
    a = ts.solve_torch_many(kernels, quality='search', device='cpu')
    b = ts.solve_torch_many(kernels, quality='search', device='cpu')
    assert [ops_sig(x) for x in a] == [ops_sig(y) for y in b]


@pytest.mark.parametrize('hard_dc', [0, 2])
def test_quality_under_hard_dc_budget(hard_dc):
    kernel = random_kernel(np.random.default_rng(14), 6, 4)
    sol = ts.solve_torch_many([kernel], hard_dc=hard_dc, quality='search', device='cpu')[0]
    assert_exact(sol, kernel)
    allowed = hard_dc + api.minimal_latency(kernel, [QInterval(-128.0, 127.0, 1.0)] * 6, [0.0] * 6, -1, -1)
    assert max((lt for st in sol.stages for lt in st.out_latency), default=0.0) <= allowed
    fast = ts.solve_torch_many([kernel], hard_dc=hard_dc, device='cpu')[0]
    assert float(sol.cost) <= float(fast.cost)
    # the first-fit key carries the beam slot (search_all_decompose_dc off)
    got = ts.solve_torch_many([kernel], hard_dc=hard_dc, search_all_decompose_dc=False, quality='search', device='cpu')
    assert_exact(got[0], kernel)


def test_quality_heterogeneous_qintervals():
    """Fork prefixes respect per-input metadata (restart perms included)."""
    rng = np.random.default_rng(15)
    kernel = random_kernel(rng, 6, 4)
    qints = [QInterval(-(2.0**e), 2.0**e - 2.0**-2, 2.0**-2) for e in range(2, 8)]
    lats = [float(i % 3) for i in range(6)]
    for q in ('search', {'beam': 3, 'depth': 2, 'n_restarts': 2}):
        sol = ts.solve_torch_many([kernel], qintervals_list=[qints], latencies_list=[lats], quality=q, device='cpu')[0]
        assert_exact(sol, kernel)
        x = np.stack([rng.integers(-(2**e), 2**e, 64) for e in range(2, 8)], axis=1).astype(np.float64)
        np.testing.assert_array_equal(sol.predict(x, backend='numpy'), x @ kernel)


def test_learned_ranker_solve():
    """The committed ranker.json steering the device prune (f32, as the JAX
    package's device prune scores): exact, never worse than 'fast',
    deterministic, and op for op the JAX package's solve."""
    kernels = kernels_of(16)[:3]
    spec = search.SearchSpec(beam=3, depth=2, ranker=str(RANKER))
    a = ts.solve_torch_many(kernels, quality=spec, device='cpu')
    b = ts.solve_torch_many(kernels, quality=spec, device='cpu')
    fast = ts.solve_torch_many(kernels, device='cpu')
    want = js.solve_jax_many(kernels, quality=jsearch.SearchSpec(beam=3, depth=2, ranker=str(RANKER)))
    for k, x, y, f, w in zip(kernels, a, b, fast, want):
        assert_exact(x, k)
        assert float(x.cost) <= float(f.cost) and ops_sig(x) == ops_sig(y) == ops_sig(w)


# ---------------------------------------------------------------------------
# training, counters
# ---------------------------------------------------------------------------


def test_train_reproduces_ranker_json(tmp_path, capsys):
    from da4ml_tpu_torch.cmvm.search.train import main

    out = tmp_path / 'ranker.json'
    assert main([str(RANKER.parent), str(out)]) == 0
    assert out.read_bytes() == RANKER.read_bytes()
    assert main([]) == 2 and 'da4ml_tpu_torch.cmvm.search.train' in capsys.readouterr().err


def test_search_stats_match_reference_telemetry(rng):
    """``tests/test_beam_search.py::test_search_telemetry_counters``' solve:
    the port's counters equal the JAX package's telemetry values."""
    from da4ml_tpu import telemetry
    from da4ml_tpu.telemetry.metrics import metrics_snapshot

    kernel = random_kernel(rng, 6, 4)
    keys = ('lanes_expanded', 'fork_lanes', 'frontier_culled', 'device_forks', 'device_prunes', 'strict_wins', 'ties',
            'host_rescues')  # fmt: skip
    before = dict(ts.search_stats)
    ts.solve_torch_many([kernel], quality='search', device='cpu')
    got = {k: ts.search_stats[k] - before[k] for k in keys}
    telemetry.enable()
    try:
        js.solve_jax_many([kernel], quality='search')
        snap = metrics_snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    want = {k: int(snap.get(f'search.{k}', {}).get('value', 0)) for k in keys}
    assert got == want and got['fork_lanes'] > 0
    assert got['strict_wins'] + got['ties'] + got['host_rescues'] == 1
    assert ts.search_stats['beam_width'] == snap['search.beam_width']['value'] == 5


# ---------------------------------------------------------------------------
# host backends, the tracer, the command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('backend', ['cpp', 'cpu'])
def test_host_backend_degrade_equals_reference(backend):
    """quality on a host backend: the spec's portfolio sweep, equal to the
    reference's op for op, with one warning per backend."""
    kernel = random_kernel(np.random.default_rng(17), 6, 4)
    api._warned.discard(f'cmvm.quality.{backend}')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        got = api.solve(kernel, backend=backend, quality='max')
        again = api.solve(kernel, backend=backend, quality='search')
    msgs = [str(w.message) for w in caught if 'quality' in str(w.message)]
    assert len(msgs) == 1 and f'backend {backend!r}' in msgs[0], msgs
    want = japi.solve(kernel, backend=backend, quality='max')
    assert_exact(got, kernel)
    assert ops_sig(got) == ops_sig(want)
    assert ops_sig(again) == ops_sig(japi.solve(kernel, backend=backend, quality='search'))


def test_quality_through_solver_options():
    """quality routes through the tracer's solver_options on the torch
    backend (the device beam) and on a host backend (the degrade)."""
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace

    rng = np.random.default_rng(18)
    w = random_kernel(rng, 6, 3)
    data = rng.integers(-8, 8, (16, 18)).astype(np.float64)
    costs = {}
    for opts in ({'backend': 'torch', 'device': 'cpu'}, {'backend': 'torch', 'device': 'cpu', 'quality': 'search'},
                 {'backend': 'cpu', 'quality': 'search'}):  # fmt: skip
        inp = FixedVariableArrayInput((3, 6), hwconf=HWConfig(1, -1, -1), solver_options=opts)
        x = inp.quantize(np.ones((3, 6)), np.full((3, 6), 3), np.zeros((3, 6), np.int64))
        comb = comb_trace(inp, x @ w)
        np.testing.assert_array_equal(comb.predict(data, backend='numpy').reshape(16, 3, -1), data.reshape(16, 3, 6) @ w)
        costs[tuple(opts.items())] = float(comb.cost)
    fast, beam, _ = costs.values()
    assert beam <= fast
    before = ts.search_stats['fork_lanes']
    inp = FixedVariableArrayInput(6, hwconf=HWConfig(1, -1, -1), solver_options={'backend': 'torch', 'device': 'cpu',
                                                                                   'quality': 'search'})  # fmt: skip
    comb_trace(inp, inp.quantize(np.ones(6), np.full(6, 3), np.zeros(6, np.int64)) @ w)
    assert ts.search_stats['fork_lanes'] > before, 'the tracer must run the beam'


_MLP = (
    'import torch\n'
    'class BeamMLP(torch.nn.Module):\n'
    '    input_shape = (6,)\n'
    '    def __init__(self):\n'
    '        super().__init__()\n'
    '        self.fc1 = torch.nn.Linear(6, 5)\n'
    '        self.act = torch.nn.ReLU()\n'
    '    def forward(self, x):\n'
    '        return self.act(self.fc1(x))\n'
)


@pytest.fixture
def mlp_pt(tmp_path, monkeypatch):
    import importlib

    import torch

    (tmp_path / 'beam_mlp_def.py').write_text(_MLP)
    monkeypatch.syspath_prepend(str(tmp_path))
    model = importlib.import_module('beam_mlp_def').BeamMLP()
    rng = np.random.default_rng(19)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.tensor(rng.integers(-4, 4, p.shape).astype(np.float32)))
    path = tmp_path / 'mlp.pt'
    torch.save(model, path)
    return path


def _files(root: Path) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob('*')) if p.is_file()}


def test_convert_quality_search_equals_reference(tmp_path, mlp_pt):
    """``convert --quality search --solver-backend torch --device cpu``
    writes the JAX package's ``convert --solver-backend jax --quality
    search`` project, file for file."""
    from da4ml_tpu._cli import main as jmain
    from da4ml_tpu_torch._cli import main as tmain

    args = ['convert', str(mlp_pt), '--flavor', 'verilog', '--inputs-kif', '1', '4', '0', '-n', '64', '-v', '0',
            '--quality', 'search']  # fmt: skip
    before = ts.search_stats['fork_lanes']
    assert tmain([*args, str(tmp_path / 'port'), '--solver-backend', 'torch', '--device', 'cpu']) == 0
    assert ts.search_stats['fork_lanes'] > before
    assert jmain([*args, str(tmp_path / 'ref'), '--solver-backend', 'jax']) == 0
    got, want = _files(tmp_path / 'port'), _files(tmp_path / 'ref')
    assert sorted(got) == sorted(want) and [k for k in want if got[k] != want[k]] == []
    assert json.loads(got['mismatches.json'])['n_mismatch'] == 0


@pytest.mark.parametrize('quality', ['search', 'max'])
def test_convert_quality_host_backend_degrades(tmp_path, mlp_pt, quality):
    """With the default 'auto' backend --quality exits 0 and warns once."""
    from da4ml_tpu_torch._cli import main as tmain

    api._warned.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        rc = tmain(['convert', str(mlp_pt), str(tmp_path / 'prj'), '--inputs-kif', '1', '4', '0', '-n', '16', '-v', '0',
                    '--quality', quality, '--device', 'cpu'])  # fmt: skip
    assert rc == 0
    msgs = [str(w.message) for w in caught if 'portfolio sweep' in str(w.message)]
    assert len(msgs) == 1, msgs
    assert (tmp_path / 'prj' / 'mismatches.json').exists()


# ---------------------------------------------------------------------------
# K2's plain version on full-capacity (beam-fork) rung classes
# ---------------------------------------------------------------------------


def prefix_rung_lanes(rng, P, O, B, n_in):
    """Seven lanes of a fork rung: inputs in rows 0..n_in-1, each lane with
    its own prefix depth (so its own cur0 = n_in + d), methods 0-5, and a
    padding lane (cur0 = P)."""
    N = 7
    depths = np.array([0, 1, 2, 3, 1, 2, 0])
    E = np.zeros((N, P, O, B), np.int8)
    q = np.zeros((N, P, 3), np.float32)
    q[:, :, 2] = 1.0
    lat = np.zeros((N, P), np.float32)
    for x, d in enumerate(depths):
        rows = n_in + d
        E[x, :rows] = rng.choice([-1, 0, 0, 1], size=(rows, O, B)).astype(np.int8)
        st = 2.0 ** -rng.integers(0, 3, rows)
        q[x, :rows, 0] = -rng.integers(0, 64, rows) * st
        q[x, :rows, 1] = rng.integers(1, 64, rows) * st
        q[x, :rows, 2] = st
        lat[x, :rows] = rng.integers(0, 3, rows)
    cur = (n_in + depths).astype(np.int32)
    cur[-1] = P
    meth = (np.arange(N) % 6).astype(np.int32)
    return E, q, lat, cur, meth


@pytest.mark.parametrize('P,O,B,K,adder,carry,R_in', [(32, 8, 4, 8, -1, -1, 16), (32, 8, 2, 8, 2, -1, 0)])
def test_rung_plain_full_rec_matches_jax_top4(rng, P, O, B, K, adder, carry, R_in):
    """Full-capacity records (n_iters = P) with heterogeneous cur0: K2's
    plain version equals the JAX package's top4 rung with full_rec."""
    lanes = prefix_rung_lanes(rng, P, O, B, 8)
    jspec = js._KernelSpec(P, O, B, adder, carry, 'top4', R_in=R_in, topk=K, full_rec=True)
    jlanes = lanes
    if R_in:  # the reference's trimmed upload: R_in rows, digits packed
        E, q, lat, cur, meth = lanes
        jlanes = (js._pack_rows_np(E[:, :R_in], js._fork_fmt(O, B)), q[:, :R_in], lat[:, :R_in], cur, meth)
    want = [np.asarray(x) for x in js._build_cse_fn(jspec)(*jlanes)]
    want[0] = js._unpack_digits(want[0], O, B)
    spec = ts._KernelSpec(P, O, B, adder, carry, R_in=R_in, topk=K, full_rec=True)
    assert spec.n_iters == P
    got = [t.numpy() for t in ts.cse_rung(*lanes, spec, device='cpu')]
    for name, w, g in zip(('E', 'qmeta', 'lat', 'records', 'cur'), want, got):
        assert w.dtype == g.dtype and w.shape == g.shape, (name, w.shape, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[4][:-1] > lanes[3][:-1]).all(), 'every live lane must commit ops'


def test_full_rec_rung_class():
    """A group holding a prefix lane takes full-capacity records; the trimmed
    class keeps P - R_in, and its records size the rung's bytes."""
    trimmed = ts._resolve_rung_class(64, 8, 4, -1, -1, 32)
    full = ts._resolve_rung_class(64, 8, 4, -1, -1, 32, full_rec=True)
    assert (trimmed.R_in, trimmed.n_iters, full.R_in, full.n_iters) == (32, 32, 32, 64)
    assert ts._rung_bytes_per_lane(full) - ts._rung_bytes_per_lane(trimmed) == 16 * 32
