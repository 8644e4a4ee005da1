"""The port's device CMVM search against the JAX package, on the CPU.

The plain rung function (``torch_search.cse_rung`` with CPU tensors, the
plain version of the CUDA kernel K2) equals the JAX package's top4 rung
function on every output; ``solve_torch_many`` equals ``solve_jax_many`` and
the port's host solver op for op. Inputs are made with numpy and handed to
both packages. Tolerance is exact.
"""

import numpy as np
import pytest
import torch

from da4ml_tpu.cmvm import jax_search as js
from da4ml_tpu_torch.cmvm import api, fused_cse
from da4ml_tpu_torch.cmvm import torch_search as ts
from da4ml_tpu_torch.ir.types import QInterval


def random_kernel(rng, n_dim, bits, m=None):
    mag = rng.integers(0, 2**bits, (n_dim, m or n_dim)).astype(np.float64)
    return mag * rng.choice([-1.0, 1.0], (n_dim, m or n_dim))


def ops_sig(p):
    return [[(o.id0, o.id1, o.opcode, o.data) for o in st.ops] for st in p.stages]


def assert_exact(sol, kernel):
    np.testing.assert_array_equal(np.asarray(sol.kernel, np.float64), kernel)


def rung_lanes(rng, P, O, B, n_rows):
    """Seven lanes of one rung class: random trit digits in the first
    ``n_rows`` rows, methods 0-5, and a padding lane (cur0 = P). Lane 0's
    first row carries a run of equal digits, which the search matches as an
    i == j chain."""
    N = 7
    E = np.zeros((N, P, O, B), np.int8)
    E[:, :n_rows] = rng.choice([-1, 0, 0, 1], size=(N, n_rows, O, B)).astype(np.int8)
    E[0, 0, :, :] = 1
    q = np.zeros((N, P, 3), np.float32)
    q[:, :, 2] = 1.0
    st = 2.0 ** -rng.integers(0, 3, (N, n_rows))
    q[:, :n_rows, 0] = -rng.integers(0, 64, (N, n_rows)) * st
    q[:, :n_rows, 1] = rng.integers(1, 64, (N, n_rows)) * st
    q[:, :n_rows, 2] = st
    lat = np.zeros((N, P), np.float32)
    lat[:, :n_rows] = rng.integers(0, 3, (N, n_rows))
    cur = np.full(N, n_rows, np.int32)
    cur[-1] = P
    meth = (np.arange(N) % 6).astype(np.int32)
    return E, q, lat, cur, meth


@pytest.mark.parametrize(
    'P,O,B,K,adder,carry',
    [(32, 8, 2, 8, -1, -1), (32, 8, 4, 8, 3, 8), (64, 8, 4, 8, -1, -1), (64, 8, 2, 8, 2, -1)],
)
def test_rung_matches_jax_top4(rng, P, O, B, K, adder, carry):
    lanes = rung_lanes(rng, P, O, B, 8)
    want = [np.asarray(x) for x in js._build_cse_fn(js._KernelSpec(P, O, B, adder, carry, 'top4', topk=K))(*lanes)]
    want[0] = js._unpack_digits(want[0], O, B)
    got = [t.numpy() for t in ts.cse_rung(*lanes, ts._KernelSpec(P, O, B, adder, carry, topk=K), device='cpu')]
    names = ('E', 'qmeta', 'lat', 'records', 'cur')
    for name, w, g in zip(names, want, got):
        assert w.dtype == g.dtype and w.shape == g.shape, (name, w.dtype, g.dtype, w.shape, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)
    cur0 = lanes[3]
    assert got[4][-1] == P and (got[3][-1] == 0).all(), 'the padding lane must stay frozen'
    assert (got[4][:-1] > cur0[:-1]).all(), 'every live lane must commit ops'
    rec0 = got[3][0, : got[4][0] - cur0[0]]
    assert (rec0[:, 0] == rec0[:, 1]).any(), 'lane 0 must match an i == j chain'


def test_k2_wrapper_takes_plain_version_on_cpu(rng):
    spec = ts._KernelSpec(32, 8, 2, -1, -1, topk=8)
    lanes = rung_lanes(rng, 32, 8, 2, 8)
    inputs = ts.rung_inputs(*lanes, spec, device='cpu')
    assert not np.shares_memory(inputs[0].numpy(), lanes[0]) and not np.shares_memory(inputs[5].numpy(), lanes[3])
    state = [t.clone() for t in inputs]
    fused_cse.reset_counts()
    got = fused_cse.greedy_loop(*inputs, spec)
    want = ts.greedy_plain(*state, spec)
    assert fused_cse.launches == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the state is updated in place: E, qm, lat and cur are returned, and the
    # two calls leave equal score caches
    for k, t in zip((0, 1, 2, 4), (inputs[0], inputs[1], inputs[2], inputs[5])):
        assert got[k] is t
    assert not torch.equal(inputs[5], state[5].new_tensor(lanes[3]))
    assert torch.equal(inputs[3], state[3]) and torch.equal(inputs[4], state[4])
    meta = [t.to('meta') for t in inputs]
    with pytest.raises(ValueError, match='CUDA tensors'):
        fused_cse.greedy_loop(*meta, spec)


def test_k2_launch_rejects_lane_entering_below_record_capacity(rng):
    """A lane whose cur0 lies below P - n_iters would write op records past
    the record buffer: the wrapper raises before the launch."""
    spec = ts._KernelSpec(32, 8, 2, -1, -1, R_in=8, topk=8)
    inputs = list(ts.rung_inputs(*rung_lanes(rng, 32, 8, 2, 8), spec, device='cpu'))
    inputs[5][1] = 7  # below R_in = 8: 25 ops for 24 records
    fused_cse.reset_counts()
    with pytest.raises(ValueError, match='P - n_iters = 8'):
        fused_cse.launch(*inputs, spec)
    assert fused_cse.launches == 0


@pytest.mark.parametrize(
    'case',
    ['mixed_sizes', 'hard_dc_0', 'hard_dc_2', 'no_sweep_hard_dc_1', 'candidates_restarts', 'dummy'],
)
def test_solve_many_matches_jax(rng, case):
    kernels = [random_kernel(rng, 6, 4), random_kernel(rng, 5, 3)]
    if case == 'mixed_sizes':
        kernels, kw = [random_kernel(rng, n, b) for n, b in [(4, 2), (8, 4), (6, 3)]], {}
    elif case.startswith('hard_dc'):
        kw = {'hard_dc': int(case[-1])}
    elif case == 'no_sweep_hard_dc_1':  # the host's first-fitting-dc preference
        kw = {'hard_dc': 1, 'search_all_decompose_dc': False}
    elif case == 'candidates_restarts':
        kernels, kw = kernels[:1], {'method0_candidates': ['wmc', 'mc'], 'n_restarts': 2}
    else:  # no greedy search in stage 0: dummy lanes emit straight from the CSD
        kw = {'method0': 'dummy'}
    want = js.solve_jax_many(kernels, **kw)
    got = ts.solve_torch_many(kernels, device='cpu', **kw)
    for k, w, g in zip(kernels, want, got):
        assert_exact(g, k)
        assert ops_sig(g) == ops_sig(w)
        assert float(g.cost) == float(w.cost)


def test_solve_many_latencies_and_sizes_match_jax():
    """Heterogeneous qintervals/latencies and finite adder/carry sizes: the
    f32 scoring metadata agrees with the reference's, and the emitted program
    replays exactly."""
    rng = np.random.default_rng(1000)
    kernels, qints_l, lats_l = [], [], []
    for _ in range(3):
        n_in = int(rng.integers(3, 8))
        kernels.append(random_kernel(rng, n_in, int(rng.integers(2, 5))))
        frac = 2.0 ** -rng.integers(0, 4, n_in)
        lo = -rng.integers(1, 128, n_in).astype(np.float64) * frac
        hi = rng.integers(1, 128, n_in).astype(np.float64) * frac
        qints_l.append([QInterval(float(lo[i]), float(hi[i]), float(frac[i])) for i in range(n_in)])
        lats_l.append([float(v) for v in rng.integers(0, 4, n_in)])
    kw = dict(qintervals_list=qints_l, latencies_list=lats_l, adder_size=4, carry_size=8)
    want = js.solve_jax_many(kernels, **kw)
    got = ts.solve_torch_many(kernels, device='cpu', **kw)
    for k, w, g, qints in zip(kernels, want, got, qints_l):
        assert_exact(g, k)
        assert ops_sig(g) == ops_sig(w)
        cols = [q.step * rng.integers(round(q.min / q.step), round(q.max / q.step) + 1, 32) for q in qints]
        x = np.stack(cols, axis=1).astype(np.float64)
        np.testing.assert_array_equal(g.predict(x, backend='numpy'), x @ k)


@pytest.mark.parametrize('method0', ['wmc', 'mc'])
def test_solve_torch_equals_host_solver_op_for_op(rng, method0):
    """The device search commits the host solver's op sequence: greedy ties
    resolve in the host's scan order."""
    for trial in range(3):
        kernel = random_kernel(rng, int(rng.integers(5, 13)), int(rng.integers(3, 11)))
        ref = api.solve(kernel, method0=method0)
        got = ts.solve_torch(kernel, method0=method0, device='cpu')
        assert_exact(got, kernel)
        assert float(got.cost) == float(ref.cost), (trial, got.cost, ref.cost)
        for sr, sg in zip(ref.stages, got.stages):
            assert list(sr.ops) == list(sg.ops), trial


def test_backend_torch_routes_to_device_search(rng):
    kernel = random_kernel(rng, 6, 4)
    via_api = api.solve(kernel, backend='torch', device='cpu')
    direct = ts.solve_torch(kernel, device='cpu')
    assert_exact(via_api, kernel)
    assert ops_sig(via_api) == ops_sig(direct)
    with pytest.raises(NotImplementedError, match='beam'):
        ts.solve_torch(kernel, quality='search', device='cpu')
    with pytest.raises(NotImplementedError, match='mesh'):
        ts.solve_torch(kernel, mesh=object(), device='cpu')


def test_solve_torch_without_cuda_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.solve_torch(random_kernel(rng, 4, 2))
    with pytest.raises(RuntimeError, match='CUDA'):
        api.solve(random_kernel(rng, 4, 2), backend='torch')


def test_pmax_routes_lanes_to_host(rng, monkeypatch):
    """Lanes whose slot demand exceeds PMAX solve on the host (counted),
    small ones in the same batch stay on the device; all exact."""
    monkeypatch.setattr(ts, 'PMAX', 64)
    big, small = random_kernel(rng, 8, 8), random_kernel(rng, 4, 2)
    before = ts.search_stats['pmax_host_fallbacks']
    sols = ts.solve_torch_many([big, small], device='cpu')
    assert ts.search_stats['pmax_host_fallbacks'] > before
    for k, s in zip((big, small), sols):
        assert_exact(s, k)


def test_chunked_rungs_identical(rng, monkeypatch):
    """A tiny device-memory budget splits every rung into chunks of one lane;
    the results are the unchunked ones, op for op."""
    kernels = [random_kernel(rng, 6, 4) for _ in range(3)]
    base = ts.solve_torch_many(kernels, device='cpu')
    monkeypatch.setattr(ts, 'DEVICE_BUDGET', 1)
    calls = []
    real = ts.cse_rung
    monkeypatch.setattr(ts, 'cse_rung', lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
    chunked = ts.solve_torch_many(kernels, device='cpu')
    assert calls and max(calls) == 1
    for k, b, c in zip(kernels, base, chunked):
        assert_exact(c, k)
        assert ops_sig(b) == ops_sig(c) and b.cost == c.cost


def test_tracer_batches_distinct_rows_like_jax(rng):
    """A 2-D input whose rows differ in precision: the torch backend solves
    the distinct rows as one lane batch, as the JAX package's jax backend
    does, and both trace to the same program."""
    from da4ml_tpu.trace import FixedVariableArrayInput as JaxInput
    from da4ml_tpu.trace import HWConfig as JaxHW
    from da4ml_tpu.trace import comb_trace as jax_trace
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace

    w = rng.integers(-8, 8, (6, 4)).astype(np.float64)
    ints = np.repeat(np.array([[2], [3], [4]]), 6, axis=1)

    def trace(inp_cls, hw, tracer, **opts):
        inp = inp_cls((3, 6), hwconf=hw(1, -1, -1), solver_options=opts)
        return tracer(inp, inp.quantize(np.ones((3, 6)), ints, np.ones((3, 6), np.int64)) @ w)

    calls = []
    real = ts.solve_torch_many

    def counted(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, 'solve_torch_many', counted)
        got = trace(FixedVariableArrayInput, HWConfig, comb_trace, backend='torch', device='cpu')
    assert calls == [3]
    want = trace(JaxInput, JaxHW, jax_trace, backend='jax')
    host = trace(FixedVariableArrayInput, HWConfig, comb_trace, backend='cpu')
    assert np.array_equal(got.to_binary(), want.to_binary())
    assert np.array_equal(got.to_binary(), host.to_binary())
