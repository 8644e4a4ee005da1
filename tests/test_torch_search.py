"""The port's device CMVM search against the JAX package, on the CPU.

The plain rung function (``torch_search.cse_rung`` with CPU tensors, the
plain version of the CUDA kernel K2) equals the JAX package's top4 rung
function on every output; ``solve_torch_many`` equals ``solve_jax_many`` and
the port's host solver op for op. Inputs are made with numpy and handed to
both packages. Tolerance is exact.
"""

import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

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
    assert len(inputs) == 5, 'a rung takes no score cache: K2 builds its own'
    assert not np.shares_memory(inputs[0].numpy(), lanes[0]) and not np.shares_memory(inputs[3].numpy(), lanes[3])
    state = [t.clone() for t in inputs]
    fused_cse.reset_counts()
    got = fused_cse.greedy_loop(*inputs, spec)
    want = ts.rung_plain(*state, spec)
    assert fused_cse.launches == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the state is updated in place: E, qm, lat and cur are returned
    for k, t in zip((0, 1, 2, 4), (inputs[0], inputs[1], inputs[2], inputs[3])):
        assert got[k] is t
    assert not torch.equal(inputs[3], state[3].new_tensor(lanes[3]))
    assert torch.equal(inputs[4], state[4])
    meta = [t.to('meta') for t in inputs]
    with pytest.raises(ValueError, match='CUDA tensors'):
        fused_cse.greedy_loop(*meta, spec)


@pytest.mark.parametrize('P,O,B,K,adder,carry', [(32, 8, 2, 8, -1, -1), (64, 8, 4, 16, 3, 8), (64, 16, 6, 8, -1, -1)])
def test_greedy_loop_builds_its_own_cache_on_cpu(rng, P, O, B, K, adder, carry):
    """On CPU tensors, the rung from its cache-less inputs is the cache build
    (init_cache) followed by the plain greedy loop, and launches nothing."""
    spec = ts._KernelSpec(P, O, B, adder, carry, R_in=16, topk=K)
    inputs = ts.rung_inputs(*rung_lanes(rng, P, O, B, 16), spec, device='cpu')
    E, qm, lat, cur, meth = (t.clone() for t in inputs)
    tv, tc = ts.init_cache(E, qm, lat, meth, K)
    want = ts.greedy_plain(E, qm, lat, tv, tc, cur, meth, spec)
    fused_cse.reset_counts()
    got = fused_cse.greedy_loop(*inputs, spec)
    assert fused_cse.launches == 0
    for name, g, w in zip(('E', 'qmeta', 'lat', 'records', 'cur'), got, want):
        assert torch.equal(g, w), name
    assert (got[4][:-1] > inputs[3].new_tensor(16)).any(), 'the lanes must commit ops'


def test_k2_launch_rejects_lane_entering_below_record_capacity(rng):
    """A lane whose cur0 lies below P - n_iters would write op records past
    the record buffer: the wrapper raises before the launch."""
    spec = ts._KernelSpec(32, 8, 2, -1, -1, R_in=8, topk=8)
    inputs = list(ts.rung_inputs(*rung_lanes(rng, 32, 8, 2, 8), spec, device='cpu'))
    inputs[3][1] = 7  # below R_in = 8: 25 ops for 24 records
    fused_cse.reset_counts()
    with pytest.raises(ValueError, match='P - n_iters = 8'):
        fused_cse.launch(*inputs, spec)
    assert fused_cse.launches == 0


#: an H100's shared memory in bytes: per block with the opt-in, per SM,
#: reserved per block
_H100_SMEM = (232448, 233472, 1024)
#: the (P, O, B) classes of the flagship's device search (K = 8)
_FLAGSHIP_CLASSES = [(32, 8, 2), (32, 32, 4), (32, 32, 6), (64, 8, 4), (64, 8, 6), (64, 32, 2), (64, 32, 4), (64, 32, 6),
                     (128, 8, 4), (128, 8, 6), (128, 32, 4), (128, 32, 6), (256, 32, 4), (256, 32, 6)]  # fmt: skip


@pytest.mark.parametrize(
    'P,O,B,K,placement',
    [(P, O, B, 8, 'shared') for P, O, B in _FLAGSHIP_CLASSES]
    + [(512, 8, 4, 16, 'shared'), (1024, 64, 4, 16, 'shared'), (2048, 8, 4, 16, 'global'), (32768, 32, 8, 16, 'global')],
)
def test_cluster_geometry(P, O, B, K, placement):
    """K2's launch shape on an H100: the smallest cluster (2 to 16 blocks)
    that leaves each block at most SLOTS_PER_CTA slots, the instantiation's
    largest block, and the slice in
    shared memory exactly when it fits beside the static arrays (else the
    same layout in global memory)."""
    C, threads, got = fused_cse.cluster_geometry(P, O, B, K, _H100_SMEM)
    assert got == placement
    assert C in (2, 4, 8, 16) and P % C == 0
    assert P // C <= fused_cse.SLOTS_PER_CTA or C == fused_cse.MAX_CLUSTER
    assert C == 2 or P // (C // 2) > fused_cse.SLOTS_PER_CTA, 'a smaller cluster would do'
    assert threads == (512 if K <= 8 else 256), 'the instantiation\'s largest block'
    assert re.search(rf'kThreadsFor = K > 8 \? kMaxThreads / 2 : kMaxThreads', _CU.read_text())
    need = fused_cse.slice_layout(P, O, B, K, C)['bytes'] + fused_cse.STATIC_SMEM
    assert (need <= _H100_SMEM[0]) == (placement == 'shared')
    if placement == 'shared':  # one block of the cluster fits an SM beside the reserved bytes
        assert need + _H100_SMEM[2] <= _H100_SMEM[1]


@pytest.mark.parametrize('P,O,B,K', [(32, 8, 2, 8), (256, 32, 6, 8), (1024, 64, 4, 16), (2048, 8, 4, 16)])
def test_slice_layout(P, O, B, K):
    """The slice's regions are 16-byte aligned and disjoint, in the source's
    Layout order, and hold what the kernel keeps there."""
    C = fused_cse.cluster_geometry(P, O, B, K, _H100_SMEM)[0]
    lay = fused_cse.slice_layout(P, O, B, K, C)
    offs = [lay[r] for r in fused_cse.SLICE_REGIONS]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs) and offs[0] == 0
    PC, TB = P // C, 2 * B
    assert lay['tc'] - lay['tv'] >= 4 * K * TB * PC and lay['planes'] - lay['meta'] >= 16 * P
    assert lay['parts'] - lay['planes'] >= 8 * fused_cse.plane_words(O, B) * P
    assert lay['cv'] - lay['S'] >= 4 * 2 * 3 * TB * PC and lay['cc'] - lay['cv'] >= 4 * 3 * TB * C * K
    assert lay['bytes'] >= lay['nov'] + 4 * 2 * 3 * PC


def _split_topk(vals, k, C):
    """K2's split top-K in plain torch: a partial top-k over each of C
    contiguous column blocks (a block of the cluster's slots), then the top-k
    of the C·k partial entries in cache order (the owner's merge)."""
    P = vals.shape[-1]
    PC = P // C
    pv, pc = [], []
    for r in range(C):
        v, c = ts._topk_scan(vals[..., r * PC : (r + 1) * PC], k)
        pv.append(v)
        pc.append(torch.where(c >= 0, c + r * PC, -1))
    return ts._merge_topk(torch.cat(pv, -1), torch.cat(pc, -1).to(torch.int32), k)


@pytest.mark.parametrize('C', [1, 2, 4, 8, 16])
def test_split_topk_equals_topk_scan(rng, C):
    """A top-K split by slot blocks and merged by the row's owner is the
    top-K of the whole row, ties (equal scores, -inf) included: the cache
    order (score desc, column desc) is total over distinct columns."""
    for P, K in ((64, 8), (256, 16), (32, 16)):
        vals = torch.from_numpy(rng.integers(-3, 4, (12, P)).astype(np.float32))
        vals[torch.from_numpy(rng.random((12, P)) < 0.4)] = -float('inf')
        vals[0] = -float('inf')  # a dead row
        want_v, want_c = ts._topk_scan(vals, K)
        got_v, got_c = _split_topk(vals, K, C)
        assert torch.equal(got_v, want_v) and torch.equal(got_c, want_c), (P, K)


_CU = Path(fused_cse.SOURCE)


def test_k2_source_agrees_with_wrapper():
    """The wrapper's slice regions, launch signature and phase names match
    the CUDA source (nothing checks them at run time but the card)."""
    src = _CU.read_text()
    layout = re.search(r'struct Layout \{(.*?)\};', src, re.S)[1]
    assert re.findall(r'int (\w+);', layout) == [*fused_cse.SLICE_REGIONS, 'bytes']
    assert 'Layout{' + ', '.join(f'off[{k}]' for k in range(len(fused_cse.SLICE_REGIONS) + 1)) + '}' in src
    lib = SimpleNamespace(**{n: SimpleNamespace() for n in ('fused_cse_launch', 'fused_cse_active_clusters',
                                                            'fused_cse_device_smem', 'fused_cse_error_string')})  # fmt: skip
    fused_cse._declare(lib)
    for name in ('fused_cse_launch', 'fused_cse_active_clusters', 'fused_cse_device_smem'):
        params = re.search(rf'int {name}\((.*?)\)\s*\{{', src, re.S)[1]
        assert len(params.split(',')) == len(getattr(lib, name).argtypes), name
    assert f'ph_acc[{len(fused_cse.PHASES)}]' in src
    assert f'constexpr int kMaxCluster = {fused_cse.MAX_CLUSTER};' in src


@pytest.mark.parametrize('defines', [(), ('-DFUSED_CSE_PHASES',)])
def test_k2_source_parses_with_stub_headers(defines):
    """``g++ -fsyntax-only`` parses the CUDA source against declaration-only
    stubs of the CUDA headers: C++ errors show here, not first on the card."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ on this machine')
    stub = Path(__file__).resolve().parent / 'cuda_stub'
    proc = subprocess.run([gxx, '-std=c++17', '-fsyntax-only', '-I', str(stub), *defines, '-x', 'c++', str(_CU)],
                          capture_output=True, text=True)  # fmt: skip
    assert proc.returncode == 0, proc.stderr


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
    beam = api.solve(kernel, backend='torch', quality='search', device='cpu')
    assert_exact(beam, kernel)
    assert float(beam.cost) <= float(via_api.cost)
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


def _lane_by_lane_work(inputs, rec, cur, spec) -> dict[str, int]:
    """``chip_smoke.rung_work``'s count replayed one lane and one iteration
    at a time, every live row recounted after each substitution."""
    E0, _, _, cur0, _ = (np.asarray(x) for x in inputs)
    N, P, O, B = E0.shape
    TB = 2 * B
    work = {'bytes': 2 * (N * P * O * B + 16 * N * P) + 12 * N + 16 * N * spec.n_iters,
            'int_build': 0, 'fp_build': 0, 'int_loop': 0, 'fp_loop': 0}  # fmt: skip
    lane = torch.zeros(1, dtype=torch.int64)
    for n in range(N):
        if cur0[n] >= P:
            continue
        E = torch.from_numpy(E0[n : n + 1].copy())
        live = int(E[0].ne(0).any(-1).any(-1).sum())
        work['int_build'] += live * int((B - torch.nonzero(E[0])[:, 2]).sum())
        work['fp_build'] += 2 * TB * live * live
        for t in range(int(cur[n]) - int(cur0[n])):
            id0, id1, sub, shift = (int(v) for v in rec[n, t])
            i, j, s = (id0, id1, shift) if shift >= 0 else (id1, id0, -shift)
            c = int(cur0[n]) + t
            E[0, c] = ts._dev_substitute(E, lane, *(torch.tensor([v]) for v in (sub, s, i, j)), B)[0]
            live = int(E[0].ne(0).any(-1).any(-1).sum())
            dirty = sorted({i, j, c})
            work['int_loop'] += B * live * int((E[0, dirty] != 0).sum())
            work['fp_loop'] += TB * live + len(dirty) * (2 * (TB - 1) * live + TB * live + TB * live)
    return work


@pytest.mark.parametrize('P,O,B,adder,carry,n_rows', [(64, 8, 4, -1, -1, 16), (32, 8, 6, 3, 8, 12), (64, 8, 2, 2, -1, 40)])
def test_smoke_rung_work_is_the_lane_by_lane_replay(P, O, B, adder, carry, n_rows):
    """The smoke run's K2 bound replays every lane's iterations at once; it
    counts what a replay lane by lane, live rows recounted each time, counts
    (seeded random rungs run through K2's plain version)."""
    from test_torch_pipeline import _chip_smoke

    smoke = _chip_smoke()
    spec = ts._KernelSpec(P, O, B, adder, carry, R_in=n_rows, topk=8)
    inputs = smoke.random_rung(np.random.default_rng(P + n_rows), P, O, B, n_rows)
    out = ts.rung_plain(*ts.rung_inputs(*inputs, spec, device='cpu'), spec)
    rec, cur = out[3].numpy(), out[4].numpy()
    assert (cur - inputs[3]).max() > 0
    assert smoke.rung_work(ts, inputs, rec, cur, spec) == _lane_by_lane_work(inputs, rec, cur, spec)


def _check_signature(port_fn, ref_fn, port_only: tuple[str, ...]):
    """``port_fn`` binds positional arguments as ``ref_fn`` does: the same
    positional parameters in the same order, the shared keyword-only ones
    in the reference's order, and the port's own names last and
    keyword-only."""
    import inspect

    tp = list(inspect.signature(port_fn).parameters.values())
    rp = list(inspect.signature(ref_fn).parameters.values())
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    assert [p.name for p in tp if p.kind in positional] == [p.name for p in rp if p.kind in positional]
    ref_names = [p.name for p in rp]
    shared = [p.name for p in tp if p.name in ref_names]
    assert shared == [n for n in ref_names if n in shared]
    assert [p.name for p in tp][len(shared):] == list(port_only)
    for p in tp:
        if p.name in port_only:
            assert p.kind == inspect.Parameter.KEYWORD_ONLY, p
        else:
            assert p.kind == next(r.kind for r in rp if r.name == p.name), p
            assert p.default == next(r.default for r in rp if r.name == p.name), p


def test_solve_signature_is_the_reference_s():
    import inspect

    from da4ml_tpu.cmvm import api as japi

    _check_signature(api.solve, japi.solve, ('device',))
    assert list(inspect.signature(api.solve).parameters)[14] == 'mesh'


def test_solve_torch_signatures_are_the_reference_s():
    _check_signature(ts.solve_torch_many, js._solve_jax_many_impl, ('device',))
    _check_signature(ts.solve_torch, js.solve_jax, ('device',))


def test_positional_mesh_binds_and_a_real_mesh_raises():
    """``mesh`` binds at the reference's position and must be None; the
    multi-device search is not ported."""
    w = np.array([[3.0, -5.0], [6.0, 1.0]])
    args = (w, 'wmc', 'auto', -1, -2, None, None, -1, -1, True, 'cpu', 0, None, 1, None)
    assert api.solve(*args).kernel.tolist() == w.tolist()
    with pytest.raises(NotImplementedError, match='mesh'):
        api.solve(*args[:14], object())
    with pytest.raises(NotImplementedError, match='mesh'):
        ts.solve_torch_many([w], 'wmc', 'auto', -1, -2, None, None, -1, -1, True, object(), device='cpu')
    with pytest.raises(TypeError):
        api.solve(*args, 'fast')  # quality is keyword-only, as in the reference
