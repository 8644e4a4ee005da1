"""The port's native host library against the JAX package's, on the CPU.

``da4ml_tpu_torch/native`` builds its own copy of the C++ sources into
``build/da4ml_tpu_torch/``. Here its CMVM solver (``backend='cpp'``) is held
op for op against the JAX package's native solver and the port's Python
solver; its interpreter and the port's vectorized numpy interpreter against
the JAX package's and the port's table-driven reference interpreter on the
synth corpus; its batched decomposition and emission, inside the device
search (``solve_torch_many(device='cpu')``), against the Python route and
``solve_jax_many``. Inputs are made with numpy from a seed; equality is
exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from da4ml_tpu import native as jnative
from da4ml_tpu.cmvm import solve as jsolve
from da4ml_tpu.cmvm.jax_search import solve_jax_many
from da4ml_tpu.ir import dais_binary as jbin
from da4ml_tpu.ir import synth as jsynth
from da4ml_tpu.ir.types import QInterval as JQInterval
from da4ml_tpu.native import bindings as jbindings
from da4ml_tpu.runtime import numpy_backend as jnumpy_backend
from da4ml_tpu_torch import native
from da4ml_tpu_torch.cmvm import api
from da4ml_tpu_torch.cmvm import torch_search as ts
from da4ml_tpu_torch.cmvm.decompose import kernel_decompose
from da4ml_tpu_torch.entry import flagship_comb
from da4ml_tpu_torch.ir.dais_binary import decode
from da4ml_tpu_torch.ir.types import QInterval
from da4ml_tpu_torch.native import bindings, build
from da4ml_tpu_torch.runtime import numpy_backend, reference, run_comb

ROOT = Path(__file__).resolve().parents[1]


def _random_kernel(rng, n_in, n_out, bits):
    return (rng.integers(0, 2**bits, (n_in, n_out)) * rng.choice([-1.0, 1.0], (n_in, n_out))).astype(np.float64)


def _stage_sig(st):
    return ([tuple(op) for op in st.ops], st.shape, list(st.inp_shifts), list(st.out_idxs), list(st.out_shifts),
            [bool(v) for v in st.out_negs], st.carry_size, st.adder_size)  # fmt: skip


def _assert_same(a, b, kernel):
    """Two pipelines (of either package) are the same solution, op for op."""
    np.testing.assert_array_equal(np.asarray(a.kernel, np.float64), kernel)
    assert float(a.cost) == float(b.cost)
    assert len(a.stages) == len(b.stages)
    for sa, sb in zip(a.stages, b.stages):
        assert _stage_sig(sa) == _stage_sig(sb)


def _jax_qints(qints):
    return [JQInterval(*q) for q in qints] if qints else None


# ---------------------------------------------------------------------------
# the solver: backend='cpp' and 'auto'
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('method0', ['mc', 'wmc'])
@pytest.mark.parametrize('hard_dc', [0, 2, -1])
@pytest.mark.parametrize('decompose_dc', [0, -1, -2])
def test_cpp_solve_config_parity(method0, hard_dc, decompose_dc):
    """The cartesian of ``tests/test_native_solver.py``: port 'cpp' equals
    the JAX package's 'cpp' and the port's 'cpu'."""
    rng = np.random.default_rng(1000 + 100 * ['mc', 'wmc'].index(method0) + 10 * hard_dc + decompose_dc)
    kernel = _random_kernel(rng, 6, 5, 4)
    qints = [QInterval(-8.0, 7.0, 1.0)] * 6
    kw = dict(method0=method0, hard_dc=hard_dc, decompose_dc=decompose_dc, search_all_decompose_dc=False)
    got = api.solve(kernel, backend='cpp', qintervals=qints, n_workers=1, **kw)
    _assert_same(got, jsolve(kernel, backend='cpp', qintervals=_jax_qints(qints), **kw), kernel)
    _assert_same(got, api.solve(kernel, backend='cpu', qintervals=qints, **kw), kernel)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_cpp_solve_search_all_parity(seed):
    rng = np.random.default_rng(seed)
    n_in, n_out = int(rng.integers(2, 10)), int(rng.integers(1, 10))
    kernel = _random_kernel(rng, n_in, n_out, 4)
    qints = [QInterval(-128.0, 127.0, 1.0)] * n_in
    got = api.solve(kernel, backend='cpp', qintervals=qints, n_workers=1)
    _assert_same(got, jsolve(kernel, backend='cpp', qintervals=_jax_qints(qints)), kernel)
    _assert_same(got, api.solve(kernel, backend='cpu', qintervals=qints), kernel)


def test_cpp_solve_sized_cost_model_and_threads():
    """Adder and carry sizes, fractional intervals and input latencies; the
    thread count (``n_workers``) does not change the result."""
    rng = np.random.default_rng(9)
    kernel = _random_kernel(rng, 8, 6, 4)
    qints = [QInterval(-16.0, 15.0, 0.5)] * 8
    kw = dict(adder_size=6, carry_size=8, latencies=[float(i % 3) for i in range(8)])
    got = api.solve(kernel, backend='cpp', qintervals=qints, n_workers=1, **kw)
    _assert_same(got, api.solve(kernel, backend='cpp', qintervals=qints, n_workers=4, **kw), kernel)
    _assert_same(got, jsolve(kernel, backend='cpp', qintervals=_jax_qints(qints), **kw), kernel)
    _assert_same(got, api.solve(kernel, backend='cpu', qintervals=qints, **kw), kernel)


def test_auto_resolves_as_the_reference(monkeypatch):
    """'auto' is 'cpp' when the native solver builds, else 'cpu'."""
    rng = np.random.default_rng(12)
    kernel = _random_kernel(rng, 7, 4, 4)
    routes = []
    real_native, real_solve = native.solve_native, api._solve_task
    monkeypatch.setattr(native, 'solve_native', lambda *a, **k: routes.append('cpp') or real_native(*a, **k))
    monkeypatch.setattr(api, '_solve_task', lambda t: routes.append('cpu') or real_solve(t))
    got = api.solve(kernel, backend='auto')
    assert set(routes) == {'cpp'}
    routes.clear()
    monkeypatch.setattr(native, 'has_solver', lambda: False)
    _assert_same(api.solve(kernel, backend='auto'), got, kernel)
    assert set(routes) == {'cpu'}
    _assert_same(got, jsolve(kernel, backend='auto'), kernel)


@pytest.mark.parametrize('backend', ['cpp', 'auto'])
def test_tracer_solves_rows_with_the_native_solver(backend, monkeypatch):
    """``solver_options={'backend': 'cpp' | 'auto'}`` reaches ``solve`` on the
    tracer's per-row path and runs the native solver; the program equals
    the Python solver's byte for byte."""
    calls = []
    real = native.solve_native
    monkeypatch.setattr(native, 'solve_native', lambda *a, **k: calls.append(k['n_threads']) or real(*a, **k))
    small = dict(n_in=6, hidden=(7,), n_out=3)
    got = flagship_comb(**small, backend=backend, n_workers=2)
    assert calls == [2, 2]  # one solve per layer, n_workers as the thread count
    assert np.array_equal(got.to_binary(), flagship_comb(**small, backend='cpu').to_binary())


# ---------------------------------------------------------------------------
# the interpreters: native.run_binary and runtime.numpy_backend
# ---------------------------------------------------------------------------

CORPUS = (*jsynth.FAMILIES, 'mixed', 'wide 0', 'wide 1')


def _corpus_case(name: str):
    """A ``da4ml_tpu.ir.synth`` program (its binary) and seeded inputs: one
    opcode family (lookup tables among them), all families, or wide int64."""
    rng = np.random.default_rng(90_000 + CORPUS.index(name))
    if name in jsynth.FAMILIES:
        jprog = jsynth.random_program(rng, n_ops=160, n_in=5, n_out=4, families=(name,))
    else:
        jprog = jsynth.random_program(rng, n_ops=300, n_in=6, n_out=5, wide=name.startswith('wide'))
    if name.startswith('wide'):
        assert jprog.max_width + 2 > 31  # the int64 path
    return jbin.encode(jprog), jsynth.random_inputs(rng, jprog, 257)


@pytest.mark.parametrize('name', CORPUS)
def test_native_run_binary_matches_jax_and_reference(name):
    binary, data = _corpus_case(name)
    want = reference.run_program(decode(binary), data)
    got = native.run_binary(binary, data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.run_binary(binary, data))
    for n_threads in (1, 3):
        np.testing.assert_array_equal(native.run_binary(binary, data, n_threads=n_threads), want)


@pytest.mark.parametrize('name', CORPUS)
def test_numpy_backend_matches_jax_and_reference(name):
    binary, data = _corpus_case(name)
    want = reference.run_program(decode(binary), data)
    got = numpy_backend.run_binary(binary, data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnumpy_backend.run_binary(binary, data))


def test_run_comb_routes_every_backend():
    comb = flagship_comb(n_in=6, hidden=(8,), n_out=3, backend='cpp')
    data = np.random.default_rng(5).uniform(-8, 8, (300, 6))
    want = reference.run_binary(comb.to_binary(), data)
    np.testing.assert_array_equal(run_comb(comb, data, backend='cpp'), want)
    np.testing.assert_array_equal(run_comb(comb, data, backend='numpy'), want)
    np.testing.assert_array_equal(comb.predict(data, backend='torch', device='cpu'), want)
    np.testing.assert_array_equal(comb.predict(data, backend='cpp', n_threads=2), want)
    with pytest.raises(ValueError, match='Unknown backend'):
        run_comb(comb, data, backend='auto')


def test_program_info_and_invalid_binary():
    binary, _ = _corpus_case('mixed')
    prog = decode(binary)
    info = bindings.program_info(binary)
    assert (info['n_in'], info['n_out'], info['n_ops']) == (prog.n_in, prog.n_out, prog.n_ops)
    assert info == jbindings.program_info(binary)
    with pytest.raises(RuntimeError, match='version mismatch'):
        native.run_binary(np.array([9, 0, 1, 1, 0, 0], dtype=np.int32), np.zeros((1, 1)))
    with pytest.raises(ValueError, match='Input size mismatch'):
        native.run_binary(binary, np.zeros((4, prog.n_in + 1)))


# ---------------------------------------------------------------------------
# the device search's host side: decompose_batch and emit_batch
# ---------------------------------------------------------------------------


def test_decompose_batch_matches_kernel_decompose():
    rng = np.random.default_rng(21)
    kernels = [_random_kernel(rng, n, 4, 4) for n in (4, 6, 8, 8, 5)]
    dcs = [-1, 0, 2, 3, 1]
    for k, dc, (m0, m1) in zip(kernels, dcs, bindings.decompose_batch(kernels, dcs)):
        r0, r1 = kernel_decompose(k, dc)
        np.testing.assert_array_equal(m0, r0)
        np.testing.assert_array_equal(m1, r1)
        np.testing.assert_array_equal(m0 @ m1, k)


class _Calls:
    """Counts the native calls the device search makes (wraps, not replaces)."""

    def __init__(self, monkeypatch):
        self.n = {'decompose_batch': 0, 'emit_batch': 0}
        for name in self.n:
            monkeypatch.setattr(native, name, self._wrap(name, getattr(native, name)))

    def _wrap(self, name, real):
        def fn(*args, **kw):
            self.n[name] += 1
            return real(*args, **kw)

        return fn


@pytest.mark.parametrize('method0', ['wmc', 'mc'])
def test_native_emission_matches_python_and_jax(method0, monkeypatch):
    """``solve_torch_many(device='cpu')`` with native decomposition and
    emission equals the same search with ``has_emit`` patched off, and
    ``solve_jax_many``, op for op (``tests/test_jax_search.py:261-296``)."""
    rng = np.random.default_rng(31 + len(method0))
    kernels = [_random_kernel(rng, n, m, 4) for n, m in ((6, 4), (7, 5), (9, 3), (12, 8))]
    kernels.append(kernels[0].copy())  # a duplicate lane
    qlist = [None, [QInterval(-8.0, 7.0, 0.5)] * 7, None, None, None]
    calls = _Calls(monkeypatch)
    got = ts.solve_torch_many(kernels, method0=method0, qintervals_list=qlist, n_restarts=2, device='cpu')
    assert calls.n['decompose_batch'] == 1 and calls.n['emit_batch'] > 0
    jax_qlist = [_jax_qints(q) for q in qlist]
    want_jax = solve_jax_many(kernels, method0=method0, qintervals_list=jax_qlist, n_restarts=2)
    monkeypatch.setattr(native, 'has_emit', lambda: False)
    want_py = ts.solve_torch_many(kernels, method0=method0, qintervals_list=qlist, n_restarts=2, device='cpu')
    assert calls.n['decompose_batch'] == 1
    for k, a, b, c in zip(kernels, got, want_py, want_jax):
        _assert_same(a, b, k)
        _assert_same(a, c, k)


def test_native_emission_under_latency_budget(monkeypatch):
    """hard_dc >= 0 (the dc ladder as lanes, the terminal lane) and sized
    adders, native against Python emission and the JAX package's search."""
    rng = np.random.default_rng(41)
    kernels = [_random_kernel(rng, 8, 6, 4), _random_kernel(rng, 5, 5, 3)]
    kw = dict(hard_dc=1, decompose_dc=-2, search_all_decompose_dc=False, adder_size=6, carry_size=8)
    got = ts.solve_torch_many(kernels, device='cpu', **kw)
    want_jax = solve_jax_many(kernels, **kw)
    monkeypatch.setattr(native, 'has_emit', lambda: False)
    want_py = ts.solve_torch_many(kernels, device='cpu', **kw)
    for k, a, b, c in zip(kernels, got, want_py, want_jax):
        _assert_same(a, b, k)
        _assert_same(a, c, k)


def test_raw_handles_materialize_as_python_emission(monkeypatch):
    """With the native library, ``solve_single_lanes`` hands back ``RawComb`` handles whose
    cost, output intervals and latencies are read from the arrays, and whose
    ``CombLogic`` equals the Python emission's."""
    rng = np.random.default_rng(51)
    lanes = [ts._Lane(_random_kernel(rng, 6, 5, 4), [QInterval(-8.0, 7.0, 1.0)] * 6, [float(i % 2) for i in range(6)],
                      m) for m in ('wmc', 'mc-dc')]  # fmt: skip
    lanes.append(ts._Lane(lanes[0].kernel, lanes[0].qintervals, lanes[0].latencies, 'wmc', perm=np.arange(6)[::-1].copy()))
    raw = ts.solve_single_lanes(lanes, 6, 8, device='cpu')
    assert all(isinstance(s, bindings.RawComb) for s in raw)
    monkeypatch.setattr(native, 'has_emit', lambda: False)
    py = ts.solve_single_lanes([ts._Lane(ln.kernel, ln.qintervals, ln.latencies, ln.method, perm=ln.perm)
                                for ln in lanes], 6, 8, device='cpu')  # fmt: skip
    for r, p in zip(raw, py):
        assert r.cost == p.cost and r.out_qint == p.out_qint and r.out_latency == p.out_latency
        assert _stage_sig(ts._as_comb(r)) == _stage_sig(p)


def test_include_host_solves_with_auto(monkeypatch):
    seen = []
    real = api.solve
    monkeypatch.setattr(ts._host_api, 'solve', lambda *a, **k: seen.append(k['backend']) or real(*a, **k))
    rng = np.random.default_rng(61)
    kernel = _random_kernel(rng, 6, 4, 4)
    got = ts.solve_torch_many([kernel], include_host=True, device='cpu')[0]
    assert seen == ['auto']
    _assert_same(got, api.solve(kernel, backend='cpp'), kernel)


# ---------------------------------------------------------------------------
# the flagship and the library
# ---------------------------------------------------------------------------


def _graft_flagship():
    spec = importlib.util.spec_from_file_location('_graft_entry', ROOT / '__graft_entry__.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._flagship_comb()


def test_flagship_auto_matches_cpu_and_jax():
    """The default ``flagship_comb()`` ('auto': the native solver) gives the
    JAX package's ``_flagship_comb()`` program byte for byte (both 'auto'),
    and the port's 'cpu' one at a small width."""
    got = flagship_comb()
    assert np.array_equal(got.to_binary(), _graft_flagship().to_binary())
    assert np.array_equal(flagship_comb(backend='cpp').to_binary(), got.to_binary())
    small = dict(n_in=8, hidden=(16, 8), n_out=3)
    assert np.array_equal(flagship_comb(**small, backend='auto').to_binary(),
                          flagship_comb(**small, backend='cpu').to_binary())  # fmt: skip


def test_library_lies_under_the_port_build_dir():
    assert native.is_available() and native.has_solver() and native.has_emit()
    assert bindings.load_error() is None
    path = Path(bindings.load_lib()._name).resolve()
    assert path == build.lib_path() and path.exists()
    assert path.parent == (ROOT / 'build' / 'da4ml_tpu_torch').resolve()
    assert (ROOT / 'da4ml_tpu') not in path.parents and path.parent != build.SRC_DIR.parent
    assert path.name != Path(jbindings.load_lib()._name).name


def test_failed_build_is_reported(monkeypatch, tmp_path):
    """A build that fails leaves the library unloaded with the compiler's
    message in ``load_error()``; 'auto' then solves on the Python solver."""
    monkeypatch.setattr(bindings, '_lib', None)
    monkeypatch.setattr(bindings, '_lib_failed', None)
    monkeypatch.setattr(build, 'SRC_DIR', tmp_path)
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / 'out')
    (tmp_path / 'broken.cc').write_text('int f( {\n')
    assert not native.is_available() and not native.has_solver()
    assert 'g++ failed' in bindings.load_error() and 'broken.cc' in bindings.load_error()
    with pytest.raises(RuntimeError, match='unavailable'):
        native.run_binary(np.zeros(6, np.int32), np.zeros((1, 1)))
    kernel = _random_kernel(np.random.default_rng(71), 5, 3, 3)
    np.testing.assert_array_equal(np.asarray(api.solve(kernel, backend='auto').kernel, np.float64), kernel)
