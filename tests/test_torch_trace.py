"""The port's tracer and host CMVM solver against the JAX package's: the same
numpy weight matrices traced by both with ``backend='cpu'`` give the same
cost, an identical DAIS binary and the same ``predict`` output."""

import numpy as np
import pytest

import da4ml_tpu.cmvm as jcmvm
import da4ml_tpu.trace as jtrace
import da4ml_tpu_torch.cmvm as tcmvm
import da4ml_tpu_torch.trace as ttrace
from da4ml_tpu.ir.types import QInterval as JQInterval
from da4ml_tpu_torch.ir.types import QInterval


def _mlp(trace, dims=(8, 16, 8, 3), seed=11):
    """An MLP with 4-bit integer weights and relu(i=5, f=2) between layers,
    traced by ``trace`` (either package's trace module)."""
    rng = np.random.default_rng(seed)
    n_in = dims[0]
    inp = trace.FixedVariableArrayInput(n_in, hwconf=trace.HWConfig(1, -1, -1), solver_options={'backend': 'cpu'})
    x = inp.quantize(np.ones(n_in), np.full(n_in, 3), np.full(n_in, 2))
    for li in range(len(dims) - 1):
        w = rng.integers(-8, 8, (dims[li], dims[li + 1])).astype(np.float64)
        x = x @ w
        if li < len(dims) - 2:
            x = x.relu(i=np.full(dims[li + 1], 5), f=np.full(dims[li + 1], 2))
    return trace.comb_trace(inp, x)


@pytest.fixture(scope='module')
def combs():
    return _mlp(ttrace), _mlp(jtrace)


def test_trace_same_cost_and_binary(combs):
    port, jax_pkg = combs
    assert port.cost == jax_pkg.cost
    assert port.shape == jax_pkg.shape == (8, 3)
    assert np.array_equal(port.to_binary(), jax_pkg.to_binary())


def test_trace_same_predict(combs):
    port, jax_pkg = combs
    data = np.random.default_rng(5).uniform(-8, 8, (257, 8))
    want = jax_pkg.predict(data, backend='numpy')
    np.testing.assert_array_equal(port.predict(data, backend='torch', device='cpu'), want)
    np.testing.assert_array_equal(port.predict(data, backend='numpy'), want)


def test_trace_replay_matches_numeric(combs):
    """Float replay of the traced program equals its bit-exact execution on
    values on the input grid."""
    port, _ = combs
    data = np.random.default_rng(6).integers(-32, 32, (16, 8)) / 4.0
    rows = np.array([[float(v) for v in port(row)] for row in data])
    np.testing.assert_array_equal(rows, port.predict(data, backend='torch', device='cpu'))


@pytest.mark.parametrize('shape', [(4, 6), (6, 5), (9, 3)])
def test_solve_matches_jax_host_solver(shape):
    rng = np.random.default_rng(sum(shape))
    kernel = rng.integers(-16, 16, shape).astype(np.float64)
    qints = [(-8.0, 7.75, 0.25)] * shape[0]
    port = tcmvm.solve(kernel, qintervals=[QInterval(*q) for q in qints], backend='cpu')
    ref = jcmvm.solve(kernel, qintervals=[JQInterval(*q) for q in qints], backend='cpu')
    assert port.cost == ref.cost
    assert np.array_equal(np.asarray(port.kernel, np.float64), kernel)
    for a, b in zip(port.stages, ref.stages):
        assert np.array_equal(a.to_binary(), b.to_binary())


def test_solve_workers_same_result():
    kernel = np.random.default_rng(9).integers(-8, 8, (8, 6)).astype(np.float64)
    seq = tcmvm.solve(kernel, backend='auto')
    par = tcmvm.solve(kernel, backend='cpu', n_workers=2)
    assert seq.cost == par.cost
    assert all(np.array_equal(a.to_binary(), b.to_binary()) for a, b in zip(seq.stages, par.stages))


@pytest.mark.parametrize('backend', ['jax'])
def test_solve_refuses_unported_backends(backend):
    with pytest.raises(ValueError, match='not ported'):
        tcmvm.solve(np.eye(3), backend=backend)
