"""The port's tracer ops against the JAX package's, op by op.

Each case of ``tests/test_trace_ops.py`` (its ``CASES``, the lookup, sort and
argsort cases and the input-widening case) is traced by both packages on the
same numpy-seeded quantization, with the native solver (``'cpp'``) for the
constant matmuls: the port's DAIS binary (lookup tables included) equals the
JAX package's byte for byte, and the port's ``predict`` (its executor's plain
version on the CPU) equals the JAX package's numpy interpreter and the
quantized numpy golden. Tolerance is exact."""

import numpy as np
import pytest

import da4ml_tpu.trace as jtrace
import da4ml_tpu.trace.ops as jops
import da4ml_tpu_torch.trace as ttrace
import da4ml_tpu_torch.trace.ops as tops
from da4ml_tpu.ops.numeric import numeric_binary_bit_op, numeric_unary_bit_op
from da4ml_tpu.trace.ops.quantization import fixed_quantize

N = 8
PACKAGES = ((ttrace, tops), (jtrace, jops))


def random_kif(rng):
    k = rng.integers(0, 2, N)
    i = rng.integers(-2, 5, N)
    f = rng.integers(-2, 5, N)
    f = np.maximum(f, 1 - k - i)
    return k, i, f


def _trace(pkg, op, k, i, f):
    trace, ops = pkg
    inp = trace.FixedVariableArrayInput(N, hwconf=trace.HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    return trace.comb_trace(inp, op(ops, inp.quantize(k, i, f)))


def _same_program(port, ref) -> None:
    assert np.array_equal(port.to_binary(), ref.to_binary())
    assert port.cost == ref.cost
    pt, rt = port.lookup_tables or (), ref.lookup_tables or ()
    assert len(pt) == len(rt) and all(np.array_equal(a.table, b.table) for a, b in zip(pt, rt))


def check_op(op, gold=None, seed=42):
    """Trace ``op(ops, x)`` with both packages; hold the binaries, the
    predicts and the golden ``gold(row)`` (default: ``op`` on the quantized
    row with the JAX package's ops) equal."""
    rng = np.random.default_rng(seed)
    k, i, f = random_kif(rng)
    port, ref = (_trace(pkg, op, k, i, f) for pkg in PACKAGES)
    _same_program(port, ref)
    data = rng.uniform(-8, 8, (512, N))
    want = ref.predict(data, backend='numpy')
    np.testing.assert_array_equal(port.predict(data, backend='torch', device='cpu'), want)
    gold_fn = gold if gold is not None else (lambda row: op(jops, row))
    golden = np.array([np.asarray(gold_fn(row), dtype=np.float64).ravel() for row in fixed_quantize(data, k, i, f)])
    np.testing.assert_array_equal(want, golden.reshape(want.shape))
    return port


def _elem_qints(k, i, f):
    from da4ml_tpu.ir.types import QInterval

    return [QInterval(-(2.0**ii) * kk, 2.0**ii - 2.0**-ff, 2.0**-ff) for kk, ii, ff in zip(k, i, f)]


def _gold_bit_binary(subop):
    from da4ml_tpu.ir.types import QInterval, minimal_kif

    def out_qint(q0, q1):
        (k0, i0, f0), (k1, i1, f1) = minimal_kif(q0), minimal_kif(q1)
        k, i, f = int(max(k0, k1)), max(i0, i1), max(f0, f1)
        return QInterval(-k * 2.0**i, 2.0**i - 2.0**-f, 2.0**-f)

    def fn(row):
        qints = _elem_qints(*random_kif(np.random.default_rng(42)))
        return np.array([numeric_binary_bit_op(float(a), float(b), subop, qa, qb, out_qint(qa, qb))
                         for a, b, qa, qb in zip(row[:4], row[4:], qints[:4], qints[4:])])  # fmt: skip

    return fn


def _gold_unary_bit(op, same_qint=False):
    def fn(row):
        qints = _elem_qints(*random_kif(np.random.default_rng(42)))
        return np.array([numeric_unary_bit_op(float(a), op, q, q if same_qint else None) for a, q in zip(row, qints)])

    return fn


K1, I2, F2 = np.ones(N), np.full(N, 2), np.full(N, 2)

#: ``tests/test_trace_ops.py``'s CASES, each op taking the package's ``ops``
CASES = {
    'identity': (lambda m, x: x, None),
    'neg': (lambda m, x: -x, None),
    'scale_pow2': (lambda m, x: x * 4, None),
    'scale_np2': (lambda m, x: x * 2.25, None),
    'scale_neg': (lambda m, x: x * -3.5, None),
    'add_pair': (lambda m, x: x[:4] + x[4:], None),
    'sub_pair': (lambda m, x: x[:4] - x[4:], None),
    'cadd': (lambda m, x: x + 1.5, None),
    'cadd_chain': (lambda m, x: (x + 1.5) + 0.25, None),
    'relu': (lambda m, x: m.relu(x), None),
    'relu_if': (lambda m, x: m.relu(x, i=np.full(N, 2), f=np.full(N, 2)), None),
    'relu_rnd': (lambda m, x: m.relu(x, i=np.full(N, 2), f=np.full(N, 2), round_mode='RND'), None),
    'quantize_narrow': (lambda m, x: m.quantize(x, K1, I2, F2), None),
    'quantize_rnd': (lambda m, x: m.quantize(x, K1, I2, F2, round_mode='RND'), None),
    'quantize_sat': (lambda m, x: m.quantize(x, K1, I2, F2, overflow_mode='SAT'), None),
    'quantize_sat_sym': (lambda m, x: m.quantize(x, K1, I2, F2, overflow_mode='SAT_SYM'), None),
    'abs': (lambda m, x: abs(x), None),
    'maximum': (lambda m, x: np.maximum(x[:4], x[4:]), None),
    'minimum': (lambda m, x: np.minimum(x[:4], x[4:]), None),
    'max_reduce': (lambda m, x: np.max(x), None),
    'min_reduce': (lambda m, x: np.min(x), None),
    'sum': (lambda m, x: np.sum(x), None),
    'mean8': (lambda m, x: np.mean(x), None),
    'vmul': (lambda m, x: x[:4] * x[4:], None),
    'square': (lambda m, x: x * x, None),
    'power': (lambda m, x: x[:3] ** 3, None),
    'where': (lambda m, x: np.where(x[:4] > 0, x[:4], x[4:]), None),
    'clip': (lambda m, x: np.clip(x, -1.0, 1.0), None),
    'matmul_var': (lambda m, x: x[:4].reshape(2, 2) @ x[4:].reshape(2, 2), None),
    'matmul_int': (lambda m, x: x @ np.arange(-2 * N, 2 * N).reshape(N, 4), None),
    'matmul_frac': (lambda m, x: x @ (np.arange(-2 * N, 2 * N).reshape(N, 4) * 0.25), None),
    'rmatmul': (lambda m, x: np.arange(-12.0, 12.0).reshape(3, N) @ x, None),
    'einsum': (lambda m, x: np.einsum('i,ij->j', x, np.arange(N * 3).reshape(N, 3) * 1.0), None),
    'einsum_rev': (lambda m, x: np.einsum('ij,j->i', np.arange(N * 3).reshape(3, N) * 1.0, x), None),
    'einsum_elemwise': (lambda m, x: np.einsum('...i,...i->...i', x[:4], x[4:]), None),
    'einsum_batched_mm': (
        lambda m, x: np.einsum('...ij,...jk->...ik', x.reshape(2, 2, 2), x.reshape(2, 2, 2)),
        None,
    ),
    'einsum_bcast_l': (lambda m, x: np.einsum('...i,ij->...j', x.reshape(2, 4), np.arange(12.0).reshape(4, 3)), None),
    'einsum_bcast_r': (lambda m, x: np.einsum('ij,...j->...i', np.arange(12.0).reshape(3, 4), x.reshape(2, 4)), None),
    'einsum_outer': (lambda m, x: np.einsum('i,j->ij', x[:4], x[4:]), None),
    'einsum_collapse': (lambda m, x: np.einsum('ij,jk->k', x.reshape(2, 4), np.arange(12.0).reshape(4, 3)), None),
    'einsum_scalar_out': (lambda m, x: np.einsum('i,i->', x, np.arange(N) * 1.0), None),
    'einsum_full_collapse': (lambda m, x: np.einsum('i,j->j', x, np.arange(4.0)), None),
    'einsum_fn': (lambda m, x: m.einsum('ij,jk->ik', x.reshape(2, 4), np.arange(12.0).reshape(4, 3)), None),
    'dot': (lambda m, x: np.dot(x, np.arange(N) * 1.0), None),
    'gt': (lambda m, x: x[:4] > x[4:], lambda x: (x[:4] > x[4:]).astype(np.float64)),
    'le': (lambda m, x: x[:4] <= x[4:], lambda x: (x[:4] <= x[4:]).astype(np.float64)),
    'and': (lambda m, x: x[:4] & x[4:], _gold_bit_binary(0)),
    'or': (lambda m, x: x[:4] | x[4:], _gold_bit_binary(1)),
    'xor': (lambda m, x: x[:4] ^ x[4:], _gold_bit_binary(2)),
    'not': (lambda m, x: ~x, _gold_unary_bit(0, same_qint=True)),
    'any_elem': (lambda m, x: x.to_bool('any'), _gold_unary_bit(1)),
    'all_elem': (lambda m, x: x.to_bool('all'), _gold_unary_bit(2)),
    'reduce_fn': (lambda m, x: m.reduce(lambda a, b: a + b, x.reshape(2, 4), axis=1), None),
    'leaky_relu': (lambda m, x: m.leaky_relu(x, 0.25), None),
    'relu6': (lambda m, x: m.relu6(x), None),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_op(name):
    op, gold = CASES[name]
    check_op(op, gold)


@pytest.mark.parametrize('fn', ['sin', 'tanh_of_sin'])
def test_lookup(fn):
    """Lazy unary functions lower to lookup tables, equal in both packages."""

    def f(x):
        return np.sin(x) if fn == 'sin' else np.tanh(np.sin(x))

    port = check_op(lambda m, x: f(x).quantize(K1, np.ones(N), np.full(N, 4)), lambda x: fixed_quantize(f(x), 1, 1, 4))
    assert port.lookup_tables


def _seq(pkg, n, i_bits, f_bits, build):
    trace, _ = pkg
    inp = trace.FixedVariableArrayInput(n, hwconf=trace.HWConfig(1, -1, -1))
    q = inp.quantize(np.ones(n), np.full(n, i_bits), np.full(n, f_bits))
    return trace.comb_trace(inp, build(q))


@pytest.mark.parametrize('case', ['sort', 'argsort_gather'])
def test_sort(case):
    """``np.sort`` and an argsort gather: the same comparator network."""
    if case == 'sort':
        n, f_bits, build = 6, 1, np.sort

        def gold(qdata):
            return np.sort(qdata, axis=-1)
    else:
        n, f_bits = 5, 0

        def build(q):
            return (q * 2)[np.argsort(q)].ravel()

        def gold(qdata):
            return 2 * np.sort(qdata, axis=-1)

    port, ref = (_seq(pkg, n, 3, f_bits, build) for pkg in PACKAGES)
    _same_program(port, ref)
    data = np.random.default_rng(7).uniform(-8, 8, (256, n))
    want = gold(fixed_quantize(data, 1, 3, f_bits))
    np.testing.assert_array_equal(ref.predict(data, backend='numpy'), want)
    np.testing.assert_array_equal(port.predict(data, backend='torch', device='cpu'), want)


def test_input_precision_widening():
    """An input quantized twice keeps the widest precision, in both packages."""

    def build(pkg):
        trace, _ = pkg
        inp = trace.FixedVariableArrayInput(4, hwconf=trace.HWConfig(1, -1, -1))
        a = inp.quantize(np.ones(4), np.full(4, 2), np.full(4, 1))
        b = inp.quantize(np.ones(4), np.full(4, 3), np.full(4, 0))
        return trace.comb_trace(inp, a + b)

    port, ref = (build(pkg) for pkg in PACKAGES)
    _same_program(port, ref)
    k, i, f = port.inp_kifs
    assert (i >= 3).all() and (f >= 1).all()


def test_retrace_and_from_kif():
    """Symbolic replay of a traced program re-traces to the same program, and
    ``FixedVariableArray.from_kif`` builds the same roots in both packages."""
    port = check_op(*CASES['matmul_int'])
    hw = ttrace.HWConfig(port.adder_size, port.carry_size, -1)
    inp = [ttrace.FixedVariable(*q, hwconf=hw) for q in port.inp_qint]
    again = ttrace.comb_trace(inp, list(port(inp)))
    assert np.array_equal(again.to_binary(), port.to_binary())

    def from_kif(trace):
        arr = trace.FixedVariableArray.from_kif(np.ones(4), np.full(4, 3), np.full(4, 1), hwconf=trace.HWConfig(1, -1, -1))
        return trace.comb_trace(arr, arr * arr)

    assert np.array_equal(from_kif(ttrace).to_binary(), from_kif(jtrace).to_binary())
