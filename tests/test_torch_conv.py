"""The port's convolution and pooling front ends against the JAX package's.

The cases of ``tests/test_conv.py`` traced by both packages on the same
numpy-seeded weights and inputs: with the native solver (``'cpp'``) the
port's DAIS binary equals the JAX package's byte for byte and its predict
equals a direct numpy convolution; with ``'torch'`` on the CPU (K2's plain
version) a depthwise convolution — every channel in one lane batch through
``cmvm_multi`` — and the config-5 model of ``bench.py`` at its small size
equal the JAX package's ``'jax'`` traces op for op. ``offload_fn`` and
``cmvm_multi`` are held the same way. Tolerance is exact."""

import numpy as np
import pytest

import da4ml_tpu.trace as jtrace
import da4ml_tpu.trace.ops as jops
import da4ml_tpu_torch.trace as ttrace
import da4ml_tpu_torch.trace.ops as tops
from da4ml_tpu_torch.cmvm import torch_search

PACKAGES = ((ttrace, tops), (jtrace, jops))


def _np_conv2d(x, w, strides=(1, 1), padding='valid', dilation=(1, 1)):
    kh, kw, cin, cout = w.shape
    sh, sw = strides
    dh, dw = dilation
    H, W, _ = x.shape
    if padding == 'same':

        def pad_amt(size, k, s, d):
            keff = (k - 1) * d + 1
            total = max((-(-size // s) - 1) * s + keff - size, 0)
            return total // 2, total - total // 2

        x = np.pad(x, (pad_amt(H, kh, sh, dh), pad_amt(W, kw, sw, dw), (0, 0)))
        H, W = x.shape[:2]
    Ho, Wo = (H - (kh - 1) * dh - 1) // sh + 1, (W - (kw - 1) * dw - 1) // sw + 1
    out = np.zeros((Ho, Wo, cout))
    for ho in range(Ho):
        for wo in range(Wo):
            patch = x[ho * sh : ho * sh + kh * dh : dh, wo * sw : wo * sw + kw * dw : dw]
            out[ho, wo] = np.tensordot(patch, w, axes=([0, 1, 2], [0, 1, 2]))
    return out


def _traced(pkg, shape, build, backend='cpp', i_bits=3, **opts):
    trace, ops = pkg
    inp = trace.FixedVariableArrayInput(shape, hwconf=trace.HWConfig(1, -1, -1), solver_options={'backend': backend, **opts})
    x = inp.quantize(np.ones(shape), np.full(shape, i_bits), np.zeros(shape, np.int64))
    return trace.comb_trace(inp, build(ops, x))


def check(shape, build, ref_fn, seed=0, **kw):
    """Both packages' traces are byte-identical; the port's predict equals
    ``ref_fn`` (a numpy computation) on integer inputs; returns the port's."""
    port, ref = (_traced(pkg, shape, build, **kw) for pkg in PACKAGES)
    assert np.array_equal(port.to_binary(), ref.to_binary())
    data = np.random.default_rng(seed).integers(-8, 8, (32, *shape)).astype(np.float64)
    out = port.predict(data.reshape(len(data), -1), backend='torch', device='cpu')
    want = np.stack([ref_fn(d) for d in data]).reshape(len(data), -1)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ref.predict(data.reshape(len(data), -1), backend='numpy'), want)
    return port


def _weights(seed, shape, lo=-4, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.float64)


@pytest.mark.parametrize('padding', ['valid', 'same'])
@pytest.mark.parametrize('strides', [(1, 1), (2, 2)])
def test_conv2d(padding, strides, monkeypatch):
    monkeypatch.setenv('DA4ML_RUN_MODE', 'level')  # the subject is not the mode: no race
    w = _weights(1, (3, 3, 2, 3))
    check((6, 7, 2), lambda m, x: m.conv2d(x, w, strides=strides, padding=padding),
          lambda d: _np_conv2d(d, w, strides, padding))  # fmt: skip


def test_conv2d_dilation():
    w = _weights(2, (3, 3, 1, 2))
    check((8, 8, 1), lambda m, x: m.conv2d(x, w, dilation=(2, 2)), lambda d: _np_conv2d(d, w, dilation=(2, 2)))


@pytest.mark.parametrize('padding', ['valid', 'same'])
def test_conv1d(padding):
    w = _weights(3, (3, 2, 4))
    check((9, 2), lambda m, x: m.conv1d(x, w, stride=2, padding=padding),
          lambda d: _np_conv2d(d[None], w[None], (1, 2), padding)[0])  # fmt: skip


@pytest.mark.parametrize('padding', ['valid', 'same'])
def test_max_pool2d(padding):
    def ref(d):
        Ho, Wo = (3 if padding == 'same' else 2), 3
        out = np.full((Ho, Wo, 2), -np.inf)
        for ho in range(Ho):
            for wo in range(Wo):
                out[ho, wo] = d[ho * 2 : ho * 2 + 2, wo * 2 : wo * 2 + 2].reshape(-1, 2).max(axis=0)
        return out

    check((5, 6, 2), lambda m, x: m.max_pool2d(x, (2, 2), padding=padding), ref)


@pytest.mark.parametrize('pool', ['avg_pool2d', 'max_pool1d', 'avg_pool1d'])
def test_pools(pool):
    if pool == 'avg_pool2d':
        check((6, 6, 1), lambda m, x: m.avg_pool2d(x, (2, 2)), lambda d: d.reshape(3, 2, 3, 2).mean(axis=(1, 3)))
    elif pool == 'max_pool1d':
        check((8, 2), lambda m, x: m.max_pool1d(x, 2), lambda d: d.reshape(4, 2, 2).max(axis=1))
    else:
        check((8, 2), lambda m, x: m.avg_pool1d(x, 2), lambda d: d.reshape(4, 2, 2).mean(axis=1))


def test_pad_and_upsample():
    def build(m, x):
        return m.upsample_nearest(m.zero_pad(x, [(1, 1), (1, 1)]), (2, 2))

    def ref(d):
        return np.repeat(np.repeat(np.pad(d, ((1, 1), (1, 1), (0, 0))), 2, axis=0), 2, axis=1)

    check((3, 3, 1), build, ref)


def _np_depthwise2d(x, w, padding='valid'):
    return np.concatenate([_np_conv2d(x[..., c : c + 1], w[:, :, c : c + 1, :], padding=padding)
                           for c in range(w.shape[2])], axis=-1)  # fmt: skip


@pytest.mark.parametrize('padding', ['valid', 'same'])
def test_depthwise_conv2d_cpp(padding):
    w = _weights(4, (3, 3, 3, 2))
    check((5, 5, 3), lambda m, x: m.depthwise_conv2d(x, w, padding=padding), lambda d: _np_depthwise2d(d, w, padding))


def test_depthwise_conv1d_cpp():
    w = _weights(5, (3, 2, 1))
    check((7, 2), lambda m, x: m.depthwise_conv1d(x, w),
          lambda d: _np_depthwise2d(d[None], w[None])[0])  # fmt: skip


class _CountLanes:
    """Counts the port's ``solve_torch_many`` calls and their lanes."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = torch_search.solve_torch_many

        def counted(kernels, *a, **kw):
            self.calls.append(len(kernels))
            return real(kernels, *a, **kw)

        monkeypatch.setattr(torch_search, 'solve_torch_many', counted)


def test_depthwise_conv2d_torch_matches_jax(monkeypatch):
    """All channels of a depthwise convolution go to the device search as one
    lane batch, and the trace equals the JAX package's ``'jax'`` trace op for
    op."""
    w = _weights(6, (3, 3, 3, 2))
    lanes = _CountLanes(monkeypatch)
    port = _traced(PACKAGES[0], (5, 5, 3), lambda m, x: m.depthwise_conv2d(x, w, padding='same'), 'torch', device='cpu')
    ref = _traced(PACKAGES[1], (5, 5, 3), lambda m, x: m.depthwise_conv2d(x, w, padding='same'), 'jax')
    assert len(lanes.calls) == 1 and lanes.calls[0] > 3, lanes.calls
    assert np.array_equal(port.to_binary(), ref.to_binary())


def config5_model(pkg, backend: str, limited: bool = True, **opts):
    """``bench.py``'s ``_trace_model``: an 8×8×3 input (4×4×2 when
    ``limited``), a 3×3 'same' conv, relu, a 2×2 max-pool, dense, relu,
    dense 5; weights from ``default_rng(5)``."""
    trace, ops = pkg
    rng = np.random.default_rng(5)
    side, cin, cmid, dense = (4, 2, 4, 8) if limited else (8, 3, 8, 32)
    flat = (side // 2) ** 2 * cmid
    w1 = rng.integers(-32, 32, (3, 3, cin, cmid)).astype(np.float64)
    w2 = rng.integers(-32, 32, (flat, dense)).astype(np.float64)
    w3 = rng.integers(-32, 32, (dense, 5)).astype(np.float64)
    shape = (side, side, cin)
    inp = trace.FixedVariableArrayInput(shape, hwconf=trace.HWConfig(1, -1, -1), solver_options={'backend': backend, **opts})
    x = inp.quantize(np.ones(shape), np.full(shape, 3), np.full(shape, 2))
    x = ops.conv2d(x, w1, padding='same')
    x = x.relu(i=np.full(x.shape, 6), f=np.full(x.shape, 2))
    x = ops.max_pool2d(x, 2).reshape(-1)
    x = (x @ w2).relu(i=np.full(dense, 7), f=np.full(dense, 2))
    return trace.comb_trace(inp, x @ w3)


@pytest.mark.parametrize('backend', ['cpp', 'torch'])
def test_config5_model_matches_jax(backend, monkeypatch):
    """The config-5 model at its small size: byte-identical to the JAX
    package's with the native solver, and the device search's trace (plain
    version on the CPU) equal to the JAX package's ``'jax'`` trace."""
    monkeypatch.setenv('DA4ML_RUN_MODE', 'level')  # the subject is not the mode: no race
    port = config5_model(PACKAGES[0], backend, **({'device': 'cpu'} if backend == 'torch' else {}))
    ref = config5_model(PACKAGES[1], 'jax' if backend == 'torch' else 'cpp')
    assert np.array_equal(port.to_binary(), ref.to_binary())
    data = np.random.default_rng(8).uniform(-8, 8, (64, port.shape[0]))
    np.testing.assert_array_equal(port.predict(data, backend='torch', device='cpu'), ref.predict(data, backend='numpy'))


def _offload_small_weights(cm, v):
    return np.abs(cm) <= 1


@pytest.mark.parametrize('case', ['partial', 'all'])
def test_offload_fn(case):
    """``offload_fn`` sends the weights it masks to explicit multipliers and
    the rest to the solver, in both packages alike."""
    w = _weights(7, (6, 4), -3, 4)
    fn = _offload_small_weights if case == 'partial' else (lambda cm, v: np.ones(cm.shape, bool))

    def build(m, x):
        return x @ w

    check((6,), build, lambda d: d @ w, offload_fn=fn)


def test_cmvm_multi_matches_per_job():
    """``cmvm_multi`` on the device search (one lane batch for every job)
    equals the JAX package's and the per-job host solves of each job."""
    from da4ml_tpu.trace.fixed_variable_array import cmvm_multi as jmulti
    from da4ml_tpu_torch.trace.fixed_variable_array import cmvm_multi

    rng = np.random.default_rng(9)
    ws = [rng.integers(-8, 8, (4, 3)).astype(np.float64) for _ in range(3)]

    def run(pkg, multi, opts):
        trace, _ = pkg
        inp = trace.FixedVariableArrayInput((3, 4), hwconf=trace.HWConfig(1, -1, -1), solver_options=opts)
        x = inp.quantize(np.ones((3, 4)), np.full((3, 4), 3), np.full((3, 4), 1))
        jobs = [(w, trace.FixedVariableArray(x._vars[j : j + 1], opts)) for j, w in enumerate(ws)]
        outs = multi(jobs, opts)
        return trace.comb_trace(inp, np.concatenate([np.array(o).ravel() for o in outs]))

    port = run(PACKAGES[0], cmvm_multi, {'backend': 'torch', 'device': 'cpu'})
    assert np.array_equal(port.to_binary(), run(PACKAGES[1], jmulti, {'backend': 'jax'}).to_binary())
    host = run(PACKAGES[0], cmvm_multi, {'backend': 'cpu'})
    data = np.random.default_rng(10).uniform(-8, 8, (32, 12))
    np.testing.assert_array_equal(port.predict(data, device='cpu'), host.predict(data, device='cpu'))
