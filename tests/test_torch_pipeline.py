"""The port's ``to_pipeline`` and ``retime_pipeline`` against the JAX package's.

``bench.py``'s two fusion workloads at their small sizes — the separable conv
stack (depthwise and pointwise convolutions, cut at latency 6) and the
relu-attention transformer block (T 4, D 4, F 8, cut at 8) — are traced by
both packages from the same seeded weights. Their stages, cut with and
without retiming, are byte-identical, and the port's stage-by-stage
``Pipeline.predict(backend='torch', device='cpu')`` equals the JAX package's
staged numpy predict. Traced with the device search, the port's on the CPU
(K2's plain version) equals the JAX package's ``'jax'`` op for op; and the
stage digests ``chip_smoke.py`` holds the card's traces to are the JAX
package's. Tolerance is exact."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import da4ml_tpu.trace as jtrace
import da4ml_tpu.trace.ops as jops
import da4ml_tpu_torch.trace as ttrace
import da4ml_tpu_torch.trace.ops as tops

PACKAGES = ((ttrace, tops), (jtrace, jops))


def fusion_workloads(pkg, limited: bool = True, **opts) -> dict:
    """``bench.py``'s ``_run_fusion_workloads`` builders, traced with one
    package: ``{name: (CombLogic, latency cutoff)}``, weights drawn from
    ``default_rng(23)`` in bench.py's order."""
    trace, ops = pkg
    rng = np.random.default_rng(23)

    def conv_stack():
        shape = (5, 5, 2)
        inp = trace.FixedVariableArrayInput(shape, hwconf=trace.HWConfig(1, -1, 6), solver_options=opts or None)
        x = inp.quantize(np.ones(shape), np.full(shape, 2), np.zeros(shape, np.int64))
        h = ops.relu(ops.depthwise_conv2d(x, rng.integers(-3, 4, (3, 3, 2, 1)).astype(np.float64)), i=3, f=0)
        h = ops.relu(ops.conv2d(h, rng.integers(-3, 4, (1, 1, 2, 3)).astype(np.float64)), i=3, f=0)
        h = ops.relu(ops.depthwise_conv2d(h, rng.integers(-2, 3, (2, 2, 3, 1)).astype(np.float64)), i=3, f=0)
        out = ops.conv2d(h, rng.integers(-3, 4, (1, 1, 3, 2)).astype(np.float64))
        return trace.comb_trace(inp, out), 6

    def transformer_block():
        T, D, F = (4, 4, 8) if limited else (8, 8, 16)
        shape = (T, D)
        inp = trace.FixedVariableArrayInput(shape, hwconf=trace.HWConfig(1, -1, 8), solver_options=opts or None)
        x = inp.quantize(np.ones(shape), np.full(shape, 2), np.zeros(shape, np.int64))
        wq, wk, wv = (rng.integers(-2, 3, (D, D)).astype(np.float64) for _ in range(3))
        q = ops.quantize(ops.einsum('td,df->tf', x, wq), 1, 3, 0)
        k = ops.quantize(ops.einsum('td,df->tf', x, wk), 1, 3, 0)
        v = ops.quantize(ops.einsum('td,df->tf', x, wv), 1, 3, 0)
        scores = ops.relu(ops.einsum('td,sd->ts', q, k), i=3, f=0)
        h = ops.quantize(x + ops.quantize(ops.einsum('ts,sd->td', scores, v), 1, 3, 0), 1, 3, 0)
        w1 = rng.integers(-2, 3, (D, F)).astype(np.float64)
        w2 = rng.integers(-2, 3, (F, D)).astype(np.float64)
        ffn = ops.quantize(ops.einsum('tf,fd->td', ops.relu(ops.einsum('td,df->tf', h, w1), i=3, f=0), w2), 1, 3, 0)
        return trace.comb_trace(inp, ops.quantize(h + ffn, 1, 3, 0)), 8

    return {'conv_stack': conv_stack(), 'transformer_block': transformer_block()}


@pytest.fixture(scope='module')
def workloads():
    return tuple(fusion_workloads(pkg) for pkg in PACKAGES)


def _same_stages(a, b) -> None:
    assert len(a.stages) == len(b.stages)
    for sa, sb in zip(a.stages, b.stages):
        assert np.array_equal(sa.to_binary(), sb.to_binary())


NAMES = ('conv_stack', 'transformer_block')


@pytest.mark.parametrize('retiming', [False, True])
@pytest.mark.parametrize('name', NAMES)
def test_to_pipeline_matches_jax(workloads, name, retiming):
    (port, cutoff), (ref, _) = workloads[0][name], workloads[1][name]
    assert np.array_equal(port.to_binary(), ref.to_binary())
    pp = ttrace.to_pipeline(port, cutoff, retiming=retiming)
    jp = jtrace.to_pipeline(ref, cutoff, retiming=retiming)
    assert len(pp.stages) > 1
    _same_stages(pp, jp)
    _same_stages(ttrace.retime_pipeline(pp), jtrace.retime_pipeline(jp))


@pytest.mark.parametrize('name', NAMES)
def test_staged_predict_matches_jax(workloads, name):
    (port, cutoff), (ref, _) = workloads[0][name], workloads[1][name]
    pipe = ttrace.to_pipeline(port, cutoff, retiming=False)
    data = np.random.default_rng(11).uniform(-4, 4, (200, port.shape[0]))
    want = jtrace.to_pipeline(ref, cutoff, retiming=False).predict(data, backend='numpy')
    np.testing.assert_array_equal(pipe.predict(data, backend='torch', device='cpu'), want)
    np.testing.assert_array_equal(port.predict(data, backend='torch', device='cpu'), want)


def test_pipeline_of_lookups_and_muxes():
    """A program with lookup tables and muxes cuts into stages whose tables
    are localized, byte-identical to the JAX package's."""

    def build(pkg):
        trace, ops = pkg
        inp = trace.FixedVariableArrayInput(6, hwconf=trace.HWConfig(1, -1, 2))
        x = inp.quantize(np.ones(6), np.full(6, 2), np.full(6, 2))
        y = np.sin(x).quantize(np.ones(6), np.ones(6), np.full(6, 3))
        z = np.maximum(y[:3] + x[3:], np.tanh(x[:3]).quantize(np.ones(3), np.ones(3), np.full(3, 3)))
        return trace.to_pipeline(trace.comb_trace(inp, ops.relu(z @ np.arange(-4.0, 5.0).reshape(3, 3))), 2)

    port, ref = (build(pkg) for pkg in PACKAGES)
    _same_stages(port, ref)
    assert any(s.lookup_tables for s in port.stages) and len(port.stages) > 1
    data = np.random.default_rng(12).uniform(-4, 4, (100, 6))
    np.testing.assert_array_equal(port.predict(data, device='cpu'), ref.predict(data, backend='numpy'))


@pytest.fixture(scope='module')
def searched():
    """Both workloads traced with the device search: the port's on the CPU
    (K2's plain version) and the JAX package's ``'jax'``."""
    return fusion_workloads(PACKAGES[0], backend='torch', device='cpu'), fusion_workloads(PACKAGES[1], backend='jax')


@pytest.mark.parametrize('name', NAMES)
def test_device_search_matches_jax(searched, name):
    (port, cutoff), (ref, _) = searched[0][name], searched[1][name]
    assert np.array_equal(port.to_binary(), ref.to_binary())
    _same_stages(ttrace.to_pipeline(port, cutoff, retiming=False), jtrace.to_pipeline(ref, cutoff, retiming=False))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_fusion_digests_are_the_reference_stages():
    """``chip_smoke.FUSION_DIGESTS`` are the JAX package's stages of the
    full-size workloads (native solver), and the smoke run's own builders
    give them with the port's native solver."""
    smoke = _chip_smoke()
    ref = fusion_workloads(PACKAGES[1], limited=False, backend='cpp')
    port = smoke.fusion_workloads(backend='cpp')
    for name in NAMES:
        comb, cutoff = ref[name]
        assert smoke.stages_digest(jtrace.to_pipeline(comb, cutoff, retiming=False)) == smoke.FUSION_DIGESTS[name]
        assert smoke.stages_digest(port[name]) == smoke.FUSION_DIGESTS[name]
