"""Names the port's ported modules carry for the reference's callers:
``ir.synth.opcode_counts`` and ``random_pipeline``, ``ir.types.qint_scale``
and ``qint_neg``, and the aliases ``trace.tracer.gather_variables``,
``trace.fixed_variable.to_csd_powers`` and
``trace.fixed_variable_array.RetardedFixedVariableArray``. Each is held to
the JAX package's with the same seeds and inputs."""

import numpy as np
import pytest

import da4ml_tpu.ir.synth as jsynth
import da4ml_tpu.ir.types as jtypes
import da4ml_tpu.trace.fixed_variable as jfv
import da4ml_tpu.trace.fixed_variable_array as jfva
import da4ml_tpu.trace.tracer as jtracer
import da4ml_tpu_torch.ir.synth as tsynth
import da4ml_tpu_torch.ir.types as ttypes
import da4ml_tpu_torch.trace.fixed_variable as tfv
import da4ml_tpu_torch.trace.fixed_variable_array as tfva
import da4ml_tpu_torch.trace.tracer as ttracer
from da4ml_tpu.ir.dais_binary import encode as jencode
from da4ml_tpu_torch.ir.dais_binary import encode as tencode


@pytest.mark.parametrize('seed', [0, 1])
def test_opcode_counts_equal_the_reference(seed):
    def corpus(synth):
        rng = np.random.default_rng(seed)
        return [synth.random_program(rng, n_ops=150, n_in=6, n_out=5, wide=k == 2) for k in range(3)]

    got, want = tsynth.opcode_counts(corpus(tsynth)), jsynth.opcode_counts(corpus(jsynth))
    assert got == want and sum(got.values()) == 3 * 150
    assert tsynth.opcode_counts([]) == jsynth.opcode_counts([])


@pytest.mark.parametrize('n_stages,families', [(1, tsynth.FAMILIES), (3, tsynth.FAMILIES), (4, ('add', 'mux'))])
def test_random_pipeline_equals_the_reference(n_stages, families):
    got = tsynth.random_pipeline(np.random.default_rng(n_stages), n_stages=n_stages, n_ops=60, families=families)
    want = jsynth.random_pipeline(np.random.default_rng(n_stages), n_stages=n_stages, n_ops=60, families=families)
    assert len(got) == len(want) == n_stages
    for g, w in zip(got, want):
        assert np.array_equal(tencode(g), jencode(w))
    for a, b in zip(got[:-1], got[1:]):
        assert a.n_out == b.n_in and (a.out_idxs >= 0).all() and not a.out_negs.any()


def test_qint_scale_and_neg_equal_the_reference():
    rng = np.random.default_rng(3)
    for _ in range(50):
        lo = float(rng.integers(-64, 64)) / 4
        hi = lo + float(rng.integers(0, 64)) / 4
        step = 2.0 ** int(rng.integers(-3, 3))
        scale = float(rng.choice([-1, 1])) * 2.0 ** int(rng.integers(-4, 5))
        tq, jq = ttypes.QInterval(lo, hi, step), jtypes.QInterval(lo, hi, step)
        assert tuple(ttypes.qint_scale(tq, scale)) == tuple(jtypes.qint_scale(jq, scale))
        assert tuple(ttypes.qint_neg(tq)) == tuple(jtypes.qint_neg(jq))


def test_aliases_name_the_same_objects_as_the_reference():
    assert ttracer.gather_variables is ttracer.collect_graph
    assert tfv.to_csd_powers is tfv.csd_terms
    assert tfva.RetardedFixedVariableArray is tfva.LazyUnaryArray
    rng = np.random.default_rng(4)
    for x in [0.0, 1.0, -3.0, 0.375, 7.75, *rng.uniform(-100, 100, 20).round(3).tolist()]:
        assert list(tfv.to_csd_powers(x)) == list(jfv.to_csd_powers(x))


def test_gather_variables_equals_the_reference_on_a_trace():
    def graph(trace, fva):
        inp = fva.FixedVariableArrayInput((6,), hwconf=trace.HWConfig(1, -1, -1))
        x = inp.quantize(np.ones(6), np.full(6, 3), np.full(6, 1))
        w = np.random.default_rng(5).integers(-4, 4, (6, 3)).astype(np.float64)
        out = (x @ w).relu()
        lazy = np.sin(x[:2])
        assert isinstance(lazy, fva.RetardedFixedVariableArray)
        return list(inp._vars.ravel()), list(out._vars.ravel()) + list(lazy.quantize(1, 1, 4)._vars.ravel())

    import da4ml_tpu.trace as jtrace
    import da4ml_tpu_torch.trace as ttrace

    (tn, tslot), (jn, jslot) = ttracer.gather_variables(*graph(ttrace, tfva)), jtracer.gather_variables(*graph(jtrace, jfva))
    assert len(tn) == len(jn) and sorted(tslot.values()) == sorted(jslot.values())
    assert [(v.opr, v.latency, v.low, v.high, v.step) for v in tn] == [(v.opr, v.latency, v.low, v.high, v.step) for v in jn]
