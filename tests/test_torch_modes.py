"""The port's executor modes: ``DaisExecutor(prog, force_i64=None,
mode='auto', device=None)`` with ``mode='unroll'|'scan'|'level'|'pallas'``.

Every mode, on the CPU, equals the port's reference interpreter
(``runtime/reference.py``) bit for bit on the synth corpus, narrow and wide
programs and ``force_i64=True`` included; on three narrow (int32) programs
each mode also equals the JAX package's ``DaisExecutor(prog, mode=same)``
(its ``pallas`` in interpret mode, as its own tests run it). Mode
validation, the ``DA4ML_RUN_MODE`` override, the ``UNROLL_LIMIT`` refusal,
``run_comb(mode=)`` and the entry points' caches follow the reference's,
with its messages.

Isolation: the JAX package's executor flips ``jax_enable_x64`` for the whole
process when it runs a wide program or ``force_i64=True`` (JAX 0.9.0 has no
scoped switch), which would change every later test in the worker. So no
test here runs it on such a program, and an autouse fixture asserts that
no test changed the flag.
"""

import re

import jax
import numpy as np
import pytest
import torch

from da4ml_tpu.ir import dais_binary as jbin
from da4ml_tpu.ir.synth import random_program as jax_random_program
from da4ml_tpu.runtime.jax_backend import DaisExecutor as JaxExecutor
from da4ml_tpu_torch import runtime, telemetry
from da4ml_tpu_torch.ir.dais_binary import encode
from da4ml_tpu_torch.ir.synth import FAMILIES, random_inputs, random_pipeline, random_program
from da4ml_tpu_torch.runtime import reference, run_comb
from da4ml_tpu_torch.runtime import torch_backend as tb
from da4ml_tpu_torch.runtime.torch_backend import MODES, DaisExecutor


@pytest.fixture(autouse=True)
def _x64_unchanged(monkeypatch):
    """No test of this file may change JAX's process-wide x64 flag."""
    monkeypatch.delenv('DA4ML_RUN_MODE', raising=False)
    before = jax.config.read('jax_enable_x64')
    yield
    assert jax.config.read('jax_enable_x64') == before, 'a test changed jax_enable_x64 for the whole process'


def _modes_equal_reference(prog, data, force_i64=None):
    want = reference.run_program(prog, data)
    for mode in MODES:
        ex = DaisExecutor(prog, force_i64=force_i64, mode=mode, device='cpu')
        assert ex.mode == mode
        np.testing.assert_array_equal(ex(data), want, err_msg=f'mode={mode} force_i64={force_i64}')


@pytest.mark.parametrize('wide', [False, True], ids=['narrow', 'wide'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_every_mode_equals_the_reference_interpreter(seed, wide):
    rng = np.random.default_rng(seed)
    prog = random_program(rng, n_ops=220, n_in=6, n_out=5, wide=wide)
    assert DaisExecutor(prog, mode='level', device='cpu').use_i64 == wide
    _modes_equal_reference(prog, random_inputs(rng, prog, 257))  # odd batch


def test_every_mode_on_a_program_of_every_family():
    """One program holding every opcode family (the counterpart of the
    reference's ``test_parity_covers_all_families``), narrow and wide."""
    for wide in (False, True):
        rng = np.random.default_rng(4)
        prog = random_program(rng, n_ops=500, n_in=6, n_out=5, families=FAMILIES, wide=wide)
        # input, add/sub, relu, quant, cadd, const, mux, mul, lookup, bitu, bitb
        assert set(range(11)) <= set(np.abs(prog.opcode).tolist())
        _modes_equal_reference(prog, random_inputs(rng, prog, 65))


@pytest.mark.parametrize('family', FAMILIES)
def test_every_mode_per_family_forced_i64(family):
    """A single-family narrow program through every mode on the int64 path
    (``force_i64=True``) and on its own int32 path."""
    rng = np.random.default_rng(50_000 + FAMILIES.index(family))
    prog = random_program(rng, n_ops=120, n_in=5, n_out=4, families=(family,))
    data = random_inputs(rng, prog, 33)
    ex = DaisExecutor(prog, force_i64=True, mode='scan', device='cpu')
    assert ex.use_i64 and ex.dtype == torch.int64 and ex.meta['f'].dtype == np.int64
    assert DaisExecutor(prog, mode='scan', device='cpu').dtype == torch.int32
    _modes_equal_reference(prog, data, force_i64=True)
    _modes_equal_reference(prog, data)


@pytest.mark.parametrize('seed', [30, 31, 32])
def test_every_mode_equals_the_jax_executor_on_narrow_programs(seed):
    """The same narrow program in both packages, each port mode against the
    reference's executor in the same mode."""
    jprog = jax_random_program(np.random.default_rng(seed), n_ops=100, n_in=5, n_out=4)
    prog = random_program(np.random.default_rng(seed), n_ops=100, n_in=5, n_out=4)
    assert np.array_equal(encode(prog), jbin.encode(jprog)), 'the two generators differ'
    data = random_inputs(np.random.default_rng(seed + 1), prog, 64)
    for mode in MODES:
        jex = JaxExecutor(jprog, mode=mode)
        assert jex.mode == mode and not jex.use_i64
        ex = DaisExecutor(prog, mode=mode, device='cpu')
        np.testing.assert_array_equal(ex(data), jex(data), err_msg=f'mode={mode}')


def test_bad_mode_raises_the_reference_message():
    prog = random_program(np.random.default_rng(5), n_ops=40, n_in=3, n_out=2)
    jprog = jax_random_program(np.random.default_rng(5), n_ops=40, n_in=3, n_out=2)
    with pytest.raises(ValueError) as want:
        JaxExecutor(jprog, mode='fast')
    with pytest.raises(ValueError) as got:
        DaisExecutor(prog, mode='fast', device='cpu')
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=re.escape("got 'torch'")):
        DaisExecutor(prog, mode='torch', device='cpu')


def test_force_i64_takes_a_bool():
    """``force_i64`` is the second parameter, as in the reference: a device
    passed there by position is refused, not read as True."""
    prog = random_program(np.random.default_rng(5), n_ops=40, n_in=3, n_out=2)
    with pytest.raises(TypeError, match='device='):
        DaisExecutor(prog, 'cpu')
    assert DaisExecutor(prog, False, 'scan', 'cpu').dtype == torch.int32
    assert DaisExecutor(prog, np.bool_(True), device='cpu').dtype == torch.int64


def test_auto_is_level_on_the_cpu(monkeypatch):
    """``'auto'`` on the CPU takes the reference's static answer for a
    program under ``AUTOTUNE_MIN_OPS``: ``'unroll'``; with the race off,
    ``'level'`` above ``UNROLL_LIMIT`` (patched down here)."""
    prog = random_program(np.random.default_rng(6), n_ops=60, n_in=4, n_out=3)
    ex = DaisExecutor(prog, device='cpu')
    assert ex.mode == 'unroll'
    monkeypatch.setenv('DA4ML_RUN_AUTOTUNE', '0')
    monkeypatch.setattr(DaisExecutor, 'UNROLL_LIMIT', 50)
    assert DaisExecutor(prog, device='cpu').mode == 'level'
    data = random_inputs(np.random.default_rng(6), prog, 17)
    np.testing.assert_array_equal(ex(data), reference.run_program(prog, data))


def test_unroll_refuses_large_level_runs_it():
    """Past ``UNROLL_LIMIT`` ops unroll refuses with the reference's message;
    level and scan run the same program and equal the reference
    interpreter."""
    rng = np.random.default_rng(7)
    big = random_program(rng, n_ops=20_500, n_in=16, n_out=8, n_levels=24)
    assert big.n_ops > DaisExecutor.UNROLL_LIMIT == JaxExecutor.UNROLL_LIMIT
    with pytest.raises(ValueError, match='unroll') as got:
        DaisExecutor(big, mode='unroll', device='cpu')
    jbig = jax_random_program(np.random.default_rng(7), n_ops=20_500, n_in=16, n_out=8, n_levels=24)
    assert not jbig.max_width + 2 > 31, 'a wide program would flip jax_enable_x64'
    with pytest.raises(ValueError) as want:
        JaxExecutor(jbig, mode='unroll')
    assert str(got.value) == str(want.value)
    data = random_inputs(rng, big, 64)
    ref = reference.run_program(big, data)
    np.testing.assert_array_equal(DaisExecutor(big, mode='level', device='cpu')(data), ref)
    np.testing.assert_array_equal(DaisExecutor(big, mode='scan', device='cpu')(data), ref)


def test_run_mode_env_forces(monkeypatch):
    rng = np.random.default_rng(22)
    prog = random_program(rng, n_ops=120, n_in=6, n_out=4)
    data = random_inputs(rng, prog, 40)
    monkeypatch.setenv('DA4ML_RUN_MODE', 'scan')
    ex = DaisExecutor(prog, mode='auto', device='cpu')
    assert ex.mode == 'scan' and isinstance(ex.plan, tb.ScanPlan)
    np.testing.assert_array_equal(ex(data), reference.run_program(prog, data))
    # explicit modes are not overridden
    assert DaisExecutor(prog, mode='level', device='cpu').mode == 'level'
    assert DaisExecutor(prog, mode='unroll', device='cpu').mode == 'unroll'
    # a value that is not a mode leaves 'auto' to its own rule
    monkeypatch.setenv('DA4ML_RUN_MODE', 'fastest')
    assert DaisExecutor(prog, device='cpu').mode == 'unroll'
    monkeypatch.setenv('DA4ML_RUN_MODE', ' Level ')
    assert DaisExecutor(prog, device='cpu').mode == 'level'
    monkeypatch.setenv('DA4ML_RUN_MODE', ' Unroll ')
    assert DaisExecutor(prog, device='cpu').mode == 'unroll'


def _traced_model(rng):
    """A traced model exercising LUTs, relu, abs and bitwise ops (the
    reference's ``tests/test_runtime_modes.py`` model, on the port's
    tracer)."""
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace

    inp = FixedVariableArrayInput((8,), hwconf=HWConfig(1, -1, -1))
    x = inp.quantize(np.ones(8), np.full(8, 4), np.full(8, 1))
    w = rng.integers(-8, 8, (8, 5)).astype(np.float64)
    y = np.sin(x[:4]).quantize(np.ones(4), np.ones(4), np.full(4, 6))
    z = (x @ w).relu()
    out = np.concatenate([z, y, abs(x[:2]), x[:2] & x[2:4]])
    return comb_trace(inp, out)


def test_run_comb_mode_param():
    rng = np.random.default_rng(8)
    comb = _traced_model(rng)
    data = rng.uniform(-16, 16, (64, 8))
    ref = comb.predict(data, backend='numpy')
    for mode in MODES:
        np.testing.assert_array_equal(run_comb(comb, data, device='cpu', mode=mode), ref, err_msg=mode)
    with pytest.raises(ValueError, match='mode'):
        run_comb(comb, data, backend='cpp', mode='level')
    with pytest.raises(ValueError, match='mode'):
        run_comb(comb, data, device='cpu', mode='jax')


def test_executor_caches_key_on_the_mode(monkeypatch):
    rng = np.random.default_rng(9)
    prog = random_program(rng, n_ops=50, n_in=4, n_out=3)
    b = encode(prog)
    by_mode = {m: tb.executor_for_binary(b, mode=m, device='cpu') for m in MODES}
    assert {m: ex.mode for m, ex in by_mode.items()} == {m: m for m in MODES}
    assert all(tb.executor_for_binary(b, mode=m, device='cpu') is ex for m, ex in by_mode.items())
    auto = tb.executor_for_binary(b, device='cpu')
    assert auto.mode == 'unroll' and auto is not by_mode['unroll']
    monkeypatch.setenv('DA4ML_RUN_MODE', 'level')
    forced = tb.executor_for_binary(b, device='cpu')
    assert forced.mode == 'level' and forced is not auto
    data = random_inputs(rng, prog, 30)
    want = reference.run_program(prog, data)
    for m in MODES:
        np.testing.assert_array_equal(tb.run_binary(b, data, device='cpu', mode=m), want)
    monkeypatch.delenv('DA4ML_RUN_MODE')
    stages = [encode(p) for p in random_pipeline(rng, n_stages=2, n_ops=40)]
    fused = {m: tb.fused_executor_for_binaries(stages, mode=m, device='cpu') for m in ('scan', 'pallas')}
    assert fused['scan'].mode == 'scan' and fused['pallas'].mode == 'pallas' and fused['scan'] is not fused['pallas']
    assert tb.fused_executor_for_binaries(stages, mode='scan', device='cpu') is fused['scan']


class _Events:
    """An in-memory telemetry sink."""

    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass


def test_the_resolved_mode_is_counted_and_traced(monkeypatch):
    telemetry.reset()
    sink = _Events()
    try:
        telemetry.enable()
        telemetry.add_sink(sink)
        prog = random_program(np.random.default_rng(11), n_ops=60, n_in=4, n_out=3)
        data = random_inputs(np.random.default_rng(11), prog, 8)
        for mode in ('level', 'scan', 'auto'):
            DaisExecutor(prog, mode=mode, device='cpu')(data)
        snap = telemetry.metrics_snapshot()
    finally:
        telemetry.reset()
    assert {m: snap[f'run.mode.{m}']['value'] for m in ('level', 'scan', 'unroll')} == dict.fromkeys(
        ('level', 'scan', 'unroll'), 1.0
    )
    calls = [e for e in sink.events if e.get('name') == 'run.call']
    assert [e['args']['mode'] for e in calls] == ['level', 'scan', 'unroll']


def test_scan_is_table_driven_over_device_columns():
    """The scan plan reads its per-op metadata from device columns and
    switches on the branch column; the unroll plan folds each op's
    constants into its own step."""
    prog = random_program(np.random.default_rng(12), n_ops=80, n_in=4, n_out=3)
    scan = DaisExecutor(prog, mode='scan', device='cpu')
    unroll = DaisExecutor(prog, mode='unroll', device='cpu')
    data = random_inputs(np.random.default_rng(12), prog, 9)
    scan(data)
    (table,) = scan.plan._on.values()
    assert all(isinstance(v, torch.Tensor) for v in table.values())
    assert table['id0'].dtype == torch.int64 and table['a_shift'].dtype == torch.int32
    assert len(scan.plan.branches) == prog.n_ops and len(set(map(id, scan.plan.branches))) > 5
    assert len(unroll.plan.steps) == prog.n_ops
    assert not hasattr(unroll.plan, 'table') and not hasattr(scan.plan, 'steps')
    np.testing.assert_array_equal(scan(data), unroll(data))


def test_pipeline_stages_keep_the_default_mode():
    stages = [random_program(np.random.default_rng(13), n_ops=40, n_in=4, n_out=3)]
    pipe = tb.PipelineExecutor(stages, device='cpu')
    assert [s.mode for s in pipe.stages] == ['unroll']


def test_conformance_runs_every_mode_and_skips_unroll_past_its_limit(monkeypatch):
    """Every executor mode conforms; unroll is skipped above its limit and
    only there; the old default-mode name ``'torch'`` is an unknown mode."""
    import da4ml_tpu_torch.analysis.conformance as conf

    assert conf.CONFORMANCE_MODES == ('numpy', 'cpp', *MODES)
    assert DaisExecutor.UNROLL_LIMIT == conf.UNROLL_LIMIT == runtime.UNROLL_LIMIT
    prog = random_program(np.random.default_rng(15), n_ops=90, n_in=5, n_out=4, wide=True)
    assert not conf.check_conformance(prog, modes=MODES, n_samples=24, device='cpu')
    with pytest.raises(ValueError, match="unknown conformance mode 'torch'"):
        conf._run_mode(prog, 'torch', np.zeros((1, prog.n_in)), device='cpu')
    monkeypatch.setattr(DaisExecutor, 'UNROLL_LIMIT', 50)
    monkeypatch.setattr(conf, 'UNROLL_LIMIT', 50)
    with pytest.raises(ValueError, match='UNROLL_LIMIT=50'):
        DaisExecutor(prog, mode='unroll', device='cpu')
    assert not conf.check_conformance(prog, modes=('unroll',), n_samples=24, device='cpu')

