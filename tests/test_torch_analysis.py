"""The port's conformance, soundness and mutation passes, and its
``DA4ML_VERIFY=1`` post-solve hook, against the JAX package's.

Carried from ``tests/test_optable.py`` (conformance, transfer soundness,
the mutation catalog) and ``tests/test_verifier.py`` (the post-solve hook):
the conformance corpus runs clean through the port's CPU modes (``numpy``,
``cpp`` and ``torch`` on ``device='cpu'``, the kernel's plain version); a
broken backend is caught as C401 at the divergent op; the pass is opt-in;
the transfer-soundness sweep is clean on every table row and gives the
reference's report for the same seed, and a narrowed transfer is caught as
D310; every corruption of the catalog (the reference's names and rule ids)
is caught by the port's verifier with its rule; the hook raises where the
reference's raises, with the same text."""

import json

import numpy as np
import pytest

import da4ml_tpu.analysis as janalysis
import da4ml_tpu.ir.optable as joptable
import da4ml_tpu_torch.analysis as tanalysis
import da4ml_tpu_torch.ir.optable as toptable
from da4ml_tpu_torch.analysis import (
    COMB_CORRUPTIONS,
    OPT_IN_PASSES,
    PASSES,
    PIPELINE_CORRUPTIONS,
    check_conformance,
    check_spec_soundness,
    check_transfer_soundness,
    corruption_by_name,
    run_conformance_corpus,
)
from da4ml_tpu_torch.ir.optable import DAIS_V1_OPCODES, OP_TABLE, OPCODE_TO_SPEC
from da4ml_tpu_torch.ir.synth import random_program


def test_conformance_corpus_all_modes_clean():
    report, diags = run_conformance_corpus(n_programs=3, n_ops=150, n_samples=48, seed=0, device='cpu')
    assert report['ok'], [str(d) for d in diags]
    assert report['modes'] == ['numpy', 'cpp', 'unroll', 'scan', 'level', 'pallas']
    assert set(report['per_opcode']) == {str(oc) for oc in DAIS_V1_OPCODES}
    assert all(info['mismatches'] == 0 for info in report['per_opcode'].values())
    json.dumps(report)  # the report is a JSON-ready artifact


def test_conformance_coverage_gap_flagged(monkeypatch):
    # an add-only corpus leaves most of the table uncovered -> C402 per gap
    import da4ml_tpu_torch.analysis.conformance as conf

    prog = random_program(np.random.default_rng(0), n_ops=40, n_in=4, n_out=2, families=('add',))
    monkeypatch.setattr(conf, 'random_program', lambda *a, **k: prog)
    report, diags = conf.run_conformance_corpus(n_programs=1, n_samples=16, modes=('numpy',))
    gaps = [d for d in diags if d.rule == 'C402']
    assert gaps and not report['ok']
    assert all(d.opcode is not None for d in gaps)


def test_conformance_catches_broken_backend(monkeypatch):
    """An injected numpy-backend bug is a C401 anchored at the divergent op."""
    from da4ml_tpu_torch.runtime import numpy_backend

    prog = random_program(np.random.default_rng(3), n_ops=120, n_in=5, n_out=4)
    real = numpy_backend.run_program

    def broken(p, data, return_buf=False):
        out, buf = real(p, data, return_buf=True)
        bad = next(i for i in range(p.n_ops) if int(p.opcode[i]) == 7)
        buf = buf.copy()
        buf[bad] += 1
        idx = int(p.out_idxs[0]) if int(p.out_idxs[0]) >= 0 else 0
        out = out.copy()
        out[:, 0] = buf[idx] + 1  # force an output divergence too
        return (out, buf) if return_buf else out

    monkeypatch.setattr(numpy_backend, 'run_program', broken)
    diags = check_conformance(prog, modes=('numpy',), n_samples=32)
    assert diags and all(d.rule == 'C401' for d in diags)
    d = diags[0]
    assert d.opcode == 7 and d.op_index is not None
    assert OPCODE_TO_SPEC[d.opcode].family == 'mul'
    assert d.to_dict()['opcode_family'] == 'mul'


@pytest.mark.parametrize('backend', ['cpp', 'torch'])
def test_conformance_reports_a_broken_output_binding(monkeypatch, backend):
    """The modes without an execution buffer (cpp, and the torch backend's
    four executor modes) are attributed through the output binding; a
    backend that raises is a C401 too, not a skip."""
    import da4ml_tpu_torch.analysis.conformance as conf
    from da4ml_tpu_torch.runtime import MODES

    modes = MODES if backend == 'torch' else (backend,)
    prog = random_program(np.random.default_rng(4), n_ops=80, n_in=5, n_out=4)
    real = conf._run_mode

    def off_by_one(p, m, data, device=None):
        out, buf = real(p, m, data, device)
        out = out.copy()
        out[:, 2] += 1.0
        return out, buf

    monkeypatch.setattr(conf, '_run_mode', off_by_one)
    diags = check_conformance(prog, modes=modes, n_samples=16, device='cpu')
    assert len(diags) == len(modes)
    for d in diags:
        assert d.rule == 'C401' and f'first divergent output 2 (bound to op {int(prog.out_idxs[2])})' in d.message

    def raising(p, m, data, device=None):
        raise RuntimeError('kernel build failed')

    monkeypatch.setattr(conf, '_run_mode', raising)
    diags = check_conformance(prog, modes=modes, n_samples=16, device='cpu')
    assert [d.rule for d in diags] == ['C401'] * len(modes)
    for mode, d in zip(modes, diags):
        assert f"backend '{mode}' raised RuntimeError" in d.message


def test_conformance_is_opt_in_pass(monkeypatch):
    assert 'conformance' in PASSES and 'conformance' in OPT_IN_PASSES
    assert OPT_IN_PASSES == janalysis.OPT_IN_PASSES
    prog = random_program(np.random.default_rng(5), n_ops=60, n_in=4, n_out=3)
    assert not check_conformance(prog, modes=('numpy',), n_samples=16)

    import da4ml_tpu_torch.analysis.conformance as conf

    def fail(*a, **k):
        raise AssertionError('the default passes ran the conformance pass')

    monkeypatch.setattr(conf, 'conformance_pass', fail)
    from test_torch_verifier import _rich
    import da4ml_tpu_torch.trace as ttrace

    assert tanalysis.verify(_rich(ttrace)).ok


def test_transfer_soundness_all_rows_clean():
    report, diags = check_transfer_soundness(n_cases=20, n_samples=12, seed=1)
    assert report['ok'], [str(d) for d in diags]
    assert set(report['per_family']) == {spec.key for spec in OP_TABLE}
    want, _ = janalysis.check_transfer_soundness(n_cases=20, n_samples=12, seed=1)
    assert report == want


@pytest.mark.parametrize('key', [spec.key for spec in OP_TABLE])
def test_samplers_equal_the_reference(key):
    """Each row's ``sample`` draws the reference's honest one-op program
    from the same generator state."""
    port = next(s for s in OP_TABLE if s.key == key)
    ref = next(s for s in joptable.OP_TABLE if s.key == key)
    got, want = port.sample(np.random.default_rng(9)), ref.sample(np.random.default_rng(9))
    assert [tuple(o) for o in got.ops] == [tuple(o) for o in want.ops] and got.op_index == want.op_index
    assert (got.tables is None) == (want.tables is None)
    if got.tables is not None:
        assert [t.spec.hash for t in got.tables] == [t.spec.hash for t in want.tables]


def test_soundness_catches_broken_transfer(monkeypatch):
    """A transfer that narrows the add interval is caught as D310."""
    from da4ml_tpu_torch.ir.types import QInterval

    add_spec = next(s for s in OP_TABLE if s.key == 'add')

    def narrowing_transfer(comb, op, q, operand):
        c, _ = toptable._tf_add(comb, op, q, operand)
        return QInterval(c.min / 64.0, c.max / 64.0, c.step), []

    broken = add_spec._replace(transfer=narrowing_transfer)
    monkeypatch.setitem(toptable.OPCODE_TO_SPEC, 0, broken)
    monkeypatch.setitem(toptable.OPCODE_TO_SPEC, 1, broken)
    diags = check_spec_soundness(broken, np.random.default_rng(0), n_cases=10, n_samples=16)
    assert diags and all(d.rule == 'D310' for d in diags)
    assert diags[0].opcode in (0, 1)


def test_mutation_catalog_is_the_references():
    """The table-generated catalog carries the reference's entries (same
    names, families and expected rules), one mutation family per row."""
    got = [(c.name, c.family, c.expect_rule) for c in COMB_CORRUPTIONS + PIPELINE_CORRUPTIONS]
    want = [(c.name, c.family, c.expect_rule) for c in janalysis.COMB_CORRUPTIONS + janalysis.PIPELINE_CORRUPTIONS]
    assert got == want and len(got) == 19
    assert all(spec.mutations for spec in OP_TABLE)
    with pytest.raises(KeyError, match='unknown corruption'):
        corruption_by_name('nope')


@pytest.fixture(scope='module')
def rich():
    from test_torch_verifier import _rich
    import da4ml_tpu_torch.trace as ttrace

    return _rich(ttrace)


@pytest.mark.parametrize('name', [c.name for c in COMB_CORRUPTIONS])
def test_mutation_caught_with_its_rule(rich, name):
    """Each corruption, applied by the port to its own trace, is flagged by
    the port's verifier with the catalog's rule."""
    corruption = corruption_by_name(name)
    result = tanalysis.verify(corruption.apply(rich))
    assert result.by_rule(corruption.expect_rule), result.format_text()


def test_pipeline_mutation_caught():
    from da4ml_tpu_torch.cmvm import solve
    from da4ml_tpu_torch.ir import QInterval

    kernel = np.random.default_rng(3).integers(-8, 8, (6, 5)).astype(np.float64)
    pipe = solve(kernel, qintervals=[QInterval(-8.0, 7.0, 1.0)] * 6, backend='cpp')
    (corruption,) = PIPELINE_CORRUPTIONS
    assert tanalysis.verify(pipe).ok
    assert tanalysis.verify(corruption.apply(pipe)).by_rule('W120')


def test_post_solve_hook_raises_where_the_reference_raises(monkeypatch):
    """``DA4ML_VERIFY=1``: a clean solve passes the hook; a corrupted
    program from the dispatch raises ``VerificationError`` with the
    reference's text; without the variable it passes through."""
    from da4ml_tpu.cmvm import api as japi
    from da4ml_tpu_torch.cmvm import api as tapi

    kernel = np.arange(-3.0, 3.0).reshape(2, 3)
    monkeypatch.setenv('DA4ML_VERIFY', '1')
    assert tapi.solve(kernel, backend='cpp') is not None
    good = japi.solve(kernel, backend='cpp', fallback=False)
    jbad = janalysis.corruption_by_name('pipeline.stage_interface').apply(good)
    from da4ml_tpu_torch.ir import Pipeline

    tbad = Pipeline.from_dict(jbad.to_dict(), verify=False)
    monkeypatch.setattr(japi, '_solve_dispatch', lambda *a, **k: jbad)
    monkeypatch.setattr(tapi, '_solve_dispatch', lambda *a, **k: tbad)
    with pytest.raises(tanalysis.VerificationError, match='DA4ML_VERIFY') as got:
        tapi.solve(kernel, backend='cpp')
    with pytest.raises(janalysis.VerificationError) as want:
        japi.solve(kernel, backend='cpp', fallback=False)
    assert str(got.value) == str(want.value)
    monkeypatch.delenv('DA4ML_VERIFY')
    assert tapi.solve(kernel, backend='cpp') is tbad


def test_lint_opcodes_clean_and_catches_a_new_site(tmp_path):
    """The port's tree passes its own allowlist; a dispatch site in a new
    module fails, and so does an allowlist entry whose file has none."""
    import shutil
    from pathlib import Path

    from da4ml_tpu_torch.analysis.driftlint import ALLOWLIST, lint_opcodes

    root = Path(__file__).resolve().parents[1]
    assert lint_opcodes(root) == ([], [])
    assert all(k.startswith('da4ml_tpu_torch/') for k in ALLOWLIST)
    shutil.copytree(root / 'da4ml_tpu_torch', tmp_path / 'da4ml_tpu_torch', ignore=shutil.ignore_patterns('*.so', '__pycache__'))
    (tmp_path / 'da4ml_tpu_torch' / 'newmod.py').write_text('def f(op):\n    return op.opcode == 7\n')
    (tmp_path / 'da4ml_tpu_torch' / 'trace' / 'pipeline.py').write_text('')
    violations, stale = lint_opcodes(tmp_path)
    assert [(v.path, v.lineno) for v in violations] == [('da4ml_tpu_torch/newmod.py', 2)]
    assert stale == ['da4ml_tpu_torch/trace/pipeline.py']
