"""The port's verifier against the JAX package's, diagnostic for diagnostic.

The same programs go through ``da4ml_tpu.analysis.verify`` and
``da4ml_tpu_torch.analysis.verify``: clean traced and solved programs (the
reference's ``rich_comb``, which holds every opcode family, traced by both
packages with the native solver and byte-identical), and every corruption of
the JAX package's ``COMB_CORRUPTIONS`` and ``PIPELINE_CORRUPTIONS``, applied
by the JAX package and carried across with ``to_dict()`` and the port's
``from_dict(verify=False)``. Each diagnostic's rule, severity, op index,
stage, opcode and message are compared exactly. Then the load-time check:
the port's ``from_dict``/``load`` with ``verify=True`` raise exactly where
the reference's raise."""

import json

import numpy as np
import pytest

import da4ml_tpu.analysis as janalysis
import da4ml_tpu.ir as jir
import da4ml_tpu.trace as jtrace
import da4ml_tpu_torch.analysis as tanalysis
import da4ml_tpu_torch.ir as tir
import da4ml_tpu_torch.trace as ttrace
from da4ml_tpu.analysis import COMB_CORRUPTIONS, PIPELINE_CORRUPTIONS, corruption_by_name


def _rich(trace):
    """``tests/test_verifier.py``'s ``rich_comb``, traced by ``trace`` with the
    native solver."""
    rng = np.random.default_rng(7)
    inp = trace.FixedVariableArrayInput((8,), hwconf=trace.HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(8), np.full(8, 3), np.full(8, 2))
    w = rng.integers(-4, 4, (8, 3)).astype(np.float64)
    outs = [
        np.sin(x[:4]).quantize(np.ones(4), np.ones(4), np.full(4, 4)),
        x[:4] * x[4:],
        np.where(x[:2] > 0, x[2:4], 1.25),
        x[:4] & x[4:],
        ~x[:2],
        (x @ w).relu(),
        x[1:3] + 1.5,
    ]
    return trace.comb_trace(inp, np.concatenate([np.atleast_1d(v) for v in outs]))


@pytest.fixture(scope='module')
def rich():
    """(the port's trace, the reference's trace) of ``rich_comb``."""
    return _rich(ttrace), _rich(jtrace)


def _solved_reference():
    """The reference's ``Pipeline`` of one solved 6x5 kernel, the fixture
    ``solved_pipeline`` of ``tests/test_verifier.py``."""
    from da4ml_tpu.cmvm import solve

    kernel = np.random.default_rng(3).integers(-8, 8, (6, 5)).astype(np.float64)
    return solve(kernel, qintervals=[jir.QInterval(-8.0, 7.0, 1.0)] * 6, backend='cpp')


_SOLVED = _solved_reference()


def _applies(corruption, program) -> bool:
    try:
        corruption.apply(program)
    except ValueError:  # the program has no op of the corruption's family
        return False
    return True


#: comb corruptions applied to the solved pipeline's first stage: those whose
#: opcode family the stage holds
STAGE_CORRUPTIONS = [c.name for c in COMB_CORRUPTIONS if _applies(c, _SOLVED.stages[0])]


@pytest.fixture(scope='module')
def solved():
    """(port, reference) of the solved pipeline."""
    return tir.Pipeline.from_dict(_SOLVED.to_dict()), _SOLVED


def _rows(result):
    return [(d.rule, d.severity, d.op_index, d.stage, d.opcode, d.message) for d in result.diagnostics]


def _same_verdict(port_prog, ref_prog, passes=None):
    port, ref = tanalysis.verify(port_prog, passes=passes), janalysis.verify(ref_prog, passes=passes)
    assert _rows(port) == _rows(ref)
    assert port.ok == ref.ok and port.target == ref.target
    assert port.to_dict() == ref.to_dict() and port.format_text() == ref.format_text()
    return port


def _port(ref_prog):
    """The reference program carried across unverified."""
    cls = tir.Pipeline if isinstance(ref_prog, jir.Pipeline) else tir.CombLogic
    return cls.from_dict(ref_prog.to_dict(), verify=False)


def test_rich_comb_byte_identical_and_clean(rich):
    port, ref = rich
    assert np.array_equal(port.to_binary(), ref.to_binary())
    assert {-1, 4, 5, 7, 8, 10} <= {op.opcode for op in port.ops}
    result = _same_verdict(port, ref)
    assert result.ok, result.format_text()


@pytest.mark.parametrize('passes', [None, ('wellformed',), ('qinterval',), ('deadcode',), ('wellformed', 'deadcode')])
def test_clean_programs_same_diagnostics(rich, solved, passes):
    _same_verdict(rich[0], rich[1], passes)
    _same_verdict(solved[0], solved[1], passes)


@pytest.mark.parametrize('seed,shape,qb', [(0, (4, 7), 3), (1, (9, 2), 5)])
def test_solver_programs_same_diagnostics(seed, shape, qb):
    from da4ml_tpu.cmvm import solve

    from da4ml_tpu_torch.cmvm import solve as tsolve

    kernel = np.random.default_rng(seed).integers(-16, 16, shape).astype(np.float64)
    qints = [(-(2.0 ** (qb - 1)), 2.0 ** (qb - 1) - 1, 1.0)] * shape[0]
    ref = solve(kernel, qintervals=[jir.QInterval(*q) for q in qints], backend='cpp')
    port = tsolve(kernel, qintervals=[tir.QInterval(*q) for q in qints], backend='cpp')
    assert all(np.array_equal(a.to_binary(), b.to_binary()) for a, b in zip(port.stages, ref.stages))
    assert _same_verdict(port, ref).ok


@pytest.mark.parametrize('name', [c.name for c in COMB_CORRUPTIONS])
def test_comb_corruption_same_diagnostics(rich, name):
    corruption = corruption_by_name(name)
    bad = corruption.apply(rich[1])
    result = _same_verdict(_port(bad), bad)
    assert result.by_rule(corruption.expect_rule), result.format_text()


@pytest.mark.parametrize('name', [c.name for c in PIPELINE_CORRUPTIONS] + STAGE_CORRUPTIONS)
def test_pipeline_corruption_same_diagnostics(solved, name):
    """Pipeline corruptions, and the comb corruptions applied to the solved
    pipeline's first stage."""
    corruption = corruption_by_name(name)
    ref = solved[1]
    if corruption in PIPELINE_CORRUPTIONS:
        bad = corruption.apply(ref)
    else:
        bad = jir.Pipeline(stages=(corruption.apply(ref.stages[0]),) + ref.stages[1:])
    result = _same_verdict(_port(bad), bad)
    assert result.by_rule(corruption.expect_rule), result.format_text()


def test_conformance_pass_is_not_silently_skipped(rich, monkeypatch):
    """The opt-in pass runs every mode on ``device``; each executor mode that
    cannot run (no CUDA device here) is a C401 diagnostic, never a skip."""
    assert tanalysis.verify(rich[0], passes=('conformance',), device='cpu').ok
    monkeypatch.setattr('torch.cuda.is_available', lambda: False)
    result = tanalysis.verify(rich[0], passes=('conformance',))
    c401 = result.by_rule('C401')
    modes = ('unroll', 'scan', 'level', 'pallas')
    assert len(c401) == len(modes), result.format_text()
    for mode, d in zip(modes, c401):
        assert f"backend '{mode}' raised RuntimeError" in d.message, result.format_text()
    with pytest.raises(ValueError, match='unknown analysis pass'):
        tanalysis.verify(rich[0], passes=('nope',))


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize('name', [c.name for c in COMB_CORRUPTIONS])
def test_from_dict_raises_where_the_reference_raises(rich, name):
    """``CombLogic.from_dict(verify=True)`` (the default) in both packages on
    every corrupted dict: the same error type and text, or neither raises."""
    blob = corruption_by_name(name).apply(rich[1]).to_dict()
    want = _raises(lambda: jir.CombLogic.from_dict(json.loads(json.dumps(blob))))
    got = _raises(lambda: tir.CombLogic.from_dict(json.loads(json.dumps(blob))))
    assert got == want
    if want is not None:
        assert want[0] == 'VerificationError' and 'CombLogic.from_dict' in want[1]
    assert tir.CombLogic.from_dict(blob, verify=False) is not None


def test_from_dict_rejects_corrupt_program(rich):
    """``tests/test_verifier.py::test_from_dict_rejects_corrupt_program`` on the
    port: an add op's forward reference fails at load."""
    blob = rich[0].to_dict()
    blob['ops'][5][0] = len(blob['ops']) + 3
    blob['ops'][5][2] = 0
    with pytest.raises(tanalysis.VerificationError, match='CombLogic.from_dict') as port:
        tir.CombLogic.from_dict(blob)
    with pytest.raises(janalysis.VerificationError) as ref:
        jir.CombLogic.from_dict(blob)
    assert str(port.value) == str(ref.value)
    assert tir.CombLogic.from_dict(blob, verify=False) is not None


def test_load_rejects_corrupt_file(tmp_path, solved):
    blob = solved[1].to_dict()
    blob['stages'][0]['out_idxs'][0] = 10**6
    path = tmp_path / 'pipeline.json'
    path.write_text(json.dumps(blob))
    with pytest.raises(tanalysis.VerificationError, match='Pipeline.from_dict') as port:
        tir.Pipeline.load(path)
    with pytest.raises(janalysis.VerificationError) as ref:
        jir.Pipeline.load(path)
    assert str(port.value) == str(ref.value)
    assert tir.Pipeline.load(path, verify=False) is not None
    bad = corruption_by_name('pipeline.stage_interface').apply(solved[1])
    path.write_text(json.dumps(bad.to_dict()))
    with pytest.raises(tanalysis.VerificationError, match='W120'):
        tir.Pipeline.load(path)


def test_roundtrip_still_clean(tmp_path, rich):
    path = tmp_path / 'comb.json'
    rich[0].save(path)
    assert tir.CombLogic.load(path) == rich[0]
