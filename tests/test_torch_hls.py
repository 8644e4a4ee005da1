"""The port's HLS codegen against the JAX package's, file for file, and its
g++ emulator against the interpreters.

Programs are traced by both packages with the native solver
(byte-identical), then written by each package's ``HLSModel`` in each
flavour (``vitis``, ``hlslib``, ``oneapi``): every file of the two projects
(``src/{name}.hh``, ``src/dais_hls.hh``, ``src/bridge.cc``, the synthesis top
and build script, ``model/``, ``metadata.json``) is byte-identical, for a
comb, a pipeline, a lookup-table program and a depthwise conv. The emulator
each package builds with g++ runs numpy-seeded samples: its outputs equal
the port's reference interpreter, ``predict(backend='interp',
device='cpu')`` and the JAX package's emulator exactly — on one program that
holds every op case of ``tests/test_torch_trace_ops.py``, so one build
covers the op matrix of ``tests/test_hls_codegen.py``."""

import shutil
from pathlib import Path

import numpy as np
import pytest

import da4ml_tpu.codegen as jcodegen
import da4ml_tpu.trace as jtrace
import da4ml_tpu_torch.codegen as tcodegen
from da4ml_tpu_torch.analysis import VerificationError, corruption_by_name
from da4ml_tpu_torch.ir.dais_binary import decode
from da4ml_tpu_torch.runtime import reference
from test_torch_codegen import _both, _depthwise, _files
from test_torch_trace_ops import CASES, N, PACKAGES

if shutil.which('g++') is None:
    pytest.skip('g++ not available', allow_module_level=True)

HLS_FLAVORS = ('vitis', 'hlslib', 'oneapi')
DATA = np.random.default_rng(3).uniform(-8, 8, (256, N))


def _all_cases(m, x):
    """Every op case on one input, outputs concatenated: one program holds
    the op matrix."""
    return np.concatenate([np.ravel(op(m, x)) for op, _ in CASES.values()])


PROGRAMS = {
    'comb': (lambda: _both(CASES['matmul_frac'][0]), -1),
    'pipeline': (lambda: _both(CASES['matmul_int'][0]), 2.0),
    'lookup': (lambda: _both(lambda m, x: np.sin(x).quantize(np.ones(N), np.ones(N), np.full(N, 4))), -1),
    'depthwise_conv': (lambda: tuple(_depthwise(pkg) for pkg in PACKAGES), 1.0),
}


def _stages(solution):
    return solution.stages if hasattr(solution, 'stages') else (solution,)


def _reference(solution, data):
    """The port's reference interpreter, stage by stage."""
    out = data
    for stage in _stages(solution):
        out = reference.run_program(decode(stage.to_binary()), out)
    return out


@pytest.mark.parametrize('flavor', HLS_FLAVORS)
@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_project_files_equal_the_reference(tmp_path, name, flavor):
    make, cutoff = PROGRAMS[name]
    port, ref = make()
    assert np.array_equal(port.to_binary(), ref.to_binary())
    model = tcodegen.HLSModel(port, 'kern', tmp_path / 'port', latency_cutoff=cutoff, flavor=flavor).write()
    jcodegen.HLSModel(ref, 'kern', tmp_path / 'ref', latency_cutoff=cutoff, flavor=flavor).write()
    got, want = _files(tmp_path / 'port'), _files(tmp_path / 'ref')
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    top = {'vitis': 'src/hls_top.cc', 'hlslib': 'src/hls_top.cc', 'oneapi': 'src/hls_top_oneapi.cpp'}[flavor]
    script = {'vitis': 'tcl/build_vitis.tcl', 'hlslib': 'tcl/build_hlslib.sh', 'oneapi': 'tcl/build_oneapi.sh'}[flavor]
    assert {'src/kern.hh', 'src/dais_hls.hh', 'src/bridge.cc', top, script, 'metadata.json'} <= set(got)
    assert model.is_pipeline == (cutoff > 0)


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_emulator_equals_the_interpreters(tmp_path, name):
    make, cutoff = PROGRAMS[name]
    port, ref = make()
    model = tcodegen.HLSModel(port, 'kern', tmp_path / 'port', latency_cutoff=cutoff).write().compile()
    data = np.random.default_rng(11).uniform(-8, 8, (256, port.shape[0]))
    got = model.predict(data, backend='emu')
    np.testing.assert_array_equal(got, _reference(model.solution, data))
    np.testing.assert_array_equal(got, model.predict(data, backend='interp', device='cpu'))
    jmodel = jcodegen.HLSModel(ref, 'kern', tmp_path / 'ref', latency_cutoff=cutoff).write().compile()
    np.testing.assert_array_equal(got, jmodel.predict(data, backend='emu'))


def test_emulator_over_the_op_matrix(tmp_path):
    """Every op case of the trace tests in one kernel: the port's g++
    emulator equals its reference interpreter and the JAX package's
    emulator, at one thread and at eight."""
    port, ref = _both(_all_cases)
    model = tcodegen.HLSModel(port, 'kern', tmp_path / 'port').write().compile()
    got = model.predict(DATA, backend='emu', n_threads=1)
    np.testing.assert_array_equal(got, _reference(port, DATA))
    np.testing.assert_array_equal(model.predict(DATA, backend='emu', n_threads=8), got)
    jmodel = jcodegen.HLSModel(ref, 'kern', tmp_path / 'ref').write().compile()
    np.testing.assert_array_equal(jmodel.predict(DATA, backend='emu'), got)


def test_predict_auto_and_interp(tmp_path):
    """``'auto'`` takes the DAIS executor until the emulator is built, then
    the emulator; ``'interp'`` runs on the given device."""
    port, _ = _both(CASES['matmul_int'][0])
    model = tcodegen.HLSModel(port, 'kern', tmp_path, latency_cutoff=1.0).write()
    want = port.predict(DATA, device='cpu')
    np.testing.assert_array_equal(model.predict(DATA, backend='interp', device='cpu'), want)
    np.testing.assert_array_equal(model.predict(DATA, device='cpu'), want)
    with pytest.raises(RuntimeError, match='compile'):
        model.predict(DATA, backend='emu')
    model.compile()
    assert len(list(Path(tmp_path).glob('libkern_*.so'))) == 1
    np.testing.assert_array_equal(model.predict(DATA), want)


def test_flavor_rejected(tmp_path):
    port, _ = _both(CASES['sum'][0])
    with pytest.raises(ValueError, match='flavor'):
        tcodegen.HLSModel(port, 'kern', tmp_path, flavor='catapult')


def test_hls_precondition(tmp_path):
    """``tests/test_verifier.py::test_hls_precondition`` on the port: a
    copy op reading a lane past the inputs is refused before ``src/``
    exists, with the reference's text."""
    from da4ml_tpu.analysis import corruption_by_name as jcorruption_by_name
    from test_torch_verifier import _rich

    port = corruption_by_name('copy.bad_lane').apply(_rich(PACKAGES[0][0]))
    jbad = jcorruption_by_name('copy.bad_lane').apply(_rich(jtrace))
    assert np.array_equal(port.to_binary(), jbad.to_binary())
    with pytest.raises(VerificationError, match='precondition') as got:
        tcodegen.HLSModel(port, 'bad_model', tmp_path / 'hproj').write()
    assert not (tmp_path / 'hproj' / 'src').exists()
    with pytest.raises(Exception) as want:
        jcodegen.HLSModel(jbad, 'bad_model', tmp_path / 'jproj').write()
    assert str(got.value) == str(want.value)


def test_header_is_a_byte_equal_copy():
    root = Path(__file__).resolve().parents[1]
    ref = root / 'da4ml_tpu' / 'codegen' / 'hls' / 'source' / 'dais_hls.hh'
    port = root / 'da4ml_tpu_torch' / 'codegen' / 'hls' / 'source' / 'dais_hls.hh'
    assert port.read_bytes() == ref.read_bytes()
    text = (root / 'pyproject.toml').read_text()
    assert '"codegen/hls/source/*.hh"' in text[text.index('da4ml_tpu_torch = [') :]
