"""The port's RTL codegen against the JAX package's, file for file.

Every case of ``tests/test_torch_trace_ops.py`` (the op cases of
``tests/test_trace_ops.py``) is traced by both packages with the native
solver (byte-identical programs), then written by each package's
``VerilogModel`` and ``VHDLModel``: every file of the two projects (``src/``,
``binder/``, ``tcl/``, ``constraints/``, ``model/``, ``metadata.json``) is
byte-identical. The same holds for pipelined programs at
``register_layers`` 1 and 2, a lookup-table program (``.mem`` files), a
depthwise conv and the flagship cut at latency 5. The port's netlist
simulators run the emitted HDL on numpy-seeded samples: their outputs equal
the reference's simulators and ``predict(backend='interp', device='cpu')``
exactly. The codegen precondition raises on a corrupted program and
``DA4ML_VERIFY=0`` bypasses it; the Verilator and GHDL emulation cases skip
where those tools are missing, as the reference's do."""

from pathlib import Path

import numpy as np
import pytest

import da4ml_tpu.codegen as jcodegen
import da4ml_tpu.trace as jtrace
import da4ml_tpu_torch.codegen as tcodegen
import da4ml_tpu_torch.trace as ttrace
from da4ml_tpu.codegen.rtl.verilog.netlist_sim import simulate_comb as jsim_comb
from da4ml_tpu.codegen.rtl.verilog.netlist_sim import simulate_pipeline as jsim_pipe
from da4ml_tpu.codegen.rtl.vhdl.netlist_sim import simulate_comb_vhdl as jsim_comb_vhdl
from da4ml_tpu.codegen.rtl.vhdl.netlist_sim import simulate_pipeline_vhdl as jsim_pipe_vhdl
from da4ml_tpu_torch.analysis import VerificationError
from da4ml_tpu_torch.codegen.rtl.verilog.netlist_sim import simulate_comb, simulate_pipeline
from da4ml_tpu_torch.codegen.rtl.vhdl.netlist_sim import simulate_comb_vhdl, simulate_pipeline_vhdl
from test_torch_trace_ops import CASES, N, PACKAGES, _trace, random_kif

FLAVORS = ('verilog', 'vhdl')
MODELS = {'verilog': (tcodegen.VerilogModel, jcodegen.VerilogModel), 'vhdl': (tcodegen.VHDLModel, jcodegen.VHDLModel)}
SIMS = {
    'verilog': ((simulate_comb, simulate_pipeline), (jsim_comb, jsim_pipe)),
    'vhdl': ((simulate_comb_vhdl, simulate_pipeline_vhdl), (jsim_comb_vhdl, jsim_pipe_vhdl)),
}
DATA = np.random.default_rng(3).uniform(-8, 8, (48, N))


def _both(op, seed=42):
    """(port, reference) traces of ``op`` on the seeded input quantization."""
    k, i, f = random_kif(np.random.default_rng(seed))
    port, ref = (_trace(pkg, op, k, i, f) for pkg in PACKAGES)
    assert np.array_equal(port.to_binary(), ref.to_binary())
    return port, ref


def _files(root: Path) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob('*')) if p.is_file()}


def _same_project(tmp_path, flavor, port_prog, ref_prog, name='prj', **kw):
    """Write both projects; every file byte-identical. Returns the port's model."""
    tcls, jcls = MODELS[flavor]
    port = tcls(port_prog, name, tmp_path / 'port', **kw).write()
    jcls(ref_prog, name, tmp_path / 'ref', **kw).write()
    got, want = _files(tmp_path / 'port'), _files(tmp_path / 'ref')
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    assert {'metadata.json', 'binder/binder.cc', 'binder/Makefile', 'tcl/build_vivado.tcl'} <= set(got)
    return port


@pytest.mark.parametrize('flavor', FLAVORS)
@pytest.mark.parametrize('name', sorted(CASES))
def test_comb_project_and_netlist(tmp_path, name, flavor):
    port, ref = _both(CASES[name][0])
    model = _same_project(tmp_path, flavor, port, ref)
    assert model.latency_ticks == 0 and not model.is_pipeline
    want = port.predict(DATA, device='cpu')
    (sim, _), (jsim, _) = SIMS[flavor]
    np.testing.assert_array_equal(sim(port, data=DATA), want)
    np.testing.assert_array_equal(jsim(ref, data=DATA), want)
    np.testing.assert_array_equal(model.predict(DATA, backend='netlist'), want)


@pytest.mark.parametrize('flavor', FLAVORS)
@pytest.mark.parametrize('cutoff,register_layers', [(0.5, 1), (1.0, 1), (2.0, 2)])
def test_pipeline_project_and_netlist(tmp_path, flavor, cutoff, register_layers):
    port, ref = _both(CASES['matmul_int'][0])
    model = _same_project(tmp_path, flavor, port, ref, latency_cutoff=cutoff, register_layers=register_layers)
    assert model.is_pipeline and len(model.solution.stages) > 1
    assert model.latency_ticks == (len(model.solution.stages) - 1) * register_layers
    want = port.predict(DATA, device='cpu')
    np.testing.assert_array_equal(model.predict(DATA, backend='interp', device='cpu'), want)
    np.testing.assert_array_equal(model.predict(DATA, backend='netlist'), want)
    (_, sim), (_, jsim) = SIMS[flavor]
    ref_pipe = jtrace.to_pipeline(ref, cutoff)
    np.testing.assert_array_equal(jsim(ref_pipe, data=DATA, register_layers=register_layers), want)
    np.testing.assert_array_equal(sim(model.solution, data=DATA, register_layers=register_layers), want)
    from da4ml_tpu_torch.ir import Pipeline

    assert Pipeline.load(tmp_path / 'port' / 'model' / 'pipeline.json') == model.solution


@pytest.mark.parametrize('flavor', FLAVORS)
def test_lookup_project_writes_mem_files(tmp_path, flavor):
    port, ref = _both(lambda m, x: np.sin(x).quantize(np.ones(N), np.ones(N), np.full(N, 4)))
    model = _same_project(tmp_path, flavor, port, ref)
    mems = sorted((tmp_path / 'port' / 'src').glob('*.mem'))
    assert mems, 'a lookup op must emit a .mem file'
    for m in mems:
        assert all(set(line) <= set('0123456789abcdefx') for line in m.read_text().splitlines())
    np.testing.assert_array_equal(model.predict(DATA, backend='netlist'), port.predict(DATA, device='cpu'))


def _depthwise(pkg):
    trace, ops = pkg
    rng = np.random.default_rng(5)
    shape = (4, 4, 2)
    inp = trace.FixedVariableArrayInput(shape, hwconf=trace.HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(shape), np.full(shape, 3), np.zeros(shape, np.int64))
    y = ops.depthwise_conv2d(x, rng.integers(-4, 4, (2, 2, 2, 1)).astype(np.float64))
    return trace.comb_trace(inp, ops.max_pool1d(y.reshape(9, 2), 3))


@pytest.mark.parametrize('flavor', FLAVORS)
@pytest.mark.parametrize('cutoff', [-1, 1.0])
def test_depthwise_conv_project_and_netlist(tmp_path, flavor, cutoff):
    port, ref = (_depthwise(pkg) for pkg in PACKAGES)
    assert np.array_equal(port.to_binary(), ref.to_binary())
    model = _same_project(tmp_path, flavor, port, ref, latency_cutoff=cutoff)
    data = np.random.default_rng(5).uniform(-8, 8, (32, port.shape[0]))
    np.testing.assert_array_equal(model.predict(data, backend='netlist'), port.predict(data, device='cpu'))


@pytest.mark.parametrize('flavor', FLAVORS)
def test_flagship_project_at_latency_5(tmp_path, flavor, monkeypatch):
    """The README's quick start: the flagship program cut at latency 5. Both
    projects are the ones ``chip_smoke.PROJECT_DIGESTS`` pins."""
    monkeypatch.setenv('DA4ML_RUN_MODE', 'level')  # the subject is not the mode: no race
    import __graft_entry__
    from da4ml_tpu_torch.entry import flagship_comb
    from test_torch_pipeline import _chip_smoke

    port, ref = flagship_comb(backend='cpp'), __graft_entry__._flagship_comb(backend='cpp')
    model = _same_project(tmp_path, flavor, port, ref, name='model', latency_cutoff=5)
    assert len(model.solution.stages) == 5
    smoke = _chip_smoke()
    assert smoke.FIRMWARE_CUTOFF == 5
    assert smoke.project_digest(tmp_path / 'ref') == smoke.PROJECT_DIGESTS[flavor]
    data = np.random.default_rng(20261021).uniform(-8, 8, (16, 16))
    want = model.predict(data, backend='interp', device='cpu')
    np.testing.assert_array_equal(want, port.predict(data, device='cpu'))
    np.testing.assert_array_equal(model.predict(data, backend='netlist'), want)


def _narrowed_mul(rich_ref):
    from da4ml_tpu.analysis import corruption_by_name
    from da4ml_tpu_torch.ir import CombLogic

    bad = corruption_by_name('mul.narrowed_interval').apply(rich_ref)
    return CombLogic.from_dict(bad.to_dict(), verify=False), bad


@pytest.mark.parametrize('flavor', FLAVORS)
def test_codegen_precondition(tmp_path, flavor, monkeypatch):
    from test_torch_verifier import _rich

    port, ref = _narrowed_mul(_rich(jtrace))
    tcls, jcls = MODELS[flavor]
    with pytest.raises(VerificationError, match='precondition') as got:
        tcls(port, 'bad_model', tmp_path / 'proj').write()
    assert not (tmp_path / 'proj' / 'src').exists()
    with pytest.raises(Exception) as want:
        jcls(ref, 'bad_model', tmp_path / 'jproj').write()
    assert type(want.value).__name__ == 'VerificationError' and str(got.value) == str(want.value)
    monkeypatch.setenv('DA4ML_VERIFY', '0')  # explicit bypass
    tcls(port, 'bad_model', tmp_path / 'proj').write()
    assert (tmp_path / 'proj' / 'src').exists()


def test_predict_auto_takes_interp_without_an_emulator(tmp_path):
    port, _ = _both(CASES['matmul_int'][0])
    model = tcodegen.VerilogModel(port, 'prj', tmp_path, latency_cutoff=1.0).write()
    want = port.predict(DATA, device='cpu')
    np.testing.assert_array_equal(model.predict(DATA, device='cpu'), want)
    with pytest.raises(RuntimeError, match='compile'):
        model.predict(DATA, backend='emu')


@pytest.mark.parametrize('flavor', FLAVORS)
def test_compile_needs_its_tools(tmp_path, flavor):
    tcls, _ = MODELS[flavor]
    port, _ = _both(CASES['sum'][0])
    model = tcls(port, 'prj', tmp_path).write()
    if tcls.emulation_available():
        assert model.compile() is model
    else:
        with pytest.raises(RuntimeError, match='not found'):
            model.compile()


@pytest.mark.skipif(not tcodegen.RTLModel.emulation_available(), reason='verilator not installed')
def test_rtl_verilator_emulation(tmp_path):
    port, _ = _both(CASES['matmul_int'][0])
    model = tcodegen.RTLModel(ttrace.to_pipeline(port, 2.0), 'prj', tmp_path).write().compile()
    np.testing.assert_array_equal(model.predict(DATA, backend='emu'), port.predict(DATA, device='cpu'))


@pytest.mark.skipif(not tcodegen.VHDLModel.emulation_available(), reason='verilator/ghdl not installed')
def test_vhdl_ghdl_emulation(tmp_path):
    port, _ = _both(CASES['matmul_int'][0])
    model = tcodegen.VHDLModel(ttrace.to_pipeline(port, 2.0), 'vh', tmp_path).write().compile()
    np.testing.assert_array_equal(model.predict(DATA, backend='emu'), port.predict(DATA, device='cpu'))


def test_templates_are_byte_equal_copies():
    """The port's HDL primitives, binder header, constraints and flow
    scripts are its own copies of the JAX package's, byte for byte, and
    ``pyproject.toml`` ships them as the port's package data."""
    root = Path(__file__).resolve().parents[1]
    ref, port = root / 'da4ml_tpu' / 'codegen' / 'rtl', root / 'da4ml_tpu_torch' / 'codegen' / 'rtl'
    names = sorted(p.relative_to(ref) for d in ('common', 'verilog/source', 'vhdl/source')
                   for p in (ref / d).iterdir() if p.is_file())  # fmt: skip
    assert len(names) == 24
    assert [n for n in names if (port / n).read_bytes() != (ref / n).read_bytes()] == []
    text = (root / 'pyproject.toml').read_text()
    section = text[text.index('da4ml_tpu_torch = [') :]
    assert all(f'"codegen/rtl/{pat}"' in section for pat in ('verilog/source/*.v', 'vhdl/source/*.vhd', 'common/*.hh',
                                                            'common/*.tcl', 'common/*.xdc', 'common/*.sdc'))  # fmt: skip
