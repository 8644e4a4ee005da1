"""The port stands alone: it imports neither jax nor anything of da4ml_tpu."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'da4ml_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']

_RUN = """
import sys
import numpy as np
from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace
inp = FixedVariableArrayInput(4, hwconf=HWConfig(1, -1, -1))
x = inp.quantize(np.ones(4), np.full(4, 3), np.full(4, 2))
comb = comb_trace(inp, (x @ np.array([[1., -3.], [2., 5.], [-7., 1.], [4., 4.]])).relu(i=np.full(2, 5), f=np.full(2, 2)))
data = np.random.default_rng(0).uniform(-8, 8, (32, 4))
assert np.array_equal(comb.predict(data, device='cpu'), comb.predict(data, backend='numpy'))
assert np.array_equal(comb.predict(data, backend='cpp'), comb.predict(data, backend='numpy'))
from da4ml_tpu_torch.cmvm import solve, solve_torch
w = np.array([[3., -5., 7.], [6., 1., -2.], [-4., 4., 5.]])
sol = solve_torch(w, device='cpu')
assert np.array_equal(np.asarray(sol.kernel, np.float64), w)
assert solve(w, backend='cpp') == solve(w, backend='auto') == solve(w, backend='cpu')
from da4ml_tpu_torch.trace.ops import conv2d, max_pool2d, relu
from da4ml_tpu_torch.trace.pipeline import to_pipeline
img = FixedVariableArrayInput((4, 4, 1), hwconf=HWConfig(1, -1, 2))
y = relu(conv2d(img.quantize(1, 3, 0), np.arange(-4.0, 5.0).reshape(3, 3, 1, 1)))
pipe = to_pipeline(comb_trace(img, max_pool2d(y, 2)), 2)
data = np.random.default_rng(1).integers(-8, 8, (16, 16)).astype(np.float64)
assert len(pipe.stages) > 1 and np.array_equal(pipe.predict(data, device='cpu'), pipe.predict(data, backend='numpy'))
bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'da4ml_tpu' or m.startswith('da4ml_tpu.'))
assert not bad, bad
print('ok')
"""


def test_port_runs_without_jax_or_reference_package():
    proc = subprocess.run([sys.executable, '-c', _RUN], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == 'ok'


_TRACE_MODEL = """
import sys
import tempfile
import numpy as np
from da4ml_tpu_torch.codegen import VerilogModel
from da4ml_tpu_torch.converter import trace_model
from da4ml_tpu_torch.models import config5_twin
from da4ml_tpu_torch.trace import HWConfig, comb_trace
model = config5_twin(limited=True)
comb = comb_trace(*trace_model(model, HWConfig(1, -1, -1), {'backend': 'cpp'}, inputs_kif=(1, 3, 2)))
with tempfile.TemporaryDirectory() as d:
    rtl = VerilogModel(comb, 'twin', d, latency_cutoff=5).write()
    data = np.floor(np.random.default_rng(0).uniform(-8, 8, (4, comb.shape[0])) * 4) / 4
    assert np.array_equal(rtl.predict(data, backend='netlist'), rtl.predict(data, backend='interp', device='cpu'))
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'da4ml_tpu'))
assert not bad, bad
print('ok')
"""


def test_trace_model_and_codegen_import_neither_jax_nor_reference_package():
    """The PyTorch front end on a torch module, then codegen and the netlist
    simulator: neither jax nor da4ml_tpu is imported (the plugin registry
    reads only the port's own entry-point group)."""
    proc = subprocess.run([sys.executable, '-c', _TRACE_MODEL], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == 'ok'


_CLI = """
import json, runpy, sys, tempfile
from pathlib import Path
import numpy as np

def cli(*argv):
    sys.argv = ['da4ml_tpu_torch', *argv]
    try:
        runpy.run_module('da4ml_tpu_torch', run_name='__main__', alter_sys=True)
    except SystemExit as e:
        return e.code
    raise AssertionError('the command line did not exit')

with tempfile.TemporaryDirectory() as d:
    d = Path(d)
    (d / 'prj').mkdir()
    (d / 'prj' / 'metadata.json').write_text(json.dumps({'name': 'model', 'cost': 1.0, 'latency': [0, 1]}))
    assert cli('report', str(d / 'prj'), '-o', str(d / 'r.csv')) == 0
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace
    inp = FixedVariableArrayInput(4, hwconf=HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(4), np.full(4, 3), np.full(4, 2))
    comb_trace(inp, (x @ np.array([[1., -3.], [2., 5.], [-7., 1.], [4., 4.]])).relu()).save(d / 'comb.json')
    assert cli('convert', str(d / 'comb.json'), str(d / 'hls'), '--flavor', 'hls', '-n', '16', '--validate-rtl',
               '-lc', '1', '-v', '0', '--device', 'cpu') == 0
    assert cli('verify', str(d / 'hls'), '--conformance', '--samples', '16', '--device', 'cpu') == 0
    assert cli('lint-opcodes') == 0
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'da4ml_tpu'))
assert not bad, bad
print('ok')
"""


def test_command_line_imports_neither_jax_nor_reference_package():
    """``python -m da4ml_tpu_torch`` ``report``, ``convert`` (HLS, the g++
    emulator against the executor), ``verify --conformance`` and
    ``lint-opcodes``, run in one process: neither jax nor da4ml_tpu is
    imported."""
    proc = subprocess.run([sys.executable, '-c', _CLI], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == 'ok'


def test_host_solver_imports_no_torch():
    """The host solver's spawned workers import ``da4ml_tpu_torch.cmvm``;
    the device search (and torch) load only when asked for."""
    code = (
        'import sys, da4ml_tpu_torch.cmvm as c; assert "torch" not in sys.modules, "torch"; '
        'c.solve_torch; assert "torch" in sys.modules; print("ok")'
    )
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == 'ok'


def test_native_library_loads_without_reference_package():
    """Loading the port's own native library (built from its own sources
    into ``build/da4ml_tpu_torch/``) imports neither torch, jax nor
    da4ml_tpu, and maps no library of da4ml_tpu into the process."""
    code = (
        'import sys; from da4ml_tpu_torch.native import bindings; lib = bindings.load_lib(); '
        'assert lib is not None, bindings.load_error(); '
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "da4ml_tpu", "torch")); assert not bad, bad; '
        'maps = open("/proc/self/maps").read(); assert "da4ml_tpu/native" not in maps; '
        'assert "build/da4ml_tpu_torch/libda4ml_native_" in lib._name, lib._name; print("ok")'
    )
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == 'ok'


def test_scans_cover_the_native_module():
    native = {p.relative_to(ROOT).as_posix() for p in PORT_FILES if p.parent.name == 'native'}
    assert {'da4ml_tpu_torch/native/__init__.py', 'da4ml_tpu_torch/native/bindings.py',
            'da4ml_tpu_torch/native/build.py'} <= native  # fmt: skip


def test_scans_cover_the_trace_modules():
    trace = {p.relative_to(ROOT).as_posix() for p in PORT_FILES if 'trace' in p.parts}
    ops = ('__init__', 'conv_utils', 'einsum_utils', 'quantization', 'reduce_utils', 'sorting')
    assert {f'da4ml_tpu_torch/trace/ops/{m}.py' for m in ops} | {'da4ml_tpu_torch/trace/pipeline.py'} <= trace


def test_scans_cover_the_firmware_modules():
    files = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    mods = ['analysis/' + m for m in ('__init__', 'diagnostics', 'wellformed', 'interval', 'deadcode', 'runner')]
    mods += ['codegen/__init__', 'codegen/rtl/rtl_model', 'converter/__init__', 'converter/plugin',
             'converter/torch_plugin', 'models']  # fmt: skip
    mods += [f'codegen/rtl/{f}/{m}' for f in ('verilog', 'vhdl') for m in ('comb', 'io_wrapper', 'pipeline', 'netlist_sim')]
    assert {f'da4ml_tpu_torch/{m}.py' for m in mods} <= files


def test_scans_cover_the_cli_modules():
    files = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    mods = ['__main__', '_cli/__init__', '_cli/convert', '_cli/report', '_cli/verify', 'codegen/hls/hls_codegen',
            'codegen/hls/hls_model', 'analysis/conformance', 'analysis/soundness', 'analysis/mutation',
            'analysis/driftlint']  # fmt: skip
    assert {f'da4ml_tpu_torch/{m}.py' for m in mods} <= files


def test_scans_cover_the_search_modules():
    files = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    mods = ['cmvm/torch_beam'] + [f'cmvm/search/{m}' for m in ('__init__', 'spec', 'ranker', 'beam', 'trace', 'train')]
    assert {f'da4ml_tpu_torch/{m}.py' for m in mods} <= files


def test_quality_search_imports_neither_jax_nor_reference_package():
    """A ``quality='search'`` solve on the CPU (the device beam, the host
    replay, the trace export) and the trainer import neither jax nor
    da4ml_tpu."""
    code = (
        'import sys, os, tempfile, numpy as np; os.environ["DA4ML_SEARCH_TRACE_DIR"] = tempfile.mkdtemp(); '
        'from da4ml_tpu_torch.cmvm import solve; from da4ml_tpu_torch.cmvm.search.train import train_from_dir; '
        'W = np.random.default_rng(0).integers(-8, 8, (5, 5)).astype(float); '
        'sol = solve(W, backend="torch", quality="search", device="cpu"); '
        'assert np.array_equal(np.asarray(sol.kernel, float), W); '
        'train_from_dir(os.environ["DA4ML_SEARCH_TRACE_DIR"]); '
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "da4ml_tpu")); assert not bad, bad; '
        'print("ok")'
    )
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == 'ok'


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    src = path.read_text()
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        for name in names:
            root = name.split('.')[0]
            assert root not in ('jax', 'jaxlib', 'da4ml_tpu'), f'{path.name} imports {name}'
    assert not re.search(r'\bimport jax\b|\bfrom jax\b', src)
    assert not re.search(r'\bda4ml_tpu\.|\bfrom da4ml_tpu\b(?!_)|\bimport da4ml_tpu\b(?!_)', src)


def test_scans_cover_the_telemetry_modules():
    files = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    mods = [f'telemetry/{m}' for m in ('__init__', 'core', 'metrics', 'log', 'export', 'catalog')]
    mods += [f'telemetry/obs/{m}' for m in ('__init__', 'profile', 'collect', 'openmetrics', 'health', 'server', 'tailer')]
    mods += ['_cli/stats', '_cli/trace_view', '_cli/monitor', 'typing']
    assert {f'da4ml_tpu_torch/{m}.py' for m in mods} <= files


_ROOT_EXPORTS = """
import json
import sys
import da4ml_tpu_torch as d
light = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'da4ml_tpu', 'torch'))
assert not light, light
from da4ml_tpu_torch import CombLogic, LookupTable, Op, Pipeline, Precision, QInterval, minimal_kif
from da4ml_tpu_torch.cmvm import solve
from da4ml_tpu_torch.converter import trace_model
from da4ml_tpu_torch.analysis import verify
assert (d.solve, d.trace_model, d.verify) == (solve, trace_model, verify)
assert d.telemetry is sys.modules['da4ml_tpu_torch.telemetry']
import da4ml_tpu_torch.typing as t
assert t.HWConfig is sys.modules['da4ml_tpu_torch.trace'].HWConfig and t.CombLogic is CombLogic
import torch
assert not torch.cuda.is_initialized()
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'da4ml_tpu'))
assert not bad, bad
print(json.dumps([sorted(d.__all__), sorted(t.__all__)]))
"""


def test_root_exports_the_reference_names_lazily():
    """``import da4ml_tpu_torch`` gives the reference root's names (and
    ``telemetry``) without importing torch, jax or da4ml_tpu; resolving the
    lazy ones initialises no CUDA. ``da4ml_tpu_torch.typing`` mirrors
    ``da4ml_tpu.typing``."""
    import da4ml_tpu
    import da4ml_tpu.typing

    proc = subprocess.run([sys.executable, '-c', _ROOT_EXPORTS], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names, typing_names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert names == sorted([*da4ml_tpu.__all__, 'telemetry'])
    assert typing_names == sorted(da4ml_tpu.typing.__all__)
