"""The port's command line (``python -m da4ml_tpu_torch``) against the JAX
package's (``python -m da4ml_tpu``).

Carried from ``tests/test_cli.py`` and ``tests/test_verifier.py``'s CLI
cases, on the CPU (``--device cpu``): ``convert`` of a saved program in
every flavour writes the JAX package's project file for file; a pickled
torch module converts in a subprocess with zero mismatches and the JAX
package's ``mismatches.json``; ``report`` gives the JAX package's table in
every format; ``verify`` gives its text, JSON and exit code on every
corruption of the catalog; ``verify --fuzz`` runs clean; ``convert
--trace`` writes a trace that validates, which ``stats`` and ``trace-view``
read, and ``monitor`` serves for its ``--duration``; each option the port
does not carry yet exits 2 naming its ROADMAP item, and so does a run that
would need the card where there is none."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import da4ml_tpu.trace as jtrace
from da4ml_tpu._cli import main as jmain
from da4ml_tpu.analysis import COMB_CORRUPTIONS, PIPELINE_CORRUPTIONS, corruption_by_name
from da4ml_tpu_torch._cli import main as tmain
from test_cli import _fake_project

ROOT = Path(__file__).resolve().parents[1]


def _make_comb(trace):
    """``tests/test_cli.py``'s ``_make_comb``, traced by ``trace`` with the
    native solver."""
    rng = np.random.default_rng(7)
    inp = trace.FixedVariableArrayInput(6, trace.HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(6), np.full(6, 3), np.full(6, 2))
    w = rng.integers(-8, 8, (6, 4)).astype(np.float64)
    return trace.comb_trace(inp, (x @ w).relu(i=np.full(4, 6), f=np.full(4, 2)))


def _files(root: Path) -> dict[str, bytes]:
    """A project's files, without the emulation library a validation builds."""
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob('*'))
            if p.is_file() and p.suffix != '.so'}  # fmt: skip


@pytest.fixture(scope='module')
def comb_json(tmp_path_factory):
    path = tmp_path_factory.mktemp('cli') / 'comb.json'
    _make_comb(jtrace).save(path)
    return path


@pytest.mark.parametrize('flavor', ['verilog', 'vhdl', 'hls', 'vitis', 'hlslib', 'oneapi'])
def test_convert_from_json(tmp_path, comb_json, flavor):
    """Validated against the emulator (g++ for HLS, the netlist simulator
    for RTL here), and every file equal to the JAX package's project."""
    out = tmp_path / 'port'
    args = ['convert', str(comb_json), str(out), '--flavor', flavor, '-n', '64', '-lc', '3', '--validate-rtl', '-v', '0']
    assert tmain(args + ['--device', 'cpu']) == 0
    assert jmain(['convert', str(comb_json), str(tmp_path / 'ref'), '--flavor', flavor, '-n', '0', '-lc', '3', '-v', '0']) == 0
    got, want = _files(out), _files(tmp_path / 'ref')
    assert sorted(got) == sorted(want) and [k for k in want if got[k] != want[k]] == []
    meta = json.loads(got['metadata.json'])
    assert meta['flavor'] == ('vitis' if flavor == 'hls' else flavor) and meta['pipelined']


def test_convert_comb_no_pipeline(tmp_path, comb_json):
    assert tmain(['convert', str(comb_json), str(tmp_path), '-lc', '-1', '-n', '32', '--validate-rtl', '-v', '0',
                  '--device', 'cpu']) == 0  # fmt: skip
    assert not json.loads((tmp_path / 'metadata.json').read_text())['pipelined']


def test_convert_validation_catches_a_wrong_emulator(tmp_path, comb_json, monkeypatch):
    """``--validate-rtl`` holds the emulator to the DAIS executor and raises
    on a difference."""
    from da4ml_tpu_torch.codegen import HLSModel

    real = HLSModel.predict

    def off(self, data, backend='auto', n_threads=0, device=None):
        y = real(self, data, backend, n_threads, device)
        return y + (backend == 'emu')

    monkeypatch.setattr(HLSModel, 'predict', off)
    with pytest.raises(RuntimeError, match='emulation validation failed'):
        tmain(['convert', str(comb_json), str(tmp_path), '--flavor', 'hls', '-n', '16', '--validate-rtl', '-v', '0',
               '--device', 'cpu'])  # fmt: skip


_MLP = (
    'import torch\n'
    'class SmallMLP(torch.nn.Module):\n'
    '    input_shape = (6,)\n'
    '    def __init__(self):\n'
    '        super().__init__()\n'
    '        self.fc1 = torch.nn.Linear(6, 8)\n'
    '        self.act = torch.nn.ReLU()\n'
    '        self.fc2 = torch.nn.Linear(8, 3)\n'
    '    def forward(self, x):\n'
    '        return self.fc2(self.act(self.fc1(x)))\n'
)


def test_cli_convert_torch_model(tmp_path, monkeypatch):
    """``tests/test_cli.py::test_cli_convert_torch_model`` on the port: a
    pickled torch nn.Module converts through ``python -m da4ml_tpu_torch``
    with zero mismatches, the JAX package's ``mismatches.json`` and its
    project (the reference converts the same file in this process)."""
    import importlib

    import torch

    (tmp_path / 'torch_mlp_def.py').write_text(_MLP)
    monkeypatch.syspath_prepend(str(tmp_path))
    mod = importlib.import_module('torch_mlp_def')
    rng = np.random.default_rng(4)
    model = mod.SmallMLP()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.tensor(rng.integers(-4, 4, p.shape).astype(np.float32)))
    path = tmp_path / 'mlp.pt'
    torch.save(model, path)
    args = ['convert', str(path), '--flavor', 'verilog', '--inputs-kif', '1', '4', '0', '-n', '128']
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join([str(tmp_path), str(ROOT), env.get('PYTHONPATH', '')])
    r = subprocess.run([sys.executable, '-m', 'da4ml_tpu_torch', *args, str(tmp_path / 'port'), '--device', 'cpu'],
                       capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)  # fmt: skip
    assert r.returncode == 0, r.stderr[-2000:]
    assert jmain([*args, str(tmp_path / 'ref'), '-v', '0']) == 0
    report = json.loads((tmp_path / 'port' / 'mismatches.json').read_text())
    assert report['n_mismatch'] == 0 and report['n_total'] == 128 * 3, report
    got, want = _files(tmp_path / 'port'), _files(tmp_path / 'ref')
    assert sorted(got) == sorted(want) and [k for k in want if got[k] != want[k]] == []


def _report_projects(tmp_path):
    return [_fake_project(tmp_path, 'a-bits=4', 'vivado'), _fake_project(tmp_path, 'b-bits=8', 'quartus'),
            _fake_project(tmp_path, 'c-bits=6', 'vitis')]  # fmt: skip


@pytest.mark.parametrize('ext', ['json', 'csv', 'tsv', 'md', 'html'])
def test_report_outputs_equal_the_reference(tmp_path, ext):
    dirs = [str(d) for d in _report_projects(tmp_path)]
    assert tmain(['report', *dirs, '-o', str(tmp_path / f'port.{ext}')]) == 0
    assert jmain(['report', *dirs, '-o', str(tmp_path / f'ref.{ext}')]) == 0
    got, want = (tmp_path / f'port.{ext}').read_text(), (tmp_path / f'ref.{ext}').read_text()
    assert got == want and got
    if ext == 'json':
        assert {v['bits'] for v in json.loads(got)} == {4, 6, 8}


@pytest.mark.parametrize('args', [[], ['--full'], ['-s', 'bits', '-c', 'name', 'LUT', 'bits']], ids=['default', 'full', 'columns'])
def test_report_stdout_equals_the_reference(tmp_path, capsys, args):
    dirs = [str(d) for d in _report_projects(tmp_path)]
    for argv in ([*dirs, *args], [dirs[0], *args]):  # the table, and one project's listing
        assert tmain(['report', *argv]) == 0
        got = capsys.readouterr().out
        assert jmain(['report', *argv]) == 0
        assert got == capsys.readouterr().out and got


def test_report_vivado_parse():
    """``tests/test_cli.py::test_report_vivado`` on the port's parser."""
    import tempfile

    from da4ml_tpu_torch._cli.report import load_project

    with tempfile.TemporaryDirectory() as tmp:
        res = load_project(_fake_project(Path(tmp), 'prj-bits=6-lc=2.5', 'vivado'))
    assert res['WNS(ns)'] == 0.237 and res['LUT'] == 1244 and res['FF'] == 567 and res['DSP'] == 2
    assert abs(res['latency(ns)'] - 4 * (5.0 - 0.237)) < 1e-9


def _corrupted(name):
    """The reference's rich program (or solved pipeline) with one catalog
    corruption, as a dict."""
    from test_torch_verifier import _SOLVED, _rich

    corruption = corruption_by_name(name)
    if corruption in PIPELINE_CORRUPTIONS:
        return corruption.apply(_SOLVED).to_dict()
    return corruption.apply(_rich(jtrace)).to_dict()


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize('name', [c.name for c in COMB_CORRUPTIONS + PIPELINE_CORRUPTIONS])
def test_verify_equals_the_reference_on_the_catalog(tmp_path, capsys, monkeypatch, name):
    monkeypatch.chdir(tmp_path)
    Path('bad.json').write_text(json.dumps(_corrupted(name)))
    for argv in (['verify', 'bad.json'], ['verify', 'bad.json', '--json'], ['verify', 'bad.json', '--strict']):
        got = _run(tmain, argv, capsys)
        assert got == _run(jmain, argv, capsys)
        assert corruption_by_name(name).expect_rule in got[1]
    assert got[0] == 1  # --strict fails on errors and warnings alike


def test_verify_clean_program_and_project_dir(tmp_path, capsys, monkeypatch, comb_json):
    """A clean program, a project directory (with the fused program's
    ``fused:`` stats line), ``--strict``, ``--passes`` and an unreadable
    file: the reference's output and exit codes."""
    monkeypatch.chdir(tmp_path)
    assert jmain(['convert', str(comb_json), 'prj', '-n', '0', '-lc', '3', '-v', '0']) == 0
    Path('garbage.json').write_text('{not json')
    for argv in (['verify', str(comb_json)], ['verify', 'prj'], ['verify', 'prj', '--json', '--strict'],
                 ['verify', 'prj', '--passes', 'wellformed,deadcode'], ['verify', 'garbage.json']):  # fmt: skip
        got = _run(tmain, argv, capsys)
        assert got == _run(jmain, argv, capsys)
    assert 'fused:' in _run(tmain, ['verify', 'prj'], capsys)[1]
    assert _run(tmain, ['verify', 'garbage.json'], capsys)[0] == 2
    with pytest.raises(ValueError, match='unknown analysis pass'):
        tmain(['verify', 'prj', '--passes', 'nope'])


def test_verify_conformance_on_a_project(tmp_path, capsys, comb_json):
    """``--conformance`` runs the numpy, cpp and torch modes on the device
    (the plain version here); ``--samples``, ``--modes`` and ``--out``
    reach the pass."""
    assert tmain(['convert', str(comb_json), str(tmp_path / 'prj'), '-n', '0', '-lc', '3', '-v', '0', '--device', 'cpu']) == 0
    rc, out = _run(tmain, ['verify', str(tmp_path / 'prj'), '--conformance', '--json', '--samples', '256', '--device',
                           'cpu', '--out', str(tmp_path / 'r.json')], capsys)  # fmt: skip
    assert rc == 0 and json.loads(out)['ok'] and json.loads(out)['fused']['ok']
    assert json.loads((tmp_path / 'r.json').read_text()) == json.loads(out)


def test_verify_fuzz_clean(tmp_path, capsys):
    out = tmp_path / 'report.json'
    rc, text = _run(tmain, ['verify', '--fuzz', '4', '--device', 'cpu', '--out', str(out)], capsys)
    assert rc == 0, text
    report = json.loads(out.read_text())
    assert report['ok'] and report['conformance']['modes'] == ['numpy', 'cpp', 'torch']
    assert report['transfer_soundness']['per_family']['add']['counterexamples'] == 0
    assert text.splitlines()[-1] == 'opcode conformance: ok'


def test_verify_no_paths_errors(capsys):
    assert tmain(['verify']) == 2
    assert 'fuzz' in capsys.readouterr().out


@pytest.mark.parametrize(
    'argv,item',
    [
        (['--deadline', '5'], 'item 10'),
        (['--fallback', 'on'], 'item 10'),
        (['--resume', 'ckpt.json'], 'item 10'),
        (['--warmup'], 'item 12'),
        (['--warmup-max-dim', '32'], 'item 12'),
    ],
)
def test_unported_convert_option_exits_2(tmp_path, capsys, comb_json, argv, item):
    rc = tmain(['convert', str(comb_json), str(tmp_path / 'prj'), '--device', 'cpu', *argv])
    err = capsys.readouterr().err
    assert rc == 2 and f'ROADMAP Queue 1, {item}' in err and not (tmp_path / 'prj').exists(), err


def test_verify_concurrency_exits_2(capsys):
    assert tmain(['verify', '--concurrency']) == 2
    assert 'items 7 and 10' in capsys.readouterr().err


@pytest.mark.parametrize('argv', [['convert', '{json}', '{out}'], ['verify', '--fuzz', '1'],
                                  ['verify', '{json}', '--conformance']], ids=['convert', 'fuzz', 'conformance'])  # fmt: skip
def test_no_card_without_device_cpu_exits_2(tmp_path, capsys, monkeypatch, comb_json, argv):
    """With no CUDA device and no ``--device cpu`` the command refuses: it
    never runs on the host in the card's place."""
    import torch

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = [a.format(json=comb_json, out=tmp_path / 'prj') for a in argv]
    assert tmain(argv) == 2
    assert 'no CUDA device is available; pass --device cpu' in capsys.readouterr().err
    assert not (tmp_path / 'prj').exists()


def test_keras_models_are_refused(tmp_path):
    (tmp_path / 'm.keras').write_bytes(b'')
    with pytest.raises(ValueError, match='Keras front end'):
        tmain(['convert', str(tmp_path / 'm.keras'), str(tmp_path / 'prj'), '--device', 'cpu'])


def test_console_script_and_main_module():
    text = (ROOT / 'pyproject.toml').read_text()
    assert 'da4ml-tpu-torch = "da4ml_tpu_torch._cli:main"' in text
    r = subprocess.run([sys.executable, '-m', 'da4ml_tpu_torch', '--help'], capture_output=True, text=True, cwd=ROOT,
                       timeout=120)  # fmt: skip
    assert r.returncode == 0
    for sub in ('convert', 'report', 'verify', 'lint-opcodes'):
        assert sub in r.stdout
    r = subprocess.run([sys.executable, '-m', 'da4ml_tpu_torch', 'lint-opcodes'], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)  # fmt: skip
    assert r.returncode == 0 and r.stdout.startswith('lint-opcodes: ok'), r.stdout + r.stderr


@pytest.fixture
def telemetry_state():
    """Telemetry is process-global: every sink, metric, span watcher and
    server a test leaves behind is torn down, and the package logger's
    configuration restored, so nothing leaks into the next test of the
    worker."""
    import logging

    from da4ml_tpu_torch import telemetry
    from da4ml_tpu_torch.telemetry import log as tlog
    from da4ml_tpu_torch.telemetry.obs.server import stop_server

    base = logging.getLogger('da4ml_tpu_torch')
    saved = (list(base.handlers), base.level, base.propagate, tlog._configured)
    yield telemetry
    stop_server()
    telemetry.reset()
    base.handlers[:], base.level, base.propagate = saved[0], saved[1], saved[2]
    tlog._configured = saved[3]


def test_convert_trace_validates_and_stats_and_trace_view_read_it(tmp_path, capsys, comb_json, telemetry_state):
    """``convert --trace`` writes a Chrome trace that the port's validator
    passes, with the conversion's, the executor's and codegen's spans;
    ``stats`` summarizes it (table and JSON) and ``trace-view`` merges it."""
    trace = tmp_path / 't.json'
    assert tmain(['convert', str(comb_json), str(tmp_path / 'prj'), '--device', 'cpu', '-n', '32', '--trace', str(trace)]) == 0
    events, metrics = telemetry_state.load_trace(trace)
    telemetry_state.validate_trace(events)
    names = {e['name'] for e in events}
    assert {'cli.convert', 'run.call', 'codegen.rtl.write'} <= names, names
    assert metrics['run.samples']['value'] == 32
    assert not telemetry_state.tracing_active() and not telemetry_state.metrics_on()
    capsys.readouterr()
    assert tmain(['stats', str(trace), '--validate']) == 0
    out = capsys.readouterr().out
    assert f'{trace}: {len(events)} events' in out and 'run.call' in out and 'run.samples: 32' in out
    assert tmain(['stats', str(trace), '--json']) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc['n_events'] == len(events) and doc['spans']['cli.convert']['count'] == 1
    merged = tmp_path / 'merged.json'
    assert tmain(['trace-view', str(trace), '--out', str(merged)]) == 0
    view, _ = telemetry_state.load_trace(merged)
    assert {e['name'] for e in view} >= names
    assert tmain(['stats', str(tmp_path / 'missing.json')]) == 1
    assert tmain(['trace-view', str(tmp_path / 'missing.jsonl')]) == 2


def test_monitor_serves_for_its_duration(telemetry_state):
    """``monitor --duration`` binds an ephemeral port, logs its URL and
    exits 0; ``/metrics`` answers valid OpenMetrics while it runs."""
    import threading
    import urllib.request

    from da4ml_tpu_torch.telemetry.obs import server_port, validate_openmetrics

    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault('rc', tmain(['monitor', '--port', '0', '--duration', '1.5'])))
    t.start()
    for _ in range(100):
        if server_port():
            break
        threading.Event().wait(0.02)
    port = server_port()
    assert port, 'monitor did not bind'
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/metrics', timeout=5) as r:
        validate_openmetrics(r.read().decode())
    t.join(timeout=30)
    assert rc == {'rc': 0}


def test_help_lists_the_telemetry_subcommands():
    r = subprocess.run([sys.executable, '-m', 'da4ml_tpu_torch', '--help'], capture_output=True, text=True, cwd=ROOT,
                       timeout=120)  # fmt: skip
    assert r.returncode == 0
    for sub in ('stats', 'trace-view', 'monitor'):
        assert sub in r.stdout
