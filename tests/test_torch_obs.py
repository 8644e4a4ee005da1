"""The port's live observability plane (``da4ml_tpu_torch.telemetry.obs``).

Carried from ``tests/test_obs.py`` where the case applies to the port
(``bench_diff`` and the reliability, serve and fleet cases wait for their
modules): the OpenMetrics exposition and its validator, the endpoints over
a device-search solve and an executor call on the CPU, health and status
(no CUDA initialised by a scrape), the disabled path, the environment
variable, the trace tailer, ``stats --follow`` and ``monitor --follow``,
the trace merge, exemplars, and the device profile (``DA4ML_PROFILE``:
``torch.profiler`` on the CPU here; the card's kernels are checked by
``chip_smoke.py``). Every test leaves the server stopped, telemetry reset,
the environment and the package logger as it found them."""

import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import da4ml_tpu.telemetry as jtel
from da4ml_tpu_torch import telemetry
from da4ml_tpu_torch.cmvm import solve
from da4ml_tpu_torch.telemetry import log as tlog
from da4ml_tpu_torch.telemetry.obs import (
    TraceTailer,
    health_snapshot,
    render_openmetrics,
    serve,
    server_port,
    status_snapshot,
    stop_server,
    validate_openmetrics,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolated_obs(monkeypatch):
    """The server, telemetry and the package logger are process-global:
    every test starts clean and leaves nothing behind."""
    for var in ('DA4ML_TRACE', 'DA4ML_PROFILE', 'DA4ML_METRICS_PORT', 'DA4ML_HEALTH_STALL_S'):
        monkeypatch.delenv(var, raising=False)
    base = logging.getLogger('da4ml_tpu_torch')
    saved = (list(base.handlers), base.level, base.propagate, tlog._configured, set(tlog._warned_once))
    stop_server()
    telemetry.reset()
    yield
    stop_server()
    telemetry.reset()
    base.handlers[:], base.level, base.propagate = saved[0], saved[1], saved[2]
    tlog._configured = saved[3]
    tlog._warned_once.clear()
    tlog._warned_once.update(saved[4])


def _small_kernel(seed=3, n=6, m=4):
    return np.random.default_rng(seed).integers(-8, 8, (n, m)).astype(np.float64)


def _get(url: str):
    """(status, body) even for non-2xx responses."""
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _run_executor(n=64):
    from da4ml_tpu_torch.ir.synth import random_inputs, random_program
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    rng = np.random.default_rng(0)
    prog = random_program(rng, n_ops=40, n_in=4, n_out=2)
    return DaisExecutor(prog, device='cpu')(random_inputs(rng, prog, n))


# ---------------------------------------------------------------------------
# the OpenMetrics exposition
# ---------------------------------------------------------------------------


def test_exposition_valid_over_real_registry():
    telemetry.enable(metrics=True)
    solve(_small_kernel(), backend='cpu')
    fams = validate_openmetrics(render_openmetrics())
    assert fams['da4ml_solve_calls']['type'] == 'counter'
    assert fams['da4ml_solve_calls']['samples']['da4ml_solve_calls_total'] == 1.0
    dur = fams['da4ml_solve_duration_seconds']
    assert dur['type'] == 'histogram' and dur['samples']['da4ml_solve_duration_seconds_count'] == 1.0
    adders = fams['da4ml_solve_adders']
    finite = [k for k in adders['samples'] if '_bucket' in k and '+Inf' not in k]
    assert sum(adders['samples'][k] for k in finite) >= 1.0
    assert fams['da4ml_health_status']['samples']['da4ml_health_status'] == 0.0


def test_exposition_label_folding_and_unfolded_names():
    telemetry.enable(metrics=True)
    telemetry.gauge('run.mode.level').set(3.0)
    telemetry.gauge('breaker.state.cpp').set(1.0)  # no breaker fold in the port yet
    fams = validate_openmetrics(render_openmetrics())
    assert fams['da4ml_run_mode']['samples']['da4ml_run_mode{mode="level"}'] == 3.0
    assert fams['da4ml_breaker_state_cpp']['help'] == 'da4ml_tpu_torch metric breaker.state.cpp'


def test_exposition_escapes_hostile_label_values():
    from da4ml_tpu_torch.telemetry.obs.openmetrics import _labels_str

    rendered = _labels_str({'mode': 'a"b\\c\nd'})
    fams = validate_openmetrics(f'# HELP da4ml_x x\n# TYPE da4ml_x gauge\nda4ml_x{rendered} 1\n# EOF\n')
    (key,) = fams['da4ml_x']['samples']
    assert '\\"' in key and '\\\\' in key and '\\n' in key


@pytest.mark.parametrize(
    'bad',
    [
        'da4ml_x 1\n# EOF\n',
        '# HELP da4ml_x x\n# TYPE da4ml_x gauge\nda4ml_x 1\n',
        '# HELP da4ml_x x\n# TYPE da4ml_x counter\nda4ml_x 1\n# EOF\n',
        '# HELP da4ml_x x\n# TYPE da4ml_x wat\nda4ml_x 1\n# EOF\n',
        '# HELP da4ml_x x\n# TYPE da4ml_x gauge\nda4ml_x{le>="0"} 1\n# EOF\n',
        '# HELP da4ml_x x\n# TYPE da4ml_x gauge\nda4ml_x 1\nda4ml_x 2\n# EOF\n',
        '# HELP da4ml_x x\n# TYPE da4ml_x histogram\nda4ml_x_bucket{le="1"} 5\nda4ml_x_bucket{le="+Inf"} 3\n'
        'da4ml_x_sum 1\nda4ml_x_count 3\n# EOF\n',
        '# HELP da4ml_x x\n# TYPE da4ml_x histogram\nda4ml_x_bucket{le="1"} 1\nda4ml_x_sum 1\nda4ml_x_count 1\n# EOF\n',
        '# HELP da4ml_g g\n# TYPE da4ml_g gauge\nda4ml_g 1 # {trace_id="x"} 1 1\n# EOF\n',
        '# HELP da4ml_h h\n# TYPE da4ml_h histogram\nda4ml_h_bucket{le="+Inf"} 1\nda4ml_h_sum 1 # {trace_id="x"} 1\n'
        'da4ml_h_count 1\n# EOF\n',
        '# HELP da4ml_c c\n# TYPE da4ml_c counter\nda4ml_c_total 1 # {trace_id="' + 'a' * 130 + '"} 1\n# EOF\n',
        '# HELP da4ml_c c\n# TYPE da4ml_c counter\nda4ml_c_total 1 # {notquoted} 1\n# EOF\n',
    ],
)
def test_exposition_validator_rejects_as_the_reference_does(bad):
    from da4ml_tpu.telemetry.obs import validate_openmetrics as j_validate

    with pytest.raises(ValueError) as tp:
        validate_openmetrics(bad)
    with pytest.raises(ValueError) as jp:
        j_validate(bad)
    assert str(tp.value) == str(jp.value)


def test_exemplars_render_and_validate():
    telemetry.enable(metrics=True)
    tid = telemetry.new_trace_id()
    telemetry.histogram('run.batch_s').observe(0.011, trace_id=tid)
    telemetry.histogram('run.batch_s').observe(0.012)
    text = render_openmetrics()
    assert ('# {trace_id="%s"} 0.011' % tid) in text
    assert validate_openmetrics(text)['da4ml_run_batch_seconds']['type'] == 'histogram'
    ok = '# HELP da4ml_c c\n# TYPE da4ml_c counter\nda4ml_c_total 5 # {trace_id="ab12"} 1 1700000000.5\n# EOF\n'
    assert validate_openmetrics(ok)['da4ml_c']['samples']['da4ml_c_total'] == 5.0


def test_histogram_bucket_presets():
    assert telemetry.COUNT_BUCKETS[0] <= 1 and telemetry.COUNT_BUCKETS[-1] >= 1e6
    assert telemetry.BYTES_BUCKETS[0] <= 4096 and telemetry.BYTES_BUCKETS[-1] >= 2**30
    assert (telemetry.DEFAULT_BUCKETS, telemetry.COUNT_BUCKETS, telemetry.BYTES_BUCKETS) == (
        jtel.DEFAULT_BUCKETS, jtel.COUNT_BUCKETS, jtel.BYTES_BUCKETS)  # fmt: skip
    telemetry.enable(metrics=True)
    telemetry.histogram('t.count', telemetry.COUNT_BUCKETS).observe(5000)
    telemetry.histogram('t.bytes', telemetry.BYTES_BUCKETS).observe(2**20)
    snap = telemetry.metrics_snapshot()
    assert sum(snap['t.count']['buckets']) == 1 and sum(snap['t.bytes']['buckets']) == 1


# ---------------------------------------------------------------------------
# the endpoints
# ---------------------------------------------------------------------------


def test_endpoint_smoke_over_device_solve_and_executor():
    """Scraping a process that ran the device search and the executor on the
    CPU: valid OpenMetrics with the solver, scheduler and runtime families;
    /healthz ok; /statusz with the scheduler's and runtime's numbers and no
    devices (CUDA was never initialised, and the scrape does not do it)."""
    import torch

    srv = serve(0)
    assert server_port() == srv.port
    solve(_small_kernel(5, 8, 8), backend='torch', device='cpu')
    _run_executor()
    status, body = _get(srv.url + '/metrics')
    assert status == 200
    fams = validate_openmetrics(body)
    for fam in ('da4ml_solve_calls', 'da4ml_cse_device_rounds', 'da4ml_sched_device_seconds', 'da4ml_sched_rungs',
                'da4ml_run_device_seconds', 'da4ml_run_samples', 'da4ml_health_status'):  # fmt: skip
        assert fam in fams, fam
    assert fams['da4ml_run_mode']['samples'] == {'da4ml_run_mode_total{mode="level"}': 1.0}
    status, body = _get(srv.url + '/healthz')
    doc = json.loads(body)
    assert status == 200 and doc['status'] == 'ok' and doc['checks']['breakers'] == {'status': 'ok', 'open': [], 'states': {}}
    status, body = _get(srv.url + '/statusz')
    doc = json.loads(body)
    assert status == 200 and doc['telemetry']['metrics_enabled'] is True
    assert doc['scheduler']['sched.rungs'] >= 1 and doc['runtime']['run.samples'] == 64
    assert doc['devices'] is None and doc['run_modes'] == {} and doc['serve'] is None and doc['locktrace'] is None
    assert not torch.cuda.is_initialized()
    assert _get(srv.url + '/nope')[0] == 404


def test_serve_idempotent_and_stop():
    a = serve(0)
    assert serve(0) is a
    stop_server()
    assert server_port() is None
    c = serve(0)
    assert c is not a and server_port() == c.port


def test_healthz_stalled_campaign_degrades(monkeypatch):
    from da4ml_tpu_torch.telemetry import core

    telemetry.enable(metrics=True)
    telemetry.gauge('campaign.total').set(3.0)
    telemetry.gauge('campaign.done').set(1.0)
    telemetry.beat('campaign')
    doc = health_snapshot()
    assert doc['checks']['campaign']['in_progress'] is True and doc['status'] == 'ok'
    core._heartbeats['campaign'] -= 500.0
    doc = health_snapshot()
    assert doc['checks']['campaign']['status'] == 'degraded' and doc['status'] == 'degraded'
    telemetry.gauge('campaign.done').set(3.0)
    assert health_snapshot()['status'] == 'ok'
    monkeypatch.setenv('DA4ML_HEALTH_STALL_S', '1e9')
    telemetry.gauge('campaign.done').set(1.0)
    assert health_snapshot()['status'] == 'ok'


def test_health_matches_the_reference_shape(monkeypatch):
    """With nothing of reliability, serve, store or the campaign driver
    loaded, the port's health document has the reference's keys and checks.
    Other tests in the same process may have loaded those reference modules,
    so they are hidden from ``sys.modules`` for the reference's snapshot."""
    from da4ml_tpu.telemetry.obs import health_snapshot as j_health

    for name in [m for m in sys.modules if m.startswith(('da4ml_tpu.reliability', 'da4ml_tpu.serve',
                                                         'da4ml_tpu.store', 'da4ml_tpu.parallel'))]:  # fmt: skip
        monkeypatch.delitem(sys.modules, name)
    port, ref = health_snapshot(), j_health()
    assert port.keys() == ref.keys() and port['checks'].keys() == ref['checks'].keys()
    assert port['checks']['campaign'].keys() == ref['checks']['campaign'].keys()
    assert port['checks']['compile_cache'] == ref['checks']['compile_cache']


def test_statusz_active_spans():
    srv = serve(0)
    with telemetry.span('obs.outer', probe=1):
        names = [s['name'] for s in json.loads(_get(srv.url + '/statusz')[1])['active_spans']]
        assert 'obs.outer' in names
    assert all(s['name'] != 'obs.outer' for s in status_snapshot()['active_spans'])
    stop_server()
    assert telemetry.span('a') is telemetry.span('b')


def test_broken_provider_returns_500_not_dead_thread():
    srv = serve(0, status_provider=lambda: (_ for _ in ()).throw(RuntimeError('boom')))
    status, body = _get(srv.url + '/statusz')
    assert status == 500 and 'boom' in body
    assert _get(srv.url + '/metrics')[0] == 200


def test_disabled_no_server_thread():
    assert server_port() is None
    solve(_small_kernel(), backend='cpu')
    assert server_port() is None
    assert not any(t.name == 'da4ml-obs-server' for t in threading.enumerate())
    assert telemetry.metrics_snapshot() == {}


def test_env_var_activation_subprocess():
    code = ('import urllib.request\nimport da4ml_tpu_torch.telemetry\n'
            'from da4ml_tpu_torch.telemetry.obs import server_port, validate_openmetrics\n'
            'p = server_port()\nassert p, "endpoint not armed"\n'
            'validate_openmetrics(urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics", timeout=10).read().decode())\n'
            'print("PORT_OK")\n')  # fmt: skip
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, DA4ML_METRICS_PORT='0'))  # fmt: skip
    assert out.returncode == 0, out.stderr
    assert 'PORT_OK' in out.stdout


def test_bad_metrics_port_does_not_break_import():
    out = subprocess.run([sys.executable, '-c', 'import da4ml_tpu_torch.telemetry; print("IMPORT_OK")'], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=dict(os.environ, DA4ML_METRICS_PORT='x'))  # fmt: skip
    assert out.returncode == 0 and 'IMPORT_OK' in out.stdout
    assert "DA4ML_METRICS_PORT='x': could not start endpoint" in out.stderr


# ---------------------------------------------------------------------------
# the tailer, stats --follow, monitor --follow
# ---------------------------------------------------------------------------


def test_tailer_incremental_and_truncation(tmp_path):
    path = tmp_path / 't.jsonl'
    ev = {'ph': 'X', 'name': 'a', 'ts': 0, 'dur': 1, 'pid': 1, 'tid': 1}
    path.write_text(json.dumps(ev) + '\n')
    tailer = TraceTailer(path)
    assert tailer.poll() == 1 and tailer.poll() == 0
    with open(path, 'a') as fh:
        fh.write(json.dumps(dict(ev, name='b')) + '\n')
        fh.write('{"partial": ')
    assert tailer.poll() == 1 and [e['name'] for e in tailer.events] == ['a', 'b']
    with open(path, 'a') as fh:
        fh.write('1}\n')
    assert tailer.poll() == 1
    with open(path, 'a') as fh:
        rec = {'ph': 'M', 'name': 'metrics', 'args': {'metrics': {'solve.calls': {'type': 'counter', 'value': 2}}}}
        fh.write(json.dumps(rec) + '\n')
    assert tailer.poll() == 0 and tailer.metrics['solve.calls']['value'] == 2
    path.write_text(json.dumps(ev) + '\n')
    assert tailer.poll() == 1 and len(tailer.events) == 1


def test_tailer_and_loader_merge_multi_pid_metrics(tmp_path):
    path = tmp_path / 'fleet.jsonl'
    recs = [{'name': 'metrics', 'ph': 'M', 'ts': t, 'pid': pid, 'tid': 0,
             'args': {'metrics': {'c.x': {'type': 'counter', 'value': v}}}}
            for t, pid, v in ((1.0, 1, 2.0), (2.0, 1, 5.0), (2.0, 2, 7.0))]  # fmt: skip
    path.write_text('\n'.join(json.dumps(r) for r in recs) + '\n')
    tailer = TraceTailer(path)
    tailer.poll()
    assert tailer.metrics['c.x']['value'] == 12.0
    assert telemetry.load_trace(path)[1]['c.x']['value'] == 12.0


def test_stats_follow_cli(tmp_path, capsys):
    from da4ml_tpu_torch._cli import main

    path = tmp_path / 'trace.jsonl'
    telemetry.enable(path)
    solve(_small_kernel(), backend='cpu')
    telemetry.disable()
    assert main(['stats', '--follow', str(path), '--max-updates', '1', '--interval', '0.01']) == 0
    out = capsys.readouterr().out
    assert 'update 1' in out and 'cmvm.solve' in out
    assert main(['stats', '--follow', str(tmp_path / 'trace.json'), '--max-updates', '1']) == 1


def test_monitor_follow_serves_mirrored_metrics(tmp_path):
    import argparse

    from da4ml_tpu_torch._cli.monitor import monitor_main

    path = tmp_path / 'trace.jsonl'
    telemetry.enable(path)
    solve(_small_kernel(), backend='cpu')
    telemetry.reset()
    args = argparse.Namespace(port=0, host='127.0.0.1', follow=path, interval=0.05, duration=3.0, stall_after=60.0)
    t = threading.Thread(target=monitor_main, args=(args,), daemon=True)
    t.start()
    port = None
    for _ in range(100):
        port = server_port()
        if port:
            break
        time.sleep(0.05)
    assert port, 'monitor never bound'
    assert 'da4ml_solve_calls' in validate_openmetrics(_get(f'http://127.0.0.1:{port}/metrics')[1])
    assert json.loads(_get(f'http://127.0.0.1:{port}/statusz')[1])['n_events'] > 0
    t.join(timeout=30)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# the trace merge
# ---------------------------------------------------------------------------


def _write_trace(path, pid, unix_time_us, events):
    lines = [{'name': 'clock_sync', 'ph': 'M', 'ts': 0.0, 'pid': pid, 'tid': 0, 'args': {'unix_time_us': unix_time_us}}]
    lines += [dict(ev, pid=pid, tid=ev.get('tid', 0)) for ev in events]
    path.write_text('\n'.join(json.dumps(ln) for ln in lines) + '\n')


def test_merge_traces_aligns_clocks_and_indexes_by_trace_id(tmp_path):
    from da4ml_tpu_torch.telemetry.obs.collect import merge_traces, write_merged

    tid = 'ab' * 16
    _write_trace(tmp_path / 'a.jsonl', 101, 5_000_000.0,
                 [{'name': 'run.call', 'ph': 'X', 'ts': 10.0, 'dur': 50.0, 'args': {'span_id': 1, 'trace_id': tid}}])
    _write_trace(tmp_path / 'b.jsonl', 202, 6_000_000.0,
                 [{'name': 'cmvm.solve', 'ph': 'X', 'ts': 10.0, 'dur': 30.0, 'args': {'span_id': 2, 'trace_id': tid}},
                  {'name': 'unrelated', 'ph': 'X', 'ts': 1.0, 'dur': 1.0, 'args': {'span_id': 3}}])  # fmt: skip
    report = merge_traces(sorted(tmp_path.glob('*.jsonl')))
    assert report['max_processes_per_trace'] == 2
    t = report['traces'][tid]
    assert t['n_spans'] == 2 and t['pids'] == [101, 202] and set(t['names']) == {'run.call', 'cmvm.solve'}
    evs = {e['args']['span_id']: e for e in report['doc']['traceEvents'] if e.get('ph') == 'X'}
    assert evs[2]['ts'] - evs[1]['ts'] == pytest.approx(1_000_000.0)
    out = tmp_path / 'merged.json'
    write_merged(report, out)
    assert json.loads(out.read_text())['otherData']['sources'][0]['aligned'] is True
    events, _ = telemetry.load_trace(out)
    assert len(events) == report['n_events']


def test_merge_metrics_histograms_and_exemplars():
    from da4ml_tpu.telemetry.obs.collect import merge_metrics as j_merge
    from da4ml_tpu_torch.telemetry.obs.collect import merge_metrics

    h1 = {'type': 'histogram', 'count': 2, 'sum': 0.3, 'bounds': [0.1, 1.0], 'buckets': [1, 1],
          'min': 0.05, 'max': 0.25, 'exemplars': {'0': ['t-old', 0.05, 100.0]}}  # fmt: skip
    h2 = {'type': 'histogram', 'count': 1, 'sum': 0.05, 'bounds': [0.1, 1.0], 'buckets': [1, 0],
          'min': 0.05, 'max': 0.05, 'exemplars': {'0': ['t-new', 0.04, 200.0]}}  # fmt: skip
    merged = merge_metrics({1: {'h': h1}, 2: {'h': h2}})
    assert merged == j_merge({1: {'h': h1}, 2: {'h': h2}})
    m = merged['h']
    assert m['count'] == 3 and m['buckets'] == [2, 1] and m['sum'] == pytest.approx(0.35)
    assert m['min'] == 0.05 and m['max'] == 0.25 and m['exemplars']['0'][0] == 't-new'


# ---------------------------------------------------------------------------
# the device profile
# ---------------------------------------------------------------------------


def test_profile_annotate_disabled_is_noop():
    from contextlib import nullcontext

    from da4ml_tpu_torch.telemetry.obs import profile

    cm = profile.annotate('cmvm.rung')
    assert isinstance(cm, nullcontext) and cm is profile.annotate('run.call')
    with cm:
        pass
    assert not profile.profiling_active()


def test_profile_armed_writes_a_chrome_trace_with_the_ranges(tmp_path):
    """``DA4ML_PROFILE`` in a child process: a device-search solve and an
    executor call on the CPU produce a ``torch.profiler`` Chrome trace whose
    ``da4ml:cmvm.rung`` and ``da4ml:run.call`` ranges carry the ids of the
    telemetry spans they ran in (here the CPU ops K2's and K1's plain
    versions run)."""
    code = ('import numpy as np, json\n'
            'from da4ml_tpu_torch import telemetry\n'
            'from da4ml_tpu_torch.cmvm import solve\n'
            'from da4ml_tpu_torch.ir.synth import random_inputs, random_program\n'
            'from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor\n'
            'from da4ml_tpu_torch.telemetry.obs import profile\n'
            'solve(np.random.default_rng(2).integers(-8, 8, (6, 6)).astype(float), backend="torch", device="cpu")\n'
            'assert profile.profiling_active(), "profiler did not arm"\n'
            'rng = np.random.default_rng(0); prog = random_program(rng, n_ops=30, n_in=4, n_out=2)\n'
            'DaisExecutor(prog, device="cpu")(random_inputs(rng, prog, 32))\n'
            'print(json.dumps({"profile": profile.stop()}))\n')  # fmt: skip
    env = dict(os.environ, DA4ML_PROFILE=str(tmp_path / 'prof'), DA4ML_TRACE=str(tmp_path / 'spans.json'))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    path = json.loads(out.stdout.strip().splitlines()[-1])['profile']
    assert Path(path).parent == tmp_path / 'prof'
    events = json.loads(Path(path).read_text())['traceEvents']
    ranges = [e for e in events if str(e.get('name', '')).startswith('da4ml:')]
    names = {e['name'].split('#')[0] for e in ranges}
    assert names == {'da4ml:cmvm.rung', 'da4ml:run.call'}, names
    spans, _ = telemetry.load_trace(tmp_path / 'spans.json')
    by_id = {e['args']['span_id']: e['name'] for e in spans if e['ph'] == 'X'}
    for e in ranges:
        sid = int(e['name'].split('#span=')[1])
        want = ('run.call',) if e['name'].startswith('da4ml:run.call') else ('cmvm.jax.stage0', 'cmvm.jax.stage1')
        assert by_id[sid] in want, (e['name'], by_id.get(sid))
    assert any(e.get('cat') == 'cpu_op' for e in events)


def test_profile_that_cannot_start_warns_once_and_disarms(tmp_path, monkeypatch, capsys):
    """A profiler that fails to start disarms with one warning; the work runs
    on, through the same path."""
    import torch.profiler

    from da4ml_tpu_torch.telemetry.obs import profile

    def broken(*a, **k):
        raise RuntimeError('no profiler here')

    monkeypatch.setattr(torch.profiler, 'profile', broken)
    monkeypatch.setattr(profile, '_failed', False)
    monkeypatch.setenv('DA4ML_PROFILE', str(tmp_path / 'prof'))
    sol = solve(_small_kernel(), backend='torch', device='cpu')
    assert np.array_equal(np.asarray(sol.kernel, np.float64), _small_kernel())
    assert profile._failed and not profile.profiling_active()
    assert profile.annotate('run.call') is profile._NULL
    assert capsys.readouterr().err.count('torch profiler unavailable') == 1
