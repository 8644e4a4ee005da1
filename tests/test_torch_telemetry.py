"""The port's telemetry (``da4ml_tpu_torch.telemetry``) against the JAX
package's (``da4ml_tpu.telemetry``).

Carried from ``tests/test_telemetry.py`` where the case applies to the
port: the disabled path, span nesting and threads, the exporters, the
metrics registry, logging, the trace context. Then parity: the same spans,
instants and metrics through both packages give the same events and
snapshot, each package's reader and validator take the other's trace, and
the same events summarize alike; the port's slice on the CPU (a traced
model solved with the device search, run by ``DaisExecutor`` and written
to Verilog) emits the reference's span names and metric families at the
counterpart sites; the catalog covers every emission site of the port.
Every test leaves telemetry, the environment and the package logger as it
found them (``_isolated``)."""

import ast
import json
import logging
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import da4ml_tpu.telemetry as jtel
from da4ml_tpu_torch import telemetry
from da4ml_tpu_torch.cmvm import solve
from da4ml_tpu_torch.telemetry import log as tlog
from da4ml_tpu_torch.telemetry.obs.server import stop_server

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Telemetry is process-global: every test starts clean and leaves no
    sink, metric, heartbeat, server or logger configuration behind, in
    either package."""
    for var in ('DA4ML_TRACE', 'DA4ML_PROFILE', 'DA4ML_METRICS_PORT', 'DA4ML_LOG_LEVEL'):
        monkeypatch.delenv(var, raising=False)
    base = logging.getLogger('da4ml_tpu_torch')
    saved = (list(base.handlers), base.level, base.propagate, tlog._configured, set(tlog._warned_once))
    telemetry.reset()
    jtel.reset()
    yield
    stop_server()
    telemetry.reset()
    jtel.reset()
    base.handlers[:], base.level, base.propagate = saved[0], saved[1], saved[2]
    tlog._configured = saved[3]
    tlog._warned_once.clear()
    tlog._warned_once.update(saved[4])


def _small_kernel(seed=3, n=6, m=4):
    return np.random.default_rng(seed).integers(-8, 8, (n, m)).astype(np.float64)


# ---------------------------------------------------------------------------
# the disabled path
# ---------------------------------------------------------------------------


def test_disabled_no_events_and_no_registry():
    assert not telemetry.tracing_active() and not telemetry.metrics_on()
    assert telemetry.span('a') is telemetry.span('b')  # the shared no-op singleton
    solve(_small_kernel(), backend='cpu')
    solve(_small_kernel(), backend='torch', device='cpu')
    assert telemetry.metrics_snapshot() == {}


def test_noop_span_is_reusable_and_falsy():
    sp = telemetry.span('x', k=1)
    assert not sp
    with sp as inner:
        assert inner.span_id is None
        inner.set(more=2)
    with sp:
        pass


def test_disabled_overhead_under_2pct():
    """Telemetry-off instrumentation costs under 2 % of a small solve."""
    kernel = _small_kernel(5, 8, 8)
    solve(kernel, backend='cpu')
    t0 = time.perf_counter()
    solve(kernel, backend='cpu')
    solve_s = time.perf_counter() - t0
    n = 10_000
    t0 = time.perf_counter()
    for _ in range(n):
        with telemetry.span('bench.noop', backend='cpu'):
            pass
        telemetry.counter('bench.noop').inc()
        telemetry.histogram('bench.noop_s').observe(0.0)
    per_call = (time.perf_counter() - t0) / n
    assert 100 * per_call < 0.02 * solve_s, (per_call, solve_s)


# ---------------------------------------------------------------------------
# spans, threads, exporters, metrics
# ---------------------------------------------------------------------------


def test_span_nesting_and_chrome_schema(tmp_path):
    path = tmp_path / 'trace.json'
    telemetry.enable(path)
    with telemetry.span('outer', kind='test') as so:
        with telemetry.span('mid') as sm:
            with telemetry.span('leaf') as sl:
                pass
        assert sm.parent_id == so.span_id and sl.parent_id == sm.span_id
    telemetry.instant('tick', n=1)
    telemetry.disable()
    events, _ = telemetry.load_trace(path)
    telemetry.validate_trace(events)
    by = {e['name']: e for e in events}
    assert by['leaf']['args']['parent_id'] == by['mid']['args']['span_id']
    assert by['mid']['args']['parent_id'] == by['outer']['args']['span_id']
    assert 'parent_id' not in by['outer']['args'] and by['tick']['ph'] == 'i'
    for child, parent in (('leaf', 'mid'), ('mid', 'outer')):
        c, p = by[child], by[parent]
        assert p['ts'] - 1e-6 <= c['ts'] and c['ts'] + c['dur'] <= p['ts'] + p['dur'] + 1e-6
    assert json.loads(path.read_text())['otherData']['producer'] == 'da4ml_tpu_torch.telemetry'


def test_jsonl_sink_streams_and_appends_metrics(tmp_path):
    path = tmp_path / 'trace.jsonl'
    telemetry.enable(path)
    with telemetry.span('one'):
        pass
    telemetry.counter('c.x').inc(2)
    telemetry.disable()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines[0]['name'] == 'clock_sync' and lines[0]['args']['unix_time_us'] > 0
    assert lines[1]['name'] == 'one' and lines[1]['ph'] == 'X'
    assert lines[-1]['ph'] == 'M' and lines[-1]['args']['metrics']['c.x']['value'] == 2.0
    events, metrics = telemetry.load_trace(path)
    telemetry.validate_trace(events)
    assert metrics['c.x']['value'] == 2.0


def test_span_thread_safety_parallel_solves(tmp_path):
    """Solves on four threads: parent links never cross threads, every
    event is schema-valid, and each solve is one ``cmvm.solve`` root."""
    path = tmp_path / 'trace.json'
    telemetry.enable(path)
    kernels = [_small_kernel(seed) for seed in range(8)]
    with ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(lambda k: solve(k, backend='cpu'), kernels))
    telemetry.disable()
    events, metrics = telemetry.load_trace(path)
    telemetry.validate_trace(events)
    spans = [e for e in events if e['ph'] == 'X']
    assert len({e['tid'] for e in spans}) > 1
    by_id = {e['args']['span_id']: e for e in spans}
    for e in spans:
        parent = e['args'].get('parent_id')
        if parent is not None:
            assert by_id[parent]['tid'] == e['tid']
    roots = [e for e in spans if e['name'] == 'cmvm.solve']
    assert len(roots) == len(kernels) and all('parent_id' not in e['args'] for e in roots)
    assert metrics['solve.calls']['value'] == len(kernels)


def test_collect_phases_is_thread_local():
    done = threading.Event()

    def other():
        done.wait(5)
        with telemetry.span('other.span'):
            pass

    t = threading.Thread(target=other)
    with telemetry.collect_phases() as phases:
        t.start()
        with telemetry.span('mine.span'):
            pass
        done.set()
        t.join(10)
        got = dict(phases)
    assert not t.is_alive()
    assert 'mine.span' in got and 'other.span' not in got


def test_metrics_registry_roundtrip():
    telemetry.enable(metrics=True)
    telemetry.counter('t.count').inc()
    telemetry.counter('t.count').inc(4)
    telemetry.gauge('t.gauge').set(2.5)
    h = telemetry.histogram('t.hist')
    for v in (0.0002, 0.02, 3.0):
        h.observe(v)
    with telemetry.timer('t.timer'):
        pass
    snap = telemetry.metrics_snapshot()
    assert snap['t.count'] == {'type': 'counter', 'value': 5.0}
    assert snap['t.gauge']['value'] == 2.5
    assert snap['t.hist']['count'] == 3 and snap['t.hist']['min'] == 0.0002 and snap['t.hist']['max'] == 3.0
    assert sum(snap['t.hist']['buckets']) == 3 and snap['t.timer']['count'] == 1
    json.dumps(snap)


def test_metric_type_conflict_raises():
    telemetry.enable(metrics=True)
    telemetry.counter('t.same').inc()
    with pytest.raises(TypeError):
        telemetry.gauge('t.same')


def test_heartbeats():
    assert telemetry.beat_age_s('t.beat') is None
    telemetry.beat('t.beat')
    assert 0.0 <= telemetry.beat_age_s('t.beat') < 5.0
    telemetry.reset()
    assert telemetry.beat_age_s('t.beat') is None


def test_env_var_activation(tmp_path):
    """``DA4ML_TRACE=<path>`` alone captures a trace of the port."""
    path = tmp_path / 'env_trace.json'
    code = ('import numpy as np\nfrom da4ml_tpu_torch.cmvm import solve\n'
            "solve(np.array([[1.0, 2.0], [3.0, -1.0]]), backend='cpu')\n")  # fmt: skip
    env = dict(os.environ, DA4ML_TRACE=str(path))
    subprocess.run([sys.executable, '-c', code], check=True, env=env, cwd=ROOT, timeout=120)
    events, metrics = telemetry.load_trace(path)
    telemetry.validate_trace(events)
    assert any(e['name'] == 'cmvm.solve' for e in events)
    assert metrics['solve.calls']['value'] == 1.0


def test_emit_span_and_monotonic_mapping(tmp_path):
    from da4ml_tpu_torch.telemetry.core import monotonic_ts_us

    path = tmp_path / 'trace.jsonl'
    telemetry.enable(path)
    sid = telemetry.emit_span('seg', monotonic_ts_us(time.monotonic()), 0.002, trace_id='cd' * 16, parent_id=7, rows=3)
    telemetry.disable()
    assert sid > 0
    events, _ = telemetry.load_trace(path)
    seg = next(e for e in events if e['name'] == 'seg')
    assert seg['ph'] == 'X' and seg['dur'] == pytest.approx(2000.0)
    assert seg['args'] == {'rows': 3, 'span_id': sid, 'parent_id': 7, 'trace_id': 'cd' * 16}
    assert telemetry.emit_span('seg', 0.0, 0.1) == 0


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------


def test_get_logger_stdout_and_stderr(capsys):
    log = telemetry.get_logger('test.site')
    assert log.name == 'da4ml_tpu_torch.test.site'
    assert telemetry.get_logger('da4ml_tpu_torch.cmvm').name == 'da4ml_tpu_torch.cmvm'
    log.info('plain info line')
    log.warning('something odd')
    cap = capsys.readouterr()
    assert 'plain info line\n' in cap.out and 'plain info line' not in cap.err
    assert '[WARNING] something odd\n' in cap.err


def test_log_records_mirrored_into_trace_and_warn_once(tmp_path, capsys):
    path = tmp_path / 'trace.json'
    telemetry.enable(path)
    telemetry.get_logger('test.mirror').warning('breaker opened')
    assert telemetry.warn_once('t.once', 'said once', logger='test') is True
    assert telemetry.warn_once('t.once', 'said once', logger='test') is False
    telemetry.disable()
    events, _ = telemetry.load_trace(path)
    warns = [e['args']['message'] for e in events if e['name'] == 'log.warning']
    assert warns == ['breaker opened', 'said once']
    assert capsys.readouterr().err.count('said once') == 1


def test_log_level_from_environment():
    code = ('from da4ml_tpu_torch.telemetry import get_logger\n'
            "log = get_logger('t'); log.info('hidden'); log.error('shown')\n")  # fmt: skip
    env = dict(os.environ, DA4ML_LOG_LEVEL='error')
    r = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert 'hidden' not in r.stdout and '[ERROR] shown' in r.stderr


# ---------------------------------------------------------------------------
# the trace context
# ---------------------------------------------------------------------------


def test_traceparent_roundtrip_and_rejects():
    tid, sid = telemetry.new_trace_id(), telemetry.new_span_id()
    assert len(tid) == 32 and int(tid, 16) != 0 and sid > 0
    hdr = telemetry.format_traceparent(tid, sid)
    assert hdr == f'00-{tid}-{sid:016x}-01' and telemetry.parse_traceparent(hdr) == (tid, sid)
    for bad in (None, '', 'not-a-header', '01-' + 'a' * 32 + '-' + 'b' * 16 + '-01', '00-' + '0' * 32 + '-' + 'b' * 16 + '-01',
                '00-' + 'a' * 30 + '-' + 'b' * 16 + '-01', '00-' + 'g' * 32 + '-' + 'b' * 16 + '-01'):  # fmt: skip
        assert telemetry.parse_traceparent(bad) is None, bad
    assert telemetry.parse_traceparent('00-' + 'a' * 32 + '-' + '0' * 16 + '-01') == ('a' * 32, None)


def test_bind_trace_attaches_trace_id_and_remote_parent(tmp_path):
    path = tmp_path / 'trace.jsonl'
    telemetry.enable(path)
    tid = 'ab' * 16
    with telemetry.bind_trace(tid, 0xBEEF):
        assert telemetry.current_trace_id() == tid
        with telemetry.span('root_here'):
            with telemetry.span('child'):
                pass
        telemetry.instant('tick')
    assert telemetry.current_trace() is None
    telemetry.disable()
    events, _ = telemetry.load_trace(path)
    by = {e['name']: e for e in events}
    assert by['root_here']['args']['trace_id'] == tid and by['root_here']['args']['parent_id'] == 0xBEEF
    assert by['child']['args']['trace_id'] == tid
    assert by['child']['args']['parent_id'] == by['root_here']['args']['span_id']
    assert by['tick']['args']['trace_id'] == tid
    with telemetry.bind_trace() as tb:
        assert len(tb.trace_id) == 32 and tb.parent_span_id is None


_FORK = """
import json, os
from da4ml_tpu_torch import telemetry
parent = [telemetry.new_span_id() for _ in range(4)]
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    os.write(w, json.dumps([telemetry.new_span_id() for _ in range(4)]).encode())
    os._exit(0)
os.close(w)
child = json.loads(os.read(r, 4096))
os.waitpid(pid, 0)
print(json.dumps([parent, child]))
"""


def test_fork_reseeds_span_id_epoch():
    """A forked child mints span ids from a new epoch (``os.register_at_fork``).
    The fork runs in a fresh interpreter that holds no other threads."""
    proc = subprocess.run([sys.executable, '-c', _FORK], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    parent_ids, child_ids = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (child_ids[0] >> 32) != (parent_ids[0] >> 32) and not set(parent_ids) & set(child_ids)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _drive(tel, path):
    """One fixed sequence of spans, instants and metrics through ``tel``."""
    tel.enable(path)
    with tel.bind_trace('ef' * 16, 0x1234):
        with tel.span('cmvm.solve', backend='torch', shape='6x4') as sp:
            with tel.span('cmvm.jax.stage0', n_lanes=3):
                tel.instant('cmvm.progress', done=1, total=2)
            sp.set(cost=17.0)
    tel.counter('solve.calls').inc()
    tel.counter('run.mode.pallas').inc(2)
    tel.gauge('search.beam_width').set(5)
    tel.histogram('solve.duration_s').observe(0.0123)
    tel.histogram('solve.adders', tel.COUNT_BUCKETS).observe(17.0)
    tel.histogram('sched.hbm_bytes', tel.BYTES_BUCKETS).observe(3 << 20)
    tel.get_logger('parity').warning('mirrored')
    tel.disable()


def _shape(events):
    """Events without their process, clock and id values, and with each
    logger name relative to its package."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ('ts', 'dur', 'pid', 'tid')}
        args = {k: (v if k not in ('span_id', 'parent_id') or v == 0x1234 else 'id')
                for k, v in e.get('args', {}).items() if k != 'unix_time_us'}  # fmt: skip
        if 'logger' in args:
            args['logger'] = args['logger'].split('.', 1)[1]
        e['args'] = args
        out.append(e)
    return out


@pytest.mark.parametrize('suffix', ['.json', '.jsonl'])
def test_same_sequence_same_trace_in_both_packages(tmp_path, suffix, capsys):
    """The same calls give the same events (names, phases, attributes,
    parentage) and the same metrics snapshot; each package's reader and
    validator take the other's file."""
    tp, jp = tmp_path / f'port{suffix}', tmp_path / f'ref{suffix}'
    _drive(telemetry, tp)
    _drive(jtel, jp)
    capsys.readouterr()
    (te, tm), (je, jm) = telemetry.load_trace(tp), jtel.load_trace(jp)
    assert _shape(te) == _shape(je)
    assert tm == jm
    for ev_load, ev_val, path in ((telemetry.load_trace, jtel.validate_trace, tp),
                                  (jtel.load_trace, telemetry.validate_trace, jp)):  # fmt: skip
        events, metrics = ev_load(path)
        ev_val(events)
        assert metrics == tm
    assert telemetry.REQUIRED_EVENT_KEYS == jtel.REQUIRED_EVENT_KEYS


def test_validators_reject_alike():
    bad = [[], [{'name': 'x', 'ph': 'X', 'ts': 0, 'pid': 1}], [{'name': 'x', 'ph': 'Q', 'ts': 0, 'pid': 1, 'tid': 1}],
           [{'name': 'x', 'ph': 'X', 'ts': 0, 'pid': 1, 'tid': 1}], [{'name': '', 'ph': 'i', 'ts': 0, 'pid': 1, 'tid': 1}],
           [{'name': 'x', 'ph': 'i', 'ts': '0', 'pid': 1, 'tid': 1}]]  # fmt: skip
    for events in bad:
        with pytest.raises(ValueError) as tp:
            telemetry.validate_trace(events)
        with pytest.raises(ValueError) as jp:
            jtel.validate_trace(events)
        assert str(tp.value) == str(jp.value)


def test_summaries_and_exposition_equal_in_both_packages(tmp_path, capsys):
    """``stats``' summary of one event list and the OpenMetrics text of one
    snapshot (the port's families) are the same in both packages."""
    from da4ml_tpu._cli.stats import render_summary as j_render
    from da4ml_tpu._cli.stats import summarize_events as j_summarize
    from da4ml_tpu.telemetry.obs import render_openmetrics as j_openmetrics
    from da4ml_tpu_torch._cli.stats import render_summary, summarize_events
    from da4ml_tpu_torch.telemetry.catalog import METRICS
    from da4ml_tpu_torch.telemetry.obs import render_openmetrics, validate_openmetrics

    _drive(telemetry, tmp_path / 't.json')
    capsys.readouterr()
    events, metrics = telemetry.load_trace(tmp_path / 't.json')
    assert summarize_events(events) == j_summarize(events)
    assert render_summary(summarize_events(events), metrics) == j_render(j_summarize(events), metrics)
    telemetry.reset()
    telemetry.enable(metrics=True)
    for name in METRICS:
        if name.endswith(('_s', '_bytes', 'adders', '_samples')) and name != 'run.samples':
            telemetry.histogram(name, telemetry.COUNT_BUCKETS if name.endswith(('adders', '_samples'))
                                else telemetry.DEFAULT_BUCKETS).observe(3.0)  # fmt: skip
        elif name in ('search.beam_width', 'run.samples_per_s', 'health.status') or name.startswith('fuse.depth'):
            telemetry.gauge(name).set(2.5)
        elif name != 'run.mode':
            telemetry.counter(name).inc(3)
    telemetry.counter('run.mode.pallas').inc()
    telemetry.counter('run.mode.fused_ir').inc()
    telemetry.histogram('run.device_s').observe(0.004, trace_id='ab' * 16)
    snap = telemetry.metrics_snapshot()
    text = render_openmetrics(snap)
    assert text == j_openmetrics(snap)
    fams = validate_openmetrics(text)
    assert fams['da4ml_run_mode']['samples'] == {'da4ml_run_mode_total{mode="fused_ir"}': 1.0,
                                                 'da4ml_run_mode_total{mode="pallas"}': 1.0}  # fmt: skip


def test_traceparent_alike_in_both_packages():
    for tid, sid in (('a1' * 16, 5), ('ff' * 16, None), ('0' * 31 + '1', 2**64 - 1)):
        hdr = telemetry.format_traceparent(tid, sid)
        assert hdr == jtel.format_traceparent(tid, sid)
        assert telemetry.parse_traceparent(hdr) == jtel.parse_traceparent(hdr)
    for hdr in ('', '00-' + '0' * 32 + '-' + '1' * 16 + '-01', ' 00-' + 'A' * 32 + '-' + '0' * 16 + '-01 '):
        assert telemetry.parse_traceparent(hdr) == jtel.parse_traceparent(hdr)


#: families the reference emits on this path whose counterparts the port
#: does not carry (ROADMAP.md): the XLA compile classes (``jit.*``)
_LEFT_OUT = ('jit.',)


def _slice_run(tel, tr, decode, executor, verilog, solver_options, exkw, out):
    tel.enable(out / 't.json')
    rng = np.random.default_rng(11)
    inp = tr.FixedVariableArrayInput(5, hwconf=tr.HWConfig(1, -1, -1), solver_options=solver_options)
    x = inp.quantize(np.ones(5), np.full(5, 3), np.full(5, 2))
    x = (x @ rng.integers(-8, 8, (5, 4)).astype(np.float64)).relu(i=np.full(4, 6), f=np.full(4, 2))
    x = x @ rng.integers(-8, 8, (4, 3)).astype(np.float64)
    comb = tr.comb_trace(inp, x)
    data = rng.uniform(-8, 8, (64, 5))
    y = executor(decode(comb.to_binary()), **exkw)(data)
    verilog(comb, 'm', out / 'prj', latency_cutoff=2).write()
    tel.disable()
    events, metrics = tel.load_trace(out / 't.json')
    tel.validate_trace(events)
    return comb, y, events, metrics


def test_slice_on_the_cpu_emits_the_reference_spans_and_families(tmp_path, monkeypatch):
    """A small traced model solved by the device search on the CPU, run by
    ``DaisExecutor(device='cpu')`` and written to Verilog, under
    ``telemetry.enable``: the same program as the JAX package's ``'jax'``
    trace, and the span names and metric families the reference emits at
    the counterpart sites (the reference's direct solve path, as the port
    has no reliability layer yet; its executor in ``level`` mode, the
    plain version K1 runs on the CPU)."""
    import da4ml_tpu.trace as jtr
    import da4ml_tpu_torch.trace as ttr
    from da4ml_tpu.codegen import VerilogModel as JVerilog
    from da4ml_tpu.ir.dais_binary import decode as jdecode
    from da4ml_tpu.runtime.jax_backend import DaisExecutor as JExecutor
    from da4ml_tpu_torch.codegen import VerilogModel
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor
    from da4ml_tpu_torch.telemetry.catalog import fold_family

    monkeypatch.setenv('DA4ML_SOLVE_FALLBACK', '0')
    (tmp_path / 'p').mkdir()
    (tmp_path / 'r').mkdir()
    comb, y, te, tm = _slice_run(telemetry, ttr, decode, DaisExecutor, VerilogModel, {'backend': 'torch', 'device': 'cpu'},
                                 {'device': 'cpu', 'mode': 'level'}, tmp_path / 'p')  # fmt: skip
    jcomb, jy, je, jm = _slice_run(jtel, jtr, jdecode, JExecutor, JVerilog, {'backend': 'jax'}, {'mode': 'level'},
                                   tmp_path / 'r')  # fmt: skip
    assert np.array_equal(comb.to_binary(), jcomb.to_binary()) and np.array_equal(y, jy)
    spans = {e['name'] for e in te if e['ph'] == 'X'}
    assert spans == {e['name'] for e in je if e['ph'] == 'X'}, spans
    assert {'cmvm.solve', 'cmvm.dispatch', 'cmvm.jax.stage0', 'run.call', 'trace.comb_trace', 'codegen.rtl.write'} <= spans
    fams = {fold_family(n) for n in tm}
    ref = {fold_family(n) for n in jm if not n.startswith(_LEFT_OUT)}
    assert fams == ref, (fams ^ ref)
    calls = {e['args']['mode'] for e in te if e['name'] == 'run.call'}
    assert calls == {'level'} and tm['run.mode.level']['value'] == 1
    assert tm['cse.device_rounds']['value'] == jm['cse.device_rounds']['value']
    assert tm['sched.rungs']['value'] == jm['sched.rungs']['value']
    assert tm['solve.calls']['value'] == jm['solve.calls']['value'] == 2


def test_flagship_twin_converts_with_a_trace(tmp_path, capsys):
    """``convert --trace`` of the flagship twin's ``.pt`` through the device
    search on the CPU (the telemetry phase of ``chip_smoke.py`` on the
    card): zero mismatches on 1024 samples, and a trace holding the solve,
    the executor's call and codegen."""
    import torch

    from da4ml_tpu_torch._cli import main
    from da4ml_tpu_torch.models import flagship_twin

    torch.save(flagship_twin(), tmp_path / 'f.pt')
    argv = ['convert', str(tmp_path / 'f.pt'), str(tmp_path / 'prj'), '--solver-backend', 'torch', '--device', 'cpu',
            '--inputs-kif', '1', '3', '2', '-v', '0', '--trace', str(tmp_path / 't.json')]  # fmt: skip
    assert main(argv) == 0
    assert json.loads((tmp_path / 'prj' / 'mismatches.json').read_text())['n_mismatch'] == 0
    events, metrics = telemetry.load_trace(tmp_path / 't.json')
    telemetry.validate_trace(events)
    assert {'cli.convert', 'trace.model', 'cmvm.solve', 'run.call', 'codegen.rtl.write'} <= {e['name'] for e in events}
    assert metrics['cse.device_rounds']['value'] > 0 and metrics['run.samples']['value'] == 1024


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------


def _emission_sites():
    """``(module, name or None, line)`` for every ``counter``/``gauge``/
    ``histogram``/``timer`` call in the port; ``name`` is None for a
    non-literal name (an f-string)."""
    sites = []
    for path in sorted((ROOT / 'da4ml_tpu_torch').rglob('*.py')):
        rel = path.relative_to(ROOT).as_posix()
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else fn.id if isinstance(fn, ast.Name) else None
            if fname not in ('counter', 'gauge', 'histogram', 'timer'):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                sites.append((rel, arg.value, node.lineno))
            elif isinstance(arg, ast.JoinedStr):
                sites.append((rel, None, node.lineno))
    return sites


def test_catalog_covers_every_emission_site():
    from da4ml_tpu_torch.telemetry.catalog import DYNAMIC_SITES, METRICS, fold_family, help_for

    sites = [s for s in _emission_sites() if not s[0].startswith('da4ml_tpu_torch/telemetry/metrics.py')]
    literal = {fold_family(name) for _, name, _ in sites if name is not None}
    missing = sorted(n for n in literal if n not in METRICS)
    assert not missing, f'emitted but not catalogued: {missing}'
    dynamic = {mod for mod, name, _ in sites if name is None}
    assert dynamic == set(DYNAMIC_SITES), dynamic
    emitted = literal | {f for fams in DYNAMIC_SITES.values() for f in fams}
    assert set(METRICS) == emitted, f'catalogued with no emission site: {sorted(set(METRICS) - emitted)}'
    assert all(help_for(f) == METRICS[f] for f in METRICS)


def test_catalog_keeps_the_reference_names_and_help():
    """Every family the port emits is one of the reference's, with its HELP
    text: a scrape of either package reads alike."""
    from da4ml_tpu.telemetry.catalog import FOLDS as JFOLDS
    from da4ml_tpu.telemetry.catalog import METRICS as JMETRICS
    from da4ml_tpu_torch.telemetry.catalog import FOLDS, METRICS

    assert {k: JMETRICS.get(k) for k in METRICS} == METRICS
    assert FOLDS.items() <= JFOLDS.items()
