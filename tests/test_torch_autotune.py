"""The port's ``mode='auto'``: the static rule, the measured race and the
decision cache keyed by (program digest, platform), and the example plugin.

The counterparts of the reference's autotune tests
(``tests/test_runtime_modes.py``) run the port's executor on the CPU with an
isolated decision cache (``tuner_env``); the static answer is held to the
reference's ``DaisExecutor(prog).mode`` on the same narrow programs, the
reference run with its JAX compile cache and decisions isolated the way its
own fixture isolates them. Every winner's output equals the port's reference
interpreter exactly. The example plugin's trace is byte-identical to the
reference plugin's.

Isolation: no test here runs the JAX executor on a wide program (it would
flip ``jax_enable_x64`` for the whole process); an autouse fixture asserts
that no test changed the flag.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import da4ml_tpu.runtime.jax_backend as jb
from da4ml_tpu.ir import dais_binary as jbin
from da4ml_tpu.ir.synth import random_program as jax_random_program
from da4ml_tpu.runtime.jax_backend import DaisExecutor as JaxExecutor
from da4ml_tpu_torch import telemetry
from da4ml_tpu_torch.ir.dais_binary import encode
from da4ml_tpu_torch.ir.synth import FAMILIES, random_inputs, random_pipeline, random_program
from da4ml_tpu_torch.runtime import cuda_backend, reference
from da4ml_tpu_torch.runtime import torch_backend as tb
from da4ml_tpu_torch.runtime.torch_backend import MODES, DaisExecutor

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ('DA4ML_RUN_MODE', 'DA4ML_RUN_AUTOTUNE', 'DA4ML_RUN_AUTOTUNE_MIN_OPS', 'DA4ML_RUN_AUTOTUNE_BATCH',
         'DA4ML_TORCH_CACHE')  # fmt: skip


@pytest.fixture(autouse=True)
def _x64_unchanged(monkeypatch):
    """No test of this file may change JAX's process-wide x64 flag; each
    starts with the executor's knobs unset and telemetry reset."""
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    before = jax.config.read('jax_enable_x64')
    telemetry.reset()
    yield
    telemetry.reset()
    assert jax.config.read('jax_enable_x64') == before, 'a test changed jax_enable_x64 for the whole process'


@pytest.fixture
def tuner_env(monkeypatch, tmp_path):
    """An isolated decision cache and a small race batch; the port's
    in-process decisions saved, cleared and restored."""
    monkeypatch.setenv('DA4ML_TORCH_CACHE', str(tmp_path))
    monkeypatch.setenv('DA4ML_RUN_AUTOTUNE_MIN_OPS', '0')
    monkeypatch.setenv('DA4ML_RUN_AUTOTUNE_BATCH', '64')
    saved = dict(tb._MODE_DECISIONS)
    tb._MODE_DECISIONS.clear()
    yield tmp_path
    tb._MODE_DECISIONS.clear()
    tb._MODE_DECISIONS.update(saved)


AUTOTUNE_CANDIDATE = cuda_backend.autotune_candidate


def k1_in_race(monkeypatch):
    """Put K1 into the CPU's race, as on the card (its plain version runs)."""
    monkeypatch.setattr(cuda_backend, 'autotune_candidate', lambda device: True)


@pytest.fixture
def jax_tuner(tmp_path):
    """The reference's own isolation (its ``tuner_env``): its JAX compile
    cache at a directory of its own, its decisions restored."""
    old = jax.config.jax_compilation_cache_dir
    jax.config.update('jax_compilation_cache_dir', str(tmp_path / 'xla'))
    saved = dict(jb._MODE_DECISIONS)
    yield
    jb._MODE_DECISIONS.clear()
    jb._MODE_DECISIONS.update(saved)
    jax.config.update('jax_compilation_cache_dir', old)


def _decision_files(root: Path) -> list[Path]:
    return sorted((root / 'run-modes').glob('*.json'))


def _count(name: str) -> float:
    return telemetry.metrics_snapshot().get(name, {}).get('value', 0)


class _Clock:
    """A clock that moves only when a paced plan runs."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t


def _paced(monkeypatch, costs: dict[str, float], built: dict | None = None) -> None:
    """The race reads a clock on which each candidate's call takes
    ``costs[mode]`` seconds, so its ranking is known whatever the host's
    load; ``built`` collects the plans the race built, by mode."""
    clock = _Clock()
    monkeypatch.setattr(tb, 'time', clock)
    real = DaisExecutor._build_plan

    def build(self, mode):
        plan = real(self, mode)

        def paced(x):
            clock.t += costs[mode]
            return plan(x)

        if built is not None:
            built[mode] = paced
        return paced

    monkeypatch.setattr(DaisExecutor, '_build_plan', build)


# ---------------------------------------------------------------------------
# counterparts of the reference's autotune tests
# ---------------------------------------------------------------------------


def test_autotune_decision_cached(tuner_env):
    """A race persists one decision file; a second construction is answered
    from memory, a third (memory cleared) from the file, none re-measured."""
    telemetry.enable(metrics=True)
    rng = np.random.default_rng(21)
    prog = random_program(rng, n_ops=300, n_in=6, n_out=4)
    ex1 = DaisExecutor(prog, device='cpu')
    assert ex1.mode in MODES
    n_tuned = _count('run.autotune')
    assert n_tuned == 1 and _count('run.mode_cache_hit') == 0
    files = _decision_files(tuner_env)
    assert len(files) == 1 and files[0].name == f'{ex1._digest()}.cpu.json', 'the decision must persist in the cache'
    assert json.loads(files[0].read_text())['mode'] == ex1.mode

    ex2 = DaisExecutor(prog, device='cpu')
    assert ex2.mode == ex1.mode and _count('run.autotune') == n_tuned and _count('run.mode_cache_hit') == 1
    tb._MODE_DECISIONS.clear()
    ex3 = DaisExecutor(prog, device='cpu')
    assert ex3.mode == ex1.mode
    assert _count('run.autotune') == n_tuned, 'no re-measure on a cache hit'
    assert _count('run.mode_cache_hit') == 2
    data = random_inputs(rng, prog, 50)
    want = reference.run_program(prog, data)
    for ex in (ex1, ex2, ex3):
        np.testing.assert_array_equal(ex(data), want)


def test_run_mode_env_forces(tuner_env, monkeypatch):
    prog = random_program(np.random.default_rng(22), n_ops=300, n_in=6, n_out=4)
    monkeypatch.setenv('DA4ML_RUN_MODE', 'scan')
    assert DaisExecutor(prog, mode='auto', device='cpu').mode == 'scan'
    # explicit modes are not overridden
    assert DaisExecutor(prog, mode='level', device='cpu').mode == 'level'
    assert not _decision_files(tuner_env), 'a forced mode raced'


def test_autotune_disabled_heuristic(tuner_env, monkeypatch):
    monkeypatch.setenv('DA4ML_RUN_AUTOTUNE', '0')
    prog = random_program(np.random.default_rng(23), n_ops=300, n_in=6, n_out=4)
    assert DaisExecutor(prog, mode='auto', device='cpu').mode == 'unroll'
    monkeypatch.setattr(DaisExecutor, 'UNROLL_LIMIT', 100)
    assert DaisExecutor(prog, mode='auto', device='cpu').mode == 'level'
    assert not _decision_files(tuner_env) and not tb.mode_decisions()


def test_autotune_decision_platform_keyed(tuner_env, monkeypatch):
    """Decisions persist under (digest, platform): one measured on the CPU
    does not answer for another platform."""
    telemetry.enable(metrics=True)
    prog = random_program(np.random.default_rng(29), n_ops=300, n_in=6, n_out=4)
    ex1 = DaisExecutor(prog, device='cpu')
    files = _decision_files(tuner_env)
    assert len(files) == 1 and files[0].name.endswith('.cpu.json')
    assert list(tb.mode_decisions()) == [f'{ex1._digest()}@cpu']

    # the same digest on another platform: the memory and the file cache miss
    tb._MODE_DECISIONS.clear()
    monkeypatch.setattr(tb, '_platform', lambda device: 'elsewhere')
    ex2 = DaisExecutor(prog, device='cpu')
    assert ex2.mode in MODES and ex2._digest() == ex1._digest()
    assert _count('run.autotune') == 2, 'a decision was reused across platforms'
    assert [f.name.split('.')[1] for f in _decision_files(tuner_env)] == sorted(['cpu', 'elsewhere'])


def test_autotune_pallas_measured_never_favoured_when_slower(tuner_env, monkeypatch):
    """K1 in the race (its plain version on the CPU) is measured and wins
    only on the clock."""
    k1_in_race(monkeypatch)
    prog = random_program(np.random.default_rng(37), n_ops=300, n_in=6, n_out=4)
    ex = DaisExecutor(prog, device='cpu')
    (f,) = _decision_files(tuner_env)
    blob = json.loads(f.read_text())
    assert blob['mode'] == ex.mode and blob['platform'] == 'cpu'
    assert 'pallas_samples_per_s' in blob, 'pallas must have been measured'
    measured = {m: blob[f'{m}_samples_per_s'] for m in MODES if f'{m}_samples_per_s' in blob}
    assert blob[f'{ex.mode}_samples_per_s'] == max(measured.values())
    # the CPU's own race leaves K1 out
    monkeypatch.setattr(cuda_backend, 'autotune_candidate', AUTOTUNE_CANDIDATE)
    assert 'pallas' not in DaisExecutor(prog, mode='level', device='cpu')._candidates()


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('seed', [40, 41, 42])
def test_static_answer_equals_the_references(seed, monkeypatch, jax_tuner):
    """On the CPU the port's static answer is the reference's
    ``DaisExecutor(prog).mode`` for the same narrow program: at or under the
    minimum op count, and with ``DA4ML_RUN_AUTOTUNE=0`` on either side of
    ``UNROLL_LIMIT`` (patched down on both classes)."""
    jprog = jax_random_program(np.random.default_rng(seed), n_ops=150, n_in=5, n_out=4)
    prog = random_program(np.random.default_rng(seed), n_ops=150, n_in=5, n_out=4)
    assert np.array_equal(encode(prog), jbin.encode(jprog)), 'the two generators differ'
    cases = [({}, None), ({'DA4ML_RUN_AUTOTUNE_MIN_OPS': '200'}, None),
             ({'DA4ML_RUN_AUTOTUNE': '0', 'DA4ML_RUN_AUTOTUNE_MIN_OPS': '10'}, None),
             ({'DA4ML_RUN_AUTOTUNE': 'off', 'DA4ML_RUN_AUTOTUNE_MIN_OPS': '10'}, 100)]  # fmt: skip
    got, want = [], []
    for env, limit in cases:
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            if limit is not None:
                mp.setattr(DaisExecutor, 'UNROLL_LIMIT', limit)
                mp.setattr(JaxExecutor, 'UNROLL_LIMIT', limit)
            jex = JaxExecutor(jprog)
            assert not jex.use_i64
            want.append(jex.mode)
            got.append(DaisExecutor(prog, device='cpu').mode)
    assert got == want == ['unroll', 'unroll', 'unroll', 'level']


def test_static_answer_on_a_cuda_device_is_k1(monkeypatch):
    """The card's static answer is ``'pallas'`` at every size, where the
    CPU's is the reference's ``'unroll'`` (up to ``UNROLL_LIMIT``) or
    ``'level'`` (above it, with the race off). Only the rule is asked; no
    plan is built."""
    import torch

    prog = random_program(np.random.default_rng(43), n_ops=150, n_in=5, n_out=4)
    ex = DaisExecutor(prog, mode='level', device='cpu')
    ex.device = torch.device('cuda')
    assert ex._select_mode() == ('pallas', None)
    monkeypatch.setenv('DA4ML_RUN_AUTOTUNE', '0')
    monkeypatch.setattr(DaisExecutor, 'UNROLL_LIMIT', 100)
    assert ex._select_mode() == ('pallas', None)
    ex.device = torch.device('cpu')
    assert ex._select_mode() == ('level', None)
    assert cuda_backend.autotune_candidate(torch.device('cuda'))
    assert not cuda_backend.autotune_candidate(torch.device('cpu'))


def test_race_candidates_follow_the_references_rule(monkeypatch):
    """Up to ``UNROLL_LIMIT``: level, unroll, scan; above it level and scan,
    or scan alone on a chain-shaped program (fewer than 4 ops a level); K1
    first where it is a candidate."""
    prog = random_program(np.random.default_rng(44), n_ops=200, n_in=5, n_out=4)
    ex = DaisExecutor(prog, mode='level', device='cpu')
    assert ex._candidates() == ['level', 'unroll', 'scan']
    k1_in_race(monkeypatch)
    assert ex._candidates() == ['pallas', 'level', 'unroll', 'scan']
    monkeypatch.setattr(DaisExecutor, 'UNROLL_LIMIT', 50)
    assert prog.n_ops / ex.schedule.depth >= 4
    assert ex._candidates() == ['pallas', 'level', 'scan']
    chain = random_program(np.random.default_rng(45), n_ops=200, n_in=2, n_out=1, n_levels=150)
    cex = DaisExecutor(chain, mode='level', device='cpu')
    assert chain.n_ops / cex.schedule.depth < 4
    assert cex._candidates() == ['pallas', 'scan']


def test_race_batch_is_cut_for_wide_rows(tuner_env, monkeypatch):
    """The race batch is at most ``DA4ML_RUN_AUTOTUNE_BATCH`` rows, and no
    more than one call-boundary chunk of this program's float64 rows holds."""
    monkeypatch.delenv('DA4ML_RUN_AUTOTUNE_BATCH')
    rng = np.random.default_rng(46)
    prog = random_program(rng, n_ops=200, n_in=24, n_out=4)
    ex = DaisExecutor(prog, mode='level', device='cpu')
    x = ex._race_batch()
    assert tuple(x.shape) == (4096, 24) and x.dtype == ex.dtype
    want = ((np.arange(4096 * 24, dtype=np.int64).reshape(4096, 24) * 2654435761) % 255 - 127).astype(np.int32)
    np.testing.assert_array_equal(x.numpy(), want)  # the reference's synthetic batch
    monkeypatch.setattr(tb, 'CHUNK_BYTES', 8 * 24 * 37 + 5)
    assert tuple(ex._race_batch().shape) == (37, 24)
    monkeypatch.setenv('DA4ML_RUN_AUTOTUNE_BATCH', '20')
    assert ex._race_batch().shape[0] == 20
    monkeypatch.delenv('DA4ML_RUN_AUTOTUNE_BATCH')
    auto = DaisExecutor(prog, device='cpu')
    (f,) = _decision_files(tuner_env)
    assert json.loads(f.read_text())['batch'] == 37
    data = random_inputs(rng, prog, 90)
    np.testing.assert_array_equal(auto(data), reference.run_program(prog, data))


def test_a_candidate_over_its_bound_is_skipped_and_the_winner_unchanged(tuner_env, monkeypatch):
    """On a clock where level takes 50 ms, unroll 10 ms and scan 300 ms a
    call, and with the launch floor patched to 0.1 ms, scan's bound (two
    launches an op, a constant's one) exceeds unroll's time and scan is skipped,
    recorded with its bound; without the skip (floor 0) scan is measured and
    loses, and the winner is the same. Unpatched, each mode's bound is below
    its measured time."""
    prog = random_program(np.random.default_rng(47), n_ops=120, n_in=5, n_out=4)
    real_build, real_floor = DaisExecutor._build_plan, tb._launch_floor_s
    _paced(monkeypatch, {'level': 0.05, 'unroll': 0.01, 'scan': 0.3})
    floor = 1e-4
    monkeypatch.setattr(tb, '_launch_floor_s', lambda device: floor)
    ex = DaisExecutor(prog, device='cpu')
    (f,) = _decision_files(tuner_env)
    skipped = json.loads(f.read_text())
    n_const = int(np.count_nonzero(prog.opcode == 5))
    assert skipped['scan_skipped_bound_s'] == pytest.approx((2 * prog.n_ops - n_const) * floor)
    assert 'scan_samples_per_s' not in skipped and 'scan_compile_s' not in skipped
    assert {'level_samples_per_s', 'unroll_samples_per_s'} <= set(skipped) and ex.mode == 'unroll'

    tb._MODE_DECISIONS.clear()
    f.unlink()
    monkeypatch.setattr(tb, '_launch_floor_s', lambda device: 0.0)
    full = DaisExecutor(prog, device='cpu')
    blob = json.loads(f.read_text())
    assert 'scan_samples_per_s' in blob and not any(k.endswith('_skipped_bound_s') for k in blob)
    assert full.mode == ex.mode == 'unroll'

    monkeypatch.setattr(tb, 'time', time)  # the host's clock again
    floor = real_floor(ex.device)
    assert floor > 0
    x = ex._race_batch()
    for m in MODES:
        plan = real_build(ex, m)
        plan(x)
        run_s = float('inf')
        for _ in range(3):
            t0 = time.perf_counter()
            plan(x)
            run_s = min(run_s, time.perf_counter() - t0)
        assert ex._min_launches(m) * floor <= run_s, (m, ex._min_launches(m), floor, run_s)


def test_a_raising_pallas_candidate_raises(tuner_env, monkeypatch):
    """No fallback: a K1 candidate that fails raises out of the race and
    nothing is stored."""
    k1_in_race(monkeypatch)

    def broken(self, x):
        raise RuntimeError('K1 failed to launch')

    monkeypatch.setattr(cuda_backend.DaisKernel, '__call__', broken)
    prog = random_program(np.random.default_rng(48), n_ops=200, n_in=5, n_out=4)
    with pytest.raises(RuntimeError, match='K1 failed to launch'):
        DaisExecutor(prog, device='cpu')
    assert not _decision_files(tuner_env) and not tb.mode_decisions()


def test_corrupt_and_foreign_decision_files_are_ignored(tuner_env, monkeypatch):
    """An unreadable, corrupt, unknown-mode or other-platform decision file
    is raced over (and replaced); a valid one answers without a race."""
    telemetry.enable(metrics=True)
    prog = random_program(np.random.default_rng(49), n_ops=200, n_in=5, n_out=4)
    digest = DaisExecutor(prog, mode='level', device='cpu')._digest()
    d = tuner_env / 'run-modes'
    d.mkdir(parents=True)
    path = d / f'{digest}.cpu.json'
    bad = ['{"mode": "sc', '[1, 2]', json.dumps({'mode': 'fastest', 'platform': 'cpu'}),
           json.dumps({'mode': 'scan', 'platform': 'cuda'}), '']  # fmt: skip
    for k, text in enumerate(bad):
        tb._MODE_DECISIONS.clear()
        path.write_text(text)
        ex = DaisExecutor(prog, device='cpu')
        assert _count('run.autotune') == k + 1, text
        blob = json.loads(path.read_text())
        assert blob['mode'] == ex.mode and blob['platform'] == 'cpu'
    path.unlink()
    path.mkdir()  # unreadable as a file: raced, the write fails quietly
    tb._MODE_DECISIONS.clear()
    assert DaisExecutor(prog, device='cpu').mode in MODES and _count('run.autotune') == len(bad) + 1
    path.rmdir()
    path.write_text(json.dumps({'mode': 'scan', 'platform': 'cpu'}))
    tb._MODE_DECISIONS.clear()
    assert DaisExecutor(prog, device='cpu').mode == 'scan'
    assert _count('run.autotune') == len(bad) + 1 and _count('run.mode_cache_hit') == 1
    assert not list(d.glob('*.tmp*')), 'a temporary decision file was left behind'


def test_the_cache_directory_is_the_ports_own(monkeypatch, tmp_path):
    """``run-modes`` under ``DA4ML_TORCH_CACHE``, else under
    ``~/.cache/da4ml_tpu_torch``; ``0``/``none``/``off`` keep decisions in
    memory. Never under the reference's cache."""
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    assert tb._mode_cache_dir() == str(tmp_path / 'home' / '.cache' / 'da4ml_tpu_torch' / 'run-modes')
    monkeypatch.setenv('DA4ML_TORCH_CACHE', str(tmp_path / 'c'))
    assert tb._mode_cache_dir() == str(tmp_path / 'c' / 'run-modes') and (tmp_path / 'c' / 'run-modes').is_dir()
    for off in ('0', 'none', 'OFF'):
        monkeypatch.setenv('DA4ML_TORCH_CACHE', off)
        assert tb._mode_cache_dir() is None
    saved = dict(tb._MODE_DECISIONS)
    tb._MODE_DECISIONS.clear()
    try:
        monkeypatch.setenv('DA4ML_RUN_AUTOTUNE_MIN_OPS', '0')
        monkeypatch.setenv('DA4ML_RUN_AUTOTUNE_BATCH', '16')
        prog = random_program(np.random.default_rng(50), n_ops=100, n_in=4, n_out=3)
        ex = DaisExecutor(prog, device='cpu')
        assert tb.mode_decisions() == {f'{ex._digest()}@cpu': ex.mode}
        assert not list(tmp_path.rglob('*.json')), 'an in-memory decision was written'
    finally:
        tb._MODE_DECISIONS.clear()
        tb._MODE_DECISIONS.update(saved)


def test_a_child_process_reads_the_same_decision(tuner_env):
    """A decision persisted by this process answers a child process's
    construction of the same program without a race."""
    prog = random_program(np.random.default_rng(51), n_ops=200, n_in=5, n_out=4)
    ex = DaisExecutor(prog, device='cpu')
    code = (
        'import numpy as np\n'
        'from da4ml_tpu_torch.ir.synth import random_program\n'
        'from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor\n'
        'def no_race(self, digest, platform):\n'
        '    raise SystemExit("raced")\n'
        'DaisExecutor._autotune = no_race\n'
        'prog = random_program(np.random.default_rng(51), n_ops=200, n_in=5, n_out=4)\n'
        "print(DaisExecutor(prog, device='cpu').mode)\n"
    )
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join(p for p in (str(ROOT), os.environ.get('PYTHONPATH', '')) if p)}
    out = subprocess.run([sys.executable, '-c', code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ex.mode


def test_the_digest_changes_with_k1s_build_digest(monkeypatch):
    """The digest is the program's and its environment's: stable for the
    same program, changed by the int64 path and by K1's build digest (read
    without building K1)."""
    prog = random_program(np.random.default_rng(52), n_ops=100, n_in=4, n_out=3)
    a = DaisExecutor(prog, mode='level', device='cpu')
    assert a._digest() == DaisExecutor(prog, mode='scan', device='cpu')._digest()
    assert a._digest() != DaisExecutor(prog, force_i64=True, mode='level', device='cpu')._digest()
    other = random_program(np.random.default_rng(53), n_ops=100, n_in=4, n_out=3)
    assert a._digest() != DaisExecutor(other, mode='level', device='cpu')._digest()
    k1 = cuda_backend.build_digest()
    assert len(k1) == 16 and k1 == cuda_backend.source_digest(cuda_backend.SOURCE, cuda_backend.NVCC_FLAGS)
    before = a._digest()
    monkeypatch.setattr(cuda_backend, 'build_digest', lambda: 'another build 16')
    assert a._digest() != before


@pytest.mark.parametrize('winner', MODES)
def test_every_winner_equals_the_reference_interpreter(winner, tuner_env, monkeypatch):
    """Whichever mode wins, the executor keeps the plan the race built (no
    second build), drops a losing K1, and equals the reference interpreter:
    narrow and wide programs of every family."""
    k1_in_race(monkeypatch)
    built: dict = {}
    _paced(monkeypatch, {m: 0.001 if m == winner else 0.05 for m in MODES}, built)
    monkeypatch.setattr(tb, '_launch_floor_s', lambda device: 0.0)
    for wide in (False, True):
        rng = np.random.default_rng(54 + wide)
        prog = random_program(rng, n_ops=100, n_in=5, n_out=4, families=FAMILIES, wide=wide)
        built.clear()
        ex = DaisExecutor(prog, device='cpu')
        assert ex.mode == winner and set(built) == set(MODES)
        assert ex.plan is built[winner], 'the winner was built twice'
        assert ('kernel' in vars(ex)) == (winner == 'pallas'), 'a losing K1 stayed on the executor'
        data = random_inputs(rng, prog, 40)
        np.testing.assert_array_equal(ex(data), reference.run_program(prog, data), err_msg=f'{winner} wide={wide}')


def test_fused_executor_races_under_the_minimum(tuner_env, monkeypatch):
    """``fused_executor_for_binaries`` races even a program under the
    minimum op count; an executor of one such stage takes the static
    answer."""
    telemetry.enable(metrics=True)
    monkeypatch.setenv('DA4ML_RUN_AUTOTUNE_MIN_OPS', str(10**6))
    rng = np.random.default_rng(56)
    stages = [encode(p) for p in random_pipeline(rng, n_stages=2, n_ops=60)]
    assert tb.executor_for_binary(stages[0], device='cpu').mode == 'unroll' and _count('run.autotune') == 0
    ex = tb.fused_executor_for_binaries(stages, device='cpu')
    assert _count('run.autotune') == 1 and len(_decision_files(tuner_env)) == 1
    assert tb.fused_executor_for_binaries(stages, device='cpu') is ex
    data = rng.uniform(-8, 8, (33, ex.prog.n_in))
    np.testing.assert_array_equal(ex(data), reference.run_program(ex.prog, data))


def test_statusz_and_health_show_the_decision(tuner_env):
    from da4ml_tpu_torch.telemetry.obs import serve, status_snapshot, stop_server

    prog = random_program(np.random.default_rng(57), n_ops=150, n_in=5, n_out=4)
    ex = DaisExecutor(prog, device='cpu')
    want = {f'{ex._digest()}@cpu': ex.mode}
    assert status_snapshot()['run_modes'] == want == tb.mode_decisions()
    import urllib.request

    srv = serve(0)
    try:
        with urllib.request.urlopen(srv.url + '/statusz', timeout=10) as resp:
            assert json.loads(resp.read().decode())['run_modes'] == want
    finally:
        stop_server()


def test_the_catalog_has_the_new_families():
    from da4ml_tpu.telemetry.catalog import METRICS as JAX_METRICS

    from da4ml_tpu_torch.telemetry.catalog import METRICS

    for fam in ('run.autotune', 'run.mode_cache_hit'):
        assert METRICS[fam] == JAX_METRICS[fam]


# ---------------------------------------------------------------------------
# the example plugin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('inputs_defined', [True, False])
def test_example_plugin_traces_the_references_program(inputs_defined):
    """The port's example plugin, pre-registered under ``da4ml_tpu_torch``,
    traces the same program as the reference's under ``da4ml_tpu``, byte for
    byte (native solver on both sides), and the program equals the model's
    numpy evaluation on seeded inputs."""
    import da4ml_tpu.converter as jconverter
    import da4ml_tpu.converter.example as jexample
    import da4ml_tpu.trace as jtrace

    import da4ml_tpu_torch.converter as tconverter
    import da4ml_tpu_torch.converter.example as texample
    import da4ml_tpu_torch.trace as ttrace

    assert tconverter.get_available_plugins()['da4ml_tpu_torch'] == 'da4ml_tpu_torch.converter.example:ExampleTracer'
    binaries = []
    for conv, trace, example in ((tconverter, ttrace, texample), (jconverter, jtrace, jexample)):
        model = example.ExampleModel(input_shape=None if inputs_defined else (4, 5))
        opts = {'backend': 'cpp'}
        if inputs_defined:
            inputs = trace.FixedVariableArrayInput((4, 5), trace.HWConfig(1, -1, -1), solver_options=opts)
            inp, out = conv.trace_model(model, solver_options=opts, inputs=inputs)
        else:
            inp, out = conv.trace_model(model, solver_options=opts)
        comb = trace.comb_trace(inp, out)
        binaries.append(np.asarray(comb.to_binary()))
        if example is texample:
            port_comb = comb
    assert np.array_equal(binaries[0], binaries[1])
    data = np.random.default_rng(42).uniform(-128, 128, (200, 4, 5))
    golden = np.array([texample.operation(x).ravel() for x in data])
    np.testing.assert_array_equal(port_comb.predict(data.reshape(200, -1), backend='numpy'), golden)
    with pytest.raises(ValueError, match='cannot determine input shapes'):
        tconverter.trace_model(texample.ExampleModel(input_shape=None))
