"""The port's call boundary and pipeline executor against the JAX package's.

- ``_infer_chunks`` is the reference's rule: equal to it over a grid of batch
  sizes and row widths at the reference's budget and cap, and at the port's
  it gives the chunk counts the measurement chose;
- the call (``boundary_call``: the conversion as torch ops, ``fn``, the
  int->float) equals the one-launch route, in one chunk and in several,
  empty and ragged batches too;
- the conversion as torch ops (``int_inputs_on``) equals ``_int_inputs``
  word for word, values beyond the integer type's range included, and NaN
  and inf are refused with the host's error text (on the CPU this checks the
  code path; ``chip_smoke.py`` checks the cast on the card);
- ``PipelineExecutor`` (``__call__``, ``chained``) and ``run_pipeline`` with
  each ``fused`` equal the JAX package's ``run_pipeline`` with the same
  ``fused``, on synth chains and on a positive-shift boundary between two
  int32 stages and a 64->32 boundary;
- the executor caches are least-recently-used, and a stage list's key tells
  apart lists whose bytes run together.

The JAX side runs its ``level`` mode (``DA4ML_RUN_MODE``), the JAX package's
CPU executor. Tolerance is exact."""

from collections import OrderedDict

import numpy as np
import pytest
import torch

from da4ml_tpu.ir.dais_binary import encode
from da4ml_tpu.ir.synth import FAMILIES, random_inputs, random_pipeline, random_program
from da4ml_tpu.runtime import jax_backend as jb
from da4ml_tpu_torch.ir.dais_binary import decode
from da4ml_tpu_torch.ir.fuse import fuse_binaries
from da4ml_tpu_torch.runtime import PipelineExecutor, fused_executor_for_binaries, run_pipeline
from da4ml_tpu_torch.runtime import torch_backend as tb
from da4ml_tpu_torch.runtime.reference import run_program

CPU = torch.device('cpu')


@pytest.fixture
def level_mode(monkeypatch):
    """The JAX executors in their ``level`` mode (no autotune)."""
    monkeypatch.setenv('DA4ML_RUN_MODE', 'level')
    monkeypatch.delenv('DA4ML_JAX_INFER_CHUNKS', raising=False)
    monkeypatch.delenv('DA4ML_JAX_INFER_CHUNK_BYTES', raising=False)


def corpus():
    """Synth programs of every family, narrow and wide, and a few lane
    widths: ``[(label, reference DaisProgram)]``."""
    rng = np.random.default_rng(20261017)
    progs = [(f'family {f}', random_program(rng, n_ops=40, n_in=5, n_out=7, families=(f,))) for f in FAMILIES]
    progs += [(f'wide {k}', random_program(rng, n_ops=60, n_in=6, n_out=5, wide=True)) for k in range(2)]
    # inputs of 12 to 14 bits: int16 lanes
    mid = random_program(rng, n_ops=40, n_in=5, n_out=4, families=('add',))
    progs.append(('int16 inputs', mid._replace(integers=np.where(mid.opcode == -1, 11, mid.integers).astype(np.int32))))
    return progs


def test_infer_chunks_matches_jax(level_mode, monkeypatch):
    # the port's budget and cap: one chunk for the flagship's 2^20 float64
    # rows of 16 inputs, four for the config-5 model's (192 inputs) and for
    # 2048 rows of the 256x256 conv front end
    assert [tb._infer_chunks(n, 8 * cols) for n, cols in ((1 << 20, 16), (1 << 20, 192), (2048, 65536))] == [1, 4, 4]
    monkeypatch.setattr(tb, 'CHUNK_BYTES', 1 << 20)  # the reference's budget and cap
    monkeypatch.setattr(tb, 'CHUNK_MAX', 16)
    for n in (0, 1, 5, 1000, 4095, 65536, 1 << 20, 3_000_001):
        for row_bytes in (0, 1, 4, 16, 128, 4096, 1 << 20):
            assert tb._infer_chunks(n, row_bytes) == jb._infer_chunks(n, row_bytes), (n, row_bytes)


@pytest.mark.parametrize('n', [0, 1, 7, 100, 1001])
def test_chunked_call_equals_one_launch(monkeypatch, n):
    ref_prog = random_program(np.random.default_rng(n), n_ops=80, n_in=6, n_out=4, families=FAMILIES)
    ex = tb.DaisExecutor(decode(encode(ref_prog)), device='cpu')
    data = random_inputs(np.random.default_rng(2), ref_prog, n)
    one = ex.fn_int(ex.int_inputs(data)).numpy().astype(np.float64) * ex._out_scale()
    want = run_program(ex.prog, data) if n else np.zeros((0, ex.prog.n_out))
    assert np.array_equal(one, want)
    got = ex(data)
    assert got.shape == (n, ex.prog.n_out) and np.array_equal(got, want)
    monkeypatch.setattr(tb, 'CHUNK_BYTES', 16)  # several chunks, the last one padded
    for cap in (4, 16):
        monkeypatch.setattr(tb, 'CHUNK_MAX', cap)
        assert tb._infer_chunks(n, 24) == (1 if n * 24 < 32 else min(-(-n * 24 // 16), cap, n))
        got = tb.boundary_call(ex, ex, ex.fn_int, data, CPU)
        assert got.shape == (n, ex.prog.n_out) and np.array_equal(got, want), cap


@pytest.mark.parametrize('wide', [False, True])
def test_conversion_as_torch_ops_equals_host(wide):
    rng = np.random.default_rng(5)
    ref_prog = random_program(rng, n_ops=60, n_in=6, n_out=3, wide=wide)
    ex = tb.DaisExecutor(decode(encode(ref_prog)), device='cpu')
    assert ex.use_i64 == wide
    edges = (1e19, -1e19, 1e300, -1e300, 2.0**63, -(2.0**63) - 4096) if wide else (3e9, -3e9, 1e12, -1e12, 1e300,
                                                                                  -1e300, 2.0**31, -(2.0**31) - 1)  # fmt: skip
    data = random_inputs(rng, ref_prog, 50)
    rows = rng.integers(0, len(data), 3 * len(edges))
    data[rows, rng.integers(0, ex.prog.n_in, len(rows))] = np.resize(edges, len(rows))
    bad = torch.zeros((), dtype=torch.int64)
    got = ex.int_inputs_on(torch.from_numpy(data), bad).numpy()
    with np.errstate(invalid='ignore'):  # numpy warns on the out-of-range cast it makes
        want = ex._int_inputs(data)
    assert int(bad) == 0 and got.dtype == want.dtype and np.array_equal(got, want)
    y = ex.fn_int(torch.from_numpy(want))
    one_launch = y.numpy().astype(np.float64) * ex._out_scale()
    assert np.array_equal(ex.float_outputs_on(y).numpy(), one_launch)
    assert np.array_equal(ex(data), one_launch)
    for v in (np.nan, np.inf, -np.inf):
        odd = data.copy()
        odd[[1, 4], 0] = v
        with pytest.raises(tb.InvalidInputError) as host:
            ex._int_inputs(odd)
        with pytest.raises(tb.InvalidInputError) as card:
            ex(odd)
        assert str(card.value) == str(host.value) == 'DaisExecutor: input contains 2 non-finite (NaN/inf) value(s)'


def shift_chains():
    """Stage chains whose boundaries the executor must widen: a positive
    shift between two int32 stages, and a 64->32 boundary."""
    rng = np.random.default_rng(11)
    a, b = random_pipeline(rng, n_stages=2, n_ops=50)
    up = (a, b._replace(inp_shifts=b.inp_shifts + 2))
    rng = np.random.default_rng(12)
    wide = random_program(rng, n_ops=60, n_in=4, n_out=3, wide=True)
    out_idxs = wide.out_idxs.copy()
    out_idxs[out_idxs < 0] = int(wide.n_in)
    wide = wide._replace(out_idxs=out_idxs, out_negs=np.zeros_like(wide.out_negs))
    narrow = random_program(rng, n_ops=50, n_in=3, n_out=3)
    return [('positive shift, int32 stages', up), ('64->32', (wide, narrow))]


def synth_chains():
    chains = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        chains.append((f'seed {seed}', random_pipeline(rng, n_stages=3, n_ops=50)))
    return chains + shift_chains()


@pytest.mark.parametrize('label, chain', [pytest.param(*c, id=c[0]) for c in synth_chains()])
def test_pipeline_executor_matches_jax(level_mode, monkeypatch, label, chain):
    binaries = [encode(p) for p in chain]
    data = random_inputs(np.random.default_rng(4), chain[0], 65)
    ex = PipelineExecutor([decode(b) for b in binaries], device='cpu')
    if label == 'positive shift, int32 stages':
        assert ex._bound64 == [True] and not any(s.use_i64 for s in ex.stages)
        assert (ex._shifts[0] > 0).any()
    if label == '64->32':
        assert ex._bound64 == [True] and [s.use_i64 for s in ex.stages] == [True, False]
    # the fused program under the reference interpreter: the chained integer
    # semantics, seam by seam
    want = run_program(decode(fuse_binaries(binaries)), data)
    monkeypatch.setattr(tb, 'CHUNK_BYTES', 64)  # chunked, the last chunk padded
    monkeypatch.setattr(tb, 'CHUNK_MAX', 16)
    for fused in (True, False, 'ir'):
        ref = jb.run_pipeline(binaries, data, fused=fused)
        assert np.array_equal(ref, want), (label, fused)
        assert np.array_equal(run_pipeline(binaries, data, device='cpu', fused=fused), ref), (label, fused)
    assert np.array_equal(ex(data), want) and np.array_equal(ex.chained(data), want)
    fex = fused_executor_for_binaries(binaries, device='cpu')
    assert fused_executor_for_binaries(binaries, device='cpu') is fex
    assert tb.pipeline_executor_for_binaries(binaries, device='cpu') is tb.pipeline_executor_for_binaries(binaries, 'cpu')


def test_executor_caches_are_lru(monkeypatch):
    rng = np.random.default_rng(21)
    progs = [random_program(rng, n_ops=30, n_in=4, n_out=4) for _ in range(3)]
    b0, b1, b2 = (encode(p) for p in progs)
    # length-prefixed keys: two stage lists whose bytes run together differ
    assert tb._pipeline_key([b0, b1]) != tb._pipeline_key([np.concatenate([b0, b1])])
    monkeypatch.setattr(tb, '_EXECUTOR_CACHE_CAP', 2)
    monkeypatch.setattr(tb, '_executor_cache', OrderedDict())
    monkeypatch.delenv('DA4ML_RUN_MODE', raising=False)
    e0, e1 = tb.executor_for_binary(b0, device='cpu'), tb.executor_for_binary(b1, device='cpu')
    assert tb.executor_for_binary(b0, device=torch.device('cpu')) is e0  # a hit: b1 is now the least recently used
    tb.executor_for_binary(b2, device='cpu')
    assert list(tb._executor_cache) == [(b0.tobytes(), 'auto', '', 'cpu'), (b2.tobytes(), 'auto', '', 'cpu')]
    assert tb.executor_for_binary(b1, device='cpu') is not e1
    data = random_inputs(np.random.default_rng(3), progs[1], 20)
    assert np.array_equal(tb.run_binary(b1, data, device='cpu'), run_program(decode(b1), data))
