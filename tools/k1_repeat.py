#!/usr/bin/env python3
"""K1 (the DAIS kernel, ``da4ml_tpu_torch/csrc/dais_exec.cu``) launched many
times on one NVIDIA GPU, for faults that show only now and then, and timed
on the flagship.

Runs the port found under ``--root`` (default: this checkout), so that two
checkouts can be held against each other on one card, each in its own
process, e.g. a parent commit unpacked with ``git archive`` into ``build/``:

    python3 tools/k1_repeat.py --root build/parent
    python3 tools/k1_repeat.py
    python3 tools/k1_repeat.py --scratch

1. repeat: the first program of ``chip_smoke.py``'s K1 corpus (160 add/sub
   ops, the shared-memory path) on the same 131073 inputs that corpus gives
   it, launched ``REPEATS`` times; each output is held to the plain
   version's, computed once on the card; a differing launch is counted, with
   its words and rows, and whether the reference interpreter agrees with the
   kernel or with the plain version on those rows;
2. corpus: the shared-memory programs of that corpus (one for each synth
   family, two mixed, three int64, one over 48 KB of shared memory, one
   with two tiles a block) at its batches of 33, 1000 and 131073 rows,
   ``CORPUS_REPEATS`` times each, counted the same way;
3. flagship: K1 on the flagship program (``flagship_comb(backend='cpp')``)
   at 2^20 samples, the median of ``FLAGSHIP_REPS`` CUDA-event timings,
   the output's sum printed so two checkouts can be seen to agree;
4. with ``--scratch``: K1's global-memory scratch budget, the kept one
   (``cuda_backend.SCRATCH_BYTES``) against 256 MiB, in turns, on the
   config-5 model (``chip_smoke.config5_model('cpp')``, 2^20 samples) and
   the 256x256 conv front end (``chip_smoke.wide_conv_front_end``, 2048
   samples); each run equal to the first.

Prints one line per phase and, last, a JSON object of the counts and times.
Exits non-zero when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
CORPUS_SEED = 20261016  # chip_smoke.check_corpus's
CORPUS_BATCHES = (33, 1000, 131073)
FLAGSHIP_SAMPLES = 1 << 20
REPEATS = 2000  # launches of the first corpus program
CORPUS_REPEATS = 30  # launches of each (program, batch) of the corpus
FLAGSHIP_REPS = 20


def card_line() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]  # fmt: skip


def cuda_ms(torch, fn, reps: int) -> list[float]:
    """CUDA-event milliseconds of ``reps`` calls after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def shared_corpus():
    """The shared-memory programs of ``chip_smoke.check_corpus``, built as it
    builds them, and its generator after them: ``(rng, [(name, program)])``."""
    from da4ml_tpu_torch.ir.synth import FAMILIES, random_program

    rng = np.random.default_rng(CORPUS_SEED)
    corpus = [(f'family {f}', random_program(rng, n_ops=160, n_in=5, n_out=4, families=(f,))) for f in FAMILIES]
    corpus += [(f'mixed {k}', random_program(rng, n_ops=400, n_in=8, n_out=6)) for k in range(2)]
    corpus += [(f'wide {k}', random_program(rng, n_ops=400, n_in=8, n_out=6, wide=True)) for k in range(3)]
    corpus.append(('smem over 48K', random_program(np.random.default_rng(1), n_ops=1500, n_in=8, n_out=6, n_levels=5)))
    corpus.append(('two tiles a block', random_program(np.random.default_rng(0), n_ops=20, n_in=2, n_out=2,
                                                       n_levels=18)))  # fmt: skip
    return rng, corpus


class Tally:
    """Launches held to the plain version: how many, how many differed, and
    what each difference looked like."""

    def __init__(self):
        self.launches, self.bad, self.reports = 0, 0, []

    def check(self, torch, ex, prog, data, x, y_plain, label: str) -> None:
        from da4ml_tpu_torch.runtime.reference import run_program

        y = ex.kernel.launch(x)
        torch.cuda.synchronize()
        self.launches += 1
        if torch.equal(y, y_plain):
            return
        self.bad += 1
        rows = (y != y_plain).any(1).nonzero().flatten()
        ref = run_program(prog, data[rows.cpu().numpy()])
        scale = ex._out_scale()
        kernel_ok = np.array_equal(y[rows].cpu().numpy().astype(np.float64) * scale, ref)
        plain_ok = np.array_equal(y_plain[rows].cpu().numpy().astype(np.float64) * scale, ref)
        tiles = sorted({r // 32 for r in rows.tolist()})
        report = (f'{label}: {int((y != y_plain).sum())} words differ in {len(rows)} rows, {len(tiles)} tiles '
                  f'(first {tiles[:8]}); the reference agrees with the kernel: {kernel_ok}, the plain version: '
                  f'{plain_ok}')  # fmt: skip
        self.reports.append(report)
        print(report, flush=True)


def scratch_scan(torch, ex, x, label: str, card: str) -> dict:
    """K1 at the kept scratch budget and at 256 MiB, in turns (each timed
    twice, the order reversed the second time), each run equal to the first."""
    from da4ml_tpu_torch.runtime import cuda_backend

    kept = cuda_backend.SCRATCH_BYTES
    budgets = (kept, 256 << 20)
    want, times, launches = ex.kernel.launch(x), {b: [] for b in budgets}, {}
    for order in (budgets, budgets[::-1]):
        for b in order:
            cuda_backend.SCRATCH_BYTES = b
            try:
                cuda_backend.reset_counts()
                assert torch.equal(ex.kernel.launch(x), want), f'{label}: K1 at a {b >> 20} MiB scratch differs'
                launches[b] = cuda_backend.launches
                times[b].append(statistics.median(cuda_ms(torch, lambda: ex.kernel.launch(x), 5)))
            finally:
                cuda_backend.SCRATCH_BYTES = kept
    print(f'[{card}] {label} K1 by scratch budget: ' + '; '.join(
        f"{b >> 20} MiB{' (kept)' if b == kept else ''}, {launches[b]} launches: "
        f"{', '.join(f'{t:.4f}' for t in ts)} ms" for b, ts in times.items()), flush=True)  # fmt: skip
    return {f'{b >> 20} MiB': {'launches': launches[b], 'ms': ts} for b, ts in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', type=Path, default=HERE, help='checkout whose da4ml_tpu_torch runs')
    ap.add_argument('--scratch', action='store_true', help='also time the scratch budgets (traces two models)')
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print('k1_repeat: no CUDA device', file=sys.stderr)
        return 2
    from da4ml_tpu_torch.entry import flagship_comb
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.ir.synth import random_inputs
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    assert Path(cuda_backend.__file__).resolve().is_relative_to(root), cuda_backend.__file__
    card = card_line()
    print(f'{card}; port at {root}', flush=True)
    t0 = time.perf_counter()
    cuda_backend.build()
    print(f'build dais_exec: {time.perf_counter() - t0:.3f} s', flush=True)
    result = {'root': str(root), 'card': card}

    # 1. the first corpus program on the inputs the corpus gives it at 131073 rows
    rng, corpus = shared_corpus()
    name, prog = corpus[0]
    data = [random_inputs(rng, prog, b) for b in CORPUS_BATCHES][-1]
    ex = DaisExecutor(prog, mode='pallas', device='cuda')
    x = ex.int_inputs(data)
    y_plain = ex.plain(x)
    tally = Tally()
    t0 = time.perf_counter()
    for k in range(REPEATS):
        tally.check(torch, ex, prog, data, x, y_plain, f'{name} at {len(data)} rows, launch {k}')
    print(f'[{card}] repeat: corpus {name} at {len(data)} rows, {tally.launches} launches, {tally.bad} differ from '
          f'the plain version ({time.perf_counter() - t0:.1f} s)', flush=True)  # fmt: skip
    result['repeat'] = {'program': name, 'rows': len(data), 'launches': tally.launches, 'differ': tally.bad,
                        'reports': tally.reports}  # fmt: skip

    # 2. the shared-memory corpus at its three batches
    tally = Tally()
    rng = np.random.default_rng(CORPUS_SEED + 1)
    t0 = time.perf_counter()
    for name, prog in corpus:
        ex = DaisExecutor(prog, mode='pallas', device='cuda')
        for batch in CORPUS_BATCHES:
            data = random_inputs(rng, prog, batch)
            x = ex.int_inputs(data)
            y_plain = ex.plain(x)
            for k in range(CORPUS_REPEATS):
                tally.check(torch, ex, prog, data, x, y_plain, f'corpus {name} at {batch} rows, launch {k}')
    print(f'[{card}] corpus: {len(corpus)} shared-memory programs x {len(CORPUS_BATCHES)} batches, {tally.launches} '
          f'launches, {tally.bad} differ from the plain version ({time.perf_counter() - t0:.1f} s)', flush=True)  # fmt: skip
    result['corpus'] = {'launches': tally.launches, 'differ': tally.bad, 'reports': tally.reports}

    # 3. the flagship at 2^20 samples
    prog = decode(flagship_comb(backend='cpp').to_binary())
    data = np.random.default_rng(20260729).uniform(-8, 8, (FLAGSHIP_SAMPLES, prog.n_in))
    ex = DaisExecutor(prog, mode='pallas', device='cuda')
    x = ex.int_inputs(data)
    y = ex.kernel.launch(x)
    assert torch.equal(y, ex.plain(x)), 'flagship: K1 differs from its plain version'
    times = cuda_ms(torch, lambda: ex.kernel.launch(x), FLAGSHIP_REPS)
    total = int(y.sum(dtype=torch.int64))
    print(f'[{card}] flagship K1 at {FLAGSHIP_SAMPLES} samples: median {statistics.median(times):.4f} ms of '
          f'{len(times)} (min {min(times):.4f}, max {max(times):.4f}); output sum {total}', flush=True)  # fmt: skip
    result['flagship'] = {'median_ms': statistics.median(times), 'ms': times, 'sum': total}

    # 4. the scratch budget on the two global-memory programs
    if args.scratch:
        sys.path.insert(1, str(HERE))
        import chip_smoke

        result['scratch'] = {}
        for label, comb, n in (('config 5', chip_smoke.config5_model('cpp'), 1 << 20),
                               ('wide conv', chip_smoke.wide_conv_front_end(), 2048)):  # fmt: skip
            prog = decode(comb.to_binary())
            ex = DaisExecutor(prog, mode='pallas', device='cuda')
            x = ex.int_inputs(np.random.default_rng(20261018).uniform(-8, 8, (n, prog.n_in)))
            result['scratch'][label] = scratch_scan(torch, ex, x, label, card)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
