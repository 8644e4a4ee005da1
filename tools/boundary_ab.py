#!/usr/bin/env python3
"""The call boundary's chunking measured on one NVIDIA GPU: how many chunks
a float batch should be cut into.

For each workload, a float64 batch goes through ``torch_backend.boundary_call``
(the call of ``DaisExecutor`` and ``PipelineExecutor``: the conversion on the
card, the executor's integer function, the int->float on the card) at
several chunk rules, in interleaved rounds, each output equal to the first
(host clock, the call's whole time):

- the port's rule (``CHUNK_BYTES``, ``CHUNK_MAX`` as they stand);
- the reference's rule, 1 MiB a chunk and at most 16 (``_infer_chunks`` in
  ``da4ml_tpu/runtime/jax_backend.py``);
- 4 and 8 chunks;
- one chunk.

Several chunks go up through pinned staging buffers on an upload stream and
come back on a download stream, chunk k+1's upload overlapping chunk k's
kernel; one chunk is one ``.to(device)`` and one ``.cpu()``.

Workloads: the flagship (2^20 samples), ``bench.py``'s pipeline model
(262144; its stages chained and its fused program), the fusion workloads
(2^16; chained and fused), the 256x256 conv front end (2048) and the
config-5 model (2^20), every executor K1 (``DA4ML_RUN_MODE=pallas``). Prints
one line per workload with each rule's median, least and most seconds and K1
launches.

Usage: ``python3 tools/boundary_ab.py`` from the repository root.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROUNDS = 6
#: (label, CHUNK_BYTES, CHUNK_MAX); None keeps the port's value
RULES = (
    ("the port's rule", None, None),
    ("the reference's rule (1 MiB, at most 16)", 1 << 20, 16),
    ('4 chunks', 1, 4),
    ('8 chunks', 1, 8),
    ('one chunk', 1 << 62, 1),
)


def card_line() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]  # fmt: skip


def ab(torch, tb, cuda_backend, card, label, first, last, fn, arr):
    kept = tb.CHUNK_BYTES, tb.CHUNK_MAX

    def call(budget, cap):
        tb.CHUNK_BYTES, tb.CHUNK_MAX = budget or kept[0], cap or kept[1]
        try:
            return tb.boundary_call(first, last, fn, arr, first.device), tb._infer_chunks(len(arr), 8 * arr.shape[1])
        finally:
            tb.CHUNK_BYTES, tb.CHUNK_MAX = kept

    want, _ = call(1 << 62, 1)
    times = {name: [] for name, *_ in RULES}
    launches, chunks = {}, {}
    for r in range(ROUNDS + 1):  # round 0 warms up
        for name, budget, cap in RULES:
            torch.cuda.synchronize()
            cuda_backend.reset_counts()
            t0 = time.perf_counter()
            y, chunks[name] = call(budget, cap)
            dt = time.perf_counter() - t0
            launches[name] = cuda_backend.launches
            assert np.array_equal(y, want), f'{label}: {name} differs from one chunk'
            if r:
                times[name].append(dt)
    parts = '; '.join(f'{name}: {chunks[name]} chunks, median {statistics.median(v):.4f} s (min {min(v):.4f}, max '
                      f'{max(v):.4f}), {launches[name]} K1 launches' for name, v in times.items())  # fmt: skip
    print(f'[{card}] {label}, {len(arr)} samples, {arr.nbytes / 2**20:.0f} MiB: {parts}; all equal', flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('boundary_ab: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from da4ml_tpu_torch.entry import flagship_comb

    # K1 is the subject: every executor built here, pipeline stages and the
    # fused program included, takes mode='pallas' for 'auto'
    os.environ.update(cs.PINNED_ENV)
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime import torch_backend as tb

    card = card_line()
    print(card, flush=True)

    def run(label, ex, first=None, last=None):
        ab(torch, tb, cuda_backend, card, label, first or ex, last or ex, ex.fn_int, DATA[label])

    DATA = {}
    prog = decode(flagship_comb(backend='cpp').to_binary())
    DATA['flagship'] = np.random.default_rng(20260729).uniform(-8, 8, (1 << 20, prog.n_in))
    run('flagship', tb.DaisExecutor(prog, mode='pallas'))
    pipes = {'pipeline model': cs.pipeline_model()}
    rng = np.random.default_rng(20261019)
    for name, p in cs.fusion_workloads(backend='cpp').items():
        pipes[name] = (p, rng.uniform(-4, 4, (1 << 16, p.shape[0])))
    for name, (p, d) in pipes.items():
        bins = [s.to_binary() for s in p.stages]
        pex = tb.PipelineExecutor([decode(b) for b in bins])
        DATA[f'{name}, stages chained'] = DATA[f"{name}, fused='ir'"] = d
        run(f'{name}, stages chained', pex, pex.stages[0], pex.stages[-1])
        run(f"{name}, fused='ir'", tb.fused_executor_for_binaries(bins))
    wprog = decode(cs.wide_conv_front_end().to_binary())
    DATA['wide conv'] = np.random.default_rng(20261020).uniform(-8, 8, (2048, wprog.n_in))
    run('wide conv', tb.DaisExecutor(wprog, mode='pallas'))
    del DATA['wide conv']
    cprog = decode(cs.config5_model('cpp').to_binary())
    DATA['config 5'] = np.random.default_rng(20261018).uniform(-8, 8, (1 << 20, cprog.n_in))
    run('config 5', tb.DaisExecutor(cprog, mode='pallas'))
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
