#!/usr/bin/env python3
"""Smoke run of da4ml_tpu_torch on one NVIDIA GPU.

Drives the port's main path end to end on the card and checks every kernel
on it against its plain PyTorch version:

1. card: prints ``nvidia-smi``'s name and power limit; builds the DAIS
   kernel (``da4ml_tpu_torch/csrc/dais_exec.cu``, nvcc, sm_90a) while the
   host solves the flagship;
2. host solve: traces the flagship MLP (16→32→32→5, 4-bit weights) through
   the port's tracer and CMVM solver into one DAIS program;
3. corpus: the kernel against its plain ``level`` version on the card, bit
   for bit (``torch.equal``), on a seeded synth corpus that covers all eleven
   opcode families and wide int64 programs, at batches of 33, 1000 and 131073
   rows; one program's buffer lies just under 48 KB of shared memory, and
   one int64 program is too wide for shared memory and takes the kernel's
   global-memory scratch path;
4. flagship: 2^20 numpy-seeded samples through ``DaisExecutor`` on the card
   (the kernel's launch count is reset just before and read just after) and
   through ``entry()``; the output must equal the plain version on the card
   and the port's reference interpreter on the host, bit for bit; then times
   the call's host stages, and the kernel and its plain version with CUDA
   events;
5. checks that neither jax nor da4ml_tpu was imported.

Prints the kernel table as one JSON line, the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
there is no CUDA device or any phase fails.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet / Hopper white paper) used
#: for the kernel's bound: HBM3 bandwidth, and int32 ALU issue = 132 SMs x
#: 64 INT32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: shared-memory bandwidth, 132 SMs x 128 B/clk x 1.98 GHz (reported beside
#: the bound: the kernel reads two operands and writes one result per op)
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9

FLAGSHIP_SAMPLES = 1 << 20
CORPUS_BATCHES = (33, 1000, 131073)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout  # fmt: skip
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``reps`` warm calls, each timed with CUDA events."""
    import torch

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
    return statistics.median(times)


def check_corpus(torch, DaisExecutor, cuda_backend, run_program) -> None:
    from da4ml_tpu_torch.ir.synth import FAMILIES, random_inputs, random_program

    rng = np.random.default_rng(20261016)
    corpus = [(f'family {f}', random_program(rng, n_ops=160, n_in=5, n_out=4, families=(f,))) for f in FAMILIES]
    corpus += [(f'mixed {k}', random_program(rng, n_ops=400, n_in=8, n_out=6)) for k in range(2)]
    corpus += [(f'wide {k}', random_program(rng, n_ops=400, n_in=8, n_out=6, wide=True)) for k in range(3)]
    # 90 int32 slots: a 46080-byte buffer at 128 threads, just under 48 KB,
    # which launches only with the shared-memory opt-in
    corpus.append(('smem 48K', random_program(np.random.default_rng(1), n_ops=340, n_in=8, n_out=6, n_levels=4)))
    # 1029 int64 slots: too wide for shared memory even at 32 samples, so the
    # kernel keeps its buffer in global memory, in chunks
    corpus.append(('global scratch', random_program(np.random.default_rng(1), n_ops=3200, n_in=8, n_out=6,
                                                    n_levels=3, wide=True)))  # fmt: skip
    assert sum(ex_prog.max_width + 2 > 31 for _, ex_prog in corpus) >= 2, 'corpus must hold two wide int64 programs'
    card = torch.device('cuda', 0)
    n_checked = 0
    for name, prog in corpus:
        ex = DaisExecutor(prog, device='cuda')
        threads, rows = ex.kernel.geometry(card)
        if name == 'smem 48K':
            smem = ex.kernel.n_slots * threads * ex.kernel.itemsize
            assert ex.dtype == torch.int32 and 48 * 1024 - 4096 < smem <= 48 * 1024 and rows is None, (smem, rows)
        assert (rows is not None) == (name == 'global scratch'), f'corpus {name}: {ex.kernel.n_slots} slots, rows {rows}'
        for batch in CORPUS_BATCHES:
            data = random_inputs(rng, prog, batch)
            x = ex.int_inputs(data)
            y_kernel = ex.kernel.launch(x)
            y_plain = ex.plain(x)
            torch.cuda.synchronize()
            if not torch.equal(y_kernel, y_plain):
                bad = int((y_kernel != y_plain).sum())
                raise AssertionError(f'corpus {name} batch {batch}: {bad} words differ')
            if batch == 1000:
                got = y_kernel.cpu().numpy().astype(np.float64) * ex._out_scale()
                if not np.array_equal(got, run_program(prog, data)):
                    raise AssertionError(f'corpus {name}: kernel disagrees with the reference interpreter')
            n_checked += 1
        path = f'global scratch, {rows} rows per chunk' if rows else 'shared memory'
        print(f'corpus {name}: {prog.n_ops} ops, {ex.dtype}, {ex.kernel.n_slots} slots, threads {threads}, {path}: equal',
              flush=True)  # fmt: skip
    assert cuda_backend.scratch_launches > 0, 'no corpus program took the global-memory path'
    print(f'corpus: {n_checked} (program, batch) cases bit-exact; scratch launches {cuda_backend.scratch_launches}')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from da4ml_tpu_torch.entry import entry, flagship_comb
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.reference import run_program
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    card = card_line()
    print(card, flush=True)

    # phase 1+2: nvcc builds the kernel while the host solves the flagship
    build_s: list[float] = []
    build_err: list[BaseException] = []

    def _build():
        t0 = time.perf_counter()
        try:
            cuda_backend.build()
        except BaseException as e:  # re-raised on the main thread below
            build_err.append(e)
        build_s.append(time.perf_counter() - t0)

    build_thread = threading.Thread(target=_build)
    build_thread.start()
    t0 = time.perf_counter()
    comb = flagship_comb(n_workers=os.cpu_count() or 1)
    solve_s = time.perf_counter() - t0
    build_thread.join()
    if build_err:
        raise build_err[0]
    print(f'build: {build_s[0]:.3f} s (nvcc, sm_90a)')
    for line in cuda_backend.build_log.splitlines():
        if 'Function properties' in line or 'registers' in line or 'spill' in line:
            print('  ptxas:', line.strip())
    prog = decode(comb.to_binary())
    print(f'solve: {solve_s:.3f} s host CMVM ({os.cpu_count()} workers); program {prog.n_ops} ops, cost {comb.cost}')

    # phase 3: corpus, kernel vs plain version on the card
    check_corpus(torch, DaisExecutor, cuda_backend, run_program)

    # phase 4: the main path at 2^20 samples
    data = np.random.default_rng(20260729).uniform(-8, 8, (FLAGSHIP_SAMPLES, prog.n_in))
    ex = DaisExecutor(prog)
    assert ex.device.type == 'cuda' and ex.dtype == torch.int32
    cuda_backend.reset_counts()
    t0 = time.perf_counter()
    y = ex(data)
    t1 = time.perf_counter()
    fn, (x_entry,) = entry()
    y_entry = fn(x_entry)
    torch.cuda.synchronize()
    call_s, entry_s = t1 - t0, time.perf_counter() - t1
    launches = cuda_backend.launches
    print(f'flagship: main path launched the DAIS kernel {launches} times ({cuda_backend.scratch_launches} scratch)')
    assert launches > 0, 'the main path never launched the DAIS kernel'
    assert y.shape == (FLAGSHIP_SAMPLES, prog.n_out) and np.isfinite(y).all()

    x = ex.int_inputs(data)
    y_plain = ex.plain(x)
    y_kernel = ex.fn_int(x)
    torch.cuda.synchronize()
    assert torch.equal(y_kernel, y_plain), 'flagship: kernel disagrees with its plain version on the card'
    max_abs_err = float((y_kernel.double() - y_plain.double()).abs().max())
    assert np.array_equal(y, y_plain.cpu().numpy().astype(np.float64) * ex._out_scale())
    chunk = 1 << 17
    ref = np.concatenate([run_program(prog, data[i : i + chunk]) for i in range(0, len(data), chunk)])
    assert np.array_equal(y, ref), 'flagship: kernel disagrees with the reference interpreter'
    assert torch.equal(y_entry, ex.plain(x_entry)), 'entry(): kernel disagrees with its plain version'
    print(f'flagship: {FLAGSHIP_SAMPLES} samples bit-exact vs plain (card) and reference (host)')

    # host clock of DaisExecutor.__call__ on 2^20 float samples, by stage
    t0 = time.perf_counter()
    x_host = torch.from_numpy(ex._int_inputs(data))
    t1 = time.perf_counter()
    x_card = x_host.to(ex.device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    y_card = ex.fn_int(x_card)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    y_host = y_card.cpu().numpy()
    t4 = time.perf_counter()
    y_host.astype(np.float64) * ex._out_scale()
    t5 = time.perf_counter()
    print(f'flagship call: {call_s:.4f} s (entry(): {entry_s:.4f} s, a new executor on 64 rows); again by stage: '
          f'float->int {t1 - t0:.4f} s, H2D {t2 - t1:.4f} s, kernel {t3 - t2:.4f} s, D2H {t4 - t3:.4f} s, '
          f'int->float {t5 - t4:.4f} s')  # fmt: skip

    ms = cuda_ms(lambda: ex.fn_int(x), reps=20)
    plain_ms = cuda_ms(lambda: ex.plain(x), reps=5)
    n_bytes, int_ops = ex.kernel.work(FLAGSHIP_SAMPLES)
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, int_ops / INT32_OPS_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')
    smem_ms = 3 * prog.n_ops * FLAGSHIP_SAMPLES * ex.kernel.itemsize / SMEM_BYTES_PER_S * 1e3
    threads = ex.kernel.geometry(x.device)[0]
    print(f'[{card}] dais_exec: {ms:.4f} ms for {FLAGSHIP_SAMPLES} samples ({FLAGSHIP_SAMPLES / ms * 1e3:.4g} samples/s), '
          f'{prog.n_ops} ops, {ex.kernel.n_slots} slots, {threads} threads/block')  # fmt: skip
    print(f'[{card}] plain level version: {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} '
          f'(int ALU {ops_ms:.4f} ms for {ex.kernel.int_ops_per_sample} operations per sample, HBM {bytes_ms:.4f} ms; '
          f'shared-memory traffic {smem_ms:.4f} ms)')  # fmt: skip
    print(f'[{card}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')

    # phase 5: the port imported nothing of JAX
    assert 'jax' not in sys.modules and 'da4ml_tpu' not in sys.modules, 'jax or da4ml_tpu was imported'

    kernels = [
        {
            'name': 'dais_exec',
            'route': 'cuda',
            'source': 'da4ml_tpu_torch/csrc/dais_exec.cu',
            'replaces': 'da4ml_tpu/runtime/pallas_backend.py:480',
            'launches': launches,
            'max_abs_err': max_abs_err,
            'ms': ms,
            'plain_ms': plain_ms,
            'bound_ms': bound_ms,
            'bound_by': bound_by,
            'library_ms': None,
        }
    ]
    print(json.dumps({'kernels': kernels}))
    print(card)
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': torch.cuda.device_count()}
    print(json.dumps({'ok': True, 'device': device}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
