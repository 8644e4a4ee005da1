#!/usr/bin/env python3
"""Smoke run of da4ml_tpu_torch on one NVIDIA GPU.

Drives the port's main paths end to end on the card and checks every kernel
on them against its plain PyTorch version:

1. card: prints ``nvidia-smi``'s name and power limit; nvcc builds the DAIS
   kernel K1 (``csrc/dais_exec.cu``), the greedy-CSE kernel K2
   (``csrc/fused_cse.cu``) and K2's phase-timing build, sm_90a, one nvcc
   each, all started together; prints ptxas' report of K1 and K2;
2. host solve: traces the flagship MLP (16→32→32→5, 4-bit weights) through
   the port's tracer and host CMVM solver into one DAIS program (timed on
   its own);
3. K1 corpus: the DAIS kernel against its plain ``level`` version on the
   card, bit for bit (``torch.equal``), on a seeded synth corpus that covers
   all eleven opcode families and wide int64 programs, at batches of 33,
   1000 and 131073 rows; one program's block takes more than 48 KB of shared
   memory, one runs two tiles a block, and one int64 program takes the
   global-memory scratch path; prints each program's slots, phases, tiles per
   block, warps per tile, record bytes, the occupancy API's resident warps
   per SM, buffer path, and ptxas' registers and spills of the instantiation
   it runs;
4. device search (K2's main path): ``flagship_comb(backend='torch')`` traces
   and solves the flagship with the device CMVM search on the card (K2's
   launch count is reset just before and read just after; every rung call is
   recorded; the wall time has no stage timer inside); no lane may go to the
   host, ``torch_search.init_cache`` must not run (K2 builds the score cache
   itself), and the program must be byte-identical to the host-solved one;
   a second run of the same search times the rung calls by stage (upload,
   K2, fetch) and the host side by stage (tracing, decomposition, emission);
5. flagship execution (K1's main path): 2^20 numpy-seeded samples through
   ``DaisExecutor`` on the device-solved program (K1's count reset just
   before, read just after) and through ``entry()``; the output must equal
   the plain version on the card and the reference interpreter on the host;
   prints its launch shape as for the corpus (at least 24 resident warps per
   SM); times the call's host stages, and K1 and its plain version; times K1
   again with other phase sizes (one phase per level among them) and warps
   per tile, each held to the plain version;
6. K2 corpus: every recorded flagship rung, and seeded random trit lanes
   (i == j chains, methods 0-5, adder/carry sizes unset and set, a padding
   lane, K = 16 classes at P = 512, 1024 and 2048, the last too large for
   shared memory, so its slices take the global placement), through K2 and
   through its plain version on the card, both from the same cache-less
   inputs: all five outputs equal (``torch.equal``); prints each class's
   cluster geometry, occupancy and ptxas report; times K2 and the plain
   version per rung with CUDA events, K2's phases (clock cycles of its
   phase-timing build) on every flagship rung, and the fixed cost of a
   launch whose lanes all enter at ``cur == P`` (on the card, and the host
   time of its foreign call), and counts K2's
   bound from the iterations each rung recorded (the kernel line sums the
   flagship's rungs);
7. wider layers: the four six-bit layers of ``bench.py`` (16×64, 64×32,
   32×32, 32×5) solved with ``solve_torch_many`` on the card, held to
   ``Pipeline.kernel == kernel``;
8. checks that neither jax nor da4ml_tpu was imported.

Prints the kernel table as one JSON line, the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
there is no CUDA device or any phase fails.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet / Hopper white paper) used
#: for the kernels' bounds: HBM3 bandwidth; int32 ALU issue = 132 SMs x
#: 64 INT32 lanes x 1.98 GHz boost clock; fp32 issue = 132 SMs x 128 FP32
#: lanes x 1.98 GHz (the data sheet's 67 TFLOP/s counts an FMA as two)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9
#: shared-memory bandwidth, 132 SMs x 128 B/clk x 1.98 GHz (reported beside
#: the bound: the kernel reads two operands and writes one result per op)
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9

FLAGSHIP_SAMPLES = 1 << 20
CORPUS_BATCHES = (33, 1000, 131073)
#: the wider JEDI-MLP layers of bench.py (section 2_jedi_mlp_layers), six-bit
WIDE_LAYERS = ((16, 64), (64, 32), (32, 32), (32, 5))


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout  # fmt: skip
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, fresh=None) -> float:
    """Median milliseconds of ``reps`` calls, each timed with CUDA events,
    after one untimed warm call. ``fresh()``, when given, makes each call's
    arguments outside the timed span (for a function that updates them in
    place)."""
    import torch

    fn(*(fresh() if fresh else ()))
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        args = fresh() if fresh else ()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def print_ptxas(log: str) -> None:
    for line in log.splitlines():
        if 'Function properties' in line or 'registers' in line or 'spill' in line:
            print('  ptxas:', line.strip())


def k2_ptxas(log: str) -> dict[tuple[int, bool], tuple[int, int]]:
    """ptxas' (registers, stack frame bytes) of each K2 instantiation, keyed
    by (K, global placement)."""
    out, key, stack = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r'fused_cse_kernelILi(\d+)ELb([01])E', line):
            key = (int(m[1]), m[2] == '1')
        elif (m := re.search(r'(\d+) bytes stack frame', line)) and key:
            stack = int(m[1])
        elif (m := re.search(r'Used (\d+) registers', line)) and key:
            out[key], key = (int(m[1]), stack), None
    return out


def k1_ptxas(log: str) -> dict[tuple[int, bool], dict[str, int]]:
    """ptxas' registers, spill stores and loads and stack frame of each K1
    instantiation, keyed by (itemsize, global-memory buffer)."""
    out, key, info = {}, None, {}
    for line in log.splitlines():
        if m := re.search(r'dais_exec_kernelI([il])Lb([01])E', line):
            key, info = (4 if m[1] == 'i' else 8, m[2] == '1'), {}
        elif (m := re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads', line)) and key:
            info = {'stack': int(m[1]), 'spill_stores': int(m[2]), 'spill_loads': int(m[3])}
        elif (m := re.search(r'Used (\d+) registers', line)) and key:
            out[key], key = {'registers': int(m[1]), **info}, None
    return out


def k1_shape(torch, ex, ptxas) -> tuple[str, dict]:
    """K1's launch shape for one program on card 0, as one line and a dict:
    slots, phases, tiles per block, warps per tile (G), record bytes, resident
    warps per SM (the occupancy API), buffer path, ptxas' report of the
    instantiation it runs."""
    card = torch.device('cuda', 0)
    k = ex.kernel
    g = k.geometry(card)
    path = f'global scratch, {g.scratch_rows} rows a launch' if g.scratch_rows else 'shared memory'
    shape = {'slots': k.n_slots, 'phases': len(k.phases), 'tiles': g.tiles, 'warps': g.warps,
             'record_bytes': k.records.dtype.itemsize, 'resident_warps': k.occupancy(card), 'smem': g.smem,
             'global': g.scratch_rows is not None, **ptxas[k.itemsize, g.scratch_rows is not None]}  # fmt: skip
    line = (f"{k.n_ops} ops, {ex.dtype}, {shape['slots']} slots, {shape['phases']} phases, {g.tiles} tiles x "
            f"{g.warps} warps a block, {shape['record_bytes']}-byte records, {g.smem} B shared memory a block, "
            f"{shape['resident_warps']} resident warps per SM (occupancy API), {path}; ptxas {shape['registers']} "
            f"registers, {shape['spill_stores']}/{shape['spill_loads']} B spill stores/loads")  # fmt: skip
    return line, shape


def check_corpus(torch, DaisExecutor, cuda_backend, run_program, ptxas) -> None:
    from da4ml_tpu_torch.ir.synth import FAMILIES, random_inputs, random_program

    rng = np.random.default_rng(20261016)
    corpus = [(f'family {f}', random_program(rng, n_ops=160, n_in=5, n_out=4, families=(f,))) for f in FAMILIES]
    corpus += [(f'mixed {k}', random_program(rng, n_ops=400, n_in=8, n_out=6)) for k in range(2)]
    corpus += [(f'wide {k}', random_program(rng, n_ops=400, n_in=8, n_out=6, wide=True)) for k in range(3)]
    # 482 int32 slots: a block of 67568 bytes of shared memory, over 48 KB,
    # which launches only with the dynamic-size opt-in
    corpus.append(('smem over 48K', random_program(np.random.default_rng(1), n_ops=1500, n_in=8, n_out=6, n_levels=5)))
    # phases of at most 2 ops: one warp a tile, two tiles a block, each warp on
    # its own named barrier
    corpus.append(('two tiles a block', random_program(np.random.default_rng(0), n_ops=20, n_in=2, n_out=2,
                                                       n_levels=18)))  # fmt: skip
    # about a thousand int64 slots: a tile too wide for shared memory, so the
    # kernel keeps its buffers in global memory, in chunks
    corpus.append(('global scratch', random_program(np.random.default_rng(1), n_ops=3200, n_in=8, n_out=6,
                                                    n_levels=3, wide=True)))  # fmt: skip
    assert sum(ex_prog.max_width + 2 > 31 for _, ex_prog in corpus) >= 2, 'corpus must hold two wide int64 programs'
    n_checked = 0
    for name, prog in corpus:
        ex = DaisExecutor(prog, device='cuda')
        line, shape = k1_shape(torch, ex, ptxas)
        if name == 'smem over 48K':
            assert ex.dtype == torch.int32 and shape['smem'] > 48 * 1024 and not shape['global'], shape
        assert shape['global'] == (name == 'global scratch'), f'corpus {name}: {shape}'
        assert (shape['tiles'] > 1) == (name == 'two tiles a block'), f'corpus {name}: {shape}'
        assert shape['resident_warps'] > 0, f'corpus {name}: the kernel cannot launch ({shape})'
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
        print(f'corpus {name}: {line}: equal', flush=True)
    assert cuda_backend.scratch_launches > 0, 'no corpus program took the global-memory path'
    print(f'corpus: {n_checked} (program, batch) cases bit-exact; scratch launches {cuda_backend.scratch_launches}')


#: K1's phase sizes and warps per tile timed beside the kept pair
#: (``cuda_backend.PHASE_OPS``, ``MAX_WARPS``): a phase per level, shorter
#: phases, fewer and more warps
K1_ALTERNATIVES = ((10**9, 6), (64, 6), (128, 6), (192, 4), (192, 8))


def k1_scheme_scan(torch, prog, x, y_plain, ptxas, card: str) -> None:
    """K1 on the flagship with the host's phase size (``PHASE_OPS``) and
    warps per tile (``MAX_WARPS``) at the kept pair and each of
    ``K1_ALTERNATIVES``: the same kernel build, other phases, slots and launch
    shape. Each must equal the plain version; prints slots, phases, the
    launch shape and ms, in turns (each pair timed twice, the order reversed
    the second time)."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    schemes = ((cuda_backend.PHASE_OPS, cuda_backend.MAX_WARPS), *K1_ALTERNATIVES)
    runs = {}
    for phase_ops, warps in schemes:
        consts = {(cuda_backend, 'PHASE_OPS'): lambda _, v=phase_ops: v, (cuda_backend, 'MAX_WARPS'): lambda _, v=warps: v}
        with Patched(consts):
            ex = DaisExecutor(prog)
            assert torch.equal(ex.kernel.launch(x), y_plain), f'K1 with {phase_ops}-op phases, {warps} warps'
            runs[phase_ops, warps] = (ex, consts, k1_shape(torch, ex, ptxas)[1], [])
    for order in (schemes, schemes[::-1]):
        for key in order:
            ex, consts, _, times = runs[key]
            with Patched(consts):
                times.append(cuda_ms(lambda: ex.kernel.launch(x), reps=10))
    for (phase_ops, warps), (ex, _, shape, times) in runs.items():
        label = 'a phase per level' if phase_ops >= 10**9 else f'phases of at most {phase_ops} ops'
        print(f"[{card}] K1 scheme, {label}, {warps} warps a tile: {shape['slots']} slots, {shape['phases']} phases, "
              f"{shape['tiles']} x {shape['warps']} warps a block, {shape['resident_warps']} resident warps per SM: "
              f"{', '.join(f'{t:.4f}' for t in times)} ms, equal")  # fmt: skip


def run_dais_flagship(torch, prog, card: str, ptxas) -> dict:
    """K1's main path: the flagship program on 2^20 samples, checked and timed."""
    from da4ml_tpu_torch.entry import entry
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.reference import run_program
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

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

    line, shape = k1_shape(torch, ex, ptxas)
    print(f'[{card}] flagship dais_exec: {line}')
    assert shape['resident_warps'] >= 24, f'flagship: {shape["resident_warps"]} resident warps per SM, want 24'
    compact = {cuda_backend.LOWERINGS[f] for f in cuda_backend.COMPACT}
    assert shape['record_bytes'] <= 16 and set(ex.kernel.fam.tolist()) <= compact, 'flagship records need the pool'
    ms = cuda_ms(lambda: ex.fn_int(x), reps=20)
    plain_ms = cuda_ms(lambda: ex.plain(x), reps=5)
    n_bytes, int_ops = ex.kernel.work(FLAGSHIP_SAMPLES)
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, int_ops / INT32_OPS_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')
    smem_ms = 3 * prog.n_ops * FLAGSHIP_SAMPLES * ex.kernel.itemsize / SMEM_BYTES_PER_S * 1e3
    print(f'[{card}] dais_exec: {ms:.4f} ms for {FLAGSHIP_SAMPLES} samples ({FLAGSHIP_SAMPLES / ms * 1e3:.4g} samples/s), '
          f'{prog.n_ops} ops, {ex.kernel.n_slots} slots, {len(ex.kernel.phases)} phases')  # fmt: skip
    print(f'[{card}] plain level version: {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} '
          f'(int ALU {ops_ms:.4f} ms for {ex.kernel.int_ops_per_sample} operations per sample, HBM {bytes_ms:.4f} ms; '
          f'shared-memory traffic {smem_ms:.4f} ms)')  # fmt: skip
    print(f'[{card}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    k1_scheme_scan(torch, prog, x, y_plain, ptxas, card)
    return {
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


# ---------------------------------------------------------------------------
# K2: rungs of the device search
# ---------------------------------------------------------------------------


class Patched:
    """Replaces functions of modules while active: ``{(module, name): make}``,
    where ``make(real)`` returns the replacement of ``module.name``."""

    def __init__(self, makers):
        self.makers, self.saved = makers, {}

    def __enter__(self):
        for (mod, name), make in self.makers.items():
            self.saved[mod, name] = getattr(mod, name)
            setattr(mod, name, make(self.saved[mod, name]))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def timed(seconds: dict, key: str, sync: bool = False):
    """A maker for :class:`Patched`: the function, its host seconds added to
    ``seconds[key]`` (ended by a device synchronize when ``sync``)."""

    def make(real):
        def fn(*args, **kw):
            import torch

            t0 = time.perf_counter()
            out = real(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            seconds[key] += time.perf_counter() - t0
            return out

        return fn

    return make


class RungRecorder(Patched):
    """Records every ``torch_search.cse_rung`` call of a solve (inputs, spec)
    and counts the calls of ``torch_search.init_cache`` meanwhile (on the card
    K2 builds the score cache itself). With ``stages``, also times the rung
    calls by stage on the host clock, each stage ended by a device
    synchronize: ``upload`` (``rung_inputs``), ``K2``
    (``fused_cse.greedy_loop``: the wrapper's checks and the launch) and
    ``fetch`` (the five outputs to the host). The stage timers add
    synchronizes and fetches of their own, so a run with them is not the one
    whose wall time is reported."""

    def __init__(self, ts, fused_cse, stages: bool = False):
        self.calls, self.init_cache_calls, self.stages = [], 0, stages
        self.seconds = dict.fromkeys(('upload', 'K2', 'fetch'), 0.0)
        makers = {(ts, 'cse_rung'): self._record, (ts, 'init_cache'): self._count_init_cache}
        if stages:
            makers[ts, 'rung_inputs'] = timed(self.seconds, 'upload', sync=True)
            makers[fused_cse, 'greedy_loop'] = timed(self.seconds, 'K2', sync=True)
        super().__init__(makers)

    def _record(self, real):
        def cse_rung(E0, qmeta0, lat0, cur0, method, spec, device=None):
            self.calls.append(((E0, qmeta0, lat0, cur0, method), spec))
            out = real(E0, qmeta0, lat0, cur0, method, spec, device)
            if self.stages:
                t0 = time.perf_counter()
                out = tuple(t.cpu() for t in out)
                self.seconds['fetch'] += time.perf_counter() - t0
            return out

        return cse_rung

    def _count_init_cache(self, real):
        def init_cache(*args, **kw):
            self.init_cache_calls += 1
            return real(*args, **kw)

        return init_cache

    @property
    def total(self) -> float:
        return sum(self.seconds.values())


def host_clock(ts) -> tuple[Patched, dict]:
    """Times the device search's host side: ``solve`` (all of
    ``solve_torch_many``), ``decomposition`` (kernel decomposition and each
    lane's CSD) and ``emission`` (each lane's state from its op records, and
    its adder tree)."""
    seconds = dict.fromkeys(('solve', 'decomposition', 'emission'), 0.0)
    stages = {'solve_torch_many': 'solve', 'kernel_decompose': 'decomposition', '_prepare_lane': 'decomposition',
              '_host_state_from': 'emission', 'to_solution': 'emission'}  # fmt: skip
    return Patched({(ts, name): timed(seconds, key) for name, key in stages.items()}), seconds


def rung_work(ts, inputs, rec, cur, spec) -> dict[str, int]:
    """Bytes, and int32 and fp32 operations of the cache build and of the
    loop, that one rung needs for this run's data.

    Bytes: every input read once and every output written once; the score
    cache is built and kept on chip and moves none. Operations count only
    live slots (rows holding a nonzero digit; a check against an all-zero row
    finds nothing, and its candidates are invalid), L of them at a time.
    Cache build, per lane that runs: int32, every live row's nonzero digit at
    bit b meets each live slot once per shift that exists for it with the row
    first (B - b checks); fp32, one score and one top-K compare for each of
    the 2B·L·L candidates. Loop, per recorded iteration, over its d distinct
    dirty rows {i, j, cur} (two for an i == j chain), replayed from the
    iteration's record: int32, the exact recount, where a nonzero digit at
    bit b meets each live slot once per shift that exists for it in each
    operand order (B - b row first, b + 1 slot first), the shift-0 product
    the same in both orders: B checks; fp32, the argmax over the 2B·L cache
    heads, the scores of each dirty row's 2·(2B - 1)·L refreshed candidates
    (at shift 0 only one operand order is a candidate), one compare per
    refreshed column in the merge of each of the 2B·L cache rows (d·2B·L),
    one pass over each of the d·2B rebuilt rows of L scores.
    """
    import torch

    E0, _, _, cur0, _ = (np.asarray(x) for x in inputs)
    N, P, O, B = E0.shape
    TB = 2 * B
    work = {'bytes': 2 * (N * P * O * B + 16 * N * P) + 12 * N + 16 * N * spec.n_iters,
            'int_build': 0, 'fp_build': 0, 'int_loop': 0, 'fp_loop': 0}  # fmt: skip
    lane = torch.zeros(1, dtype=torch.int64)
    for n in range(N):
        if cur0[n] >= P:  # a padding or frozen lane does nothing
            continue
        E = torch.from_numpy(E0[n : n + 1].copy())
        live = int(E[0].ne(0).any(-1).any(-1).sum())
        bits = torch.nonzero(E[0])[:, 2]
        work['int_build'] += live * int((B - bits).sum())
        work['fp_build'] += 2 * TB * live * live
        for t in range(int(cur[n]) - int(cur0[n])):
            id0, id1, sub, shift = (int(v) for v in rec[n, t])
            i, j, s = (id0, id1, shift) if shift >= 0 else (id1, id0, -shift)
            c = int(cur0[n]) + t
            args = (torch.tensor([v]) for v in (sub, s, i, j))
            E[0, c] = ts._dev_substitute(E, lane, *args, B)[0]  # the search's own substitution
            live = int(E[0].ne(0).any(-1).any(-1).sum())
            dirty = sorted({i, j, c})
            work['int_loop'] += B * live * int((E[0, dirty] != 0).sum())
            work['fp_loop'] += TB * live + len(dirty) * (2 * (TB - 1) * live + TB * live + TB * live)
    return work


def random_rung(rng, P: int, O: int, B: int, n_rows: int, N: int = 7):
    """Seeded random trit lanes of one rung class: methods 0-5 and a padding
    lane (cur0 = P); lane 0's first row is a run of equal digits, which the
    search matches as an i == j chain."""
    E = np.zeros((N, P, O, B), np.int8)
    E[:, :n_rows] = rng.choice([-1, 0, 0, 1], size=(N, n_rows, O, B)).astype(np.int8)
    E[0, 0] = 1
    q = np.zeros((N, P, 3), np.float32)
    q[:, :, 2] = 1.0
    st = 2.0 ** -rng.integers(0, 3, (N, n_rows))
    q[:, :n_rows, 0] = -rng.integers(0, 64, (N, n_rows)) * st
    q[:, :n_rows, 1] = rng.integers(1, 64, (N, n_rows)) * st
    q[:, :n_rows, 2] = st
    lat = np.zeros((N, P), np.float32)
    lat[:, :n_rows] = rng.integers(0, 3, (N, n_rows))
    cur = np.full(N, n_rows, np.int32)
    cur[-1] = P
    return E, q, lat, cur, (np.arange(N) % 6).astype(np.int32)


def k2_geometry(torch, fused_cse, P: int, O: int, B: int, K: int, ptxas) -> dict:
    """K2's launch shape for a rung class on card 0: cluster size, block
    size, placement, shared memory per block (the slice when it lives there,
    and the static arrays), clusters the card holds at once, and ptxas'
    registers and stack frame of the instantiation it runs."""
    card = torch.device('cuda', 0)
    C, threads, placement = fused_cse.cluster_geometry(P, O, B, K, fused_cse.device_smem(card))
    slice_bytes = fused_cse.slice_layout(P, O, B, K, C)['bytes']
    dyn = slice_bytes if placement == 'shared' else 0
    regs, stack = ptxas.get((K, placement == 'global'), (None, None))
    return {'C': C, 'threads': threads, 'placement': placement, 'slice_bytes': slice_bytes, 'dynamic_smem': dyn,
            'active_clusters': fused_cse.active_clusters(card, K, placement, C, threads, dyn), 'registers': regs,
            'stack': stack}  # fmt: skip


def check_rung(torch, ts, fused_cse, inputs, spec, name: str, phases: bool = False) -> dict:
    """One rung through K2 and through its plain version on the card, both
    from the same cache-less inputs: all five outputs must be equal. Also
    K2's and the plain version's milliseconds (CUDA events; K2's launch
    alone, its wrapper's checks and allocations made before the span), the
    rung's work for its bound, and with ``phases`` the clock cycles of K2's
    phases from its phase-timing build."""
    dev_in = ts.rung_inputs(*inputs, spec, device='cuda')

    def fresh():  # both update the state in place
        return [t.clone() for t in dev_in]

    got = fused_cse.launch(*fresh(), spec)
    want = ts.rung_plain(*fresh(), spec)
    torch.cuda.synchronize()
    for field, g, w in zip(('E', 'qmeta', 'lat', 'records', 'cur'), got, want):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f'K2 rung {name}: {field} differs from the plain version at {bad}')
    rec, cur = got[3].cpu().numpy(), got[4].cpu().numpy()
    done = cur - dev_in[3].cpu().numpy()  # iterations per lane
    out = {
        'name': name, 'N': len(cur), 'P': spec.P, 'O': spec.O, 'B': spec.B, 'K': spec.topk, 'iters': int(done.sum()),
        'max_iters': int(done.max()), 'chains': sum(int((rec[n, :k, 0] == rec[n, :k, 1]).sum()) for n, k in enumerate(done)),
        'max_abs_err': max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want) if g.numel()),
    }  # fmt: skip
    out['ms'] = cuda_ms(fused_cse.run, reps=5, fresh=lambda: [fused_cse.prepare(*fresh(), spec)])
    out['plain_ms'] = cuda_ms(lambda *a: ts.rung_plain(*a, spec), reps=3, fresh=fresh)
    if phases:
        out['phases'] = fused_cse.phase_cycles(*fresh(), spec)
    work = rung_work(ts, inputs, rec, cur, spec)
    out['bytes_ms'] = work['bytes'] / HBM_BYTES_PER_S * 1e3
    for part in ('build', 'loop'):
        out[f'int_{part}_ms'] = work[f'int_{part}'] / INT32_OPS_PER_S * 1e3
        out[f'fp_{part}_ms'] = work[f'fp_{part}'] / FP32_OPS_PER_S * 1e3
    out['int_ms'] = out['int_build_ms'] + out['int_loop_ms']
    out['fp_ms'] = out['fp_build_ms'] + out['fp_loop_ms']
    # the int32 and fp32 pipes issue side by side: the least time is the larger
    out['ops_ms'] = max(out['int_ms'], out['fp_ms'])
    return out


def k2_empty_launch_ms(torch, ts, fused_cse, inputs, spec) -> float:
    """CUDA-event milliseconds of a K2 launch whose lanes all enter at
    cur == P, so every cluster leaves at once: the fixed cost of a launch
    (the wrapper's foreign call and the cluster launch)."""
    dev_in = ts.rung_inputs(*inputs, spec, device='cuda')
    dev_in[3].fill_(spec.P)
    return cuda_ms(fused_cse.run, reps=20, fresh=lambda: [fused_cse.prepare(*[t.clone() for t in dev_in], spec)])


def k2_launch_host_us(torch, ts, fused_cse, inputs, spec, reps: int = 100) -> float:
    """Host microseconds of one ``fused_cse.run`` call (the launch's foreign
    call), the mean of ``reps`` back-to-back calls whose lanes all enter at
    cur == P, so the card never holds the host back."""
    dev_in = ts.rung_inputs(*inputs, spec, device='cuda')
    dev_in[3].fill_(spec.P)
    prep = fused_cse.prepare(*dev_in, spec)
    fused_cse.run(prep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fused_cse.run(prep)
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def phase_line(ph: dict) -> str:
    """K2's phase cycles (``fused_cse.phase_cycles``) as one line: the cache
    build's cycles, then each phase's cycles per iteration and its share."""
    ph = dict(ph)
    it = max(ph.pop('iterations'), 1)
    build = ph.pop('cache build')
    loop = sum(ph.values())
    parts = ', '.join(f'{k} {v / it:.0f} ({v / max(loop, 1):.1%})' for k, v in ph.items())
    return f'cache build {build} cycles; {it} iterations of {loop / it:.0f} cycles: {parts}'


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from da4ml_tpu_torch.cmvm import fused_cse, solve_torch_many
    from da4ml_tpu_torch.cmvm import torch_search as ts
    from da4ml_tpu_torch.entry import flagship_comb
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.reference import run_program
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    card = card_line()
    print(card, flush=True)

    # phase 1: nvcc builds K1, K2 and K2's phase-timing build, one process
    # each, all started together; phase 2: then the host solves the flagship
    # (timed alone: the builds would share its cores)
    builds: dict[str, float] = {}
    build_err: list[BaseException] = []

    def _build(name, build):
        t0 = time.perf_counter()
        try:
            build()
        except BaseException as e:  # re-raised on the main thread below
            build_err.append(e)
        builds[name] = time.perf_counter() - t0

    jobs = (('dais_exec', cuda_backend.build), ('fused_cse', fused_cse.build), ('fused_cse phases', fused_cse.build_phases))
    threads = [threading.Thread(target=_build, args=a) for a in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if build_err:
        raise build_err[0]
    for name, log in (('dais_exec', cuda_backend.build_log), ('fused_cse', fused_cse.build_log)):
        print(f'build {name}: {builds[name]:.3f} s (nvcc, sm_90a)')
        print_ptxas(log)
    k1_regs = k1_ptxas(cuda_backend.build_log)
    assert len(k1_regs) == 4, f'ptxas reported K1 instantiations {sorted(k1_regs)}'
    for (itemsize, glob), info in sorted(k1_regs.items()):
        print(f'K1 int{8 * itemsize} {"global" if glob else "shared"}-memory instantiation: {info}')
        assert glob or info['spill_stores'] == info['spill_loads'] == 0, f'K1 int{8 * itemsize} spills: {info}'
    print(f"build fused_cse phases: {builds['fused_cse phases']:.3f} s (nvcc, sm_90a, -DFUSED_CSE_PHASES)")
    k2_regs = k2_ptxas(fused_cse.build_log)
    assert len(k2_regs) == 2 * len(fused_cse.CACHE_DEPTHS), f'ptxas reported K2 instantiations {sorted(k2_regs)}'
    t0 = time.perf_counter()
    comb = flagship_comb(n_workers=os.cpu_count() or 1)
    solve_s = time.perf_counter() - t0
    print(f'solve: {solve_s:.3f} s host CMVM ({os.cpu_count()} workers); cost {comb.cost}', flush=True)

    # phase 3: K1 corpus, kernel vs plain version on the card
    check_corpus(torch, DaisExecutor, cuda_backend, run_program, k1_regs)

    # phase 4: K2's main path — the flagship through the device search, its
    # wall time on the host clock with no stage timer inside
    pmax0 = ts.search_stats['pmax_host_fallbacks']
    with RungRecorder(ts, fused_cse) as flag_rungs:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        comb_dev = flagship_comb(backend='torch')
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        k2_launches = fused_cse.launches
    pmax_routes = ts.search_stats['pmax_host_fallbacks'] - pmax0
    classes = sorted({(s.P, s.O, s.B, s.topk, s.R_in) for _, s in flag_rungs.calls})
    print(f'device search: flagship solved in {dev_s:.3f} s on the card (host solve {solve_s:.3f} s); '
          f'{len(flag_rungs.calls)} rung calls in {len(classes)} classes (P, O, B, K, R_in) {classes}; K2 launched '
          f'{k2_launches} times; init_cache calls {flag_rungs.init_cache_calls}; PMAX host routes {pmax_routes}',
          flush=True)  # fmt: skip
    assert k2_launches == len(flag_rungs.calls) > 0, 'K2 must launch once per rung call of the device search'
    assert flag_rungs.init_cache_calls == 0, 'the device search built a score cache outside K2'
    assert pmax_routes == 0, f'{pmax_routes} flagship lanes went to the host solver'
    assert np.array_equal(comb_dev.to_binary(), comb.to_binary()), 'device-solved flagship differs from the host-solved'
    prog = decode(comb_dev.to_binary())
    print(f'device search: program byte-identical to the host solve ({prog.n_ops} ops, cost {comb_dev.cost})')
    # the same search again (device='cuda' is its own cache key, so it traces
    # anew), every stage timed: rung calls by stage, and the host side
    clock, host_s = host_clock(ts)
    with RungRecorder(ts, fused_cse, stages=True) as staged, clock:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        comb_staged = flagship_comb(backend='torch', device='cuda')
        torch.cuda.synchronize()
        staged_s = time.perf_counter() - t0
    assert fused_cse.launches == len(staged.calls) == len(flag_rungs.calls) and staged.init_cache_calls == 0
    assert np.array_equal(comb_staged.to_binary(), comb.to_binary()), 'the staged device search differs'
    rung_s = staged.total
    stages = ', '.join(f'{k} {v:.4f} s' for k, v in staged.seconds.items())
    other_s = host_s['solve'] - rung_s - host_s['decomposition'] - host_s['emission']
    print(f'device search by stage (a second run, {staged_s:.3f} s, the timers synchronizing the device): rung calls '
          f'{rung_s:.4f} s ({stages}); host: tracing {staged_s - host_s["solve"]:.4f} s, decomposition '
          f'{host_s["decomposition"]:.4f} s, emission {host_s["emission"]:.4f} s, rung ladder and argmin {other_s:.4f} s',
          flush=True)  # fmt: skip

    # phase 5: K1's main path at 2^20 samples, on the device-solved program
    dais = run_dais_flagship(torch, prog, card, k1_regs)

    # phase 6: K2 corpus — the flagship's rungs (timed, phases of each) and
    # random trit lanes
    rows = [check_rung(torch, ts, fused_cse, inp, spec, f'flagship {k}', phases=True)
            for k, (inp, spec) in enumerate(flag_rungs.calls)]  # fmt: skip
    rng = np.random.default_rng(20261016)
    # the last class's slices (P = 2048 over a cluster of 16) exceed the 227 KB
    # of shared memory a block can have, so K2 keeps them in global memory
    synth = [(64, 8, 4, -1, -1, 16), (128, 32, 6, 3, 8, 32), (256, 32, 6, -1, -1, 32), (256, 8, 2, 2, -1, 128),
             (512, 8, 4, -1, -1, 64), (1024, 64, 4, -1, -1, 16), (2048, 8, 4, -1, -1, 16)]  # fmt: skip
    for P, O, B, adder, carry, n_rows in synth:
        spec = ts._KernelSpec(P, O, B, adder, carry, R_in=n_rows, topk=8 if P <= 256 else 16)
        rows.append(check_rung(torch, ts, fused_cse, random_rung(rng, P, O, B, n_rows), spec,
                               f'random P{P} O{O} B{B} a{adder} c{carry}', phases=P == 2048))  # fmt: skip
    shapes = {}
    for r in rows:
        key = (r['P'], r['O'], r['B'], r['K'])
        if key not in shapes:
            shapes[key] = g = k2_geometry(torch, fused_cse, *key, k2_regs)
            print(f"K2 class P {key[0]} O {key[1]} B {key[2]} K {key[3]}: cluster {g['C']} x {g['threads']} threads, "
                  f"{g['placement']} slice {g['slice_bytes']} B, dynamic shared memory {g['dynamic_smem']} B per block, "
                  f"{g['active_clusters']} clusters at once; {g['registers']} registers, "
                  f"{g['stack']} B stack frame")  # fmt: skip
            assert g['active_clusters'] > 0, key
        r['placement'] = shapes[key]['placement']
    for r in rows:
        print(f"K2 rung {r['name']}: N {r['N']} P {r['P']} O {r['O']} B {r['B']} K {r['K']}, {r['iters']} iterations "
              f"(at most {r['max_iters']} a lane), {r['chains']} i == j chains: equal, K2 {r['ms']:.4f} ms "
              f"({r['ms'] * 1e3 / max(r['max_iters'], 1):.2f} us per iteration of its longest lane), "
              f"plain {r['plain_ms']:.2f} ms")  # fmt: skip
        if 'phases' in r:
            print(f"  [{card}] K2 phases, lane 0, clock64 cycles: {phase_line(r['phases'])}")
    empty = [k2_empty_launch_ms(torch, ts, fused_cse, *flag_rungs.calls[k]) for k in (0, len(flag_rungs.calls) - 1)]
    host_us = [k2_launch_host_us(torch, ts, fused_cse, *flag_rungs.calls[k]) for k in (0, len(flag_rungs.calls) - 1)]
    print(f'[{card}] K2 launch with every lane at cur == P (the fixed cost of a launch): '
          f'{", ".join(f"{ms:.4f} ms" for ms in empty)} on the card, {", ".join(f"{us:.2f} us" for us in host_us)} '
          f'of host time per launch call (100 back to back) (the first and the last flagship rung)')  # fmt: skip
    assert any(r['K'] == 16 for r in rows) and any(r['chains'] for r in rows)
    assert {r['placement'] for r in rows} == {'shared', 'global'}, 'K2 must run both placements'
    flag_rows = [r for r in rows if r['name'].startswith('flagship')]
    k2_ms, k2_plain = sum(r['ms'] for r in flag_rows), sum(r['plain_ms'] for r in flag_rows)
    k2_bound = sum(max(r['bytes_ms'], r['ops_ms']) for r in flag_rows)
    ops_ms, bytes_ms = sum(r['ops_ms'] for r in flag_rows), sum(r['bytes_ms'] for r in flag_rows)
    part = {k: sum(r[k] for r in flag_rows) for k in ('int_build_ms', 'fp_build_ms', 'int_loop_ms', 'fp_loop_ms')}
    print(f'[{card}] fused_cse: {k2_ms:.4f} ms over the flagship\'s {len(flag_rows)} rungs '
          f'({sum(r["iters"] for r in flag_rows)} iterations), cache build included; plain version {k2_plain:.2f} ms; '
          f'bound {k2_bound:.6f} ms by {"operations" if ops_ms >= bytes_ms else "bytes"} '
          f'(operations {ops_ms:.6f} ms: int32 cache build {part["int_build_ms"]:.6f} ms and recount '
          f'{part["int_loop_ms"]:.6f} ms, fp32 cache build {part["fp_build_ms"]:.6f} ms and scores, merge and argmax '
          f'{part["fp_loop_ms"]:.6f} ms; HBM {bytes_ms:.6f} ms); K2 {k2_ms / k2_bound:.0f}x the bound')  # fmt: skip

    # phase 7: the wider six-bit layers of bench.py through the device search
    wrng = np.random.default_rng(20260729)
    kernels = []
    for ni, no in WIDE_LAYERS:
        mag = wrng.integers(0, 2**6, (ni, no)).astype(np.float64)
        kernels.append(mag * wrng.choice([-1.0, 1.0], (ni, no)))
    with RungRecorder(ts, fused_cse) as wide_rungs:
        t0 = time.perf_counter()
        sols = solve_torch_many(kernels)
        torch.cuda.synchronize()
        wide_s = time.perf_counter() - t0
    for k, s in zip(kernels, sols):
        assert np.array_equal(np.asarray(s.kernel, np.float64), k), f'wide layer {k.shape} is not exact'
    print(f'wider layers {WIDE_LAYERS}: {wide_s:.3f} s on the card, exact; cost {[float(s.cost) for s in sols]} (total {sum(float(s.cost) for s in sols)}), '
          f'{len(wide_rungs.calls)} rungs, largest P {max(s.P for _, s in wide_rungs.calls)}')  # fmt: skip

    # phase 8: the port imported nothing of JAX
    assert 'jax' not in sys.modules and 'da4ml_tpu' not in sys.modules, 'jax or da4ml_tpu was imported'

    kernels_line = [
        dais,
        {
            'name': 'fused_cse',
            'route': 'cuda',
            'source': 'da4ml_tpu_torch/csrc/fused_cse.cu',
            'replaces': 'da4ml_tpu/cmvm/fused_cse.py:108',
            'launches': k2_launches,
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': k2_ms,
            'plain_ms': k2_plain,
            'bound_ms': k2_bound,
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
            'library_ms': None,
        },
    ]
    print(json.dumps({'kernels': kernels_line}))
    print(card)
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': torch.cuda.device_count()}
    print(json.dumps({'ok': True, 'device': device}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
