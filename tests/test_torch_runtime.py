"""The port's DAIS executor — the module that carries the CUDA kernel — against
the JAX package's, on the CPU.

Here the executor's wrapper runs the kernel's plain ``level`` version (the
tensors lie on the CPU); it is held against ``da4ml_tpu``'s
``DaisExecutor(mode='pallas')``, which runs the Pallas kernel in interpret
mode on the CPU. Wide (int64) programs are held against the reference
interpreter. The kernel's host-side data — phases, slots assigned by phase
liveness, 16-byte op records — is executed here by a numpy model of the CUDA
source's semantics, its warps interleaved in adversarial orders. Tolerance is
exact."""

import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from da4ml_tpu.ir import dais_binary as jbin
from da4ml_tpu.ir.synth import FAMILIES, random_inputs, random_program
from da4ml_tpu.runtime import reference as jref
from da4ml_tpu.runtime.jax_backend import DaisExecutor as JaxExecutor
from da4ml_tpu_torch.ir.dais_binary import decode
from da4ml_tpu_torch.runtime import cuda_backend, program_from_binary, reference
from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor, InvalidInputError


def _port(jprog):
    return decode(jbin.encode(jprog))


@pytest.mark.parametrize('family', FAMILIES)
def test_executor_matches_pallas_per_family(family):
    """One single-family program per opcode family, odd batch of 33."""
    rng = np.random.default_rng(50_000 + FAMILIES.index(family))
    jprog = random_program(rng, n_ops=160, n_in=5, n_out=4, families=(family,))
    data = random_inputs(rng, jprog, 33)
    want = JaxExecutor(jprog, mode='pallas')(data)
    ex = DaisExecutor(_port(jprog), device='cpu')
    assert ex.device.type == 'cpu'
    np.testing.assert_array_equal(ex(data), want, err_msg=f'family={family}')
    np.testing.assert_array_equal(ex(data), reference.run_program(ex.prog, data), err_msg=f'family={family}')


@pytest.mark.parametrize('seed', [0, 1])
def test_executor_matches_pallas_mixed(seed):
    rng = np.random.default_rng(60_000 + seed)
    jprog = random_program(rng, n_ops=300, n_in=6, n_out=5)
    data = random_inputs(rng, jprog, 65)
    np.testing.assert_array_equal(DaisExecutor(_port(jprog), device='cpu')(data), JaxExecutor(jprog, mode='pallas')(data))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_wide_int64_against_reference(seed):
    """Wide programs take the int64 path and equal the reference interpreter
    (the JAX package's and the port's)."""
    rng = np.random.default_rng(70_000 + seed)
    jprog = random_program(rng, n_ops=250, n_in=6, n_out=5, wide=True)
    ex = DaisExecutor(_port(jprog), device='cpu')
    assert ex.use_i64 and ex.dtype == torch.int64
    data = random_inputs(rng, jprog, 41)
    got = ex(data)
    np.testing.assert_array_equal(got, jref.run_program(jprog, data))
    np.testing.assert_array_equal(got, reference.run_program(ex.prog, data))


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    prog = _port(random_program(np.random.default_rng(1), n_ops=40))
    with pytest.raises(RuntimeError, match='CUDA'):
        DaisExecutor(prog)
    with pytest.raises(RuntimeError, match='CUDA'):
        program_from_binary(jbin.encode(random_program(np.random.default_rng(1), n_ops=40)))


def test_cpu_tensor_runs_plain_version_without_launch():
    rng = np.random.default_rng(2)
    ex = DaisExecutor(_port(random_program(rng, n_ops=120)), device='cpu')
    x = ex.int_inputs(random_inputs(rng, ex.prog, 17))
    before = cuda_backend.launches
    assert torch.equal(ex.kernel(x), ex.plain(x))
    assert cuda_backend.launches == before
    with pytest.raises(ValueError):
        ex.kernel(x.to(torch.int64) if ex.dtype == torch.int32 else x.to(torch.int32))


def test_program_from_binary_and_validation():
    rng = np.random.default_rng(3)
    jprog = random_program(rng, n_ops=80, n_in=4, n_out=3)
    ex = program_from_binary(jbin.encode(jprog), device='cpu')
    data = random_inputs(rng, jprog, 9)
    np.testing.assert_array_equal(ex(data), jref.run_program(jprog, data))
    with pytest.raises(InvalidInputError):
        ex(data[:, :3])
    with pytest.raises(InvalidInputError):
        ex(np.full((2, 4), np.nan))
    with pytest.raises(InvalidInputError):
        ex(data[0])


# ---------------------------------------------------------------------------
# the kernel's host-side data, executed by a numpy model of dais_exec.cu
# ---------------------------------------------------------------------------

#: shared memory of an H100 in bytes (per block with the opt-in, per SM,
#: reserved per block), as cudaDeviceGetAttribute reports it
_H100_SMEM = (232448, 233472, 1024)


def _wrap(v, sg, w, T):
    bits = np.dtype(T).itemsize * 8
    if w >= bits:
        return v
    if w <= 0:
        return np.full_like(v, -1 if sg else 0)
    U = np.uint32 if bits == 32 else np.uint64
    mask = U((1 << w) - 1)
    u = v.view(U) & mask
    if sg:
        u = np.where(((u >> U(w - 1)) & U(1)) == 1, u | ~mask, u)
    return u.astype(U).view(T)


def _eval_pool(fam, a, b, c, e, buf, table, T):
    """An op of a pool family: its slots from the record, its constants from
    the pool entry ``e`` (the old 64-byte record's fields)."""
    L = cuda_backend.LOWERINGS
    k0, k1, k2, k3 = (np.int64(e[f]).astype(T) for f in ('k0', 'k1', 'k2', 'k3'))
    aux, w, sg = int(e['aux']), int(e['w']), int(e['sg'])
    n = buf.shape[1]
    if fam == L['const_add']:
        return ((buf[a] * k1) >> aux) + k2
    if fam == L['const']:
        return np.full(n, k2, T)
    if fam == L['msb_mux']:
        cond = (buf[c] < 0) if (aux >> 16) & 1 else (buf[c] >= k3)
        r0 = _wrap((buf[a] * k1) >> (aux & 0xFF), sg, w, T)
        r1 = _wrap(((buf[b] * k0) * k2) >> ((aux >> 8) & 0xFF), sg, w, T)
        return np.where(cond, r0, r1)
    if fam == L['mul']:
        return buf[a] * buf[b]
    if fam == L['lookup']:
        return table[np.clip(buf[a] - k0, k1, k2).astype(np.int64)].astype(T)
    if fam == L['bit_unary']:
        s = buf[a] * k0
        if aux == 0:
            return ~s if sg else (~s & k1)
        return ((s != 0) if aux == 1 else ((s & k1) == k1)).astype(T)
    assert fam == L['bit_binary']
    v1, v2 = buf[a] * k0, buf[b] * k1
    if aux & 1:
        v2 = v2 * k2
    else:
        v1 = v1 * k3
    so = aux >> 8
    return v1 & v2 if so == 0 else (v1 | v2 if so == 1 else v1 ^ v2)


def _eval_record(fam, r, e, buf, x, table, T, unit=1):
    """One 16-byte record (and its pool entry) for every sample, decoded as
    ``eval_op`` in the CUDA source decodes it; its slot fields count in
    ``unit`` (``slot_unit``)."""
    L = cuda_backend.LOWERINGS
    bits = np.dtype(T).itemsize * 8
    a, b, ctl = int(r['a']), int(r['b']) // unit, int(r['ctl'])
    rs, w, sg = ctl & 63, (ctl >> 6) & 127, (ctl >> 13) & 1
    sign = T(int(r['s']) if bits == 32 else (-1 if (ctl >> 14) & 1 else 1))
    k = np.int64(r['k']).astype(T)
    if fam == L['copy']:
        return _wrap(x[:, a].astype(T), sg, w, T)
    a //= unit
    if fam == L['addsub']:
        return (buf[a] * k + buf[b] * sign) >> rs
    if fam in (L['relu'], L['quantize']):
        s = buf[a] * sign
        q = _wrap((s * k) >> rs, sg, w, T)
        return np.where(s < 0, T(0), q) if fam == L['relu'] else q
    return _eval_pool(fam, a, b, ctl // unit, e, buf, table, T)


def _eval_wide(fam, r, buf, x, table, T):
    """One op from its ``WIDE_DTYPE`` fields, with the semantics of the old
    64-byte record (``(x0 * k0 + x1 * k1) >> aux`` for an addsub)."""
    L = cuda_backend.LOWERINGS
    a, b, c, w, sg, aux = (int(r[f]) for f in ('a', 'b', 'c', 'w', 'sg', 'aux'))
    k0, k1 = (np.int64(r[f]).astype(T) for f in ('k0', 'k1'))
    if fam == L['copy']:
        return _wrap(x[:, a].astype(T), sg, w, T)
    if fam == L['addsub']:
        return (buf[a] * k0 + buf[b] * k1) >> aux
    if fam in (L['relu'], L['quantize']):
        s = buf[a] * k0
        q = _wrap((s * k1) >> aux, sg, w, T)
        return np.where(s < 0, T(0), q) if fam == L['relu'] else q
    return _eval_pool(fam, a, b, c, r, buf, table, T)


def _warp_orders(G: int, n_phases: int, seed: int) -> list[np.ndarray]:
    """The order in which the G warps of a tile run their whole share of each
    phase: seed 0 in order, seed 1 reversed, other seeds shuffled."""
    rng = np.random.default_rng(seed)
    if seed == 0:
        return [np.arange(G)] * n_phases
    if seed == 1:
        return [np.arange(G)[::-1]] * n_phases
    return [rng.permutation(G) for _ in range(n_phases)]


def _emulate(kernel: cuda_backend.DaisKernel, x: np.ndarray, seed: int = 0, alt=None) -> np.ndarray:
    """Per-sample semantics of ``dais_exec_kernel`` (vectorized over samples)
    run from the record stream as the kernel reads it, with the G warps of a
    tile (``launch_geometry`` on an H100) interleaved adversarially: in each
    phase one warp runs its whole share — of every (padded) group, the
    batches of ``UNROLL`` consecutive records dealt to it (batch b to warp b
    mod G), each reading before it writes — before the next warp starts, in
    the orders of ``_warp_orders(seed)``. A slot written in the phase in
    which another warp still reads its old value gives a wrong answer in some
    order. ``alt`` (``stream``, ``offsets``, ``stream_pool``, ``n_slots``,
    ``outs``, ``slot_unit``) replaces the kernel's own: another slot
    assignment of the same ops."""
    T = np.int64 if kernel.dtype == torch.int64 else np.int32
    alt = alt or kernel
    G = cuda_backend.launch_geometry(kernel.n_slots, kernel.itemsize, kernel.phase_widths, _H100_SMEM).warps
    U, unit = cuda_backend.UNROLL, alt.slot_unit
    buf = np.zeros((alt.n_slots, len(x)), T)
    orders = _warp_orders(G, len(alt.offsets), seed)
    with np.errstate(over='ignore'):
        for (at, units), order in zip(alt.offsets.tolist(), orders):
            blk = alt.stream[at : at + units]
            n_groups, p0 = int(blk[0, 0]), int(blk[0, 1])
            words = blk[1:].reshape(-1)[:n_groups].astype(np.int64).tolist()
            recs = np.ascontiguousarray(blk[1 + -(-n_groups // 4) :]).view(kernel.records.dtype).reshape(-1)
            for w in order.tolist():
                for g in words:
                    fam, start, n = g & 0xFF, (g >> 8) & 0xFFF, g >> 20
                    assert n % U == 0
                    for j in range(start + w * U, start + n, G * U):
                        vals = [_eval_record(fam, recs[i], alt.stream_pool[p0 + i], buf, x, kernel.table, T, unit)
                                for i in range(j, j + U)]  # fmt: skip
                        for i, v in zip(range(j, j + U), vals):
                            buf[int(recs[i]['dst']) // unit] = v
        return np.stack([buf[int(s) // unit] * T(g) for s, g in alt.outs], axis=1)


_RECORD_CASES = (*FAMILIES, 'mixed', 'wide')


@pytest.mark.parametrize('case', _RECORD_CASES)
def test_kernel_records_match_plain_version(case):
    """Phases, slots assigned by phase liveness and the 16-byte records,
    executed with the CUDA source's semantics in adversarial warp orders,
    equal the plain version bit for bit."""
    rng = np.random.default_rng(80_000 + _RECORD_CASES.index(case))
    families = FAMILIES if case in ('mixed', 'wide') else (case,)
    jprog = random_program(rng, n_ops=220, n_in=6, n_out=5, families=families, wide=case == 'wide')
    ex = DaisExecutor(_port(jprog), device='cpu')
    x = ex.int_inputs(random_inputs(rng, jprog, 129))
    want = ex.plain(x).numpy()
    for seed in range(4):
        assert np.array_equal(_emulate(ex.kernel, x.numpy(), seed), want), f'warp order seed {seed}'
    assert ex.kernel.n_slots <= ex.prog.n_ops


def _reads(prog, i: int) -> list[int]:
    oc = int(prog.opcode[i])
    reads = []
    if oc not in (-1, 5):
        reads.append(int(prog.id0[i]))
    if oc in (0, 1, 6, -6, 7, 10):
        reads.append(int(prog.id1[i]))
    if abs(oc) == 6:
        reads.append(int(prog.data_lo[i]))
    return reads


def test_slot_assignment_keeps_live_values():
    """No slot is written in the phase in which its old value is still read
    (by any op of the phase), no value is overwritten while a later phase
    still reads it, and output slots survive to the end."""
    rng = np.random.default_rng(4)
    ex = DaisExecutor(_port(random_program(rng, n_ops=400, n_in=6, n_out=6)), device='cpu')
    slot, order, prog = ex.kernel.slot, ex.schedule.order, ex.prog
    holder = {}  # slot -> op whose value it holds
    for s, e in ex.kernel.phases:
        ops = order[s:e].tolist()
        for i in ops:
            for j in _reads(prog, i):
                assert holder[int(slot[j])] == j, f'op {i} reads op {j} after its slot was reused'
        read_here = {int(slot[j]) for i in ops for j in _reads(prog, i)}
        written_here = [int(slot[i]) for i in ops]
        assert not read_here & set(written_here), 'a slot is written in the phase that reads its old value'
        assert len(set(written_here)) == len(written_here), 'two ops of a phase write one slot'
        for i in ops:
            holder[int(slot[i])] = i
    for j in prog.out_idxs[prog.out_idxs >= 0].tolist():
        assert holder[int(slot[j])] == j
    assert ex.kernel.n_slots < prog.n_ops


def test_group_runs_read_before_any_write():
    """Phases cover the packed order, never straddle a level and hold at most
    ``PHASE_OPS`` ops; each phase's groups are its runs of one family; its
    block of the record stream is its header, group words and records, each
    group padded to a multiple of ``UNROLL`` with its last record, and fits a
    stage; and no op of a phase reads a slot another op of the phase writes —
    so its warps may run its ops in any order, each batch reading before it
    writes."""
    rng = np.random.default_rng(5)
    ex = DaisExecutor(_port(random_program(rng, n_ops=500, n_in=6, n_out=6, n_levels=12)), device='cpu')
    k = ex.kernel
    level = ex.schedule.level[ex.schedule.order]
    assert [s for s, _ in k.phases] == [0, *(e for _, e in k.phases[:-1])] and k.phases[-1][1] == ex.prog.n_ops
    reads = {
        cuda_backend.LOWERINGS['addsub']: 'ab', cuda_backend.LOWERINGS['mul']: 'ab',
        cuda_backend.LOWERINGS['bit_binary']: 'ab', cuda_backend.LOWERINGS['msb_mux']: 'abc',
        cuda_backend.LOWERINGS['copy']: '', cuda_backend.LOWERINGS['const']: '',
    }  # fmt: skip
    assert k.phase_table.shape == (len(k.phases), 4)
    offsets = k.offsets.tolist()
    for ph, ((s, e), (r0, n, g0, ng), (at, units)) in enumerate(zip(k.phases, k.phase_table.tolist(), offsets)):
        assert (r0, n) == (s, e - s) and 1 <= n <= cuda_backend.PHASE_OPS and (level[s:e] == level[s]).all()
        groups = [(g & 0xFF, (g >> 8) & 0xFFF, g >> 20) for g in k.groups[g0 : g0 + ng].tolist()]
        assert sum(length for *_, length in groups) == n and groups[0][1] == 0
        fams = []
        for fam, start, length in groups:
            assert (k.fam[s + start : s + start + length] == fam).all()
            fams.append(fam)
        assert len(set(fams)) == len(fams)
        blk = k.stream[at : at + units]
        assert units <= n + cuda_backend.STAGE_EXTRA and blk[0, 0] == ng
        ahead = ph + cuda_backend.STAGES  # the block this one's buffer takes next
        assert blk[0, 2:].tolist() == (offsets[ahead] if ahead < len(offsets) else [0, 0])
        idx = []  # the phase's records in stream order: each group padded with its last record
        for g, pg in zip(k.groups[g0 : g0 + ng].tolist(), blk[1:].reshape(-1)[:ng].view(np.int32).tolist()):
            start, length = r0 + ((g >> 8) & 0xFFF), g >> 20
            padded = -(-length // cuda_backend.UNROLL) * cuda_backend.UNROLL
            assert pg == (g & 0xFF) | len(idx) << 8 | padded << 20
            idx += list(range(start, start + length)) + [start + length - 1] * (padded - length)
        assert np.array_equal(blk[units - len(idx) :], k.records[idx].view(np.uint32).reshape(-1, 4))
        assert np.array_equal(k.stream_pool[blk[0, 1] : blk[0, 1] + len(idx)], k.pool[idx])
        written = {int(r['dst']) for r in k.records[s:e]}
        for r, fam in zip(k.records[s:e], k.fam[s:e]):
            slots = {'a': r['a'], 'b': r['b'], 'c': r['ctl']}
            for f in reads.get(int(fam), 'a'):
                assert int(slots[f]) not in written


def _packed_slots(prog, order: np.ndarray) -> tuple[np.ndarray, int]:
    """The single-thread kernel's rule, kept here to show it unsafe for a
    tile of several warps: a slot is freed at the packed position of its
    value's last reader."""
    n = prog.n_ops
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    last = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for j in _reads(prog, i):
            last[j] = max(last[j], pos[i])
    last[prog.out_idxs[prog.out_idxs >= 0]] = n
    release = [[] for _ in range(n)]
    for j in np.flatnonzero((last >= 0) & (last < n)).tolist():
        release[int(last[j])].append(j)
    slot, free, n_slots = np.zeros(n, np.int64), [], 0
    for p, i in enumerate(order.tolist()):
        free += [int(slot[j]) for j in release[p]]
        if free:
            slot[i] = free.pop()
        else:
            slot[i], n_slots = n_slots, n_slots + 1
        if last[i] < 0:
            free.append(int(slot[i]))
    return slot, n_slots


def test_packed_order_slot_rule_fails_across_warps():
    """The single-thread kernel's rule — free a slot at its last reader's
    packed position — reuses slots inside a phase; with the phase's ops dealt
    out among warps, some adversarial order then reads an overwritten value.
    The phase rule never does."""
    rng = np.random.default_rng(7)
    ex = DaisExecutor(_port(random_program(rng, n_ops=400, n_in=6, n_out=6, families=('addsub',))), device='cpu')
    x = ex.int_inputs(random_inputs(rng, ex.prog, 65)).numpy()
    want = ex.plain(torch.from_numpy(x)).numpy()
    assert cuda_backend.launch_geometry(ex.kernel.n_slots, 4, ex.kernel.phase_widths, _H100_SMEM).warps > 1
    slot, n_slots = _packed_slots(ex.prog, ex.schedule.order)
    k = ex.kernel
    records = cuda_backend.pack_records(cuda_backend.wide_records(ex, slot), 32)[0]
    stream, offsets, pool = cuda_backend.phase_stream(k.phase_table, k.groups, records, k.pool)
    old = SimpleNamespace(stream=stream, offsets=offsets, stream_pool=pool, n_slots=n_slots, slot_unit=1,
                          outs=np.stack([slot[np.maximum(ex.prog.out_idxs, 0)], k.outs[:, 1]], 1))
    wrong = [seed for seed in range(6) if not np.array_equal(_emulate(ex.kernel, x, seed, old), want)]
    assert wrong, 'the packed-order rule survived every warp order'
    assert all(np.array_equal(_emulate(ex.kernel, x, seed), want) for seed in range(6))


_FLAGSHIP_LEVELS = (16, 16, 75, 117, 95, 57, 32, 32, 90, 170, 203, 149, 87, 37, 32, 32, 41, 36, 25, 18, 11, 5, 4, 2, 1)


def _widths(levels) -> list[int]:
    """Phase widths of a program with these level widths."""
    starts = np.concatenate([[0], np.cumsum(levels)])
    return [e - s for s, e in cuda_backend.phase_bounds(SimpleNamespace(starts=starts), cuda_backend.PHASE_OPS)]


@pytest.mark.parametrize(
    'n_slots, itemsize, levels, warps, on_chip',
    [(30, 4, (16, 8), 6, True), (90, 4, (40, 40, 10), 6, True), (96, 4, (2, 1), 1, True),
     (383, 4, _FLAGSHIP_LEVELS, 6, True), (256, 8, (64, 64), 6, True), (1029, 8, (300, 300, 300), 6, False),
     (1800, 4, (700, 700), 6, False)],
)  # fmt: skip
def test_launch_geometry(n_slots, itemsize, levels, warps, on_chip):
    """G fills the widest phase at UNROLL ops a warp, at most MAX_WARPS; the tiles per block keep
    the most warps resident within the H100's shared memory and thread
    limits; the flagship's slot count leaves at least 24 resident warps per
    SM; a tile that does not fit a block goes to global memory in launches of
    whole blocks within the scratch budget."""
    widths = _widths(levels)
    g = cuda_backend.launch_geometry(n_slots, itemsize, widths, _H100_SMEM)
    assert g.warps == warps and (g.scratch_rows is None) == on_chip and g.threads <= cuda_backend.MAX_THREADS
    assert g.stage_units == max(widths) + cuda_backend.STAGE_EXTRA and g.tiles <= cuda_backend.MAX_TILES
    region = cuda_backend.tile_region(n_slots, itemsize, g.stage_units, on_chip)
    assert g.smem == g.tiles * region <= _H100_SMEM[0]
    blocks = min(32, _H100_SMEM[1] // (g.smem + _H100_SMEM[2]), 2048 // g.threads)
    assert g.resident_warps == min(64, blocks * g.tiles * g.warps)
    assert cuda_backend.slot_unit(n_slots, itemsize) == (cuda_backend.TILE * itemsize if on_chip else 1)
    if on_chip:
        assert n_slots * cuda_backend.TILE * itemsize <= min(g.smem, cuda_backend.TILE_BYTES_ON_CHIP)
    else:
        assert n_slots * cuda_backend.TILE * itemsize > cuda_backend.TILE_BYTES_ON_CHIP
        per_launch = cuda_backend.TILE * g.tiles
        assert g.scratch_rows % per_launch == 0 and g.scratch_rows * n_slots * itemsize <= cuda_backend.SCRATCH_BYTES
    if levels == _FLAGSHIP_LEVELS:
        assert len(widths) == 26 and max(widths) <= cuda_backend.PHASE_OPS and g.resident_warps >= 24


def test_smoke_corpus_reaches_both_buffer_paths():
    """The smoke run's three sized programs (same generator and seeds) land
    where it needs them: one int32 program whose block takes more than 48 KB
    of shared memory, which launches only with the dynamic-size opt-in, one
    whose one-warp tiles go two to a block, and one int64 program that the
    geometry sends to the global-memory scratch."""
    from da4ml_tpu_torch.ir.synth import random_program as port_random_program

    big = DaisExecutor(port_random_program(np.random.default_rng(1), n_ops=1500, n_in=8, n_out=6, n_levels=5), 'cpu')
    g = cuda_backend.launch_geometry(big.kernel.n_slots, big.kernel.itemsize, big.kernel.phase_widths, _H100_SMEM)
    assert big.dtype == torch.int32 and g.scratch_rows is None and g.smem > 48 * 1024
    wide = DaisExecutor(
        port_random_program(np.random.default_rng(1), n_ops=3200, n_in=8, n_out=6, n_levels=3, wide=True), 'cpu'
    )
    assert wide.dtype == torch.int64
    g = cuda_backend.launch_geometry(wide.kernel.n_slots, wide.kernel.itemsize, wide.kernel.phase_widths, _H100_SMEM)
    assert g.scratch_rows is not None
    narrow = DaisExecutor(port_random_program(np.random.default_rng(0), n_ops=20, n_in=2, n_out=2, n_levels=18), 'cpu')
    g = cuda_backend.launch_geometry(narrow.kernel.n_slots, 4, narrow.kernel.phase_widths, _H100_SMEM)
    assert (g.tiles, g.warps, g.scratch_rows) == (2, 1, None)
    rng = np.random.default_rng(6)
    for ex in (big, wide, narrow):
        data = random_inputs(rng, ex.prog, 7)
        np.testing.assert_array_equal(ex(data), reference.run_program(ex.prog, data))


def _wide(family, **fields):
    rec = np.zeros(1, dtype=cuda_backend.WIDE_DTYPE)
    rec['fam'] = cuda_backend.LOWERINGS[family]
    rec['k0'] = rec['k1'] = rec['k2'] = rec['k3'] = 1
    rec['w'] = 32
    for name, value in fields.items():
        rec[name] = value
    return rec


def _record_ops(wide, bits=32):
    rec, ext = cuda_backend.pack_records(wide, bits)
    return cuda_backend.record_ops(wide['fam'], rec, ext, bits).tolist()


@pytest.mark.parametrize(
    'family, fields, ops',
    [
        ('addsub', {}, 1),  # x0 + x1
        ('addsub', {'k1': -4}, 1),  # x0 - (x1 << 2): one IMAD
        ('addsub', {'k0': 8, 'aux': 1}, 2),  # ((x0 << 3) + x1) >> 1
        ('copy', {'w': 8, 'sg': 1}, 2),  # signed wrap
        ('copy', {'w': 8, 'sg': 0}, 1),  # unsigned wrap: a mask
        ('copy', {'w': 32, 'sg': 1}, 0),  # full width: nothing
        ('relu', {'w': 7, 'sg': 1}, 4),  # wrap, compare and select
        ('relu', {'k0': -1, 'k1': 4, 'w': 7, 'sg': 1}, 5),
        ('quantize', {'aux': 2, 'w': 6, 'sg': 0}, 2),
        ('const_add', {'k1': 2, 'k2': 5}, 1),
        ('const', {'k2': 5}, 0),
        ('msb_mux', {'w': 32}, 2),  # compare and select
        ('msb_mux', {'w': 8, 'sg': 1, 'k1': 2, 'k2': 4, 'aux': 1 | 1 << 8}, 10),  # two shifted, wrapped branches
        ('mul', {}, 1),
        ('lookup', {'k0': 3, 'k1': 0, 'k2': 15}, 3),
        ('bit_unary', {'aux': 2, 'k0': -1}, 3),
        ('bit_binary', {'aux': 1, 'k2': 4}, 2),  # x0 & (x1 << 2)
        ('bit_binary', {'aux': 0, 'k0': -1, 'k1': -1}, 3),
    ],
)  # fmt: skip
def test_record_ops_counts_only_what_a_record_needs(family, fields, ops):
    """The bound's operation count, read from the packed records: shifts by
    0, signs of +1 and full-width wraps cost nothing; a shift or negation
    fused with its add counts once."""
    assert _record_ops(_wide(family, **fields)) == [ops]


def _edge_rows(family: str, bits: int, rng) -> np.ndarray:
    """``WIDE_DTYPE`` rows of one family with the edge constants the host
    produces: pow2 multipliers for shifts of 0, 1, bits - 1 (the most negative
    value), bits and more (0), negative multipliers, right shifts 0 to
    bits - 1, wrap widths from below 0 to above ``bits``."""
    def tw(v):  # a Python int wrapped into the executor's width
        return (v + 2 ** (bits - 1)) % 2**bits - 2 ** (bits - 1)

    def pow2(s):
        return tw(1 << s) if s < bits else 0

    shifts = (0, 1, bits - 1, bits, bits + 3)
    rows = []
    for i in range(24):
        s = shifts[i % len(shifts)]
        r = dict(dst=int(rng.integers(0, 8)), a=int(rng.integers(0, 8)), b=int(rng.integers(0, 8)),
                 c=int(rng.integers(0, 8)), w=int((-1, 0, 1, 5, bits - 1, bits, bits + 3)[i % 7]), sg=i % 2,
                 aux=int((0, 1, bits - 1)[i % 3]))  # fmt: skip
        if family == 'addsub':
            sign = -1 if i % 4 >= 2 else 1
            if i % 2:  # the second operand shifted left: x1 * (+/-2^s)
                r.update(k0=1, k1=tw(sign * pow2(s)))
            else:  # the first operand shifted left, the second's sign
                r.update(k0=pow2(s), k1=sign)
        elif family in ('relu', 'quantize'):
            r.update(k0=-1 if i % 4 >= 2 else 1, k1=pow2(s))
        elif family == 'copy':
            r.update(a=int(rng.integers(0, 4)))
        else:
            ks = rng.integers(-(2**31), 2**31, 4)
            r.update(k0=int(ks[0]), k1=int(ks[1]), k2=int(ks[2]), k3=pow2(s))
            if family == 'msb_mux':
                r.update(aux=int(rng.integers(0, bits)) | int(rng.integers(0, bits)) << 8 | (i % 2) << 16)
            elif family == 'lookup':
                r.update(k0=int(rng.integers(-4, 4)), k1=0, k2=15)
            elif family in ('bit_unary', 'bit_binary'):
                r.update(aux=(i % 3) if family == 'bit_unary' else (i % 2) | (i % 3) << 8)
        rows.append(_wide(family, **r))
    return np.concatenate(rows)


@pytest.mark.parametrize('bits', [32, 64])
@pytest.mark.parametrize('family', list(cuda_backend.LOWERINGS))
def test_compact_record_round_trip(family, bits):
    """Every family's op, packed into the 16-byte record and its pool entry,
    then decoded as the kernel decodes it, computes what its fields compute:
    at pow2 shifts of 0, bits - 1 and bits or more, with negative multipliers
    and right shifts up to bits - 1, on operands including the extremes."""
    rng = np.random.default_rng(90_000 + bits + cuda_backend.LOWERINGS[family])
    T = np.int64 if bits == 64 else np.int32
    wide = _edge_rows(family, bits, rng)
    unit = cuda_backend.TILE * bits // 8  # slot fields as byte offsets, as on the shared-memory path
    rec, ext = cuda_backend.pack_records(wide, bits, unit)
    assert rec.dtype.itemsize == 16 and (rec['dst'] == wide['dst'] * unit).all()
    info = np.iinfo(T)
    buf = rng.integers(info.min, info.max, (8, 64), dtype=T, endpoint=True)
    buf[:, :4] = np.array([info.min, info.max, 0, -1], T)
    x = rng.integers(info.min, info.max, (64, 4), dtype=T, endpoint=True)
    table = np.arange(16, dtype=T) * 3 - 7
    fam = cuda_backend.LOWERINGS[family]
    with np.errstate(over='ignore'):
        for w, r, e in zip(wide, rec, ext):
            want = _eval_wide(fam, w, buf, x, table, T)
            got = _eval_record(fam, r, e, buf, x, table, T, unit)
            assert np.array_equal(got, want), (family, w)


_CU = cuda_backend.SOURCE


def test_kernel_source_audit_matches_optable():
    """The kernel's family switch is named, both ways, by the opcode table;
    the source's record words, constants and C signatures agree with the
    wrapper's."""
    from da4ml_tpu_torch.ir.optable import OP_TABLE

    assert {spec.lower for spec in OP_TABLE} == set(cuda_backend.LOWERINGS)
    src = _CU.read_text()
    for name, fid in cuda_backend.LOWERINGS.items():
        assert f'FAM_{name} = {fid},' in src and f'case FAM_{name}:' in src
    assert all(d.itemsize == 16 for d in cuda_backend.REC_DTYPES.values())
    assert re.findall(r'\n    (T k0, k1, k2, k3;\n    int32_t aux, w, sg, pad;)', src)
    lib = SimpleNamespace(**{n: SimpleNamespace() for n in ('dais_exec_launch', 'dais_exec_occupancy',
                                                            'dais_device_smem', 'dais_error_string')})  # fmt: skip
    cuda_backend._declare(lib)
    for name in ('dais_exec_launch', 'dais_exec_occupancy', 'dais_device_smem'):
        params = re.search(rf'int {name}\((.*?)\)\s*\{{', src, re.S)[1]
        assert len(params.split(',')) == len(getattr(lib, name).argtypes), name


def test_kernel_source_parses_with_stub_headers():
    """``g++ -fsyntax-only`` parses the CUDA source, every template
    instantiated, against declaration-only stubs of the CUDA headers: C++
    errors show here, not first on the card."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ on this machine')
    stub = Path(__file__).resolve().parent / 'cuda_stub'
    proc = subprocess.run([gxx, '-std=c++17', '-fsyntax-only', '-I', str(stub), '-x', 'c++', str(_CU)],
                          capture_output=True, text=True)  # fmt: skip
    assert proc.returncode == 0, proc.stderr
