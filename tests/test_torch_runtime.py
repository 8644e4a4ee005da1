"""The port's DAIS executor — the module that carries the CUDA kernel — against
the JAX package's, on the CPU.

Here the executor's wrapper runs the kernel's plain ``level`` version (the
tensors lie on the CPU); it is held against ``da4ml_tpu``'s
``DaisExecutor(mode='pallas')``, which runs the Pallas kernel in interpret
mode on the CPU. Wide (int64) programs are held against the reference
interpreter. The kernel's host-side data — liveness-assigned slots and op
records — is executed here by a numpy model of the CUDA source's semantics.
Tolerance is exact."""

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


def _emulate(kernel: cuda_backend.DaisKernel, x: np.ndarray) -> np.ndarray:
    """Per-sample semantics of ``dais_exec_kernel`` (vectorized over samples):
    the records in chunks, each chunk in runs of one (level, family) group,
    each run ``UNROLL`` ops at a time that all read before any writes (the
    last batch repeats the run's last op in its empty places)."""
    L = cuda_backend.LOWERINGS
    T = np.int64 if kernel.dtype == torch.int64 else np.int32
    buf = np.zeros((kernel.n_slots, len(x)), T)

    def eval_op(r, fam):
        a, b, c, w, sg, aux = (int(r[f]) for f in ('a', 'b', 'c', 'w', 'sg', 'aux'))
        k0, k1, k2, k3 = (np.int64(r[f]).astype(T) for f in ('k0', 'k1', 'k2', 'k3'))
        if fam == L['copy']:
            return _wrap(x[:, a].astype(T), sg, w, T)
        if fam == L['addsub']:
            return (buf[a] * k0 + buf[b] * k1) >> aux
        if fam in (L['relu'], L['quantize']):
            s = buf[a] * k0
            q = _wrap((s * k1) >> aux, sg, w, T)
            return np.where(s < 0, T(0), q) if fam == L['relu'] else q
        if fam == L['const_add']:
            return ((buf[a] * k1) >> aux) + k2
        if fam == L['const']:
            return np.full(len(x), k2, T)
        if fam == L['msb_mux']:
            cond = (buf[c] < 0) if (aux >> 16) & 1 else (buf[c] >= k3)
            r0 = _wrap((buf[a] * k1) >> (aux & 0xFF), sg, w, T)
            r1 = _wrap(((buf[b] * k0) * k2) >> ((aux >> 8) & 0xFF), sg, w, T)
            return np.where(cond, r0, r1)
        if fam == L['mul']:
            return buf[a] * buf[b]
        if fam == L['lookup']:
            return kernel.table[np.clip(buf[a] - k0, k1, k2).astype(np.int64)].astype(T)
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

    recs, U = kernel.records, cuda_backend.UNROLL
    with np.errstate(over='ignore'):
        for c0 in range(0, len(recs), cuda_backend.RECORD_CHUNK):
            stage = recs[c0 : c0 + cuda_backend.RECORD_CHUNK]
            j = 0
            while j < len(stage):
                head = int(stage[j]['fam'])
                run = max(1, min(head >> 8, len(stage) - j))
                ops = stage[j : j + run]
                for k in range(0, run, U):
                    batch = ops[np.minimum(np.arange(k, k + U), run - 1)]
                    vals = [eval_op(r, head & 0xFF) for r in batch]
                    for r, v in zip(batch, vals):
                        buf[int(r['dst'])] = v
                j += run
        return np.stack([buf[int(s)] * T(g) for s, g in kernel.outs], axis=1)


_RECORD_CASES = (*FAMILIES, 'mixed', 'wide')


@pytest.mark.parametrize('case', _RECORD_CASES)
def test_kernel_records_match_plain_version(case):
    """Slots assigned by liveness and the op records, executed with the CUDA
    source's semantics, equal the plain version bit for bit."""
    rng = np.random.default_rng(80_000 + _RECORD_CASES.index(case))
    families = FAMILIES if case in ('mixed', 'wide') else (case,)
    jprog = random_program(rng, n_ops=220, n_in=6, n_out=5, families=families, wide=case == 'wide')
    ex = DaisExecutor(_port(jprog), device='cpu')
    x = ex.int_inputs(random_inputs(rng, jprog, 129))
    assert np.array_equal(_emulate(ex.kernel, x.numpy()), ex.plain(x).numpy())
    assert ex.kernel.n_slots <= ex.prog.n_ops


def test_slot_assignment_keeps_live_values():
    """No slot is overwritten while a later op still reads its value, and
    output slots survive to the end."""
    rng = np.random.default_rng(4)
    ex = DaisExecutor(_port(random_program(rng, n_ops=400, n_in=6, n_out=6)), device='cpu')
    slot, order = ex.kernel.slot, ex.schedule.order
    holder = {}  # slot -> op whose value it holds
    prog = ex.prog
    for i in order.tolist():
        oc = int(prog.opcode[i])
        reads = []
        if oc not in (-1, 5):
            reads.append(int(prog.id0[i]))
        if oc in (0, 1, 6, -6, 7, 10):
            reads.append(int(prog.id1[i]))
        if abs(oc) == 6:
            reads.append(int(prog.data_lo[i]))
        for j in reads:
            assert holder[int(slot[j])] == j, f'op {i} reads op {j} after its slot was reused'
        holder[int(slot[i])] = i
    for j in prog.out_idxs[prog.out_idxs >= 0].tolist():
        assert holder[int(slot[j])] == j
    assert ex.kernel.n_slots < prog.n_ops


def test_group_runs_read_before_any_write():
    """Each record's run length spans its (level, family) group, and no op of
    a group reads the slot an earlier op of the group writes — so the kernel
    may read a group's operands before it writes any of its results."""
    rng = np.random.default_rng(5)
    ex = DaisExecutor(_port(random_program(rng, n_ops=500, n_in=6, n_out=6, n_levels=12)), device='cpu')
    recs = ex.kernel.records
    fam, left = recs['fam'] & 0xFF, recs['fam'] >> 8
    reads = {
        cuda_backend.LOWERINGS['addsub']: 'ab', cuda_backend.LOWERINGS['mul']: 'ab',
        cuda_backend.LOWERINGS['bit_binary']: 'ab', cuda_backend.LOWERINGS['msb_mux']: 'abc',
        cuda_backend.LOWERINGS['copy']: '', cuda_backend.LOWERINGS['const']: '',
    }  # fmt: skip
    p = 0
    while p < len(recs):
        n = int(left[p])
        group = recs[p : p + n]
        assert n >= 1 and (fam[p : p + n] == fam[p]).all() and (left[p : p + n] == np.arange(n, 0, -1)).all()
        written = set()
        for r in group:
            for f in reads.get(int(r['fam']) & 0xFF, 'a'):
                assert int(r[f]) not in written
            written.add(int(r['dst']))
        p += n


#: shared memory of an H100 in bytes (per block with the opt-in, per SM,
#: reserved per block), as cudaDeviceGetAttribute reports it
_H100_SMEM = (232448, 233472, 1024)


@pytest.mark.parametrize(
    'n_slots, itemsize, threads, on_chip',
    [(30, 4, 128, True), (90, 4, 128, True), (96, 4, 128, True), (268, 4, 64, True), (500, 8, 32, True),
     (1029, 8, 128, False), (1800, 4, 128, False)],
)  # fmt: skip
def test_launch_geometry(n_slots, itemsize, threads, on_chip):
    """The block size keeps the most samples resident (ties to the larger
    block); a buffer that does not fit at 32 samples goes to global memory in
    chunks of whole blocks within the scratch budget."""
    got_threads, rows = cuda_backend.launch_geometry(n_slots, itemsize, _H100_SMEM)
    assert got_threads == threads and (rows is None) == on_chip
    static = cuda_backend.RECORD_CHUNK * cuda_backend.REC_DTYPE.itemsize
    if on_chip:
        assert n_slots * threads * itemsize + static <= _H100_SMEM[0]
    else:
        assert n_slots * 32 * itemsize + static > _H100_SMEM[0]
        assert rows % 128 == 0 and rows * n_slots * itemsize <= cuda_backend.SCRATCH_BYTES


def test_smoke_corpus_reaches_both_buffer_paths():
    """The smoke run's two sized programs (same generator and seeds) land where
    it needs them: one int32 buffer between 44 and 48 KB at 128 threads, which
    launches only with the shared-memory opt-in, and one int64 program that
    the geometry sends to the global-memory scratch."""
    from da4ml_tpu_torch.ir.synth import random_program as port_random_program

    near = DaisExecutor(port_random_program(np.random.default_rng(1), n_ops=340, n_in=8, n_out=6, n_levels=4), 'cpu')
    threads, rows = cuda_backend.launch_geometry(near.kernel.n_slots, near.kernel.itemsize, _H100_SMEM)
    smem = near.kernel.n_slots * threads * near.kernel.itemsize
    assert near.dtype == torch.int32 and rows is None and 48 * 1024 - 4096 < smem <= 48 * 1024
    wide = DaisExecutor(
        port_random_program(np.random.default_rng(1), n_ops=3200, n_in=8, n_out=6, n_levels=3, wide=True), 'cpu'
    )
    assert wide.dtype == torch.int64
    assert cuda_backend.launch_geometry(wide.kernel.n_slots, wide.kernel.itemsize, _H100_SMEM)[1] is not None
    rng = np.random.default_rng(6)
    for ex in (near, wide):
        data = random_inputs(rng, ex.prog, 7)
        np.testing.assert_array_equal(ex(data), reference.run_program(ex.prog, data))


def _record(family, **fields):
    rec = np.zeros(1, dtype=cuda_backend.REC_DTYPE)
    rec['fam'] = cuda_backend.LOWERINGS[family]
    rec['k0'] = rec['k1'] = rec['k2'] = rec['k3'] = 1
    for name, value in fields.items():
        rec[name] = value
    return rec


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
    """The bound's operation count: shifts by 0, signs of +1 and full-width
    wraps cost nothing; a shift or negation fused with its add counts once."""
    assert cuda_backend.record_ops(_record(family, **fields), 32).tolist() == [ops]


def test_kernel_source_audit_matches_optable():
    """The kernel's family switch is named, both ways, by the opcode table."""
    from da4ml_tpu_torch.ir.optable import OP_TABLE

    assert {spec.lower for spec in OP_TABLE} == set(cuda_backend.LOWERINGS)
    src = cuda_backend.SOURCE.read_text()
    for name, fid in cuda_backend.LOWERINGS.items():
        assert f'FAM_{name} = {fid},' in src and f'case FAM_{name}:' in src
    assert cuda_backend.REC_DTYPE.itemsize == 64
