"""The hand-written CUDA kernel that executes DAIS programs — wrapper, build
and host-side program data.

``csrc/dais_exec.cu`` replaces ``da4ml_tpu/runtime/pallas_backend.py::
build_pallas_fn`` (the TPU's Pallas mega-kernel). It is one table-driven
kernel, compiled once for int32 and int64 with ``nvcc`` for ``sm_90a`` into
``build/da4ml_tpu_torch/`` at first use and loaded with ``ctypes``; a
program is data, not code. This module turns a :class:`DaisExecutor`'s
program into that data:

- the packed order is ``levelize_program(prog, sort_key=family)``, the order
  ``build_pallas_fn`` walks; it is cut into phases: each level, split into
  near-equal chunks of at most ``PHASE_OPS`` ops (``phase_bounds``). The
  kernel deals a phase's ops out among the warps of a sample tile and
  separates phases by a barrier of those warps;
- buffer slots are assigned by operand liveness at phase granularity
  (``assign_slots``): a slot is freed only at the barrier after the phase of
  its value's last reader, so no op writes a slot in the phase in which
  another warp may still read its old value; ops named by ``out_idxs`` stay
  live to the end;
- each op becomes a 16-byte record (``REC_DTYPES``): three 16-bit slot ids, a
  16-bit control word and a multiplier in the executor's width. The four
  families that need nothing else (``COMPACT``: copy, addsub, relu,
  quantize) are executed from the record alone; the other seven read their
  constants from a pool (``EXT_DTYPES``, one entry per record) in global
  memory. The constants are the plain ``level`` version's. A program whose
  slots or input columns do not fit 16 bits takes the 24-bit-field layout
  (``field_bits``): the same records, each slot field's bits 16-23 in its
  pool entry's ``hi`` word, which every op then reads;
- per phase, its record range and its (family) groups (``phase_tables``),
  and the record stream the kernel copies a phase at a time: per phase a
  16-byte header, its group words and its records (``phase_stream``).

What bounds the kernel on an H100, and what the design does about it, is in
the source's header note.

:class:`DaisKernel` is the wrapper. On a CUDA tensor it launches the kernel
on the current stream, or raises; on a CPU tensor it runs the plain
``level`` version (``torch_backend.LevelPlan``). It counts its launches in
the module-level ``launches`` (``scratch_launches`` counts those that kept
the buffer in global memory because the program was too wide for shared
memory). Its first launch records the reference's ``run.pallas.compile_s``
(the library's load or build, the program's packing and upload) and
``run.pallas.vmem_bytes`` (here: the dynamic shared memory of a block).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import telemetry
from ..ir.optable import OP_TABLE
from ..ir.schedule import operand_edges

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'dais_exec.cu'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'da4ml_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')  # fmt: skip

#: family ids of the kernel's switch, keyed by ``OpSpec.lower``
LOWERINGS: dict[str, int] = {
    'copy': 0,
    'addsub': 1,
    'relu': 2,
    'quantize': 3,
    'const_add': 4,
    'const': 5,
    'msb_mux': 6,
    'mul': 7,
    'lookup': 8,
    'bit_unary': 9,
    'bit_binary': 10,
}
#: families whose 16-byte record holds all they need; the others read their
#: constants from the pool
COMPACT = ('copy', 'addsub', 'relu', 'quantize')

#: samples of a tile: the lanes of a warp
TILE = 32
#: consecutive ops one warp evaluates together (``kUnroll``): their loads
#: overlap; 2 measured faster than 4 on the H100 (fewer padding records, and
#: 8 spills)
UNROLL = 2
#: record buffers of a tile's stage (``kStages``): phase p + kStages is
#: copied in while the next phases run
STAGES = 2
#: threads of a block at most (``kMaxThreads``): tiles x warps x 32
MAX_THREADS = 256
#: warps that share a tile at most (G): fewer warps a tile repeat less of a
#: phase's fixed work, more hide more latency; 6 measured fastest on the H100
#: among the counts that keep 24 warps resident on the flagship
MAX_WARPS = 6
#: tiles of a block at most (``kMaxTiles``): tile t meets on named barrier
#: 1 + t, and ptxas reserves every barrier id the source names
MAX_TILES = 4
#: 16-byte units of a phase's block in the stream beside its records at
#: most: the header, up to one group word per family, and each group's
#: padding to a multiple of ``UNROLL``
STAGE_EXTRA = 4 + len(LOWERINGS) * (UNROLL - 1)
#: most ops of one phase: a level wider than this is split into phases, so a
#: tile's record stage stays small. Longer phases take fewer barriers but
#: hold more slots: 192 measured fastest on the H100 among the sizes that
#: keep 24 warps resident on the flagship (64, 96, 128, 160, 192)
PHASE_OPS = 192

#: the 16-byte op record per executor width. ``dst``, ``a``, ``b``: slots (a
#: copy's ``a`` is its input column); ``ctl``: for ``COMPACT`` families the
#: right shift (bits 0-5), wrap width (bits 6-12), signed (bit 13) and negate
#: (bit 14), for the others the third operand's slot; ``k``: the multiplier
#: (int32 records also carry the sign, +1 or -1, as ``s``; int64 records
#: take it from the negate bit)
REC_DTYPES = {
    32: np.dtype([('dst', '<u2'), ('a', '<u2'), ('ctl', '<u2'), ('b', '<u2'), ('k', '<i4'), ('s', '<i4')]),
    64: np.dtype([('dst', '<u2'), ('a', '<u2'), ('ctl', '<u2'), ('b', '<u2'), ('k', '<i8')]),
}
#: the constant pool's entry per record (``Ext<T>`` in the source)
EXT_DTYPES = {
    bits: np.dtype([('k0', t), ('k1', t), ('k2', t), ('k3', t), ('aux', '<i4'), ('w', '<i4'), ('sg', '<i4'),
                    ('hi', '<u4')])
    for bits, t in ((32, '<i4'), (64, '<i8'))
}  # fmt: skip
assert all(d.itemsize == 16 for d in REC_DTYPES.values()), 'records are 16 bytes in csrc/dais_exec.cu'
#: the record's slot fields, in the pool entry's ``hi`` word of the 24-bit
#: layout: bits 16-23 of field ``f`` at bits ``8 * HI_BYTE[f]``
HI_BYTE = {'dst': 0, 'a': 1, 'b': 2, 'c': 3}
#: the largest value a slot field holds, per layout (``field_bits``)
FIELD_MAX = {16: 0xFFFF, 24: 0xFFFFFF}

#: the op fields of the level lowering, one row per op: the constants both
#: the compact records and the pool are packed from
WIDE_DTYPE = np.dtype(
    [('fam', '<i8'), ('dst', '<i8'), ('a', '<i8'), ('b', '<i8'), ('c', '<i8'), ('w', '<i8'), ('sg', '<i8'),
     ('aux', '<i8'), ('k0', '<i8'), ('k1', '<i8'), ('k2', '<i8'), ('k3', '<i8')]
)  # fmt: skip

#: global-memory scratch budget of the chunked path for programs too wide
#: for shared memory: a launch takes as many tiles as fit. 1 GiB measured
#: faster than 256 MiB on the H100 for the config-5 model and the 256x256
#: conv front end, which then need fewer, fuller launches (PERF.md)
SCRATCH_BYTES = 1 << 30
#: the largest tile buffer kept in shared memory: its records address slots
#: by 16-bit byte offsets (``slot_unit``)
TILE_BYTES_ON_CHIP = 1 << 16


def _audit() -> None:
    """Two-way audit of the opcode table's ``lower`` column against the
    kernel's family switch: every row names a family of the switch, every
    family of the switch is named by a row, and the ids agree with the
    source's enum and ``case`` labels. The source's constants agree with
    this module's."""
    named = {spec.lower for spec in OP_TABLE}
    if named != set(LOWERINGS):
        raise RuntimeError(
            f'opcode table lower names {sorted(named)} and the CUDA family switch {sorted(LOWERINGS)} disagree'
        )
    src = SOURCE.read_text()
    enum = {k: int(v) for k, v in re.findall(r'\bFAM_(\w+)\s*=\s*(\d+)', src)}
    cases = set(re.findall(r'case\s+FAM_(\w+)\s*:', src))
    if enum != LOWERINGS or cases != set(LOWERINGS):
        raise RuntimeError(f'{SOURCE.name} family switch {enum} / cases {sorted(cases)} disagree with {LOWERINGS}')
    consts = (('kTile', TILE), ('kUnroll', UNROLL), ('kStages', STAGES), ('kMaxThreads', MAX_THREADS),
              ('kMaxTiles', MAX_TILES))
    for const, val in consts:
        if f'constexpr int32_t {const} = {val};' not in src:
            raise RuntimeError(f'{SOURCE.name}: {const} disagrees with {val}')


_audit()

#: kernel launches since the last ``reset_counts`` (any program)
launches = 0
#: of those, launches that kept the operand buffer in global memory
scratch_launches = 0


def reset_counts() -> None:
    global launches, scratch_launches
    launches = 0
    scratch_launches = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_libs: dict = {}
_lib_lock = threading.Lock()
#: nvcc's diagnostics of the last build (ptxas register / spill report)
build_log = ''


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc'), shutil.which('nvcc')]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels are built from source at first use')


def source_digest(source: Path, flags: tuple[str, ...]) -> str:
    """The content address of a kernel library: source and flags, hashed."""
    return hashlib.sha256(source.read_bytes() + ' '.join(flags).encode()).hexdigest()[:16]


def build_digest() -> str:
    """The digest ``build()`` names K1's library by, read without building
    it (so a changed K1 is raced again by ``mode='auto'``)."""
    return source_digest(SOURCE, NVCC_FLAGS)


def autotune_candidate(device: torch.device) -> bool:
    """Whether ``mode='auto'``'s race times K1 (``mode='pallas'``): on a
    CUDA device only. On the CPU the wrapper runs its plain version, which is
    the race's ``level`` candidate already; the reference's
    ``DA4ML_PALLAS_AUTOTUNE`` asks for Pallas's interpret mode, a code path
    the port does not have."""
    return device.type == 'cuda'


def compile_source(source: Path, flags: tuple[str, ...]) -> tuple[Path, str]:
    """Compile one kernel source with nvcc into a shared library under
    ``BUILD_DIR``, content-addressed by source and flags: ``(path, nvcc's
    diagnostics)``. The diagnostics are kept beside the library, so a build
    that already exists returns those of the run that made it. Raises with
    nvcc's output on failure."""
    out = BUILD_DIR / f'lib{source.stem}_{source_digest(source, flags)}.so'
    log_path = out.with_suffix('.log')
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ''
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
    proc = subprocess.run([_nvcc(), *flags, '-o', str(tmp), str(source)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed on {source.name} with exit code {proc.returncode}:\n{log}')
    tmp_log = out.with_name(f'{out.stem}.{os.getpid()}.tmp.log')
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, out)
    return out, log


def build() -> Path:
    """Compile ``csrc/dais_exec.cu`` for sm_90a (no-op when this source and
    these flags are already built); raises with nvcc's output on failure."""
    global build_log
    out, log = compile_source(SOURCE, NVCC_FLAGS)
    if log:
        build_log = log
    return out


def load_library(build_fn, declare) -> ctypes.CDLL:
    """The library ``build_fn()`` builds, loaded once per process with its C
    signatures declared by ``declare(lib)``."""
    with _lib_lock:
        lib = _libs.get(build_fn)
        if lib is None:
            lib = ctypes.CDLL(str(build_fn()))
            declare(lib)
            _libs[build_fn] = lib
        return lib


def _declare(lib) -> None:
    vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.dais_exec_launch.restype = ci
    lib.dais_exec_launch.argtypes = [ci] * 3 + [vp] * 8 + [ctypes.c_longlong] + [ci] * 7 + [vp]
    lib.dais_exec_occupancy.restype = ci
    lib.dais_exec_occupancy.argtypes = [ci] * 6 + [pi]
    lib.dais_device_smem.restype = ci
    lib.dais_device_smem.argtypes = [ci] + [pi] * 3
    lib.dais_error_string.restype = ctypes.c_char_p
    lib.dais_error_string.argtypes = [ci]


def load():
    """The built kernel library, with its C signatures declared."""
    return load_library(build, _declare)


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{what} failed: CUDA error {rc} ({lib.dais_error_string(rc).decode()})')


_smem: dict[int, tuple[int, int, int]] = {}


def device_smem(device: torch.device) -> tuple[int, int, int]:
    """Shared memory of ``device`` in bytes: (per block, per SM, reserved per block)."""
    if device.index not in _smem:
        lib = load()
        vals = [ctypes.c_int(0) for _ in range(3)]
        _check(lib, lib.dais_device_smem(device.index, *(ctypes.byref(v) for v in vals)), 'cudaDeviceGetAttribute')
        _smem[device.index] = tuple(v.value for v in vals)
    return _smem[device.index]


# ---------------------------------------------------------------------------
# host-side program data
# ---------------------------------------------------------------------------


def phase_bounds(schedule, max_ops: int) -> list[tuple[int, int]]:
    """The kernel's phases as ``(start, end)`` positions of the packed order:
    each level, split into the fewest near-equal chunks of at most
    ``max_ops`` ops. A phase never straddles two levels, so no op reads a
    value written in its own phase."""
    out = []
    starts = [int(v) for v in schedule.starts]
    for s, e in zip(starts[:-1], starts[1:]):
        k = -(-(e - s) // max_ops)
        cuts = [s + (e - s) * i // k for i in range(k + 1)]
        out += list(zip(cuts[:-1], cuts[1:]))
    return out


def assign_slots(prog, order: np.ndarray, phases: list[tuple[int, int]]) -> tuple[np.ndarray, int]:
    """Buffer slot of every op by operand liveness over the ``phases`` of
    the packed ``order``.

    The warps of a tile run a phase's ops in no fixed order, so a value's
    slot is freed only at the barrier after the phase of its last reader,
    and taken again no earlier than the next phase; a value nothing reads
    holds its slot to the end of its own phase, and the values ``out_idxs``
    names to the end of the program. Returns ``(slot per op, n_slots)``.
    """
    n = prog.n_ops
    order = np.asarray(order, dtype=np.int64)
    phase_of = np.zeros(n, dtype=np.int64)  # by packed position
    for p, (s, e) in enumerate(phases):
        phase_of[s:e] = p
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n, dtype=np.int64)
    readers, operands = operand_edges(prog.opcode, prog.id0, prog.id1, prog.data_lo)
    last = phase_of[pos]  # the phase to the end of which each op's slot is held
    if len(operands):
        np.maximum.at(last, operands, phase_of[pos[readers]])
    last[prog.out_idxs[prog.out_idxs >= 0].astype(np.int64)] = len(phases)

    release: list[list[int]] = [[] for _ in range(len(phases) + 1)]
    for j, p in enumerate(last.tolist()):
        release[p].append(j)
    slot = np.zeros(n, dtype=np.int64)
    free: list[int] = []
    n_slots = 0
    for p, (s, e) in enumerate(phases):
        for i in order[s:e].tolist():
            if free:
                slot[i] = free.pop()
            else:
                slot[i], n_slots = n_slots, n_slots + 1
        free += [int(slot[j]) for j in release[p]]
    return slot, max(n_slots, 1)


def wide_records(ex, slot: np.ndarray) -> np.ndarray:
    """Every op's fields (``WIDE_DTYPE``) in packed order, with the plain
    version's constants cast to the executor's dtype the way numpy casts them
    there: a pow2 multiplier for a shift of ``bits`` or more wraps to 0, and
    ``2**(bits - 1)`` to the most negative value; right shifts are clamped to
    ``bits - 1``; signs fold into the multipliers."""
    prog, m = ex.prog, ex.meta
    n = prog.n_ops
    bits = 64 if ex.use_i64 else 32

    def tcast(a):
        return np.asarray(a).astype(np.int64).astype(ex.np_dtype).astype(np.int64)

    def pow2(s):
        return tcast(np.int64(1) << np.maximum(np.asarray(s, np.int64), 0))

    def rsh(s):
        return np.minimum(np.maximum(np.asarray(s, np.int64), 0), bits - 1)

    def sign(flags):
        return np.where(np.asarray(flags) != 0, -1, 1).astype(np.int64)

    def safe(ids):
        return slot[np.clip(np.asarray(ids, np.int64), 0, max(n - 1, 0))]

    def i64(name):
        return m[name].astype(np.int64)

    fam = np.array([LOWERINGS[OP_TABLE[b].lower] for b in m['branch'].tolist()], dtype=np.int64)
    rec = np.zeros(n, dtype=WIDE_DTYPE)
    rec['fam'] = fam
    rec['dst'] = slot
    rec['a'] = np.where(fam == LOWERINGS['copy'], i64('id0'), safe(m['id0']))
    rec['b'] = safe(m['id1'])
    rec['c'] = safe(m['dlo'])
    rec['w'] = m['w']
    rec['sg'] = m['sg']

    a_shift, q_shift = i64('a_shift'), i64('f') - i64('f0')
    k0, k1, k2, k3, aux = (np.zeros(n, np.int64) for _ in range(5))

    def put(family: str, **cols):
        sel = fam == LOWERINGS[family]
        for name, col in cols.items():
            {'k0': k0, 'k1': k1, 'k2': k2, 'k3': k3, 'aux': aux}[name][sel] = np.asarray(col)[sel]

    put('addsub', k0=pow2(-a_shift), k1=tcast(sign(m['issub']) * pow2(a_shift)), aux=rsh(i64('g_shift')))
    for family in ('relu', 'quantize'):
        put(family, k0=sign(m['neg']), k1=pow2(q_shift), aux=rsh(-q_shift))
    put('const_add', k1=pow2(q_shift), aux=rsh(-q_shift), k2=tcast(m['const']))
    put('const', k2=tcast(m['const']))
    put(
        'msb_mux', k0=sign(m['neg']), k1=pow2(i64('mux_s0')), k2=pow2(i64('mux_s1')), k3=pow2(i64('wc') - 1),
        aux=rsh(-i64('mux_s0')) | (rsh(-i64('mux_s1')) << 8) | ((m['sgc'] != 0).astype(np.int64) << 16),
    )  # fmt: skip
    put(
        'lookup', k0=tcast(i64('lut_zero') + i64('dhi') - i64('tab_off')), k1=tcast(m['tab_off']),
        k2=tcast(m['tab_end']),
    )  # fmt: skip
    dlo = i64('dlo')
    put('bit_unary', k0=sign(m['neg']), k1=tcast(m['mask0']), aux=np.where(dlo == 0, 0, np.where(dlo == 1, 1, 2)))
    so = i64('bb_subop')
    put(
        'bit_binary', k0=sign(m['bb_neg0']), k1=sign(m['bb_neg1']), k2=pow2(a_shift), k3=pow2(-a_shift),
        aux=(a_shift > 0).astype(np.int64) | (np.where(so == 0, 0, np.where(so == 1, 1, 2)) << 8),
    )  # fmt: skip
    for name, col in (('k0', k0), ('k1', k1), ('k2', k2), ('k3', k3), ('aux', aux)):
        rec[name] = col
    return rec[ex.schedule.order.astype(np.int64)]


def slot_unit(n_slots: int, itemsize: int) -> int:
    """What a record's slot field counts in: bytes (``TILE x itemsize`` a
    slot, the byte offset of the slot in a sample's column) when the tile's
    buffer fits ``TILE_BYTES_ON_CHIP`` and lives in shared memory, else slots
    (the global-memory path)."""
    return TILE * itemsize if n_slots * TILE * itemsize <= TILE_BYTES_ON_CHIP else 1


def slot_fields(wide: np.ndarray, unit: int = 1) -> dict[str, np.ndarray]:
    """The slot fields of ``wide_records``' rows as the records hold them, in
    ``unit`` (``slot_unit``): ``dst``, ``a`` (a copy's input column, which is
    not scaled), ``b``, and ``c``, the third operand's slot, which only the
    pool families have."""
    copy = wide['fam'] == LOWERINGS['copy']
    pool = ~np.isin(wide['fam'], [LOWERINGS[f] for f in COMPACT])
    return {'dst': wide['dst'] * unit, 'a': np.where(copy, wide['a'], wide['a'] * unit), 'b': wide['b'] * unit,
            'c': np.where(pool, wide['c'] * unit, 0)}  # fmt: skip


def field_bits(wide: np.ndarray, unit: int = 1) -> int:
    """The record layout ``wide_records``' rows need: 16 when every slot
    field fits 16 bits, else 24 (``pack_records``)."""
    return 16 if all(len(v) == 0 or v.max() <= FIELD_MAX[16] for v in slot_fields(wide, unit).values()) else 24


def pack_records(wide: np.ndarray, bits: int, unit: int = 1, fbits: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """``(records, pool)``: the 16-byte records (``REC_DTYPES[bits]``) and
    the constant pool (``EXT_DTYPES[bits]``, one entry per record) of
    ``wide_records``' rows, their slot fields in ``unit`` (``slot_unit``),
    in the ``fbits`` layout: 16, each field whole in the record, or 24, its
    low 16 bits in the record and bits 16-23 in the pool entry's ``hi`` word
    (``HI_BYTE``).

    An addsub is ``(x * k + y * s) >> r`` with ``s`` = +1 or -1: the host
    puts the operand whose pow2 multiplier is not 1 first (for a left shift
    of the second operand, the two swap), so one multiplier in the
    executor's width suffices. A relu or quantize is ``wrap((x * s) * k >>
    r)``, the relu's sign test on ``x * s``. The wrap width is clamped to
    ``[0, bits]``, which keeps its meaning (no wrap at ``bits`` or more; the
    constant ``-sg`` at 0 or less). Raises when a slot or input column does
    not fit ``fbits`` bits.
    """
    fam = wide['fam']
    n = len(wide)
    rec = np.zeros(n, dtype=REC_DTYPES[bits])
    ext = np.zeros(n, dtype=EXT_DTYPES[bits])
    is_fam = {name: fam == LOWERINGS[name] for name in LOWERINGS}
    wide = wide.copy()
    for name, v in slot_fields(wide, unit).items():
        if n and (v.min() < 0 or v.max() > FIELD_MAX[fbits]):
            raise ValueError(f'DAIS kernel: field {name} ({v.max()}) does not fit the {fbits}-bit record fields')
        wide[name] = v
    addsub = is_fam['addsub']
    swap = addsub & (wide['k1'] != 1) & (wide['k1'] != -1)
    if (swap & (wide['k0'] != 1)).any():
        raise ValueError('DAIS kernel: an addsub scales both operands')
    full = {'dst': wide['dst'], 'a': np.where(swap, wide['b'], wide['a']), 'b': np.where(swap, wide['a'], wide['b']),
            'c': wide['c']}  # fmt: skip
    for name in ('dst', 'a', 'b'):
        rec[name] = full[name] & 0xFFFF
    k = np.where(swap, wide['k1'], np.where(addsub, wide['k0'], wide['k1']))
    s = np.where(swap, 1, np.where(addsub, wide['k1'], wide['k0']))
    compact = np.isin(fam, [LOWERINGS[f] for f in COMPACT])
    s = np.where(compact & ~is_fam['copy'], s, 1)
    k = np.where(compact & ~is_fam['copy'], k, 0)
    ctl = (wide['aux'] & 63) | (np.clip(wide['w'], 0, bits) << 6) | ((wide['sg'] != 0) << 13) | ((s == -1) << 14)
    rec['ctl'] = np.where(compact, ctl, full['c'] & 0xFFFF)
    rec['k'] = k
    if bits == 32:
        rec['s'] = s
    for name in ('k0', 'k1', 'k2', 'k3', 'aux', 'w', 'sg'):
        ext[name] = np.where(compact, 0, wide[name])
    if fbits == 24:
        ext['hi'] = sum(((full[f] >> 16) & 0xFF) << (8 * HI_BYTE[f]) for f in HI_BYTE)
    return rec, ext


def phase_tables(phases: list[tuple[int, int]], fam: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(phase table, group table)`` of the kernel: per phase ``(first
    record, records, first group, groups)`` (int32, 4 a phase), and per group
    — a run of one family inside a phase — ``family | start << 8 | length
    << 20``, start relative to its phase. ``fam`` is the family of each
    record, in packed order."""
    table, groups = [], []
    for s, e in phases:
        cuts = [s, *(s + 1 + np.flatnonzero(np.diff(fam[s:e]))).tolist(), e]
        table.append((s, e - s, len(groups), len(cuts) - 1))
        groups += [int(fam[a]) | (a - s) << 8 | (b - a) << 20 for a, b in zip(cuts[:-1], cuts[1:])]
    return np.array(table, np.int32).reshape(-1, 4), np.array(groups, np.int32)


def phase_stream(table: np.ndarray, groups: np.ndarray, rec: np.ndarray, ext: np.ndarray):
    """``(stream, offsets, pool)``: what the kernel copies, one phase at a
    time, as 16-byte units (uint32, 4 a unit); per phase the first unit and
    the units of its block; and the constant pool in the stream's record
    order. A phase's block is a header (groups, the index of its first record
    in the pool, and the first unit and units of the block ``STAGES`` phases
    on, which the kernel copies next into the same buffer), its group words
    (family | start << 8 | length << 20) padded to whole units, then its
    records. Each group is padded to a multiple of ``UNROLL`` records by
    repeating its last record, which computes and stores the same value
    again."""
    words = rec.view(np.uint32).reshape(-1, 4)
    blocks, offsets, pools, at, r_at = [], [], [], 0, 0
    for r0, n, g0, ng in table.tolist():
        idx, gw = [], []
        for g in groups[g0 : g0 + ng].tolist():
            start, length = r0 + ((g >> 8) & 0xFFF), g >> 20
            padded = -(-length // UNROLL) * UNROLL
            gw.append((g & 0xFF) | len(idx) << 8 | padded << 20)
            idx += list(range(start, start + length)) + [start + length - 1] * (padded - length)
        head = np.zeros((1 + -(-ng // 4), 4), np.uint32)
        head[0, :2] = ng, r_at
        head.reshape(-1)[4 : 4 + ng] = np.array(gw, np.int64).astype(np.uint32)
        blocks += [head, words[idx]]
        pools.append(ext[idx])
        offsets.append((at, len(head) + len(idx)))
        at, r_at = at + len(head) + len(idx), r_at + len(idx)
    for p in range(len(offsets) - STAGES):
        blocks[2 * p][0, 2:] = offsets[p + STAGES]
    stream = np.concatenate(blocks) if blocks else np.zeros((0, 4), np.uint32)
    pool = np.concatenate(pools) if pools else ext[:0]
    return stream, np.array(offsets, np.int32).reshape(-1, 2), pool


def record_ops(fam: np.ndarray, rec: np.ndarray, ext: np.ndarray, bits: int) -> np.ndarray:
    """The fewest integer ALU instructions each op record needs per sample —
    the operation count of the kernel's bound. ``fam`` is each record's
    family; ``rec`` and ``ext`` are ``pack_records``' output.

    Only what the record's constants make non-trivial counts: a pow2
    multiplier of 1 is no shift, a sign of +1 no negation, a right shift of 0
    none. A multiply or shift and the add or negation beside it count as one
    (IMAD / LEA); a wrap costs a mask when unsigned, a shift pair when signed,
    nothing at full width; a compare and its select count as two. Loads and
    stores are not counted.
    """
    fam = np.asarray(fam, np.int64)
    ctl = rec['ctl'].astype(np.int64)
    compact = np.isin(fam, [LOWERINGS[f] for f in COMPACT])
    r = np.where(compact, ctl & 63, ext['aux'].astype(np.int64))
    neg = (ctl >> 14) & 1
    w = np.where(compact, (ctl >> 6) & 127, ext['w'].astype(np.int64))
    sg = np.where(compact, (ctl >> 13) & 1, ext['sg'].astype(np.int64))
    k = rec['k'].astype(np.int64)
    k0, k1, k2, k3 = (ext[f].astype(np.int64) for f in ('k0', 'k1', 'k2', 'k3'))
    wrap = np.where((w >= bits) | (w <= 0), 0, np.where(sg != 0, 2, 1))
    scaled = ((neg != 0) | (k != 1)).astype(np.int64)  # (-x) << l, one IMAD
    mux0 = wrap + (k1 != 1) + ((r & 0xFF) > 0)
    mux1 = wrap + ((k0 != 1) | (k2 != 1)) + (((r >> 8) & 0xFF) > 0)
    apos = (r & 1) != 0
    counts = {
        'copy': wrap,
        'addsub': 1 + (r > 0),
        'relu': scaled + (r > 0) + wrap + 2,
        'quantize': scaled + (r > 0) + wrap,
        'const_add': 1 + (r > 0),
        'const': 0,
        'msb_mux': 2 + mux0 + mux1,
        'mul': 1,
        'lookup': (k0 != 0) + 2,
        'bit_unary': (k0 != 1) + np.where(r == 2, 2, 1),
        'bit_binary': 1 + ((k0 != 1) | (~apos & (k3 != 1))) + ((k1 != 1) | (apos & (k2 != 1))),
    }
    ops = np.zeros(len(rec), dtype=np.int64)
    for name, count in counts.items():
        sel = fam == LOWERINGS[name]
        ops[sel] = np.broadcast_to(count, ops.shape)[sel]
    return ops


class Geometry(NamedTuple):
    """A program's launch shape on one device (``launch_geometry``)."""

    tiles: int  # sample tiles per block
    warps: int  # warps that share a tile (G)
    stage_units: int  # 16-byte units of one buffer of a tile's record stage
    smem: int  # dynamic shared memory per block, bytes
    scratch_rows: int | None  # rows per launch of the global-memory path; None: the buffer is in shared memory
    resident_warps: int  # warps per SM the shared memory and thread limits allow

    @property
    def threads(self) -> int:
        return TILE * self.tiles * self.warps


def tile_region(n_slots: int, itemsize: int, stage_units: int, on_chip: bool) -> int:
    """Bytes of one tile's shared-memory region: its record stage's barriers
    and ``STAGES`` buffers of ``stage_units`` 16-byte units, then its operand
    buffer (``n_slots`` x ``TILE`` values) on the shared-memory path."""
    head = -(-8 * STAGES // 16) * 16
    return head + STAGES * stage_units * 16 + (n_slots * TILE * itemsize if on_chip else 0)


def launch_geometry(n_slots: int, itemsize: int, phase_widths, smem: tuple[int, int, int]) -> Geometry:
    """The launch shape of a program with ``n_slots`` buffer slots and the
    given phase widths (ops per phase) on a device with shared memory
    ``smem`` (``device_smem``).

    G, the warps that share a tile, is what the widest phase fills at
    ``UNROLL`` ops a warp, at most ``MAX_WARPS``. The buffer is in
    shared memory when it fits ``TILE_BYTES_ON_CHIP`` (``slot_unit``) and a
    block. A tile's stage
    holds the widest phase's block (``STAGE_EXTRA`` units beside its
    records). The tiles per block, at most ``MAX_TILES``, are those that keep
    the most warps resident per SM (ties to fewer tiles), counting shared
    memory (per block, per SM, the reserve per block), ``MAX_THREADS`` per
    block, 2048 threads and 32 blocks per SM. A program whose one tile does
    not fit a block keeps its buffer in a global-memory scratch instead, in
    launches of ``scratch_rows`` rows within ``SCRATCH_BYTES``.
    """
    per_block, per_sm, reserved = smem
    widest = max([int(w) for w in phase_widths] or [1])
    warps = min(MAX_WARPS, max(1, -(-widest // UNROLL)))
    units = widest + STAGE_EXTRA
    on_chip = slot_unit(n_slots, itemsize) > 1 and tile_region(n_slots, itemsize, units, True) <= per_block
    region = tile_region(n_slots, itemsize, units, on_chip)
    best = None
    for tiles in range(1, min(MAX_TILES, MAX_THREADS // (TILE * warps)) + 1):
        need = tiles * region
        if need > per_block:
            break
        blocks = min(32, per_sm // (need + reserved), 2048 // (TILE * warps * tiles))
        resident = min(64, blocks * tiles * warps)
        if best is None or resident > best.resident_warps:
            best = Geometry(tiles, warps, units, need, None, resident)
    if on_chip:
        return best
    rows_per_block = TILE * best.tiles
    rows = max(rows_per_block, SCRATCH_BYTES // (n_slots * itemsize) // rows_per_block * rows_per_block)
    return best._replace(scratch_rows=rows)


class KernelData(NamedTuple):
    """A program's data for the kernel (:func:`pack`)."""

    phases: list[tuple[int, int]]  # (start, end) of each phase in the packed order
    slot: np.ndarray  # buffer slot of each op
    n_slots: int
    fam: np.ndarray  # family of each record, in packed order
    slot_unit: int  # what a slot field counts in (``slot_unit``)
    field_bits: int  # 16 or 24 (``field_bits``)
    records: np.ndarray
    pool: np.ndarray
    phase_table: np.ndarray
    groups: np.ndarray
    stream: np.ndarray
    offsets: np.ndarray
    stream_pool: np.ndarray
    outs: np.ndarray  # per output: slot field, sign
    table: np.ndarray  # the flat lookup tables
    int_ops_per_sample: int  # ``record_ops`` summed over the records


def pack(ex) -> KernelData:
    """The kernel's data for executor ``ex``'s program: phases, slots by
    phase liveness, records and the stream the kernel copies."""
    prog, itemsize = ex.prog, np.dtype(ex.np_dtype).itemsize
    phases = phase_bounds(ex.schedule, PHASE_OPS)
    slot, n_slots = assign_slots(prog, ex.schedule.order, phases)
    wide = wide_records(ex, slot)
    unit = slot_unit(n_slots, itemsize)
    fbits = field_bits(wide, unit)
    records, pool = pack_records(wide, 8 * itemsize, unit, fbits)
    phase_table, groups = phase_tables(phases, wide['fam'])
    stream, offsets, stream_pool = phase_stream(phase_table, groups, records, pool)
    out_idx = prog.out_idxs.astype(np.int64)
    outs = np.stack(
        [np.where(out_idx >= 0, slot[np.clip(out_idx, 0, max(prog.n_ops - 1, 0))], 0),
         np.where(out_idx < 0, 0, np.where(prog.out_negs != 0, -1, 1))], axis=1,
    ).astype(np.int64) if prog.n_ops else np.zeros((prog.n_out, 2), np.int64)  # fmt: skip
    outs[:, 0] *= unit
    int_ops = int(record_ops(wide['fam'], records, pool, 8 * itemsize).sum())
    return KernelData(phases, slot, n_slots, wide['fam'], unit, fbits, records, pool, phase_table, groups, stream,
                      offsets, stream_pool, outs, np.ascontiguousarray(ex.meta['flat_tab']), int_ops)  # fmt: skip


class DaisKernel:
    """The CUDA kernel's wrapper for one :class:`DaisExecutor`.

    ``kernel(x)`` maps a (batch, n_in) integer tensor to (batch, n_out). A
    CPU tensor runs the plain ``level`` version; a CUDA tensor launches the
    kernel, or raises — there is no fallback. The kernel's program data
    (``data``: phases, slots, records, the stream) is built at the first
    launch or the first read of ``data``, so a CPU executor never builds it.
    """

    def __init__(self, ex):
        self._ex = ex
        self.plain = ex.plain
        self.dtype, self.itemsize = ex.dtype, np.dtype(ex.np_dtype).itemsize
        self.bits = 8 * self.itemsize
        self.n_in, self.n_out, self.n_ops = ex.prog.n_in, ex.prog.n_out, ex.prog.n_ops
        self._dev: dict[torch.device, tuple] = {}
        self._built = False

    @functools.cached_property
    def data(self) -> KernelData:
        return pack(self._ex)

    @property
    def record_bytes(self) -> float:
        """Bytes of its record and pool entry one op of a tile reads: the
        16-byte record, plus for a pool family its whole pool entry, plus in
        the 24-bit layout the ``hi`` word of a compact family's entry (the
        mean over the program's ops)."""
        d = self.data
        compact = np.isin(d.fam, [LOWERINGS[f] for f in COMPACT])
        extra = np.where(compact, 4 if d.field_bits == 24 else 0, d.pool.dtype.itemsize)
        return d.records.dtype.itemsize + float(extra.mean() if len(extra) else 0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == 'cpu':
            return self.plain(x)
        if x.device.type != 'cuda':
            raise ValueError(f'the DAIS kernel runs on CUDA tensors (CPU: its plain version), got {x.device}')
        return self.launch(x)

    @property
    def phase_widths(self) -> list[int]:
        return [e - s for s, e in self.data.phases]

    def geometry(self, device: torch.device) -> Geometry:
        """``launch_geometry`` of this program on ``device``."""
        return launch_geometry(self.data.n_slots, self.itemsize, self.phase_widths, device_smem(device))

    def occupancy(self, device: torch.device) -> int:
        """Warps per SM resident at once, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
        reports it for this program's geometry (registers included)."""
        g = self.geometry(device)
        lib = load()
        blocks = ctypes.c_int(0)
        rc = lib.dais_exec_occupancy(device.index, self.bits == 64, g.scratch_rows is not None,
                                     self.data.field_bits == 24, g.threads, g.smem, ctypes.byref(blocks))  # fmt: skip
        _check(lib, rc, 'cudaOccupancyMaxActiveBlocksPerMultiprocessor')
        return blocks.value * g.tiles * g.warps

    def _on(self, device: torch.device) -> tuple:
        hit = self._dev.get(device)
        if hit is None:

            def move(a):
                return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)).to(device)

            d = self.data
            hit = self._dev[device] = tuple(move(a) for a in (d.stream, d.offsets, d.stream_pool, d.outs, d.table))
        return hit

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        global launches, scratch_launches
        if x.dtype != self.dtype or x.dim() != 2 or x.shape[1] != self.n_in:
            raise ValueError(f'DAIS kernel takes a (batch, {self.n_in}) {self.dtype} tensor, got {x.dtype} {tuple(x.shape)}')
        if not x.is_contiguous():
            raise ValueError('DAIS kernel takes a contiguous input tensor')
        device = torch.device('cuda', x.device.index if x.device.index is not None else torch.cuda.current_device())
        batch = x.shape[0]
        y = torch.empty((batch, self.n_out), dtype=self.dtype, device=device)
        if batch == 0 or self.n_out == 0:
            return y
        t_build = time.perf_counter()
        lib, d = load(), self.data
        stream_, offsets, pool, outs, tab = (t.data_ptr() for t in self._on(device))
        g = self.geometry(device)
        if (g.scratch_rows is None) != (d.slot_unit > 1):
            raise ValueError(f'DAIS kernel: a {d.n_slots}-slot tile does not fit this device\'s shared memory')
        if not self._built:
            self._built = True
            if telemetry.metrics_on():
                telemetry.histogram('run.pallas.compile_s').observe(time.perf_counter() - t_build)
                telemetry.histogram('run.pallas.vmem_bytes', telemetry.BYTES_BUCKETS).observe(g.smem)
        stream = torch.cuda.current_stream(device).cuda_stream

        def run(r0: int, n: int, scratch) -> None:
            rc = lib.dais_exec_launch(
                device.index, self.bits == 64, d.field_bits == 24, stream_, offsets, pool, x[r0:].data_ptr(), outs,
                y[r0:].data_ptr(), tab, scratch, n, max(self.n_in, 1), self.n_out, len(d.phases), d.n_slots,
                g.tiles, g.warps, g.stage_units, stream,
            )  # fmt: skip
            _check(lib, rc, 'dais_exec launch' if scratch is None else 'dais_exec launch (global-memory scratch)')

        if g.scratch_rows is None:
            run(0, batch, None)
            launches += 1
            return y
        per_launch = TILE * g.tiles
        rows = min(g.scratch_rows, -(-batch // per_launch) * per_launch)  # no more scratch than the batch takes
        scratch = torch.empty(rows * d.n_slots, dtype=self.dtype, device=device)
        for r0 in range(0, batch, rows):
            run(r0, min(rows, batch - r0), scratch.data_ptr())
            launches += 1
            scratch_launches += 1
        return y

    def work(self, batch: int) -> tuple[int, int]:
        """(bytes, integer ALU operations) the function needs for ``batch``
        samples: each input read once, each output written once; the ALU
        instructions ``record_ops`` counts for every op, per sample."""
        return (self.n_in + self.n_out) * self.itemsize * batch, self.data.int_ops_per_sample * batch
