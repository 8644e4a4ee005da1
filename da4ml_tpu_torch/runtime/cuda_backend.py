"""The hand-written CUDA kernel that executes DAIS programs — wrapper, build
and host-side op records.

``csrc/dais_exec.cu`` replaces ``da4ml_tpu/runtime/pallas_backend.py::
build_pallas_fn`` (the TPU's Pallas mega-kernel). It is one table-driven
kernel, compiled once for int32 and int64 with ``nvcc`` for ``sm_90a`` into
``build/da4ml_tpu_torch/`` at first use and loaded with ``ctypes``; a
program is data, not code. This module turns a :class:`DaisExecutor`'s
program into that data:

- the packed order is ``levelize_program(prog, sort_key=family)``, the order
  ``build_pallas_fn`` walks;
- buffer slots are assigned by operand liveness — a linear scan over the
  packed order that frees a slot after its last reader; ops named by
  ``out_idxs`` stay live to the end — so the on-chip buffer holds about the
  program's ``peak_live`` slots instead of one slot per op;
- each op becomes a 64-byte record (family id and the ops left in its
  (level, family) group, operand slots, width/signed, pow2 multipliers,
  clamped right shifts, constants, LUT offsets) built from ``op_meta``, with
  the same constants the plain ``level`` version uses.

What bounds the kernel on an H100, and what the design does about it, is in
the source's header note.

:class:`DaisKernel` is the wrapper. On a CUDA tensor it launches the kernel
on the current stream, or raises; on a CPU tensor it runs the plain
``level`` version (``torch_backend.LevelPlan``). It counts its launches in
the module-level ``launches`` (``scratch_launches`` counts those that kept
the buffer in global memory because the program was too wide for shared
memory).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..ir.optable import OP_TABLE
from ..ir.schedule import operand_edges
from .torch_backend import level_groups

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

def _audit() -> None:
    """Two-way audit of the opcode table's ``lower`` column against the
    kernel's family switch: every row names a family of the switch, every
    family of the switch is named by a row, and the ids agree with the
    source's enum and ``case`` labels."""
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
    for const, val in (('kChunk', RECORD_CHUNK), ('kUnroll', UNROLL)):
        if f'constexpr int32_t {const} = {val};' not in src:
            raise RuntimeError(f'{SOURCE.name}: {const} disagrees with {val}')


REC_DTYPE = np.dtype(
    [('fam', '<i4'), ('dst', '<i4'), ('a', '<i4'), ('b', '<i4'), ('c', '<i4'), ('w', '<i4'), ('sg', '<i4'),
     ('aux', '<i4'), ('k0', '<i8'), ('k1', '<i8'), ('k2', '<i8'), ('k3', '<i8')]
)  # fmt: skip
assert REC_DTYPE.itemsize == 64, 'OpRec is 64 bytes in csrc/dais_exec.cu'

#: op records the kernel stages through shared memory at a time (``kChunk``
#: in the source): a static 4 KB of shared memory per block beside the buffer
RECORD_CHUNK = 64
#: ops of one (level, family) group the kernel evaluates together
#: (``kUnroll``): all read their operands before any writes its result
UNROLL = 4

#: global-memory scratch budget of the chunked path for programs too wide
#: for shared memory
SCRATCH_BYTES = 256 << 20

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


def compile_source(source: Path, flags: tuple[str, ...]) -> tuple[Path, str]:
    """Compile one kernel source with nvcc into a shared library under
    ``BUILD_DIR``, content-addressed by source and flags: ``(path, nvcc's
    diagnostics)``, the diagnostics empty when that build already exists.
    Raises with nvcc's output on failure."""
    digest = hashlib.sha256(source.read_bytes() + ' '.join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f'lib{source.stem}_{digest}.so'
    if out.exists():
        return out, ''
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
    proc = subprocess.run([_nvcc(), *flags, '-o', str(tmp), str(source)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed on {source.name} with exit code {proc.returncode}:\n{log}')
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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ('dais_exec_i32', 'dais_exec_i64'):
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = [ci, vp, ci, vp, ci, vp, ci, vp, vp, ctypes.c_longlong, ci, ci, vp, vp]
    lib.dais_device_smem.restype = ci
    lib.dais_device_smem.argtypes = [ci] + [ctypes.POINTER(ci)] * 3
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


def assign_slots(prog, order: np.ndarray) -> tuple[np.ndarray, int]:
    """Buffer slot of every op by operand liveness over the packed ``order``.

    A slot is freed at the packed position of its op's last reader (before
    that op's result is placed, which is safe: a thread reads its operands
    before it writes); ops that no op reads and no output names are freed
    right after they are written. Returns ``(slot per op, n_slots)``.
    """
    n = prog.n_ops
    order = np.asarray(order, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n, dtype=np.int64)
    readers, operands = operand_edges(prog.opcode, prog.id0, prog.id1, prog.data_lo)
    last = np.full(n, -1, dtype=np.int64)
    if len(operands):
        np.maximum.at(last, operands, pos[readers])
    outs = prog.out_idxs[prog.out_idxs >= 0].astype(np.int64)
    last[outs] = n  # outputs stay live to the end

    release: list[list[int]] = [[] for _ in range(n)]
    for j in np.flatnonzero((last >= 0) & (last < n)).tolist():
        release[int(last[j])].append(j)
    slot = np.zeros(n, dtype=np.int64)
    free: list[int] = []
    n_slots = 0
    last_l = last.tolist()
    for p, i in enumerate(order.tolist()):
        for j in release[p]:
            free.append(int(slot[j]))
        if free:
            s = free.pop()
        else:
            s, n_slots = n_slots, n_slots + 1
        slot[i] = s
        if last_l[i] < 0:  # dead op: nothing reads it
            free.append(s)
    return slot, max(n_slots, 1)


def op_records(ex, slot: np.ndarray) -> np.ndarray:
    """The kernel's op records (``REC_DTYPE``) in packed order.

    Constants are the level lowering's, cast to the executor's dtype the way
    numpy casts them there (pow2 multipliers wrap at the top bit); right
    shifts are clamped to ``bits - 1``.
    """
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
    rec = np.zeros(n, dtype=REC_DTYPE)
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
    rec = rec[ex.schedule.order.astype(np.int64)]
    # above the family id: the ops left in the op's (level, family) group
    left = np.zeros(n, dtype=np.int64)
    for s, e in level_groups(ex.schedule, m['branch'].astype(np.int64)):
        left[s:e] = np.arange(e - s, 0, -1)
    rec['fam'] |= left << 8
    return rec


def record_ops(rec: np.ndarray, bits: int) -> np.ndarray:
    """The fewest integer ALU instructions each op record needs per sample —
    the operation count of the kernel's bound.

    Only what the record's constants make non-trivial counts: a pow2
    multiplier of 1 is no shift, a sign of +1 no negation, a right shift of 0
    none. A multiply or shift and the add or negation beside it count as one
    (IMAD / LEA); a wrap costs a mask when unsigned, a shift pair when signed,
    nothing at full width; a compare and its select count as two. Loads and
    stores are not counted.
    """
    fam = rec['fam'].astype(np.int64) & 0xFF
    w, sg, aux = (rec[f].astype(np.int64) for f in ('w', 'sg', 'aux'))
    k0, k1, k2, k3 = (rec[f] for f in ('k0', 'k1', 'k2', 'k3'))
    wrap = np.where((w >= bits) | (w <= 0), 0, np.where(sg != 0, 2, 1))
    scaled = ((k0 != 1) | (k1 != 1)).astype(np.int64)  # (-x) << l, one IMAD
    mux0 = wrap + (k1 != 1) + ((aux & 0xFF) > 0)
    mux1 = wrap + ((k0 != 1) | (k2 != 1)) + (((aux >> 8) & 0xFF) > 0)
    apos = (aux & 1) != 0
    counts = {
        'copy': wrap,
        'addsub': 1 + (aux > 0),
        'relu': scaled + (aux > 0) + wrap + 2,
        'quantize': scaled + (aux > 0) + wrap,
        'const_add': 1 + (aux > 0),
        'const': 0,
        'msb_mux': 2 + mux0 + mux1,
        'mul': 1,
        'lookup': (k0 != 0) + 2,
        'bit_unary': (k0 != 1) + np.where(aux == 2, 2, 1),
        'bit_binary': 1 + ((k0 != 1) | (~apos & (k3 != 1))) + ((k1 != 1) | (apos & (k2 != 1))),
    }
    ops = np.zeros(len(rec), dtype=np.int64)
    for name, count in counts.items():
        sel = fam == LOWERINGS[name]
        ops[sel] = np.broadcast_to(count, ops.shape)[sel]
    return ops


def launch_geometry(n_slots: int, itemsize: int, smem: tuple[int, int, int]) -> tuple[int, int | None]:
    """(threads per block, scratch rows per chunk or None for the
    shared-memory path) of a program with ``n_slots`` buffer slots, on a
    device with shared memory ``smem`` (``device_smem``).

    On chip, the block size is the one of 128, 64 and 32 samples that keeps
    the most samples resident per SM (ties to the larger block): the buffer's
    size, not the thread count, bounds occupancy. A program whose buffer does
    not fit even at 32 samples keeps it in a global-memory scratch.
    """
    per_block, per_sm, reserved = smem
    best = None
    for threads in (128, 64, 32):
        need = n_slots * threads * itemsize + RECORD_CHUNK * REC_DTYPE.itemsize
        if need > per_block:
            continue
        resident = min(per_sm // (need + reserved), 32, 2048 // threads) * threads
        if best is None or resident > best[0]:
            best = (resident, threads)
    if best is not None:
        return best[1], None
    return 128, max(128, SCRATCH_BYTES // (n_slots * itemsize) // 128 * 128)


class DaisKernel:
    """The CUDA kernel's wrapper for one :class:`DaisExecutor`.

    ``kernel(x)`` maps a (batch, n_in) integer tensor to (batch, n_out). A
    CPU tensor runs the plain ``level`` version; a CUDA tensor launches the
    kernel, or raises — there is no fallback.
    """

    def __init__(self, ex):
        prog = ex.prog
        self.plain = ex.plain
        self.dtype, self.itemsize = ex.dtype, np.dtype(ex.np_dtype).itemsize
        self.n_in, self.n_out, self.n_ops = prog.n_in, prog.n_out, prog.n_ops
        self.slot, self.n_slots = assign_slots(prog, ex.schedule.order)
        self.records = op_records(ex, self.slot)
        out_idx = prog.out_idxs.astype(np.int64)
        self.outs = np.stack(
            [np.where(out_idx >= 0, self.slot[np.clip(out_idx, 0, max(self.n_ops - 1, 0))], 0),
             np.where(out_idx < 0, 0, np.where(prog.out_negs != 0, -1, 1))], axis=1,
        ).astype(np.int64) if self.n_ops else np.zeros((self.n_out, 2), np.int64)  # fmt: skip
        self.table = np.ascontiguousarray(ex.meta['flat_tab'])
        self.int_ops_per_sample = int(record_ops(self.records, 8 * self.itemsize).sum())
        self._dev: dict[torch.device, tuple] = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == 'cpu':
            return self.plain(x)
        if x.device.type != 'cuda':
            raise ValueError(f'the DAIS kernel runs on CUDA tensors (CPU: its plain version), got {x.device}')
        return self.launch(x)

    def geometry(self, device: torch.device) -> tuple[int, int | None]:
        """``launch_geometry`` of this program on ``device``."""
        return launch_geometry(self.n_slots, self.itemsize, device_smem(device))

    def _on(self, device: torch.device) -> tuple:
        hit = self._dev.get(device)
        if hit is None:
            rec = torch.from_numpy(self.records.view(np.uint8)).to(device)
            outs = torch.from_numpy(self.outs).to(device)
            tab = torch.from_numpy(self.table).to(device)
            hit = self._dev[device] = (rec, outs, tab)
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
        lib = load()
        rec, outs, tab = self._on(device)
        threads, rows = self.geometry(device)
        fn = lib.dais_exec_i64 if self.dtype == torch.int64 else lib.dais_exec_i32
        stream = torch.cuda.current_stream(device).cuda_stream
        n_in = max(self.n_in, 1)
        if rows is None:
            rc = fn(device.index, rec.data_ptr(), self.n_ops, x.data_ptr(), n_in, outs.data_ptr(), self.n_out,
                    y.data_ptr(), tab.data_ptr(), batch, self.n_slots, threads, None, stream)  # fmt: skip
            _check(lib, rc, 'dais_exec launch')
            launches += 1
            return y
        scratch = torch.empty(rows * self.n_slots, dtype=self.dtype, device=device)
        for r0 in range(0, batch, rows):
            n = min(rows, batch - r0)
            rc = fn(device.index, rec.data_ptr(), self.n_ops, x[r0:].data_ptr(), n_in, outs.data_ptr(), self.n_out,
                    y[r0:].data_ptr(), tab.data_ptr(), n, self.n_slots, threads, scratch.data_ptr(), stream)  # fmt: skip
            _check(lib, rc, 'dais_exec launch (global-memory scratch)')
            launches += 1
            scratch_launches += 1
        return y

    def work(self, batch: int) -> tuple[int, int]:
        """(bytes, integer ALU operations) the function needs for ``batch``
        samples: each input read once, each output written once; the ALU
        instructions ``record_ops`` counts for every op, per sample."""
        return (self.n_in + self.n_out) * self.itemsize * batch, self.int_ops_per_sample * batch
