"""DAIS program executor on torch tensors.

``DaisExecutor`` turns a decoded DAIS program into a batched integer kernel
and wraps it with the float boundary (input scaling/floor, output rescale),
so the kernel only ever sees fixed-point integer arithmetic: int32, or int64
when the program's widths demand it (the rule of
``da4ml_tpu/runtime/jax_backend.py:493``, copied exactly).

Execution goes through the hand-written CUDA kernel (``cuda_backend``) on a
CUDA device. Its plain version is :class:`LevelPlan`, the ``level``
lowering of ``DaisExecutor._build_level`` in ``jax_backend.py`` as torch ops:
ops are packed into dependency levels (``ir.schedule``), each (level,
family) group executes as a few vectorized torch ops — operand gathers,
shift-by-multiply against precomputed pow2 vectors, fused add/sub via a sign
vector, two's-complement wrap from per-op (width, signed) tables — and
writes its contiguous rows of the execution buffer in place. The CUDA
kernel's wrapper runs that plain version when, and only when, it is handed a
CPU tensor.

The call boundary (``__call__``) is the reference's ``_run_batch`` with the
conversion on the device: the float64 batch goes to the device, is checked
for NaN and inf, scaled, floored and cast there (``_int_inputs`` as torch
ops, bit for bit), runs through the kernel and is rescaled to float64 there.
A batch of at least two chunk budgets (``_infer_chunks``) is cut into
equal-shape chunks, the last padded and trimmed; on a CUDA device those go up
through pinned staging buffers on an upload stream and come back on a
download stream, chunk k+1's upload overlapping chunk k's kernel, events
ordering every use. A smaller batch is one ``.to(device)`` and one
``.cpu()``.

:class:`PipelineExecutor` chains the stages of a pipeline behind one such
boundary, each stage's kernel launch and the exact inter-stage shift on the
device; ``run_pipeline`` and ``fused_executor_for_binaries`` are its cached
entry points, the latter over the IR-fused program (``ir/fuse.py``).

Entry points run on the card unless the caller passes ``device='cpu'``;
``device=None`` with no CUDA device raises instead of dropping to the CPU.

Counterpart of ``DaisExecutor``, ``PipelineExecutor`` and ``run_pipeline`` in
``da4ml_tpu/runtime/jax_backend.py``, without the ``unroll``/``scan`` modes,
autotune, sharding and model-shard paths.

Telemetry, as the reference records it: each call is one ``run.call`` span
(``mode`` ``'pallas'`` — the CUDA kernel plays the reference's Pallas
kernel — or ``'level'``, its plain version on the CPU, and the pipelines'
``'pipeline-fused'`` / ``'pipeline-chained'``) whose device work runs inside
``telemetry.obs.profile.annotate('run.call')``, and one sample of the
``run.*`` metrics; ``run.device_s`` is the boundary's upload, kernel and
download, timed where the call already waits for its output.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache

import time

import numpy as np
import torch
from numpy.typing import NDArray

from .. import telemetry
from ..ir.dais_binary import DaisProgram, decode
from ..ir.optable import OP_TABLE, VECTOR_CLASS
from ..ir.schedule import LevelSchedule, levelize_program
from ..telemetry.obs import profile as _prof


class InvalidInputError(ValueError):
    """An inference batch the executor cannot take (shape, width, non-finite)."""


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another; ``None`` with no CUDA device raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'da4ml_tpu_torch runs on a CUDA device by default and none is available; '
                "pass device='cpu' to run the plain torch version on the host"
            )
        return torch.device('cuda')
    return torch.device(device)


def non_finite_error(what: str, bad: int) -> InvalidInputError:
    return InvalidInputError(f'{what}: input contains {bad} non-finite (NaN/inf) value(s)')


def validate_batch(data, n_in: int, what: str = 'DaisExecutor', finite: bool = True) -> NDArray[np.float64]:
    """Validate an inference batch before dispatch:

    - the batch must be 2-D ``(n_samples, n_features)``;
    - the feature width must match the program's ``n_in``;
    - with ``finite``, every value must be finite (NaN/inf floor to
      undefined integers); the card's boundary checks that on the card.

    Returns the batch as a float64 array.
    """
    try:
        arr = np.asarray(data, dtype=np.float64)
    except (TypeError, ValueError) as e:
        raise InvalidInputError(f'{what}: input is not a numeric array: {e}') from e
    if arr.ndim != 2:
        raise InvalidInputError(
            f'{what}: input must be 2-D (n_samples, n_features), got shape {arr.shape}; '
            f'flatten per-sample features to {n_in} columns first'
        )
    if arr.shape[1] != n_in:
        raise InvalidInputError(f'{what}: feature width mismatch: program expects {n_in} inputs, got {arr.shape[1]}')
    if finite and arr.size and not np.isfinite(arr).all():
        raise non_finite_error(what, int(np.count_nonzero(~np.isfinite(arr))))
    return arr


def op_meta(prog: DaisProgram, use_i64: bool) -> dict[str, NDArray]:
    """Gathered per-op operand metadata shared by the level lowering and the
    CUDA kernel's op records (numpy, original op order; garbage where a
    family ignores a field)."""
    np_dt = np.int64 if use_i64 else np.int32
    n_ops = prog.n_ops

    f_arr = prog.fractionals.astype(np_dt)
    sg_arr = prog.signed.astype(np_dt)
    w_arr = prog.width.astype(np_dt)
    oc_arr = prog.opcode.astype(np.int64)
    id0_arr = prog.id0.astype(np.int64)
    id1_arr = prog.id1.astype(np.int64)
    dlo_arr = prog.data_lo.astype(np.int64)
    dhi_arr = prog.data_hi.astype(np.int64)

    # dispatch class per op, generated from the opcode table
    branch_arr = np.array([VECTOR_CLASS[int(o)] for o in oc_arr], np.int32)
    neg_arr = (oc_arr < 0).astype(np_dt)
    sub_arr = (oc_arr == 1).astype(np_dt)  # subtraction is opcode +1, not a negative opcode

    safe0 = np.clip(id0_arr, 0, max(n_ops - 1, 0))
    safe1 = np.clip(id1_arr, 0, max(n_ops - 1, 0))
    f0_arr = f_arr[safe0]
    f1_arr = f_arr[safe1]
    a_shift_arr = (dlo_arr + f0_arr - f1_arr).astype(np_dt)
    g_shift_arr = (np.maximum(f0_arr, f1_arr - dlo_arr) - f_arr).astype(np_dt)
    const_arr = ((dhi_arr << 32) | (dlo_arr & 0xFFFFFFFF)).astype(np_dt)
    safec = np.clip(dlo_arr, 0, max(n_ops - 1, 0))
    sgc_arr = sg_arr[safec]
    wc_arr = w_arr[safec]
    mux_s0_arr = (f_arr - f0_arr).astype(np_dt)
    mux_s1_arr = (f_arr - f1_arr + dhi_arr).astype(np_dt)
    # lookup tables flattened with per-table offsets; index clamped within
    # its own table
    if prog.tables:
        flat_tab = np.concatenate([np.asarray(t, np_dt) for t in prog.tables])
        offs = np.cumsum([0] + [len(t) for t in prog.tables])
    else:
        flat_tab = np.zeros(1, np_dt)
        offs = np.array([0, 1])
    safet = np.clip(dlo_arr, 0, len(offs) - 2)
    tab_off_arr = offs[safet].astype(np_dt)
    tab_end_arr = (offs[safet + 1] - 1).astype(np_dt)
    lut_zero_arr = (-sg_arr[safe0] * (1 << np.maximum(w_arr[safe0] - 1, 0))).astype(np_dt)
    mask0_arr = ((1 << w_arr[safe0].astype(np.int64)) - 1).astype(np_dt)
    bb_neg0 = ((dhi_arr & 1) != 0).astype(np_dt)
    bb_neg1 = ((dhi_arr & 2) != 0).astype(np_dt)
    bb_subop = (dhi_arr >> 24).astype(np_dt)

    return {
        'branch': branch_arr, 'neg': neg_arr, 'issub': sub_arr, 'oc': oc_arr,
        'id0': id0_arr, 'id1': id1_arr, 'dlo': dlo_arr, 'dhi': dhi_arr,
        'f': f_arr, 'sg': sg_arr, 'w': w_arr, 'f0': f0_arr, 'f1': f1_arr,
        'a_shift': a_shift_arr, 'g_shift': g_shift_arr, 'const': const_arr,
        'sgc': sgc_arr, 'wc': wc_arr, 'mux_s0': mux_s0_arr, 'mux_s1': mux_s1_arr,
        'tab_off': tab_off_arr, 'tab_end': tab_end_arr, 'lut_zero': lut_zero_arr,
        'mask0': mask0_arr, 'bb_neg0': bb_neg0, 'bb_neg1': bb_neg1, 'bb_subop': bb_subop,
        'flat_tab': flat_tab,
    }  # fmt: skip


def level_groups(sched: LevelSchedule, fam: NDArray) -> list[tuple[int, int]]:
    """Contiguous (level, family) groups of the packed order, as
    ``(start, end)`` positions."""
    n_ops = len(sched.order)
    if not n_ops:
        return []
    order = sched.order.astype(np.int64)
    key = sched.level[order].astype(np.int64) * 16 + fam[order]
    cuts = (np.flatnonzero(np.diff(key)) + 1).tolist()
    bounds = [0, *cuts, n_ops]
    return list(zip(bounds[:-1], bounds[1:]))


# ---------------------------------------------------------------------------
# level lowering: one emitter per opcode-table row, keyed by OpSpec.lower.
# Each emitter runs at build time over one (level, family) group and returns
# (constants, body): numpy constants the body reads (moved to the device on
# first use) and body(buf, xT, c) -> (g, batch) block in the executor dtype.
# Semantics mirror jax_backend.DaisExecutor._build_level group for group.
# ---------------------------------------------------------------------------


class _Group:
    """Build-time context of one (level, family) group."""

    def __init__(self, m, idxs, np_dt, pos, n_ops):
        self.m, self.idxs, self.np_dt, self.pos, self.n_ops = m, idxs, np_dt, pos, n_ops

    def cvec(self, a) -> NDArray:
        """(g,) per-op constant -> (g, 1) column in the execution dtype."""
        return np.ascontiguousarray(np.asarray(a)).astype(self.np_dt)[:, None]

    def pow2(self, s) -> NDArray:
        # two's-complement multiply ≡ left shift mod 2^width, so the wrapped
        # pow2 constant is exact even at the top bit
        return (np.int64(1) << np.asarray(s, np.int64)).astype(self.np_dt)

    def shift_consts(self, s) -> tuple[NDArray, NDArray]:
        """(multiplier, right-shift) pair implementing shift-by-``s``."""
        return self.cvec(self.pow2(np.maximum(s, 0))), self.cvec(np.maximum(-s, 0))

    def wrap_consts(self) -> tuple[NDArray, NDArray]:
        w = self.m['w'][self.idxs].astype(np.int64)
        sg = self.m['sg'][self.idxs].astype(np.int64)
        mod = self.cvec(np.int64(1) << w)
        imin = self.cvec(np.where(sg != 0, -(np.int64(1) << np.maximum(w - 1, 0)), 0))
        return mod, imin

    def sign_of(self, flags) -> NDArray:
        return self.cvec(np.where(np.asarray(flags) != 0, -1, 1))

    def positions(self, ids) -> NDArray:
        """Packed buffer rows of original op ids (clipped: garbage lanes)."""
        return self.pos[np.clip(ids, 0, max(self.n_ops - 1, 0))]

    def field(self, name: str) -> NDArray:
        return self.m[name][self.idxs]


def _wrap(v, imin, mod):
    return ((v - imin) % mod) + imin


def _emit_copy(g: _Group):
    mod, imin = g.wrap_consts()
    c = {'src': g.field('id0'), 'mod': mod, 'imin': imin}

    def body(buf, xT, c):
        return _wrap(xT.index_select(0, c['src']), c['imin'], c['mod'])

    return c, body


def _emit_addsub(g: _Group):
    a = g.field('a_shift')
    c = {
        'p0': g.positions(g.field('id0')),
        'p1': g.positions(g.field('id1')),
        'l0': g.cvec(g.pow2(np.maximum(-a, 0))),
        'l1': g.cvec(g.pow2(np.maximum(a, 0))),
        'gs': g.cvec(np.maximum(g.field('g_shift'), 0)),
        'sub': g.sign_of(g.field('issub')),
    }

    def body(buf, xT, c):
        x0 = buf.index_select(0, c['p0'])
        x1 = buf.index_select(0, c['p1'])
        return (x0 * c['l0'] + x1 * c['sub'] * c['l1']) >> c['gs']

    return c, body


def _shift_wrap_emitter(relu: bool):
    def emit(g: _Group):
        ql, qr = g.shift_consts(g.field('f').astype(np.int64) - g.field('f0').astype(np.int64))
        mod, imin = g.wrap_consts()
        c = {'p0': g.positions(g.field('id0')), 'neg': g.sign_of(g.field('neg')), 'ql': ql, 'qr': qr,
             'mod': mod, 'imin': imin}  # fmt: skip

        def body(buf, xT, c):
            v = buf.index_select(0, c['p0']) * c['neg']
            q = _wrap((v * c['ql']) >> c['qr'], c['imin'], c['mod'])
            return torch.where(v < 0, torch.zeros_like(q), q) if relu else q

        return c, body

    return emit


def _emit_const_add(g: _Group):
    ql, qr = g.shift_consts(g.field('f').astype(np.int64) - g.field('f0').astype(np.int64))
    c = {'p0': g.positions(g.field('id0')), 'ql': ql, 'qr': qr, 'cst': g.cvec(g.field('const'))}

    def body(buf, xT, c):
        return ((buf.index_select(0, c['p0']) * c['ql']) >> c['qr']) + c['cst']

    return c, body


def _emit_const(g: _Group):
    c = {'cst': g.cvec(g.field('const'))}

    def body(buf, xT, c):
        return c['cst'].expand(c['cst'].shape[0], xT.shape[1])

    return c, body


def _emit_msb_mux(g: _Group):
    l0v, r0v = g.shift_consts(g.field('mux_s0'))
    l1v, r1v = g.shift_consts(g.field('mux_s1'))
    mod, imin = g.wrap_consts()
    c = {
        'p0': g.positions(g.field('id0')), 'p1': g.positions(g.field('id1')), 'pc': g.positions(g.field('dlo')),
        'neg': g.sign_of(g.field('neg')), 'sgc': g.cvec(g.field('sgc')),
        'thr': g.cvec(g.pow2(np.maximum(g.field('wc').astype(np.int64) - 1, 0))),
        'l0v': l0v, 'r0v': r0v, 'l1v': l1v, 'r1v': r1v, 'mod': mod, 'imin': imin,
    }  # fmt: skip

    def body(buf, xT, c):
        xc = buf.index_select(0, c['pc'])
        cond = torch.where(c['sgc'] != 0, xc < 0, xc >= c['thr'])
        x0 = buf.index_select(0, c['p0'])
        v1 = buf.index_select(0, c['p1']) * c['neg']
        r0 = _wrap((x0 * c['l0v']) >> c['r0v'], c['imin'], c['mod'])
        r1 = _wrap((v1 * c['l1v']) >> c['r1v'], c['imin'], c['mod'])
        return torch.where(cond, r0, r1)

    return c, body


def _emit_mul(g: _Group):
    c = {'p0': g.positions(g.field('id0')), 'p1': g.positions(g.field('id1'))}

    def body(buf, xT, c):
        return buf.index_select(0, c['p0']) * buf.index_select(0, c['p1'])

    return c, body


def _emit_lookup(g: _Group):
    c = {
        'p0': g.positions(g.field('id0')), 'lz': g.cvec(g.field('lut_zero')), 'dh': g.cvec(g.field('dhi')),
        'to': g.cvec(g.field('tab_off')), 'te': g.cvec(g.field('tab_end')), 'ft': g.m['flat_tab'],
    }  # fmt: skip

    def body(buf, xT, c):
        x0 = buf.index_select(0, c['p0'])
        index = torch.clamp(x0 - c['lz'] - c['dh'] + c['to'], c['to'], c['te'])
        return c['ft'][index.long()]

    return c, body


def _emit_bit_unary(g: _Group):
    d = g.field('dlo')
    c = {'p0': g.positions(g.field('id0')), 'neg': g.sign_of(g.field('neg')), 'mask': g.cvec(g.field('mask0')),
         'sgo': g.cvec(g.field('sg')), 'is0': g.cvec(d == 0), 'is1': g.cvec(d == 1)}  # fmt: skip

    def body(buf, xT, c):
        v = buf.index_select(0, c['p0']) * c['neg']
        r_not = torch.where(c['sgo'] != 0, ~v, (~v) & c['mask'])
        r_any = (v != 0).to(v.dtype)
        r_all = ((v & c['mask']) == c['mask']).to(v.dtype)
        return torch.where(c['is0'] != 0, r_not, torch.where(c['is1'] != 0, r_any, r_all))

    return c, body


def _emit_bit_binary(g: _Group):
    a = g.field('a_shift')
    so = g.field('bb_subop')
    c = {
        'p0': g.positions(g.field('id0')), 'p1': g.positions(g.field('id1')),
        's0': g.sign_of(g.field('bb_neg0')), 's1': g.sign_of(g.field('bb_neg1')), 'apos': g.cvec(a > 0),
        'l1v': g.cvec(g.pow2(np.maximum(a, 0))), 'l0v': g.cvec(g.pow2(np.maximum(-a, 0))),
        'so0': g.cvec(so == 0), 'so1': g.cvec(so == 1),
    }  # fmt: skip

    def body(buf, xT, c):
        v1 = buf.index_select(0, c['p0']) * c['s0']
        v2 = buf.index_select(0, c['p1']) * c['s1']
        v2 = torch.where(c['apos'] != 0, v2 * c['l1v'], v2)
        v1 = torch.where(c['apos'] != 0, v1, v1 * c['l0v'])
        return torch.where(c['so0'] != 0, v1 & v2, torch.where(c['so1'] != 0, v1 | v2, v1 ^ v2))

    return c, body


#: level-lowering registry, keyed by ``OpSpec.lower`` — the same eleven names
#: the CUDA kernel's family switch uses
LEVEL_EMITTERS: dict[str, object] = {
    'copy': _emit_copy,
    'addsub': _emit_addsub,
    'relu': _shift_wrap_emitter(relu=True),
    'quantize': _shift_wrap_emitter(relu=False),
    'const_add': _emit_const_add,
    'const': _emit_const,
    'msb_mux': _emit_msb_mux,
    'mul': _emit_mul,
    'lookup': _emit_lookup,
    'bit_unary': _emit_bit_unary,
    'bit_binary': _emit_bit_binary,
}

if {spec.lower for spec in OP_TABLE} != set(LEVEL_EMITTERS):
    raise RuntimeError('level emitters out of step with the opcode table lower column')


class LevelPlan:
    """The plain ``level`` version of the DAIS kernel (``mode='level'`` of the
    JAX package's executor): ``plan(x)`` maps a (batch, n_in) integer tensor
    on any device to (batch, n_out), in the executor's dtype. Constants move
    to a device on their first use there."""

    def __init__(self, ex: 'DaisExecutor'):
        prog, m = ex.prog, ex.meta
        self.dtype = ex.dtype
        np_dt = ex.np_dtype
        n_ops = prog.n_ops
        order = ex.schedule.order.astype(np.int64)
        pos = np.zeros(max(n_ops, 1), dtype=np.int64)
        pos[order] = np.arange(n_ops, dtype=np.int64)
        fam = m['branch'].astype(np.int64)

        self.groups = []  # (start, end, body, constants)
        for s, e in level_groups(ex.schedule, fam):
            idxs = order[s:e]
            emitter = LEVEL_EMITTERS[OP_TABLE[int(fam[idxs[0]])].lower]
            consts, body = emitter(_Group(m, idxs, np_dt, pos, n_ops))
            self.groups.append((s, e, body, consts))

        out_idx = prog.out_idxs.astype(np.int64)
        self.pos_out = np.where(out_idx >= 0, pos[np.clip(out_idx, 0, max(n_ops - 1, 0))], 0)
        self.osign = np.where(out_idx < 0, 0, np.where(prog.out_negs != 0, -1, 1)).astype(np_dt)[:, None]
        self.rows = max(n_ops, 1)
        self._on: dict[torch.device, list] = {}

    def _consts(self, device: torch.device) -> list:
        hit = self._on.get(device)
        if hit is None:

            def move(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            hit = [{k: move(v) for k, v in c.items()} for *_, c in self.groups]
            hit.append((move(self.pos_out), move(self.osign)))
            self._on[device] = hit
        return hit

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.dtype or x.dim() != 2:
            raise ValueError(f'level plan takes a 2-D {self.dtype} tensor, got {x.dtype} of shape {tuple(x.shape)}')
        cs = self._consts(x.device)
        xT = x.t().contiguous()
        # every row is written before it is read (causality), so the buffer
        # starts uninitialized and each group's block lands in place
        buf = torch.empty((self.rows, x.shape[0]), dtype=self.dtype, device=x.device)
        for (s, e, body, _), c in zip(self.groups, cs):
            buf[s:e] = body(buf, xT, c)
        pos_out, osign = cs[-1]
        return (buf.index_select(0, pos_out) * osign).t().contiguous()


# ---------------------------------------------------------------------------
# the call boundary: chunked, overlapped transfers
# ---------------------------------------------------------------------------

#: per-chunk budget of the float64 batch, and chunks of one call at most:
#: the reference's rule, its 1 MiB and 16 chunks replaced after a measurement
#: (``tools/boundary_ab.py``, NVIDIA H100 80GB HBM3, 700 W), where they lost
#: to one chunk on the batches of 25 to 128 MiB measured and to 4 chunks on
#: those of 1 and 1.5 GiB
CHUNK_BYTES = 256 << 20
CHUNK_MAX = 4


def _infer_chunks(n: int, row_bytes: int = 0) -> int:
    """Chunk count for a batch: batch bytes over the per-chunk budget
    (``CHUNK_BYTES``), at most ``CHUNK_MAX`` chunks; a batch under two budgets
    is one chunk. The reference's rule (which also reads two environment
    variables; the port reads none)."""
    total = n * max(row_bytes, 1)
    if total < 2 * CHUNK_BYTES:
        return 1
    return int(max(1, min(-(-total // CHUNK_BYTES), CHUNK_MAX, n)))


@lru_cache(maxsize=None)
def _copy_streams(index: int) -> tuple:
    """The upload and download streams of CUDA device ``index``: two copy
    engines, so chunk k's download never queues before chunk k+1's upload."""
    return torch.cuda.Stream(index), torch.cuda.Stream(index)


def run_chunks(host: NDArray, fn, out_cols: int, out_dtype: torch.dtype, device: torch.device) -> NDArray:
    """``fn`` over a host batch, chunk by chunk: ``host`` (n, cols) goes to
    ``device`` in ``_infer_chunks`` equal-shape chunks (the last one padded
    with zeros), ``fn`` maps each device chunk to an (rows, ``out_cols``)
    ``out_dtype`` tensor, and the chunks' results come back trimmed to n rows,
    as numpy.

    One chunk is one ``.to(device)`` and one ``.cpu()``. Several chunks on
    a CUDA device are each copied into one of two pinned staging buffers on
    the host, uploaded on the upload stream, run by ``fn`` on the current
    stream once the upload's event has passed, and downloaded on the download
    stream into a pinned buffer once ``fn``'s event has passed: chunk k+1's
    upload overlaps chunk k's ``fn``. The host refills a staging buffer only
    after the upload that read it has ended, and copies a chunk's result out
    only after its download has ended; ``record_stream`` keeps the caching
    allocator from handing a chunk's device buffers to another stream before
    the stream that reads them is done. On the CPU the chunks run in turn."""
    n, cols = host.shape
    if n == 0:
        return torch.empty((n, out_cols), dtype=out_dtype).numpy()
    nc = _infer_chunks(n, host.itemsize * cols)
    if nc == 1:
        return fn(torch.from_numpy(np.ascontiguousarray(host)).to(device)).cpu().numpy()
    chunk = -(-n // nc)
    nc = -(-n // chunk)
    res = torch.empty((n, out_cols), dtype=out_dtype).numpy()
    if device.type != 'cuda':
        for k in range(nc):
            r0, m = k * chunk, min(chunk, n - k * chunk)
            part = host[r0 : r0 + m]
            if m < chunk:  # equal-shape chunks: pad the last one, trim its result
                part = np.concatenate([part, np.zeros((chunk - m, cols), host.dtype)])
            y = fn(torch.from_numpy(np.ascontiguousarray(part)).to(device))
            res[r0 : r0 + m] = y[:m].cpu().numpy()
        return res

    device = torch.device('cuda', device.index if device.index is not None else torch.cuda.current_device())
    up, down = _copy_streams(device.index)
    compute = torch.cuda.current_stream(device)
    in_dtype = torch.from_numpy(host[:0]).dtype
    staging = [torch.empty((chunk, cols), dtype=in_dtype, pin_memory=True) for _ in range(min(nc, 2))]
    uploaded: list = [None] * len(staging)  # per staging buffer, the event of the upload that last read it
    fetched = []  # per chunk, the event of its download
    out = torch.empty((nc * chunk, out_cols), dtype=out_dtype, pin_memory=True)
    out_np = out.numpy()

    def copy_out(k: int) -> None:
        fetched[k].synchronize()
        r0 = k * chunk
        res[r0 : r0 + chunk] = out_np[r0 : min(r0 + chunk, n)]

    for k in range(nc):
        r0, m = k * chunk, min(chunk, n - k * chunk)
        b = k % len(staging)
        if uploaded[b] is not None:
            uploaded[b].synchronize()
        stage_np = staging[b].numpy()
        stage_np[:m] = host[r0 : r0 + m]
        stage_np[m:] = 0
        with torch.cuda.stream(up):
            xd = torch.empty((chunk, cols), dtype=in_dtype, device=device)
            xd.copy_(staging[b], non_blocking=True)
            uploaded[b] = up.record_event()
        compute.wait_event(uploaded[b])
        xd.record_stream(compute)
        yd = fn(xd)
        ready = compute.record_event()
        with torch.cuda.stream(down):
            down.wait_event(ready)
            out[r0 : r0 + chunk].copy_(yd, non_blocking=True)
            fetched.append(down.record_event())
        yd.record_stream(down)
        del xd, yd
        if k:
            copy_out(k - 1)
    copy_out(nc - 1)
    return res


def boundary_call(first: 'DaisExecutor', last: 'DaisExecutor', fn, data, device: torch.device) -> NDArray[np.float64]:
    """A float batch through an integer function ``fn`` (``first``'s inputs to
    ``last``'s outputs) behind the call boundary, chunked by ``run_chunks``:
    each float64 chunk is converted on ``device`` (``first.int_inputs_on``),
    ``fn`` runs, and its output is rescaled there (``last.float_outputs_on``);
    a NaN or inf anywhere refuses the batch with ``validate_batch``'s error
    before any output is returned."""
    what = type(first).__name__
    arr = validate_batch(data, first.prog.n_in, what=what, finite=False)
    bad = torch.zeros((), dtype=torch.int64, device=device)

    def on_device(xf):
        return last.float_outputs_on(fn(first.int_inputs_on(xf, bad)))

    timed = telemetry.metrics_on()
    t0 = time.perf_counter() if timed else 0.0
    out = run_chunks(arr, on_device, last.prog.n_out, torch.float64, device)
    if timed:  # run_chunks returns once the output is on the host
        telemetry.histogram('run.device_s').observe(time.perf_counter() - t0)
    n_bad = int(bad)
    if n_bad:
        raise non_finite_error(what, n_bad)
    return out


def _record_call(holder, n: int, dt: float, nbytes: int = 0) -> None:
    """run.* telemetry for one batch call; the first call of an executor
    includes its kernel's build and is recorded as ``run.compile_s``."""
    if not holder._compile_recorded:
        holder._compile_recorded = True
        telemetry.histogram('run.compile_s').observe(dt)
    if telemetry.metrics_on() and dt > 0:
        telemetry.gauge('run.samples_per_s').set(n / dt)
        telemetry.histogram('run.batch_s').observe(dt)
        telemetry.histogram('run.batch_samples', telemetry.COUNT_BUCKETS).observe(n)
        if nbytes:
            telemetry.histogram('run.hbm_bytes', telemetry.BYTES_BUCKETS).observe(nbytes)
        telemetry.counter('run.samples').inc(n)


def _traced_call(holder, first: 'DaisExecutor', last: 'DaisExecutor', fn, data, mode: str) -> NDArray[np.float64]:
    """``boundary_call`` as one ``run.call`` span, its device work annotated
    for the profiler, and its ``run.*`` sample."""
    t0 = time.perf_counter()
    with telemetry.span('run.call', mode=mode, n_samples=len(data)) as sp:
        with _prof.annotate('run.call', sp.span_id):
            res = boundary_call(first, last, fn, data, holder.device)
    _record_call(holder, len(data), time.perf_counter() - t0,
                 nbytes=len(data) * (first.prog.n_in + last.prog.n_out) * 8)  # fmt: skip
    return res


class DaisExecutor:
    """A DAIS program as a batched integer kernel on one device.

    ``fn_int`` maps a (batch, n_in) integer tensor to (batch, n_out) through
    the CUDA kernel's wrapper (the plain ``level`` version for a CPU tensor);
    ``__call__`` wraps it with the call boundary (``boundary_call``).
    """

    def __init__(self, prog: DaisProgram, device=None):
        prog.validate()
        self.prog = prog
        self.device = resolve_device(device)
        # +2 headroom: shift_add aligns operands before the narrowing shift
        self.use_i64 = prog.max_width + 2 > 31
        self.dtype = torch.int64 if self.use_i64 else torch.int32
        self.np_dtype = np.int64 if self.use_i64 else np.int32
        self.meta = op_meta(prog, self.use_i64)
        self.schedule = levelize_program(prog, sort_key=self.meta['branch'].astype(np.int64))
        self.plain = LevelPlan(self)
        self._in_scale = self._inp_scale()
        self._out_sf = self._out_scale()
        self._scales: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

        from .cuda_backend import DaisKernel

        # the wrapper packs the kernel's records at its first launch: a CPU
        # executor never builds them
        self.kernel = DaisKernel(self)
        self.mode = 'pallas' if self.device.type == 'cuda' else 'level'
        self._compile_recorded = False
        telemetry.counter(f'run.mode.{self.mode}').inc()

    def fn_int(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, n_in) integer tensor -> (batch, n_out), on x's device."""
        return self.kernel(x)

    # -- host boundary -----------------------------------------------------

    def _inp_scale(self) -> NDArray[np.float64]:
        """Each input column's scale, 2**(inp_shift + the copy op's fractionals)
        (0 for a column no copy op reads)."""
        prog = self.prog
        scale = np.zeros(prog.n_in, dtype=np.float64)
        for i in range(prog.n_ops):
            if prog.opcode[i] == -1:
                i0 = int(prog.id0[i])
                scale[i0] = 2.0 ** (int(prog.inp_shifts[i0]) + int(prog.fractionals[i]))
        return scale

    def _int_inputs(self, data: NDArray[np.float64]) -> NDArray:
        arr = validate_batch(data, self.prog.n_in, what=type(self).__name__)
        x = np.floor(arr * self._in_scale)
        return x.astype(self.np_dtype)

    def _out_scale(self) -> NDArray[np.float64]:
        prog = self.prog
        sf = np.zeros(prog.n_out, dtype=np.float64)
        for j in range(prog.n_out):
            idx = int(prog.out_idxs[j])
            if idx < 0:
                continue
            sf[j] = 2.0 ** (int(prog.out_shifts[j]) - int(prog.fractionals[idx]))
        return sf

    def _scales_on(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        hit = self._scales.get(device)
        if hit is None:
            hit = self._scales[device] = (torch.from_numpy(self._in_scale).to(device),
                                          torch.from_numpy(self._out_sf).to(device))  # fmt: skip
        return hit

    def int_inputs_on(self, xf: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
        """``_int_inputs`` as torch ops on xf's device, bit for bit: adds the
        count of xf's non-finite values to ``bad``, then scales, floors and
        casts. A value outside the integer type's range becomes its minimum,
        as numpy's cast on an x86 host gives it (a CUDA cast would saturate)."""
        bad += (~torch.isfinite(xf)).sum()
        x = torch.floor(xf * self._scales_on(xf.device)[0])
        lo = -(2.0 ** (8 * np.dtype(self.np_dtype).itemsize - 1))
        return torch.where((x >= lo) & (x < -lo), x, lo).to(self.dtype)

    def float_outputs_on(self, y: torch.Tensor) -> torch.Tensor:
        """The host's ``out.astype(float64) * _out_scale()`` as torch ops on
        y's device, bit for bit."""
        return y.to(torch.float64) * self._scales_on(y.device)[1]

    def int_inputs(self, data) -> torch.Tensor:
        """The integer input tensor of a float batch, converted on the host,
        on the executor's device."""
        return torch.from_numpy(self._int_inputs(data)).to(self.device)

    def __call__(self, data: NDArray[np.float64]) -> NDArray[np.float64]:
        return _traced_call(self, self, self, self.fn_int, data, self.mode)


class PipelineExecutor:
    """On-device execution of a hardware pipeline's stages.

    Every stage's kernel launch and the *exact* inter-stage re-scaling run on
    the device, behind one call boundary at the two ends; the integer
    activations never leave the device. Boundary j carries ``s[j] =
    out_shift_prev[j] - f_prev[out_idx_j] + inp_shift_next[j] + f_next[j]``:
    the next stage's ``floor(out_float * 2**(inp_shift + f))`` on the
    grid-aligned boundary value is exactly an arithmetic shift of the previous
    stage's output code (floor division for negative ``s``), so the chained
    execution is bit-exact with the stage-by-stage float one.

    Counterpart of ``PipelineExecutor`` in ``da4ml_tpu/runtime/jax_backend.py``.
    """

    def __init__(self, progs: list[DaisProgram], device=None):
        if not progs:
            raise ValueError('PipelineExecutor needs at least one stage')
        self.device = resolve_device(device)
        self.stages = [DaisExecutor(p, device=self.device) for p in progs]
        shifts: list[NDArray[np.int64]] = []
        for pa, pb in zip(progs[:-1], progs[1:]):
            if pa.n_out != pb.n_in:
                raise ValueError(f'stage boundary mismatch: {pa.n_out} outputs feed {pb.n_in} inputs')
            f_out = np.where(pa.out_idxs >= 0, pa.fractionals[np.maximum(pa.out_idxs, 0)], 0)
            f_in = np.zeros(pb.n_in, dtype=np.int64)
            for i in range(pb.n_ops):
                if pb.opcode[i] == -1:
                    f_in[int(pb.id0[i])] = int(pb.fractionals[i])
            shifts.append(pa.out_shifts.astype(np.int64) - f_out + pb.inp_shifts.astype(np.int64) + f_in)
        self._shifts = shifts
        exs = self.stages
        # boundary k shifts in the WIDER of the two boundary dtypes: widening
        # first keeps a 32->64-bit up-shift from overflowing, and a 64->32-bit
        # boundary must right-shift the full value BEFORE the next stage's
        # input cast wraps it. An up-shift between two int32 stages must
        # itself widen so it cannot wrap before the next stage's input cast
        # does the wrapping.
        self._bound64 = [
            exs[k].use_i64 or exs[k + 1].use_i64 or bool(np.any(shifts[k] > 0)) for k in range(len(shifts))
        ]
        # shift by s as (x * 2**max(s, 0)) >> min(max(-s, 0), width - 1): a
        # multiply wraps where a left shift of a negative value would trap,
        # a multiplier of 0 is a left shift by the width or more, and a right
        # shift by the width or more is the sign fill
        self._shift_consts = []
        for s, b64 in zip(shifts, self._bound64):
            bits = 64 if b64 else 32
            np_dt = np.int64 if b64 else np.int32
            left = np.where(s >= 0, s, 0)
            mul = np.where(left < bits, np.int64(1) << np.minimum(left, 63), 0).astype(np_dt)
            rsh = np.minimum(np.where(s < 0, -s, 0), bits - 1).astype(np_dt)
            self._shift_consts.append((mul, rsh))
        self._consts: dict[torch.device, list] = {}
        self._compile_recorded = False

    def _boundary(self, x: torch.Tensor, k: int) -> torch.Tensor:
        hit = self._consts.get(x.device)
        if hit is None:
            hit = self._consts[x.device] = [(torch.from_numpy(m).to(x.device), torch.from_numpy(r).to(x.device))
                                            for m, r in self._shift_consts]  # fmt: skip
        mul, rsh = hit[k]
        return (x.to(mul.dtype) * mul) >> rsh

    def fn_int(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, n_in) integer tensor -> the last stage's (batch, n_out),
        on x's device: each stage's kernel, then the boundary shift. Each
        intermediate is freed as soon as the next stage has read it."""
        for k, ex in enumerate(self.stages):
            x = ex.fn_int(x.to(ex.dtype).contiguous())
            if k < len(self._shifts):
                x = self._boundary(x, k)
        return x

    def __call__(self, data: NDArray[np.float64]) -> NDArray[np.float64]:
        """All stages over each chunk of the batch behind the call boundary
        (``boundary_call``)."""
        return _traced_call(self, self.stages[0], self.stages[-1], self.fn_int, data, 'pipeline-fused')

    def chained(self, data: NDArray[np.float64]) -> NDArray[np.float64]:
        """The per-stage entry point, ``fused=False`` of ``run_pipeline``.

        The reference runs its stages either as one XLA program or as one
        program per stage with donated buffers. In PyTorch both are the same
        sequence of launches on one stream, each intermediate freed as soon
        as the next stage has read it (the counterpart of donation), so this
        is ``__call__`` under the reference's ``run.call`` mode for it.
        """
        return _traced_call(self, self.stages[0], self.stages[-1], self.fn_int, data, 'pipeline-chained')


_EXECUTOR_CACHE_CAP = 256
_executor_cache: OrderedDict[tuple, DaisExecutor] = OrderedDict()
_pipeline_cache: OrderedDict[tuple, PipelineExecutor] = OrderedDict()
_fused_ir_cache: OrderedDict[tuple, DaisExecutor] = OrderedDict()


def _cached(cache: OrderedDict, key, build):
    """LRU lookup: ``cache[key]``, built by ``build()`` on a miss, the least
    recently used entry evicted past ``_EXECUTOR_CACHE_CAP`` entries."""
    hit = cache.get(key)
    if hit is None:
        while len(cache) >= _EXECUTOR_CACHE_CAP:
            cache.popitem(last=False)
        cache[key] = hit = build()
    else:
        cache.move_to_end(key)
    return hit


def executor_for_binary(binary: NDArray[np.int32], device=None) -> DaisExecutor:
    """A cached executor for a DAIS binary on ``device`` (LRU, 256 entries)."""
    dev = resolve_device(device)
    key = (np.asarray(binary, dtype=np.int32).tobytes(), str(dev))
    return _cached(_executor_cache, key, lambda: DaisExecutor(decode(binary), device=dev))


def run_binary(binary: NDArray[np.int32], data: NDArray[np.float64], device=None) -> NDArray[np.float64]:
    return executor_for_binary(binary, device=device)(data)


def _pipeline_key(binaries: list[NDArray[np.int32]]) -> bytes:
    # length-prefixed segments: plain concatenation would let two different
    # stage lists with identical byte streams collide
    return b''.join(
        len(bs := np.asarray(b, dtype=np.int32).tobytes()).to_bytes(8, 'little') + bs for b in binaries
    )


def fused_executor_for_binaries(binaries: list[NDArray[np.int32]], device=None) -> DaisExecutor:
    """A cached executor over the IR-fused pipeline on ``device``: the
    per-stage binaries merged into ONE DAIS program (``ir.fuse.fuse_binaries``),
    so the kernel runs the whole pipeline in one launch a chunk."""
    dev = resolve_device(device)

    def build():
        from ..ir.fuse import fuse_binaries

        ex = DaisExecutor(decode(fuse_binaries(binaries)), device=dev)
        telemetry.counter('run.mode.fused_ir').inc()
        return ex

    return _cached(_fused_ir_cache, (_pipeline_key(binaries), str(dev)), build)


def pipeline_executor_for_binaries(binaries: list[NDArray[np.int32]], device=None) -> PipelineExecutor:
    """A cached :class:`PipelineExecutor` over the stages' binaries on ``device``."""
    dev = resolve_device(device)
    key = (_pipeline_key(binaries), str(dev))
    return _cached(_pipeline_cache, key, lambda: PipelineExecutor([decode(b) for b in binaries], device=dev))


def run_pipeline(binaries: list[NDArray[np.int32]], data: NDArray[np.float64], device=None,
                 fused: bool | str = True) -> NDArray[np.float64]:  # fmt: skip
    """Multi-stage execution on ``device`` (the card when None).
    ``fused=True`` chains the stages' kernels behind one call boundary
    (``fused=False``, ``PipelineExecutor.chained``, is the same path here),
    and ``fused='ir'`` first merges the stages into ONE DAIS program at the
    IR level."""
    if fused == 'ir':
        return fused_executor_for_binaries(binaries, device)(data)
    ex = pipeline_executor_for_binaries(binaries, device)
    return ex(data) if fused else ex.chained(data)
