"""DAIS program executor on torch tensors.

``DaisExecutor`` turns a decoded DAIS program into a batched integer kernel
and wraps it with the host float boundary (input scaling/floor, output
rescale), so the device only ever sees fixed-point integer arithmetic: int32,
or int64 when the program's widths demand it (the rule of
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

Entry points run on the card unless the caller passes ``device='cpu'``;
``device=None`` with no CUDA device raises instead of dropping to the CPU.

Counterpart of ``DaisExecutor`` in ``da4ml_tpu/runtime/jax_backend.py``
without its ``unroll``/``scan`` modes, autotune, packed I/O, donation,
sharding and model-shard paths.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from numpy.typing import NDArray

from ..ir.dais_binary import DaisProgram, decode
from ..ir.optable import OP_TABLE, VECTOR_CLASS
from ..ir.schedule import LevelSchedule, levelize_program


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


def validate_batch(data, n_in: int, what: str = 'DaisExecutor') -> NDArray[np.float64]:
    """Validate an inference batch before dispatch:

    - the batch must be 2-D ``(n_samples, n_features)``;
    - the feature width must match the program's ``n_in``;
    - every value must be finite (NaN/inf floor to undefined integers).

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
    if arr.size and not np.isfinite(arr).all():
        bad = int(np.count_nonzero(~np.isfinite(arr)))
        raise InvalidInputError(f'{what}: input contains {bad} non-finite (NaN/inf) value(s)')
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


class DaisExecutor:
    """A DAIS program as a batched integer kernel on one device.

    ``fn_int`` maps a (batch, n_in) integer tensor to (batch, n_out) through
    the CUDA kernel's wrapper (the plain ``level`` version for a CPU tensor);
    ``__call__`` wraps it with the host float boundary.
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

        from .cuda_backend import DaisKernel

        # the wrapper packs the kernel's records at its first launch: a CPU
        # executor never builds them
        self.kernel = DaisKernel(self)

    def fn_int(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, n_in) integer tensor -> (batch, n_out), on x's device."""
        return self.kernel(x)

    # -- host boundary -----------------------------------------------------

    def _int_inputs(self, data: NDArray[np.float64]) -> NDArray:
        prog = self.prog
        arr = validate_batch(data, prog.n_in, what=type(self).__name__)
        scale = np.zeros(prog.n_in, dtype=np.float64)
        for i in range(prog.n_ops):
            if prog.opcode[i] == -1:
                i0 = int(prog.id0[i])
                scale[i0] = 2.0 ** (int(prog.inp_shifts[i0]) + int(prog.fractionals[i]))
        x = np.floor(arr * scale)
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

    def int_inputs(self, data) -> torch.Tensor:
        """The integer input tensor of a float batch, on the executor's device."""
        return torch.from_numpy(self._int_inputs(data)).to(self.device)

    def __call__(self, data: NDArray[np.float64]) -> NDArray[np.float64]:
        out = self.fn_int(self.int_inputs(data)).cpu().numpy()
        return out.astype(np.float64) * self._out_scale()


_executor_cache: OrderedDict[tuple, DaisExecutor] = OrderedDict()
_EXECUTOR_CACHE_CAP = 256


def executor_for_binary(binary: NDArray[np.int32], device=None) -> DaisExecutor:
    """A cached executor for a DAIS binary on ``device`` (LRU, 256 entries)."""
    dev = resolve_device(device)
    key = (np.asarray(binary, dtype=np.int32).tobytes(), str(dev))
    ex = _executor_cache.get(key)
    if ex is None:
        while len(_executor_cache) >= _EXECUTOR_CACHE_CAP:
            _executor_cache.popitem(last=False)
        _executor_cache[key] = ex = DaisExecutor(decode(binary), device=dev)
    else:
        _executor_cache.move_to_end(key)
    return ex


def run_binary(binary: NDArray[np.int32], data: NDArray[np.float64], device=None) -> NDArray[np.float64]:
    return executor_for_binary(binary, device=device)(data)
